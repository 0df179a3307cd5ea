"""The mesh's rank processes over torch.distributed: the ``data``,
``model``, ``pipe``, ``seq``, ``expert`` and ``fsdp`` axes (counterpart of
pg_asr_tpu/parallel/mesh.py and of the placements of parallel/moe.py,
parallel/fsdp.py and parallel/pipeline.py).

The JAX package runs a mesh in one process over its devices (and over
hosts with ``jax.distributed``). The port runs one process per mesh
position, PyTorch's way, each on its own device: ``data`` ranks take their
own rows of the batch and sum the loss's denominators and the gradients,
as the JAX package's ``shard_map`` step does with ``psum``; ``model``
ranks take the same rows and run their parts of the Megatron pairs
(parallel/tensor.py); ``pipe`` ranks take the same rows, each holds the
blocks of its pipeline stage and passes activations on to the next stage
and gradients back (parallel/pipeline.py); ``seq`` ranks take the same
rows and each runs the blocks on its slice of the frames
(parallel/sequence.py); ``expert`` ranks take the same rows and split each
MoE block's experts (parallel/moe.py); ``fsdp`` ranks take their own rows
and split the parameters and the optimizer state (parallel/fsdp.py).
Ranks lie on the mesh row-major (``ParallelPlan.coords``), as
``jax.sharding.Mesh`` lays out devices.

  * ``init_distributed``: the process group, from a ``tcp://`` rendezvous
    at the coordinator's address; NCCL for a CUDA rank, gloo for a CPU
    rank, unless the caller names a backend. A configured cluster that
    fails raises: it never carries on as a single process.
  * ``DataParallel``: this rank's place on the mesh and the collectives
    the steps make, each over a named set of ranks: the *batch* ranks
    (those holding distinct rows: ``data``, ``data x fsdp``) for the
    loss's denominators, the MoE's token counts and the gradients of
    whole leaves; the model group for the Megatron pairs' sums and the
    gathers of the leaves the forward takes whole; the pipe group for the
    point-to-point moves between stages and the gathers of the stages'
    blocks; the seq group for the gathers of keys, values and final
    states and their reduce-scatters; the expert group for the MoE's
    combine; the fsdp group for the gathers and reduce-scatters of split
    leaves; every rank for the stop agreement and the broadcast.
    ``ONE_DEVICE`` without a process group, every collective the
    identity; ``GroupRank`` in the joined group (without a plan: a data
    axis over the whole group).
  * ``pad_batch_to_multiple``, ``local_rows``: a global batch laid out over
    the ranks as the JAX package lays it out over the devices of a mesh.
"""

from __future__ import annotations

import datetime
import math
import socket

import numpy as np
import torch

from . import tensor

# a peer that stops answering turns into an error after this long
DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device: torch.device | str = "cpu",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group as rank `process_id` of `num_processes`, the
    group's store at `coordinator_address` (host:port, served by rank 0).

    ``backend`` None: NCCL when `device` is a CUDA device (made the
    process's current device when it has an index), else gloo. No cluster configured (no
    address, at most one process) or a group already joined: nothing to
    do. A configured cluster that cannot be joined raises RuntimeError,
    with the JAX package's message: each rank training alone on its shard
    while their checkpoints race is never the fallback."""
    import torch.distributed as dist

    if dist.is_initialized():
        print(f"[mesh] torch.distributed already initialized (process "
              f"{dist.get_rank()}/{dist.get_world_size()})")
        return
    if not coordinator_address and (num_processes or 0) <= 1:
        print("[mesh] torch.distributed not initialized: no cluster "
              "configured")
        return
    device = torch.device(device)
    try:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("a cluster needs its coordinator address, its "
                             "number of processes and this process's id")
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed for the configured "
            f"cluster (coordinator={coordinator_address!r}, "
            f"num_processes={num_processes}, process_id={process_id}): {e}"
        ) from e
    print(f"[mesh] torch.distributed initialized (process "
          f"{dist.get_rank()}/{dist.get_world_size()}, {backend})")


def destroy_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def pad_batch_to_multiple(arrays: tuple[np.ndarray, ...], multiple: int):
    """Pad the leading (batch) dim to a multiple with zero rows (ragged
    final batches under data parallelism). Zero rows have num_samples 0
    and label_lens 0, which the losses leave out, so the padded step
    computes the unpadded loss and gradients exactly."""
    b = arrays[0].shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arrays
    return tuple(np.concatenate(
        [a, np.zeros((rem,) + a.shape[1:], dtype=a.dtype)], axis=0)
        for a in arrays)


def local_rows(arrays: tuple[np.ndarray, ...], rank: int, world: int):
    """This rank's rows of a global batch, as a ``data`` mesh of `world`
    devices shards it: zero-padded to a multiple of `world`, then the
    rank's contiguous block."""
    arrays = pad_batch_to_multiple(tuple(np.asarray(a) for a in arrays),
                                   world)
    n = arrays[0].shape[0] // world
    return tuple(a[rank * n:(rank + 1) * n] for a in arrays)




def join_mesh(plan, device: torch.device | str) -> "DataParallel":
    """This process's rank on the mesh of `plan` (parallel/driver.py):
    ``ONE_DEVICE`` outside any process group; else the joined group's
    ``GroupRank``, whose world size must be the mesh's."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if plan.world > 1:
            raise ValueError(
                f"--mesh {plan.text} needs {plan.world} rank processes "
                "joined in a process group (parallel/mesh.init_distributed);"
                " the CLI starts them")
        return ONE_DEVICE
    if dist.get_world_size() != plan.world:
        raise ValueError(
            f"--mesh {plan.text} in a process group of "
            f"{dist.get_world_size()} ranks: the mesh's positions must equal "
            "the world size")
    return GroupRank(device, plan)


def shard_leaf(v: torch.Tensor, dim: int, index: int, n: int
               ) -> torch.Tensor:
    """Part `index` of `n` of `v` along `dim`, in storage of its own (a
    view would keep the whole tensor alive)."""
    size = v.shape[dim] // n
    return v.narrow(dim, index * size, size).clone(
        memory_format=torch.contiguous_format)


class DataParallel:
    """This process's place on the mesh and the collectives that the steps
    make; reductions are sums unless named otherwise. ``rank`` and
    ``world`` are its place among the ranks that hold distinct rows of a
    batch (the data index, or data x fsdp), ``n_ranks`` the processes of
    the whole mesh. This base is the run without a process group (one
    device, ``ONE_DEVICE``): rank 0 of 1, every collective the identity,
    every leaf whole, so that the steps have one body for one device and
    for any mesh."""

    rank, world, n_ranks, is_main = 0, 1, 1, True
    # the strategy of the mesh's plan (parallel/driver.py) and the
    # microbatches of a pipeline
    strategy, microbatches = "data", 0
    expert_index, expert_size = 0, 1
    model_index, model_size = 0, 1
    pipe_index, pipe_size = 0, 1
    seq_index, seq_size = 0, 1

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks that hold distinct rows."""
        return t

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_sum(t) / self.world

    def sum_grads(self, grads: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """The step's gradients (of the whole leaves that
        ``forward_params`` gave) summed over the ranks that hold distinct
        rows, in the layout the parameters are held in."""
        return grads

    def broadcast_(self, tensors: dict[str, torch.Tensor]) -> None:
        """Rank 0's values into every rank's tensors, in place."""

    def any(self, flag: bool) -> bool:
        """True on every rank when it is True on any (a max over ranks)."""
        return flag

    def sum_counts(self, *counts: int) -> tuple[int, ...]:
        """Host integers summed over the ranks that hold distinct rows."""
        return counts

    def exclusive_offsets(self, counts: torch.Tensor):
        """For per-rank counts (K,) int64: (the sum over the ranks of rows
        before this one, the sum over all of them), each (K,): the
        rank-major global order that the MoE's expert slots follow."""
        return torch.zeros_like(counts), counts

    def step_generator(self, carried: torch.Generator) -> torch.Generator:
        """The generator of one step's random draws on this rank: on one
        device the carried generator itself."""
        return carried

    def shard(self, tree: dict[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
        """This rank's part of full-shape parameter-like leaves (parameters,
        optimizer moments, accumulators, EMA)."""
        return tree

    def unshard(self, tree: dict[str, torch.Tensor], axis: str | None = None
                ) -> dict[str, torch.Tensor]:
        """The full-shape leaves of this rank's parts (of the leaves split
        over `axis`, or over any axis), gathered from their group."""
        return tree

    def forward_params(self, params: dict[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
        """The parameters a step's forward takes: the fsdp leaves and the
        model axis's unpaired leaves gathered whole, the expert stacks and
        the Megatron pairs' leaves as this rank holds them."""
        return self.unshard(params, "fsdp")

    def whole_pairs(self, tree: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
        """A ``forward_params`` tree with its Megatron pairs' leaves
        gathered whole too, in the canonical layout, without gradient (for
        a decoder that runs the whole model)."""
        return tree

    def leaf_sums(self, sums: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """Per-leaf float32 sums of this rank's parts completed into the
        whole leaves' sums: summed over each split leaf's group, a whole
        leaf counted once; under ``pipe`` with the other stages' blocks'
        sums added, in their leaves' dtype."""
        return sums

    def group_sum(self, t: torch.Tensor, over) -> torch.Tensor:
        """The sum of `t` over the named group of ranks (``"expert"``,
        ``"model"``, or ``"model+expert"``: both; or a tuple of axes: those
        that differ from this rank only along them), in float32, without
        gradient."""
        return t

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's parts of `t` joined along `dim`, without
        gradient."""
        return t

    def model_part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part along `dim` of `t`, which every rank of the
        model group holds whole."""
        return t


# the rank of a run without a process group
ONE_DEVICE = DataParallel()

# a set of ranks of one member: no collective
_SELF = "self"

# the mesh axes a rank has a place on, and the named sets of ranks of the
# collectives: those that differ from this rank only along the axes named
_AXES = ("data", "model", "pipe", "seq", "expert", "fsdp")
_GROUPS = {"batch": ("data", "fsdp"), "data": ("data",),
           "expert": ("expert",), "fsdp": ("fsdp",), "model": ("model",),
           "model+expert": ("model", "expert"), "world": _AXES}


def group_parts(coords: list[dict[str, int]], along: tuple[str, ...]
                ) -> tuple[tuple[int, ...], ...]:
    """The sets of ranks (`coords`: each rank's mesh position) that differ
    only along the axes `along`, in rank order."""
    parts: dict[tuple, list[int]] = {}
    for r, c in enumerate(coords):
        key = tuple(v for a, v in sorted(c.items()) if a not in along)
        parts.setdefault(key, []).append(r)
    return tuple(sorted(tuple(ranks) for ranks in parts.values()))


class GroupRank(DataParallel):
    """This process's rank in the joined process group, on `device`, at its
    place on `plan`'s mesh (without a plan: a data axis over the whole
    group). Every collective takes and returns tensors on `device` (NCCL
    reduces device tensors only) and returns a new tensor with no
    gradient. The sets of ranks are ``dist.new_group`` groups, one for
    every set of axes, made on every rank in one order (a set of ranks
    made once however many sets of axes give it); one that spans the
    world is the default group.

    A leaf's placement (``ParallelPlan.splits``) names the axes that split
    it. Its gradient is summed over the ranks that differ from this one
    along the other axes: the ``data`` ranks hold other rows, the ``pipe``
    ranks of other stages (whose part of a whole leaf's gradient is zero
    but for the frontend on the first stage and the head on the last) and
    the ``seq`` ranks of other frames hold other parts of the sum, and the
    ``model`` and ``expert`` ranks that hold the same part compute copies
    of one gradient, which are averaged (on the card the copies differ in
    their last bits, and the ranks of a group must keep equal weights), as
    are a policy-gradient plan's ``pipe`` and ``seq`` replicas. Under
    ``pipe`` a block's leaves live on its stage's ranks only: ``shard``
    drops the other stages' blocks, ``unshard`` gathers them back from
    their stages, and ``leaf_sums`` gives every stage's sums."""

    def __init__(self, device: torch.device | str, plan=None):
        import itertools

        import torch.distributed as dist

        n = dist.get_world_size()
        self.global_rank = dist.get_rank()
        self.n_ranks = n
        self.is_main = self.global_rank == 0  # the one that writes files
        self.device = torch.device(device)
        self.plan = plan
        if plan is None:
            sizes = dict(dict.fromkeys(_AXES, 1), data=n)
            coords = [dict(dict.fromkeys(_AXES, 0), data=r) for r in range(n)]
        else:
            if plan.world != n:
                raise ValueError(f"--mesh {plan.text} has {plan.world} "
                                 f"positions, the process group {n} ranks")
            sizes = plan.sizes
            coords = [plan.coords(r) for r in range(n)]
        me = coords[self.global_rank]
        F = sizes["fsdp"]
        self.strategy = plan.strategy if plan is not None else "data"
        self.microbatches = plan.microbatches if plan is not None else 0
        self._copies = ("model", "expert") + (
            plan.copies if plan is not None else ())
        self.pipe_index, self.pipe_size = me["pipe"], sizes["pipe"]
        self.seq_index, self.seq_size = me["seq"], sizes["seq"]
        # the global ranks of this rank's pipe group, by stage (row-major:
        # the rank rises with the pipe index within a group)
        self._pipe_ranks = next(ranks for ranks in
                                group_parts(coords, ("pipe",))
                                if self.global_rank in ranks)
        # gloo's send and recv take host tensors only
        self._host_p2p = (self.device.type == "cuda"
                          and dist.get_backend() == "gloo")
        self.rank = me["data"] * F + me["fsdp"]
        self.world = sizes["data"] * F
        self.expert_index, self.expert_size = me["expert"], sizes["expert"]
        self.fsdp_index, self.fsdp_size = me["fsdp"], F
        self.model_index, self.model_size = me["model"], sizes["model"]
        self._index = {a: me[a] for a in _AXES}
        self._size = {a: sizes[a] for a in _AXES}
        self._made: dict[tuple, object] = {}
        self._groups = {along: self._new_group(coords, along)
                        for r in range(1, len(_AXES) + 1)
                        for along in itertools.combinations(_AXES, r)}
        # leaf -> its ((axis, dim), ...); the model-split leaves that the
        # forward takes whole
        self._placed: dict[str, tuple[tuple[str, int], ...]] = {}
        self._gathered: set[str] = set()
        # under pipe: every block leaf -> its stage; another stage's leaf
        # -> (its whole shape, dtype); the whole tree's order
        self._staged: dict[str, int] = {}
        self._away: dict[str, tuple[tuple[int, ...], torch.dtype]] = {}
        self._order: list[str] = []

    def _new_group(self, coords, along):
        """The ranks that differ from this one only along the axes
        `along`: None for the whole world (the default group), _SELF for
        this rank alone, else its ``dist.new_group`` (every rank makes
        every such group, in one order, as new_group requires)."""
        import torch.distributed as dist

        key = group_parts(coords, along)
        if len(key) == 1:
            return None
        if key in self._made:
            return self._made[key]
        mine = None
        for ranks in key:
            if len(ranks) == 1:
                if self.global_rank in ranks:
                    mine = _SELF
                continue
            group = dist.new_group(list(ranks))
            if self.global_rank in ranks:
                mine = group
        self._made[key] = mine
        return mine

    def _all_reduce(self, t: torch.Tensor, over) -> None:
        """`t` summed in place over the named set of ranks (a name of
        ``_GROUPS``, or a tuple of axes)."""
        import torch.distributed as dist

        axes = _GROUPS.get(over, over) if isinstance(over, str) else over
        group = self._groups[tuple(a for a in _AXES if a in axes)]
        if group is not _SELF:
            dist.all_reduce(t, group=group)

    def _dim(self, k: str, axis: str) -> int | None:
        """The dimension of leaf `k` that `axis` splits, or None."""
        return dict(self._placed.get(k, ())).get(axis)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        out = t.detach().clone()
        self._all_reduce(out, "batch")
        return out

    def _sum_flat(self, grads: dict[str, torch.Tensor], over
                  ) -> dict[str, torch.Tensor]:
        """One all-reduce a dtype, on the tensors flattened into one
        buffer."""
        by_dtype: dict[torch.dtype, list[str]] = {}
        for k, g in grads.items():
            by_dtype.setdefault(g.dtype, []).append(k)
        out = {}
        for keys in by_dtype.values():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            self._all_reduce(flat, over)
            at = 0
            for k in keys:
                n = grads[k].numel()
                out[k] = flat[at:at + n].view_as(grads[k])
                at += n
        return out

    def sum_grads(self, grads: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """Each leaf's gradient summed over the ranks that differ from this
        one along the axes that do not split it (one all-reduce a set of
        axes and dtype) and divided by the ``model`` and ``expert`` ranks
        among them, which hold copies: a whole leaf over every rank, an
        expert stack over the data group, a model axis's part over the
        data group and, under ``model x expert``, averaged over the expert
        group. An unpaired leaf of the model axis, gathered whole for the
        forward, keeps this rank's slice of its whole gradient first. fsdp
        leaves: a reduce-scatter within the fsdp group, then an all-reduce
        of the part over the data group."""
        by_over: dict[tuple, dict[str, torch.Tensor]] = {}
        split = {}
        for k, g in grads.items():
            axes = {a for a, _ in self._placed.get(k, ())}
            if k in self._staged:
                axes.add("pipe")
            if "fsdp" in axes:
                split[k] = g
                continue
            if k in self._gathered:
                g = shard_leaf(g, self._dim(k, "model"), self.model_index,
                               self.model_size)
            over = tuple(a for a in _AXES if a not in axes)
            by_over.setdefault(over, {})[k] = g
        out = {}
        for over, part in by_over.items():
            copies = math.prod(self._size[a] for a in over
                               if a in self._copies)
            summed = self._sum_flat(part, over)
            out.update(summed if copies == 1 else
                       {k: g / copies for k, g in summed.items()})
        if split:
            out.update(self._sum_flat(self._reduce_scatter(split), "data"))
        return {k: out[k] for k in grads}

    def _reduce_scatter(self, grads: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
        """Each full-shape fsdp gradient summed within the fsdp group,
        this rank keeping its part: one reduce-scatter a dtype (torch's
        ``reduce_scatter_single``, earlier ``reduce_scatter_tensor``), the
        input laid out as the F ranks' parts one after another."""
        import torch.distributed as dist

        scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)
        F = self.fsdp_size
        by_dtype: dict[torch.dtype, list[str]] = {}
        for k, g in grads.items():
            by_dtype.setdefault(g.dtype, []).append(k)
        out = {}
        for keys in by_dtype.values():
            parts = {k: grads[k].chunk(F, dim=self._dim(k, "fsdp"))
                     for k in keys}
            flat = torch.cat([parts[k][f].reshape(-1) for f in range(F)
                              for k in keys])
            mine = flat.new_empty(flat.numel() // F)
            scatter_single(mine, flat, group=self._groups[("fsdp",)])
            at = 0
            for k in keys:
                shape = parts[k][0].shape
                n = parts[k][0].numel()
                out[k] = mine[at:at + n].view(shape)
                at += n
        return out

    def broadcast_(self, tensors: dict[str, torch.Tensor]) -> None:
        import torch.distributed as dist

        for t in tensors.values():
            dist.broadcast(t, src=0)

    def any(self, flag: bool) -> bool:
        import torch.distributed as dist

        if self.n_ranks == 1:  # no agreement to reach: no wait for the card
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def sum_counts(self, *counts: int) -> tuple[int, ...]:
        t = torch.tensor(counts, dtype=torch.int64, device=self.device)
        return tuple(int(v) for v in self.all_sum(t).tolist())

    def exclusive_offsets(self, counts: torch.Tensor):
        table = counts.new_zeros((self.world,) + tuple(counts.shape))
        table[self.rank] = counts
        table = self.all_sum(table)
        return table[:self.rank].sum(0), table.sum(0)

    def step_generator(self, carried: torch.Generator) -> torch.Generator:
        """The carried generator stays the same on every rank (a host
        generator when there are several); each step draws one seed from
        it and this rank's draws come from a generator on its device
        seeded from that seed and its row index (``rank``), as the JAX
        step folds the data axis's index into its key: the ranks of one
        expert or model group, which hold the same rows, draw the same
        bits. In a group of one the draws are the carried generator's own,
        as on one device without a mesh."""
        if self.n_ranks == 1:
            return carried
        seed = int(torch.randint(0, 2 ** 62, (), generator=carried))
        return torch.Generator(device=self.device).manual_seed(
            (seed + self.rank * 0x9E3779B97F4A7C15) % 2 ** 63)

    def shard(self, tree: dict[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
        """A model axis's ``qkv`` and ``conv_in`` leaves are put in the run
        layout (parallel/tensor.py ``to_run``) before their split; under
        ``pipe`` another stage's blocks are left out."""
        if self.plan is None:
            return tree
        out = {}
        self._order = self._order or list(tree)
        for k, v in tree.items():
            stage = self.plan.stage(k)
            if stage is not None:
                self._staged[k] = stage
                if stage != self.pipe_index:
                    self._away[k] = (tuple(v.shape), v.dtype)
                    continue
            splits = self.plan.splits(k, tuple(v.shape))
            if splits:
                self._placed[k] = splits
            for axis, dim in splits:
                if axis == "model":
                    v = tensor.to_run(k, v, self.model_size)
                    if not tensor.is_paired(k):
                        self._gathered.add(k)
                v = shard_leaf(v, dim, self._index[axis], self._size[axis])
            out[k] = v
        return out

    def _gather(self, tree: dict[str, torch.Tensor], axis: str,
                keys: list[str]) -> dict[str, torch.Tensor]:
        """The leaves `keys` of `tree`, split over `axis`, gathered from
        its group: one all-gather a dtype (torch's ``all_gather_single``,
        earlier ``all_gather_into_tensor``), each leaf reassembled along its
        dimension into a contiguous tensor."""
        import torch.distributed as dist

        gather_single = getattr(dist, "all_gather_single",
                                dist.all_gather_into_tensor)
        batches: dict[torch.dtype, list[str]] = {}
        for k in keys:
            batches.setdefault(tree[k].dtype, []).append(k)
        if not batches:
            return tree
        out = dict(tree)
        n = self._size[axis]
        for keys in batches.values():
            flat = torch.cat([tree[k].reshape(-1) for k in keys])
            every = flat.new_empty(n * flat.numel())
            gather_single(every, flat, group=self._groups[(axis,)])
            parts = every.view(n, -1)
            at = 0
            for k in keys:
                v = tree[k]
                size = v.numel()
                out[k] = torch.cat([parts[i, at:at + size].view(v.shape)
                                    for i in range(n)],
                                   dim=self._dim(k, axis))
                at += size
        return out

    def unshard(self, tree: dict[str, torch.Tensor], axis: str | None = None
                ) -> dict[str, torch.Tensor]:
        """The model axis's parts first (back in the canonical layout),
        then the expert axis's, then the fsdp axis's, then the other
        pipeline stages' blocks (in the tree's order)."""
        for ax in ("model", "expert", "fsdp"):
            if axis not in (None, ax):
                continue
            keys = [k for k in tree if self._dim(k, ax) is not None]
            tree = self._gather(tree, ax, keys)
            if ax == "model":
                tree = dict(tree, **{k: tensor.to_run(
                    k, tree[k], self.model_size, inverse=True)
                    for k in keys})
        if axis in (None, "pipe") and self._away:
            tree = self._gather_stages(tree)
        return tree

    def _stage_keys(self) -> list[list[str]]:
        """Each stage's block leaves, in the tree's order."""
        out: list[list[str]] = [[] for _ in range(self.pipe_size)]
        for k in self._order:
            if k in self._staged:
                out[self._staged[k]].append(k)
        return out

    def _gather_stages(self, tree: dict[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
        """`tree` with every stage's blocks, whole: each stage's leaves
        broadcast from its rank in the pipe group, one broadcast a stage
        and dtype."""
        import torch.distributed as dist

        got = dict(tree)
        group = self._groups[("pipe",)]
        for s, keys in enumerate(self._stage_keys()):
            mine = s == self.pipe_index
            meta = {k: (tuple(tree[k].shape), tree[k].dtype) if mine
                    else self._away[k] for k in keys}
            by_dtype: dict[torch.dtype, list[str]] = {}
            for k in keys:
                by_dtype.setdefault(meta[k][1], []).append(k)
            for dt, ks in by_dtype.items():
                sizes = [math.prod(meta[k][0]) for k in ks]
                flat = (torch.cat([tree[k].reshape(-1) for k in ks]) if mine
                        else torch.empty(sum(sizes), dtype=dt,
                                         device=self.device))
                dist.broadcast(flat, src=self._pipe_ranks[s], group=group)
                for k, part in zip(ks, flat.split(sizes)):
                    got[k] = part.view(meta[k][0])
        return {k: got[k] for k in self._order if k in got}

    def forward_params(self, params: dict[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
        tree = self.unshard(params, "fsdp")
        return self._gather(tree, "model",
                            [k for k in tree if k in self._gathered])

    @torch.no_grad()
    def whole_pairs(self, tree: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
        keys = [k for k in tree if self._dim(k, "model") is not None
                and k not in self._gathered]
        out = self._gather({k: v.detach() for k, v in tree.items()},
                           "model", keys)
        return dict(out, **{k: tensor.to_run(k, out[k], self.model_size,
                                             inverse=True) for k in keys})

    def leaf_sums(self, sums: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        by_axes: dict[tuple, list[str]] = {}
        for k in sums:
            if k in self._placed:
                axes = {a for a, _ in self._placed[k]}
                by_axes.setdefault(tuple(a for a in _AXES if a in axes),
                                   []).append(k)
        out = dict(sums)
        for axes, keys in by_axes.items():
            stacked = torch.stack([sums[k].float() for k in keys])
            self._all_reduce(stacked, axes)
            out.update(zip(keys, stacked.unbind()))
        if self._away:
            # the other stages' blocks, each stage's sums in one all-gather
            # over the pipe group (every stage holds as many leaves), in
            # their leaves' dtype
            stages = self._stage_keys()
            mine = torch.stack([out[k].float()
                                for k in stages[self.pipe_index]])
            every = self._axis_gather(mine, "pipe", 0).view(
                self.pipe_size, -1)
            for s, keys in enumerate(stages):
                if s != self.pipe_index:
                    out.update({k: every[s, j].to(self._away[k][1])
                                for j, k in enumerate(keys)})
        return out

    def group_sum(self, t: torch.Tensor, over) -> torch.Tensor:
        out = t.detach().float().clone()
        self._all_reduce(out, over)
        return out.to(t.dtype)

    def _axis_gather(self, t: torch.Tensor, axis: str, dim: int
                     ) -> torch.Tensor:
        """The parts of `t` of the group along `axis` joined along `dim`
        in the group's order, without gradient."""
        import torch.distributed as dist

        gather_single = getattr(dist, "all_gather_single",
                                dist.all_gather_into_tensor)
        t = t.detach().contiguous()
        n = self._size[axis]
        every = t.new_empty(n * t.numel())
        gather_single(every, t.reshape(-1), group=self._groups[(axis,)])
        return torch.cat(list(every.view(n, *t.shape)), dim=dim)

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return self._axis_gather(t, "model", dim)

    def seq_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The seq group's parts of `t` (each rank's slice of the frames)
        joined along `dim`, without gradient."""
        return self._axis_gather(t, "seq", dim)

    def seq_reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """`t`, whole along `dim` on every rank of the seq group, summed
        over the group, this rank's part along `dim` kept (one
        reduce-scatter), without gradient."""
        import torch.distributed as dist

        scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)
        whole = t.detach().movedim(dim, 0).contiguous()
        mine = whole.new_empty((whole.shape[0] // self.seq_size,)
                               + tuple(whole.shape[1:]))
        scatter_single(mine, whole, group=self._groups[("seq",)])
        return mine.movedim(0, dim)

    def pipe_send(self, t: torch.Tensor, stage: int, tag: int = 0):
        """Start sending `t` to the rank of pipeline stage `stage` in this
        rank's pipe group (the JAX pipeline's ``ppermute``); returns what
        ``wait_all`` takes. Under gloo a CUDA tensor goes through a host
        copy."""
        import torch.distributed as dist

        t = t.detach()
        t = (t.cpu() if self._host_p2p else t).contiguous()
        return dist.isend(t, dst=self._pipe_ranks[stage], tag=tag), t

    def pipe_recv(self, shape: tuple[int, ...], dtype: torch.dtype,
                  stage: int, tag: int = 0) -> torch.Tensor:
        """The tensor the rank of stage `stage` sends with `tag`, on this
        rank's device."""
        import torch.distributed as dist

        buf = torch.empty(shape, dtype=dtype, device=(
            "cpu" if self._host_p2p else self.device))
        dist.recv(buf, src=self._pipe_ranks[stage], tag=tag)
        return buf.to(self.device)

    @staticmethod
    def wait_all(sends: list) -> None:
        """Wait for the sends ``pipe_send`` started."""
        for work, _ in sends:
            work.wait()

    def model_part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return shard_leaf(t, dim, self.model_index, self.model_size)
