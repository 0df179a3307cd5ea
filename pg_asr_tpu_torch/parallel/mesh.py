"""The ``data`` mesh axis over torch.distributed (counterpart of the data
half of pg_asr_tpu/parallel/mesh.py).

The JAX package runs ``--mesh data=N`` in one process over N devices (and
over hosts with ``jax.distributed``). The port runs one process per rank,
PyTorch's way: each rank holds the whole model on its own device, takes
its own rows of the batch, and the steps sum the loss's denominators and
the gradients over the ranks (train.py, rl/reinforce.py), as the JAX
package's ``shard_map`` step does with ``psum``.

  * ``init_distributed``: the process group, from a ``tcp://`` rendezvous
    at the coordinator's address; NCCL for a CUDA rank, gloo for a CPU
    rank, unless the caller names a backend. A configured cluster that
    fails raises: it never carries on as a single process.
  * ``DataParallel``: this rank's place on the data axis and the
    collectives the steps make (all sums but the stop agreement, which
    takes a max): ``ONE_DEVICE`` without a process group, every collective
    the identity; ``GroupRank`` in the joined group.
  * ``pad_batch_to_multiple``, ``local_rows``: a global batch laid out over
    the ranks as the JAX package lays it out over the devices of a mesh.
"""

from __future__ import annotations

import datetime
import socket

import numpy as np
import torch

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


def join_data_axis(size: int, device: torch.device | str) -> "DataParallel":
    """This process's rank on a data axis of `size` ranks: ``ONE_DEVICE``
    outside any process group; else the joined group's ``GroupRank``,
    whose world size must be `size`."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if size > 1:
            raise ValueError(
                f"--mesh data={size} needs {size} rank processes joined in "
                "a process group (parallel/mesh.init_distributed); the CLI "
                "starts them")
        return ONE_DEVICE
    if dist.get_world_size() != size:
        raise ValueError(
            f"--mesh data={size} in a process group of "
            f"{dist.get_world_size()} ranks: the data axis must equal the "
            "world size")
    return GroupRank(device)


class DataParallel:
    """This process's rank on the ``data`` axis and the collectives that
    the data-parallel steps make; reductions are sums unless named
    otherwise. This base is the run without a process group (one device,
    ``ONE_DEVICE``): rank 0 of 1, every collective the identity, so that
    the steps have one body for one device and for N ranks."""

    rank, world, is_main = 0, 1, True

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `t`."""
        return t

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_sum(t) / self.world

    def sum_grads(self, grads: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """Every gradient summed over the ranks."""
        return grads

    def broadcast_(self, tensors: dict[str, torch.Tensor]) -> None:
        """Rank 0's values into every rank's tensors, in place."""

    def any(self, flag: bool) -> bool:
        """True on every rank when it is True on any (a max over ranks)."""
        return flag

    def sum_counts(self, *counts: int) -> tuple[int, ...]:
        """Host integers summed over the ranks."""
        return counts

    def exclusive_offsets(self, counts: torch.Tensor):
        """For per-rank counts (K,) int64: (the sum over the ranks before
        this one, the sum over all ranks), each (K,): the rank-major
        global order that the MoE's expert slots follow."""
        return torch.zeros_like(counts), counts

    def step_generator(self, carried: torch.Generator) -> torch.Generator:
        """The generator of one step's random draws on this rank: on one
        device the carried generator itself."""
        return carried


# the rank of a run without a process group
ONE_DEVICE = DataParallel()


class GroupRank(DataParallel):
    """This process's rank in the joined process group, on `device`. Every
    collective takes and returns tensors on `device` (NCCL reduces device
    tensors only) and returns a new tensor with no gradient."""

    def __init__(self, device: torch.device | str):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.is_main = self.rank == 0  # the one that writes files
        self.device = torch.device(device)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def sum_grads(self, grads: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """One all-reduce a dtype, on the gradients flattened into one
        buffer."""
        import torch.distributed as dist

        by_dtype: dict[torch.dtype, list[str]] = {}
        for k, g in grads.items():
            by_dtype.setdefault(g.dtype, []).append(k)
        out = {}
        for keys in by_dtype.values():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            dist.all_reduce(flat)
            at = 0
            for k in keys:
                n = grads[k].numel()
                out[k] = flat[at:at + n].view_as(grads[k])
                at += n
        return {k: out[k] for k in grads}

    def broadcast_(self, tensors: dict[str, torch.Tensor]) -> None:
        import torch.distributed as dist

        for t in tensors.values():
            dist.broadcast(t, src=0)

    def any(self, flag: bool) -> bool:
        import torch.distributed as dist

        if self.world == 1:  # no agreement to reach: no wait for the card
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
        generator when world > 1); each step draws one seed from it and
        this rank's draws come from a generator on its device seeded from
        that seed and the rank, as the JAX step folds the data axis's index
        into its key. At world 1 the draws are the carried generator's
        own, as on one device without a mesh."""
        if self.world == 1:
            return carried
        seed = int(torch.randint(0, 2 ** 62, (), generator=carried))
        return torch.Generator(device=self.device).manual_seed(
            (seed + self.rank * 0x9E3779B97F4A7C15) % 2 ** 63)
