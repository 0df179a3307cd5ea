"""Mesh specs and the parallel plan (counterpart of
pg_asr_tpu/parallel/driver.py).

The user writes ``--mesh data=2,fsdp=2`` as for the JAX CLI, and
``parse_mesh_spec`` reads it with the JAX package's rules and messages.
``ParallelPlan`` validates a mesh against a config before any rank process
starts, with the JAX package's ``ValueError`` messages, and says what the
ranks run: one rank process per mesh position (``world``, the product of
the axis sizes), laid out row-major over the axes as given, as
``jax.sharding.Mesh`` lays out its devices (``coords``); each rank's rows
of a batch (the batch splits over ``data``, and over ``data x fsdp`` under
``fsdp``; ``batch_multiple`` counts the microbatches under ``pipe`` too);
and where each parameter leaf lives
(``placement``): whole on every rank, its experts split over ``expert``
(parallel/moe.py), its largest divisible dimension over ``fsdp``
(parallel/fsdp.py), or the dimension the Megatron rules name over
``model`` (parallel/tensor.py), an expert stack under ``model x expert``
over both; under ``pipe`` a block's leaves live on the ranks of its
pipeline stage only (``stage``), its Megatron pairs split over ``model``
within it, and every other leaf is whole on every rank; under ``seq``
every leaf is whole. The steps' collectives are parallel/mesh.py's, the
pipeline's schedule parallel/pipeline.py's and the sequence-parallel
encoder parallel/sequence.py's.

The port runs every axis of the JAX vocabulary: ``data``, ``model``,
``pipe`` (with ``--microbatches``), ``seq``, ``expert`` and ``fsdp``, each
of the others with ``data``, and the JAX pairs ``model x expert`` and
``pipe x model`` (``data x pipe x model``).
"""

from __future__ import annotations

import math

MESH_AXES = ("data", "model", "pipe", "seq", "expert", "fsdp")


def parse_mesh_spec(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """'data=2,pipe=2' -> ((2, 2), ('data', 'pipe'))."""
    shape: list[int] = []
    axes: list[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in MESH_AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} (valid: {', '.join(MESH_AXES)})")
        if name in axes:
            raise ValueError(f"mesh axis {name!r} given twice")
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad mesh axis size in {part!r}") from None
        if n < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1")
        axes.append(name)
        shape.append(n)
    if not axes:
        raise ValueError("empty mesh spec")
    return tuple(shape), tuple(axes)


def mesh_text(shape: tuple[int, ...], axes: tuple[str, ...]) -> str:
    """((2, 2), ('data', 'fsdp')) -> 'data=2,fsdp=2'."""
    return ",".join(f"{a}={n}" for a, n in zip(axes, shape))


class ParallelPlan:
    """What the ranks of a mesh run for a config (the JAX package's
    ``ParallelPlan``: its checks and messages, its batch multiple; the
    placement its sharding rules give). ``mesh_shape`` empty: one device,
    rank 0 of 1."""

    def __init__(self, cfg, mesh_shape: tuple[int, ...] = (),
                 mesh_axes: tuple[str, ...] = (), microbatches: int = 0,
                 replicas: bool = False):
        self.shape, self.axes = tuple(mesh_shape), tuple(mesh_axes)
        sizes = dict(zip(self.axes, self.shape))
        live = [a for a in ("model", "pipe", "seq", "expert", "fsdp")
                if sizes.get(a, 1) > 1]
        composable = ({"model", "expert"}, {"model", "pipe"})
        if len(live) > 1 and set(live) not in composable:
            raise ValueError(
                f"mesh composes {live} — 'data' composes with any ONE of "
                "model/pipe/seq/expert/fsdp (plus the GSPMD pairs "
                "model+expert and model+pipe); other compositions are "
                "not supported")
        # ``replicas`` (a policy-gradient step's plan): the JAX package's
        # ``make_pg_step`` runs one GSPMD step on replicated parameters
        # whatever the mesh, so the ranks of a pipe or seq group run copies
        # of the data (and model) step on the same rows, for any family
        self.copies = ("pipe", "seq") if replicas else ()
        # the strategy that owns the layout ('model' rides along with
        # 'expert' and 'pipe', as in the JAX package)
        own = [a for a in live if a not in self.copies]
        non_model = [a for a in own if a != "model"]
        self.strategy = (non_model[0] if non_model
                         else own[0] if own else "data")
        self.tp = "model" in live
        self.sizes = {a: sizes.get(a, 1) for a in MESH_AXES}
        self.world = math.prod(self.shape)
        self._heads = _num_heads(cfg)
        self.fsdp_coverage = None
        self.microbatches, self.layers = 0, 0
        is_moe = (cfg.model.family == "transformer"
                  and cfg.transformer.num_experts > 0)
        if self.strategy in ("pipe", "seq"):
            if cfg.model.family != "transformer" or is_moe:
                raise ValueError(
                    f"'{self.strategy}' axis requires the dense transformer "
                    f"family (got family={cfg.model.family!r}, "
                    f"num_experts={cfg.transformer.num_experts})")
        if self.strategy == "pipe":
            S = self.sizes["pipe"]
            L = cfg.transformer.num_layers
            if L % S != 0:
                raise ValueError(
                    f"transformer.num_layers={L} not divisible into "
                    f"{S} pipeline stages")
            self.microbatches = microbatches or S
            self.layers = L
            if self.tp:
                t = self.sizes["model"]
                if (cfg.transformer.num_heads % t
                        or cfg.transformer.ffn_dim % t):
                    raise ValueError(
                        f"model axis size {t} must divide num_heads="
                        f"{cfg.transformer.num_heads} and ffn_dim="
                        f"{cfg.transformer.ffn_dim}")
        if self.strategy == "fsdp":
            from .fsdp import shardable_fraction

            n = self.sizes["fsdp"]
            frac = shardable_fraction(_param_shapes(cfg), n)
            if frac == 0.0:
                raise ValueError(
                    f"fsdp={n} shards NO parameter leaf of this model "
                    "(no dimension divisible by the axis size) — it would "
                    "silently degrade to replicated data parallelism; "
                    "pick an axis size that divides the layer dims")
            self.fsdp_coverage = frac
        if self.strategy == "expert":
            E = cfg.transformer.num_experts
            n = self.sizes["expert"]
            if not is_moe:
                raise ValueError(
                    "'expert' axis needs a MoE model — set "
                    "--moe_experts N (transformer.num_experts)")
            if E % n != 0:
                raise ValueError(
                    f"num_experts={E} not divisible over expert axis "
                    f"size {n}")

    @property
    def text(self) -> str:
        return mesh_text(self.shape, self.axes) or "none"

    @property
    def batch_multiple(self) -> int:
        """The JAX package's: a batch is zero-padded to a multiple of the
        ranks that hold distinct rows (``data``, times ``fsdp`` under
        ``fsdp``: the ranks of one model, expert, pipe or seq group hold the
        same rows), times the microbatches under ``pipe``."""
        n = self.sizes["data"] * self.sizes["fsdp"]
        return n * self.microbatches if self.strategy == "pipe" else n

    def coords(self, rank: int) -> dict[str, int]:
        """The mesh position of rank `rank` (row-major over the axes as
        given); 0 on an axis the mesh does not name."""
        out = dict.fromkeys(MESH_AXES, 0)
        for axis, n in reversed(tuple(zip(self.axes, self.shape))):
            out[axis] = rank % n
            rank //= n
        return out

    def placement(self, name: str, shape: tuple[int, ...]):
        """Where a parameter leaf (and its optimizer state, accumulator and
        EMA) is split: None when every rank holds it whole, (axis,
        dimension) for one split, and a tuple of those pairs for a leaf
        split over two axes (an expert stack under ``model x expert``).
        Under ``pipe`` this is the split within the leaf's stage
        (``stage``)."""
        splits = self.splits(name, shape)
        if not splits:
            return None
        return splits[0] if len(splits) == 1 else splits

    def splits(self, name: str, shape: tuple[int, ...]
               ) -> tuple[tuple[str, int], ...]:
        """Every (axis, dimension) split of a leaf, expert before model;
        () when it is whole."""
        out = []
        if self.strategy == "expert":
            from .moe import moe_leaf_dim

            dim = moe_leaf_dim(name)
            if dim is not None:
                out.append(("expert", dim))
        if self.strategy == "fsdp":
            from .fsdp import fsdp_leaf_dim

            dim = fsdp_leaf_dim(tuple(shape), self.sizes["fsdp"])
            if dim is not None:
                out.append(("fsdp", dim))
        if self.tp and (self.strategy != "pipe"
                        or self.stage(name) is not None):
            # under pipe x model only the stages' blocks split, as the JAX
            # package's pipeline_stage_specs split them
            from .tensor import model_leaf_dim

            dim = model_leaf_dim(name, tuple(shape), self.sizes["model"],
                                 self._heads, moe=self.strategy == "expert")
            if dim is not None:
                out.append(("model", dim))
        return tuple(out)

    def stage(self, name: str) -> int | None:
        """Under ``pipe``, the pipeline stage whose ranks alone hold leaf
        `name`: block i's leaves on stage i // (L / S), as the JAX
        package's ``stack_pipeline_params`` stacks them; None for a leaf
        every rank holds (the frontend, ``ln_final``, ``ctc_head``) and on
        any other mesh."""
        parts = name.split(".")
        if self.strategy != "pipe" or parts[0] != "blocks":
            return None
        return int(parts[1]) // (self.layers // self.sizes["pipe"])


def _num_heads(cfg) -> int:
    """The attention heads of the config's model (0 without attention)."""
    family = cfg.model.family
    if family == "transducer":
        family = cfg.transducer.encoder
    if family in ("transformer", "conformer"):
        return getattr(cfg, family).num_heads
    return 0


def _param_shapes(cfg) -> dict:
    """The config's parameters as shapes only (tensors on the meta device,
    as the JAX package's ``eval_shape`` probe): nothing is allocated."""
    import torch

    from ..train import init_model_params

    with torch.device("meta"):
        return init_model_params(cfg, torch.Generator(), "meta")
