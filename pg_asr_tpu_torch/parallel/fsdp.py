"""ZeRO-style sharded parameters and optimizer state: the ``fsdp`` mesh
axis (counterpart of pg_asr_tpu/parallel/fsdp.py).

The JAX package places every parameter leaf, its Adam moments and its
gradient sharded over the ``fsdp`` axis on the leaf's largest divisible
dimension and lets GSPMD insert the all-gathers and reduce-scatters around
the unchanged global step. The port makes the same placement
(``fsdp_leaf_spec``: the same rule, ties to the trailing-most dimension)
and the collectives by hand, in parallel/mesh.py:

  * at rest each fsdp rank holds 1/F of every shardable leaf, of its AdamW
    ``mu`` and ``nu``, of its MultiSteps accumulator and of its EMA (the
    leaves with no divisible dimension stay whole on every rank);
  * a step all-gathers the whole tree within the fsdp group
    (``dist.all_gather_into_tensor``, one buffer a dtype), reassembled along
    each leaf's sharded dimension into contiguous tensors (the BiLSTM
    kernels read ``W`` and ``U`` in place), runs the one-device forward and
    backward on it, and frees it;
  * the gradients are reduce-scattered within the fsdp group
    (``dist.reduce_scatter_tensor``) and, under ``data x fsdp``, all-reduced
    over the data group; the clip's global norm sums each shard's squares
    over the fsdp group (train.global_norm), and AdamW, the accumulator and
    the EMA run on the shards;
  * checkpoints hold the full shapes, gathered before rank 0 writes, so
    that any mesh, or one device, resumes or serves them.

The batch is split over ``data x fsdp`` (every rank its own rows), and the
plan refuses an axis size that shards no leaf (parallel/driver.py).
"""

from __future__ import annotations

import math

import torch

from .mesh import shard_leaf

AXIS = "fsdp"


def fsdp_leaf_dim(shape: tuple[int, ...], n: int) -> int | None:
    """The dimension of a leaf of `shape` that an fsdp axis of `n` shards:
    the largest divisible by `n`, ties to the trailing-most, never a
    dimension of 1; None (replicated) when no dimension divides."""
    if n <= 1 or not shape:
        return None
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n == 0 and s >= best_size and s > 1:
            best, best_size = i, s
    return best


def fsdp_leaf_spec(shape: tuple[int, ...], n: int) -> tuple:
    """The leaf's partition spec as the JAX package writes it: one entry a
    dimension, ``"fsdp"`` on the sharded one, else None; ``()`` when
    replicated."""
    dim = fsdp_leaf_dim(tuple(shape), n)
    if dim is None:
        return ()
    return tuple(AXIS if i == dim else None for i in range(len(shape)))


def param_specs(params: dict, n: int) -> dict[str, tuple]:
    """{name: spec} of a parameter dict (tensors or shapes)."""
    return {k: fsdp_leaf_spec(tuple(v.shape), n) for k, v in params.items()}


def shardable_fraction(params: dict, n: int) -> float:
    """The fraction of the parameters' elements that an fsdp axis of `n`
    shards (the rest is replicated)."""
    total = sharded = 0
    for v in params.values():
        size = math.prod(v.shape)
        total += size
        if fsdp_leaf_dim(tuple(v.shape), n) is not None:
            sharded += size
    return sharded / max(total, 1)


def shard_params_fsdp(params: dict[str, torch.Tensor], n: int,
                      index: int) -> dict[str, torch.Tensor]:
    """The shards that fsdp position `index` of `n` holds of full-shape
    leaves: 1/n of each shardable leaf along its dimension, the others
    whole."""
    out = {}
    for k, v in params.items():
        dim = fsdp_leaf_dim(tuple(v.shape), n)
        out[k] = v if dim is None else shard_leaf(v, dim, index, n)
    return out
