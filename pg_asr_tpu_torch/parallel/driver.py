"""Mesh specs and the strategy router (counterpart of
pg_asr_tpu/parallel/driver.py).

The user writes ``--mesh data=2`` as for the JAX CLI, and ``parse_mesh_spec``
reads it with the JAX package's rules and messages. The port runs the
``data`` axis: N rank processes over torch.distributed, one device each,
the batch's rows split over them and the loss and gradients summed
(parallel/mesh.py, train.py, rl/reinforce.py). ``data_parallel_size``
routes a config: it returns the size of the ``data`` axis, or refuses an
axis the port does not run yet, naming its ROADMAP.md item.
"""

from __future__ import annotations

from .. import not_ported

MESH_AXES = ("data", "model", "pipe", "seq", "expert", "fsdp")

# the axes the port does not run yet -> their ROADMAP.md queue 1 item
_UNPORTED_AXES = {"expert": "15b.2", "model": "15b.3", "fsdp": "15b.3",
                  "seq": "15b.3", "pipe": "15b.3"}


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


def data_parallel_size(mesh_shape: tuple[int, ...],
                       mesh_axes: tuple[str, ...],
                       microbatches: int = 0) -> int:
    """The ``data`` axis's size of a mesh (1 without one: ``mesh_shape``
    empty, one device, where the JAX package takes every local device).
    Raises ``not_ported`` for any other live axis (size > 1) and for
    pipeline microbatches."""
    sizes = dict(zip(mesh_axes, mesh_shape))
    for axis, item in _UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise not_ported(f"--mesh {axis}={sizes[axis]} (the {axis} axis, "
                             f"item {item} of ROADMAP.md queue 1)")
    if microbatches:
        raise not_ported("--microbatches (the pipeline mesh, item 15b.3 of "
                         "ROADMAP.md queue 1)")
    return sizes.get("data", 1)
