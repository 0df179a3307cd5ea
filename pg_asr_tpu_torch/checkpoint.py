"""The port's checkpoint format: ``<model_path>/config.json`` in the JAX
package's schema (``config.Config``) beside ``model_best.pt`` /
``model_last.pt``, each a ``torch.save``d state dict. Reading the JAX
package's flax ``.ckpt`` files is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import os
import tempfile

import torch

from .config import Config

BEST_NAME = "model_best.pt"
LAST_NAME = "model_last.pt"


def checkpoint_path(model_path: str, which: str = "best") -> str:
    if which not in ("best", "last"):
        raise ValueError(f"which must be best or last, got {which!r}")
    return os.path.join(model_path, BEST_NAME if which == "best" else LAST_NAME)


def save_checkpoint(path: str, state: dict[str, torch.Tensor]) -> None:
    """Atomic write of a state dict to `path`."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        torch.save({k: v.detach().cpu() for k, v in state.items()}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a state dict onto the CPU (tensors only, no pickled code)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def save_model(model_path: str, params: dict[str, torch.Tensor],
               cfg: Config, which: tuple[str, ...] = ("best", "last")) -> None:
    """Write config.json and the named checkpoints of one model."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "config.json"), "w") as fo:
        fo.write(cfg.to_json())
    for w in which:
        save_checkpoint(checkpoint_path(model_path, w), params)
