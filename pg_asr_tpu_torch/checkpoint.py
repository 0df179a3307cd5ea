"""The port's checkpoint format: ``<model_path>/config.json`` in the JAX
package's schema (``config.Config``) beside ``model_best.pt`` /
``model_last.pt``. Each ``.pt`` file is a ``torch.save``d dict holding
``params`` (the model's state dict) and, when the trainer wrote it, the
trainer's state: ``opt_state`` (AdamW moments and count), ``step``,
``epoch`` and ``best_val_loss``. Reading the JAX package's flax ``.ckpt``
files is not ported yet (ROADMAP.md)."""

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


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, state: dict) -> None:
    """Atomic write of a (nested) state dict to `path`; tensors go to CPU."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint onto the CPU (tensors and numbers only, no pickled
    code). Its ``params`` entry is the model's state dict."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def save_config(model_path: str, cfg: Config) -> None:
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "config.json"), "w") as fo:
        fo.write(cfg.to_json())


def save_model(model_path: str, params: dict[str, torch.Tensor],
               cfg: Config, which: tuple[str, ...] = ("best", "last")) -> None:
    """Write config.json and the named checkpoints of one model (params
    only, no trainer state)."""
    save_config(model_path, cfg)
    for w in which:
        save_checkpoint(checkpoint_path(model_path, w), {"params": params})
