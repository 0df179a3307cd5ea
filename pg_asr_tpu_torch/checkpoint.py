"""The port's checkpoint format: ``<model_path>/config.json`` in the JAX
package's schema (``config.Config``) beside ``model_best.pt`` /
``model_last.pt`` and, with ``train.keep_ckpts``, the newest per-epoch
snapshots ``model_epochNNNN.pt``. Each ``.pt`` file is a ``torch.save``d
dict holding ``params`` (the model's state dict) and, when the trainer
wrote it, the trainer's state: ``opt_state`` (AdamW moments and count;
with ``accum_steps`` also ``mini_step`` and ``acc_grads``), ``step``,
``epoch``, ``batches_done`` (> 0: saved mid-epoch), ``best_val_loss``,
``rng_state`` (the step generator's) and, with ``ema_decay``,
``ema_params``. Reading the JAX package's flax ``.ckpt`` files is not
ported yet (ROADMAP.md)."""

from __future__ import annotations

import glob
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


def epoch_snapshots(model_path: str) -> list[str]:
    """The per-epoch snapshots in <model_path>, oldest first."""
    return sorted(glob.glob(os.path.join(model_path, "model_epoch*.pt")))


def save_rolling(model_path: str, state: dict, epoch: int, keep: int) -> str:
    """Write model_epochNNNN.pt and keep the newest `keep` snapshots (the
    JAX package's ``CheckpointManager.save_rolling``)."""
    path = os.path.join(model_path, f"model_epoch{epoch:04d}.pt")
    save_checkpoint(path, state)
    for old in epoch_snapshots(model_path)[:-keep]:
        os.unlink(old)
    return path


def average_checkpoints(paths: list[str], key: str = "params"
                        ) -> dict[str, torch.Tensor]:
    """The uniform average of the `key` state dicts of `paths`: floating
    tensors summed in float64, divided by the count and cast back; other
    tensors the last checkpoint's (the JAX package's
    ``average_checkpoints``). Raises KeyError when a file lacks `key`."""
    if not paths:
        raise ValueError("average_checkpoints needs at least one path")
    acc: dict[str, torch.Tensor] = {}
    last: dict[str, torch.Tensor] = {}
    for p in paths:
        last = load_checkpoint(p)[key]
        for k, t in last.items():
            if t.is_floating_point():
                acc[k] = t.double() if k not in acc else acc[k] + t.double()
    return {k: (acc[k] / float(len(paths))).to(t.dtype)
            if t.is_floating_point() else t for k, t in last.items()}
