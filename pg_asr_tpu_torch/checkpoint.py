"""The port's checkpoint format: ``<model_path>/config.json`` in the JAX
package's schema (``config.Config``) beside ``model_best.pt`` /
``model_last.pt`` and, with ``train.keep_ckpts``, the newest per-epoch
snapshots ``model_epochNNNN.pt``. Each ``.pt`` file is a ``torch.save``d
dict holding ``params`` (the model's state dict) and, when the trainer
wrote it, the trainer's state: ``opt_state`` (AdamW moments and count;
with ``accum_steps`` also ``mini_step`` and ``acc_grads``), ``step``,
``epoch``, ``batches_done`` (> 0: saved mid-epoch), ``best_val_loss``,
``rng_state`` (the step generator's) and, with ``ema_decay``,
``ema_params``.

The JAX package's checkpoints (``model_best.ckpt``, ``model_last.ckpt``,
``model_epoch*.ckpt``: ``flax.serialization.to_bytes`` of a state dict)
are read by ``read_flax_checkpoint``, a decoder of the part of msgpack
that flax writes, in pure Python (neither msgpack nor flax is needed), and
``load_checkpoint`` gives their ``params`` and ``ema_params`` as the
port's state dicts (``convert.params_from_jax``: every family's tree, the
seq2seq family's ``encoder``, ``embed``, ``dec_lstm`` and ``output``
included). Where a model directory holds both formats the port's ``.pt``
files are read.
"""

from __future__ import annotations

import glob
import os
import struct
import tempfile

import numpy as np
import torch

from .config import Config

BEST_NAME = "model_best.pt"
LAST_NAME = "model_last.pt"
FLAX_NAMES = {"best": "model_best.ckpt", "last": "model_last.ckpt"}

# the dtype names of flax's ndarray records that the port reads
# ("bfloat16" is ml_dtypes' name: read as its raw 16 bits)
_DTYPES = ("float32", "float64", "float16", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "bool")


class _Msgpack:
    """A msgpack reader for what flax writes: maps, arrays, str, bin,
    ints, floats, bool, nil and the ext records 1 (ndarray) and 3 (numpy
    scalar), each a packed (shape, dtype name, C-order bytes)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._unpack(
                {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), self._take(n))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self._unpack(">b")
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):
            n = self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self._take(n), "utf-8")
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack byte 0x{b:02x} is not in what flax writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    @staticmethod
    def _ext(code: int, payload: memoryview) -> torch.Tensor:
        if code not in (1, 3):  # 1 ndarray, 3 numpy scalar
            raise ValueError(f"msgpack ext type {code} is not an array")
        shape, name, buf = _Msgpack(bytes(payload)).read()
        name = name.decode() if isinstance(name, bytes) else name
        if name not in _DTYPES:
            raise ValueError(f"unsupported dtype {name!r} in a flax array")
        # a copy the tensor owns (the payload is read-only)
        raw = np.frombuffer(buf, np.uint8).copy()
        if name == "bfloat16":
            t = torch.from_numpy(raw.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(raw.view(np.dtype(name)))
        return t.reshape(tuple(shape))


def _unchunk(node):
    """flax's ``__msgpack_chunked_array__`` records (leaves over 2**30
    bytes, flattened in pieces) back into arrays."""
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def read_flax_checkpoint(path: str) -> dict:
    """The state dict in a file written by ``flax.serialization.to_bytes``
    (the JAX package's ``.ckpt`` checkpoints): nested dicts with str keys
    (flax writes lists as {"0": ..., "1": ...}), CPU tensors for arrays
    and numpy scalars (bfloat16 included), Python numbers, str, bytes,
    bool and None for the rest."""
    with open(path, "rb") as fo:
        reader = _Msgpack(fo.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return _unchunk(tree)


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


def cleanup_tmp(model_path: str) -> None:
    """Remove what a save cut short left in `model_path` (its temporary
    ``tmp*.tmp`` files: a process killed mid-save runs no ``finally``). The
    trainer calls it before its first save, on the one process that
    writes."""
    for path in glob.glob(os.path.join(model_path, "tmp*.tmp")):
        os.unlink(path)


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint onto the CPU (tensors and numbers only, no pickled
    code). Its ``params`` entry is the model's state dict. A JAX package
    ``.ckpt`` file comes back with its ``params`` and ``ema_params`` as
    the port's state dicts and its other entries as read."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if path.endswith(".ckpt"):
        from .convert import params_from_jax

        state = read_flax_checkpoint(path)
        return {k: params_from_jax(v) if k in ("params", "ema_params") else v
                for k, v in state.items()}
    return torch.load(path, map_location="cpu", weights_only=True)


def find_checkpoint(model_path: str, which: str = "best") -> str:
    """model_{best,last}.pt, or the JAX package's model_{best,last}.ckpt
    where there is no .pt; the .pt path when neither exists."""
    path = checkpoint_path(model_path, which)
    flax_path = os.path.join(model_path, FLAX_NAMES[which])
    if not os.path.exists(path) and os.path.exists(flax_path):
        return flax_path
    return path


def has_flax_checkpoints(model_path: str) -> bool:
    """Whether model_path holds a JAX package run (.ckpt files)."""
    return (any(os.path.exists(os.path.join(model_path, n))
                for n in FLAX_NAMES.values())
            or bool(glob.glob(os.path.join(model_path, "model_epoch*.ckpt"))))


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


def epoch_snapshots(model_path: str, ext: str = ".pt") -> list[str]:
    """The per-epoch snapshots in <model_path>, oldest first (ext ".ckpt":
    the JAX package's)."""
    return sorted(glob.glob(os.path.join(model_path, f"model_epoch*{ext}")))


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
