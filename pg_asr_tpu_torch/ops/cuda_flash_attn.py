"""Segment-masked multi-head attention as a hand-written CUDA kernel
(csrc/flash_attn.cu) and its launcher.

Replaces the TPU kernel that pg_asr_tpu/ops/flash_attn.py ``mhsa`` reaches:
JAX's library Pallas TPU flash attention forward, called with segment ids
(valid = 1, pad = 0). The launcher takes CUDA tensors only and launches the
kernel or raises; ops/flash_attn.py chooses between it and the plain
version by the tensor's device. There is no fallback.

q, k and v are read in place through their (batch, head, time) strides,
so views of a fused (B, T, 3, H, dh) projection need no copy; only a head
axis that is not contiguous is copied first. The output is written in a
(B, T, H, dh) buffer and returned as its (B, H, T, dh) view, so the caller's
transpose back to (B, T, H * dh) is free.

``LAUNCHES`` counts launches (the launcher adds one where it launches the
kernel, nowhere else), so that a run can show its path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["HEAD_DIMS", "LAUNCHES", "flash_attn_cuda"]

LAUNCHES = 0
HEAD_DIMS = (32, 64)  # the kernel's template instances (csrc/flash_attn.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_HEAD_DIM = -6  # csrc/common.cuh kErrHeadDim
_declared = False


def _lib() -> ctypes.CDLL:
    global _declared
    lib = load_library()
    if not _declared:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pgasr_flash_attn.argtypes = ([vp] * 5 + [ll] * 12 + [ci] * 4
                                         + [ctypes.c_float, ci, vp])
        lib.pgasr_flash_attn.restype = ci
        lib.pgasr_cuda_error_string.argtypes = [ci]
        lib.pgasr_cuda_error_string.restype = ctypes.c_char_p
        _declared = True
    return lib


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Launch flash_attn: q, k, v (B, H, T, dh) float32 or bfloat16 on one
    CUDA device, dh in HEAD_DIMS, valid_mask (B, T) -> the (B, H, T, dh)
    context in q's type. Raises on anything else."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn needs CUDA tensors, got {q.device}")
    if any(t.device != q.device for t in (k, v, valid_mask)):
        raise ValueError("q, k, v and valid_mask must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one (B, H, T, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, dh = q.shape
    if 0 in q.shape:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attn supports head dims {HEAD_DIMS}, got "
                         f"{dh}")
    if tuple(valid_mask.shape) != (B, T):
        raise ValueError(f"valid_mask must be ({B}, {T}), got "
                         f"{tuple(valid_mask.shape)}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    seg = valid_mask.to(torch.int32).contiguous()
    o = torch.empty(B, T, H, dh, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  seg.data_ptr(), o.data_ptr(), *strides, B,
                                  H, T, dh, float(sm_scale), _DTYPES[q.dtype],
                                  stream)
    if rc != 0:
        msg = ("head dim not supported" if rc == _ERR_HEAD_DIM
               else lib.pgasr_cuda_error_string(rc).decode())
        raise RuntimeError(f"flash_attn kernel (B={B}, H={H}, T={T}, "
                           f"dh={dh}, {q.dtype}): {msg}")
    LAUNCHES += 1
    return o
