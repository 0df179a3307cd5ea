"""Segment-masked multi-head attention as hand-written CUDA kernels
(csrc/flash_attn.cu, csrc/flash_attn_bwd.cu) and their launchers.

Replace the TPU kernels that pg_asr_tpu/ops/flash_attn.py ``mhsa`` reaches:
JAX's library Pallas TPU flash attention, called with segment ids (valid =
1, pad = 0): its forward (``flash_attn_cuda``; with ``residuals`` the form
its custom VJP saves, which also writes the row sum l and row max m) and
the two kernels of its backward, dk and dv (``flash_attn_bwd_dkv_cuda``)
and dq (``flash_attn_bwd_dq_cuda``). The launchers take CUDA tensors only
and launch the kernel or raise; ops/flash_attn.py chooses between them and
the plain versions by the tensor's device. There is no fallback.

q, k, v and do are read in place through their (batch, head, time)
strides, so views of a fused (B, T, 3, H, dh) projection need no copy;
only a head axis that is not contiguous is copied first. Each output is
written in a (B, T, H, dh) buffer and returned as its (B, H, T, dh) view,
so the caller's transpose back to (B, T, H * dh) is free.

Launch counts (each launcher adds one where it launches its kernel,
nowhere else), so that a run can show its path went through them:
``LAUNCHES`` the forward's inference form, ``RES_LAUNCHES`` its residual
form, ``DKV_LAUNCHES`` and ``DQ_LAUNCHES`` the backward kernels.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["HEAD_DIMS", "LAUNCHES", "RES_LAUNCHES", "DKV_LAUNCHES",
           "DQ_LAUNCHES", "flash_attn_cuda", "flash_attn_bwd_dkv_cuda",
           "flash_attn_bwd_dq_cuda"]

LAUNCHES = 0
RES_LAUNCHES = 0
DKV_LAUNCHES = 0
DQ_LAUNCHES = 0
HEAD_DIMS = (32, 64)  # the kernels' template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_HEAD_DIM = -6  # csrc/common.cuh kErrHeadDim
_declared = False


def _lib() -> ctypes.CDLL:
    global _declared
    lib = load_library()
    if not _declared:
        vp, ci, ll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.pgasr_flash_attn.argtypes = ([vp] * 7 + [ll] * 12 + [ci] * 4
                                         + [cf, ci, vp])
        lib.pgasr_flash_attn_bwd_dkv.argtypes = [vp] * 11 + [ci] * 4 + [
            cf, ci, vp]
        lib.pgasr_flash_attn_bwd_dq.argtypes = [vp] * 10 + [ci] * 4 + [
            cf, ci, vp]
        for fn in (lib.pgasr_flash_attn, lib.pgasr_flash_attn_bwd_dkv,
                   lib.pgasr_flash_attn_bwd_dq):
            fn.restype = ci
        lib.pgasr_cuda_error_string.argtypes = [ci]
        lib.pgasr_cuda_error_string.restype = ctypes.c_char_p
        _declared = True
    return lib


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid_mask: torch.Tensor):
    """Device, types and shapes of a launch -> (B, H, T, dh)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
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
        raise ValueError(f"{name} supports head dims {HEAD_DIMS}, got {dh}")
    if tuple(valid_mask.shape) != (B, T):
        raise ValueError(f"valid_mask must be ({B}, {T}), got "
                         f"{tuple(valid_mask.shape)}")
    return B, H, T, dh


def _inner(t: torch.Tensor) -> torch.Tensor:
    """t itself if its dh axis is contiguous, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _out(q: torch.Tensor) -> torch.Tensor:
    """A (B, H, T, dh) view of a new (B, T, H, dh) buffer in q's type."""
    B, H, T, dh = q.shape
    return torch.empty(B, T, H, dh, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _raise_on(rc: int, lib, name: str, q: torch.Tensor) -> None:
    if rc != 0:
        msg = ("head dim not supported" if rc == _ERR_HEAD_DIM
               else lib.pgasr_cuda_error_string(rc).decode())
        B, H, T, dh = q.shape
        raise RuntimeError(f"{name} kernel (B={B}, H={H}, T={T}, dh={dh}, "
                           f"{q.dtype}): {msg}")


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: torch.Tensor, sm_scale: float,
                    residuals: bool = False):
    """Launch flash_attn: q, k, v (B, H, T, dh) float32 or bfloat16 on one
    CUDA device, dh in HEAD_DIMS, valid_mask (B, T) -> the (B, H, T, dh)
    context in q's type; with ``residuals`` -> (o, l, m), l and m (B, H, T)
    float32 (the row sum and max). Raises on anything else."""
    global LAUNCHES, RES_LAUNCHES
    B, H, T, dh = _check("flash_attn", q, k, v, valid_mask)
    q, k, v = _inner(q), _inner(k), _inner(v)
    seg = valid_mask.to(torch.int32).contiguous()
    o = _out(q)
    l = m = None
    if residuals:
        l, m = (torch.empty(B, H, T, dtype=torch.float32, device=q.device)
                for _ in range(2))
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            o.data_ptr(), None if l is None else l.data_ptr(),
            None if m is None else m.data_ptr(), *strides, B, H, T, dh,
            float(sm_scale), _DTYPES[q.dtype], stream)
    _raise_on(rc, lib, "flash_attn", q)
    if residuals:
        RES_LAUNCHES += 1
        return o, l, m
    LAUNCHES += 1
    return o


def _bwd_inputs(name, q, k, v, valid_mask, l, m, do, di):
    """Checks of a backward launch -> (q, k, v, do, seg, (B, H, T, dh))."""
    shape = _check(name, q, k, v, valid_mask)
    if do.device != q.device or do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"do must be a {tuple(q.shape)} {q.dtype} tensor on "
                         f"{q.device}, got {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}")
    for what, t in (("l", l), ("m", m), ("di", di)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape[:3] or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous {shape[:3]} "
                             f"float32 tensor on {q.device}")
    seg = valid_mask.to(torch.int32).contiguous()
    return _inner(q), _inner(k), _inner(v), _inner(do), seg, shape


def flash_attn_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid_mask: torch.Tensor,
                            l: torch.Tensor, m: torch.Tensor,
                            do: torch.Tensor, di: torch.Tensor,
                            sm_scale: float):
    """Launch flash_attn_bwd_dkv: the forward's inputs, its residuals l, m
    (B, H, T) float32, the output gradient do (q's shape and type) and di =
    sum(o . do) (B, H, T) float32 -> (dk, dv) in q's type. Raises on
    anything else."""
    global DKV_LAUNCHES
    q, k, v, do, seg, (B, H, T, dh) = _bwd_inputs(
        "flash_attn_bwd_dkv", q, k, v, valid_mask, l, m, do, di)
    dk, dv = _out(q), _out(q)
    # the dq slot is not read by this kernel
    strides = (ctypes.c_longlong * 21)(*[
        s for t in (q, k, v, do, dk, dk, dv) for s in t.stride()[:3]])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            seg.data_ptr(), l.data_ptr(), m.data_ptr(), di.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, B, H, T, dh,
            float(sm_scale), _DTYPES[q.dtype], stream)
    _raise_on(rc, lib, "flash_attn_bwd_dkv", q)
    DKV_LAUNCHES += 1
    return dk, dv


def flash_attn_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_mask: torch.Tensor, l: torch.Tensor,
                           m: torch.Tensor, do: torch.Tensor, di: torch.Tensor,
                           sm_scale: float) -> torch.Tensor:
    """Launch flash_attn_bwd_dq: inputs as ``flash_attn_bwd_dkv_cuda`` ->
    dq in q's type. Raises on anything else."""
    global DQ_LAUNCHES
    q, k, v, do, seg, (B, H, T, dh) = _bwd_inputs(
        "flash_attn_bwd_dq", q, k, v, valid_mask, l, m, do, di)
    dq = _out(q)
    # the dk and dv slots are not read by this kernel
    strides = (ctypes.c_longlong * 21)(*[
        s for t in (q, k, v, do, dq, dq, dq) for s in t.stride()[:3]])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            seg.data_ptr(), l.data_ptr(), m.data_ptr(), di.data_ptr(),
            dq.data_ptr(), strides, B, H, T, dh, float(sm_scale),
            _DTYPES[q.dtype], stream)
    _raise_on(rc, lib, "flash_attn_bwd_dq", q)
    DQ_LAUNCHES += 1
    return dq
