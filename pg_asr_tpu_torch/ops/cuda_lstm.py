"""LSTM recurrence kernels written by hand in CUDA (csrc/lstm_fwd.cu,
csrc/lstm_bwd.cu; the fused-direction csrc/bilstm_fwd.cu, csrc/bilstm_bwd.cu)
and their wrappers.

Replaces pg_asr_tpu/ops/pallas_lstm.py ``_kernel`` (inference form and the
``train=True`` residual form) and ``_kernel_bwd``, and their fused-direction
twins ``_kernel_bi`` (both forms) and ``_kernel_bi_bwd``. Each launcher
takes CUDA tensors only and launches its kernel or raises; ops/lstm.py
chooses between a launcher and the plain PyTorch version by the tensor's
device. There is no fallback from a kernel to its plain version.

Launch counts, so that a run can show its main path went through the
kernels (each launcher adds one where it launches its kernel, nowhere else):
``LAUNCHES`` the inference form of lstm_fwd, ``RES_LAUNCHES`` its residual
form, ``BWD_LAUNCHES`` lstm_bwd; ``BI_LAUNCHES``, ``BI_RES_LAUNCHES`` and
``BI_BWD_LAUNCHES`` the same three of bilstm_fwd / bilstm_bwd.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["BI_BWD_LAUNCHES", "BI_LAUNCHES", "BI_RES_LAUNCHES",
           "BWD_LAUNCHES", "LAUNCHES", "RES_LAUNCHES", "bilstm_scan_bwd_cuda",
           "bilstm_scan_cuda", "bilstm_scan_residual_cuda",
           "lstm_scan_bwd_cuda", "lstm_scan_cuda", "lstm_scan_residual_cuda"]

LAUNCHES = 0
RES_LAUNCHES = 0
BWD_LAUNCHES = 0
BI_LAUNCHES = 0
BI_RES_LAUNCHES = 0
BI_BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {
    -1: "hidden size H not supported: one block per SM holds 1 or 2 hidden "
        "units (lstm_*: H <= #SMs, or even and <= 2 x #SMs) or, for both "
        "directions, 1, 2 or 4 (bilstm_*: 2H <= #SMs, or H even and <= #SMs, "
        "or H a multiple of 4 and <= 2 x #SMs; bilstm_bwd also H <= 512)",
    -2: "cooperative grid does not fit on the device (blocks not co-resident)",
    -3: "per-block shared memory above the device limit (batch too large)",
    -4: "unsupported dtype",
}
_declared = False


def _lib() -> ctypes.CDLL:
    global _declared
    lib = load_library()
    if not _declared:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pgasr_lstm_fwd.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        lib.pgasr_lstm_fwd.restype = ci
        lib.pgasr_lstm_bwd.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.pgasr_lstm_bwd.restype = ci
        lib.pgasr_bilstm_fwd.argtypes = [vp] * 11 + [ci] * 4 + [vp]
        lib.pgasr_bilstm_fwd.restype = ci
        lib.pgasr_bilstm_bwd.argtypes = [vp] * 15 + [ci] * 4 + [vp]
        lib.pgasr_bilstm_bwd.restype = ci
        lib.pgasr_cuda_error_string.argtypes = [ci]
        lib.pgasr_cuda_error_string.restype = ctypes.c_char_p
        _declared = True
    return lib


def _check(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
           name: str) -> tuple[int, int, int]:
    """Validate the inputs the kernels share; returns (B, T, H)."""
    if xp.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {xp.device}")
    if U.device != xp.device or mask.device != xp.device:
        raise ValueError("xp, U and mask must be on the same device")
    if xp.dtype not in _DTYPES or U.dtype != xp.dtype:
        raise TypeError(f"xp and U must both be float32 or bfloat16, got "
                        f"{xp.dtype} and {U.dtype}")
    if xp.dim() != 3 or xp.shape[-1] % 4:
        raise ValueError(f"xp must be (B, T, 4H), got {tuple(xp.shape)}")
    B, T, H4 = xp.shape
    H = H4 // 4
    if tuple(U.shape) != (H, H4):
        raise ValueError(f"U must be ({H}, {H4}), got {tuple(U.shape)}")
    if tuple(mask.shape) != (B, T):
        raise ValueError(f"mask must be ({B}, {T}), got {tuple(mask.shape)}")
    if B == 0 or T == 0:
        raise ValueError("empty batch or sequence")
    if not (xp.is_contiguous() and U.is_contiguous()):
        raise ValueError("xp and U must be contiguous")
    return B, T, H


def _raise_on(rc: int, lib, kernel: str, B: int, T: int, H: int, dtype) -> None:
    if rc != 0:
        msg = _ERRORS.get(rc) or lib.pgasr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel (B={B}, T={T}, H={H}, {dtype}): "
                           f"{msg}")


def _forward(xp, U, mask, reverse: bool, residuals: bool):
    B, T, H = _check(xp, U, mask, "lstm_fwd")
    m = mask.to(torch.float32).contiguous()
    out = torch.empty(B, T, H, dtype=xp.dtype, device=xp.device)
    hbuf = torch.empty(2, B, H, dtype=torch.float32, device=xp.device)
    hprev = cprev = None
    if residuals:
        hprev = torch.empty(T, B, H, dtype=xp.dtype, device=xp.device)
        cprev = torch.empty(T, B, H, dtype=torch.float32, device=xp.device)
    lib = _lib()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_lstm_fwd(
            xp.data_ptr(), U.data_ptr(), m.data_ptr(), out.data_ptr(),
            hbuf.data_ptr(), hprev.data_ptr() if residuals else None,
            cprev.data_ptr() if residuals else None, B, T, H, int(reverse),
            _DTYPES[xp.dtype], stream)
    _raise_on(rc, lib, "lstm_fwd", B, T, H, xp.dtype)
    return out, hprev, cprev


def lstm_scan_cuda(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """Launch lstm_fwd, inference form. Raises on anything it does not take."""
    global LAUNCHES
    out, _, _ = _forward(xp, U, mask, reverse, residuals=False)
    LAUNCHES += 1
    return out


def lstm_scan_residual_cuda(xp: torch.Tensor, U: torch.Tensor,
                            mask: torch.Tensor, reverse: bool = False):
    """Launch lstm_fwd, residual form -> (out (B,T,H), hprev (T,B,H) in xp's
    type, cprev (T,B,H) float32)."""
    global RES_LAUNCHES
    res = _forward(xp, U, mask, reverse, residuals=True)
    RES_LAUNCHES += 1
    return res


def lstm_scan_bwd_cuda(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                       hprev: torch.Tensor, cprev: torch.Tensor,
                       gy: torch.Tensor, reverse: bool = False):
    """Launch lstm_bwd -> (dxp (B,T,4H) in xp's type, dU (H,4H) in U's)."""
    global BWD_LAUNCHES
    B, T, H = _check(xp, U, mask, "lstm_bwd")
    for name, t, dtype, shape in (("hprev", hprev, xp.dtype, (T, B, H)),
                                  ("cprev", cprev, torch.float32, (T, B, H)),
                                  ("gy", gy, xp.dtype, (B, T, H))):
        if t.device != xp.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {xp.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    m = mask.to(torch.float32).contiguous()
    hprev, cprev, gy = hprev.contiguous(), cprev.contiguous(), gy.contiguous()
    dxp = torch.empty_like(xp)
    dU = torch.empty_like(U)
    dbuf = torch.empty(2, B, 4 * H, dtype=U.dtype, device=xp.device)
    lib = _lib()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_lstm_bwd(
            xp.data_ptr(), U.data_ptr(), m.data_ptr(), hprev.data_ptr(),
            cprev.data_ptr(), gy.data_ptr(), dxp.data_ptr(), dU.data_ptr(),
            dbuf.data_ptr(), B, T, H, int(reverse), _DTYPES[xp.dtype], stream)
    _raise_on(rc, lib, "lstm_bwd", B, T, H, xp.dtype)
    BWD_LAUNCHES += 1
    return dxp, dU


def _check_bi(xpf, xpb, Uf, Ub, mask, name: str) -> tuple[int, int, int]:
    """Validate the fused kernels' inputs: each direction as ``_check``,
    the two of the same shape and type; returns (B, T, H)."""
    shape = _check(xpf, Uf, mask, name)
    if _check(xpb, Ub, mask, name) != shape or xpb.dtype != xpf.dtype:
        raise ValueError(f"{name}: the two directions differ in shape or "
                         f"type: {tuple(xpf.shape)} {xpf.dtype} vs "
                         f"{tuple(xpb.shape)} {xpb.dtype}")
    return shape


def _bi_forward(xpf, xpb, Uf, Ub, mask, residuals: bool):
    B, T, H = _check_bi(xpf, xpb, Uf, Ub, mask, "bilstm_fwd")
    m = mask.to(torch.float32).contiguous()
    dev = xpf.device
    y = torch.empty(B, T, 2 * H, dtype=xpf.dtype, device=dev)
    hbuf = torch.empty(2, 2, B, H, dtype=torch.float32, device=dev)
    res = [None] * 4
    if residuals:
        hp = torch.empty(2, T, B, H, dtype=xpf.dtype, device=dev)
        cp = torch.empty(2, T, B, H, dtype=torch.float32, device=dev)
        res = [hp[0], cp[0], hp[1], cp[1]]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_bilstm_fwd(
            xpf.data_ptr(), xpb.data_ptr(), Uf.data_ptr(), Ub.data_ptr(),
            m.data_ptr(), y.data_ptr(), hbuf.data_ptr(),
            *(r.data_ptr() if residuals else None for r in res), B, T, H,
            _DTYPES[xpf.dtype], stream)
    _raise_on(rc, lib, "bilstm_fwd", B, T, H, xpf.dtype)
    return y, res


def bilstm_scan_cuda(xpf: torch.Tensor, xpb: torch.Tensor, Uf: torch.Tensor,
                     Ub: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch bilstm_fwd, inference form -> y (B, T, 2H). Raises on
    anything it does not take."""
    global BI_LAUNCHES
    y, _ = _bi_forward(xpf, xpb, Uf, Ub, mask, residuals=False)
    BI_LAUNCHES += 1
    return y


def bilstm_scan_residual_cuda(xpf: torch.Tensor, xpb: torch.Tensor,
                              Uf: torch.Tensor, Ub: torch.Tensor,
                              mask: torch.Tensor):
    """Launch bilstm_fwd, residual form -> (y (B,T,2H), hpf, cpf, hpb, cpb),
    each (T,B,H), h in xp's type and c float32."""
    global BI_RES_LAUNCHES
    y, res = _bi_forward(xpf, xpb, Uf, Ub, mask, residuals=True)
    BI_RES_LAUNCHES += 1
    return (y, *res)


def bilstm_scan_bwd_cuda(xpf: torch.Tensor, xpb: torch.Tensor,
                         Uf: torch.Tensor, Ub: torch.Tensor,
                         mask: torch.Tensor, hpf: torch.Tensor,
                         cpf: torch.Tensor, hpb: torch.Tensor,
                         cpb: torch.Tensor, gy: torch.Tensor):
    """Launch bilstm_bwd -> (dxpf, dxpb (B,T,4H) in xp's type, dUf, dUb
    (H,4H) in U's)."""
    global BI_BWD_LAUNCHES
    B, T, H = _check_bi(xpf, xpb, Uf, Ub, mask, "bilstm_bwd")
    for name, t, dtype, shape in (("hpf", hpf, xpf.dtype, (T, B, H)),
                                  ("cpf", cpf, torch.float32, (T, B, H)),
                                  ("hpb", hpb, xpf.dtype, (T, B, H)),
                                  ("cpb", cpb, torch.float32, (T, B, H)),
                                  ("gy", gy, xpf.dtype, (B, T, 2 * H))):
        if t.device != xpf.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {xpf.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    m = mask.to(torch.float32).contiguous()
    hpf, cpf, hpb, cpb, gy = (t.contiguous() for t in (hpf, cpf, hpb, cpb, gy))
    dxpf, dxpb = torch.empty_like(xpf), torch.empty_like(xpb)
    dUf, dUb = torch.empty_like(Uf), torch.empty_like(Ub)
    dbuf = torch.empty(2, 2, B, 4 * H, dtype=Uf.dtype, device=xpf.device)
    lib = _lib()
    with torch.cuda.device(xpf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_bilstm_bwd(
            *(t.data_ptr() for t in (xpf, xpb, Uf, Ub, m, hpf, cpf, hpb, cpb,
                                     gy, dxpf, dxpb, dUf, dUb, dbuf)),
            B, T, H, _DTYPES[xpf.dtype], stream)
    _raise_on(rc, lib, "bilstm_bwd", B, T, H, xpf.dtype)
    BI_BWD_LAUNCHES += 1
    return dxpf, dxpb, dUf, dUb
