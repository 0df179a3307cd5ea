"""LSTM forward recurrence as a hand-written CUDA kernel (csrc/lstm_fwd.cu).

Replaces pg_asr_tpu/ops/pallas_lstm.py ``_kernel`` (``pallas_lstm_scan``,
inference form). ``lstm_scan`` picks by the tensor's device: CPU tensors run
``lstm_scan_plain``, its plain PyTorch version; CUDA tensors launch the
kernel or raise. There is no fallback from the kernel to the plain version.

``LAUNCHES`` counts kernel launches, so that a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .lstm import lstm_scan_plain

__all__ = ["LAUNCHES", "lstm_scan", "lstm_scan_cuda", "lstm_scan_plain"]

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {
    -1: "hidden size H not supported: one block per SM holds 1 or 2 hidden "
        "units, so H must be <= #SMs, or even and <= 2 x #SMs",
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
        lib.pgasr_lstm_fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       vp]
        lib.pgasr_lstm_fwd.restype = ci
        lib.pgasr_cuda_error_string.argtypes = [ci]
        lib.pgasr_cuda_error_string.restype = ctypes.c_char_p
        _declared = True
    return lib


def lstm_scan(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """Masked LSTM recurrence: (B, T, 4H) x-projections -> (B, T, H)."""
    if xp.device.type == "cpu":
        return lstm_scan_plain(xp, U, mask, reverse)
    return lstm_scan_cuda(xp, U, mask, reverse)


def lstm_scan_cuda(xp: torch.Tensor, U: torch.Tensor, mask: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel. Raises on anything it does not take."""
    global LAUNCHES
    if xp.device.type != "cuda":
        raise ValueError(f"lstm_scan_cuda needs CUDA tensors, got {xp.device}")
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
    m = mask.to(torch.float32).contiguous()
    out = torch.empty(B, T, H, dtype=xp.dtype, device=xp.device)
    hbuf = torch.empty(2, B, H, dtype=torch.float32, device=xp.device)
    lib = _lib()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_lstm_fwd(xp.data_ptr(), U.data_ptr(), m.data_ptr(),
                                out.data_ptr(), hbuf.data_ptr(), B, T, H,
                                int(reverse), _DTYPES[xp.dtype], stream)
    if rc != 0:
        msg = _ERRORS.get(rc) or lib.pgasr_cuda_error_string(rc).decode()
        raise RuntimeError(f"lstm_fwd kernel (B={B}, T={T}, H={H}, "
                           f"{xp.dtype}): {msg}")
    LAUNCHES += 1
    return out
