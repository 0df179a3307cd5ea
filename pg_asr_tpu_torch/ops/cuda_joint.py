"""The fused RNN-T joint as hand-written CUDA kernels (csrc/joint_fwd.cu,
csrc/joint_bwd.cu) and their launchers.

Replace the TPU kernels of pg_asr_tpu/ops/pallas_joint.py: ``_fwd_kernel``
(``joint_fwd_cuda``) and ``_bwd_kernel`` (``joint_bwd_cuda``). The
launchers take CUDA tensors only and launch the kernel or raise;
ops/joint.py chooses between them and the plain versions by the tensor's
device. There is no fallback.

Launch counts (each launcher adds one where it launches its kernel,
nowhere else), so that a run can show its path went through them:
``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` (the backward's one call runs its
partial-sum pass and the fixed-order reduction of the partials).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library

__all__ = ["FWD_LAUNCHES", "BWD_LAUNCHES", "joint_fwd_cuda", "joint_bwd_cuda"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERRORS = {-3: "shared memory: the card cannot hold the kernel's tile"}
_declared = False


def _lib() -> ctypes.CDLL:
    global _declared
    lib = load_library()
    if not _declared:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pgasr_joint_fwd.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.pgasr_joint_fwd.restype = ci
        lib.pgasr_joint_bwd.argtypes = [vp] * 12 + [ci] * 6 + [vp]
        lib.pgasr_joint_bwd.restype = ci
        lib.pgasr_joint_bwd_scratch_floats.argtypes = [ci] * 5
        lib.pgasr_joint_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.pgasr_cuda_error_string.argtypes = [ci]
        lib.pgasr_cuda_error_string.restype = ctypes.c_char_p
        _declared = True
    return lib


def _check(name: str, e, g, W, bias, labels):
    """Device, types and shapes of a launch -> (B, T, U, J, A) and the
    labels as contiguous int32."""
    if e.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {e.device}")
    if any(t.device != e.device for t in (g, W, bias, labels)):
        raise ValueError("e, g, W, bias and labels must be on one device")
    if e.dtype not in _DTYPES or any(t.dtype != e.dtype for t in (g, W, bias)):
        raise TypeError(f"e, g, W and bias must share one type, float32 or "
                        f"bfloat16; got {e.dtype}, {g.dtype}, {W.dtype}, "
                        f"{bias.dtype}")
    if e.dim() != 3 or g.dim() != 3 or W.dim() != 2 or bias.dim() != 1:
        raise ValueError("expected e (B, T, J), g (B, U+1, J), W (J, A), "
                         "bias (A,)")
    B, T, J = e.shape
    U = g.shape[1] - 1
    A = W.shape[1]
    if (g.shape[0] != B or g.shape[2] != J or W.shape[0] != J
            or bias.shape[0] != A or tuple(labels.shape) != (B, U)):
        raise ValueError(f"shapes disagree: e {tuple(e.shape)}, g "
                         f"{tuple(g.shape)}, W {tuple(W.shape)}, bias "
                         f"{tuple(bias.shape)}, labels {tuple(labels.shape)}")
    if min(B, T, J, A) < 1 or U < 0:
        raise ValueError(f"empty joint input e {tuple(e.shape)}, g "
                         f"{tuple(g.shape)}, W {tuple(W.shape)}")
    if any(not t.is_contiguous() for t in (e, g, W, bias)):
        raise ValueError("e, g, W and bias must be contiguous")
    return (B, T, U, J, A), labels.to(torch.int32).contiguous()


def _raise_on(rc: int, lib, name: str, shape) -> None:
    if rc != 0:
        msg = _ERRORS.get(rc) or lib.pgasr_cuda_error_string(rc).decode()
        B, T, U, J, A = shape
        raise RuntimeError(f"{name} kernel (B={B}, T={T}, U={U}, J={J}, "
                           f"A={A}): {msg}")


def joint_fwd_cuda(e: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
                   bias: torch.Tensor, labels: torch.Tensor):
    """Launch joint_fwd: e (B, T, J), g (B, U+1, J), W (J, A), bias (A,),
    one type (float32 or bfloat16), contiguous, on one CUDA device; labels
    (B, U) int -> (lp_blank (B, T, U+1), lp_label (B, T, U)) float32.
    Raises on anything else."""
    global FWD_LAUNCHES
    shape, lab = _check("joint_fwd", e, g, W, bias, labels)
    B, T, U, J, A = shape
    lpb = torch.empty(B, T, U + 1, dtype=torch.float32, device=e.device)
    lpy = torch.empty(B, T, U, dtype=torch.float32, device=e.device)
    lib = _lib()
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_joint_fwd(e.data_ptr(), g.data_ptr(), W.data_ptr(),
                                 bias.data_ptr(), lab.data_ptr(),
                                 lpb.data_ptr(), lpy.data_ptr(), B, T, U, J,
                                 A, _DTYPES[e.dtype], stream)
    _raise_on(rc, lib, "joint_fwd", shape)
    FWD_LAUNCHES += 1
    return lpb, lpy


def joint_bwd_cuda(e: torch.Tensor, g: torch.Tensor, W: torch.Tensor,
                   bias: torch.Tensor, labels: torch.Tensor,
                   gb: torch.Tensor, gy: torch.Tensor):
    """Launch joint_bwd: the forward's inputs and the cotangents gb (B, T,
    U+1), gy (B, T, U) float32 -> (de, dg, dW, db) in e's type. Raises on
    anything else."""
    global BWD_LAUNCHES
    shape, lab = _check("joint_bwd", e, g, W, bias, labels)
    B, T, U, J, A = shape
    for what, t, want in (("gb", gb, (B, T, U + 1)), ("gy", gy, (B, T, U))):
        if (t.device != e.device or t.dtype != torch.float32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous {want} float32 "
                             f"tensor on {e.device}")
    lib = _lib()
    scratch = torch.empty(
        lib.pgasr_joint_bwd_scratch_floats(B, T, U, J, A),
        dtype=torch.float32, device=e.device)
    de, dg = torch.empty_like(e), torch.empty_like(g)
    dW, db = torch.empty_like(W), torch.empty_like(bias)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_joint_bwd(
            e.data_ptr(), g.data_ptr(), W.data_ptr(), bias.data_ptr(),
            lab.data_ptr(), gb.data_ptr(), gy.data_ptr(), scratch.data_ptr(),
            de.data_ptr(), dg.data_ptr(), dW.data_ptr(), db.data_ptr(), B, T,
            U, J, A, _DTYPES[e.dtype], stream)
    _raise_on(rc, lib, "joint_bwd", shape)
    BWD_LAUNCHES += 1
    return de, dg, dW, db
