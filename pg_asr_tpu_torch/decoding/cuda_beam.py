"""The CTC prefix beam search as one hand-written CUDA kernel
(csrc/ctc_beam.cu) and its launcher.

Replaces pg_asr_tpu/decoding/pallas_beam.py ``_beam_kernel``: the whole
frame loop of the hash-impl search, and here also the per-frame top-M
symbol selection and the backtrack of the best slot (or of all K, sorted,
for the n-best). The launcher takes CUDA tensors only and launches the
kernel or raises; decoding/beam.py chooses between it and the plain
version by the tensor's device. There is no fallback.

``LAUNCHES`` counts launches (the launcher adds one where it launches the
kernel, nowhere else), so that a run can show its path went through it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import load_library

__all__ = ["LAUNCHES", "BeamScan", "ctc_beam_cuda"]

LAUNCHES = 0
_ERR_RANGE = -5  # csrc/common.cuh kErrBeamRange
_declared = False


class BeamScan(NamedTuple):
    """What one launch writes. The search: parents, syms (T, B, K) int32
    backpointers (sym -1 = stay), lens (B, K) int32 and scores (B, K)
    float32 of the final slots. The backtrack, NB = 1 (best) or K (n-best,
    by score descending, ties in slot order): labels (B, NB, Lmax) int32
    0-padded, nb_lens (B, NB) int32, nll (B, NB) float32."""
    parents: torch.Tensor
    syms: torch.Tensor
    lens: torch.Tensor
    scores: torch.Tensor
    labels: torch.Tensor
    nb_lens: torch.Tensor
    nll: torch.Tensor


def _lib() -> ctypes.CDLL:
    global _declared
    lib = load_library()
    if not _declared:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pgasr_ctc_beam.argtypes = [vp] * 9 + [ci] * 8 + [vp]
        lib.pgasr_ctc_beam.restype = ci
        lib.pgasr_cuda_error_string.argtypes = [ci]
        lib.pgasr_cuda_error_string.restype = ctypes.c_char_p
        _declared = True
    return lib


def ctc_beam_cuda(log_probs: torch.Tensor, frame_lens: torch.Tensor, K: int,
                  M: int, Lmax: int, blank: int = 0,
                  nbest: bool = False) -> BeamScan:
    """Launch ctc_beam on (B, T, A) float32 log-probs and (B,) int32 frame
    lengths, both contiguous on one CUDA device: any beam K >= 1, top-M
    symbols per frame in [1, A], labels cut at Lmax in [1, T]. Raises on
    anything else (and where the block form's K (1 + M) candidates do not
    fit its shared memory)."""
    global LAUNCHES
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_beam needs CUDA tensors, got "
                         f"{log_probs.device}")
    if frame_lens.device != log_probs.device:
        raise ValueError("log_probs and frame_lens must be on one device")
    if log_probs.dtype != torch.float32 or frame_lens.dtype != torch.int32:
        raise TypeError(f"ctc_beam takes float32 log_probs and int32 "
                        f"frame_lens, got {log_probs.dtype} and "
                        f"{frame_lens.dtype}")
    if log_probs.dim() != 3 or 0 in log_probs.shape:
        raise ValueError(f"log_probs must be a non-empty (B, T, A), got "
                         f"{tuple(log_probs.shape)}")
    B, T, A = log_probs.shape
    if tuple(frame_lens.shape) != (B,):
        raise ValueError(f"frame_lens must be ({B},), got "
                         f"{tuple(frame_lens.shape)}")
    if not (log_probs.is_contiguous() and frame_lens.is_contiguous()):
        raise ValueError("log_probs and frame_lens must be contiguous")
    if not (K >= 1 and 1 <= M <= A and 1 <= Lmax <= T and 0 <= blank < A):
        raise ValueError(
            f"ctc_beam takes a beam K >= 1, top-M in [1, A], Lmax in [1, T] "
            f"and a blank in [0, A); got K={K}, M={M}, A={A}, Lmax={Lmax}, "
            f"T={T}, blank={blank}")
    NB = K if nbest else 1
    dev = log_probs.device

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = BeamScan(empty(T, B, K), empty(T, B, K), empty(B, K),
                   empty(B, K, dtype=torch.float32), empty(B, NB, Lmax),
                   empty(B, NB), empty(B, NB, dtype=torch.float32))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pgasr_ctc_beam(log_probs.data_ptr(), frame_lens.data_ptr(),
                                *(t.data_ptr() for t in out), B, T, A, K, M,
                                Lmax, blank, NB, stream)
    if rc != 0:
        msg = ("the block form's candidates do not fit its shared memory"
               if rc == _ERR_RANGE
               else lib.pgasr_cuda_error_string(rc).decode())
        raise RuntimeError(f"ctc_beam kernel (B={B}, T={T}, A={A}, K={K}, "
                           f"M={M}): {msg}")
    LAUNCHES += 1
    return out
