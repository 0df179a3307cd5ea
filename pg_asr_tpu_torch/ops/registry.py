"""The serving path's kernels as registered PyTorch operators (namespace
``pgasr``), so that ``torch.export`` can trace a program that launches them
(exporting.py) and the loaded program launches them again.

  pgasr::bilstm_fwd  both directions of a BiLSTM layer, inference form
                     (csrc/lstm_fwd.cu bilstm_fwd, ops/cuda_lstm.py):
                     xpf, xpb (B, T, 4H), Uf, Ub (H, 4H), mask (B, T)
                     -> y (B, T, 2H) in xp's type
  pgasr::ctc_beam    the CTC prefix beam search (csrc/ctc_beam.cu,
                     decoding/cuda_beam.py): log_probs (B, T, A) float32,
                     frame_lens (B,) int32, K, M, Lmax, blank, nbest
                     -> labels (B, NB, Lmax) int32, lens (B, NB) int32,
                     nll (B, NB) float32; NB = K with nbest, else 1
  pgasr::flash_attn  segment-masked attention, inference form
                     (csrc/flash_attn.cu, ops/cuda_flash_attn.py): q, k, v
                     (B, H, T, dh), valid_mask (B, T), sm_scale
                     -> o (B, T, H, dh) in q's type (the caller's
                     ``transpose(1, 2)`` gives the (B, H, T, dh) context)

Each op has a fake implementation (the output shapes, for tracing), its
plain PyTorch version as its CPU implementation and the ctypes launcher as
its CUDA implementation: a CUDA tensor launches the kernel or raises, and
nothing falls back to the plain version. The launchers keep their launch
counters, so that the exported program's launches are counted as the live
path's are. ops/lstm.bilstm_scan, the no-grad branch of
ops/flash_attn.mhsa and decoding/beam.beam_decode / beam_decode_nbest call
these ops, so that the live path and an exported program run the same
code. Registering them compiles nothing: the kernels build at their first
CUDA call.
"""

from __future__ import annotations

import torch

from ..decoding import cuda_beam
from . import cuda_flash_attn, cuda_lstm

__all__ = ["OPS", "bilstm_fwd", "ctc_beam", "flash_attn"]


@torch.library.custom_op("pgasr::bilstm_fwd", mutates_args=(),
                         device_types="cpu")
def bilstm_fwd(xpf: torch.Tensor, xpb: torch.Tensor, Uf: torch.Tensor,
               Ub: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    from .lstm import bilstm_scan_plain

    return bilstm_scan_plain(xpf, xpb, Uf, Ub, mask)


@bilstm_fwd.register_kernel("cuda")
def _(xpf, xpb, Uf, Ub, mask):
    return cuda_lstm.bilstm_scan_cuda(xpf, xpb, Uf, Ub, mask)


@bilstm_fwd.register_fake
def _(xpf, xpb, Uf, Ub, mask):
    B, T, H4 = xpf.shape
    return xpf.new_empty(B, T, H4 // 2)


@torch.library.custom_op("pgasr::ctc_beam", mutates_args=(),
                         device_types="cpu")
def ctc_beam(log_probs: torch.Tensor, frame_lens: torch.Tensor, K: int,
             M: int, Lmax: int, blank: int,
             nbest: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from ..decoding.beam import ctc_beam_plain

    return ctc_beam_plain(log_probs, frame_lens, K, M, Lmax, blank, nbest)


@ctc_beam.register_kernel("cuda")
def _(log_probs, frame_lens, K, M, Lmax, blank, nbest):
    out = cuda_beam.ctc_beam_cuda(log_probs, frame_lens, K=K, M=M, Lmax=Lmax,
                                  blank=blank, nbest=nbest)
    return out.labels, out.nb_lens, out.nll


@ctc_beam.register_fake
def _(log_probs, frame_lens, K, M, Lmax, blank, nbest):
    B = log_probs.shape[0]
    NB = K if nbest else 1
    return (log_probs.new_empty(B, NB, Lmax, dtype=torch.int32),
            log_probs.new_empty(B, NB, dtype=torch.int32),
            log_probs.new_empty(B, NB, dtype=torch.float32))


@torch.library.custom_op("pgasr::flash_attn", mutates_args=(),
                         device_types="cpu")
def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    from .flash_attn import mhsa_plain

    return mhsa_plain(q, k, v, valid_mask, sm_scale).transpose(
        1, 2).contiguous()


@flash_attn.register_kernel("cuda")
def _(q, k, v, valid_mask, sm_scale):
    # the launcher writes a (B, T, H, dh) buffer and returns its
    # (B, H, T, dh) view: transposed back, the buffer itself
    return cuda_flash_attn.flash_attn_cuda(q, k, v, valid_mask,
                                           sm_scale).transpose(1, 2)


@flash_attn.register_fake
def _(q, k, v, valid_mask, sm_scale):
    B, H, T, dh = q.shape
    return q.new_empty(B, T, H, dh)


# op name -> the launch counter of its kernel (module, attribute)
OPS = {"pgasr::bilstm_fwd": (cuda_lstm, "BI_LAUNCHES"),
       "pgasr::ctc_beam": (cuda_beam, "LAUNCHES"),
       "pgasr::flash_attn": (cuda_flash_attn, "LAUNCHES")}
