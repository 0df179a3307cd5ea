"""Segment-masked multi-head self-attention (counterpart of
pg_asr_tpu/ops/flash_attn.py), the attention of the transformer and
conformer families when their config sets ``flash_attention``.

The function is that of JAX's library Pallas TPU flash attention as the JAX
package calls it, with segment ids ``seg = valid_mask`` (valid = 1, pad =
0): query i attends key j iff ``seg[b, i] == seg[b, j]``, so a padded query
attends the padded keys (its output is finite and masked downstream); the
mask is additive (``DEFAULT_MASK_VALUE``, not -inf); scores are q . k in
float32 times ``sm_scale``; the softmax runs in float32; p is rounded to
v's type before the p . v product, which accumulates in float32.

``mhsa`` is the one place that chooses: the hand-written kernel
(ops/cuda_flash_attn.py, csrc/flash_attn.cu) for CUDA tensors, the plain
version ``mhsa_plain`` for CPU tensors or ``use_kernel=False``. A kernel
that fails to build or launch raises; nothing falls back. The JAX
module's ``available()`` and ``pad_multiple()`` are TPU constraints (a
backend and a 128-frame block) that the port does not have.
"""

from __future__ import annotations

import torch

from . import cuda_flash_attn

# jax/experimental/pallas/ops/tpu/flash_attention.py DEFAULT_MASK_VALUE
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def mhsa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_mask: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q, k, v (B, H, T, dh) in the
    compute type, valid_mask (B, T) -> the (B, H, T, dh) context in q's
    type, every row (padded queries included)."""
    seg = valid_mask.to(torch.int32)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    s = s + torch.where(same, 0.0, DEFAULT_MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o * torch.where(l == 0.0, 1.0, 1.0 / l)).to(q.dtype)


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         valid_mask: torch.Tensor, sm_scale: float,
         use_kernel: bool = True) -> torch.Tensor:
    """Masked MHSA: the kernel on CUDA tensors (unless ``use_kernel`` is
    False), the plain version otherwise. Shapes as ``mhsa_plain``."""
    if use_kernel and q.is_cuda:
        return cuda_flash_attn.flash_attn_cuda(q, k, v, valid_mask, sm_scale)
    return mhsa_plain(q, k, v, valid_mask, sm_scale)
