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

Its gradient is the library's custom VJP (``_flash_attention_fwd`` saves
the row max ``m`` and sum ``l``; ``_flash_attention_bwd`` computes ``di``
and launches its dkv and dq kernels): ``FlashAttention`` joins the
residual forward to the backward, and ``mhsa_bwd_plain`` transcribes the
two backward kernels' numerics.

``mhsa`` is the one place that chooses: the hand-written kernels
(ops/cuda_flash_attn.py; csrc/flash_attn.cu, csrc/flash_attn_bwd.cu) for
CUDA tensors, the plain versions for CPU tensors or ``use_kernel=False``.
Under autograd it runs ``FlashAttention``; without (inference,
``torch.no_grad``) the forward's inference form, which keeps no residuals.
A kernel that fails to build or launch raises; nothing falls back. The JAX
module's ``available()`` and ``pad_multiple()`` are TPU constraints (a
backend and a 128-frame block) that the port does not have.
"""

from __future__ import annotations

import torch

from . import cuda_flash_attn

# jax/experimental/pallas/ops/tpu/flash_attention.py DEFAULT_MASK_VALUE
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# rows of the query and key tiles of the backward kernels
BWD_TILE = 64


def _scores(q: torch.Tensor, k: torch.Tensor, valid_mask: torch.Tensor,
            sm_scale: float) -> torch.Tensor:
    """(B, H, T, T) float32 scores q . k * sm_scale plus the additive
    segment mask."""
    seg = valid_mask.to(torch.int32)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return s + torch.where(same, 0.0, DEFAULT_MASK_VALUE)


def mhsa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_mask: torch.Tensor, sm_scale: float,
               residuals: bool = False):
    """The kernel's function in plain PyTorch: q, k, v (B, H, T, dh) in the
    compute type, valid_mask (B, T) -> the (B, H, T, dh) context in q's
    type, every row (padded queries included). With ``residuals`` -> (o, l,
    m), the library's residuals: m the row max of the masked scaled scores,
    l the sum of exp(s - m), both (B, H, T) float32."""
    s = _scores(q, k, valid_mask, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (o * torch.where(l == 0.0, 1.0, 1.0 / l)).to(q.dtype)
    if residuals:
        return o, l[..., 0], m[..., 0]
    return o


def bwd_p_ds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             valid_mask: torch.Tensor, o: torch.Tensor, l: torch.Tensor,
             m: torch.Tensor, do: torch.Tensor, sm_scale: float):
    """p and ds, (B, H, T, T) float32, as the library's backward kernels
    form them: di = sum(o . do) in float32; p = exp(s - m) * (1 / l); dp =
    do . v^T in float32; ds = (dp - di) * p * sm_scale."""
    di = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    s = _scores(q, k, valid_mask, sm_scale)
    p = torch.exp(s - m[..., None]) * (1.0 / l[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, (dp - di) * p * sm_scale


def bwd_products(q: torch.Tensor, k: torch.Tensor, do: torch.Tensor,
                 p: torch.Tensor, ds: torch.Tensor):
    """(dq, dk, dv) in q's type from p and ds: dv = p^T . do with p rounded
    to do's type; dk = ds^T . q with ds rounded to do's type (the dkv
    kernel); dq = ds . k with ds rounded to k's type (the dq kernel);
    products accumulate in float32."""
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def mhsa_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid_mask: torch.Tensor, o: torch.Tensor, l: torch.Tensor,
                   m: torch.Tensor, do: torch.Tensor, sm_scale: float):
    """The library backward kernels' function in plain PyTorch -> (dq, dk,
    dv) in q's type, from the forward's inputs, output o and residuals l, m
    (B, H, T) float32 and the output gradient do: ``bwd_p_ds`` then
    ``bwd_products``, as ``_flash_attention_bwd``."""
    p, ds = bwd_p_ds(q, k, v, valid_mask, o, l, m, do, sm_scale)
    return bwd_products(q, k, do, p, ds)


def kept_tile_pairs(valid_mask: torch.Tensor,
                    tile: int = BWD_TILE) -> torch.Tensor:
    """(B, n, n) bool, n = ceil(T / tile): whether the backward kernels
    compute the pair (query tile i, key tile j) of each utterance; the
    kernels (csrc/flash_attn_bwd.cu ``tile_flags``) apply this rule.

    A pair is skipped when the segment ids of its two tiles' rows (those
    < T) span disjoint ranges [min, max]. Then no query of the one shares a
    segment with a key of the other, every score of the pair carries the
    additive mask, and exp(s - m) underflows to 0: p and ds are exactly 0,
    so skipping the pair changes no bit. It holds for any int32 segment
    ids (``valid_mask`` as the kernels take it: converted to int32)."""
    seg = valid_mask.to(torch.int32)
    B, T = seg.shape
    n = -(-T // tile)
    info = torch.iinfo(torch.int32)

    def per_tile(fill, reduce):
        pad = torch.full((B, n * tile - T), fill, dtype=torch.int32,
                         device=seg.device)
        return reduce(torch.cat([seg, pad], 1).view(B, n, tile), -1)

    lo, hi = per_tile(info.max, torch.amin), per_tile(info.min, torch.amax)
    return ~((hi[:, :, None] < lo[:, None, :])
             | (hi[:, None, :] < lo[:, :, None]))


def mhsa_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid_mask: torch.Tensor, o: torch.Tensor, l: torch.Tensor,
                  m: torch.Tensor, do: torch.Tensor, sm_scale: float):
    """The backward on CUDA tensors as ``FlashAttention`` runs it -> (dq,
    dk, dv): di outside the kernels, as the library computes it, then the
    dkv and the dq kernel."""
    di = (o.float() * do.float()).sum(dim=-1).contiguous()
    args = (q, k, v, valid_mask, l, m, do, di, sm_scale)
    dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args)
    return cuda_flash_attn.flash_attn_bwd_dq_cuda(*args), dk, dv


class FlashAttention(torch.autograd.Function):
    """Segment-masked attention under autograd (counterpart of the library
    kernel's custom VJP). Forward: the residual form (o, l, m); backward:
    di, then dk and dv (the dkv kernel) and dq (the dq kernel). Kernels on
    CUDA tensors unless ``use_kernel`` is False, plain versions otherwise."""

    @staticmethod
    def forward(ctx, q, k, v, valid_mask, sm_scale: float, use_kernel: bool):
        kernel = use_kernel and q.is_cuda
        fwd = cuda_flash_attn.flash_attn_cuda if kernel else mhsa_plain
        o, l, m = fwd(q, k, v, valid_mask, sm_scale, residuals=True)
        ctx.save_for_backward(q, k, v, valid_mask, o, l, m)
        ctx.sm_scale, ctx.kernel = sm_scale, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid_mask, o, l, m = ctx.saved_tensors
        bwd = mhsa_bwd_cuda if ctx.kernel else mhsa_bwd_plain
        dq, dk, dv = bwd(q, k, v, valid_mask, o, l, m, do, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         valid_mask: torch.Tensor, sm_scale: float,
         use_kernel: bool = True) -> torch.Tensor:
    """Masked MHSA: the kernels on CUDA tensors (unless ``use_kernel`` is
    False), the plain versions otherwise; ``FlashAttention`` when a
    gradient is wanted, the inference form otherwise. Shapes as
    ``mhsa_plain``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, valid_mask, sm_scale, use_kernel)
    if use_kernel and q.is_cuda:
        return cuda_flash_attn.flash_attn_cuda(q, k, v, valid_mask, sm_scale)
    return mhsa_plain(q, k, v, valid_mask, sm_scale)
