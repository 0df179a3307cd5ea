"""Conformer-CTC acoustic model (counterpart of
pg_asr_tpu/models/conformer_ctc.py).

Masked per-utterance normalization -> frame stacking (as the transformer)
-> Linear to d_model -> blocks of: half-step FFN (LN -> silu FFN, x0.5
residual), rotary MHSA (LN -> attention with q, k rotated), convolution
module (LN -> pointwise d -> 2d -> GLU -> padded frames zeroed ->
depthwise conv over time -> LN -> swish -> pointwise d -> d), half-step FFN
-> LN -> CTC head -> float32 log-softmax.

Rotary positions rotate the halves x[..., :dh/2] and x[..., dh/2:] (as
the JAX code does; its docstring speaks of pairs), with cos and sin
computed in float32 and cast to x's type. The depthwise conv is JAX's
``conv_general_dilated`` with a (K, 1, d) kernel, feature groups d and
padding (pad, K-1-pad): ``F.conv1d(groups=d)`` with the weight as
(d, 1, K), neither flipping the kernel; it runs in full float32 forward
and backward (``DepthwiseConv``: cuDNN would run a float32 conv in TF32 by
default, the JAX package runs it at full precision). Dense attention
keeps its scores and softmax in the compute type when
``attn_softmax_bf16`` is set (the default), in float32 otherwise; the
flash path (ops/flash_attn.py, the hand-written kernels on CUDA tensors)
runs its softmax in float32 whatever the flag says, as the JAX
package's. The JAX package pads T' to 128 frames for its TPU flash
kernel; the port does not.

Training (``train=True``): dropout (``conformer.dropout``) after the input
projection, then on each of the four residual branches of a block (1 + 4L
sites, the JAX package's; the half-step FFNs add ``0.5 * dropout(h)``),
bits and ``model.remat`` as in models/transformer_ctc.py.

Parameters: a flat dict in the JAX package's layouts, ``input_proj.*``,
``blocks.{i}.{ln_ffn1,ln_attn,ln_conv,ln_mid,ln_ffn2}.{scale,bias}``
(float32 in every compute type), ``blocks.{i}.{ffn1_in,ffn1_out,qkv,
attn_out,conv_in,conv_out,ffn2_in,ffn2_out}.{w,b}``, ``blocks.{i}.conv_dw``
(K, 1, d), ``ln_final.*``, ``ctc_head.*``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..config import ConformerConfig, ModelConfig
from ..ops import flash_attn
from ..ops.features import full_f32_conv
from ..parallel import tensor
from ..parallel.mesh import ONE_DEVICE, DataParallel
from . import cast_params
from .bilstm_ctc import (apply_dropout, dropout_bits, init_linear, linear,
                         normalize_features, torch_dtype)
from .transformer_ctc import (_attn_out, _init_ln, _layer_norm, _qkv,
                              attn_split, ctc_head, ffn, num_blocks,
                              padding_bias, run_block, stack_frames)


def init_encoder_params(mcfg: ModelConfig, ccfg: ConformerConfig,
                        generator: torch.Generator) -> dict:
    """Encoder parameters (no CTC head), float32 on the CPU, with the JAX
    init's shapes and distributions (depthwise kernel ~ N(0, 2/(K+2)))."""
    d, K = ccfg.d_model, ccfg.conv_kernel
    p: dict[str, torch.Tensor] = {}
    init_linear(p, "input_proj", ccfg.subsample * mcfg.input_dim, d,
                generator)
    for i in range(ccfg.num_layers):
        pre = f"blocks.{i}"
        _init_ln(p, f"{pre}.ln_ffn1", d)
        init_linear(p, f"{pre}.ffn1_in", d, ccfg.ffn_dim, generator)
        init_linear(p, f"{pre}.ffn1_out", ccfg.ffn_dim, d, generator)
        _init_ln(p, f"{pre}.ln_attn", d)
        init_linear(p, f"{pre}.qkv", d, 3 * d, generator)
        init_linear(p, f"{pre}.attn_out", d, d, generator)
        _init_ln(p, f"{pre}.ln_conv", d)
        init_linear(p, f"{pre}.conv_in", d, 2 * d, generator)
        p[f"{pre}.conv_dw"] = (torch.randn(K, 1, d, generator=generator)
                               * (2.0 / (K + 2)) ** 0.5)
        _init_ln(p, f"{pre}.ln_mid", d)
        init_linear(p, f"{pre}.conv_out", d, d, generator)
        _init_ln(p, f"{pre}.ln_ffn2", d)
        init_linear(p, f"{pre}.ffn2_in", d, ccfg.ffn_dim, generator)
        init_linear(p, f"{pre}.ffn2_out", ccfg.ffn_dim, d, generator)
    _init_ln(p, "ln_final", d)
    return p


def init_params(mcfg: ModelConfig, ccfg: ConformerConfig,
                generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Drawn on the CPU from `generator`, then moved and cast (LayerNorm
    params stay float32)."""
    p = init_encoder_params(mcfg, ccfg, generator)
    init_linear(p, "ctc_head", ccfg.d_model, mcfg.vocab_size, generator)
    return cast_params(p, torch_dtype(mcfg.dtype), device)


def _rotary(x: torch.Tensor) -> torch.Tensor:
    """Rotary positions over the last dim of (B, h, T, dh): position t
    rotates (x[..., i], x[..., i + dh/2]) by t * 10000^(-i/(dh/2))."""
    T, dh = x.shape[-2:]
    half = dh // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freq[None, :]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _mhsa_rotary(params: dict, pre: str, x: torch.Tensor,
                 key_bias: torch.Tensor, num_heads: int,
                 flash_mask: torch.Tensor | None = None,
                 softmax_bf16: bool = False,
                 use_kernel: bool = True,
                 dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """Masked MHSA with rotary q and k. x: (B, T, d); key_bias (B, 1, 1, T)
    additive float32; flash_mask (B, T) bool routes through
    ops/flash_attn.mhsa; softmax_bf16 keeps the dense scores and softmax in
    the compute type. On a model axis (``dp``) the rank runs the heads its
    part of ``qkv`` holds (the rotation stays within a head)."""
    scale = 1.0 / (x.shape[-1] // num_heads) ** 0.5
    x, is_split = attn_split(params, pre, x, dp)
    q, k, v = _qkv(params, pre, x, num_heads)
    q, k = _rotary(q), _rotary(k)
    if flash_mask is not None:
        ctx = flash_attn.mhsa(q, k, v, flash_mask, scale,
                              use_kernel=use_kernel)
    else:
        score_t = x.dtype if softmax_bf16 else torch.float32
        scores = torch.matmul(q.to(score_t), k.to(score_t).transpose(-1, -2))
        scores = scores * scale + key_bias.to(score_t)
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(attn, v)
    return _attn_out(params, pre, ctx, dp, is_split)


class DepthwiseConv(torch.autograd.Function):
    """``F.conv1d(x, w, groups=channels)`` (x (B, C, T), w (C, 1, K), no
    padding) with TF32 off in the forward and in the backward, which runs
    after the forward's context has closed."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with full_f32_conv():
            return F.conv1d(x, w, groups=x.shape[1])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with full_f32_conv():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1], [0], [1], False, [0], x.shape[1],
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw


def _conv_module(params: dict, pre: str, x: torch.Tensor, mask: torch.Tensor,
                 kernel: int, dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """pointwise(d -> 2d) -> GLU -> depthwise conv (padded frames zeroed
    first) -> LN -> swish -> pointwise(d -> d). x: (B, T, d); mask (B, T)
    in the compute type. On a model axis (``dp``) the rank runs its d/T
    channels through the GLU (its ``conv_in`` columns in the run layout
    [a_i | b_i]) and the depthwise conv; they are gathered for ``ln_mid``,
    which normalizes all d, and split again for ``conv_out``'s rows."""
    is_split = tensor.split(dp, params[f"{pre}.conv_out.w"].shape[0],
                            x.shape[-1])
    if is_split:
        x = tensor.copy_to(x, dp)
    a, b = linear(params, f"{pre}.conv_in", x).chunk(2, dim=-1)
    h = a * torch.sigmoid(b) * mask[:, :, None]
    pad = (kernel - 1) // 2
    w = params[f"{pre}.conv_dw"].permute(2, 1, 0)  # (K, 1, d) -> (d, 1, K)
    h = DepthwiseConv.apply(F.pad(h.transpose(1, 2),
                                  (pad, kernel - 1 - pad)), w).transpose(1, 2)
    if is_split:
        h = tensor.gather_to(h, dp)
    h = _layer_norm(params, f"{pre}.ln_mid", h)
    h = h * torch.sigmoid(h)
    if is_split:
        h = tensor.split_to(h, dp)
    return tensor.row_linear(params, f"{pre}.conv_out", h, dp, is_split)


def _block(params: dict, pre: str, x: torch.Tensor, b_ffn1, b_attn, b_conv,
           b_ffn2, *, ccfg: ConformerConfig, key_bias: torch.Tensor,
           omask: torch.Tensor, flash_mask: torch.Tensor | None,
           use_kernel: bool, dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """One conformer block: half-step FFN, MHSA, conv module, half-step
    FFN, each a residual branch with its dropout site."""
    rate = ccfg.dropout

    def half_ffn(ln: str, name: str, x: torch.Tensor) -> torch.Tensor:
        return ffn(params, pre, name, _layer_norm(params, f"{pre}.{ln}", x),
                   F.silu, ccfg.ffn_dim, dp)

    x = x + 0.5 * apply_dropout(half_ffn("ln_ffn1", "ffn1", x), rate, b_ffn1)
    h = _mhsa_rotary(params, pre, _layer_norm(params, f"{pre}.ln_attn", x),
                     key_bias, ccfg.num_heads, flash_mask=flash_mask,
                     softmax_bf16=ccfg.attn_softmax_bf16,
                     use_kernel=use_kernel, dp=dp)
    x = x + apply_dropout(h, rate, b_attn)
    h = _conv_module(params, pre, _layer_norm(params, f"{pre}.ln_conv", x),
                     omask, ccfg.conv_kernel, dp)
    x = x + apply_dropout(h, rate, b_conv)
    return x + 0.5 * apply_dropout(half_ffn("ln_ffn2", "ffn2", x), rate,
                                   b_ffn2)


def encode(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
           frame_lens: torch.Tensor, mcfg: ModelConfig, ccfg: ConformerConfig,
           use_kernel: bool = True, train: bool = False,
           generator: torch.Generator | None = None,
           pre_normalized: bool = False, dp: DataParallel = ONE_DEVICE):
    """Encoder forward: (B, T, F) features -> (states (B, T', d), out_mask
    (B, T') bool, out_lens (B,)) with T' = ceil(T / subsample). In
    training dropout draws its bits from `generator` (x's device). ``dp``:
    a model axis's rank runs its part of each block's attention, FFNs and
    convolution module.
    pre_normalized=True (streaming, serving.py): the caller normalized with
    running or fixed statistics. Rotary attention sees positions only
    through their differences, so a window needs no position offset."""
    dtype = torch_dtype(mcfg.dtype)
    x = (feats.to(dtype) if pre_normalized
         else normalize_features(feats.to(dtype), frame_mask.to(dtype)))
    x, out_mask, out_lens = stack_frames(x, frame_lens, ccfg.subsample)
    x = linear(params, "input_proj", x)
    x = apply_dropout(x, ccfg.dropout,
                      dropout_bits(x, ccfg.dropout, generator, train))
    flash_mask = out_mask if ccfg.flash_attention else None
    bias, omask = padding_bias(out_mask), out_mask.to(dtype)
    for i in range(num_blocks(params)):
        block = functools.partial(_block, params, f"blocks.{i}", ccfg=ccfg,
                                  key_bias=bias, omask=omask,
                                  flash_mask=flash_mask,
                                  use_kernel=use_kernel, dp=dp)
        bits = [dropout_bits(x, ccfg.dropout, generator, train)
                for _ in range(4)]
        x = run_block(block, x, bits, mcfg.remat)
    return _layer_norm(params, "ln_final", x), out_mask, out_lens


def apply(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
          frame_lens: torch.Tensor, mcfg: ModelConfig, ccfg: ConformerConfig,
          use_kernel: bool = True, train: bool = False,
          generator: torch.Generator | None = None,
          dp: DataParallel = ONE_DEVICE):
    """(B, T, F) features -> ((B, T', A) CTC log-probs, out_mask (B, T')
    float32, out_lens (B,)). train=True applies dropout with bits from
    `generator`."""
    x, out_mask, out_lens = encode(params, feats, frame_mask, frame_lens,
                                   mcfg, ccfg, use_kernel=use_kernel,
                                   train=train, generator=generator, dp=dp)
    log_probs, omask_f = ctc_head(params, x, out_mask)
    return log_probs, omask_f, out_lens
