"""Transformer-CTC acoustic model (counterpart of
pg_asr_tpu/models/transformer_ctc.py).

Masked per-utterance feature normalization -> frame stacking (pad T to a
multiple of ``subsample``, reshape (B, T, F) -> (B, T', s*F)) -> Linear to
d_model + sinusoidal positions ([sin, cos] concatenated) -> pre-LN blocks
(LN -> MHSA -> +res, LN -> FFN(gelu, tanh form) -> +res) -> LN -> CTC head
-> log-softmax in float32. Output frame i covers input frames
[i*s, (i+1)*s) and is valid iff any of them is: out_len = ceil(len / s).
LayerNorm runs in float32 (eps 1e-6) and its params are float32 in every
compute type; matmuls run in the compute type.

Attention: with ``flash_attention`` the segment-masked attention of
ops/flash_attn.py (the hand-written kernel on CUDA tensors); without, the
dense path, scores in float32 plus a -1e9 key bias (a padded query then
attends the valid keys; both paths agree on valid rows, and the rest is
masked). The JAX package pads T' to 128 frames for its TPU flash kernel;
the port does not, so its log-probs keep T' frames.

Training (``train=True``): dropout (``transformer.dropout``) after the
input projection and positions, then after the attention and after the
FFN of each block (1 + 2L sites, the JAX package's), with uint8 bits from
the step's ``torch.Generator`` under the port's threshold rule
(``bilstm_ctc.dropout_bits``). With ``model.remat`` each block runs under
``torch.utils.checkpoint`` (non-reentrant) when a gradient is wanted: its
activations are recomputed in the backward, as ``jax.checkpoint`` does.
The checkpoint restores only the default generators' states, so a block's
dropout bits are drawn before it and passed in: the recompute applies the
same masks.

Parameters are a flat dict (the state dict ``checkpoint.save_model``
writes) in the JAX package's layouts: ``input_proj.{w,b}``,
``blocks.{i}.{ln1,ln2}.{scale,bias}``, ``blocks.{i}.{qkv,attn_out,ffn_in,
ffn_out}.{w,b}``, ``ln_final.{scale,bias}``, ``ctc_head.{w,b}``.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, TransformerConfig
from ..ops import flash_attn
from ..parallel import tensor
from ..parallel.mesh import ONE_DEVICE, DataParallel
from . import cast_params
from .bilstm_ctc import (apply_dropout, dropout_bits, init_linear, linear,
                         normalize_features, torch_dtype)


def _init_ln(p: dict, name: str, dim: int) -> None:
    p[f"{name}.scale"] = torch.ones(dim)
    p[f"{name}.bias"] = torch.zeros(dim)


def _layer_norm(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in float32 whatever the compute type, eps 1e-6."""
    y = F.layer_norm(x.float(), x.shape[-1:], params[f"{name}.scale"],
                     params[f"{name}.bias"], eps=1e-6)
    return y.to(x.dtype)


def num_blocks(params: dict) -> int:
    return sum(1 for k in params if k.startswith("blocks.")
               and k.endswith(".qkv.w"))


def init_encoder_params(mcfg: ModelConfig, tcfg: TransformerConfig,
                        generator: torch.Generator) -> dict:
    """Encoder parameters (no CTC head), float32 on the CPU: Xavier-normal
    linears with bias 0.1, LayerNorm at (1, 0), as the JAX init."""
    d = tcfg.d_model
    p: dict[str, torch.Tensor] = {}
    init_linear(p, "input_proj", tcfg.subsample * mcfg.input_dim, d,
                generator)
    for i in range(tcfg.num_layers):
        pre = f"blocks.{i}"
        _init_ln(p, f"{pre}.ln1", d)
        init_linear(p, f"{pre}.qkv", d, 3 * d, generator)
        init_linear(p, f"{pre}.attn_out", d, d, generator)
        _init_ln(p, f"{pre}.ln2", d)
        init_linear(p, f"{pre}.ffn_in", d, tcfg.ffn_dim, generator)
        init_linear(p, f"{pre}.ffn_out", tcfg.ffn_dim, d, generator)
    _init_ln(p, "ln_final", d)
    return p


def init_params(mcfg: ModelConfig, tcfg: TransformerConfig,
                generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Same shapes and distributions as the JAX init; drawn on the CPU
    from `generator`, then moved and cast (LayerNorm params stay float32)."""
    p = init_encoder_params(mcfg, tcfg, generator)
    init_linear(p, "ctc_head", tcfg.d_model, mcfg.vocab_size, generator)
    return cast_params(p, torch_dtype(mcfg.dtype), device)


def _posenc(T: int, d: int, dtype: torch.dtype,
            device: torch.device | str = "cpu",
            offset: int = 0) -> torch.Tensor:
    """Sinusoidal positions (T, d): [sin, cos] of pos * 10000^(-i/half),
    concatenated, computed in float32 and cast to `dtype`; positions start
    at `offset` (a streamed window starts mid-utterance)."""
    half = d // 2
    pos = (torch.arange(T, dtype=torch.float32, device=device)
           + offset)[:, None]
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(dtype)


def _qkv(params: dict, pre: str, x: torch.Tensor, num_heads: int):
    """The fused projection -> q, k, v (B, h, T, dh) views of it: the heads
    its columns hold (a model axis's rank: its h/T, parallel/tensor.py)."""
    B, T, d = x.shape
    qkv = linear(params, f"{pre}.qkv", x).reshape(B, T, 3, -1,
                                                  d // num_heads)
    return (qkv[:, :, i].transpose(1, 2) for i in range(3))


def _attn_out(params: dict, pre: str, ctx: torch.Tensor,
              dp: DataParallel = ONE_DEVICE,
              is_split: bool = False) -> torch.Tensor:
    """(B, h, T, dh) context -> (B, T, d) -> the output projection (split:
    this rank's heads' rows, the partial products summed over the model
    group)."""
    B, h, T, dh = ctx.shape
    return tensor.row_linear(params, f"{pre}.attn_out",
                             ctx.transpose(1, 2).reshape(B, T, h * dh), dp,
                             is_split)


def attn_split(params: dict, pre: str, x: torch.Tensor,
               dp: DataParallel) -> tuple[torch.Tensor, bool]:
    """(x, whether block `pre`'s attention runs as a Megatron pair on the
    model axis of ``dp``): split, x's gradient is summed over the group."""
    is_split = tensor.split(dp, params[f"{pre}.qkv.w"].shape[-1],
                            3 * x.shape[-1])
    return (tensor.copy_to(x, dp) if is_split else x), is_split


def _mhsa(params: dict, pre: str, x: torch.Tensor, key_bias: torch.Tensor,
          num_heads: int, flash_mask: torch.Tensor | None = None,
          use_kernel: bool = True,
          dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """Masked multi-head self-attention of block `pre`. x: (B, T, d);
    key_bias: (B, 1, 1, T) additive float32 (-1e9 on padded keys).
    flash_mask (B, T) bool routes through ops/flash_attn.mhsa. On a model
    axis (``dp``) the rank runs the heads its part of ``qkv`` holds."""
    scale = 1.0 / (x.shape[-1] // num_heads) ** 0.5
    x, is_split = attn_split(params, pre, x, dp)
    q, k, v = _qkv(params, pre, x, num_heads)
    if flash_mask is not None:
        ctx = flash_attn.mhsa(q, k, v, flash_mask, scale,
                              use_kernel=use_kernel)
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores * scale + key_bias
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(attn, v)
    return _attn_out(params, pre, ctx, dp, is_split)


def ffn(params: dict, pre: str, name: str, x: torch.Tensor, act,
        ffn_dim: int, dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """``{name}_out(act({name}_in(x)))`` of block `pre`; on a model axis
    (``dp``) the rank's columns of ``{name}_in`` and rows of
    ``{name}_out`` when it splits the FFN's `ffn_dim`."""
    is_split = tensor.split(dp, params[f"{pre}.{name}_out.w"].shape[0],
                            ffn_dim)
    if is_split:
        x = tensor.copy_to(x, dp)
    h = act(linear(params, f"{pre}.{name}_in", x))
    return tensor.row_linear(params, f"{pre}.{name}_out", h, dp, is_split)


def subsampled_lens(frame_lens: torch.Tensor, subsample: int) -> torch.Tensor:
    """Output lengths after frame stacking: ceil(len / s)."""
    return (frame_lens + (subsample - 1)) // subsample


def stack_frames(x: torch.Tensor, frame_lens: torch.Tensor, subsample: int):
    """(B, T, F) -> (B, T', s*F) with the time tail zero-padded to a
    multiple of s; returns (x, out_mask (B, T') bool, out_lens (B,))."""
    B, T, Fd = x.shape
    s = subsample
    To = -(-T // s)
    x = F.pad(x, (0, 0, 0, To * s - T)).reshape(B, To, s * Fd)
    out_lens = subsampled_lens(frame_lens, s)
    out_mask = (torch.arange(To, device=x.device)[None, :]
                < out_lens[:, None])
    return x, out_mask, out_lens


def frontend(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
             frame_lens: torch.Tensor, mcfg: ModelConfig,
             tcfg: TransformerConfig, pos_offset: int = 0,
             pre_normalized: bool = False, pad_to_multiple: int = 1):
    """Masked normalization -> frame stacking -> input projection +
    sinusoidal positions -> (x (B, T', d), out_mask (B, T') bool,
    out_lens (B,)). Streaming (serving.py) passes pre_normalized=True (it
    normalizes with running or fixed statistics) and the window's first
    absolute subframe as pos_offset. ``pad_to_multiple`` > 1 zero-pads the
    stacked frames up to a multiple of it before the projection, as the
    JAX package's frontend does for sequence parallelism (the padded
    frames are masked)."""
    dtype = torch_dtype(mcfg.dtype)
    x = (feats.to(dtype) if pre_normalized
         else normalize_features(feats.to(dtype), frame_mask.to(dtype)))
    x, out_mask, out_lens = stack_frames(x, frame_lens, tcfg.subsample)
    pad = -x.shape[1] % pad_to_multiple
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        out_mask = F.pad(out_mask, (0, pad))
    x = linear(params, "input_proj", x) + _posenc(
        x.shape[1], tcfg.d_model, dtype, x.device, pos_offset)
    return x, out_mask, out_lens


def padding_bias(out_mask: torch.Tensor) -> torch.Tensor:
    """(B, T') bool -> (B, 1, 1, T') float32: 0 on valid keys, -1e9 else."""
    return torch.where(out_mask, 0.0, -1e9).to(torch.float32)[:, None, None, :]


def run_block(block_fn, x: torch.Tensor, bits: list, remat: bool):
    """``block_fn(x, *bits)``; with ``remat`` and a gradient wanted, under
    a non-reentrant ``torch.utils.checkpoint`` (the block is recomputed in
    the backward; the bits, drawn before, make it apply the same dropout)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block_fn, x, *bits, use_reentrant=False)
    return block_fn(x, *bits)


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form


def _block(params: dict, pre: str, x: torch.Tensor, bits_attn, bits_ffn, *,
           key_bias: torch.Tensor, num_heads: int,
           flash_mask: torch.Tensor | None, use_kernel: bool,
           rate: float, ffn_dim: int = 0,
           dp: DataParallel = ONE_DEVICE) -> torch.Tensor:
    """One pre-LN block: x + dropout(MHSA(LN(x))), then + dropout(FFN)."""
    h = _mhsa(params, pre, _layer_norm(params, f"{pre}.ln1", x), key_bias,
              num_heads, flash_mask=flash_mask, use_kernel=use_kernel, dp=dp)
    x = x + apply_dropout(h, rate, bits_attn)
    h = ffn(params, pre, "ffn", _layer_norm(params, f"{pre}.ln2", x), _gelu,
            ffn_dim, dp)
    return x + apply_dropout(h, rate, bits_ffn)


def encode(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
           frame_lens: torch.Tensor, mcfg: ModelConfig,
           tcfg: TransformerConfig, use_kernel: bool = True,
           train: bool = False, generator: torch.Generator | None = None,
           pos_offset: int = 0, pre_normalized: bool = False,
           dp: DataParallel = ONE_DEVICE):
    """Encoder forward: (B, T, F) features -> (states (B, T', d), out_mask
    (B, T') bool, out_lens (B,)) with T' = ceil(T / subsample). In
    training dropout draws its bits from `generator` (x's device).
    pos_offset and pre_normalized: see ``frontend``. ``dp``: a model
    axis's rank runs its part of each block's attention and FFN. Dense
    whatever ``tcfg.num_experts`` says, as the JAX package's: the
    switch-MoE encoder is parallel/moe.py's, which the CTC dispatch picks
    (a transducer's transformer encoder stays dense)."""
    x, out_mask, out_lens = frontend(params, feats, frame_mask, frame_lens,
                                     mcfg, tcfg, pos_offset, pre_normalized)
    rate = tcfg.dropout
    x = apply_dropout(x, rate, dropout_bits(x, rate, generator, train))
    flash_mask = out_mask if tcfg.flash_attention else None
    bias = padding_bias(out_mask)
    for i in range(num_blocks(params)):
        block = functools.partial(_block, params, f"blocks.{i}",
                                  key_bias=bias, num_heads=tcfg.num_heads,
                                  flash_mask=flash_mask,
                                  use_kernel=use_kernel, rate=rate,
                                  ffn_dim=tcfg.ffn_dim, dp=dp)
        bits = [dropout_bits(x, rate, generator, train) for _ in range(2)]
        x = run_block(block, x, bits, mcfg.remat)
    return _layer_norm(params, "ln_final", x), out_mask, out_lens


def ctc_head(params: dict, x: torch.Tensor, out_mask: torch.Tensor):
    """Encoder states -> ((B, T', A) masked float32 log-probs, out_mask
    (B, T') float32)."""
    logits = linear(params, "ctc_head", x)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    omask_f = out_mask.to(torch.float32)
    return log_probs * omask_f[:, :, None], omask_f


def apply(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
          frame_lens: torch.Tensor, mcfg: ModelConfig,
          tcfg: TransformerConfig, use_kernel: bool = True,
          train: bool = False, generator: torch.Generator | None = None,
          dp: DataParallel = ONE_DEVICE):
    """(B, T, F) features -> ((B, T', A) CTC log-probs, out_mask (B, T')
    float32, out_lens (B,)). train=True applies dropout with bits from
    `generator`."""
    x, out_mask, out_lens = encode(params, feats, frame_mask, frame_lens,
                                   mcfg, tcfg, use_kernel=use_kernel,
                                   train=train, generator=generator, dp=dp)
    log_probs, omask_f = ctc_head(params, x, out_mask)
    return log_probs, omask_f, out_lens
