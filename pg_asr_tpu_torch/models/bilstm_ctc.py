"""Flagship acoustic model: BiLSTM-CTC (counterpart of
pg_asr_tpu/models/bilstm_ctc.py).

Masked per-utterance feature normalization -> Linear(F -> proj) + leaky_relu
-> N stacked BiLSTM layers (hidden per direction) -> Linear(2H -> A) ->
log_softmax in float32, alphabet index 0 = blank/pad. In training,
dropout follows the input projection and every BiLSTM layer but the last.

Parameters are a flat dict of tensors (the state dict that
``checkpoint.save_model`` writes), in the JAX package's layouts:
  input_proj.w (F, proj), input_proj.b (proj,)
  lstm.{i}.{fwd,bwd}.{W (I, 4H), U (H, 4H), b (4H,)}
  ctc_head.w (2H, A), ctc_head.b (A,)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.lstm import bilstm_layer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Same shapes and distributions as the JAX init: Xavier-normal linears
    with bias 0.1; LSTM W and U ~ U(-1/sqrt(H), 1/sqrt(H)), bias 0 with the
    forget gate at +1. Drawn on the CPU from `generator`, then moved."""
    dtype = torch_dtype(cfg.dtype)
    H = cfg.hidden_size
    p: dict[str, torch.Tensor] = {}

    def linear(name, i, o):
        std = (2.0 / (i + o)) ** 0.5
        p[f"{name}.w"] = torch.randn(i, o, generator=generator) * std
        p[f"{name}.b"] = torch.full((o,), 0.1)

    linear("input_proj", cfg.input_dim, cfg.input_proj_dim)
    in_dim = cfg.input_proj_dim
    bound = 1.0 / math.sqrt(H)
    for layer in range(cfg.num_layers):
        for d in ("fwd", "bwd"):
            pre = f"lstm.{layer}.{d}"
            p[f"{pre}.W"] = (torch.rand(in_dim, 4 * H, generator=generator)
                             * 2 - 1) * bound
            p[f"{pre}.U"] = (torch.rand(H, 4 * H, generator=generator)
                             * 2 - 1) * bound
            b = torch.zeros(4 * H)
            b[H:2 * H] = 1.0
            p[f"{pre}.b"] = b
        in_dim = 2 * H
    linear("ctc_head", 2 * H, cfg.vocab_size)
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}


def num_layers(params: dict) -> int:
    return sum(1 for k in params if k.startswith("lstm.") and k.endswith(".fwd.U"))


def normalize_features(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked per-utterance normalization over (valid frames x channels)."""
    m = mask[:, :, None]
    count = torch.clamp(m.sum(dim=(1, 2), keepdim=True) * feats.shape[-1],
                        min=1.0)
    mean = (feats * m).sum(dim=(1, 2), keepdim=True) / count
    var = ((feats - mean).square() * m).sum(dim=(1, 2), keepdim=True) / count
    return (feats - mean) * torch.rsqrt(var + 1e-5) * m


def linear(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params[f"{name}.w"]) + params[f"{name}.b"]


def dropout_threshold(rate: float) -> tuple[int, float]:
    """The JAX package's uint8-threshold rule (pg_asr_tpu/models/
    bilstm_ctc.py ``_dropout``): drop where a uniform byte is below
    ``thresh = round(256 * rate)``, clamped to [1, 255] so that a rate in
    (0, 1) always drops something and keeps something; keep probability is
    the exact quantised ``1 - thresh / 256``."""
    thresh = min(max(int(round(rate * 256.0)), 1), 255)
    return thresh, 1.0 - thresh / 256.0


def dropout_from_bits(x: torch.Tensor, rate: float,
                      bits: torch.Tensor) -> torch.Tensor:
    """Dropout of x with the given uint8 bits (same shape): kept values are
    scaled by 1 / keep_p."""
    thresh, keep_p = dropout_threshold(rate)
    return torch.where(bits >= thresh, x / keep_p, torch.zeros_like(x))


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator | None, train: bool) -> torch.Tensor:
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout {rate} in training needs a generator for "
                         "its bits")
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    return dropout_from_bits(x, rate, bits)


def encode(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
           cfg: ModelConfig, use_kernel: bool = True, train: bool = False,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Encoder forward: (B, T, F) features -> (B, T, 2H) states. In
    training (train=True) dropout draws its bits from `generator`, on x's
    device; a dropout rate above 0 without one raises."""
    dtype = torch_dtype(cfg.dtype)
    mask = frame_mask.to(dtype)
    x = normalize_features(feats.to(dtype), mask)
    x = F.leaky_relu(linear(params, "input_proj", x), negative_slope=0.01)
    x = _dropout(x, cfg.dropout, generator, train)
    n = num_layers(params)
    for i in range(n):
        layer = {d: {k: params[f"lstm.{i}.{d}.{k}"] for k in ("W", "U", "b")}
                 for d in ("fwd", "bwd")}
        x = bilstm_layer(layer, x, mask, use_kernel=use_kernel)
        if i < n - 1:
            x = _dropout(x, cfg.dropout, generator, train)
    return x


def apply(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
          cfg: ModelConfig, use_kernel: bool = True, train: bool = False,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """Forward pass: (B, T, F) features -> (B, T, A) CTC log-probs (f32)."""
    x = encode(params, feats, frame_mask, cfg, use_kernel=use_kernel,
               train=train, generator=generator)
    logits = linear(params, "ctc_head", x)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return log_probs * frame_mask.to(torch.float32)[:, :, None]
