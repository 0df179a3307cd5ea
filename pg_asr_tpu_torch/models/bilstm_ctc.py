"""Flagship acoustic model: BiLSTM-CTC (counterpart of
pg_asr_tpu/models/bilstm_ctc.py).

Masked per-utterance feature normalization -> Linear(F -> proj) + leaky_relu
-> N stacked BiLSTM layers (hidden per direction) -> Linear(2H -> A) ->
log_softmax in float32, alphabet index 0 = blank/pad. In training,
dropout follows the input projection and every BiLSTM layer but the last.
Each layer runs its two directions in one fused walk (the same bits as two
single-direction walks).

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
from . import cast_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def init_linear(p: dict, name: str, in_dim: int, out_dim: int,
                generator: torch.Generator) -> None:
    """Xavier-normal ``{name}.w`` (in, out) and bias ``{name}.b`` = 0.1, in
    float32 on the CPU (the JAX package's ``init_linear``)."""
    std = (2.0 / (in_dim + out_dim)) ** 0.5
    p[f"{name}.w"] = torch.randn(in_dim, out_dim, generator=generator) * std
    p[f"{name}.b"] = torch.full((out_dim,), 0.1)


def init_lstm(p: dict, name: str, in_dim: int, H: int,
              generator: torch.Generator) -> None:
    """``{name}.W`` (in, 4H) and ``{name}.U`` (H, 4H) ~ U(-1/sqrt(H),
    1/sqrt(H)), ``{name}.b`` 0 with the forget gate at +1, float32 on the
    CPU (the JAX package's ``init_lstm_params``)."""
    bound = 1.0 / math.sqrt(H)
    p[f"{name}.W"] = (torch.rand(in_dim, 4 * H, generator=generator)
                      * 2 - 1) * bound
    p[f"{name}.U"] = (torch.rand(H, 4 * H, generator=generator)
                      * 2 - 1) * bound
    b = torch.zeros(4 * H)
    b[H:2 * H] = 1.0
    p[f"{name}.b"] = b


def init_encoder_params(cfg: ModelConfig,
                        generator: torch.Generator) -> dict:
    """Encoder parameters (no CTC head), float32 on the CPU: the input
    projection and the BiLSTM layers (shared with the transducer family,
    models/transducer.py)."""
    H = cfg.hidden_size
    p: dict[str, torch.Tensor] = {}
    init_linear(p, "input_proj", cfg.input_dim, cfg.input_proj_dim, generator)
    in_dim = cfg.input_proj_dim
    for layer in range(cfg.num_layers):
        for d in ("fwd", "bwd"):
            init_lstm(p, f"lstm.{layer}.{d}", in_dim, H, generator)
        in_dim = 2 * H
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Same shapes and distributions as the JAX init: Xavier-normal linears
    with bias 0.1; LSTM W and U ~ U(-1/sqrt(H), 1/sqrt(H)), bias 0 with the
    forget gate at +1. Drawn on the CPU from `generator`, then moved."""
    p = init_encoder_params(cfg, generator)
    init_linear(p, "ctc_head", 2 * cfg.hidden_size, cfg.vocab_size,
                generator)
    return cast_params(p, torch_dtype(cfg.dtype), device)


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


def dropout_bits(x: torch.Tensor, rate: float,
                 generator: torch.Generator | None,
                 train: bool) -> torch.Tensor | None:
    """The uint8 bits of one dropout site of x's shape, drawn from
    `generator` on x's device; None where no dropout applies (not
    training, or rate 0). A rate above 0 in training without a generator
    raises."""
    if not train or rate <= 0.0:
        return None
    if generator is None:
        raise ValueError(f"dropout {rate} in training needs a generator for "
                         "its bits")
    return torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)


def apply_dropout(x: torch.Tensor, rate: float,
                  bits: torch.Tensor | None) -> torch.Tensor:
    """``dropout_from_bits``, or x itself where ``bits`` is None."""
    return x if bits is None else dropout_from_bits(x, rate, bits)


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator | None, train: bool) -> torch.Tensor:
    return apply_dropout(x, rate, dropout_bits(x, rate, generator, train))


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
        # Both directions in one walk: one bilstm_fwd launch, and one
        # bilstm_bwd call under autograd. The fused pair beats two
        # single-direction walks in both state types (kernel_ab.py bilstm,
        # B=64, T=401, H=256, NVIDIA H100 80GB HBM3 at 700 W; float32 /
        # bfloat16): inference form 1.572 / 1.115 ms against 1.905 / 1.572;
        # residual form + backward 1.599 + 4.790 / 1.116 + 3.222 ms against
        # 1.936 + 5.799 / 1.577 + 4.040.
        x = bilstm_layer(layer, x, mask, use_kernel=use_kernel,
                         fuse_directions=True)
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
