"""Weight-only int8 post-training quantization for export (counterpart of
pg_asr_tpu/ops/quant.py).

``quantize_tree`` replaces every float parameter with ndim >= 2 and at
least ``min_size`` elements by a quantized leaf, the dict ``{"q8": int8,
"s": float32 per-output-channel scales, "d": a zero-size tensor of the
original dtype}``; biases, norms and other 1-D parameters stay float. The
port's parameters are a flat ``dict[str, Tensor]``, so a quantized tree is
that dict with some values replaced by leaves; ``convert.params_from_jax``
and ``params_to_jax`` map such a leaf to and from the JAX package's
``{"q8", "s", "d"}`` leaf under the same name.

The numerics are the JAX package's, bit for bit: the scale is ``max(amax,
1e-8)`` in float32 over 127; ``w / scale`` in float32 is rounded half to
even (``torch.round``, as ``jnp.round``) and clipped to +-127; the
dequantized weight is ``q8.to(dtype) * s.to(dtype)``, so in bfloat16 the
scale is rounded before the product.

``dequantize_tree`` runs inside the exported serving program
(exporting.py): the int8 copy is what the artifact stores, and the
dequantized weights are made on each call. What it buys is size, not
speed: on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 16, the
full-width BiLSTM-CTC at B=8 x 20 s) the int8 artifact is 5.8 MB against
20.0 MB in float32 (3.4x: the scales, the 1-D parameters and the
features' DFT constant stay float), and its call takes 11.14 ms of
device time against 11.09, its dequantization 28 more device operations
a call.
"""

from __future__ import annotations

from typing import Any

import torch

LEAF_KEYS = ("q8", "s", "d")


def quantize_array(w: torch.Tensor) -> dict:
    """Symmetric int8 with per-output-channel scales (the last axis holds
    the output channels in every matmul and embedding table of the port:
    linear (in, out), LSTM (in, 4H), embeddings (A, E))."""
    reduce_axes = tuple(range(w.dim() - 1))
    amax = torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-8).to(torch.float32) / 127.0
    q = torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127)
    return {"q8": q.to(torch.int8), "s": scale,
            "d": torch.zeros((0,), dtype=w.dtype, device=w.device)}


def dequantize_array(leaf: dict, dtype: torch.dtype | None = None):
    out_dtype = dtype if dtype is not None else leaf["d"].dtype
    return leaf["q8"].to(out_dtype) * leaf["s"].to(out_dtype)


def is_quantized_leaf(x: Any) -> bool:
    return isinstance(x, dict) and "q8" in x and "s" in x


def quantize_tree(params: dict, min_size: int = 1024) -> dict:
    """Quantize every float tensor with ndim >= 2 and >= min_size elements
    (a small tensor is not worth its dequantization)."""
    def q(x):
        if (isinstance(x, torch.Tensor) and x.dim() >= 2
                and x.numel() >= min_size and x.is_floating_point()):
            return quantize_array(x)
        return x
    return {k: q(v) for k, v in params.items()}


def dequantize_tree(qparams: dict, dtype: torch.dtype | None = None) -> dict:
    """Inverse of quantize_tree (each leaf back in its own dtype, or in
    `dtype`)."""
    return {k: dequantize_array(v, dtype) if is_quantized_leaf(v) else v
            for k, v in qparams.items()}


def tree_bytes(params: dict) -> int:
    """Parameter bytes as stored (an int8 leaf counts one byte an element
    plus its scales)."""
    total = 0
    for v in params.values():
        for t in (v.values() if isinstance(v, dict) else (v,)):
            total += t.numel() * t.element_size()
    return total
