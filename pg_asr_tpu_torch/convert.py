"""Parameter bridge between the JAX package's BiLSTM-CTC pytree and the
port's flat state dict (the reverse direction of
pg_asr_tpu/models/torch_import.py).

JAX tree (as numpy arrays):
  {"input_proj": {"w": (F, proj), "b"}, "lstm": [{"fwd": {"W", "U", "b"},
   "bwd": {...}}, ...], "ctc_head": {"w": (2H, A), "b"}}
Port state dict: ``input_proj.w``, ``lstm.{i}.{fwd,bwd}.{W,U,b}``,
``ctc_head.w`` ... with the same layouts (linears (in, out), LSTM gates
i,f,g,o), so the conversion is a renaming and is exact both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bilstm_ctc import num_layers


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX BiLSTM-CTC params (numpy arrays) -> port state dict (CPU)."""
    out: dict[str, torch.Tensor] = {}

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, copy=True))

    for lin in ("input_proj", "ctc_head"):
        put(f"{lin}.w", tree[lin]["w"])
        put(f"{lin}.b", tree[lin]["b"])
    for i, layer in enumerate(tree["lstm"]):
        for d in ("fwd", "bwd"):
            for n in ("W", "U", "b"):
                put(f"lstm.{i}.{d}.{n}", layer[d][n])
    return out


def params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """Port state dict -> JAX BiLSTM-CTC params as numpy arrays. bfloat16
    tensors come back as float32 (numpy has no bfloat16; the widening is
    exact)."""
    def arr(name):
        t = state[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return {
        "input_proj": {"w": arr("input_proj.w"), "b": arr("input_proj.b")},
        "lstm": [{d: {n: arr(f"lstm.{i}.{d}.{n}") for n in ("W", "U", "b")}
                  for d in ("fwd", "bwd")} for i in range(num_layers(state))],
        "ctc_head": {"w": arr("ctc_head.w"), "b": arr("ctc_head.b")},
    }
