"""Parameter bridge between the JAX package's parameter pytrees and the
port's flat state dicts (the reverse direction of
pg_asr_tpu/models/torch_import.py), for every family the port serves.

A state dict name is the tree path joined by dots, list positions as
numbers, and every array keeps its JAX layout (linears (in, out), LSTM
gates i,f,g,o, the conformer's depthwise kernel (K, 1, d)), so each
direction is a renaming and exact:
  BiLSTM-CTC   {"input_proj": {"w", "b"}, "lstm": [{"fwd": {"W", "U", "b"},
               "bwd": {...}}, ...], "ctc_head": {...}}
               <-> ``input_proj.w``, ``lstm.{i}.{fwd,bwd}.{W,U,b}``, ...
  transformer  {"input_proj", "blocks": [{"ln1": {"scale", "bias"}, "qkv",
  / conformer  ...}, ...], "ln_final", "ctc_head"}
               <-> ``blocks.{i}.ln1.scale``, ``blocks.{i}.qkv.w``,
               ``blocks.{i}.conv_dw``, ``ln_final.bias``, ...
  seq2seq      {"encoder": {"input_proj", "lstm": [...]}, "embed",
               "dec_lstm": {"W", "U", "b"}, "output": {"w", "b"}}
               <-> ``encoder.lstm.{i}.fwd.W``, ``embed``, ``dec_lstm.U``,
               ``output.w``, ...
  neural LM    {"embed", "layers": [{"W", "U", "b"}, ...], "head": {"w",
               "b"}} (pg_asr_tpu/decoding/neural_lm.py)
               <-> ``embed``, ``layers.{i}.W``, ``head.w``, ...
               (decoding/neural_lm.py)
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX params (nested dicts and lists of arrays, or of CPU tensors as
    ``checkpoint.read_flax_checkpoint`` gives them) -> port state dict (CPU
    tensors, in the arrays' types)."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        elif isinstance(node, torch.Tensor):
            out[prefix] = node.detach().clone()
            return
        else:
            arr = np.array(node, copy=True)
            if arr.dtype.name == "bfloat16":  # ml_dtypes' type: widen, exact
                out[prefix] = torch.from_numpy(
                    arr.astype(np.float32)).to(torch.bfloat16)
            else:
                out[prefix] = torch.from_numpy(arr)
            return
        for key, child in items:
            walk(f"{prefix}.{key}" if prefix else str(key), child)

    walk("", tree)
    return out


def params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """Port state dict -> JAX params as numpy arrays (numbered levels
    become lists). bfloat16 tensors come back as float32 (numpy has no
    bfloat16; the widening is exact)."""
    root: dict = {}
    for name, t in state.items():
        node = root
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        t = t.detach().cpu()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
