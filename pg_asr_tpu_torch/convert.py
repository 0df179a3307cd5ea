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

A weight-only int8 leaf (ops/quant.py) keeps its place: the JAX package's
``{"q8", "s", "d"}`` dict under a parameter's path is the port's leaf dict
under the parameter's name, and back (each array exact; a bfloat16 "d"
comes back float32, as every bfloat16 array does).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.quant import is_quantized_leaf


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX params (nested dicts and lists of arrays, or of CPU tensors as
    ``checkpoint.read_flax_checkpoint`` gives them) -> port state dict (CPU
    tensors, in the arrays' types)."""
    out: dict[str, torch.Tensor] = {}

    def tensor(node) -> torch.Tensor:
        if isinstance(node, torch.Tensor):
            return node.detach().clone()
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' type: widen, exact
            return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(arr)

    def walk(prefix: str, node) -> None:
        if is_quantized_leaf(node):  # stays a leaf, its arrays converted
            out[prefix] = {k: tensor(v) for k, v in node.items()}
            return
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = tensor(node)
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

    def to_numpy(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    for name, t in state.items():
        node = root
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = ({k: to_numpy(v) for k, v in t.items()}
                      if is_quantized_leaf(t) else to_numpy(t))

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
