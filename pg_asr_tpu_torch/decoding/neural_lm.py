"""Neural (LSTM) language model for shallow fusion in the CTC prefix beam
and for n-best rescoring (counterpart of pg_asr_tpu/decoding/neural_lm.py):
a small LSTM LM trained on the corpus transcripts,

    score(prefix) = log P_ctc(prefix) + lm_weight * log P_lm(prefix)
                    + length_bonus * |prefix|

Conventions shared with the n-gram tables (decoding/lm.py): id 0 (the CTC
blank/pad) doubles as BOS, which the LM consumes first, and the
next-symbol distribution gives no mass to 0 (log P(0 | ctx) = NEG_LM).

Parameters are a flat state dict, the JAX tree's paths joined by dots
(``convert.params_from_jax`` / ``params_to_jax`` carry them across either
way): ``embed`` (A, E), ``layers.{i}.W`` (I, 4H), ``layers.{i}.U`` (H, 4H),
``layers.{i}.b`` (4H,), ``head.w`` (H, A), ``head.b`` (A,), all float32.

Two routes, as in the JAX package:
  * the beam's per-frame step (``lm_advance``, ``lm_next_logp``) is plain
    PyTorch with the JAX cell's numerics (``x @ W + h @ U + b``, then
    ``ops/lstm.xla_gate_step``); the embedding lookup is a row gather,
    which gives the bits of the JAX package's one-hot product;
  * the teacher-forced pass (``lm_sequence_logp``: LM training and
    rescoring) runs each layer through ``ops/lstm.lstm_layer``, so on CUDA
    tensors the hand-written ``lstm_fwd`` kernel (residual form +
    ``lstm_bwd`` under autograd). The JAX scan consumes BOS, scores
    ``ids[t]`` from the state and consumes it while ``t < len``; here the
    recurrence reads ``embed[[BOS, ids[0], .., ids[T-2]]]`` under the mask
    ``t <= len`` (BOS always consumed) and its output at step t scores
    ``ids[t]`` where ``t < len``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..models.bilstm_ctc import init_linear, init_lstm
from ..ops.lstm import lstm_layer, xla_gate_step
from .lm import NEG_LM

# the port's LM file beside the model; the JAX package's is lm_neural.ckpt
LM_FILE = "lm_neural.pt"
JAX_LM_FILE = "lm_neural.ckpt"


def init_lm_params(generator: torch.Generator, vocab: int,
                   embed_dim: int = 48, hidden: int = 160, layers: int = 2,
                   device: torch.device | str = "cpu") -> dict:
    """Tiny LSTM LM: embed -> `layers` x LSTM(hidden) -> head(vocab); the
    JAX init's distributions (embed N(0, 0.1^2), the LSTM and linear inits
    of models/bilstm_ctc.py), drawn on the CPU from `generator`."""
    p = {"embed": torch.randn(vocab, embed_dim, generator=generator) * 0.1}
    for i in range(layers):
        init_lstm(p, f"layers.{i}", embed_dim if i == 0 else hidden, hidden,
                  generator)
    init_linear(p, "head", hidden, vocab, generator)
    return {k: v.to(device) for k, v in p.items()}


def lm_dims(params: dict) -> tuple[int, int, int]:
    """(layers, hidden, vocab) of a parameter dict."""
    L = sum(1 for k in params if k.startswith("layers.") and k.endswith(".U"))
    return L, params["layers.0.U"].shape[0], params["head.b"].shape[0]


def _layer(params: dict, i: int) -> dict:
    return {k: params[f"layers.{i}.{k}"] for k in ("W", "U", "b")}


def lm_advance(params: dict, state: torch.Tensor,
               sym: torch.Tensor) -> torch.Tensor:
    """Advance the LM by one symbol per row. state (L, 2, N, H) stacked (h,
    c) per layer; sym (N,) int ids. -> the new state, same shape."""
    x = params["embed"][sym.long()]
    new = []
    for i in range(state.shape[0]):
        p = _layer(params, i)
        pre = (torch.matmul(x, p["W"]) + torch.matmul(state[i, 0], p["U"])
               + p["b"])
        h, c = xla_gate_step(state[i, 1], pre)
        new.append(torch.stack([h, c]))
        x = h
    return torch.stack(new)


def lm_next_logp(params: dict, state: torch.Tensor) -> torch.Tensor:
    """(N, A) log P(next symbol | consumed prefix): a log-softmax over the
    non-blank symbols; column 0 (blank) is NEG_LM."""
    logits = (torch.matmul(state[-1, 0], params["head.w"])
              + params["head.b"]).float()
    blank = torch.arange(logits.shape[-1], device=logits.device) == 0
    logp = torch.log_softmax(logits.masked_fill(blank, -math.inf), dim=-1)
    return logp.masked_fill(blank, NEG_LM)


def lm_init_state(params: dict, batch: int) -> torch.Tensor:
    """The state after consuming BOS (id 0) from zeros: (L, 2, batch, H)."""
    L, H, _ = lm_dims(params)
    dev = params["embed"].device
    zeros = torch.zeros(L, 2, batch, H, device=dev)
    return lm_advance(params, zeros,
                      torch.zeros(batch, dtype=torch.long, device=dev))


def lm_sequence_logp(params: dict, ids: torch.Tensor, lens: torch.Tensor,
                     use_kernel: bool = True) -> torch.Tensor:
    """Teacher-forced log P(ids[:len]) per row: ids (B, T) int (0-padded),
    lens (B,) -> (B,) float32. Each layer runs ``ops/lstm.lstm_layer`` (the
    LSTM kernels on CUDA tensors unless ``use_kernel`` is False), so it is
    differentiable in the parameters."""
    B, T = ids.shape
    dev = params["embed"].device
    ids = ids.to(device=dev, dtype=torch.long)
    lens = lens.to(device=dev, dtype=torch.long)
    if T == 0:
        return torch.zeros(B, device=dev)
    inp = torch.cat([torch.zeros_like(ids[:, :1]), ids[:, :-1]], dim=1)
    t = torch.arange(T, device=dev)
    mask = (t[None, :] <= lens[:, None]).to(torch.float32)
    x = params["embed"][inp]
    for i in range(lm_dims(params)[0]):
        x = lstm_layer(_layer(params, i), x, mask, use_kernel=use_kernel)
    logits = (torch.matmul(x, params["head.w"]) + params["head.b"]).float()
    blank = torch.arange(logits.shape[-1], device=dev) == 0
    logp = torch.log_softmax(logits.masked_fill(blank, -math.inf), dim=-1)
    tok = torch.gather(logp, 2, ids[..., None])[..., 0]
    return torch.where(t[None, :] < lens[:, None], tok, 0.0).sum(1)


def score_prefix_neural(params: dict, ids) -> float:
    """log P_lm of one prefix on the host, in numpy (an oracle, as
    decoding/lm.score_prefix): the LM's cell in float32, its log-softmax in
    float64."""
    host = {k: v.detach().cpu().float().numpy() for k, v in params.items()}
    L, H, _ = lm_dims(params)

    def sigmoid(z):
        return 1.0 / (1.0 + np.exp(-z))

    def advance(state, sym):
        x = host["embed"][sym]
        new = []
        for i in range(L):
            h, c = state[i]
            pre = (x @ host[f"layers.{i}.W"] + h @ host[f"layers.{i}.U"]
                   + host[f"layers.{i}.b"])
            i_g, f_g = sigmoid(pre[:H]), sigmoid(pre[H:2 * H])
            g_g, o_g = np.tanh(pre[2 * H:3 * H]), sigmoid(pre[3 * H:])
            c = f_g * c + i_g * g_g
            h = o_g * np.tanh(c)
            new.append((h, c))
            x = h
        return new

    def next_logp(state):
        logits = (state[-1][0] @ host["head.w"] + host["head.b"]).astype(
            np.float64)
        logits[0] = -np.inf
        m = np.max(logits[1:])
        logp = logits - (m + np.log(np.sum(np.exp(logits - m))))
        logp[0] = NEG_LM
        return logp

    state = advance([(np.zeros(H, np.float32),) * 2 for _ in range(L)], 0)
    total = 0.0
    for s in ids:
        total += float(next_logp(state)[int(s)])
        state = advance(state, int(s))
    return total


def train_neural_lm(texts, alphabet, *, steps: int = 300, batch: int = 32,
                    lr: float = 3e-3, max_len: int = 128, seed: int = 0,
                    embed_dim: int = 48, hidden: int = 160, layers: int = 2,
                    device: torch.device | str = "cuda",
                    params: dict | None = None) -> dict:
    """Train the LM on transcripts (next-symbol prediction) as the JAX
    package does: the batches ``np.random.default_rng(seed)`` draws, the
    loss -sum(log P) / max(sum(lens), 1), ``optax.adam(lr)``'s update
    (train.AdamW with no clip and no decay). `params`: start from these
    weights (a copy on `device` is trained) instead of
    ``init_lm_params`` from ``torch.Generator().manual_seed(seed)``."""
    from ..config import Config, TrainConfig
    from ..train import AdamW, value_and_grad

    texts = [t for t in texts if t]
    if not texts:
        raise ValueError("no transcripts to train the LM on")
    enc = [np.asarray(alphabet.encode(t)[:max_len], np.int32) for t in texts]
    T = max(1, max(len(e) for e in enc))
    ids = np.zeros((len(enc), T), np.int32)
    lens = np.zeros((len(enc),), np.int32)
    for i, e in enumerate(enc):
        ids[i, :len(e)] = e
        lens[i] = len(e)

    if params is None:
        params = init_lm_params(torch.Generator().manual_seed(seed),
                                alphabet.size, embed_dim=embed_dim,
                                hidden=hidden, layers=layers)
    params = {k: v.detach().to(device=device, dtype=torch.float32,
                               copy=True) for k, v in params.items()}
    opt = AdamW(Config(train=TrainConfig(grad_clip=math.inf)), params,
                learning_rate=lr, weight_decay=0.0)
    rng = np.random.default_rng(seed)

    def loss_fn(p, bids, blens):
        lp = lm_sequence_logp(p, bids, blens)
        return -lp.sum() / blens.sum().clamp(min=1)

    n = len(enc)
    for _ in range(steps):
        idx = rng.integers(0, n, min(batch, n))
        bids = torch.from_numpy(ids[idx]).to(device)
        blens = torch.from_numpy(lens[idx]).to(device)
        _, grads = value_and_grad(lambda p: loss_fn(p, bids, blens), params)
        opt.update(params, grads)
    return params


def save_lm(params: dict, path: str) -> None:
    """Write the LM's parameters to `path` (the port's .pt format)."""
    from ..checkpoint import save_checkpoint

    save_checkpoint(path, {"params": params})


def load_lm(path: str, vocab: int, embed_dim: int = 48, hidden: int = 160,
            layers: int = 2, device: torch.device | str = "cpu"
            ) -> dict | None:
    """The LM at `path` (the port's .pt, or the JAX package's flax .ckpt)
    on `device`, or None where there is no file. Its parameters must have
    the shapes these dimensions give."""
    if not os.path.exists(path):
        return None
    from ..checkpoint import load_checkpoint, read_flax_checkpoint
    from ..convert import params_from_jax

    if path.endswith(".ckpt"):
        params = params_from_jax(read_flax_checkpoint(path))
    else:
        params = load_checkpoint(path)["params"]
    want = init_lm_params(torch.Generator(), vocab, embed_dim=embed_dim,
                          hidden=hidden, layers=layers)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    if shapes != {k: tuple(v.shape) for k, v in want.items()}:
        raise ValueError(f"{path}: the LM's parameters {shapes} do not match "
                         f"vocab {vocab}, embed {embed_dim}, hidden {hidden}, "
                         f"{layers} layers")
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in params.items()}
