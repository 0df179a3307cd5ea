"""Attention seq2seq (LAS-style) model family (counterpart of
pg_asr_tpu/models/seq2seq.py).

  * Encoder: the BiLSTM stack of the flagship CTC model without its head
    (``bilstm_ctc.encode`` on the ``encoder.`` parameters: the fused
    ``bilstm_fwd`` / ``bilstm_bwd`` kernels on CUDA tensors).
  * Decoder: embedding (A, E) -> one LSTM (E -> H) -> dot-product
    attention of its states over the (B, Te, 2H_enc) encoder states (one
    head, no scaling; scores in float32, padded frames at -1e30) ->
    Linear(H + 2H_enc -> A) on [state, context] -> log-softmax in float32.
    Teacher forcing shifts the targets right with BOS = pad id 0, which
    also serves as end-of-sequence.

Teacher-forced decoding runs the decoder LSTM over all steps at once
through ``ops/lstm.lstm_layer`` with an all-ones mask: on CUDA tensors
the ``lstm_fwd`` kernel (inference form, or under autograd its residual
form and ``lstm_bwd``), on CPU tensors their plain versions; then one
batched attention for all steps. Free-running decoding (greedy, sampling
for SCST, the beam search) is a Python loop over steps of
``ops/lstm.xla_gate_step``, the JAX package's gate numerics with the
carries in the encoder states' dtype, as the transducer's decoders; the
greedy steps are one scan under torch.export (utils/loops.py).

Parameters: a flat dict in the JAX package's layouts, ``encoder.*`` (the
BiLSTM-CTC encoder's names), ``embed`` (A, E), ``dec_lstm.{W, U, b}`` and
``output.{w, b}``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig, Seq2SeqConfig
from ..decoding.beam import _top_k
from ..ops.lstm import lstm_layer, xla_gate_step
from ..utils.loops import scan_steps
from . import bilstm_ctc, cast_params
from .bilstm_ctc import init_linear, init_lstm, linear, torch_dtype

NEG = -1e30


def init_params(enc_cfg: ModelConfig, dec_cfg: Seq2SeqConfig,
                generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Same shapes and distributions as the JAX init (the encoder as the
    BiLSTM-CTC's, embed ~ N(0, 0.1^2), the decoder LSTM and the output
    linear as everywhere), drawn on the CPU from `generator`, then moved
    and cast."""
    enc = bilstm_ctc.init_encoder_params(enc_cfg, generator)
    p = {f"encoder.{k}": v for k, v in enc.items()}
    p["embed"] = torch.randn(dec_cfg.vocab_size, dec_cfg.embed_dim,
                             generator=generator) * 0.1
    init_lstm(p, "dec_lstm", dec_cfg.embed_dim, dec_cfg.dec_hidden, generator)
    init_linear(p, "output", dec_cfg.dec_hidden + 2 * enc_cfg.hidden_size,
                dec_cfg.vocab_size, generator)
    return cast_params(p, torch_dtype(enc_cfg.dtype), device)


def encode(params: dict, feats: torch.Tensor, frame_mask: torch.Tensor,
           cfg: ModelConfig, use_kernel: bool = True, train: bool = False,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, T, F) features -> (B, T, 2H) encoder states (the BiLSTM-CTC
    stack and its dropout)."""
    enc = {k[len("encoder."):]: v for k, v in params.items()
           if k.startswith("encoder.")}
    return bilstm_ctc.encode(enc, feats, frame_mask, cfg,
                             use_kernel=use_kernel, train=train,
                             generator=generator)


def _attend(q: torch.Tensor, enc_out: torch.Tensor,
            frame_mask: torch.Tensor) -> torch.Tensor:
    """Dot-product attention of K queries per utterance: q (B, K, H),
    enc_out (B, Te, H) -> context (B, K, H) in q's dtype. The scores are
    float32 sums of the (exact) products of the operands, the padded
    frames at -1e30 before the softmax, and the context a float32 sum
    rounded to q's dtype (the JAX package's preferred_element_type)."""
    e = enc_out.float()
    scores = torch.matmul(q.float(), e.transpose(1, 2))
    scores = torch.where(frame_mask[:, None, :] > 0, scores, NEG)
    return torch.matmul(torch.softmax(scores, dim=-1), e).to(q.dtype)


def _output(params: dict, h: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """[state, context] -> float32 log-probs over the vocabulary."""
    logits = linear(params, "output", torch.cat([h, ctx], dim=-1))
    return torch.log_softmax(logits.float(), dim=-1)


def decode_teacher_forced(params: dict, enc_out: torch.Tensor,
                          frame_mask: torch.Tensor, targets: torch.Tensor,
                          use_kernel: bool = True) -> torch.Tensor:
    """Teacher-forced decoder over precomputed encoder states: enc_out
    (B, Te, E), targets (B * K, Td), K >= 1 hypotheses per utterance
    (rows b * K + k) -> (B * K, Td, A) float32 log-probs; position t
    predicts targets[:, t]. The recurrence over all B * K rows is one
    ``lstm_layer`` call, and every row attends over its utterance's
    states (the K hypotheses of one utterance share them, so the
    encoder states are not repeated)."""
    B = enc_out.shape[0]
    N, Td = targets.shape
    dec_in = F.pad(targets[:, :-1].long(), (1, 0))  # BOS = 0
    x = params["embed"][dec_in]  # (N, Td, E)
    lstm = {k: params[f"dec_lstm.{k}"] for k in ("W", "U", "b")}
    h = lstm_layer(lstm, x, x.new_ones(N, Td), use_kernel=use_kernel)
    ctx = _attend(h.reshape(B, -1, h.shape[-1]), enc_out, frame_mask)
    return _output(params, h, ctx.reshape(N, Td, -1))


def apply_teacher_forced(params: dict, feats: torch.Tensor,
                         frame_mask: torch.Tensor, targets: torch.Tensor,
                         enc_cfg: ModelConfig, use_kernel: bool = True,
                         train: bool = False,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """Teacher-forced forward: (B, T, F) features + (B, Td) targets ->
    (B, Td, A) float32 log-probs. Dropout (encoder only) draws from
    `generator` in training."""
    enc_out = encode(params, feats, frame_mask, enc_cfg,
                     use_kernel=use_kernel, train=train, generator=generator)
    return decode_teacher_forced(params, enc_out, frame_mask, targets,
                                 use_kernel=use_kernel)


def _step(params: dict, tok: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
          enc_out: torch.Tensor, frame_mask: torch.Tensor):
    """One free-running decoder step for K rows per utterance (tok (B * K,)
    rows b * K + k, h and c (B * K, H) in the encoder states' dtype) ->
    (h, c, log-probs (B * K, A) float32)."""
    B = enc_out.shape[0]
    x = params["embed"][tok]
    pre = x @ params["dec_lstm.W"] + h @ params["dec_lstm.U"] \
        + params["dec_lstm.b"]
    h, c = xla_gate_step(c, pre)
    ctx = _attend(h.reshape(B, -1, h.shape[-1]), enc_out, frame_mask)
    return h, c, _output(params, h, ctx.reshape(h.shape[0], -1))


def _zero_carry(params: dict, n: int, enc_out: torch.Tensor):
    H = params["dec_lstm.U"].shape[0]
    h = enc_out.new_zeros(n, H)
    return h, torch.zeros_like(h)


def greedy_from_encoder(params: dict, enc_out: torch.Tensor,
                        frame_mask: torch.Tensor, max_steps: int = 128):
    """Greedy decoding over precomputed encoder states: all `max_steps`
    steps, as the JAX package's scan (utils/loops.scan_steps: one scan
    under torch.export) -> (tokens (B, max_steps) int64, log-probs (B,
    max_steps, A) float32)."""
    B = enc_out.shape[0]
    dev = enc_out.device
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    h, c = _zero_carry(params, B, enc_out)

    def step(carry, _):
        tok, h, c = carry
        h, c, lp = _step(params, tok, h, c, enc_out, frame_mask)
        tok = torch.argmax(lp, dim=-1)
        return (tok, h, c), (tok, lp)

    _, (toks, lps) = scan_steps(step, (tok, h, c),
                                (torch.arange(max_steps, device=dev),))
    return toks.transpose(0, 1), lps.transpose(0, 1)


def greedy_generate(params: dict, feats: torch.Tensor,
                    frame_mask: torch.Tensor, enc_cfg: ModelConfig,
                    max_steps: int = 128, use_kernel: bool = True):
    """Encoder + greedy decoding -> (tokens (B, max_steps), log-probs
    (B, max_steps, A))."""
    enc_out = encode(params, feats, frame_mask, enc_cfg,
                     use_kernel=use_kernel)
    return greedy_from_encoder(params, enc_out, frame_mask, max_steps)


def generated_lengths(tokens: torch.Tensor) -> torch.Tensor:
    """(..., L) generated ids -> (...) int64 length at the first EOS (pad
    id 0), L where there is none."""
    is_eos = tokens == 0
    first = is_eos.to(torch.int8).argmax(dim=-1)
    return torch.where(is_eos.any(dim=-1), first, tokens.shape[-1])


def cut_at_eos(tokens: torch.Tensor):
    """(..., L) generated ids -> (the ids zero-padded from the first EOS
    on, their lengths (...) int64)."""
    lens = generated_lengths(tokens)
    pos = torch.arange(tokens.shape[-1], device=tokens.device)
    return torch.where(pos < lens[..., None], tokens, 0), lens


def draw_tokens(generator: torch.Generator | None,
                logits: torch.Tensor) -> torch.Tensor:
    """(N, A) float32 logits -> (N,) int64 ids ~ Categorical(softmax
    (logits)), an exact draw by the Gumbel-max rule from `generator` (on
    the logits' device), as ``jax.random.categorical``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_from_encoder(params: dict, enc_out: torch.Tensor,
                        frame_mask: torch.Tensor,
                        generator: torch.Generator | None, num_samples: int,
                        max_steps: int = 128, temperature: float = 1.0):
    """Autoregressive sampling for SCST: S = num_samples continuations per
    utterance, advanced together; each step's token is drawn
    (``draw_tokens``) from the detached step posterior divided by the
    temperature, while the returned log-probs stay differentiable (through
    the decoder carry, the attention contexts and the encoder states).

    Returns (tokens (S, B, L) int64, tok_lp (S, B, L) float32 log p(token),
    entropy (S, B, L) float32 of each step's posterior)."""
    B = enc_out.shape[0]
    S = num_samples
    N = S * B
    inv_temp = float(np.float32(1.0) / max(np.float32(temperature),
                                           np.float32(1e-6)))
    # the decoder's rows are b * S + s: every utterance's samples attend
    # over its own states
    tok = torch.zeros(N, dtype=torch.long, device=enc_out.device)
    h, c = _zero_carry(params, N, enc_out)
    toks, tok_lps, ents = [], [], []
    for _ in range(max_steps):
        h, c, lp = _step(params, tok, h, c, enc_out, frame_mask)
        tok = draw_tokens(generator, lp.detach() * inv_temp)
        toks.append(tok)
        tok_lps.append(torch.gather(lp, 1, tok[:, None])[:, 0])
        ents.append(-(torch.exp(lp) * lp).sum(-1))

    def to_sbl(steps):  # L x (B * S,) -> (S, B, L)
        return torch.stack(steps, dim=1).reshape(B, S, max_steps).transpose(
            0, 1)

    return to_sbl(toks), to_sbl(tok_lps), to_sbl(ents)


def beam_scan_from_encoder(params: dict, enc_out: torch.Tensor,
                           frame_mask: torch.Tensor, beam_size: int = 8,
                           max_steps: int = 128, length_norm: float = 0.6):
    """Beam search over the decoder, all beams of all utterances advancing
    together: one (B * K)-row decoder step, then the K best of the K * A
    candidates per utterance by a stable descending sort (``lax.top_k``'s
    order: ties toward the lower index). Finished beams carry on with a
    single zero-cost EOS continuation, so their scores freeze.

    Returns the whole n-best list: (tokens (B, K, max_steps) int64
    zero-padded after the first EOS, lens (B, K) int64, GNMT length-
    normalized scores (B, K) float32, score / ((5 + L) / 6)^length_norm;
    dead beams keep the raw -1e30)."""
    B = enc_out.shape[0]
    K = beam_size
    A = params["output.b"].shape[0]
    dev = enc_out.device
    tok = torch.zeros(B * K, dtype=torch.long, device=dev)
    h, c = _zero_carry(params, B * K, enc_out)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    buf = torch.zeros(B, K, max_steps, dtype=torch.long, device=dev)
    eos_only = torch.full((A,), NEG, dtype=torch.float32, device=dev)
    eos_only[0] = 0.0
    base = torch.arange(B, device=dev)[:, None] * K
    for t in range(max_steps):
        h, c, lp = _step(params, tok, h, c, enc_out, frame_mask)
        lp = torch.where(finished[:, :, None], eos_only, lp.reshape(B, K, A))
        scores, idx = _top_k((scores[:, :, None] + lp).reshape(B, K * A), K)
        parent = idx // A
        new_tok = idx % A
        rows = (base + parent).reshape(-1)
        h, c = h[rows], c[rows]
        finished = torch.gather(finished, 1, parent) | (new_tok == 0)
        buf = torch.gather(buf, 1, parent[:, :, None].expand(-1, -1,
                                                             max_steps))
        buf[:, :, t] = new_tok
        tok = new_tok.reshape(-1)
    buf, lens = cut_at_eos(buf)
    penalty = torch.pow((5.0 + lens.float()) / 6.0,
                        torch.tensor(length_norm, dtype=torch.float32))
    # the raw sentinel for dead beams: divided by the penalty it would rise
    # above the -1e29 liveness cutoff that MWER thresholds against
    normed = torch.where(scores > -1e29,
                         scores / torch.clamp(penalty, min=1e-6), NEG)
    return buf, lens, normed


def beam_generate(params: dict, feats: torch.Tensor,
                  frame_mask: torch.Tensor, enc_cfg: ModelConfig,
                  beam_size: int = 8, max_steps: int = 128,
                  length_norm: float = 0.6, use_kernel: bool = True):
    """Encoder + beam search -> the best beam of each utterance: (tokens
    (B, max_steps) zero-padded after EOS, lens (B,), normalized scores
    (B,))."""
    enc_out = encode(params, feats, frame_mask, enc_cfg,
                     use_kernel=use_kernel)
    buf, lens, normed = beam_scan_from_encoder(params, enc_out, frame_mask,
                                               beam_size, max_steps,
                                               length_norm)
    best = torch.argmax(normed, dim=1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf[rows, best], lens[rows, best], normed[rows, best]
