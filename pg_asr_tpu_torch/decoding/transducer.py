"""Batched greedy and beam decoding of the RNN-T transducer (counterpart of
pg_asr_tpu/decoding/transducer.py, same names).

Frame-synchronous greedy search: at each encoder frame, repeatedly take the
joint network's argmax; a label advances the prediction network and stays
on the frame (at most ``max_symbols`` emissions per frame), blank moves to
the next frame. The beam search keeps, per utterance, K label histories,
each scored by the log-sum-exp over its surviving alignments (at most
``max_symbols`` labels per frame), merging histories that retire into a
frame's done pool by a rolling int32 prefix hash and their length.

Plain PyTorch on the encoder states' device (no Pallas kernel lies under
the JAX functions): where JAX scans, a Python loop over frames and
expansion rounds (``over_frames``: under torch.export the frames are one
``scan`` of the same step, utils/loops.py); where it vmaps the beam over
the batch, a batch dimension written out. Payloads (labels,
prediction-network states) move by gather where JAX contracts one-hot
matrices: every output slot selects exactly one candidate, so the values
are the same. The encoder-side joint projection is
hoisted out of the loops as one (B, T, J) product, and logits are cast to
float32 after the ``joint_out`` linear in the compute dtype, as in JAX.
"""

from __future__ import annotations

import functools

import torch

from ..config import Config
from ..models.bilstm_ctc import linear
from ..models.transducer import embed_labels
from ..ops.lstm import xla_gate_step
from ..utils.loops import scan_steps
from .beam import _logsumexp, rank_topk

NEG = -1.0e30
_HASH_M = 1_000_003  # the rolling history hash's multiplier (int32, wraps)


def _pred_step(params: dict, sym: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor):
    """One prediction-network LSTM step on label ids sym (N,): the sums in
    JAX's order, ``(x @ W + b) + h @ U``, then its gate step."""
    x = embed_labels(params, sym)
    pre = (torch.matmul(x, params["pred_lstm.W"]) + params["pred_lstm.b"]
           + torch.matmul(h, params["pred_lstm.U"]))
    return xla_gate_step(c, pre)


def init_decode_state(params: dict, batch: int, dtype):
    """Empty-history decoder state (h, c, g): the prediction net after
    consuming the start (blank) token."""
    U = params["pred_lstm.U"]
    h0 = torch.zeros(batch, U.shape[0], dtype=dtype, device=U.device)
    h, c = _pred_step(params, torch.zeros(batch, dtype=torch.long,
                                          device=U.device), h0, h0)
    return h, c, linear(params, "joint_pred", h)


def greedy_scan(params: dict, E: torch.Tensor, out_lens: torch.Tensor,
                state, max_label_len: int, max_symbols: int,
                pos_offset=None, global_cap: int | None = None):
    """Resumable greedy search over pre-projected encoder frames.

    E (B, T, J) = linear(joint_enc, enc); out_lens (B,) valid frames; state
    (h, c, g) from ``init_decode_state`` or a previous chunk. Streaming
    only: pos_offset (B,) labels emitted by earlier chunks and global_cap
    the whole stream's cap; emissions stop once pos_offset + pos reaches
    it. -> (labels (B, max_label_len) int32 0-padded, lens (B,) int32,
    state)."""
    B = E.shape[0]
    dev = E.device
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    out = torch.zeros(B, max_label_len, dtype=torch.int32, device=dev)
    step = functools.partial(_greedy_frame, params, max_symbols=max_symbols,
                             pos_offset=pos_offset, global_cap=global_cap)
    h, c, g, pos, out = over_frames(step, (*state, pos, out), E, out_lens)
    return out, pos, (h, c, g)


def _greedy_frame(params: dict, carry, e_t: torch.Tensor,
                  active: torch.Tensor, *, max_symbols: int, pos_offset=None,
                  global_cap: int | None = None):
    """One frame of the greedy search for the batch: carry (h, c, g, pos
    (B,) labels so far, out (B, L) labels), e_t (B, J) the projected
    frame, active (B,) t < out_len -> the next carry."""
    h, c, g, pos, out = carry
    L = out.shape[1]
    slots = torch.arange(L, device=e_t.device)
    for _ in range(max_symbols):
        logits = linear(params, "joint_out",
                        torch.tanh(e_t + g)).float()  # (B, A)
        sym = torch.argmax(logits, dim=-1).to(torch.int32)
        emit = active & (sym != 0) & (pos < L)
        if global_cap is not None:
            emit &= (pos_offset + pos) < global_cap
        h2, c2 = _pred_step(params, sym, h, c)
        keep = emit[:, None]
        h = torch.where(keep, h2, h)
        c = torch.where(keep, c2, c)
        g = torch.where(keep, linear(params, "joint_pred", h2), g)
        out = out + ((slots[None, :] == pos[:, None])
                     * (sym * emit)[:, None]).to(torch.int32)
        pos = pos + emit.to(torch.int32)
        active = emit  # blank or cap stops this frame's expansion
    return h, c, g, pos, out


def over_frames(step, carry: tuple, E: torch.Tensor, out_lens: torch.Tensor):
    """carry = step(carry, E[:, t], t < out_lens) for t = 0 .. T-1 ->
    the last carry (utils/loops.scan_steps: under torch.export one scan
    over the frames, so that the exported program does not grow with T)."""
    T = E.shape[1]
    valid = (torch.arange(T, device=E.device)[:, None]
             < out_lens.to(E.device)[None, :])  # (T, B)
    carry, _ = scan_steps(lambda c, e_t, v_t: (step(c, e_t, v_t), ()), carry,
                          (E.transpose(0, 1), valid))
    return carry


def transducer_greedy_decode(params: dict, enc: torch.Tensor,
                             out_lens: torch.Tensor, cfg: Config,
                             max_label_len: int = 256,
                             max_symbols: int | None = None):
    """Greedy decode of encoder states enc (B, T', De) with valid frame
    counts out_lens (B,) -> (labels (B, max_label_len) int32 0-padded,
    lens (B,) int32)."""
    if max_symbols is None:
        max_symbols = cfg.transducer.max_symbols_per_frame
    E = linear(params, "joint_enc", enc)  # (B, T, J) hoisted out of the loop
    state = init_decode_state(params, enc.shape[0], enc.dtype)
    out, pos, _ = greedy_scan(params, E, out_lens, state, max_label_len,
                              max_symbols)
    return out, pos


def _merge_pool(scores, hashes, lens, alive):
    """Fold duplicate (hash, len) entries of each row's pool (B, N) into
    their first occurrence by logsumexp; later duplicates and dead entries
    get NEG."""
    eq = ((hashes[..., :, None] == hashes[..., None, :])
          & (lens[..., :, None] == lens[..., None, :])
          & alive[..., :, None] & alive[..., None, :])
    idx = torch.arange(scores.shape[-1], device=scores.device)
    first = ~torch.any(eq & (idx[:, None] > idx[None, :]), dim=-1)
    merged = _logsumexp(torch.where(eq, scores[..., None, :], NEG), -1)
    return torch.where(alive & first, merged, NEG)


def _select(scores: torch.Tensor, K: int):
    """``rank_topk`` over the last axis -> (top scores (B, K), the index of
    the candidate each slot selects (B, K))."""
    top, oh = rank_topk(scores, K)
    iota = torch.arange(scores.shape[-1], device=scores.device)
    return top, (oh.long() * iota[:, None]).sum(-2)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, k]] for x (B, N, ...) and idx (B, K)."""
    idx = idx.view(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))


def _hash_step(hashes: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """``hash * _HASH_M + sym + 1`` in int32 with wraparound (as JAX)."""
    v = hashes.long() * _HASH_M + sym.long() + 1
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


_FIELDS = ("labels", "lens", "score", "hash", "h", "c", "g")


def _beam_frame(params, carry, e_t, valid_t, *, K: int, A: int, Lmax: int,
                max_symbols: int):
    """One frame of the beam search for the batch: carry holds (labels
    (B,K,Lmax), lens, score, hash (B,K), h, c (B,K,P), g (B,K,J)); e_t
    (B, J) projected encoder frame; valid_t (B,) t < out_len."""
    B = e_t.shape[0]
    a = dict(zip(_FIELDS, carry))
    # the frame's done pool starts empty (all-dead slots)
    d = {k: torch.zeros_like(v) for k, v in a.items()}
    d["score"] = torch.full_like(a["score"], NEG)

    for j in range(max_symbols + 1):
        logits = linear(params, "joint_out",
                        torch.tanh(e_t[:, None, :] + a["g"])).float()
        lp = torch.log_softmax(logits, dim=-1)  # (B, K, A)
        alive = a["score"] > NEG / 2

        # ---- blank outcomes -> merge into the done pool (2K entries) ------
        b_score = torch.where(alive, a["score"] + lp[..., 0], NEG)
        comb = {k: torch.cat([d[k], a[k]], dim=1) for k in _FIELDS
                if k != "score"}
        comb_score = torch.cat([d["score"], b_score], dim=1)
        merged = _merge_pool(comb_score, comb["hash"], comb["lens"],
                             comb_score > NEG / 2)
        top_s, idx = _select(merged, K)
        d = {k: _take(v, idx) for k, v in comb.items()}
        d["score"] = top_s

        # ---- label outcomes -> next round's actives -----------------------
        if j < max_symbols:
            ext = a["score"][..., None] + lp[..., 1:]  # (B, K, A-1)
            ext = torch.where((alive & (a["lens"] < Lmax))[..., None], ext,
                              NEG)
            e_s, flat = _select(ext.reshape(B, -1), K)
            parent, sym = flat // (A - 1), flat % (A - 1) + 1
            dead = e_s <= NEG / 2
            p = {k: _take(a[k], parent) for k in _FIELDS if k != "score"}
            P = p["h"].shape[-1]
            nh, nc = _pred_step(params, sym.reshape(-1),
                                p["h"].reshape(B * K, P),
                                p["c"].reshape(B * K, P))
            nh, nc = nh.reshape(B, K, P), nc.reshape(B, K, P)
            write = (torch.arange(Lmax, device=e_t.device)
                     == p["lens"][..., None]) & ~dead[..., None]
            a = dict(
                labels=torch.where(write, sym[..., None].to(torch.int32),
                                   p["labels"]),
                lens=p["lens"] + (~dead).to(torch.int32),
                score=e_s,
                hash=_hash_step(p["hash"], sym),
                h=nh, c=nc,
                g=linear(params, "joint_pred", nh),
            )

    # frames past the utterance end leave the beam untouched
    return tuple(
        torch.where(valid_t.view(B, *([1] * (o.dim() - 1))), d[k], o)
        for k, o in zip(_FIELDS, carry))


def _beam_all(params, E, out_lens, state0, *, K, A, Lmax, max_symbols):
    """Beam search over projected encoder frames E (B, T, J). Returns each
    utterance's FULL surviving pool: (labels (B, K, Lmax), lens (B, K),
    score (B, K) log-lik, dead slots ~-1e30)."""
    B = E.shape[0]
    h1, c1, g1 = state0  # (1, P) / (1, J) empty-history state
    dev = E.device
    score = torch.full((B, K), NEG, device=dev)
    score[:, 0] = 0.0  # only slot 0 alive
    carry = (torch.zeros(B, K, Lmax, dtype=torch.int32, device=dev),
             torch.zeros(B, K, dtype=torch.int32, device=dev),
             score,
             torch.zeros(B, K, dtype=torch.int32, device=dev),
             h1.expand(B, K, -1), c1.expand(B, K, -1), g1.expand(B, K, -1))
    step = functools.partial(_beam_frame, params, K=K, A=A, Lmax=Lmax,
                             max_symbols=max_symbols)
    carry = over_frames(step, carry, E, out_lens)
    return carry[0], carry[1], carry[2]


def _beam_one(params, E, out_lens, state0, *, K, A, Lmax, max_symbols):
    """Best-hypothesis beam search (see _beam_all) -> (labels (B, Lmax),
    lens (B,), nll (B,))."""
    labels, lens, score = _beam_all(params, E, out_lens, state0, K=K, A=A,
                                    Lmax=Lmax, max_symbols=max_symbols)
    best = torch.argmax(score, dim=-1)[:, None]
    return (_take(labels, best)[:, 0], _take(lens, best)[:, 0],
            -_take(score, best)[:, 0])


def _beam_args(params, enc, cfg, beam_size, max_label_len, max_symbols):
    if max_symbols is None:
        max_symbols = cfg.transducer.max_symbols_per_frame
    E = linear(params, "joint_enc", enc)  # (B, T, J)
    state0 = init_decode_state(params, 1, enc.dtype)
    return E, state0, dict(K=beam_size, A=params["joint_out.b"].shape[0],
                           Lmax=max_label_len, max_symbols=max_symbols)


def transducer_beam_decode(params: dict, enc: torch.Tensor,
                           out_lens: torch.Tensor, cfg: Config,
                           beam_size: int = 4, max_label_len: int = 256,
                           max_symbols: int | None = None):
    """Batched RNN-T beam search of encoder states enc (B, T', De) ->
    (labels (B, max_label_len) int32 0-padded, lens (B,) int32, nll (B,) =
    -log P of the best history summed over its alignments)."""
    E, state0, kw = _beam_args(params, enc, cfg, beam_size, max_label_len,
                               max_symbols)
    return _beam_one(params, E, out_lens, state0, **kw)


def transducer_beam_nbest(params: dict, enc: torch.Tensor,
                          out_lens: torch.Tensor, cfg: Config,
                          beam_size: int = 4, max_label_len: int = 256,
                          max_symbols: int | None = None):
    """The beam's full n-best pool (what MWER fine-tuning re-scores) ->
    (labels (B, K, max_label_len) int32 0-padded, lens (B, K) int32, score
    (B, K) float32 beam log-lik, dead slots ~-1e30)."""
    E, state0, kw = _beam_args(params, enc, cfg, beam_size, max_label_len,
                               max_symbols)
    return _beam_all(params, E, out_lens, state0, **kw)
