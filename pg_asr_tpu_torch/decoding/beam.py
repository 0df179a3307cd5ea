"""CTC prefix beam search (counterpart of pg_asr_tpu/decoding/beam.py).

State per utterance: K beam slots, each a prefix with its log mass ending
in blank (p_b) and in non-blank (p_nb). Per frame:
  * "stay" candidates keep the prefix: blank moves the total mass to p_b,
    repeating the last symbol moves p_nb to p_nb;
  * "extend" candidates add a non-blank symbol s: from the total mass if s
    differs from the last symbol, else from p_b only (CTC repeat rule);
  * MERGE: an extend that reproduces another slot's prefix folds its mass
    into that slot's stay (the (K, K) relation E[j, k] = "prefix_j is
    prefix_k + last_j") and is killed as a candidate;
  * top-K over [K stays, then the extends row-major] by
    logaddexp(p_b, p_nb), ties toward the LOWER index, as ``lax.top_k``
    breaks them. ``torch.topk`` promises no order among ties, and dead
    candidates tie exactly at NEG, so selection here is a stable
    descending sort (``_top_k``), never ``torch.topk``.

Two implementations, as in the JAX package:
  * ``impl="hash"`` (the default): prefixes are identified by an int32
    rolling hash h' = h * 1000003 + (s + 1) that wraps; each frame records
    (parent, symbol) backpointers and the prefixes are rebuilt after the
    scan by one reverse walk. Extends are restricted to the frame's top-M
    symbols (M = K + 2 is exact; ``prune`` caps it lower).
    On a CUDA tensor (and ``use_kernel``) the whole scan, and the
    backtrack, run in one hand-written kernel (``cuda_beam``,
    ``csrc/ctc_beam.cu``); on a CPU tensor, or with ``use_kernel=False``,
    the plain PyTorch version below (``ctc_beam_plain``: ``_scan_hash`` +
    the backtrack), which is also the kernel's reference. Both go through
    the registered op ``pgasr::ctc_beam`` (ops/registry.py), which picks
    by the tensor's device and which torch.export keeps as one node;
    ``use_kernel=False`` calls ``ctc_beam_plain`` directly.
  * ``impl="buffer"``: the structural oracle carrying (K, Lmax) prefix
    buffers and comparing them; always plain.

logaddexp is ``max + log1p(exp(min - max))``, saturating to NEG where both
arguments lie below NEG/2 (the Pallas kernel's form; the CUDA kernel
computes the same). On finite arguments it is jnp.logaddexp's formula, so
the plain version matches the JAX hash scan to an ulp per operation.

The JAX functions are per utterance under ``vmap``; here the batch axis is
written out: every state tensor leads with B, backpointers are time-major
(T, B, K) as the Pallas kernel writes them.

Shallow fusion (``lm=`` an n-gram table of decoding/lm.py, or
``neural_lm=`` the LSTM LM of decoding/neural_lm.py; hash impl only):
candidates rank by acoustic + lm_weight * log P_lm + length_bonus * len
while the carried (p_b, p_nb) stay acoustic, and the extends run over the
whole vocabulary (the top-M dominance argument holds for the acoustic key
only), so ``prune`` does not apply and the search never goes to the
kernel, which has no LM term. It is plain PyTorch on any device
(``_scan_hash_lm``), as the JAX package's is XLA; ``_step_lm_buffer`` is
its prefix-buffer form, which streams (serving.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import registry  # noqa: F401  (defines torch.ops.pgasr)
from .neural_lm import lm_advance, lm_init_state, lm_next_logp

NEG = -1.0e30
# above this candidate count rank_topk's O(C^2) compare costs more than the
# sort it replaces (pg_asr_tpu/decoding/beam.py _RANK_TOPK_MAX_C)
_RANK_TOPK_MAX_C = 1024
_HASH_M = 1000003
# hashes are held as int64 in [0, 2^32): h * _HASH_M + s < 2^53 never
# overflows, and masking to 32 bits gives the int32 wraparound's bits
_MASK32 = 0xFFFFFFFF


def _lae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mx = torch.maximum(a, b)
    out = mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))
    return out.masked_fill(mx <= NEG / 2, NEG)


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """max + log(sum(exp(x - max))) as jax.nn.logsumexp (x finite)."""
    m = x.amax(dim, keepdim=True)
    out = m + torch.log(torch.exp(x - m).sum(dim, keepdim=True))
    return out.squeeze(dim)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties toward the lower
    index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rank_topk(scores: torch.Tensor, K: int):
    """Exact top-K as a one-hot matrix, with ``lax.top_k``'s order
    (descending, ties toward the lower index): scores (..., C) ->
    (top_scores (..., K), oh (..., C, K) bool), oh[c, j] true iff
    candidate c is the j-th best. rank[c] = #{c': s_c' > s_c} +
    #{c' < c: s_c' == s_c} is a permutation of 0..C-1. Above
    _RANK_TOPK_MAX_C candidates the selection is a stable sort instead."""
    C = scores.shape[-1]
    iota = torch.arange(C, device=scores.device)
    if C > _RANK_TOPK_MAX_C:
        top_scores, top_idx = _top_k(scores, K)
        return top_scores, iota[:, None] == top_idx[..., None, :]
    other, own = scores[..., None, :], scores[..., :, None]
    beats = (other > own) | ((other == own) & (iota[None, :] < iota[:, None]))
    rank = beats.sum(-1)
    oh = rank[..., :, None] == torch.arange(K, device=scores.device)
    top_scores = (oh.to(scores.dtype) * scores[..., :, None]).sum(-2)
    return top_scores, oh


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] for (B, N) x and (B, I) idx."""
    return torch.gather(x, 1, idx.long())


def _extends(sym, sym_lp, last, lens, p_b, total, valid, *, Lmax: int,
             blank: int) -> torch.Tensor:
    """Extend candidates (B, K, M): slot k + the symbol sym[..., m] of
    log-prob sym_lp[..., m], from p_b where the symbol repeats the slot's
    last (the CTC repeat rule) and from the total otherwise; blank, dead
    slots and full prefixes NEG."""
    src = torch.where(sym == last[..., None], p_b[..., None],
                      total[..., None])
    ext = src + sym_lp
    ext = torch.where(sym == blank, NEG, ext)
    ext = torch.where(valid[..., None], ext, NEG)
    return torch.where((lens >= Lmax)[..., None], NEG, ext)


def _hash_merge(h, last, lens, valid, p_b, total, lp_last, stay_pnb):
    """Extends that reproduce another slot's prefix fold their mass into
    that slot's stay: E[b, j, k] = prefix_j == prefix_k + (last_j,), by
    hash; the mass of extend (k, last_j) is p_b_k where last_j == last_k,
    else the total. -> (E, stay_pnb with the merged mass)."""
    h_ext = (h[:, None, :] * _HASH_M
             + (last.clamp(min=0) + 1)[:, :, None]) & _MASK32      # (B, j, k)
    E = ((h[:, :, None] == h_ext)
         & (lens[:, :, None] == lens[:, None, :] + 1)
         & valid[:, :, None] & valid[:, None, :] & (last[:, :, None] >= 0))
    C_src = torch.where(last[:, :, None] == last[:, None, :], p_b[:, None, :],
                        total[:, None, :])
    C = torch.where(E, C_src + lp_last[:, :, None], NEG)
    merged = torch.where(E.any(-1), _logsumexp(C, -1), NEG)
    return E, _lae(stay_pnb, merged.clamp(min=NEG))


# ---------------------------------------------------------------------------
# impl="buffer": explicit (K, Lmax) prefix buffers (the structural oracle)
# ---------------------------------------------------------------------------


def _step(state, lp, *, K: int, A: int, Lmax: int, blank: int):
    """One frame for the batch. state: (prefixes (B, K, Lmax), lens (B, K),
    p_b (B, K), p_nb (B, K)); lp (B, A)."""
    prefixes, lens, p_b, p_nb = state
    B = lp.shape[0]
    total = _lae(p_b, p_nb)
    valid = total > NEG / 2
    at_last = torch.gather(prefixes, 2, (lens - 1).clamp(min=0)[..., None]
                           .long())[..., 0]
    last = torch.where(lens > 0, at_last, -1)

    stay_pb = torch.where(valid, total + lp[:, blank, None], NEG)
    stay_pnb = torch.where(valid & (last >= 0),
                           p_nb + _take(lp, last.clamp(min=0)), NEG)

    syms = torch.arange(A, device=lp.device)
    ext = _extends(syms, lp[:, None, :], last, lens, p_b, total, valid,
                   Lmax=Lmax, blank=blank)                         # (B, K, A)

    # E[b, j, k] = prefix_j == prefix_k + (last_j,)
    pos = torch.arange(Lmax, device=lp.device)
    eq = prefixes[:, :, None, :] == prefixes[:, None, :, :]        # (B,K,K,L)
    keep = pos < lens[:, None, :, None]                            # k's length
    shares_stem = (eq | ~keep).all(-1)
    E = ((lens[:, :, None] == lens[:, None, :] + 1) & shares_stem
         & valid[:, :, None] & valid[:, None, :] & (last[:, :, None] >= 0))
    # mass of extend (k, last_j) flowing into stay j: C[b, j, k]
    ext_at_last = torch.gather(
        ext, 2, last.clamp(min=0)[:, None, :].expand(B, K, K).long())
    C = torch.where(E, ext_at_last.transpose(1, 2), NEG)
    merged = torch.where(E.any(-1), _logsumexp(C, -1), NEG)
    stay_pnb = _lae(stay_pnb, merged.clamp(min=NEG))
    onehot_last = (syms == last[..., None]) & (last >= 0)[..., None]
    kill = (E.transpose(1, 2).float() @ onehot_last.float()) > 0  # (B, K, A)
    ext = torch.where(kill, NEG, ext)

    cand_pb = torch.cat([stay_pb, torch.full((B, K * A), NEG,
                                             device=lp.device)], 1)
    cand_pnb = torch.cat([stay_pnb, ext.reshape(B, K * A)], 1)
    top_scores, top_idx = _top_k(_lae(cand_pb, cand_pnb), K)
    is_stay = top_idx < K
    parent = torch.where(is_stay, top_idx, (top_idx - K) // A)
    sym = torch.where(is_stay, 0, (top_idx - K) % A)

    new_prefixes = torch.gather(prefixes, 1,
                                parent[..., None].expand(B, K, Lmax))
    new_lens = _take(lens, parent)
    ext_mask = (~is_stay)[..., None] & (pos == new_lens[..., None])
    new_prefixes = torch.where(ext_mask, sym[..., None].to(prefixes.dtype),
                               new_prefixes)
    new_lens = new_lens + (~is_stay).to(lens.dtype)
    new_pb = _take(cand_pb, top_idx)
    new_pnb = _take(cand_pnb, top_idx)
    dead = top_scores <= NEG / 2
    return (new_prefixes.masked_fill(dead[..., None], 0),
            new_lens.masked_fill(dead, 0), new_pb.masked_fill(dead, NEG),
            new_pnb.masked_fill(dead, NEG))


def _decode_one(log_probs, frame_lens, *, K: int, A: int, Lmax: int,
                blank: int):
    """(B, T, A) log-probs -> (best prefixes (B, Lmax), lens (B,), nll
    (B,)), the buffer search over the batch; frames t >= frame_len leave
    the state as it was."""
    B, T, _ = log_probs.shape
    dev = log_probs.device
    state = (torch.zeros(B, K, Lmax, dtype=torch.int32, device=dev),
             torch.zeros(B, K, dtype=torch.int32, device=dev),
             _init_pb(B, K, dev), torch.full((B, K), NEG, device=dev))
    for t in range(T):
        new = _step(state, log_probs[:, t], K=K, A=A, Lmax=Lmax, blank=blank)
        active = (t < frame_lens)[:, None]
        state = tuple(torch.where(active[..., None] if n.dim() == 3
                                  else active, n, o)
                      for n, o in zip(new, state))
    prefixes, lens, p_b, p_nb = state
    scores = _lae(p_b, p_nb)
    best = torch.argmax(scores, dim=1, keepdim=True)  # first max, as jnp
    labels = torch.gather(prefixes, 1, best[..., None].expand(B, 1, Lmax))
    return labels[:, 0], _take(lens, best)[:, 0], -_take(scores, best)[:, 0]


def _init_pb(B: int, K: int, device) -> torch.Tensor:
    p_b = torch.full((B, K), NEG, device=device)
    p_b[:, 0] = 0.0  # slot 0 holds the empty prefix
    return p_b


# ---------------------------------------------------------------------------
# impl="hash": rolling-hash prefix identity + backpointers. _scan_hash is
# the plain version of csrc/ctc_beam.cu.
# ---------------------------------------------------------------------------


def _prune_m(A: int, K: int, prune: int | None) -> int:
    """Per-frame symbol cap: K + 2 keeps the search exact
    (pg_asr_tpu/decoding/beam.py _step_hash gives the argument)."""
    return min(A, K + 2) if prune is None else max(2, min(A, prune))


def _step_hash(state, lp, top_lp, top_sym, *, K: int, M: int, Lmax: int,
               blank: int):
    """One frame for the batch, carrying (hash, last, lens, p_b, p_nb), all
    (B, K). lp (B, A); top_lp / top_sym (B, M) the frame's top-M symbols.
    Returns (new_state, (parent (B, K), sym (B, K), -1 = stay))."""
    h, last, lens, p_b, p_nb = state
    B = lp.shape[0]
    total = _lae(p_b, p_nb)
    valid = total > NEG / 2
    lp_last = _take(lp, last.clamp(min=0))

    stay_pb = torch.where(valid, total + lp[:, blank, None], NEG)
    stay_pnb = torch.where(valid & (last >= 0), p_nb + lp_last, NEG)

    ext = _extends(top_sym[:, None, :], top_lp[:, None, :], last, lens, p_b,
                   total, valid, Lmax=Lmax, blank=blank)           # (B, K, M)
    E, stay_pnb = _hash_merge(h, last, lens, valid, p_b, total, lp_last,
                              stay_pnb)
    # kill[b, k, r] = exists j: E[b, j, k] & last_j == top_sym[r]
    kill = (E[..., None] & (last[:, :, None, None]
                            == top_sym[:, None, None, :])).any(1)
    ext = torch.where(kill, NEG, ext)

    scores = torch.cat([_lae(stay_pb, stay_pnb), ext.reshape(B, K * M)], 1)
    top_scores, top_idx = _top_k(scores, K)
    is_stay = top_idx < K
    parent = torch.where(is_stay, top_idx, (top_idx - K) // M)
    r = torch.where(is_stay, 0, (top_idx - K) % M)
    sym = torch.where(is_stay, -1, _take(top_sym, r))

    par_h = _take(h, parent)
    new_h = torch.where(is_stay, par_h,
                        (par_h * _HASH_M + (sym.clamp(min=0) + 1)) & _MASK32)
    new_last = torch.where(is_stay, _take(last, parent), sym)
    new_lens = _take(lens, parent) + (~is_stay).to(lens.dtype)
    new_pb = torch.where(is_stay, _take(stay_pb, parent), NEG)
    new_pnb = torch.where(is_stay, _take(stay_pnb, parent), top_scores)
    dead = top_scores <= NEG / 2
    new_state = (new_h.masked_fill(dead, 0), new_last.masked_fill(dead, -1),
                 new_lens.masked_fill(dead, 0), new_pb.masked_fill(dead, NEG),
                 new_pnb.masked_fill(dead, NEG))
    return new_state, (parent, sym)


def _scan_hash(log_probs, frame_lens, *, K: int, A: int, Lmax: int,
               blank: int, prune: int | None = None, M: int | None = None):
    """Plain PyTorch version of the beam kernel: (B, T, A) float32
    log-probs, (B,) frame lengths -> final (lens (B, K) int32, scores (B, K)
    float32) and the backpointers (parents, syms), each (T, B, K) int32.
    Frames t >= frame_len keep the state and record identity parents with
    sym -1. M, the top-M symbols a frame, as the kernel takes it; by
    default ``_prune_m(A, K, prune)``."""
    B, T, _ = log_probs.shape
    dev = log_probs.device
    if M is None:
        M = _prune_m(A, K, prune)
    top_lp, top_sym = _top_k(log_probs, M)                         # (B, T, M)
    state = (torch.zeros(B, K, dtype=torch.int64, device=dev),
             torch.full((B, K), -1, dtype=torch.int64, device=dev),
             torch.zeros(B, K, dtype=torch.int64, device=dev),
             _init_pb(B, K, dev), torch.full((B, K), NEG, device=dev))
    idk = torch.arange(K, device=dev).expand(B, K)
    parents = torch.empty(T, B, K, dtype=torch.int32, device=dev)
    syms = torch.empty(T, B, K, dtype=torch.int32, device=dev)
    frame_lens = frame_lens.to(dev)
    for t in range(T):
        new, (parent, sym) = _step_hash(state, log_probs[:, t], top_lp[:, t],
                                        top_sym[:, t], K=K, M=M, Lmax=Lmax,
                                        blank=blank)
        active = (t < frame_lens)[:, None]
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
        parents[t] = torch.where(active, parent, idk)
        syms[t] = torch.where(active, sym, -1)
    _, _, lens, p_b, p_nb = state
    return lens.to(torch.int32), _lae(p_b, p_nb), parents, syms


def _backtrack(slots, parents, syms, Lmax: int) -> torch.Tensor:
    """Walk t = T-1 .. 0 from slots (B, N) through (T, B, K) backpointers
    and compact the emitted symbols (sym >= 0) into (B, N, Lmax) 0-padded
    rows; emissions past Lmax are dropped."""
    T = parents.shape[0]
    B, N = slots.shape
    emitted = torch.empty(B, N, T, dtype=torch.int64, device=slots.device)
    slot = slots.long()
    for t in range(T - 1, -1, -1):
        emitted[:, :, t] = _take(syms[t], slot)
        slot = _take(parents[t], slot)
    is_sym = emitted >= 0
    pos = torch.cumsum(is_sym, dim=2) - 1
    pos = torch.where(is_sym & (pos < Lmax), pos, Lmax)  # Lmax: overflow slot
    out = torch.zeros(B, N, Lmax + 1, dtype=torch.int64, device=slots.device)
    out.scatter_(2, pos, emitted.clamp(min=0))
    return out[..., :Lmax].to(torch.int32)


def _backtrack_slot(slot: int, parents, syms, Lmax: int) -> torch.Tensor:
    """One utterance's slot from its (T, K) backpointers -> (Lmax,)."""
    slots = torch.tensor([[slot]], device=parents.device)
    return _backtrack(slots, parents[:, None], syms[:, None], Lmax)[0, 0]


def ctc_beam_plain(log_probs: torch.Tensor, frame_lens: torch.Tensor,
                   K: int, M: int, Lmax: int, blank: int = 0,
                   nbest: bool = False):
    """Plain PyTorch version of what one ctc_beam launch returns
    (cuda_beam.ctc_beam_cuda's labels, nb_lens and nll), on any device:
    (B, T, A) float32 log-probs, (B,) int32 frame lengths -> labels (B, NB,
    Lmax) int32, lens (B, NB) int32, nll (B, NB) float32; NB = 1, the best
    slot, or K with ``nbest``, by score descending (ties in slot order)."""
    A = log_probs.shape[-1]
    lens_k, scores, parents, syms = _scan_hash(log_probs, frame_lens, K=K,
                                               A=A, Lmax=Lmax, blank=blank,
                                               M=M)
    if not nbest:
        labels, lens, nll = _backtrack_batch(parents, syms, lens_k, scores,
                                             Lmax)
        return labels[:, None], lens[:, None], nll[:, None]
    order = torch.argsort(-scores, dim=1, stable=True)
    return (_backtrack(order, parents, syms, Lmax), _take(lens_k, order),
            -_take(scores, order))


def _backtrack_batch(parents, syms, lens, scores, Lmax: int):
    """(T, B, K) backpointers, (B, K) lens and scores -> the best slot's
    (labels (B, Lmax) int32, lens (B,) int32, nll (B,) float32)."""
    best = torch.argmax(scores, dim=1, keepdim=True)  # first max, as jnp
    labels = _backtrack(best, parents, syms, Lmax)[:, 0]
    return labels, _take(lens, best)[:, 0], -_take(scores, best)[:, 0]


# ---------------------------------------------------------------------------
# LM shallow fusion (impl="hash"): pg_asr_tpu/decoding/beam.py
# _step_hash_lm, _step_lm_buffer, lm_context_scores, _decode_one_hash_lm and
# _decode_one_hash_nlm, batched. Plain PyTorch on every device.
# ---------------------------------------------------------------------------


def fused_score(ac, lm, length, lam: float, beta: float) -> torch.Tensor:
    """The fused ranking key ac + lam * lm + beta * length in float32, the
    one place the port computes it (the fused search, its best slot and
    rescoring). The JAX package's CPU build contracts the expression into
    two fused multiply-adds, each rounding the exact sum once to float32;
    here each sum is taken in float64 (the products of float32 values are
    exact there) and then rounded to float32, which matches except in rare
    double-rounding cases. lam and beta come from
    ``fusion_coefficients``."""
    f = (ac.double() + lam * lm.double()).float()
    return (f.double() + beta * length.double()).float()


def fusion_coefficients(lm_weight, length_bonus) -> tuple[float, float]:
    """(lam, beta) for ``fused_score``: lm_weight and length_bonus rounded
    to float32, as the JAX package passes them."""
    return float(np.float32(lm_weight)), float(np.float32(length_bonus))


def lm_context_scores(lm_tab: torch.Tensor, last: torch.Tensor,
                      last2: torch.Tensor) -> torch.Tensor:
    """(..., A) log P_lm(next | context) rows of an n-gram table for the
    carried beam contexts (ctx = max(last, 0); row / plane 0 is BOS, which
    the blank id 0 doubles as). A row gather: the JAX package's one-hot
    product has one nonzero term, and the table is finite, so its bits are
    the row's."""
    A = lm_tab.shape[-1]
    ctx = last.clamp(min=0)
    if lm_tab.dim() == 3:
        ctx = last2.clamp(min=0) * A + ctx
    return lm_tab.reshape(-1, A)[ctx.long()]


def _step_hash_lm(state, lp, lmn, *, K: int, A: int, Lmax: int, blank: int,
                  lam: float, beta: float):
    """One LM-fused frame for the batch, carrying (hash, last, last2, lens,
    p_b, p_nb, lm), all (B, K); lp (B, A); lmn (B, K, A) log P_lm(symbol |
    beam context). Candidates rank by ``fused_score``; the carried masses
    stay acoustic, and an extend that reproduces another slot's prefix
    merges into it as in ``_step_hash`` (the LM's product decomposition
    gives both the same LM score). -> (new_state, (parent, sym))."""
    h, last, last2, lens, p_b, p_nb, lm = state
    B = lp.shape[0]
    total = _lae(p_b, p_nb)
    valid = total > NEG / 2
    lp_last = _take(lp, last.clamp(min=0))

    stay_pb = torch.where(valid, total + lp[:, blank, None], NEG)
    stay_pnb = torch.where(valid & (last >= 0), p_nb + lp_last, NEG)

    syms = torch.arange(A, device=lp.device)
    ext = _extends(syms, lp[:, None, :], last, lens, p_b, total, valid,
                   Lmax=Lmax, blank=blank)                         # (B, K, A)
    E, stay_pnb = _hash_merge(h, last, lens, valid, p_b, total, lp_last,
                              stay_pnb)
    # kill[b, k, s] = exists j: E[b, j, k] & last_j == s, as _step's
    onehot_last = (syms == last[..., None]) & (last >= 0)[..., None]
    kill = (E.transpose(1, 2).float() @ onehot_last.float()) > 0  # (B, K, A)
    ext = torch.where(kill, NEG, ext)

    # top-K by the fused key over K stays + K*A extends
    cand_ac = torch.cat([_lae(stay_pb, stay_pnb), ext.reshape(B, K * A)], 1)
    cand_lm = torch.cat([lm, (lm[..., None] + lmn).reshape(B, K * A)], 1)
    cand_len = torch.cat([lens, (lens + 1)[..., None].expand(B, K, A)
                          .reshape(B, K * A)], 1)
    fused = fused_score(cand_ac, cand_lm, cand_len, lam, beta)
    fused = torch.where(cand_ac <= NEG / 2, NEG, fused)
    _, top_idx = _top_k(fused, K)
    is_stay = top_idx < K
    parent = torch.where(is_stay, top_idx, (top_idx - K) // A)
    sym = torch.where(is_stay, -1, (top_idx - K) % A)
    # the selected masses: the JAX package's one-hot products have one
    # nonzero term each, so they are these gathers' bits
    ac_sel = _take(cand_ac, top_idx)
    lm_sel = _take(cand_lm, top_idx)

    par_h = _take(h, parent)
    new_h = torch.where(is_stay, par_h,
                        (par_h * _HASH_M + (sym.clamp(min=0) + 1)) & _MASK32)
    par_last = _take(last, parent)
    new_last = torch.where(is_stay, par_last, sym)
    new_last2 = torch.where(is_stay, _take(last2, parent), par_last)
    new_lens = _take(lens, parent) + (~is_stay).to(lens.dtype)
    new_pb = torch.where(is_stay, _take(stay_pb, parent), NEG)
    new_pnb = torch.where(is_stay, _take(stay_pnb, parent), ac_sel)
    dead = ac_sel <= NEG / 2
    new_state = (new_h.masked_fill(dead, 0), new_last.masked_fill(dead, -1),
                 new_last2.masked_fill(dead, -1), new_lens.masked_fill(dead, 0),
                 new_pb.masked_fill(dead, NEG), new_pnb.masked_fill(dead, NEG),
                 lm_sel.masked_fill(dead, 0.0))
    return new_state, (parent, sym)


def _lm_state0(B: int, K: int, device):
    """The empty LM-fused beam: (hash, last, last2, lens, p_b, p_nb, lm)."""
    def full(v, dtype=torch.int64):
        return torch.full((B, K), v, dtype=dtype, device=device)

    return (full(0), full(-1), full(-1), full(0), _init_pb(B, K, device),
            full(NEG, torch.float32), full(0.0, torch.float32))


def _step_lm_buffer(state, lp, lmn, *, K: int, A: int, Lmax: int,
                    blank: int, lam: float, beta: float):
    """``_step_hash_lm`` carrying the (B, K, Lmax) prefix buffers in place of
    backpointer records (which grow with T and cannot stream): the streamed
    LM beam's step (serving.py). state: (prefixes (B, K, Lmax), hash, last,
    last2, lens, p_b, p_nb, lm)."""
    prefixes = state[0]
    new, (parent, sym) = _step_hash_lm(state[1:], lp, lmn, K=K, A=A,
                                       Lmax=Lmax, blank=blank, lam=lam,
                                       beta=beta)
    B = lp.shape[0]
    new_prefixes = torch.gather(prefixes, 1,
                                parent[..., None].expand(B, K, Lmax))
    old_lens = _take(state[4], parent)
    pos = torch.arange(Lmax, device=lp.device)
    write = (pos == old_lens[..., None]) & (sym >= 0)[..., None]
    new_prefixes = torch.where(write, sym.clamp(min=0)[..., None].to(
        prefixes.dtype), new_prefixes)
    new_prefixes = new_prefixes.masked_fill((new[3] == 0)[..., None], 0)
    return (new_prefixes, *new)


def _scan_hash_lm(log_probs, frame_lens, lam: float, beta: float, *, K: int,
                  A: int, Lmax: int, blank: int, lm_tab=None, nlm=None):
    """The LM-fused hash scan over the batch, an n-gram table `lm_tab` or an
    LSTM LM `nlm`: (B, T, A) float32 log-probs -> final state and the (T, B,
    K) backpointers. Under the neural LM each slot carries its LM state
    (consumed [BOS, prefix...]); after selection the states follow their
    parents and the extended slots advance by their symbol. Frames t >=
    frame_len keep every state and record identity parents."""
    B, T, _ = log_probs.shape
    dev = log_probs.device
    state = _lm_state0(B, K, dev)
    if nlm is not None:
        lm_state = lm_init_state(nlm, B * K)
        Lyr, _, _, H = lm_state.shape
        lm_state = lm_state.view(Lyr, 2, B, K, H)
    idk = torch.arange(K, device=dev).expand(B, K)
    parents = torch.empty(T, B, K, dtype=torch.int32, device=dev)
    syms = torch.empty(T, B, K, dtype=torch.int32, device=dev)
    frame_lens = frame_lens.to(dev)
    for t in range(T):
        if nlm is None:
            lmn = lm_context_scores(lm_tab, state[1], state[2])
        else:
            lmn = lm_next_logp(nlm, lm_state.view(Lyr, 2, B * K, H)).view(
                B, K, A)
        new, (parent, sym) = _step_hash_lm(state, log_probs[:, t], lmn, K=K,
                                           A=A, Lmax=Lmax, blank=blank,
                                           lam=lam, beta=beta)
        active = (t < frame_lens)[:, None]
        state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
        if nlm is not None:
            sel = torch.gather(lm_state, 3, parent[None, None, :, :, None]
                               .expand(Lyr, 2, B, K, H))
            adv = lm_advance(nlm, sel.view(Lyr, 2, B * K, H),
                             sym.clamp(min=0).view(-1)).view(Lyr, 2, B, K, H)
            moved = torch.where((sym >= 0)[:, :, None], adv, sel)
            lm_state = torch.where(active[:, :, None], moved, lm_state)
        parents[t] = torch.where(active, parent, idk)
        syms[t] = torch.where(active, sym, -1)
    return state, parents, syms


def _decode_hash_lm(log_probs, frame_lens, lam: float, beta: float, *,
                    K: int, A: int, Lmax: int, blank: int, lm_tab=None,
                    nlm=None):
    """The fused search's best slot by the fused key -> (labels (B, Lmax),
    lens (B,), nll (B,) = the negative fused score)."""
    state, parents, syms = _scan_hash_lm(log_probs, frame_lens, lam, beta,
                                         K=K, A=A, Lmax=Lmax, blank=blank,
                                         lm_tab=lm_tab, nlm=nlm)
    _, _, _, lens, p_b, p_nb, lm = state
    ac = _lae(p_b, p_nb)
    fused = torch.where(ac <= NEG / 2, NEG,
                        fused_score(ac, lm, lens, lam, beta))
    return _backtrack_batch(parents, syms, lens.to(torch.int32), fused, Lmax)


def _pad_labels(labels: torch.Tensor, max_label_len: int) -> torch.Tensor:
    Lmax = labels.shape[-1]
    if Lmax < max_label_len:
        labels = torch.nn.functional.pad(labels, (0, max_label_len - Lmax))
    return labels


def beam_decode(log_probs: torch.Tensor, frame_lens: torch.Tensor,
                beam_size: int = 16, max_label_len: int = 256,
                blank: int = 0, impl: str | None = None,
                prune: int | None = None, lm=None, neural_lm=None,
                lm_weight: float = 0.3, length_bonus: float = 0.0,
                use_kernel: bool = True):
    """Batched CTC prefix beam search.

    log_probs (B, T, A), any float type (searched in float32); frame_lens
    (B,). impl: "hash" (default; the kernel on CUDA tensors unless
    ``use_kernel`` is False) or "buffer" (the oracle, plain). prune: the
    hash impl's per-frame top-M symbol cap; None keeps the exact M = K + 2.
    lm: an (A, A) bigram or (A, A, A) trigram log-prob table
    (decoding/lm.py; numpy or a tensor) and neural_lm: LSTM LM parameters
    (decoding/neural_lm.py), one or neither, each moved to log_probs'
    device: shallow fusion with lm_weight and length_bonus, whose nll is
    the negative fused score of the best (the JAX package's rules; no
    kernel, and no ``prune``).
    Returns labels (B, max_label_len) int32 best prefixes (0-padded), lens
    (B,) int32 and nll (B,) float32."""
    impl = impl or "hash"
    if neural_lm is not None:
        if lm is not None:
            raise ValueError("pass either lm (n-gram table) or neural_lm, "
                             "not both")
        if impl != "hash":
            raise ValueError("neural-LM shallow fusion requires impl='hash' "
                             f"(got {impl!r})")
    if lm is not None and impl != "hash":
        raise ValueError("LM shallow fusion requires impl='hash' "
                         f"(got {impl!r})")
    if impl not in ("hash", "buffer"):
        raise ValueError(f"unknown beam impl {impl!r} (hash or buffer)")
    B, T, A = log_probs.shape
    Lmax = min(max_label_len, T)
    K = beam_size
    lp = log_probs.to(torch.float32).contiguous()
    fl = frame_lens.to(device=lp.device, dtype=torch.int32).contiguous()
    if lm is not None or neural_lm is not None:
        lam, beta = fusion_coefficients(lm_weight, length_bonus)
        tab = (None if lm is None else torch.as_tensor(
            lm, dtype=torch.float32, device=lp.device))
        nlm = (None if neural_lm is None else
               {k: v.to(device=lp.device, dtype=torch.float32)
                for k, v in neural_lm.items()})
        labels, lens, nll = _decode_hash_lm(lp, fl, lam, beta, K=K, A=A,
                                            Lmax=Lmax, blank=blank,
                                            lm_tab=tab, nlm=nlm)
    elif impl == "buffer":
        labels, lens, nll = _decode_one(lp, fl, K=K, A=A, Lmax=Lmax,
                                        blank=blank)
    else:
        # pgasr::ctc_beam: the kernel on a CUDA tensor, ctc_beam_plain on a
        # CPU one; use_kernel=False calls ctc_beam_plain directly
        op = torch.ops.pgasr.ctc_beam if use_kernel else ctc_beam_plain
        labels, lens, nll = (t[:, 0] for t in op(
            lp, fl, K, _prune_m(A, K, prune), Lmax, blank, False))
    return _pad_labels(labels, max_label_len), lens, nll


def beam_decode_nbest(log_probs: torch.Tensor, frame_lens: torch.Tensor,
                      beam_size: int = 8, max_label_len: int = 256,
                      blank: int = 0, use_kernel: bool = True):
    """Batched K-best CTC prefix beam search (hash impl, exact search).

    Returns labels (B, K, max_label_len) int32 (slot 0 the best, equal to
    beam_decode's), lens (B, K) int32 and nll (B, K) float32 ascending
    (ties keep slot order); dead slots carry nll ~ +1e30."""
    B, T, A = log_probs.shape
    Lmax = min(max_label_len, T)
    K = beam_size
    lp = log_probs.to(torch.float32).contiguous()
    fl = frame_lens.to(device=lp.device, dtype=torch.int32).contiguous()
    op = torch.ops.pgasr.ctc_beam if use_kernel else ctc_beam_plain
    labels, lens, nll = op(lp, fl, K, _prune_m(A, K, None), Lmax, blank, True)
    return _pad_labels(labels, max_label_len), lens, nll
