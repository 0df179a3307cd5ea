"""Batched Levenshtein distance on the device (counterpart of
pg_asr_tpu/ops/edit_distance.py): the policy-gradient rewards' character
and word error counts, with the JAX package's int32 results bit for bit.

Algorithm: one DP row over the reference per hypothesis position, with the
within-row dependency d[j] = min(h[j], d[j-1] + 1) closed into a prefix min,
d[j] = j + min_{k<=j}(h[k] - k) (``torch.cummin`` along the row). The only
loop is over one sequence's positions: a few small launches each on the
card. ``edit_distance`` walks whichever padded side is shorter (the
distance is symmetric; for the PG rewards that is the reference, ~60
symbols against a collapsed path's width T); ``edit_distance_prefixes``
walks the hypothesis, because it returns ED(ref, hyp[:i]) for every i,
frozen past each row's hyp_len as in the JAX package.

Words (WER): Python's ``split(" ")`` keeps empty segments, so a row of L
chars holds (#spaces) + 1 >= 1 words, empty ones included. Each word is
reduced to the JAX package's int32 rolling hash, h = h * 1_000_003 + sym + 1
per char with wraparound, computed here without a loop over positions: a
word's hash is sum_k (sym_k + 1) * P^(chars after k in the word) mod 2^32,
summed exactly in int64 and read back as two's-complement int32.
"""

from __future__ import annotations

import torch

BIG = 1 << 20  # the JAX module's constant (it defines it, nothing reads it)
_P = 1_000_003  # the word hash's multiplier


def _dp(ref: torch.Tensor, ref_lens: torch.Tensor, hyp: torch.Tensor,
        hyp_lens: torch.Tensor, prefixes: bool):
    """Rows of the DP over hyp positions. ref (B, Lr), hyp (B, Lh) int32;
    lens clamped to the widths (the JAX gather clamps its index). Returns
    (final (B,) int32, per-prefix (B, Lh+1) int32 or None)."""
    B, Lr = ref.shape
    ar = torch.arange(Lr + 1, dtype=torch.int32, device=ref.device)
    ref_lens = ref_lens.long().clamp(0, Lr)
    hyp_lens = hyp_lens.to(torch.int32)
    d = ar.expand(B, Lr + 1)
    rows = [d]
    for i in range(1, hyp.shape[1] + 1):
        cost = (ref != hyp[:, i - 1: i]).to(torch.int32)
        h = torch.cat([torch.full((B, 1), i, dtype=torch.int32,
                                  device=ref.device),
                       torch.minimum(d[:, 1:] + 1, d[:, :-1] + cost)], dim=1)
        new = ar + torch.cummin(h - ar, dim=1).values
        d = torch.where((i <= hyp_lens)[:, None], new, d)  # freeze past len
        if prefixes:
            rows.append(d)
    final = torch.gather(d, 1, ref_lens[:, None])[:, 0]
    if not prefixes:
        return final, None
    all_rows = torch.stack(rows, dim=1)  # (B, Lh+1, Lr+1)
    idx = ref_lens[:, None, None].expand(B, all_rows.shape[1], 1)
    return final, torch.gather(all_rows, 2, idx)[..., 0]


def edit_distance(ref: torch.Tensor, ref_lens: torch.Tensor,
                  hyp: torch.Tensor, hyp_lens: torch.Tensor) -> torch.Tensor:
    """Batched Levenshtein distance between padded id sequences: ref (B, Lr),
    ref_lens (B,), hyp (B, Lh), hyp_lens (B,) -> (B,) int32."""
    ref, hyp = ref.to(torch.int32), hyp.to(torch.int32)
    if hyp.shape[1] > ref.shape[1]:  # walk the shorter side
        ref, ref_lens, hyp, hyp_lens = hyp, hyp_lens, ref, ref_lens
    return _dp(ref, ref_lens, hyp, hyp_lens, prefixes=False)[0]


def edit_distance_prefixes(ref: torch.Tensor, ref_lens: torch.Tensor,
                           hyp: torch.Tensor, hyp_lens: torch.Tensor):
    """(distance (B,), per-prefix distances (B, Lh+1)) in one pass over hyp:
    prefix[:, i] = ED(ref[:ref_len], hyp[:min(i, hyp_len)])."""
    return _dp(ref.to(torch.int32), ref_lens, hyp.to(torch.int32), hyp_lens,
               prefixes=True)


def cer_from_ids(ref, ref_lens, hyp, hyp_lens) -> torch.Tensor:
    """(B,) character error rate = ED / ref_len (reference-length norm)."""
    d = edit_distance(ref, ref_lens, hyp, hyp_lens)
    return d.float() / torch.clamp(ref_lens.float(), min=1.0)


def word_hash_sequences(ids: torch.Tensor, lens: torch.Tensor,
                        space_id: int):
    """Segment padded char-id rows into words at `space_id`.

    ids (B, L) int ids, 0-padded; lens (B,). Returns hashes (B, L+1) int32,
    one rolling hash per word, 0-padded (empty words hash to 0 and still
    count), and counts (B,) int32 (always >= 1, like "".split(" "))."""
    ids = ids.long()
    B, L = ids.shape
    dev = ids.device
    pos = torch.arange(L, device=dev)
    valid = pos[None, :] < lens.long()[:, None]
    is_space = valid & (ids == space_id)
    is_char = valid & ~is_space
    word = torch.cumsum(is_space.long(), dim=1) - is_space.long()  # slot
    # chars after k anywhere in the row, then minus those past k's word end
    after = is_char.long().flip(1).cumsum(1).flip(1) - is_char.long()
    end_after = torch.zeros(B, L + 2, dtype=torch.long, device=dev)
    end_after.scatter_(1, torch.where(is_space, word, L + 1), after)
    end_after[:, L + 1] = 0  # the dump column; a trailing word ends at 0
    power = after - torch.gather(end_after, 1, word)
    mod = 1 << 32
    pw = [1]
    for _ in range(L):
        pw.append(pw[-1] * _P % mod)
    powers = torch.tensor(pw, dtype=torch.long, device=dev)
    terms = torch.where(is_char, (ids + 1) * powers[power] % mod, 0)
    out = torch.zeros(B, L + 1, dtype=torch.long, device=dev)
    out.scatter_add_(1, word, terms)
    out = out % mod
    out = torch.where(out >= 1 << 31, out - mod, out).to(torch.int32)
    return out, (is_space.sum(1) + 1).to(torch.int32)


def word_edit_distance(ref, ref_lens, hyp, hyp_lens, space_id: int):
    """Batched word-level Levenshtein distance between padded char-id rows
    -> (dist (B,) int32, ref word counts (B,) int32)."""
    rh, rw = word_hash_sequences(ref, ref_lens, space_id)
    hh, hw = word_hash_sequences(hyp, hyp_lens, space_id)
    return edit_distance(rh, rw, hh, hw), rw


def wer_from_ids(ref, ref_lens, hyp, hyp_lens, space_id: int) -> torch.Tensor:
    """(B,) word error rate = word-ED / ref word count (counts are >= 1)."""
    d, rw = word_edit_distance(ref, ref_lens, hyp, hyp_lens, space_id)
    return d.float() / rw.float()
