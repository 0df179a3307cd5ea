"""Character (or BPE-unit) n-gram language models for shallow fusion in the
CTC prefix beam (counterpart of pg_asr_tpu/decoding/lm.py; numpy, the
port's own copy):

    score(prefix) = log P_ctc(prefix) + lm_weight * log P_lm(prefix)
                    + length_bonus * |prefix|

The table is trained from the training transcripts (add-k smoothed counts,
no external data) and is dense, so the beam scores every (beam, symbol)
extension from one row per beam (``decoding/beam.lm_context_scores``).

Layout: index 0 is BOS (the blank/pad id never occurs inside a label
prefix, so slot 0 is free to mean "no symbol yet").
  order 2 -> (A, A):     table[prev,         next]
  order 3 -> (A, A, A):  table[prev2, prev1, next]  (prev2 = 0 until
                                                      len >= 2)
Column 0 (next = blank) is NEG_LM: extensions are never blank.
"""

from __future__ import annotations

import numpy as np

NEG_LM = -1.0e30


def train_char_ngram(texts, alphabet, order: int = 2,
                     add_k: float = 1.0) -> np.ndarray:
    """Add-k smoothed n-gram of the transcripts `texts` over `alphabet`'s
    units (index 0 = pad/blank = the BOS slot). order: 2 or 3; add_k: the
    smoothing mass per (context, symbol) cell. -> float32 log-prob table,
    (A, A) for order 2 or (A, A, A) for order 3."""
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, got {order}")
    A = alphabet.size
    counts = np.zeros((A,) * order, np.float64)
    for text in texts:
        ctx = [0] * (order - 1)
        for s in alphabet.encode(text):
            counts[tuple(ctx) + (int(s),)] += 1.0
            ctx = ctx[1:] + [int(s)]
    smoothed = counts[..., 1:] + add_k  # never predict blank
    logp = np.log(smoothed / smoothed.sum(axis=-1, keepdims=True))
    table = np.full(counts.shape, NEG_LM, np.float64)
    table[..., 1:] = logp
    return table.astype(np.float32)


def lm_from_manifest(manifest, alphabet, order: int = 2,
                     add_k: float = 1.0) -> np.ndarray:
    """``train_char_ngram`` over a loaded manifest's ``.text``s."""
    return train_char_ngram((u.text for u in manifest), alphabet,
                            order=order, add_k=add_k)


def score_prefix(table: np.ndarray, ids) -> float:
    """log P_lm of a whole prefix, on the host (an oracle for tests)."""
    order = table.ndim
    ctx = [0] * (order - 1)
    total = 0.0
    for s in ids:
        total += float(table[tuple(ctx) + (int(s),)])
        ctx = ctx[1:] + [int(s)]
    return total
