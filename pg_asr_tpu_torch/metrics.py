"""Host-side CER/WER and prediction dumps (counterpart of
pg_asr_tpu/metrics.py, same contract):
  * edit_dist(ref, hyp) -> (Levenshtein distance, len(ref));
  * CER = ED(chars) / len(ref chars), WER = ED(words) / len(ref words),
    words split on single spaces;
  * save_predictions writes "<target>|<predicted>" lines to
    <model_path>/predicted.txt.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def edit_dist(ref: Sequence, hyp: Sequence) -> tuple[int, int]:
    """Levenshtein distance between two sequences -> (distance, len(ref)).
    Accepts str (CER) or list[str] (WER)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m, 0
    if m == 0:
        return n, n
    # two-row DP over hyp; the in-row dependency d[j] = min(h[j], d[j-1]+1)
    # is d[j] = j + min_{k<=j}(h[k] - k)
    ref_arr = np.asarray(list(ref), dtype=object)
    prev = np.arange(n + 1, dtype=np.int64)
    ar = np.arange(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        sub = prev[:-1] + (ref_arr != hyp[i - 1]).astype(np.int64)
        h = np.empty(n + 1, dtype=np.int64)
        h[0] = i
        h[1:] = np.minimum(prev[1:] + 1, sub)
        prev = ar + np.minimum.accumulate(h - ar)
    return int(prev[-1]), n


def evaluate(ref: str, hyp: str) -> tuple[float, float]:
    """(CER, WER) for one utterance, reference-length normalised."""
    d, n = edit_dist(ref, hyp)
    cer = d / n if n else float(d > 0)
    dw, nw = edit_dist(ref.split(" "), hyp.split(" "))
    wer = dw / nw if nw else float(dw > 0)
    return cer, wer


def evaluate_corpus(refs: Sequence[str], hyps: Sequence[str]) -> dict:
    """Mean-of-utterance CER/WER and total-errors/total-length CER/WER."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references for {len(hyps)} hypotheses")
    cers, wers = [], []
    ed_c = len_c = ed_w = len_w = 0
    for r, h in zip(refs, hyps):
        c, w = evaluate(r, h)
        cers.append(c)
        wers.append(w)
        d, n = edit_dist(r, h)
        ed_c += d
        len_c += n
        dw, nw = edit_dist(r.split(" "), h.split(" "))
        ed_w += dw
        len_w += nw
    return {
        "cer_mean": float(np.mean(cers)) if cers else 0.0,
        "wer_mean": float(np.mean(wers)) if wers else 0.0,
        "cer": ed_c / max(len_c, 1),
        "wer": ed_w / max(len_w, 1),
        "num_utts": len(refs),
    }


def save_predictions(target: Sequence[str], predicted: Sequence[str],
                     model_path: str) -> str:
    """Write "<target>|<predicted>" lines to <model_path>/predicted.txt."""
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path, "predicted.txt")
    with open(path, "w") as fo:
        for t, p in zip(target, predicted):
            fo.write(t + "|" + p + "\n")
    return path
