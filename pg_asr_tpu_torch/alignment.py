"""``--mode align``: forced alignment of reference transcripts to audio
(counterpart of pg_asr_tpu/alignment.py).

For every manifest row: the acoustic forward on the device, the Viterbi
over the CTC lattice of the reference text (ops/align.py), and one line
of <model_path>/alignments.jsonl: per word its [start, end] seconds (true
spans, not emission peaks) and a confidence (the geometric-mean posterior
of its tokens over their aligned frames); an utterance whose lattice is
infeasible gets ``aligned: false``. CTC families only: the transducer's
decoder is label-synchronous and has no frame lattice of this shape.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import resolve_device
from .config import Config


def _group_words(ids, spans, alphabet):
    """Token spans -> words. A word starts at a literal space symbol
    (characters) or at a word-start-marker token (BPE). Returns a list of
    (word_text, [span indices])."""
    from .data.bpe import MARKER

    words = []
    cur_text: list[str] = []
    cur_idx: list[int] = []

    def flush():
        text = "".join(cur_text).strip()
        if text and cur_idx:
            words.append((text, list(cur_idx)))
        cur_text.clear()
        cur_idx.clear()

    for k, (pos, _, _) in enumerate(spans):
        sym = alphabet.symbols[int(ids[pos])]
        if sym == " " or sym.startswith(MARKER):
            flush()
        piece = alphabet.piece(int(ids[pos])).lstrip(" ")
        if piece:
            cur_text.append(piece)
            cur_idx.append(k)
    flush()
    return words


def align_rows(log_probs, out_lens, spans_b, batch, alphabet,
               sample_rate: int) -> list[dict]:
    """alignments.jsonl's rows for one batch, from host log-probs (B, T,
    A), output frame counts and ``ctc_forced_align``'s spans."""
    rows = []
    for i, spans in enumerate(spans_b):
        text = batch.texts[i]
        if not spans:
            rows.append({"text": text, "aligned": False, "words": []})
            continue
        # the utterance's seconds over its output frames (any subsampling)
        spf = ((float(batch.num_samples[i]) / sample_rate)
               / max(int(out_lens[i]), 1))
        ids = batch.labels[i]
        confs = [float(np.exp(log_probs[i, s:e, int(ids[pos])].mean()))
                 for pos, s, e in spans]
        words = [{
            "word": word,
            "start": round(spans[idx[0]][1] * spf, 3),
            "end": round(spans[idx[-1]][2] * spf, 3),
            "conf": round(float(np.exp(np.mean(
                [np.log(max(confs[k], 1e-30)) for k in idx]))), 4),
        } for word, idx in _group_words(ids, spans, alphabet)]
        rows.append({"text": text, "aligned": True, "words": words})
    return rows


def align_corpus(test_path: str, aud_path: str, alphabet_path: str,
                 model_path: str, batch_size: int = 32,
                 config: Config | None = None, which_ckpt: str = "best",
                 limit: int | None = None, device: str = "cuda") -> dict:
    """Force-align every utterance of a manifest; write alignments.jsonl."""
    from .data import BatchIterator, PrefetchIterator, load_manifest
    from .ops.align import ctc_forced_align
    from .predict import forward, load_model, model_config, model_tokenizer

    dev = resolve_device(device)
    alphabet = model_tokenizer(alphabet_path, model_config(model_path, config))
    params, cfg = load_model(model_path, alphabet, config, which=which_ckpt,
                             device=dev)
    if cfg.model.family in ("transducer", "seq2seq"):
        raise ValueError("--mode align needs a CTC-family model (frame-"
                         f"synchronous lattice); got {cfg.model.family!r}")

    utts = load_manifest(test_path, aud_path)
    if limit:
        utts = utts[:limit]
    it = PrefetchIterator(BatchIterator(
        utts, alphabet, batch_size, shuffle=False,
        sample_rate=cfg.features.sample_rate), depth=2)

    rows = []
    for batch in it:
        log_probs, _, out_lens = forward(
            params, torch.from_numpy(batch.wave).to(dev),
            torch.from_numpy(batch.num_samples).to(dev), cfg)
        spans_b = ctc_forced_align(log_probs, out_lens,
                                   torch.from_numpy(batch.labels).to(dev),
                                   torch.from_numpy(batch.label_lens).to(dev))
        rows.extend(align_rows(log_probs.float().cpu().numpy(),
                               out_lens.cpu().numpy(), spans_b, batch,
                               alphabet, cfg.features.sample_rate))

    out_path = os.path.join(model_path, "alignments.jsonl")
    with open(out_path, "w", encoding="utf-8") as fo:
        for row in rows:
            fo.write(json.dumps(row, ensure_ascii=False) + "\n")
    n_ok = sum(row["aligned"] for row in rows)
    n_fail = len(rows) - n_ok
    print(f"[align] {n_ok}/{len(rows)} utterances aligned -> {out_path}"
          + (f" ({n_fail} infeasible)" if n_fail else ""))
    return {"num_utts": len(rows), "num_aligned": n_ok, "path": out_path}
