"""``--mode pseudolabel``: confidence-filtered pseudo-labels of unlabeled
audio, the self-training data loop (counterpart of
pg_asr_tpu/selftrain.py).

Decode a directory of unlabeled audio (or a manifest whose sentences are
ignored) with the greedy timing decoder's utterance confidence (the
geometric-mean posterior of the emitted tokens), keep an utterance when
that confidence is at least ``min_conf`` and its transcript is not empty,
and write a Common Voice-style TSV (``path``, ``sentence``,
``confidence``) that train and finetune_pg read. CTC families only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import resolve_device
from .config import Config


def _scan_wavs(wav_dir: str) -> list:
    from .data.dataset import Utterance

    paths = sorted(os.path.join(wav_dir, f) for f in os.listdir(wav_dir)
                   if f.lower().endswith((".wav", ".flac")))
    return [Utterance(audio_path=p, text="", num_samples=-1) for p in paths]


def pseudo_label(wav_dir: str, alphabet_path: str, model_path: str,
                 out_tsv: str | None = None, batch_size: int = 32,
                 min_conf: float = 0.5, config: Config | None = None,
                 which_ckpt: str = "best", limit: int | None = None,
                 device: str = "cuda") -> dict:
    """Decode unlabeled audio; write the confident subset as a train TSV
    (default <model_path>/pseudo.tsv)."""
    from .data import BatchIterator, PrefetchIterator, load_manifest
    from .decoding.greedy import greedy_decode_with_timing, ids_to_strings
    from .predict import forward, load_model, model_config, model_tokenizer

    dev = resolve_device(device)
    alphabet = model_tokenizer(alphabet_path, model_config(model_path, config))
    params, cfg = load_model(model_path, alphabet, config, which=which_ckpt,
                             device=dev)
    if cfg.model.family in ("transducer", "seq2seq"):
        raise ValueError("--mode pseudolabel scores confidence from frame "
                         f"posteriors (CTC families); got "
                         f"{cfg.model.family!r}")

    if os.path.isdir(wav_dir):
        utts = _scan_wavs(wav_dir)
    else:  # a manifest of paths
        utts = load_manifest(wav_dir, None)
    if limit:
        utts = utts[:limit]
    if not utts:
        raise FileNotFoundError(f"no audio found under {wav_dir}")
    it = PrefetchIterator(BatchIterator(
        utts, alphabet, batch_size, shuffle=False,
        sample_rate=cfg.features.sample_rate), depth=2)

    out_tsv = out_tsv or os.path.join(model_path, "pseudo.tsv")
    rows, total = [], 0
    for batch in it:
        log_probs, mask, _ = forward(
            params, torch.from_numpy(batch.wave).to(dev),
            torch.from_numpy(batch.num_samples).to(dev), cfg)
        labels, lens, _, tok_lp = greedy_decode_with_timing(log_probs, mask)
        texts = ids_to_strings(labels, lens, alphabet)
        lens_h = lens.cpu().numpy()
        tok_lp_h = tok_lp.cpu().numpy()
        for i, text in enumerate(texts):
            total += 1
            n = int(lens_h[i])
            conf = float(np.exp(tok_lp_h[i, :n].mean())) if n else 0.0
            if n and conf >= min_conf and text.strip():
                rows.append((batch.paths[i], text, conf))

    with open(out_tsv, "w", encoding="utf-8") as fo:
        fo.write("path\tsentence\tconfidence\n")
        for path, text, conf in rows:
            fo.write(f"{path}\t{text}\t{conf:.4f}\n")
    print(f"[pseudolabel] kept {len(rows)}/{total} utterances "
          f"(min_conf={min_conf}) -> {out_tsv}")
    return {"num_utts": total, "num_kept": len(rows), "path": out_tsv}
