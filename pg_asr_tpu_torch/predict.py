"""Batch inference + scoring driver (counterpart of pg_asr_tpu/predict.py).

Loads model_best (or model_last, or the average of the per-epoch snapshots,
``--ckpt avg``), decodes every utterance of a test
manifest, scores CER/WER and writes predicted.txt. Per batch: int16 waves go
to the device, then features + acoustic forward + decode run there, and
only the label ids come back. Ported: the CTC families (BiLSTM-CTC,
transformer-CTC, conformer-CTC) with the greedy decoder (``timestamps``:
also timestamps.jsonl, per-word times and confidences) and the CTC prefix
beam search (``decoder="beam"``, one kernel launch per batch on CUDA), the
RNN-T transducer (any of the three encoders) with its greedy and beam
decoders (decoding/transducer.py), and the attention seq2seq with its
greedy decoding (cut at the first EOS) and its decoder beam search
(models/seq2seq.py); the family, the transducer's encoder and
``flash_attention`` come from the model's config.json. A model directory
the JAX package wrote (``.ckpt`` files) is served as well.

LM fusion into the CTC beam (``lm_order`` 2 or 3 with ``decoder="beam"``):
an n-gram table trained from ``lm_train_tsv``'s transcripts
(decoding/lm.py), or with ``lm_type="neural"`` a small LSTM LM
(decoding/neural_lm.py) trained on the device and cached beside the model
(``lm_neural.pt`` + ``lm_neural.pt.json``, the key of what it was trained
on; a JAX package ``lm_neural.ckpt`` with a matching ``lm_neural.ckpt.json``
is served as it is), fused in the beam (``lm_pass="fused"``) or
re-ranking the exact K-best (``"rescore"``, decoding/rescore.py).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from . import resolve_device
from .checkpoint import (average_checkpoints, epoch_snapshots,
                         find_checkpoint, load_checkpoint)
from .config import Config, fit_vocab
from .data import Alphabet, BatchIterator, PrefetchIterator, load_manifest
from .data.bpe import load_tokenizer
from .decoding.beam import beam_decode
from .decoding.lm import lm_from_manifest
from .decoding.neural_lm import (JAX_LM_FILE, LM_FILE, load_lm, save_lm,
                                 train_neural_lm)
from .decoding.rescore import rescore_nbest
from .decoding.greedy import (assemble_word_timings, greedy_decode,
                              greedy_decode_with_timing, ids_to_strings)
from .decoding.transducer import (transducer_beam_decode,
                                  transducer_greedy_decode)
from .metrics import evaluate_corpus, save_predictions
from .models import acoustic_forward, cast_params, check_family
from .models import seq2seq, transducer
from .models.bilstm_ctc import torch_dtype
from .ops.features import extract_features
from .utils import debug


def load_model(model_path: str, alphabet: Alphabet,
               config: Config | None = None, which: str = "best",
               device: torch.device | str = "cuda", dtype: str | None = None):
    """Load params from <model_path>/model_{best,last}.pt onto `device`
(the ``params`` entry of a checkpoint the trainer or ``save_model`` wrote;
its ``ema_params`` when the config's ``train.ema_decay`` > 0 and the
checkpoint holds them, as the JAX package serves them), or from the JAX
package's model_{best,last}.ckpt where there is no .pt. which="avg": the
uniform average of the per-epoch snapshots (train with ``keep_ckpts``;
model_epoch*.pt, else the JAX package's model_epoch*.ckpt), of their
``ema_params`` for an EMA model.

    vocab_size (the seq2seq decoder's too) and input_dim follow the
    alphabet and the feature config, as in the JAX package; `dtype`
    overrides the config's compute dtype, in which every param comes back
    but the LayerNorm ones (float32)."""
    cfg = fit_vocab(model_config(model_path, config), alphabet.size)
    if dtype is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype))
    check_family(cfg.model.family)
    dt = torch_dtype(cfg.model.dtype)
    if which == "avg":
        snaps = (epoch_snapshots(model_path)
                 or epoch_snapshots(model_path, ".ckpt"))
        if not snaps:
            raise FileNotFoundError(
                f"no model_epoch*.pt snapshots in {model_path} - train "
                "with --keep_ckpts K to enable checkpoint averaging")
        key = "ema_params" if cfg.train.ema_decay > 0.0 else "params"
        try:
            state = average_checkpoints(snaps, key)
        except KeyError:
            state = average_checkpoints(snaps, "params")
        print(f"[predict] averaged {len(snaps)} epoch snapshots "
              f"({os.path.basename(snaps[0])}..{os.path.basename(snaps[-1])})")
        return cast_params(state, dt, device), cfg
    ckpt = load_checkpoint(find_checkpoint(model_path, which))
    state = ckpt["params"]
    if cfg.train.ema_decay > 0.0:
        # EMA-trained models serve their averaged weights (the ones the
        # best-checkpoint selection was scored on); a checkpoint written
        # before EMA was enabled on a resumed run has none
        if "ema_params" in ckpt:
            state = ckpt["ema_params"]
        else:
            print("[predict] checkpoint predates EMA being enabled - "
                  "serving the raw params")
    return cast_params(state, dt, device), cfg


def model_config(model_path: str, config: Config | None = None) -> Config:
    """`config`, else <model_path>/config.json, else the defaults."""
    cfg_path = os.path.join(model_path, "config.json")
    if config is None and os.path.exists(cfg_path):
        with open(cfg_path) as fo:
            config = Config.from_json(fo.read())
    return config or Config()


def model_tokenizer(alphabet_path: str, cfg: Config):
    """The model's tokenizer: its config's text.units picks alphabet.txt
    at `alphabet_path` or the BPE files beside it (the JAX drivers'
    rule)."""
    if cfg.text.units == "bpe":
        return load_tokenizer(os.path.dirname(alphabet_path), "bpe")
    return Alphabet.load(alphabet_path)


@torch.inference_mode()
def forward(params, wave, num_samples, cfg: Config, use_kernel: bool = True):
    """Featurize + acoustic forward on wave's device -> (log_probs (B, T',
    A), out_mask (B, T') float32, out_lens (B,)); T' = T for the BiLSTM,
    ceil(T / subsample) for the attention families."""
    feats, mask, frame_lens = extract_features(wave, num_samples, cfg.features)
    out = acoustic_forward(params, feats, mask, frame_lens, cfg,
                           use_kernel=use_kernel)
    debug.check_nans(out[0], "the log-probs")
    return out


@torch.inference_mode()
def forward_transducer(params, wave, num_samples, cfg: Config,
                       beam_size: int = 0, use_kernel: bool = True):
    """Featurize + transducer encoder + batched decode on wave's device
    (greedy, or the RNN-T beam search when beam_size > 0) -> (labels (B, L)
    int32, lens (B,)); the counterpart of pg_asr_tpu/predict.py
    ``_forward_transducer``."""
    feats, mask, frame_lens = extract_features(wave, num_samples, cfg.features)
    enc, _, out_lens = transducer.encode(params, feats, mask, frame_lens, cfg,
                                         use_kernel=use_kernel)
    debug.check_nans(enc, "the encoder output")
    L = cfg.decode.max_label_len
    if beam_size > 0:
        labels, lens, _ = transducer_beam_decode(
            params, enc, out_lens, cfg, beam_size=beam_size, max_label_len=L)
        return labels, lens
    return transducer_greedy_decode(params, enc, out_lens, cfg,
                                    max_label_len=L)


@torch.inference_mode()
def forward_seq2seq(params, wave, num_samples, cfg: Config,
                    use_kernel: bool = True):
    """Featurize + encoder + greedy decoding of all
    ``decode.max_label_len`` steps on wave's device -> (tokens (B, S),
    log-probs (B, S, A)); pad id 0 is EOS (the JAX package's
    ``_forward_seq2seq``)."""
    feats, mask, _ = extract_features(wave, num_samples, cfg.features)
    out = seq2seq.greedy_generate(params, feats, mask, cfg.model,
                                  max_steps=cfg.decode.max_label_len,
                                  use_kernel=use_kernel)
    debug.check_nans(out[1], "the log-probs")
    return out


@torch.inference_mode()
def forward_seq2seq_beam(params, wave, num_samples, cfg: Config,
                         beam_size: int = 8, use_kernel: bool = True):
    """Featurize + encoder + the decoder's beam search of width beam_size
    -> (tokens (B, S) zero-padded after EOS, lens (B,)) (the JAX package's
    ``_forward_seq2seq_beam``)."""
    feats, mask, _ = extract_features(wave, num_samples, cfg.features)
    tokens, lens, scores = seq2seq.beam_generate(
        params, feats, mask, cfg.model, beam_size=beam_size,
        max_steps=cfg.decode.max_label_len, use_kernel=use_kernel)
    debug.check_nans(scores, "the beam scores")
    return tokens, lens


def _check_options(family: str, decoder: str, lm_order: int,
                   timestamps: bool, lm_train_tsv: str | None) -> None:
    """The JAX package's refusals of --timestamps (greedy decoder and CTC
    families only) and of --lm_order (the CTC beam only, and a TSV to
    train on), in its order (pg_asr_tpu/predict.py)."""
    if timestamps and decoder != "greedy":
        raise ValueError("--timestamps uses CTC emission peaks — "
                         "greedy decoder only")
    if timestamps and family in ("transducer", "seq2seq"):
        raise ValueError("--timestamps needs a CTC-family model "
                         "(frame-synchronous posteriors); the "
                         f"{family} decoder is label-synchronous")
    if lm_order and family == "transducer":
        raise ValueError("LM shallow fusion is a CTC-beam feature; the "
                         "transducer's prediction network IS its "
                         "language model")
    if lm_order and family == "seq2seq":
        raise ValueError("LM shallow fusion is a CTC-beam feature; the "
                         "seq2seq decoder LSTM IS its language model")
    if lm_order and decoder != "beam":
        raise ValueError("LM shallow fusion needs --decoder beam")
    if lm_order and not lm_train_tsv:
        raise ValueError("lm_order set but no lm_train_tsv to train on")


def neural_lm_for(model_path: str, lm_train_tsv: str, aud_path: str,
                  alphabet, lm_steps: int, device) -> dict:
    """The neural LM for a model directory, on `device`: the cached one
    when its meta file shows the same training (steps, vocab and the TSV's
    absolute path, size and mtime: the JAX package's key), the port's
    lm_neural.pt before the JAX package's lm_neural.ckpt; else one trained
    for `lm_steps` on the TSV's transcripts and cached as lm_neural.pt."""
    meta = {"steps": lm_steps, "vocab": alphabet.size,
            "tsv": os.path.abspath(lm_train_tsv),
            "tsv_size": os.path.getsize(lm_train_tsv),
            "tsv_mtime": int(os.path.getmtime(lm_train_tsv))}
    for name in (LM_FILE, JAX_LM_FILE):
        path = os.path.join(model_path, name)
        try:
            with open(path + ".json") as fo:
                cached = json.load(fo)
        except (OSError, ValueError):
            continue
        lm = (load_lm(path, alphabet.size, device=device)
              if cached == meta else None)
        if lm is not None:
            print(f"[predict] neural LM reused from {path} (same steps + "
                  "training TSV)")
            return lm
    path = os.path.join(model_path, LM_FILE)
    lm = train_neural_lm(
        (u.text for u in load_manifest(lm_train_tsv, aud_path)), alphabet,
        steps=lm_steps, device=device)
    save_lm(lm, path)
    with open(path + ".json", "w") as fo:
        json.dump(meta, fo)
    print(f"[predict] neural LM trained ({lm_steps} steps) -> {path}")
    return lm


def timing_rows(labels, lens, onsets, token_logp, out_lens, num_samples,
                texts, alphabet, sample_rate: int) -> list[dict]:
    """timestamps.jsonl's rows for one batch (host arrays): per utterance
    the target, the transcript, its confidence (geometric-mean token
    posterior, 4 decimals) and the words' timings. A frame lasts the
    utterance's seconds over its model output frames (any subsampling)."""
    rows = []
    for i in range(labels.shape[0]):
        spf = ((float(num_samples[i]) / sample_rate)
               / max(int(out_lens[i]), 1))
        n = int(lens[i])
        words = assemble_word_timings(labels[i], n, onsets[i], token_logp[i],
                                      alphabet, spf)
        conf = float(np.exp(np.mean(token_logp[i][:n]))) if n else 0.0
        rows.append({"target": texts[i],
                     "predicted": alphabet.decode(labels[i][:n]),
                     "confidence": round(conf, 4), "words": words})
    return rows


def predict(test_path: str, aud_path: str, alphabet_path: str,
            model_path: str, batch_size: int = 32,
            config: Config | None = None, decoder: str = "greedy",
            which_ckpt: str = "best", limit: int | None = None,
            device: str = "cuda", dtype: str | None = None,
            beam_size: int | None = None, beam_prune: int | None = None,
            lm_order: int = 0, lm_weight: float = 0.3,
            length_bonus: float = 0.0, lm_train_tsv: str | None = None,
            lm_type: str = "ngram", lm_steps: int = 300,
            lm_pass: str = "fused", timestamps: bool = False) -> dict:
    """Decode a test manifest and report CER/WER (+ predicted.txt dump).

    decoder="beam": CTC prefix beam search of width beam_size (default
    cfg.decode.beam_size) with the per-frame top-M cap beam_prune (default
    cfg.decode.beam_prune; 0 = the exact search; an explicit value needs
    decoder="beam" and is >= 2 or 0), as pg_asr_tpu/predict.py. For a
    transducer, decoder="beam" is the RNN-T beam search of width beam_size,
    and for the seq2seq family the decoder's own beam search of that width;
    both ignore beam_prune, as in the JAX package.

    lm_order (2 or 3; CTC families, decoder="beam"): shallow fusion of an
    n-gram of that order trained on lm_train_tsv's transcripts, or with
    lm_type="neural" of the LSTM LM (``neural_lm_for``, lm_steps), with
    lm_weight and length_bonus; lm_pass="rescore" (neural only) re-ranks
    the exact K-best instead (beam_prune then defaults to 0, and another
    value is refused). A fused search ignores beam_prune, as in the JAX
    package."""
    if decoder not in ("greedy", "beam"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if beam_prune is not None:
        if decoder != "beam":
            raise ValueError("--beam_prune applies to --decoder beam")
        if lm_pass == "rescore" and beam_prune != 0:
            raise ValueError("--beam_prune shapes the fused in-beam search; "
                             "the rescore pass decodes its n-best exactly")
        if beam_prune != 0 and beam_prune < 2:
            raise ValueError("--beam_prune must be >= 2 (blank + one "
                             "symbol), or 0 for the exact search")
    if lm_pass not in ("fused", "rescore"):
        raise ValueError(f"unknown lm_pass {lm_pass!r}")
    if lm_pass == "rescore" and lm_type != "neural":
        raise ValueError("--lm_pass rescore re-ranks the n-best with the "
                         "neural LM — set --lm_type neural (the n-gram "
                         "table fuses in-beam)")
    dev = resolve_device(device)

    cfg_peek = model_config(model_path, config)
    family = cfg_peek.model.family
    _check_options(family, decoder, lm_order, timestamps, lm_train_tsv)
    alphabet = model_tokenizer(alphabet_path, cfg_peek)
    params, cfg = load_model(model_path, alphabet, config, which=which_ckpt,
                             device=dev, dtype=dtype)
    beam_size = beam_size or cfg.decode.beam_size
    if beam_prune is None:
        # the rescore pass decodes its n-best exactly
        beam_prune = cfg.decode.beam_prune if lm_pass != "rescore" else 0
    prune = beam_prune or None  # 0 -> the exact search
    lm_tab = neural_lm = None
    if lm_order and lm_type == "neural":
        neural_lm = neural_lm_for(model_path, lm_train_tsv, aud_path,
                                  alphabet, lm_steps, dev)
    elif lm_order:
        lm_tab = lm_from_manifest(load_manifest(lm_train_tsv, aud_path),
                                  alphabet, order=lm_order)

    utts = load_manifest(test_path, aud_path)
    if limit:
        utts = utts[:limit]
    it = BatchIterator(utts, alphabet, batch_size, shuffle=False,
                       sample_rate=cfg.features.sample_rate)
    it = PrefetchIterator(it, depth=2)  # overlap WAV decode with the device

    targets: list[str] = []
    predicted: list[str] = []
    timing: list[dict] = []
    for batch in it:
        # int16 waves go to the device; only the (B, T) label ids come back
        wave = torch.from_numpy(batch.wave).to(dev)
        num_samples = torch.from_numpy(batch.num_samples).to(dev)
        if family == "transducer":
            labels, lens = forward_transducer(
                params, wave, num_samples, cfg,
                beam_size=beam_size if decoder == "beam" else 0)
            predicted.extend(ids_to_strings(labels, lens, alphabet))
            targets.extend(batch.texts)
            continue
        if family == "seq2seq":
            if decoder == "beam":
                labels, lens = forward_seq2seq_beam(params, wave, num_samples,
                                                    cfg, beam_size=beam_size)
            else:
                labels, lens = seq2seq.cut_at_eos(forward_seq2seq(
                    params, wave, num_samples, cfg)[0])
            predicted.extend(ids_to_strings(labels, lens, alphabet))
            targets.extend(batch.texts)
            continue
        log_probs, mask, out_lens = forward(params, wave, num_samples, cfg)
        with torch.inference_mode():
            if decoder == "beam" and neural_lm is not None \
                    and lm_pass == "rescore":
                labels, lens, _ = rescore_nbest(
                    log_probs, out_lens, neural_lm, beam_size=beam_size,
                    max_label_len=cfg.decode.max_label_len,
                    lm_weight=lm_weight, length_bonus=length_bonus)
            elif decoder == "beam":
                labels, lens, _ = beam_decode(
                    log_probs, out_lens, beam_size=beam_size,
                    max_label_len=cfg.decode.max_label_len, prune=prune,
                    lm=lm_tab, neural_lm=neural_lm, lm_weight=lm_weight,
                    length_bonus=length_bonus)
            elif timestamps:
                labels, lens, onsets, tok_lp = greedy_decode_with_timing(
                    log_probs, mask)
                timing.extend(timing_rows(
                    *(x.cpu().numpy() for x in (labels, lens, onsets, tok_lp,
                                                out_lens)),
                    batch.num_samples, batch.texts, alphabet,
                    cfg.features.sample_rate))
            else:
                labels, lens = greedy_decode(log_probs, mask)
        predicted.extend(ids_to_strings(labels, lens, alphabet))
        targets.extend(batch.texts)

    save_predictions(targets, predicted, model_path)
    if timestamps:
        ts_path = os.path.join(model_path, "timestamps.jsonl")
        with open(ts_path, "w", encoding="utf-8") as fo:
            for row in timing:
                fo.write(json.dumps(row, ensure_ascii=False) + "\n")
        print(f"[predict] word timings + confidences -> {ts_path}")
    stats = evaluate_corpus(targets, predicted)
    print(f"CER: {stats['cer_mean']:.4f} WER: {stats['wer_mean']:.4f} "
          f"(corpus: cer={stats['cer']:.4f} wer={stats['wer']:.4f}, "
          f"{stats['num_utts']} utts)")
    return stats
