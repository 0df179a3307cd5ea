"""Batch inference + scoring driver (counterpart of pg_asr_tpu/predict.py).

Loads model_best (or model_last), decodes every utterance of a test
manifest, scores CER/WER and writes predicted.txt. Per batch: int16 waves go
to the device, then features + BiLSTM-CTC forward + greedy decode run there,
and only the (B, T) label ids come back. Ported: the CTC family with the
greedy decoder.
"""

from __future__ import annotations

import os

import torch

from . import not_ported, resolve_device
from .checkpoint import checkpoint_path, load_checkpoint
from .config import Config
from .data import Alphabet, BatchIterator, PrefetchIterator, load_manifest
from .data.bpe import load_tokenizer
from .decoding.greedy import greedy_decode, ids_to_strings
from .metrics import evaluate_corpus, save_predictions
from .models import acoustic_forward, check_family
from .models.bilstm_ctc import torch_dtype
from .ops.features import extract_features


def load_model(model_path: str, alphabet: Alphabet,
               config: Config | None = None, which: str = "best",
               device: torch.device | str = "cpu", dtype: str | None = None):
    """Load params from <model_path>/model_{best,last}.pt onto `device`
(the ``params`` entry of a checkpoint the trainer or ``save_model`` wrote).

    vocab_size and input_dim follow the alphabet and the feature config, as
    in the JAX package; `dtype` overrides the config's compute dtype."""
    cfg_path = os.path.join(model_path, "config.json")
    if config is None and os.path.exists(cfg_path):
        with open(cfg_path) as fo:
            config = Config.from_json(fo.read())
    cfg = config or Config()
    model_kw = {}
    if (cfg.model.vocab_size != alphabet.size
            or cfg.model.input_dim != cfg.features.feature_dim):
        model_kw.update(vocab_size=alphabet.size,
                        input_dim=cfg.features.feature_dim)
    if dtype is not None:
        model_kw["dtype"] = dtype
    if model_kw:
        cfg = cfg.replace(model=cfg.model.__class__(
            **{**cfg.model.__dict__, **model_kw}))
    check_family(cfg.model.family)
    if which == "avg":
        raise not_ported("--ckpt avg (checkpoint averaging)")
    state = load_checkpoint(checkpoint_path(model_path, which))["params"]
    dt = torch_dtype(cfg.model.dtype)
    params = {k: v.to(device=device, dtype=dt) for k, v in state.items()}
    return params, cfg


@torch.inference_mode()
def forward(params, wave, num_samples, cfg: Config, use_kernel: bool = True):
    """Featurize + acoustic forward on wave's device -> (log_probs, mask,
    frame_lens)."""
    feats, mask, frame_lens = extract_features(wave, num_samples, cfg.features)
    return acoustic_forward(params, feats, mask, frame_lens, cfg,
                            use_kernel=use_kernel)


def predict(test_path: str, aud_path: str, alphabet_path: str,
            model_path: str, batch_size: int = 32,
            config: Config | None = None, decoder: str = "greedy",
            which_ckpt: str = "best", limit: int | None = None,
            device: str = "cuda", dtype: str | None = None,
            lm_order: int = 0, timestamps: bool = False) -> dict:
    """Decode a test manifest and report CER/WER (+ predicted.txt dump)."""
    if decoder == "beam":
        raise not_ported("--decoder beam (CTC prefix beam search)")
    if decoder != "greedy":
        raise ValueError(f"unknown decoder {decoder!r}")
    if lm_order:
        raise not_ported("LM shallow fusion (--lm_order)")
    if timestamps:
        raise not_ported("--timestamps")
    dev = resolve_device(device)

    cfg_peek = config
    cfg_path = os.path.join(model_path, "config.json")
    if cfg_peek is None and os.path.exists(cfg_path):
        with open(cfg_path) as fo:
            cfg_peek = Config.from_json(fo.read())
    if cfg_peek is not None and cfg_peek.text.units == "bpe":
        alphabet = load_tokenizer(os.path.dirname(alphabet_path), "bpe")
    else:
        alphabet = Alphabet.load(alphabet_path)
    params, cfg = load_model(model_path, alphabet, config, which=which_ckpt,
                             device=dev, dtype=dtype)

    utts = load_manifest(test_path, aud_path)
    if limit:
        utts = utts[:limit]
    it = BatchIterator(utts, alphabet, batch_size, shuffle=False,
                       sample_rate=cfg.features.sample_rate)
    it = PrefetchIterator(it, depth=2)  # overlap WAV decode with the device

    targets: list[str] = []
    predicted: list[str] = []
    for batch in it:
        # int16 waves go to the device; only the (B, T) label ids come back
        wave = torch.from_numpy(batch.wave).to(dev)
        num_samples = torch.from_numpy(batch.num_samples).to(dev)
        log_probs, mask, _ = forward(params, wave, num_samples, cfg)
        labels, lens = greedy_decode(log_probs, mask)
        predicted.extend(ids_to_strings(labels, lens, alphabet))
        targets.extend(batch.texts)

    save_predictions(targets, predicted, model_path)
    stats = evaluate_corpus(targets, predicted)
    print(f"CER: {stats['cer_mean']:.4f} WER: {stats['wer_mean']:.4f} "
          f"(corpus: cer={stats['cer']:.4f} wer={stats['wer']:.4f}, "
          f"{stats['num_utts']} utts)")
    return stats
