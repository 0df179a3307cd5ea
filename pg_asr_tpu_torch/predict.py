"""Batch inference + scoring driver (counterpart of pg_asr_tpu/predict.py).

Loads model_best (or model_last, or the average of the per-epoch snapshots,
``--ckpt avg``), decodes every utterance of a test
manifest, scores CER/WER and writes predicted.txt. Per batch: int16 waves go
to the device, then features + acoustic forward + decode run there, and
only the label ids come back. Ported: the CTC families (BiLSTM-CTC,
transformer-CTC, conformer-CTC) with the greedy decoder and the CTC prefix
beam search (``decoder="beam"``, one kernel launch per batch on CUDA), and
the RNN-T transducer (any of the three encoders) with its greedy and beam
decoders (decoding/transducer.py); the family, the transducer's encoder and
``flash_attention`` come from the model's config.json. LM fusion into the
beam is not ported.
"""

from __future__ import annotations

import os

import torch

from . import not_ported, resolve_device
from .checkpoint import (average_checkpoints, checkpoint_path,
                         epoch_snapshots, load_checkpoint)
from .config import Config
from .data import Alphabet, BatchIterator, PrefetchIterator, load_manifest
from .data.bpe import load_tokenizer
from .decoding.beam import beam_decode
from .decoding.greedy import greedy_decode, ids_to_strings
from .decoding.transducer import (transducer_beam_decode,
                                  transducer_greedy_decode)
from .metrics import evaluate_corpus, save_predictions
from .models import acoustic_forward, cast_params, check_family
from .models import transducer
from .models.bilstm_ctc import torch_dtype
from .ops.features import extract_features


def load_model(model_path: str, alphabet: Alphabet,
               config: Config | None = None, which: str = "best",
               device: torch.device | str = "cuda", dtype: str | None = None):
    """Load params from <model_path>/model_{best,last}.pt onto `device`
(the ``params`` entry of a checkpoint the trainer or ``save_model`` wrote;
its ``ema_params`` when the config's ``train.ema_decay`` > 0 and the
checkpoint holds them, as the JAX package serves them). which="avg": the
uniform average of the per-epoch snapshots (train with ``keep_ckpts``),
of their ``ema_params`` for an EMA model.

    vocab_size and input_dim follow the alphabet and the feature config, as
    in the JAX package; `dtype` overrides the config's compute dtype, in
    which every param comes back but the LayerNorm ones (float32)."""
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
    dt = torch_dtype(cfg.model.dtype)
    if which == "avg":
        snaps = epoch_snapshots(model_path)
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
    ckpt = load_checkpoint(checkpoint_path(model_path, which))
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


@torch.inference_mode()
def forward(params, wave, num_samples, cfg: Config, use_kernel: bool = True):
    """Featurize + acoustic forward on wave's device -> (log_probs (B, T',
    A), out_mask (B, T') float32, out_lens (B,)); T' = T for the BiLSTM,
    ceil(T / subsample) for the attention families."""
    feats, mask, frame_lens = extract_features(wave, num_samples, cfg.features)
    return acoustic_forward(params, feats, mask, frame_lens, cfg,
                            use_kernel=use_kernel)


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
    L = cfg.decode.max_label_len
    if beam_size > 0:
        labels, lens, _ = transducer_beam_decode(
            params, enc, out_lens, cfg, beam_size=beam_size, max_label_len=L)
        return labels, lens
    return transducer_greedy_decode(params, enc, out_lens, cfg,
                                    max_label_len=L)


def _check_options(family: str, decoder: str, lm_order: int,
                   timestamps: bool) -> None:
    """The JAX package's refusals of --timestamps and --lm_order for the
    transducer (pg_asr_tpu/predict.py); for the CTC families both are not
    yet ported."""
    if family == "transducer":
        if timestamps:
            raise ValueError(
                "--timestamps uses CTC emission peaks — greedy decoder only"
                if decoder != "greedy" else
                "--timestamps needs a CTC-family model (frame-synchronous "
                "posteriors); the transducer decoder is label-synchronous")
        if lm_order:
            raise ValueError("LM shallow fusion is a CTC-beam feature; the "
                             "transducer's prediction network IS its "
                             "language model")
    if lm_order:
        raise not_ported("LM shallow fusion into the beam search "
                         "(--lm_order)")
    if timestamps:
        raise not_ported("--timestamps")


def predict(test_path: str, aud_path: str, alphabet_path: str,
            model_path: str, batch_size: int = 32,
            config: Config | None = None, decoder: str = "greedy",
            which_ckpt: str = "best", limit: int | None = None,
            device: str = "cuda", dtype: str | None = None,
            beam_size: int | None = None, beam_prune: int | None = None,
            lm_order: int = 0, timestamps: bool = False) -> dict:
    """Decode a test manifest and report CER/WER (+ predicted.txt dump).

    decoder="beam": CTC prefix beam search of width beam_size (default
    cfg.decode.beam_size) with the per-frame top-M cap beam_prune (default
    cfg.decode.beam_prune; 0 = the exact search; an explicit value needs
    decoder="beam" and is >= 2 or 0), as pg_asr_tpu/predict.py. For a
    transducer, decoder="beam" is the RNN-T beam search of width beam_size,
    and beam_prune is ignored, as in the JAX package."""
    if decoder not in ("greedy", "beam"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if beam_prune is not None:
        if decoder != "beam":
            raise ValueError("--beam_prune applies to --decoder beam")
        if beam_prune != 0 and beam_prune < 2:
            raise ValueError("--beam_prune must be >= 2 (blank + one "
                             "symbol), or 0 for the exact search")
    dev = resolve_device(device)

    cfg_peek = config
    cfg_path = os.path.join(model_path, "config.json")
    if cfg_peek is None and os.path.exists(cfg_path):
        with open(cfg_path) as fo:
            cfg_peek = Config.from_json(fo.read())
    family = (cfg_peek or Config()).model.family
    _check_options(family, decoder, lm_order, timestamps)
    if cfg_peek is not None and cfg_peek.text.units == "bpe":
        alphabet = load_tokenizer(os.path.dirname(alphabet_path), "bpe")
    else:
        alphabet = Alphabet.load(alphabet_path)
    params, cfg = load_model(model_path, alphabet, config, which=which_ckpt,
                             device=dev, dtype=dtype)
    beam_size = beam_size or cfg.decode.beam_size
    if beam_prune is None:
        beam_prune = cfg.decode.beam_prune
    prune = beam_prune or None  # 0 -> the exact search

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
        if family == "transducer":
            labels, lens = forward_transducer(
                params, wave, num_samples, cfg,
                beam_size=beam_size if decoder == "beam" else 0)
            predicted.extend(ids_to_strings(labels, lens, alphabet))
            targets.extend(batch.texts)
            continue
        log_probs, mask, out_lens = forward(params, wave, num_samples, cfg)
        with torch.inference_mode():
            if decoder == "beam":
                labels, lens, _ = beam_decode(
                    log_probs, out_lens, beam_size=beam_size,
                    max_label_len=cfg.decode.max_label_len, prune=prune)
            else:
                labels, lens = greedy_decode(log_probs, mask)
        predicted.extend(ids_to_strings(labels, lens, alphabet))
        targets.extend(batch.texts)

    save_predictions(targets, predicted, model_path)
    stats = evaluate_corpus(targets, predicted)
    print(f"CER: {stats['cer_mean']:.4f} WER: {stats['wer_mean']:.4f} "
          f"(corpus: cer={stats['cer']:.4f} wer={stats['wer']:.4f}, "
          f"{stats['num_utts']} utts)")
    return stats
