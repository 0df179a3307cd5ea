"""Command-line interface of the port (counterpart of pg_asr_tpu/cli.py).

    python -m pg_asr_tpu_torch --mode train --corpus_path C --model_path M \\
        [--model ctc|transformer|conformer|transducer] [--flash_attention] \\
        [--remat] [--transducer_encoder bilstm|transformer|conformer] \\
        [--transducer_ctc_weight W] \\
        [--num_epochs N] [--batch_size N] [--learning_rate X] \\
        [--lr_schedule warmup_constant|warmup_cosine] [--dtype float32|bfloat16] \\
        [--seed S] [--device cuda|cuda:N|cpu] [--specaugment] \\
        [--speed_perturb MIN,MAX] [--wave_noise STD] [--wave_gain_db G] \\
        [--accum_steps K] [--ema_decay D] [--keep_ckpts K] \\
        [--save_every_steps N] [--val_metric loss|cer] \\
        [--loader_threads N] [--cache_audio_mb MB] [--profile_steps N] \\
        [--init_from_torch model_best.pth [--trust_torch_pickle]]
    python -m pg_asr_tpu_torch --mode predict --corpus_path C --model_path M \\
        [--decoder greedy|beam] [--beam_size K] [--beam_prune M] \\
        [--batch_size N] [--dtype ...] [--ckpt best|last|avg] [--device ...]
    python -m pg_asr_tpu_torch --mode finetune_pg --corpus_path C \\
        --model_path M [--pg_steps N] [--pg_objective reinforce|mwer] \\
        [--mwer_beam K] [--pg_reward neg_cer|neg_wer|stepwise_ed] \\
        [--pg_eval_every N] [--batch_size N] [--device ...]

The flags keep the JAX CLI's names for what is ported; ``--device`` names a
torch device and defaults to ``cuda`` (asking for it on a host without a GPU
is an error, never a CPU fallback), and ``--seed`` sets ``train.seed``.
Modes and options of the JAX CLI that are not ported yet are accepted and
exit with a message that says so (the seq2seq and MoE models, ``--mesh``,
``--max_restarts`` and ``--fault_step`` among them).
``--mode predict`` takes the model family (a transducer's encoder with it)
and ``flash_attention`` from the model's config.json, as the JAX CLI does;
for a transducer ``--decoder beam`` is its RNN-T beam search (width
``--beam_size``; ``--beam_prune`` is ignored, as in the JAX CLI); a train run that resumes takes the family and its config
from there too (the transducer's ``fused_joint`` included: no flag sets
it, as in the JAX CLI; ``train.train(config=...)`` or a config.json does).
"""

from __future__ import annotations

import argparse
import os

from .config import Config

MODES = ("train", "predict", "preproc", "finetune_pg", "stream", "export",
         "align", "pseudolabel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pg_asr_tpu_torch",
        description="PyTorch/CUDA port of pg_asr_tpu (train, predict and "
                    "policy-gradient fine-tuning of the BiLSTM-CTC, "
                    "transformer-CTC, conformer-CTC and RNN-T transducer, "
                    "so far)")
    p.add_argument("--mode", required=True, choices=MODES)
    p.add_argument("--corpus_path", type=str,
                   help="corpus dir (train/dev/test.tsv, clips/, alphabet.txt)")
    p.add_argument("--model_path", type=str,
                   help="dir for checkpoints, logs, loss curves")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda, cuda:N or cpu. CUDA runs the "
                        "hand-written kernels; asking for it on a host "
                        "without a GPU is an error, never a CPU fallback")
    p.add_argument("--num_epochs", nargs="?", type=int, default=10)
    p.add_argument("--batch_size", nargs="?", type=int, default=None,
                   help="default 32; `--mode predict --decoder beam` "
                        "defaults to 128")
    p.add_argument("--seed", type=int, default=None,
                   help="train: seed of the initial weights, the batch "
                        "order and the dropout bits (default 0)")
    p.add_argument("--dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="compute dtype of activations and parameters")
    # train
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--lr_schedule", type=str, default=None,
                   choices=["warmup_constant", "warmup_cosine"])
    p.add_argument("--model", type=str, default=None,
                   choices=["ctc", "transformer", "conformer", "transducer",
                            "seq2seq", "moe"])
    p.add_argument("--transducer_encoder", type=str, default=None,
                   choices=["bilstm", "transformer", "conformer"],
                   help="transducer family: encoder backbone "
                        "(default conformer)")
    p.add_argument("--transducer_ctc_weight", type=float, default=None,
                   help="transducer family: hybrid training with an "
                        "auxiliary CTC head, L = L_rnnt + w * L_ctc "
                        "(0 = off)")
    p.add_argument("--flash_attention", action="store_true",
                   help="train, transformer/conformer: attention through "
                        "the hand-written flash-attention kernel on CUDA "
                        "(segment-masked online softmax; no (B, H, T, T) "
                        "score tensor in device memory). `--mode predict` "
                        "takes it from the model's config.json")
    p.add_argument("--remat", action="store_true",
                   help="train, transformer/conformer: recompute each "
                        "encoder block in the backward pass (less "
                        "activation memory, one more forward per block)")
    p.add_argument("--features", type=str, default=None,
                   choices=["logmel", "mfcc"])
    p.add_argument("--units", type=str, default=None, choices=["char", "bpe"])
    p.add_argument("--accum_steps", type=int, default=None,
                   help="train: accumulate gradients over N micro-batches "
                        "per optimizer update")
    p.add_argument("--val_metric", type=str, default=None,
                   choices=["loss", "cer"],
                   help="train: select the best checkpoint on validation "
                        "loss or greedy-decode CER")
    p.add_argument("--save_every_steps", type=int, default=None,
                   help="train: also save model_last every N steps within "
                        "an epoch; a resume goes on at the next batch of "
                        "the same shuffled order")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="train: exponential moving average of the params "
                        "(validation and predict use it; 0 = off)")
    p.add_argument("--keep_ckpts", type=int, default=None,
                   help="train: keep the newest K per-epoch snapshots "
                        "(model_epochNNNN.pt) for --ckpt avg")
    p.add_argument("--loader_threads", type=int, default=None,
                   help="train: decode threads building batches ahead "
                        "(0 = inline; default: 2 on hosts of >= 4 CPUs)")
    p.add_argument("--cache_audio_mb", type=float, default=None,
                   help="train: MiB of built batches kept for later epochs "
                        "(0 = off)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="train: torch.profiler trace of N steady-state "
                        "steps into <model_path>/trace")
    p.add_argument("--mesh", type=str, default=None,
                   help="device meshes (not ported)")
    p.add_argument("--fault_step", type=int, default=None,
                   help="train: fault injection for --max_restarts (not "
                        "ported)")
    p.add_argument("--init_from_torch", type=str, default=None,
                   help="train: warm-start from a reference torch "
                        "checkpoint (model_best.pth) when model_path has "
                        "no checkpoint (families ctc and transducer with "
                        "the bilstm encoder; --features mfcc for its "
                        "120-dim input)")
    p.add_argument("--trust_torch_pickle", action="store_true",
                   help="init_from_torch: allow full unpickling when the "
                        "weights_only load fails (runs code embedded in "
                        "the file: trusted sources only)")
    p.add_argument("--specaugment", action="store_true",
                   help="train: SpecAugment time and frequency masks on "
                        "the device")
    p.add_argument("--speed_perturb", type=str, default=None,
                   metavar="MIN,MAX",
                   help="train: per-utterance speed factor range, e.g. "
                        "0.9,1.1")
    p.add_argument("--wave_noise", type=float, default=None,
                   help="train: additive noise std relative to each "
                        "utterance's RMS")
    p.add_argument("--wave_gain_db", type=float, default=None,
                   help="train: random gain in [-g, +g] dB")
    # predict
    p.add_argument("--test_path", type=str, default=None,
                   help="test manifest TSV (default <corpus_path>/test.tsv)")
    p.add_argument("--aud_path", type=str, default=None,
                   help="audio dir (default <corpus_path>/clips)")
    p.add_argument("--alphabet", type=str, default=None,
                   help="alphabet.txt (default <corpus_path>/alphabet.txt)")
    p.add_argument("--decoder", type=str, default="greedy",
                   choices=["greedy", "beam"])
    p.add_argument("--beam_size", type=int, default=None,
                   help="predict with --decoder beam: beam width (default "
                        "16, config decode.beam_size), of the CTC prefix "
                        "beam or the transducer's beam")
    p.add_argument("--beam_prune", type=int, default=None,
                   help="predict with --decoder beam: cap the per-frame "
                        "candidate symbols to the top-M (default 6, config "
                        "decode.beam_prune); 0 for the exact search (all "
                        "beam+2 candidates). The transducer's beam ignores "
                        "it")
    p.add_argument("--ckpt", type=str, default="best",
                   choices=("best", "last", "avg"))
    p.add_argument("--lm_order", type=int, default=0, choices=[0, 2, 3])
    p.add_argument("--timestamps", action="store_true")
    # finetune_pg
    p.add_argument("--pg_steps", type=int, default=200,
                   help="finetune_pg: number of fine-tune steps")
    p.add_argument("--pg_objective", type=str, default=None,
                   choices=["reinforce", "mwer"],
                   help="finetune_pg: REINFORCE over sampled alignment "
                        "paths (reference-style) or expected-CER over the "
                        "on-device K-best list (MWER)")
    p.add_argument("--mwer_beam", type=int, default=None,
                   help="finetune_pg: n-best width K for --pg_objective "
                        "mwer (default 4)")
    p.add_argument("--pg_reward", type=str, default=None,
                   choices=["neg_cer", "neg_wer", "stepwise_ed"],
                   help="finetune_pg: reward granularity — negative CER, "
                        "negative WER (on-chip word segmentation, the "
                        "north-star reward), or the reference's per-step "
                        "edit-distance deltas")
    p.add_argument("--pg_eval_every", type=int, default=50,
                   help="finetune_pg: greedy-decode the dev set every N "
                        "steps (real dev CER curve + best-on-CER "
                        "checkpoint); 0 disables")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="train/finetune_pg: relaunch a run that dies "
                        "ungracefully (not ported)")
    return p


def _replace(section, **kw):
    return section.__class__(**{**section.__dict__, **kw})


def train_config(args, cfg: Config | None = None) -> Config:
    """The Config a `--mode train` run starts from (the JAX CLI's
    ``_config`` for the flags the port has), the flags applied over `cfg`
    (default ``Config()``). Options that are not ported are set here as
    asked and refused by ``train.train``."""
    cfg = cfg or Config()
    model_kw = {}
    if args.model:
        # "moe" is the transformer family with switch-MoE FFN blocks (4
        # experts, the JAX CLI's default); train.train refuses it
        model_kw["family"] = ("transformer" if args.model == "moe"
                              else args.model)
        if args.model == "moe":
            cfg = cfg.replace(transformer=_replace(cfg.transformer,
                                                   num_experts=4))
    if args.dtype:
        model_kw["dtype"] = args.dtype
    if args.remat:
        model_kw["remat"] = True
    if model_kw:
        cfg = cfg.replace(model=_replace(cfg.model, **model_kw))
    if args.flash_attention:
        cfg = cfg.replace(
            transformer=_replace(cfg.transformer, flash_attention=True),
            conformer=_replace(cfg.conformer, flash_attention=True))
    if args.transducer_encoder:
        cfg = cfg.replace(transducer=_replace(
            cfg.transducer, encoder=args.transducer_encoder))
    if args.transducer_ctc_weight is not None:
        cfg = cfg.replace(transducer=_replace(
            cfg.transducer, ctc_weight=args.transducer_ctc_weight))
    if args.features:
        cfg = cfg.replace(features=_replace(cfg.features, kind=args.features))
    if args.units:
        cfg = cfg.replace(text=_replace(cfg.text, units=args.units))
    if args.specaugment:
        cfg = cfg.replace(augment=_replace(cfg.augment, enabled=True))
    aug = {}
    if args.speed_perturb:
        try:
            lo, hi = (float(x) for x in args.speed_perturb.split(","))
        except ValueError:
            raise SystemExit("--speed_perturb expects MIN,MAX (e.g. 0.9,1.1)")
        if not 0.5 <= lo <= hi <= 2.0:
            raise SystemExit("--speed_perturb factors must satisfy "
                             "0.5 <= MIN <= MAX <= 2.0")
        aug.update(speed_min=lo, speed_max=hi)
    for flag, field in (("wave_noise", "noise_std"),
                        ("wave_gain_db", "gain_db")):
        value = getattr(args, flag)
        if value is not None:
            if value < 0:
                raise SystemExit(f"--{flag} must be >= 0")
            aug[field] = value
    if aug:
        # a waveform option turns augmentation on; the SpecAugment masks
        # stay off unless --specaugment was given (the JAX CLI's rule)
        if not args.specaugment:
            aug.update(time_masks=0, freq_masks=0)
        cfg = cfg.replace(augment=_replace(cfg.augment, enabled=True, **aug))
    tr = {"num_epochs": args.num_epochs}
    for name in ("save_every_steps", "keep_ckpts", "cache_audio_mb",
                 "loader_threads"):
        value = getattr(args, name)
        if value is not None and value < 0:
            raise SystemExit(f"--{name} must be >= 0")
    for name in ("batch_size", "seed", "learning_rate", "lr_schedule",
                 "accum_steps", "val_metric", "ema_decay", "save_every_steps",
                 "keep_ckpts", "init_from_torch", "loader_threads",
                 "cache_audio_mb"):
        value = getattr(args, name)
        if value is not None:
            tr[name] = value
    if args.trust_torch_pickle:
        tr["trust_torch_pickle"] = True
    return cfg.replace(train=_replace(cfg.train, **tr))


def pg_config(args) -> Config:
    """The Config of a `--mode finetune_pg` run: <model_path>/config.json
    (the config the model was trained with), the flags applied over it, as
    the JAX CLI's ``_config(args, from_model_path=True)``."""
    cfg = None
    path = os.path.join(args.model_path, "config.json")
    if os.path.exists(path):
        with open(path) as fo:
            cfg = Config.from_json(fo.read())
    cfg = train_config(args, cfg)
    rl = {}
    if args.pg_objective:
        rl["objective"] = args.pg_objective
    if args.mwer_beam is not None:
        if args.mwer_beam < 2:
            raise SystemExit("--mwer_beam must be >= 2")
        rl["mwer_beam"] = args.mwer_beam
    if args.pg_reward:
        rl["reward"] = args.pg_reward
    return cfg.replace(rl=_replace(cfg.rl, **rl))


def _refuse_unported_runs(args) -> None:
    """The run options of train and finetune_pg that are not ported
    (ROADMAP.md queue 1 item 15)."""
    from . import not_ported

    if args.mesh:
        raise not_ported("--mesh (device meshes)")
    if args.max_restarts > 0:
        raise not_ported("--max_restarts (supervised relaunch, "
                         "utils/elastic.py)")
    if args.fault_step is not None:
        raise not_ported("--fault_step (fault injection for --max_restarts)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode not in ("train", "predict", "finetune_pg"):
        raise SystemExit(f"--mode {args.mode} is not yet ported to "
                         "pg_asr_tpu_torch (see ROADMAP.md); use main.py")
    from . import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    if args.mode == "train":
        if not args.corpus_path or not args.model_path:
            raise SystemExit("--mode train needs --corpus_path and "
                             "--model_path")
        from .train import train

        try:
            _refuse_unported_runs(args)
            train(args.corpus_path, args.model_path, config=train_config(args),
                  device=str(device), profile_steps=args.profile_steps)
        except NotImplementedError as e:
            raise SystemExit(str(e)) from None
        return 0

    if args.mode == "finetune_pg":
        if not args.corpus_path or not args.model_path:
            raise SystemExit("--mode finetune_pg needs --corpus_path and "
                             "--model_path")
        from .rl.reinforce import finetune_pg

        try:
            _refuse_unported_runs(args)
            finetune_pg(args.corpus_path, args.model_path,
                        num_steps=args.pg_steps,
                        batch_size=args.batch_size or 32,
                        config=pg_config(args),
                        eval_every=args.pg_eval_every, device=str(device))
        except (NotImplementedError, ValueError) as e:
            raise SystemExit(str(e)) from None
        return 0

    corpus = args.corpus_path or ""
    test_path = args.test_path or os.path.join(corpus, "test.tsv")
    aud_path = args.aud_path or os.path.join(corpus, "clips")
    alphabet = args.alphabet or os.path.join(corpus, "alphabet.txt")
    from .predict import predict

    # beam eval batches at 128, greedy at 32, as the JAX CLI
    bs = args.batch_size if args.batch_size is not None else (
        128 if args.decoder == "beam" else 32)
    try:
        predict(test_path, aud_path, alphabet, args.model_path,
                batch_size=bs, decoder=args.decoder, which_ckpt=args.ckpt,
                device=str(device), dtype=args.dtype,
                beam_size=args.beam_size, beam_prune=args.beam_prune,
                lm_order=args.lm_order, timestamps=args.timestamps)
    except (NotImplementedError, ValueError, FileNotFoundError) as e:
        raise SystemExit(str(e)) from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
