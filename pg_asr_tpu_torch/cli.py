"""Command-line interface of the port (counterpart of pg_asr_tpu/cli.py).

    python -m pg_asr_tpu_torch --mode train --corpus_path C --model_path M \\
        [--num_epochs N] [--batch_size N] [--learning_rate X] \\
        [--lr_schedule warmup_constant|warmup_cosine] [--dtype float32|bfloat16] \\
        [--seed S] [--device cuda|cuda:N|cpu]
    python -m pg_asr_tpu_torch --mode predict --corpus_path C --model_path M \\
        [--batch_size N] [--dtype ...] [--ckpt best|last] [--device ...]

The flags keep the JAX CLI's names for what is ported; ``--device`` names a
torch device and defaults to ``cuda`` (asking for it on a host without a GPU
is an error, never a CPU fallback), and ``--seed`` sets ``train.seed``.
Modes and options of the JAX CLI that are not ported yet are accepted and
exit with a message that says so.
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
        description="PyTorch/CUDA port of pg_asr_tpu (train and predict of "
                    "the BiLSTM-CTC so far)")
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
                   help="default 32")
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
    p.add_argument("--features", type=str, default=None,
                   choices=["logmel", "mfcc"])
    p.add_argument("--units", type=str, default=None, choices=["char", "bpe"])
    for name in ("accum_steps", "save_every_steps", "keep_ckpts",
                 "profile_steps"):
        p.add_argument(f"--{name}", type=int, default=None)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--val_metric", type=str, default=None,
                   choices=["loss", "cer"])
    p.add_argument("--mesh", type=str, default=None)
    p.add_argument("--init_from_torch", type=str, default=None)
    p.add_argument("--specaugment", action="store_true")
    p.add_argument("--speed_perturb", type=str, default=None)
    p.add_argument("--wave_noise", type=float, default=None)
    p.add_argument("--wave_gain_db", type=float, default=None)
    # predict
    p.add_argument("--test_path", type=str, default=None,
                   help="test manifest TSV (default <corpus_path>/test.tsv)")
    p.add_argument("--aud_path", type=str, default=None,
                   help="audio dir (default <corpus_path>/clips)")
    p.add_argument("--alphabet", type=str, default=None,
                   help="alphabet.txt (default <corpus_path>/alphabet.txt)")
    p.add_argument("--decoder", type=str, default="greedy",
                   choices=["greedy", "beam"])
    p.add_argument("--ckpt", type=str, default="best",
                   choices=("best", "last", "avg"))
    p.add_argument("--lm_order", type=int, default=0, choices=[0, 2, 3])
    p.add_argument("--timestamps", action="store_true")
    return p


def _replace(section, **kw):
    return section.__class__(**{**section.__dict__, **kw})


def train_config(args) -> Config:
    """The Config a `--mode train` run starts from (the JAX CLI's
    ``_config`` for the flags the port has). Options that are not ported
    are set here as asked and refused by ``train.train``."""
    cfg = Config()
    model_kw = {}
    if args.model:
        model_kw["family"] = args.model
    if args.dtype:
        model_kw["dtype"] = args.dtype
    if model_kw:
        cfg = cfg.replace(model=_replace(cfg.model, **model_kw))
    if args.features:
        cfg = cfg.replace(features=_replace(cfg.features, kind=args.features))
    if args.units:
        cfg = cfg.replace(text=_replace(cfg.text, units=args.units))
    if (args.specaugment or args.speed_perturb or args.wave_noise is not None
            or args.wave_gain_db is not None):
        cfg = cfg.replace(augment=_replace(cfg.augment, enabled=True))
    tr = {"num_epochs": args.num_epochs}
    for name in ("batch_size", "seed", "learning_rate", "lr_schedule",
                 "accum_steps", "val_metric", "ema_decay", "save_every_steps",
                 "keep_ckpts", "init_from_torch"):
        value = getattr(args, name)
        if value is not None:
            tr[name] = value
    return cfg.replace(train=_replace(cfg.train, **tr))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode not in ("train", "predict"):
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
        from . import not_ported
        from .train import train

        try:
            if args.mesh:
                raise not_ported("--mesh (device meshes)")
            train(args.corpus_path, args.model_path, config=train_config(args),
                  device=str(device), profile_steps=args.profile_steps or 0)
        except NotImplementedError as e:
            raise SystemExit(str(e)) from None
        return 0

    corpus = args.corpus_path or ""
    test_path = args.test_path or os.path.join(corpus, "test.tsv")
    aud_path = args.aud_path or os.path.join(corpus, "clips")
    alphabet = args.alphabet or os.path.join(corpus, "alphabet.txt")
    from .predict import predict

    try:
        predict(test_path, aud_path, alphabet, args.model_path,
                batch_size=args.batch_size or 32, decoder=args.decoder,
                which_ckpt=args.ckpt, device=str(device), dtype=args.dtype,
                lm_order=args.lm_order, timestamps=args.timestamps)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
