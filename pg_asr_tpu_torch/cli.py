"""Command-line interface of the port (counterpart of pg_asr_tpu/cli.py).

    python -m pg_asr_tpu_torch --mode predict --corpus_path C --model_path M \
        [--batch_size N] [--dtype float32|bfloat16] [--device cuda|cuda:N|cpu]

The flags are the JAX CLI's (``pg_asr_tpu.cli.build_parser``), except
``--device``, which names a torch device and defaults to ``cuda``. Modes and
options not ported yet exit with a message that says so.
"""

from __future__ import annotations

import argparse
import os

from pg_asr_tpu.cli import build_parser as _jax_parser


def build_parser() -> argparse.ArgumentParser:
    # "resolve": our --device replaces the JAX CLI's integer one
    p = argparse.ArgumentParser(
        prog="python -m pg_asr_tpu_torch",
        description="PyTorch/CUDA port of pg_asr_tpu (predict only so far)",
        parents=[_jax_parser()], conflict_handler="resolve", add_help=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda, cuda:N or cpu. CUDA runs the "
                        "hand-written kernels; asking for it on a host "
                        "without a GPU is an error, never a CPU fallback")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode != "predict":
        raise SystemExit(f"--mode {args.mode} is not yet ported to "
                         "pg_asr_tpu_torch (see ROADMAP.md); use main.py")
    from . import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

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
