"""Command-line interface of the port (counterpart of pg_asr_tpu/cli.py).

    python -m pg_asr_tpu_torch --mode train --corpus_path C --model_path M \\
        [--model ctc|transformer|conformer|transducer|seq2seq|moe] \\
        [--moe_experts E] [--capacity_factor F] [--flash_attention] \\
        [--remat] [--transducer_encoder bilstm|transformer|conformer] \\
        [--transducer_ctc_weight W] \\
        [--num_epochs N] [--batch_size N] [--learning_rate X] \\
        [--lr_schedule warmup_constant|warmup_cosine] [--dtype float32|bfloat16] \\
        [--seed S] [--device cuda|cuda:N|cpu] [--specaugment] \\
        [--speed_perturb MIN,MAX] [--wave_noise STD] [--wave_gain_db G] \\
        [--accum_steps K] [--ema_decay D] [--keep_ckpts K] \\
        [--save_every_steps N] [--val_metric loss|cer] \\
        [--loader_threads N] [--cache_audio_mb MB] [--profile_steps N] \\
        [--init_from_torch model_best.pth [--trust_torch_pickle]] \\
        [--mesh data=N|model=T|pipe=S|seq=Q|expert=X|fsdp=F|data=N,...] \\
        [--microbatches M] [--max_restarts K [--fault_step S]] \\
        [--debug_nans]
    python -m pg_asr_tpu_torch --mode predict --corpus_path C --model_path M \\
        [--decoder greedy|beam] [--beam_size K] [--beam_prune M] \\
        [--lm_order 2|3 [--lm_type ngram|neural] [--lm_pass fused|rescore] \\
        [--lm_weight W] [--lm_steps N] [--length_bonus X]] \\
        [--batch_size N] [--dtype ...] [--ckpt best|last|avg] [--device ...]
    python -m pg_asr_tpu_torch --mode finetune_pg --corpus_path C \\
        --model_path M [--pg_steps N] [--pg_objective reinforce|mwer] \\
        [--mwer_beam K] [--pg_reward neg_cer|neg_wer|stepwise_ed] \\
        [--pg_eval_every N] [--batch_size N] [--mesh data=N,fsdp=F ...] \\
        [--max_restarts K] [--debug_nans] [--device ...]
    python -m pg_asr_tpu_torch --mode preproc --corpus_path C \\
        [--librispeech_root R] [--lang en] [--units bpe \\
        [--bpe_vocab_size 256]]
    python -m pg_asr_tpu_torch --mode align --corpus_path C --model_path M \\
        [--test_path T] [--aud_path A] [--alphabet F] [--ckpt ...]
    python -m pg_asr_tpu_torch --mode pseudolabel --corpus_path C \\
        --model_path M [--aud_path DIR_OR_TSV] [--min_conf 0.5] \\
        [--out_tsv F] [--ckpt ...]
    python -m pg_asr_tpu_torch --mode stream --corpus_path C --model_path M \\
        --wav F [--chunk_frames 64] [--right_context 32] \\
        [--left_context 512] [--block_ms 100] [--decoder greedy|beam] \\
        [--beam_size 8] [--lm_order 2|3 [--lm_weight W] \\
        [--length_bonus X]] [--timestamps] [--device ...]
    python -m pg_asr_tpu_torch --mode export --model_path M --corpus_path C \\
        [--decoder greedy|beam] [--beam_size K] [--export_batch 8] \\
        [--export_seconds 20] [--export_platforms cpu,cuda] \\
        [--export_quantize int8] [--device ...]

The parser declares every flag of the JAX CLI, with its default, so that
argparse resolves a flag, or a prefix of one, as the JAX CLI does;
``--device`` names a torch device and defaults to ``cuda`` (asking for it
on a host without a GPU is an error, never a CPU fallback), and ``--seed``
sets ``train.seed``.

``--mesh`` (train, finetune_pg) runs on one rank process per mesh position
over torch.distributed (parallel/mesh.py; the plan, parallel/driver.py,
checks the mesh against the model first, with the JAX package's messages,
and a refused mesh exits before any rank starts): ``data=N`` splits the
batch's rows over N ranks; ``expert=X`` splits each switch-MoE block's
experts over X ranks that take the same rows; ``model=T`` runs each
block's attention, FFNs and convolution module and the transducer's
joint as Megatron pairs over T ranks that take the same rows, and stores
every other split leaf split (parallel/tensor.py); ``pipe=S`` splits the
transformer-CTC's blocks into S pipeline stages that run a GPipe schedule
over ``--microbatches`` M microbatches of the same rows (default S;
parallel/pipeline.py); ``seq=Q`` splits its frames over Q ranks that take
the same rows (parallel/sequence.py); ``fsdp=F`` splits the parameters
and the AdamW state over F ranks that each take their own rows; ``data``
composes with any one of them, and ``model`` with ``expert`` and with
``pipe``. Under ``pipe`` or ``seq`` ``finetune_pg`` runs replicas of the
``data`` step on their ranks, as the JAX package's replicated step. The
CLI starts the ranks itself, on
``cuda:0`` .. ``cuda:W-1`` (W the product of the sizes; or W CPU processes
under ``--device cpu``), returns nonzero if any fails, and forwards
SIGTERM to them; a mesh of one position runs in this process, in a
process group of one. With ``PGASR_DISTRIBUTED=1`` (``PGASR_COORDINATOR``
host:port, ``PGASR_NUM_PROCESSES``, ``PGASR_PROCESS_ID``, the JAX CLI's
variables) this process is one rank on its ``--device``, started by the
user, and the mesh's positions must equal the number of processes.
Without ``--mesh`` the run stays on one device (the JAX CLI takes every
local device). Every mesh takes the step one device would take on the
whole batch (train.py), and checkpoints hold the full shapes.
``--max_restarts K`` (train, finetune_pg) supervises the run and relaunches
it, up to K times, when it dies other than by SIGTERM; the relaunch
resumes from model_last (utils/elastic.py). Under ``--mesh`` the
launcher supervises the rank processes as one group: when one dies, the
others are stopped and all relaunch together. ``--fault_step S`` ends a
train run with exit code 17 at global step S, once per model directory,
to test that path.

``--model moe`` is the transformer family with switch-MoE FFN blocks
(parallel/moe.py; ``--moe_experts``, default 4, and
``--capacity_factor`` set its config, as the JAX CLI does), served by
every mode but ``--mode stream``, which refuses it as the JAX CLI does.
``--debug_nans`` turns on NaN checks for the run (utils/debug.py), as the
JAX CLI's ``jax_debug_nans``: a NaN raises FloatingPointError and +-Inf
passes, in every step's loss and gradients (train, finetune_pg), the dev
pass and the forward outputs of predict, align, pseudolabel, stream and
export. The JAX CLI sets its flag for the process; here it holds for one
``main`` call. ``--mode export`` (exporting.py)
traces the serving program on ``--device`` and writes
<model_path>/export/serving.pt2 + manifest.json; ``--export_platforms``
takes ``cpu`` and ``cuda``.
``--mode preproc`` does no tensor work and ignores ``--device``, as the
JAX CLI has none. ``--mode predict``, ``align`` and ``pseudolabel`` read
the JAX package's ``.ckpt`` model directories too.
``--mode predict`` takes the model family (a transducer's encoder with it)
and ``flash_attention`` from the model's config.json, as the JAX CLI does;
for a transducer ``--decoder beam`` is its RNN-T beam search and for the
seq2seq family its decoder's beam search (width ``--beam_size``, default
``decode.beam_size``, over ``decode.max_label_len`` steps; ``--beam_prune``
is ignored, as in the JAX CLI). ``--lm_order`` fuses an LM trained on the
corpus's train.tsv into the CTC beam of ``--mode predict`` (n-gram or
``--lm_type neural``, fused or ``--lm_pass rescore``) and of ``--mode
stream`` (n-gram); ``--mode stream``, ``align``,
``pseudolabel``, ``--timestamps`` and ``--lm_order`` refuse the seq2seq
family with the JAX CLI's errors. A train run that resumes takes the
family and its config
from there too (the transducer's ``fused_joint`` included: no flag sets
it, as in the JAX CLI; ``train.train(config=...)`` or a config.json does).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

from .config import Config

MODES = ("train", "predict", "preproc", "finetune_pg", "stream", "export",
         "align", "pseudolabel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pg_asr_tpu_torch",
        description="PyTorch/CUDA port of pg_asr_tpu (train, predict, "
                    "policy-gradient fine-tuning, corpus preparation, "
                    "forced alignment, pseudo-labels and streaming "
                    "transcription for the BiLSTM-CTC, transformer-CTC, "
                    "conformer-CTC, switch-MoE transformer, RNN-T "
                    "transducer and attention seq2seq, so far)")
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
    p.add_argument("--units", type=str, default=None, choices=["char", "bpe"],
                   help="label units: char or BPE subwords (preproc trains "
                        "them; train/predict use <corpus>/bpe.vocab)")
    p.add_argument("--bpe_vocab_size", type=int, default=None,
                   help="preproc --units bpe: target subword vocabulary "
                        "size incl. pad (default 256)")
    p.add_argument("--lang", type=str, default="en",
                   help="preproc: language of the text normaliser's extra "
                        "characters (en, eu, es, fr, de)")
    p.add_argument("--librispeech_root", type=str, default=None,
                   help="preproc: build corpus manifests + alphabet from a "
                        "LibriSpeech tree (train-*/dev-*/test-* subdirs) "
                        "into --corpus_path")
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
                   help="train/finetune_pg: data=N, model=T, pipe=S, "
                        "seq=Q, expert=X or fsdp=F, data with one of them, "
                        "model with expert or pipe: one rank process a "
                        "mesh position (cuda:0..W-1, or the CPU under "
                        "--device cpu)")
    p.add_argument("--fault_step", type=int, default=None,
                   help="train: end the process with exit code 17 at this "
                        "global step, once per model dir (tests "
                        "--max_restarts)")
    p.add_argument("--init_from_torch", type=str, default=None,
                   help="train: warm-start from a reference torch "
                        "checkpoint (model_best.pth) when model_path has "
                        "no checkpoint (families ctc, seq2seq and "
                        "transducer with the bilstm encoder; --features "
                        "mfcc for its 120-dim input)")
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
                        "beam, the transducer's beam or the seq2seq "
                        "decoder's beam")
    p.add_argument("--beam_prune", type=int, default=None,
                   help="predict with --decoder beam: cap the per-frame "
                        "candidate symbols to the top-M (default 6, config "
                        "decode.beam_prune); 0 for the exact search (all "
                        "beam+2 candidates). The transducer's beam ignores "
                        "it")
    p.add_argument("--ckpt", type=str, default="best",
                   choices=("best", "last", "avg"))
    p.add_argument("--lm_order", type=int, default=0, choices=[0, 2, 3],
                   help="predict / stream with --decoder beam: shallow-fuse "
                        "an n-gram LM of this order, trained on the "
                        "corpus's train.tsv, into the beam ranking; 0 = "
                        "off")
    p.add_argument("--lm_weight", type=float, default=0.3,
                   help="LM fusion weight")
    p.add_argument("--lm_type", type=str, default="ngram",
                   choices=["ngram", "neural"],
                   help="predict: the fused LM, an add-k n-gram table or "
                        "a small LSTM LM with beam-carried states (needs "
                        "--lm_order != 0; trained on the device, cached at "
                        "model_path/lm_neural.pt)")
    p.add_argument("--lm_steps", type=int, default=300,
                   help="predict: neural-LM training steps (--lm_type "
                        "neural)")
    p.add_argument("--lm_pass", type=str, default="fused",
                   choices=("fused", "rescore"),
                   help="predict with --lm_type neural: fuse the LM in the "
                        "beam search, or re-rank the exact K-best with one "
                        "batched LM pass")
    p.add_argument("--length_bonus", type=float, default=0.0,
                   help="LM fusion bonus per emitted unit")
    p.add_argument("--timestamps", action="store_true",
                   help="predict: also write timestamps.jsonl with per-word "
                        "[start, end] times (CTC emission peaks, seconds) "
                        "and per-word/utterance confidences (greedy "
                        "decoder, CTC families)")
    p.add_argument("--min_conf", type=float, default=0.5,
                   help="pseudolabel: keep utterances whose confidence "
                        "(geometric-mean emitted posterior) is at least "
                        "this")
    p.add_argument("--out_tsv", type=str, default=None,
                   help="pseudolabel: output manifest path (default "
                        "<model_path>/pseudo.tsv)")
    # finetune_pg
    p.add_argument("--pg_steps", type=int, default=200,
                   help="finetune_pg: number of fine-tune steps")
    p.add_argument("--pg_objective", type=str, default=None,
                   choices=["reinforce", "mwer"],
                   help="finetune_pg: REINFORCE over sampled alignment "
                        "paths (reference-style; for seq2seq SCST over "
                        "sampled decoder continuations) or expected-CER "
                        "over the on-device K-best list (MWER)")
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
                        "ungracefully, up to N times; it resumes from "
                        "model_last")
    # stream
    p.add_argument("--wav", type=str, default=None,
                   help="stream: input audio file")
    p.add_argument("--chunk_frames", type=int, default=64,
                   help="stream: committed frames per step (emission "
                        "granularity)")
    p.add_argument("--right_context", type=int, default=32,
                   help="stream: lookahead frames (latency/accuracy dial)")
    p.add_argument("--left_context", type=int, default=512,
                   help="stream (transformer/conformer): exact left-context "
                        "frames per window")
    p.add_argument("--block_ms", type=int, default=100,
                   help="stream: audio push block size in milliseconds")
    # export
    p.add_argument("--export_batch", type=int, default=8,
                   help="export: static batch size of the serving artifact")
    p.add_argument("--export_seconds", type=float, default=20.0,
                   help="export: max audio length (s) the artifact accepts")
    p.add_argument("--export_platforms", type=str, default=None,
                   help="export: comma list (cpu,cuda) for one artifact "
                        "that loads on either device; default = --device")
    p.add_argument("--export_quantize", type=str, default=None,
                   choices=["int8"],
                   help="export: weight-only per-channel int8 (~4x smaller "
                        "weights, near-lossless; dequantized in the "
                        "program: see ops/quant.py)")
    p.add_argument("--moe_experts", type=int, default=None,
                   help="switch-MoE experts per block (--model moe "
                        "defaults to 4)")
    p.add_argument("--capacity_factor", type=float, default=None,
                   help="MoE: expert capacity = tokens/experts * factor")
    p.add_argument("--debug_nans", action="store_true",
                   help="fail fast (FloatingPointError) on a NaN in a "
                        "step's loss or gradients, the dev loss or a "
                        "mode's log-probs (+-Inf passes); autograd's anomaly "
                        "mode names the backward op of a NaN")
    p.add_argument("--microbatches", type=int, default=None,
                   help="train with a pipe axis: microbatches per batch "
                        "(default: the pipe axis size)")
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
    moe = {}
    if args.model:
        # "moe" is the transformer family with switch-MoE FFN blocks (4
        # experts unless --moe_experts says otherwise, as the JAX CLI)
        model_kw["family"] = ("transformer" if args.model == "moe"
                              else args.model)
        if args.model == "moe":
            moe["num_experts"] = 4
    if args.moe_experts is not None:
        moe["num_experts"] = args.moe_experts
    if args.capacity_factor is not None:
        moe["capacity_factor"] = args.capacity_factor
    if moe:
        cfg = cfg.replace(transformer=_replace(cfg.transformer, **moe))
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
    if args.bpe_vocab_size:
        cfg = cfg.replace(text=_replace(cfg.text,
                                        bpe_vocab_size=args.bpe_vocab_size))
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
    if args.mesh:
        tr["mesh_shape"], tr["mesh_axes"] = _mesh_spec(args.mesh)
    if args.microbatches is not None:
        if args.microbatches < 1:
            raise SystemExit("--microbatches must be >= 1")
        tr["pipeline_microbatches"] = args.microbatches
    return cfg.replace(train=_replace(cfg.train, **tr))


def _mesh_spec(spec: str):
    from .parallel.driver import parse_mesh_spec

    try:
        return parse_mesh_spec(spec)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}") from None


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


def _mesh_world(args) -> int:
    """The rank processes of a train or finetune_pg run's mesh (1 without
    ``--mesh``, and for the other modes, which run on one device), from
    the plan of the config the run will take (parallel/driver.py), so
    that a mesh the model cannot take exits before any rank starts, with
    the JAX package's message."""
    if not args.mesh or args.mode not in ("train", "finetune_pg"):
        return 1
    from .train import make_plan, resume_config

    if args.mode == "train":
        cfg = train_config(args)
        if args.model_path:
            cfg, _ = resume_config(cfg, args.model_path, say=lambda _: None)
    else:
        cfg = pg_config(args)
    try:
        return make_plan(cfg, replicas=args.mode == "finetune_pg").world
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}") from None


def _launch_ranks(argv: list[str], world: int, device: str,
                  max_restarts: int, mesh: str = "") -> int:
    """``--mesh``: run this command as `world` rank processes, rank r on
    ``cuda:r`` (or the CPU), joined through the ``PGASR_*`` variables at a
    free local port, supervised as one group (utils/elastic.supervise):
    SIGTERM and SIGINT forwarded to every rank; when a rank fails, the
    others get a grace period, then are killed, and with `max_restarts` >
    0 all are relaunched together, at a new port. Returns 0, or the
    first failing rank's exit code."""
    import torch

    from .parallel.mesh import free_port
    from .utils import elastic

    kind = device.split(":")[0]
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {device}: no CUDA device is available"
                             " on this host (pass --device cpu to run the "
                             "plain PyTorch path)")
        if world > torch.cuda.device_count():
            raise SystemExit(f"--mesh {mesh}: {world} ranks, only "
                             f"{torch.cuda.device_count()} CUDA device(s) "
                             "visible")
        devices = [f"cuda:{r}" for r in range(world)]
    elif kind == "cpu":
        devices = ["cpu"] * world
    else:
        raise SystemExit(f"--device {device}: expected cuda, cuda:N or cpu")
    base = elastic.package_env()
    # the ranks do not supervise themselves: this process supervises them
    base.update({elastic.CHILD_ENV: "1", "PGASR_DISTRIBUTED": "1",
                 "PGASR_NUM_PROCESSES": str(world)})

    def spawn():
        coordinator = f"127.0.0.1:{free_port()}"
        return [subprocess.Popen(
            [sys.executable, "-m", "pg_asr_tpu_torch.cli", *argv,
             "--device", d],
            env={**base, "PGASR_COORDINATOR": coordinator,
                 "PGASR_PROCESS_ID": str(r)})
            for r, d in enumerate(devices)]

    return elastic.supervise(spawn, max_restarts=max_restarts)


@contextlib.contextmanager
def _process_group(args, world: int):
    """The process group of a train or finetune_pg rank: from the
    ``PGASR_*`` variables under ``PGASR_DISTRIBUTED=1``, a group of one
    for a ``--mesh`` of one position, else none."""
    from . import resolve_device
    from .parallel import mesh

    env = os.environ
    if args.mode not in ("train", "finetune_pg"):
        yield
        return
    if env.get("PGASR_DISTRIBUTED") == "1":
        mesh.init_distributed(
            coordinator_address=env.get("PGASR_COORDINATOR"),
            num_processes=(int(env["PGASR_NUM_PROCESSES"])
                           if "PGASR_NUM_PROCESSES" in env else None),
            process_id=(int(env["PGASR_PROCESS_ID"])
                        if "PGASR_PROCESS_ID" in env else None),
            device=resolve_device(args.device))
    elif args.mesh and world == 1:
        mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                              device=resolve_device(args.device))
    try:
        yield
    finally:
        mesh.destroy_distributed()


def preproc(args) -> None:
    """--mode preproc: a LibriSpeech tree into the corpus layout, or the
    text pass over a Common Voice-style corpus; with --units bpe also the
    BPE vocabulary of the train split. Host work only."""
    from .data.text import read_tsv

    if args.librispeech_root:
        from .data.dataset import librispeech_to_corpus

        counts = librispeech_to_corpus(args.librispeech_root,
                                       args.corpus_path)
        print(f"[preproc] LibriSpeech -> {args.corpus_path}: {counts}")
    else:
        from .data.text import preproc_text

        preproc_text(args.corpus_path, args.lang)
        print(f"[preproc] normalized TSVs + alphabet.txt in "
              f"{args.corpus_path}")
    if args.units == "bpe":
        from .data.bpe import train_bpe

        _, rows = read_tsv(os.path.join(args.corpus_path, "train.tsv"))
        tok = train_bpe([r.get("sentence", "") for r in rows],
                        args.bpe_vocab_size or 256)
        tok.save(os.path.join(args.corpus_path, "bpe.vocab"))
        print(f"[preproc] BPE vocabulary ({tok.size} tokens, "
              f"{len(tok.merges)} merges) -> "
              f"{args.corpus_path}/bpe.vocab")


def stream(args, device) -> None:
    """--mode stream: push one audio file through a StreamingTranscriber
    in --block_ms blocks, printing each emitted piece, then the flush and
    (--timestamps) one JSON word timing a line (the JAX CLI's output)."""
    import json

    import numpy as np

    from .data import load_manifest
    from .data.audio import load_audio
    from .data.bpe import load_tokenizer
    from .data.dataset import _resample_linear
    from .decoding.lm import lm_from_manifest
    from .data.native_io import native_available
    from .predict import load_model, model_config
    from .serving import StreamingTranscriber

    if not args.wav:
        raise SystemExit("--mode stream needs --wav <file>")
    if not args.corpus_path:
        raise SystemExit("--mode stream needs --corpus_path (for the "
                         "tokenizer artifacts)")
    cfg = model_config(args.model_path)
    alphabet = load_tokenizer(args.corpus_path, cfg.text.units)
    params, cfg = load_model(args.model_path, alphabet, cfg, device=device,
                             dtype=args.dtype)
    lm_tab = None
    if args.lm_order:
        # the table the offline --decoder beam fuses, from the train split
        lm_tab = lm_from_manifest(
            load_manifest(os.path.join(args.corpus_path, "train.tsv"),
                          os.path.join(args.corpus_path, "clips")),
            alphabet, order=args.lm_order)
    st = StreamingTranscriber(params, cfg, alphabet,
                              chunk_frames=args.chunk_frames,
                              right_context=args.right_context,
                              left_context=args.left_context,
                              timestamps=args.timestamps,
                              decoder=args.decoder,
                              beam_size=args.beam_size or 8, lm=lm_tab,
                              lm_weight=args.lm_weight,
                              length_bonus=args.length_bonus, device=device)
    wave, sr = load_audio(args.wav)
    rate = cfg.features.sample_rate
    if sr != rate:
        wave = _resample_linear(wave, int(round(len(wave) * rate / sr)),
                                native_available())
    block = max(1, args.block_ms * rate // 1000)
    for i in range(0, len(wave), block):
        piece = st.push(np.asarray(wave[i:i + block], np.float32))
        if piece:
            print(piece, end="", flush=True)
    print(st.flush())
    if args.timestamps:
        for w in st.words:
            print(json.dumps(w, ensure_ascii=False))


def export(args, device) -> None:
    """--mode export: the serving program of --model_path, traced on
    `device`, into <model_path>/export/ (exporting.export_model)."""
    from .exporting import export_model

    if not args.model_path:
        raise SystemExit("--mode export needs --model_path")
    platforms = tuple(s.strip() for s in
                      (args.export_platforms or "").split(",") if s.strip())
    export_model(args.model_path, corpus_path=args.corpus_path,
                 batch_size=args.export_batch,
                 max_seconds=args.export_seconds, decoder=args.decoder,
                 beam_size=(args.beam_size or 0), platforms=platforms,
                 quantize=args.export_quantize or "", device=device)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    try:
        world = _mesh_world(args)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    from .utils import elastic

    restarts = (args.max_restarts
                if args.mode in ("train", "finetune_pg")
                and os.environ.get(elastic.CHILD_ENV) != "1" else 0)
    if world > 1 and os.environ.get("PGASR_DISTRIBUTED") != "1":
        return _launch_ranks(argv, world, args.device, restarts, args.mesh)
    if restarts > 0:
        # supervise: this command again as the child (CHILD_ENV marks it);
        # a crash relaunches it and it resumes from model_last, a SIGTERM
        # is forwarded for a graceful stop
        return elastic.run_elastic(
            [sys.executable, "-m", "pg_asr_tpu_torch.cli", *argv],
            max_restarts=args.max_restarts)
    with _process_group(args, world):
        if not args.debug_nans:
            return _run(args)
        from .utils.debug import enable_nan_checks

        # for this run only (the JAX CLI sets jax_debug_nans for its
        # process)
        enable_nan_checks(True)
        try:
            return _run(args)
        finally:
            enable_nan_checks(False)


def _run(args) -> int:
    if args.mode == "preproc":
        if not args.corpus_path:
            raise SystemExit("--mode preproc needs --corpus_path")
        preproc(args)
        return 0
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
            train(args.corpus_path, args.model_path, config=train_config(args),
                  device=str(device), profile_steps=args.profile_steps,
                  fault_step=args.fault_step)
        except NotImplementedError as e:
            raise SystemExit(str(e)) from None
        return 0

    if args.mode == "finetune_pg":
        if not args.corpus_path or not args.model_path:
            raise SystemExit("--mode finetune_pg needs --corpus_path and "
                             "--model_path")
        from .rl.reinforce import finetune_pg

        try:
            finetune_pg(args.corpus_path, args.model_path,
                        num_steps=args.pg_steps,
                        batch_size=args.batch_size or 32,
                        config=pg_config(args),
                        eval_every=args.pg_eval_every, device=str(device))
        except (NotImplementedError, ValueError) as e:
            raise SystemExit(str(e)) from None
        return 0

    if args.mode == "stream":
        try:
            stream(args, str(device))
        except (NotImplementedError, ValueError, FileNotFoundError) as e:
            raise SystemExit(str(e)) from None
        return 0

    if args.mode == "export":
        try:
            export(args, str(device))
        except (NotImplementedError, ValueError, FileNotFoundError) as e:
            raise SystemExit(str(e)) from None
        return 0

    corpus = args.corpus_path or ""
    test_path = args.test_path or os.path.join(corpus, "test.tsv")
    aud_path = args.aud_path or os.path.join(corpus, "clips")
    alphabet = args.alphabet or os.path.join(corpus, "alphabet.txt")
    if args.mode in ("align", "pseudolabel"):
        try:
            if args.mode == "align":
                from .alignment import align_corpus

                align_corpus(test_path, aud_path, alphabet, args.model_path,
                             batch_size=args.batch_size or 32,
                             which_ckpt=args.ckpt, device=str(device))
            else:
                from .selftrain import pseudo_label

                pseudo_label(aud_path, alphabet, args.model_path,
                             out_tsv=args.out_tsv,
                             batch_size=args.batch_size or 32,
                             min_conf=args.min_conf, which_ckpt=args.ckpt,
                             device=str(device))
        except (NotImplementedError, ValueError, FileNotFoundError) as e:
            raise SystemExit(str(e)) from None
        return 0
    from .predict import predict

    # beam eval batches at 128, greedy at 32, as the JAX CLI
    bs = args.batch_size if args.batch_size is not None else (
        128 if args.decoder == "beam" else 32)
    try:
        predict(test_path, aud_path, alphabet, args.model_path,
                batch_size=bs, decoder=args.decoder, which_ckpt=args.ckpt,
                device=str(device), dtype=args.dtype,
                beam_size=args.beam_size, beam_prune=args.beam_prune,
                lm_order=args.lm_order, lm_weight=args.lm_weight,
                length_bonus=args.length_bonus,
                lm_train_tsv=(os.path.join(corpus, "train.tsv")
                              if (args.lm_order and corpus) else None),
                lm_type=args.lm_type, lm_steps=args.lm_steps,
                lm_pass=args.lm_pass, timestamps=args.timestamps)
    except (NotImplementedError, ValueError, FileNotFoundError) as e:
        raise SystemExit(str(e)) from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
