#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg_asr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back to
the CPU or to a kernel's plain version):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the hand-written kernels from pg_asr_tpu_torch/csrc
     (one nvcc per source, started together), then the native WAV decoder
     (native/pgasr_io.cpp, host g++) that the loader uses.
  3. kernels: each kernel vs its plain PyTorch version on the card at
     B=64, T=401, H=256 (5 s of audio, the default hidden size), float32
     and bfloat16, forward and reverse: lstm_fwd in its inference and
     residual forms, lstm_bwd with a random output gradient. Max and mean
     abs errors against stated bounds, each kernel's second launch equal
     bit for bit to its first, CUDA-event times (kernel and plain
     in turns), the time of cuDNN's nn.LSTM at the same shape as a
     yardstick, and the least time the card could take (bound).
  3b. beam kernel: ctc_beam vs the plain hash scan on the card at the
     beam's default batch and width (B=128, T=401, A=28, K=16) on sharp
     posteriors from a seed with ragged frame lengths, for the default
     prune (M=6 symbols per frame) and the exact search (M=18): labels,
     lens, parents and syms identical, nll within a stated bound; the
     n-best mode likewise; CUDA-event times in turns and the bound.
  3c. flash-attention kernel: flash_attn in its inference and residual
     forms vs its plain version (ops/flash_attn.mhsa_plain, with
     residuals=True for o, l and m) on the card at the conformer's
     attention shape at B=64 x 5 s (H=4, T'=201, dh=64), q, k, v read in
     place from a fused (B, T', 3, H, dh) projection, float32 and
     bfloat16, ragged lengths: max abs errors against stated bounds, the
     share of 64 x 64 tile pairs the kernel skips, times in turns with the
     kernels' launches queued behind a sleep kernel (device_ms, so that
     the card's time is measured, not the host's launches), the bound over
     the pairs the segment mask leaves, and F.scaled_dot_product_attention
     with the same boolean mask (without and with inputs that require
     grad), timed the same way.
  3d. flash-attention backward: at phase 3c's shape and inputs, float32
     and bfloat16, flash_attn_bwd_dkv and flash_attn_bwd_dq against
     mhsa_bwd_plain on the plain forward's l, m and a random output
     gradient: max and mean abs errors relative to max|grad|
     against stated bounds (in bf16 a control without the rounding of p
     and ds must exceed the mean bound), CUDA-event times in turns (the
     backward kernels' launches queued behind a sleep kernel, so that the
     card's time is measured, not the host's launches), each kernel's
     bound, the share of 64 x 64 tile pairs the kernels skip, and the
     backward as FlashAttention runs it (di, dkv, dq) beside that of
     F.scaled_dot_product_attention (its autograd.grad minus its forward).
  3e. fused RNN-T joint: joint_fwd and joint_bwd vs their plain versions
     (ops/joint.fused_joint_plain, fused_joint_bwd_plain) at the
     transducer's train shape at B=64 x 5 s (T'=201, U+1=61, J=256, A=28),
     float32 and bfloat16 inputs, ragged frame and label lengths, random
     cotangents on the cells the loss reads: errors against stated bounds
     (the tables absolute, the gradients relative to max|grad|), the
     backward run twice with equal bits, CUDA-event times in turns, each
     kernel's bound, and the port's unfused composition (forward, forward
     + backward) as the yardstick.
  3g. shapes past the first kernels' limits, each launched on its kernel
     (its counter rises by one a call) and held against its plain version
     within the bounds above: lstm_fwd (both forms) and lstm_bwd at phase
     3's B and T with H=512 float32, H=1024 bfloat16 and H=2048 in both
     (U's columns read from L2), timed; bilstm_fwd (both forms) and
     bilstm_bwd at H=1024, both types, each direction equal bit for bit
     to the single-direction kernels, timed in turns beside them;
     joint_fwd / joint_bwd at A=256, J=640 (B=4, T'=51, U=20, both types);
     flash_attn and its backward at dh=128, 256 and 512 (the wide kernels
     in two pieces) at phase 3c's shape, device-timed beside SDPA;
     ctc_beam over A=5000 at K=64 (the block form) and K=16 (the warp
     form), M=6 and exact, best and n-best (B=8, T=101).
  3f. fused-direction BiLSTM: bilstm_fwd (inference and residual forms)
     and bilstm_bwd vs their plain versions on the card at phase 3's shape
     (B=64, T=401, H=256 per direction), float32 and bfloat16, ragged
     lengths, against the phase 3 bounds; each direction equal bit for
     bit to a single-direction launch (lstm_fwd, lstm_bwd), the backward
     run twice (equal bits); CUDA-event times in turns (A, B, .., B, A) of
     the fused kernel, 2 x lstm_fwd / lstm_bwd on one stream, cuDNN's
     bidirectional nn.LSTM and the plain version; the bound. Then
     bilstm_layer(fuse_directions=True) at the flagship's first layer
     (input 512) under autograd (one residual bilstm_fwd and one
     bilstm_bwd launch, no single-direction launch) and without (one
     bilstm_fwd), its output (equal bits) and gradients against
     fuse_directions=False (which launches 2 lstm_fwd without grad, 2
     residual lstm_fwd and 2 lstm_bwd under autograd).
  4. predict slice: batch transcription through the port's CLI
     (`--mode predict --device cuda`, default batch 32) of 96 synthetic
     utterances of 1-5 s with the full-width default BiLSTM-CTC (random
     weights from a seed); checks predicted.txt, CER/WER, that every
     layer of every batch went through the LSTM kernels of the encoder's
     route (models/bilstm_ctc.py fuse_directions: one bilstm_fwd a layer,
     or lstm_fwd a direction), and one batch's log-probs against the
     plain recurrence; times the forward at B=64 x 5 s. Then `--decoder
     beam` (default batch 128, K=16, prune 6: one batch): the same
     checks, one ctc_beam launch per batch, and the kernel against the
     plain scan on that batch's log-probs.
  5. train slice: `--mode train --device cuda` through the CLI, one epoch
     of the synthetic train split (576 utterances, 18 steps at the default
     batch 32) with validation on dev; checks the launch counts of the
     route's residual forward and backward (per layer, or per direction,
     each step) and of its inference forward (each dev batch), the
     artifacts and finite losses, a resumed
     second epoch, and `--mode predict` on the trained model, greedy and
     beam; then one
     batch's loss and every parameter gradient, kernel path vs plain path,
     with dropout 0; then times one full train step at B=64 x 5 s in
     float32 and bfloat16.
  6. attention slices: for the conformer-CTC and the transformer-CTC at
     their full default width (6 layers, d_model 256, 4 heads, random
     weights from a seed) with flash_attention in config.json, `--mode
     predict` through the CLI, greedy (batch 32, 3 batches) and beam
     (batch 128, 1 batch): outputs checked and 6 flash_attn launches per
     batch (and 0 with flash_attention false); one batch's log-probs, the
     kernel against the plain attention; the forward at B=64 x 5 s with
     flash_attention on and off, float32 and bfloat16.
  7. attention training slices: for the conformer-CTC and the
     transformer-CTC at full default width, `--mode train --model F
     --flash_attention` through the CLI, one epoch (18 steps at batch 32,
     3 dev batches): exactly 6 residual flash_attn, 6 flash_attn_bwd_dkv
     and 6 flash_attn_bwd_dq launches per step and 6 inference-form
     launches per dev batch, finite losses, the artifacts; a resumed second
     epoch that omits --model and --flash_attention and keeps the family
     and its config; `--mode predict` on the trained model, greedy and
     beam. Then one batch's loss and every parameter gradient, kernel path
     vs plain path (dropout 0); one --remat step (12 residual forwards, the
     same gradients as without remat at dropout 0.1); the train step at
     B=64 x 5 s in float32 and bfloat16, flash_attention on and off in
     turns, with a profiler breakdown by kernel group.
  8. transducer training slice: the RNN-T at full default width
     (conformer encoder, 6 blocks, d_model 256, flash_attention;
     prediction net 128/256, joint 256, vocab 28, random weights from a
     seed): one epoch through the CLI (`--mode train --model transducer
     --flash_attention`, the default unfused joint: no joint launch), one
     through train(config=...) with fused_joint (exactly one joint_fwd and
     one joint_bwd launch per step, one joint_fwd per dev batch), a CLI
     resume that keeps fused_joint from config.json; one batch's loss and
     every gradient, kernel vs plain path (dropout 0); one kernel-path step
     with the BiLSTM and the transformer encoders; the train step at
     B=64 x 5 s, fused and unfused joint in turns, float32 and bfloat16,
     with a profiler breakdown (the joint kernels a group of their own) and
     the lattice loss timed alone.
  9. transducer transcription: `--mode predict` through the CLI on the
     transducer phase 8 trained, greedy (batch 32, 3 batches) and beam
     (batch 128, K=16, 1 batch): predicted.txt, a finite CER/WER, 6
     flash_attn launches per batch and no other kernel (the decoders run
     the unfused joint per frame); one batch's greedy labels, beam labels
     and nll, kernel path vs plain path; the encoder and the decoders
     timed apart, greedy at B=64 x 5 s and beam at B=128 x 5 s (host
     clock and profiler device time).
 10. policy-gradient slice: `--mode finetune_pg --device cuda` through
     the CLI on the BiLSTM-CTC phase 5 trained, REINFORCE for 20 steps at
     the default batch 32 with the dev CER every 10 (exactly 3 residual
     bilstm_fwd and 3 bilstm_bwd launches a step, 3 bilstm_fwd a dev batch;
     20 finite rewards, two dev CERs, model_last with epoch -1), a rerun to
     30 that resumes at 20, `--mode predict` on the result; MWER with K=4 on
     a copy of the supervised model (one ctc_beam launch a step as well);
     one batch's PG loss and every parameter gradient, kernel path vs plain
     path, for both objectives on the same paths and the same n-best (the
     n-best of ctc_beam identical to the plain scan's); the PG step at B=64
     x 5 s, both objectives, float32 and bfloat16, beside phase 5's
     supervised step, with the LSTM kernels at phase 3f's times, a profiler
     breakdown and the idle share, and the reward DP's host ms and device
     ops and the n-best launch timed alone. Then MWER through the CLI on
     the transducer phase 8 trained (fused_joint): a joint_fwd and a
     joint_bwd launch each for the n-best re-scoring and for the anchor, a
     step, and finite rewards.
 11. the supervised training recipe: `--mode train --device cuda` through
     the CLI for the full-width BiLSTM-CTC with every option (SpecAugment,
     speed 0.9-1.1, noise 0.1, gain 3 dB, --accum_steps 2, --ema_decay
     0.999, --keep_ckpts 2, --save_every_steps 5, --val_metric cer,
     --loader_threads 2, --cache_audio_mb 64, --profile_steps 2, 3
     epochs): 3 residual bilstm_fwd + 3 bilstm_bwd a micro-batch, 3 + 3
     bilstm_fwd a dev batch (loss and greedy CER), finite losses,
     ema_params in model_best and model_last, two rolling snapshots, the
     trace, the native WAV decoder; the same command in a subprocess
     (`python3 chip_smoke.py --recipe-worker ...`) stopped by SIGTERM after
     its first mid-epoch save (model_last with batches_done, exit 0), then
     resumed: the uninterrupted run's batches and step count, epoch losses
     within RESUME_LOSS_REL; `--mode predict --ckpt avg`, greedy and beam;
     one emit of 2 augmented micro-batches with EMA, kernel vs plain path;
     wave_augment, spec_augment, the EMA update and the recipe's
     micro-step timed at B=64 x 5 s, float32 and bfloat16, and the
     loader's host ms per batch (Python or native decode, 0 or 2 threads,
     the cache); examples/pg_improves_cer.py's recipe on the port's
     phonetic corpus (16 epochs, then 120 REINFORCE steps) with its test
     CERs.
 12. prints its total wall time, a JSON line of kernel results (with each
     kernel's launches on the policy-gradient and recipe paths), then as
     the last line {"ok": true, "device": {...}}.

It imports only the port (pg_asr_tpu_torch) and fails if any module of jax,
flax or the JAX package (pg_asr_tpu) was imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
# transcripts drawn from a pangram's words: all 26 letters + space, so the
# CTC head has the width of an English character alphabet (28 with blank)
WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog")
# the synthetic corpus splits n_utts into 3/4 train, 1/8 dev, 1/8 test:
# 576 / 96 / 96 utterances, i.e. 18 train steps and 3 dev and 3 test
# batches at the CLI's default batch size of 32
N_UTTS = 768
B, T, H = 64, 401, 256  # 5 s at hop 200, the default hidden size
WAVE_SAMPLES = 80000  # 5 s at 16 kHz: T = 80000 // 200 + 1 = 401 frames
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by
# operand type (float32 outside the tensor cores, bfloat16 on them)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# kernel vs plain bounds at B=64, T=401, H=256 (max and mean abs error).
# float32 differs only in summation order (max ~1.5e-7 forward).
# bfloat16: both round their output to bf16, so a slightly different sum can
# land one ulp away; 4e-3 is one ulp in [0.5, 1). The max cannot tell whether
# the kernel rounds h to bf16 before the product as the Pallas kernel does;
# the mean can (~3e-7 with the rounding, ~1.2e-5 without), and its bound lies
# between. The script checks that a control run without that rounding
# exceeds the mean bound. out and hprev are h values and share the bounds.
BOUNDS = {"float32": {"max": 1e-5, "mean": 1e-7},
          "bfloat16": {"max": 4e-3, "mean": 1e-6}}
# cprev (the float32 c carry): float32 as out; in bf16 the carries differ
# where a bf16-rounded h differed by an ulp, by ~1e-4 at most, ~1e-6 on mean
CPREV_BOUNDS = {"float32": {"max": 1e-5, "mean": 1e-7},
                "bfloat16": {"max": 1e-3, "mean": 1e-5}}
# backward, given the plain forward's residuals. dxp: float32 summation
# order only. bfloat16: dxp is dpre rounded to bf16, so a different f32 sum
# can round one ulp away; relative to max|dxp| one ulp of the largest value
# is at most 2^-7. The mean tells apart a backward that skips the
# dpre_mx rounding before dU and dh: ~9e-7 with the rounding, ~9.1e-6 for a
# plain control run without it (CPU estimate at this shape), and the bound
# lies between; the script checks the control exceeds it. dU is a float32
# sum of B*T = 25 664
# products rounded once at the end: bounded relative to max|dU|, float32
# by summation order (~3e-6 measured in development), bfloat16 by one ulp
# of the largest entry (2^-7).
BWD_BOUNDS = {"float32": {"dxp_max": 1e-5, "dxp_mean": 1e-7,
                          "du_rel": 2e-5},
              "bfloat16": {"dxp_rel": 2.0 ** -7, "dxp_mean": 3e-6,
                           "du_rel": 2.0 ** -7}}
# end-to-end log-probs (3 BiLSTM layers + head + log-softmax, float32)
LOGPROB_BOUND = 1e-3
# one train batch, kernel path vs plain path, float32, dropout 0: loss
# relative 1e-4; each parameter gradient max abs error relative to its
# max |grad| 1e-3 (float32 sums in other orders through 3 layers, the head,
# and two CTC implementations: F.ctc_loss vs the plain alpha recursion)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-4, 1e-3
# one PG batch (phase 10), kernel path vs plain path, float32, on the same
# sampled paths and the same n-best (fixed from the kernel path's
# log-probs, so the integer rewards and risks are equal): the train step's
# bounds. REINFORCE adds per-path sums of the same log-probs; MWER
# re-scores the n-best with F.ctc_loss against the plain recursion, which
# moves each hypothesis's weight by float32 rounding only
PG_LOSS_REL, PG_GRAD_REL = TRAIN_LOSS_REL, TRAIN_GRAD_REL
# beam search, kernel vs plain scan: the two run the same float32
# operations in the same order (logaddexp as max + log1p(exp(min - max)),
# the merge as max + log(sum exp)), so only expf/log1pf of nvcc's and of
# torch's CUDA build could round apart, by an ulp per operation; over 401
# frames that bounds the nll's relative error by ~1e-6. Labels, lens,
# parents and syms must be identical.
BEAM_NLL_REL = 1e-6
BEAM_B, BEAM_A, BEAM_K = 128, 28, 16  # the CLI's beam batch, vocab, width
# the attention of the conformer and transformer defaults (d_model 256, 4
# heads) at B=64 x 5 s: T' = ceil(401 / 2) frames after frame stacking
ATTN_H, ATTN_T, ATTN_DH = 4, 201, 64
# flash_attn vs its plain version, max abs error. float32: the online
# softmax over 64-key tiles and another summation order move the outputs
# (convex mixes of v, |v| < ~5) by float32 rounding only. bfloat16, relative
# to max|v|: p is rounded to bf16 against its tile's running max (the plain
# version against the row's max) and the output to bf16, at most 2^-9
# relative each, so the two may differ by a few ulps: 2^-6.
FLASH_BOUNDS = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
# the residual form's l (a float32 sum of up to T' terms in [0, 1], online
# against tile maxima): relative 1e-5; m (the row max of the same float32
# scores summed in another order): abs 1e-5
FLASH_L_REL, FLASH_M_ABS = 1e-5, 1e-5
# flash_attn_bwd_dkv / _dq vs mhsa_bwd_plain on the same l, m, do: abs
# errors relative to max|grad| of each of dq, dk, dv. float32: summation
# order only; max 2e-5, mean 2e-7 (a CPU estimate at this shape, float64
# vs float32 sums: max 8e-7, mean 1.3e-8). bfloat16: p and ds are rounded
# to bf16 at the library's points in both, from scores summed in another
# order, and each output is rounded to bf16, so the max may reach two ulps
# of the largest value (2^-7). The mean tells apart a backward that skips
# the rounding of p and ds (CPU estimate: ~6e-5 relative for a control
# without it, ~2e-8 with it); its bound 1e-6 lies between, and the script
# checks that the control exceeds it.
FLASH_BWD_BOUNDS = {"float32": {"max": 2e-5, "mean": 2e-7},
                    "bfloat16": {"max": 2.0 ** -7, "mean": 1e-6}}
# transducer decoding, kernel path vs plain path on one batch of the
# trained model (conformer encoder, flash attention vs plain attention,
# float32): the encoder states differ by float32 summation order only, so
# labels must be equal; the beam's nll (a sum over ~200 frames of
# log-probs) within relative 1e-4
TRANSDUCER_NLL_REL = 1e-4
# the transducer's joint at B=64 x 5 s: T'=201 frames, labels of 60
# symbols, the default joint_dim 256 and vocab 28
JOINT_U, JOINT_J, JOINT_A = 60, 256, 28
# joint_fwd / joint_bwd vs their plain versions. Both compute in float32
# whatever the inputs' type (bf16 inputs widen exactly), so the tables
# differ only by float32 summation order (the head's 256 products: the
# kernel sums them in order, the plain version through cuBLAS) and the
# expf/logf/tanhf of nvcc vs torch: max 2e-5, mean 1e-6 absolute (log-probs
# of magnitude ~3). The gradients, relative to max|grad| of each: float32
# by summation order over up to B*T'*(U+1) = 784 704 cells (dW, db), max
# 2e-5, mean 1e-6; bfloat16: each is a float32 sum rounded once to bf16 in
# both, so the two may round one ulp apart, which relative to the largest
# value is at most 2^-7; such splits are rare, mean 1e-4.
JOINT_BOUNDS = {
    "float32": {"lp_max": 2e-5, "lp_mean": 1e-6, "grad_max": 2e-5,
                "grad_mean": 1e-6},
    "bfloat16": {"lp_max": 2e-5, "lp_mean": 1e-6, "grad_max": 2.0 ** -7,
                 "grad_mean": 1e-4}}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """As time_ms, but the launches queue behind a sleep kernel long enough
    for the host to enqueue all of them: the events then time the card's
    work back to back, not the rate at which Python launches kernels of
    tens of microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 100000)  # > 2 x host_s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, plain_reps: int, kernel_reps: int,
             kernel_timer=time_ms):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, plain_reps)
    k1 = kernel_timer(kernel, kernel_reps)
    k2 = kernel_timer(kernel, kernel_reps)
    p2 = time_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(flops: float, nbytes: float, dtype: str):
    """Least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate of the operand type -> (ms, bound_by)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    import torch

    check(torch.cuda.is_available(), "no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # the plain references run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def phase_build():
    from pg_asr_tpu_torch import _build
    from pg_asr_tpu_torch.data import native_io

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)} in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check(native_io.native_available(), "the native WAV decoder did not "
          f"build from {native_io.SOURCE}")
    print(f"[build] {os.path.relpath(native_io.library_path())} (host C++, "
          f"the native WAV decoder) in {time.perf_counter() - t0:.1f} s")


def kernel_inputs(dev):
    import torch

    g = torch.Generator().manual_seed(SEED)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0], lens[1] = T, 1
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
    xp = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    U = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    gy = torch.randn(B, T, H, generator=g).to(dev)
    return mask, xp, U, gy, int(lens.sum())


def _errs(got, ref):
    d = (got.float() - ref.float()).abs()
    return d.max().item(), d.mean().item()


def phase_kernels(dev):
    """lstm_fwd (both forms) and lstm_bwd vs their plain versions."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_bwd_plain, lstm_scan_plain

    mask, xp32, U32, gy32, valid = kernel_inputs(dev)
    fwd, res, bwd = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        xp, U, gy = xp32.to(dtype), U32.to(dtype), gy32.to(dtype)
        name = str(dtype).split(".")[1]
        s = xp.element_size()
        # bytes: the function needs the per-step inputs (xp; in the
        # backward also hprev, cprev, gy) on the valid steps only, since a
        # padded step freezes the carry and writes zeros; it reads U and the
        # whole mask and writes its outputs at every step (out; hprev, cprev
        # in the residual form; dxp, dU in the backward)
        io_fwd = ((valid * 4 * H + H * 4 * H + B * T * H) * s + B * T * 4)
        io_res = io_fwd + B * T * H * (s + 4)
        io_bwd = (valid * H * (4 * s + s + 4 + s) + 2 * H * 4 * H * s
                  + B * T * 4 + B * T * 4 * H * s)
        # operations on the valid steps: the (B,H)x(H,4H) product (2 flops
        # per multiply-add) and ~30 elementwise ops per unit; the backward
        # does three products and ~60 elementwise ops
        f_fwd = valid * (2 * H * 4 * H + 30 * H)
        f_bwd = valid * (3 * 2 * H * 4 * H + 60 * H)
        for reverse in (False, True):
            d = "reverse" if reverse else "forward"
            tag = f"B={B} T={T} H={H} {name} {d}"
            # --- inference form
            bound = BOUNDS[name]
            got = cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)
            again = cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)
            ref_out, ref_h, ref_c = lstm_scan_plain(xp, U, mask, reverse,
                                                    residuals=True)
            torch.cuda.synchronize()
            err, mean_err = _errs(got, ref_out)
            check(got.dtype == dtype and got.shape == (B, T, H),
                  "kernel output dtype/shape")
            check(bool(torch.equal(got, again)),
                  f"lstm_fwd {name} reverse={reverse}: two launches differ")
            check(bool(torch.all(got[mask == 0] == 0)),
                  "kernel output not zero at padded steps")
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_plain(xp, U, mask, reverse),
                lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse), 3, 20)
            b_ms, b_by = bound_ms(f_fwd, io_fwd, name)
            case = {"dtype": name, "reverse": reverse, "max_abs_err": err,
                    "mean_abs_err": mean_err, "bound": bound, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}
            ctrl = ""
            if dtype == torch.bfloat16:
                # control: the plain version with h kept in float32
                skip = lstm_scan_plain(xp, U.float(), mask, reverse)
                case["control_mean_abs_err"] = _errs(skip, ref_out)[1]
                ctrl = (f", control without h rounding: mean "
                        f"{case['control_mean_abs_err']:.3e}")
            print(f"[kernel] lstm_fwd {tag}: max_abs_err {err:.3e} (bound "
                  f"{bound['max']:.0e}), mean_abs_err {mean_err:.3e} (bound "
                  f"{bound['mean']:.0e}){ctrl}; kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
            check(err <= bound["max"] and mean_err <= bound["mean"],
                  f"lstm_fwd {name} reverse={reverse} disagrees with the "
                  f"plain version: max {err}, mean {mean_err} > {bound}")
            check(case.get("control_mean_abs_err", math.inf) > bound["mean"],
                  f"the {name} mean bound does not tell apart a recurrence "
                  "that skips the rounding of h")
            fwd.append(case)

            # --- residual form
            out, hprev, cprev = cuda_lstm.lstm_scan_residual_cuda(
                xp, U, mask, reverse)
            torch.cuda.synchronize()
            check(hprev.dtype == dtype and cprev.dtype == torch.float32
                  and hprev.shape == cprev.shape == (T, B, H),
                  "residual dtypes/shapes")
            check(bool(torch.equal(out, got)),
                  "the residual form's out differs from the inference form's")
            errs = {"out": _errs(out, ref_out), "hprev": _errs(hprev, ref_h),
                    "cprev": _errs(cprev, ref_c)}
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_plain(xp, U, mask, reverse,
                                        residuals=True),
                lambda: cuda_lstm.lstm_scan_residual_cuda(xp, U, mask,
                                                          reverse), 3, 20)
            b_ms, b_by = bound_ms(f_fwd, io_res, name)
            res.append({"dtype": name, "reverse": reverse, "errors": errs,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by})
            print(f"[kernel] lstm_fwd residual {tag}: " + ", ".join(
                f"{k} max {v[0]:.3e} mean {v[1]:.3e}" for k, v in errs.items())
                + f"; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                f"{b_ms:.3f} ms ({b_by})")
            for k in ("out", "hprev", "cprev"):
                bd = CPREV_BOUNDS[name] if k == "cprev" else bound
                check(errs[k][0] <= bd["max"] and errs[k][1] <= bd["mean"],
                      f"lstm_fwd residual {name} {d}: {k} {errs[k]} > {bd}")

            # --- backward, on the plain forward's residuals
            bb = BWD_BOUNDS[name]
            dxp, dU = cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, ref_h, ref_c,
                                                   gy, reverse)
            r_dxp, r_dU = lstm_scan_bwd_plain(xp, U, mask, ref_h, ref_c, gy,
                                              reverse)
            torch.cuda.synchronize()
            check(dxp.dtype == dU.dtype == dtype, "backward dtypes")
            check(bool(torch.all(dxp[mask == 0] == 0)),
                  "dxp not zero at padded steps")
            e_dxp, e_du = _errs(dxp, r_dxp), _errs(dU, r_dU)
            dxp_ref_max = r_dxp.float().abs().max().item()
            du_ref_max = r_dU.float().abs().max().item()
            k_ms, p_ms = in_turns(
                lambda: lstm_scan_bwd_plain(xp, U, mask, ref_h, ref_c, gy,
                                            reverse),
                lambda: cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, ref_h,
                                                     ref_c, gy, reverse),
                2, 10)
            b_ms, b_by = bound_ms(f_bwd, io_bwd, name)
            case = {"dtype": name, "reverse": reverse,
                    "dxp_max_abs_err": e_dxp[0], "dxp_mean_abs_err": e_dxp[1],
                    "dxp_ref_max": dxp_ref_max, "du_max_abs_err": e_du[0],
                    "du_mean_abs_err": e_du[1], "du_ref_max": du_ref_max,
                    "bound": bb, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
            dxp_max = bb.get("dxp_max", bb.get("dxp_rel", 0) * dxp_ref_max)
            ctrl = ""
            if dtype == torch.bfloat16:
                # control: the plain backward without the dpre_mx rounding
                # (U widened to float32, so dpre stays float32 for dU, dh)
                c_dxp, _ = lstm_scan_bwd_plain(xp, U.float(), mask, ref_h,
                                               ref_c, gy, reverse)
                case["control_dxp_mean_abs_err"] = _errs(c_dxp, r_dxp)[1]
                ctrl = (f", control without dpre_mx rounding: mean "
                        f"{case['control_dxp_mean_abs_err']:.3e}")
            print(f"[kernel] lstm_bwd {tag}: dxp max {e_dxp[0]:.3e} (bound "
                  f"{dxp_max:.3e}) mean {e_dxp[1]:.3e} (bound "
                  f"{bb['dxp_mean']:.0e}){ctrl}; dU max {e_du[0]:.3e} (bound "
                  f"{bb['du_rel'] * du_ref_max:.3e} = {bb['du_rel']:.1e} x "
                  f"max|dU| {du_ref_max:.3e}) mean {e_du[1]:.3e}; kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by})")
            check(e_dxp[0] <= dxp_max and e_dxp[1] <= bb["dxp_mean"],
                  f"lstm_bwd {name} {d}: dxp {e_dxp} out of bounds")
            check(e_du[0] <= bb["du_rel"] * du_ref_max,
                  f"lstm_bwd {name} {d}: dU {e_du} out of bounds")
            check(case.get("control_dxp_mean_abs_err", math.inf)
                  > bb["dxp_mean"],
                  f"the {name} dxp mean bound does not tell apart a backward "
                  "that skips the dpre_mx rounding")
            bwd.append(case)
    return {"fwd": fwd, "res": res, "bwd": bwd}


def cudnn_lstm(dev, bidirectional: bool = False):
    """cuDNN nn.LSTM at the kernels' shape, float32, full-length batch, one
    direction or both: the one PyTorch call that computes the same
    recurrence (it also does the x@W input projection, from a 512-wide
    input, which the kernels receive precomputed). A yardstick only; the
    port never calls it. -> {"fwd_ms": no grad, "train_fwd_ms": the
    training forward, "bwd_ms": the backward}: callables to time."""
    import torch

    lstm = torch.nn.LSTM(512, H, batch_first=True,
                         bidirectional=bidirectional).to(dev)
    n_dir = 2 if bidirectional else 1
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(B, T, 512, generator=g).to(dev).requires_grad_(True)
    gy = torch.randn(B, T, n_dir * H, generator=g).to(dev)

    def infer():
        with torch.no_grad():
            lstm(x)

    def train_fwd():
        lstm(x)

    out, _ = lstm(x)
    params = [x, *lstm.parameters()]

    def backward():
        torch.autograd.grad(out, params, gy, retain_graph=True)

    return {"fwd_ms": infer, "train_fwd_ms": train_fwd, "bwd_ms": backward}


def phase_library(dev):
    """cuDNN's one-direction nn.LSTM timed: the yardstick of lstm_fwd /
    lstm_bwd (phase 3f times the bidirectional one in turns with the fused
    kernels)."""
    lib = {k: time_ms(f, 20) for k, f in cudnn_lstm(dev).items()}
    print(f"[library] cuDNN nn.LSTM(512, {H}) B={B} T={T} float32, one "
          f"direction: forward {lib['fwd_ms']:.3f} ms (no grad), "
          f"{lib['train_fwd_ms']:.3f} ms (training), backward "
          f"{lib['bwd_ms']:.3f} ms")
    return lib


def turns(fns: dict, reps: dict) -> dict:
    """{name: ms}: each callable timed in the order given, then in the
    reverse order (A, B, .., B, A), the two readings averaged."""
    got = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        got[k].append(time_ms(fns[k], reps[k]))
    return {k: sum(v) / 2 for k, v in got.items()}


def bi_inputs(dev):
    """Phase 3's inputs as the forward direction, a second draw as the
    backward one: mask, xpf, xpb, Uf, Ub, gy (B, T, 2H), valid steps."""
    import torch

    mask, xpf, Uf, gyf, valid = kernel_inputs(dev)
    g = torch.Generator().manual_seed(SEED + 1)
    xpb = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    Ub = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    gy = torch.cat([gyf, torch.randn(B, T, H, generator=g).to(dev)], -1)
    return mask, xpf, xpb, Uf, Ub, gy, valid


def lstm_counts() -> dict:
    from pg_asr_tpu_torch.ops import cuda_lstm as c

    return {"lstm_fwd": c.LAUNCHES, "lstm_fwd_residual": c.RES_LAUNCHES,
            "lstm_bwd": c.BWD_LAUNCHES, "bilstm_fwd": c.BI_LAUNCHES,
            "bilstm_fwd_residual": c.BI_RES_LAUNCHES,
            "bilstm_bwd": c.BI_BWD_LAUNCHES}


def route_counters():
    """The counters the BiLSTM encoder (models/bilstm_ctc.py encode: both
    directions of a layer in one walk) moves, and the launches of each in
    one forward of the default model: (inference, residual, backward, per
    forward)."""
    from pg_asr_tpu_torch.config import Config

    return ("bilstm_fwd", "bilstm_fwd_residual", "bilstm_bwd",
            Config().model.num_layers)


def phase_bilstm(dev):
    """3f: bilstm_fwd (both forms) and bilstm_bwd vs their plain versions,
    each direction vs a single-direction launch (equal bits), the backward
    twice (equal bits); the fused kernel, two single-direction launches,
    cuDNN's bidirectional nn.LSTM and the plain version timed in turns;
    the bound. Then bilstm_layer(fuse_directions=True) at the flagship's
    first layer, under autograd and without, against
    fuse_directions=False."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm as cl
    from pg_asr_tpu_torch.ops.lstm import (bilstm_layer,
                                           bilstm_scan_bwd_plain,
                                           bilstm_scan_plain)

    mask, *inputs32, valid = bi_inputs(dev)
    lib = cudnn_lstm(dev, bidirectional=True)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        xpf, xpb, Uf, Ub, gy = (t.to(dtype) for t in inputs32)
        args = (xpf, xpb, Uf, Ub, mask)
        name = str(dtype).split(".")[1]
        s = xpf.element_size()
        tag = f"B={B} T={T} H={H} x 2 directions {name}"
        # twice phase 3's work and bytes; the mask is read once
        io_fwd = 2 * (valid * 4 * H + H * 4 * H + B * T * H) * s + B * T * 4
        io_res = io_fwd + 2 * B * T * H * (s + 4)
        io_bwd = (2 * (valid * H * (4 * s + s + 4 + s) + 2 * H * 4 * H * s
                       + B * T * 4 * H * s) + B * T * 4)
        f_fwd = 2 * valid * (2 * H * 4 * H + 30 * H)
        f_bwd = 2 * valid * (3 * 2 * H * 4 * H + 60 * H)
        case = {"dtype": name}

        # --- forward, both forms
        y = cl.bilstm_scan_cuda(*args)
        res = cl.bilstm_scan_residual_cuda(*args)
        ref = bilstm_scan_plain(*args, residuals=True)
        sf = cl.lstm_scan_residual_cuda(xpf, Uf, mask, False)
        sb = cl.lstm_scan_residual_cuda(xpb, Ub, mask, True)
        torch.cuda.synchronize()
        check(y.dtype == dtype and y.shape == (B, T, 2 * H)
              and torch.equal(res[0], y),
              "bilstm_fwd: output dtype/shape, or the forms' y differ")
        errs = {k: _errs(g, r) for k, g, r in
                zip(("y", "hpf", "cpf", "hpb", "cpb"), res, ref)}
        for k, (mx, mean) in errs.items():
            bd = CPREV_BOUNDS[name] if k.startswith("c") else BOUNDS[name]
            check(mx <= bd["max"] and mean <= bd["mean"],
                  f"bilstm_fwd {name}: {k} max {mx} mean {mean} > {bd}")
        # each direction equals a single-direction launch bit for bit
        single = (torch.cat([sf[0], sb[0]], -1), sf[1], sf[2], sb[1], sb[2])
        equal = {k: torch.equal(g, r) for k, g, r in
                 zip(("y", "hpf", "cpf", "hpb", "cpb"), res, single)}
        check(all(equal.values()),
              f"bilstm_fwd {name}: bits differ from two lstm_fwd launches: "
              f"{equal}")
        fwd_t = turns({
            "kernel": lambda: cl.bilstm_scan_cuda(*args),
            "two": lambda: (cl.lstm_scan_cuda(xpf, Uf, mask, False),
                            cl.lstm_scan_cuda(xpb, Ub, mask, True)),
            "cudnn": lib["fwd_ms"],
            "plain": lambda: bilstm_scan_plain(*args)},
            {"kernel": 20, "two": 20, "cudnn": 10, "plain": 1})
        res_t = turns({
            "kernel": lambda: cl.bilstm_scan_residual_cuda(*args),
            "two": lambda: (cl.lstm_scan_residual_cuda(xpf, Uf, mask, False),
                            cl.lstm_scan_residual_cuda(xpb, Ub, mask, True)),
            "cudnn": lib["train_fwd_ms"],
            "plain": lambda: bilstm_scan_plain(*args, residuals=True)},
            {"kernel": 20, "two": 20, "cudnn": 10, "plain": 1})
        b_ms, b_by = bound_ms(f_fwd, io_fwd, name)
        br_ms, br_by = bound_ms(f_fwd, io_res, name)
        case.update(fwd_errors=errs, fwd_equal_to_lstm_fwd=equal,
                    fwd_ms=fwd_t["kernel"], fwd_plain_ms=fwd_t["plain"],
                    two_lstm_fwd_ms=fwd_t["two"], fwd_cudnn_ms=fwd_t["cudnn"],
                    fwd_bound_ms=b_ms, fwd_bound_by=b_by,
                    res_ms=res_t["kernel"], res_plain_ms=res_t["plain"],
                    two_lstm_fwd_residual_ms=res_t["two"],
                    res_cudnn_ms=res_t["cudnn"], res_bound_ms=br_ms,
                    res_bound_by=br_by)
        print(f"[kernel] bilstm_fwd {tag}: " + ", ".join(
            f"{k} max {v[0]:.3e} mean {v[1]:.3e}" for k, v in errs.items())
            + f" (bounds {BOUNDS[name]}, c {CPREV_BOUNDS[name]}); each "
            "direction equal bit for bit to lstm_fwd; in turns: inference "
            f"form {fwd_t['kernel']:.3f} ms (2 x lstm_fwd {fwd_t['two']:.3f}, "
            f"cuDNN bidirectional {fwd_t['cudnn']:.3f} (f32), plain "
            f"{fwd_t['plain']:.3f}, bound {b_ms:.3f} {b_by}); residual form "
            f"{res_t['kernel']:.3f} ms (2 x lstm_fwd residual "
            f"{res_t['two']:.3f}, cuDNN training forward "
            f"{res_t['cudnn']:.3f}, plain {res_t['plain']:.3f}, bound "
            f"{br_ms:.3f} {br_by})")

        # --- backward, on the plain forward's residuals
        bwd = cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        again = cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        r_bwd = bilstm_scan_bwd_plain(*args, *ref[1:], gy)
        gyf, gyb = gy[..., :H].contiguous(), gy[..., H:].contiguous()
        s_f = cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf, False)
        s_b = cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb, True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(bwd, again)),
              f"bilstm_bwd {name}: two runs differ")
        bequal = {k: torch.equal(g_, r_) for k, g_, r_ in zip(
            ("dxpf", "dxpb", "dUf", "dUb"), bwd, (s_f[0], s_b[0], s_f[1],
                                                  s_b[1]))}
        check(all(bequal.values()),
              f"bilstm_bwd {name}: bits differ from two lstm_bwd launches: "
              f"{bequal}")
        bb = BWD_BOUNDS[name]
        berrs = {}
        for k, g_, r_ in zip(("dxpf", "dxpb", "dUf", "dUb"), bwd, r_bwd):
            ref_max = r_.float().abs().max().item()
            mx, mean = _errs(g_, r_)
            if k.startswith("dxp"):
                lim = bb.get("dxp_max", bb.get("dxp_rel", 0) * ref_max)
                ok = mx <= lim and mean <= bb["dxp_mean"]
            else:
                lim = bb["du_rel"] * ref_max
                ok = mx <= lim
            berrs[k] = (mx, mean, lim)
            check(ok, f"bilstm_bwd {name}: {k} max {mx} mean {mean} out of "
                      f"bounds ({lim}, {bb}) against the plain version")
        bwd_t = turns({
            "kernel": lambda: cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy),
            "two": lambda: (
                cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf,
                                      False),
                cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb,
                                      True)),
            "cudnn": lib["bwd_ms"],
            "plain": lambda: bilstm_scan_bwd_plain(*args, *ref[1:], gy)},
            {"kernel": 10, "two": 10, "cudnn": 10, "plain": 1})
        bb_ms, bb_by = bound_ms(f_bwd, io_bwd, name)
        case.update(bwd_errors=berrs, bwd_equal_to_lstm_bwd=bequal,
                    bwd_ms=bwd_t["kernel"], bwd_plain_ms=bwd_t["plain"],
                    two_lstm_bwd_ms=bwd_t["two"], bwd_cudnn_ms=bwd_t["cudnn"],
                    bwd_bound_ms=bb_ms, bwd_bound_by=bb_by)
        print(f"[kernel] bilstm_bwd {tag}: " + ", ".join(
            f"{k} max {v[0]:.3e} (bound {v[2]:.3e}) mean {v[1]:.3e}"
            for k, v in berrs.items()) + "; equal bits run to run and to two "
            f"lstm_bwd calls; in turns: kernel {bwd_t['kernel']:.3f} ms (2 x "
            f"lstm_bwd {bwd_t['two']:.3f}, cuDNN bidirectional backward "
            f"{bwd_t['cudnn']:.3f} (f32), plain {bwd_t['plain']:.3f}, bound "
            f"{bb_ms:.3f} {bb_by})")
        train_gain = (res_t["two"] + bwd_t["two"]) - (res_t["kernel"]
                                                      + bwd_t["kernel"])
        print(f"[kernel] fused directions {name} (the encoder's route, "
              f"models/bilstm_ctc.py): fused inference form faster by "
              f"{fwd_t['two'] - fwd_t['kernel']:.3f} ms than 2 x lstm_fwd, "
              f"fused residual form + backward faster by {train_gain:.3f} "
              f"ms than 2 x lstm_fwd residual + 2 x lstm_bwd")
        cases.append(case)

    # the layer at the flagship's first layer (input 512), float32
    I = 512
    g = torch.Generator().manual_seed(SEED + 2)
    x0 = torch.randn(B, T, I, generator=g).to(dev)
    p0 = {d: {"W": (torch.rand(I, 4 * H, generator=g) * 2 - 1) / math.sqrt(I),
              "U": (torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H),
              "b": torch.randn(4 * H, generator=g) * 0.1}
          for d in ("fwd", "bwd")}
    gy = torch.randn(B, T, 2 * H, generator=g).to(dev)
    grads, launches = {}, {}
    for fuse in (True, False):
        x = x0.clone().requires_grad_(True)
        p = {d: {k: v.to(dev).requires_grad_(True) for k, v in q.items()}
             for d, q in p0.items()}
        reset_counts()
        y = bilstm_layer(p, x, mask, fuse_directions=fuse)
        y.backward(gy)
        torch.cuda.synchronize()
        launches[fuse] = lstm_counts()
        grads[fuse] = [y, x.grad] + [p[d][k].grad for d in ("fwd", "bwd")
                                     for k in ("W", "U", "b")]
    reset_counts()
    with torch.no_grad():
        bilstm_layer(p, x0, mask, fuse_directions=False)
    torch.cuda.synchronize()
    launches["unfused_no_grad"] = lstm_counts()
    reset_counts()
    with torch.no_grad():
        y_inf = bilstm_layer(p, x0, mask, fuse_directions=True)
    torch.cuda.synchronize()
    launches["no_grad"] = lstm_counts()
    zero = dict.fromkeys(lstm_counts(), 0)
    check(launches["unfused_no_grad"] == {**zero, "lstm_fwd": 2},
          f"unfused layer without grad launched "
          f"{launches['unfused_no_grad']}")
    check(launches[True] == {**zero, "bilstm_fwd_residual": 1,
                             "bilstm_bwd": 1},
          f"fused layer under autograd launched {launches[True]}")
    check(launches[False] == {**zero, "lstm_fwd_residual": 2,
                              "lstm_bwd": 2},
          f"unfused layer under autograd launched {launches[False]}")
    check(launches["no_grad"] == {**zero, "bilstm_fwd": 1},
          f"fused layer without grad launched {launches['no_grad']}")
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(grads[True], grads[False])]
    equal = [torch.equal(a, b) for a, b in zip(grads[True], grads[False])]
    inf_equal = torch.equal(y_inf, grads[True][0])
    print(f"[kernel] bilstm_layer(fuse_directions=True) B={B} T={T} I={I} "
          f"H={H} float32 vs fuse_directions=False: output and 8 gradients "
          f"equal bits {equal}, worst max|diff|/max {max(rel):.2e} (bound "
          f"{TRAIN_GRAD_REL:.0e}); inference form equal bits {inf_equal}; "
          f"launches under autograd {launches[True]} (unfused "
          f"{launches[False]}), without {launches['no_grad']}")
    check(equal[0] and max(rel) <= TRAIN_GRAD_REL and inf_equal,
          f"fused layer disagrees with the unfused one: {equal} {rel}")
    return {"cases": cases, "layer_launches": {
        "autograd": launches[True], "unfused_autograd": launches[False],
        "no_grad": launches["no_grad"],
        "unfused_no_grad": launches["unfused_no_grad"]},
        "layer_worst_rel": max(rel), "layer_equal_bits": equal}


def beam_inputs(dev):
    """Sharp posteriors (logits x 2) for B=128 utterances of T=401 frames
    and ragged frame lengths (1, 2 and T among them), from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BEAM_B, T, BEAM_A)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    fl = rng.integers(1, T + 1, BEAM_B).astype(np.int32)
    fl[:3] = [T, 1, 2]
    return torch.from_numpy(lp).to(dev), torch.from_numpy(fl).to(dev)


def beam_vs_plain(lp, fl, M: int, Lmax: int, K: int = BEAM_K):
    """ctc_beam and the plain scan + backtrack on the same inputs: checks
    labels, lens, parents and syms identical and the nll; returns the
    kernel's output and the worst nll relative error."""
    import torch

    from pg_asr_tpu_torch.decoding import beam, cuda_beam

    A = lp.shape[-1]
    prune = None if M == beam._prune_m(A, K, None) else M
    out = cuda_beam.ctc_beam_cuda(lp, fl, K=K, M=M, Lmax=Lmax)
    lens, scores, parents, syms = beam._scan_hash(
        lp, fl, K=K, A=A, Lmax=Lmax, blank=0, prune=prune)
    labels, blens, nll = beam._backtrack_batch(parents, syms, lens, scores,
                                               Lmax)
    torch.cuda.synchronize()
    for name, got, want in (("parents", out.parents, parents),
                            ("syms", out.syms, syms), ("lens", out.lens, lens),
                            ("labels", out.labels[:, 0], labels),
                            ("best lens", out.nb_lens[:, 0], blens)):
        check(torch.equal(got, want),
              f"ctc_beam M={M}: {name} differ from the plain scan")
    err = (out.nll[:, 0] - nll).abs()
    rel = (err / nll.abs().clamp(min=1)).max().item()
    check(rel <= BEAM_NLL_REL, f"ctc_beam M={M}: nll rel error {rel}")
    return out, rel, err.max().item()


def phase_beam(dev):
    """ctc_beam vs the plain hash scan at the beam's default batch and
    width, M=6 (the default prune) and M=18 (the exact search)."""
    import torch

    from pg_asr_tpu_torch.decoding import beam, cuda_beam

    lp, fl = beam_inputs(dev)
    A, valid = BEAM_A, int(fl.sum())
    cases = []
    for M in (6, beam._prune_m(A, BEAM_K, None)):
        prune = None if M == beam._prune_m(A, BEAM_K, None) else M
        out, rel, abs_err = beam_vs_plain(lp, fl, M, T)
        k_ms, p_ms = in_turns(
            lambda: beam.beam_decode(lp, fl, max_label_len=T, prune=prune,
                                     use_kernel=False),
            lambda: cuda_beam.ctc_beam_cuda(lp, fl, K=BEAM_K, M=M, Lmax=T),
            1, 20)
        # bytes: the log-prob rows of the valid frames, the frame lengths,
        # and every output once: (T, B, K) parents and syms, (B, K) lens and
        # scores, the (B, Lmax) labels, best lens and nll. Operations per
        # valid frame of an utterance: the top-M rank over A symbols, the
        # K x K merge, ~4 per candidate (score, masks) and a top-K pass
        # over the C = K(1+M) candidates, ~20 per slot for the logaddexps
        C = BEAM_K * (1 + M)
        nbytes = (valid * A * 4 + BEAM_B * 4 + 2 * T * BEAM_B * BEAM_K * 4
                  + 2 * BEAM_B * BEAM_K * 4 + BEAM_B * T * 4 + 2 * BEAM_B * 4)
        flops = valid * (A * M + BEAM_K * BEAM_K + 5 * C + 20 * BEAM_K)
        b_ms, b_by = bound_ms(flops, nbytes, "float32")
        case = {"M": M, "B": BEAM_B, "T": T, "A": A, "K": BEAM_K,
                "valid_frames": valid, "max_frames": int(fl.max()),
                "nll_max_rel_err": rel, "nll_max_abs_err": abs_err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "us_per_frame": k_ms * 1e3 / int(fl.max())}
        cases.append(case)
        print(f"[kernel] ctc_beam B={BEAM_B} T={T} A={A} K={BEAM_K} M={M}: "
              f"labels, lens, parents, syms identical to the plain scan; nll "
              f"rel err {rel:.1e} (bound {BEAM_NLL_REL:.0e}); kernel "
              f"{k_ms:.3f} ms ({case['us_per_frame']:.2f} us per frame of "
              f"the longest utterance), plain {p_ms:.3f} ms, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})")
    # the n-best mode (all K slots, sorted), exact search
    got = beam.beam_decode_nbest(lp, fl, beam_size=BEAM_K)
    want = beam.beam_decode_nbest(lp, fl, beam_size=BEAM_K, use_kernel=False)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "ctc_beam n-best differs from the plain version")
    rel = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1)).max().item()
    check(rel <= BEAM_NLL_REL, f"ctc_beam n-best nll rel error {rel}")
    print(f"[kernel] ctc_beam n-best B={BEAM_B} K={BEAM_K}: labels and lens "
          f"identical, nll rel err {rel:.1e}")
    return cases


def attn_inputs(dev, dtype, dh: int = ATTN_DH):
    """q, k, v as (B, H, T', dh) views of one fused (B, T', 3, H, dh)
    projection (the layout the models hand over) and a ragged (B, T')
    validity mask with lengths T' and 1 among them, from a seed."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(B, ATTN_T, 3, ATTN_H, dh, generator=g)
    lens = torch.randint(1, ATTN_T + 1, (B,), generator=g)
    lens[0], lens[1] = ATTN_T, 1
    valid = (torch.arange(ATTN_T)[None] < lens[:, None]).to(dev)
    qkv = qkv.to(dev, dtype)
    return (*(qkv[:, :, i].transpose(1, 2) for i in range(3)), valid,
            lens.tolist())


def phase_flash(dev):
    """flash_attn in both forms vs mhsa_plain at the conformer's attention
    shape, float32 and bfloat16; the bounds and F.scaled_dot_product_attention
    beside, all device-timed."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import kept_tile_pairs, mhsa_plain

    scale = ATTN_DH ** -0.5
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype)
        # the (query tile, key tile) pairs the kernel skips
        skipped = 1.0 - kept_tile_pairs(valid).float().mean().item()
        got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
        ref, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == q.shape,
              "flash_attn output dtype/shape")
        err = (got.float() - ref.float()).abs()
        v_max = v.float().abs().max().item()
        bound = FLASH_BOUNDS[name] * (v_max if name == "bfloat16" else 1.0)
        # every row, padded queries (which attend the padded keys) included
        check(err.max().item() <= bound,
              f"flash_attn {name} disagrees with the plain version: max "
              f"{err.max().item()} > {bound}")
        # --- the residual form: o, l and m against mhsa_plain(residuals)
        o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                  residuals=True)
        torch.cuda.synchronize()
        check(l.dtype == m.dtype == torch.float32
              and l.shape == m.shape == q.shape[:3], "l, m dtype/shape")
        check(torch.equal(o, got), "the residual form's o differs from the "
              "inference form's")
        l_rel = ((l - r_l).abs() / r_l).max().item()
        m_err = (m - r_m).abs().max().item()
        print(f"[kernel] flash_attn residual {name}: o max abs err "
              f"{err.max().item():.3e} (the inference form's bits), l max rel "
              f"err {l_rel:.2e} (bound {FLASH_L_REL:.0e}), m max abs err "
              f"{m_err:.2e} (bound {FLASH_M_ABS:.0e})")
        check(l_rel <= FLASH_L_REL and m_err <= FLASH_M_ABS,
              f"flash_attn residual {name}: l {l_rel}, m {m_err}")
        # kernels of tens of microseconds: device_ms, so that the host's
        # launches do not set the pace
        k_ms, p_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale),
            10, 50, device_ms)
        r_ms, rp_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale, residuals=True),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                    residuals=True),
            10, 50, device_ms)
        same = valid[:, None, :, None] == valid[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale), 50)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_train = device_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=same, scale=scale), 50)  # row 8r's yardstick
        lib_err = (F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale).float()
            - ref.float()).abs().max().item()
        # operations on the (query, key) pairs the segment mask leaves: a
        # valid query meets the len valid keys, a padded one the T' - len
        # padded keys; q . k and p . v are 2 flops per multiply-add each.
        # Bytes: q, k, v read once, the output written once, the int32
        # mask; the residual form also writes l and m
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        flops = 4 * ATTN_H * ATTN_DH * pairs
        nbytes = (4 * B * ATTN_H * ATTN_T * ATTN_DH * q.element_size()
                  + B * ATTN_T * 4)
        b_ms, b_by = bound_ms(flops, nbytes, name)
        b_res = bound_ms(flops, nbytes + 2 * B * ATTN_H * ATTN_T * 4, name)
        case = {"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                "dh": ATTN_DH, "pairs_per_head": pairs,
                "skipped_tile_pairs": skipped,
                "max_abs_err": err.max().item(),
                "mean_abs_err": err.mean().item(), "bound": bound,
                "l_max_rel_err": l_rel, "m_max_abs_err": m_err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms,
                "library_max_abs_err": lib_err, "res_ms": r_ms,
                "res_plain_ms": rp_ms, "res_bound_ms": b_res[0],
                "res_bound_by": b_res[1], "sdpa_train_fwd_ms": sdpa_train}
        cases.append(case)
        print(f"[kernel] flash_attn B={B} H={ATTN_H} T'={ATTN_T} "
              f"dh={ATTN_DH} {name} (q, k, v views of the fused qkv; "
              f"{skipped:.4f} of the 64 x 64 tile pairs skipped): "
              f"max_abs_err {case['max_abs_err']:.3e} (bound {bound:.3e}), "
              f"mean {case['mean_abs_err']:.3e}; device-timed: kernel "
              f"{k_ms:.4f} ms, residual form {r_ms:.4f} ms, plain {p_ms:.4f}"
              f" / {rp_ms:.4f} ms, bound {b_ms:.4f} / {b_res[0]:.4f} ms "
              f"({b_by}, {flops / 1e9:.3f} GFLOP on {pairs} pairs x "
              f"{ATTN_H} heads, {nbytes / 1e6:.1f} MB); "
              f"F.scaled_dot_product_attention {lib_ms:.4f} ms, its training "
              f"forward {sdpa_train:.4f} ms (max diff to plain "
              f"{lib_err:.1e})")
    return cases


def _rel_errs(got, ref):
    """(max, mean) abs error of got relative to max|ref|."""
    top = ref.float().abs().max().item()
    d = (got.float() - ref.float()).abs()
    return d.max().item() / top, d.mean().item() / top


def phase_flash_bwd(dev):
    """flash_attn_bwd_dkv / _dq vs their plain versions at phase 3c's
    shape, float32 and bfloat16, on the plain forward's residuals; the
    bounds and the backward of F.scaled_dot_product_attention beside."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import (kept_tile_pairs,
                                                 mhsa_bwd_cuda,
                                                 mhsa_bwd_plain, mhsa_plain)

    scale = ATTN_DH ** -0.5
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype)
        # the (query tile, key tile) pairs the kernels skip
        skipped = 1.0 - kept_tile_pairs(valid).float().mean().item()
        s = q.element_size()
        r_o, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        bht = B * ATTN_H * ATTN_T
        tensor = bht * ATTN_DH * s  # bytes of one (B, H, T', dh) tensor
        same = valid[:, None, :, None] == valid[:, None, None, :]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, attn_mask=same,
                                                  scale=scale)

        # --- the backward, on the plain forward's residuals
        g = torch.Generator().manual_seed(SEED + 1)
        do = torch.randn(B, ATTN_T, ATTN_H, ATTN_DH, generator=g).to(
            dev, dtype).transpose(1, 2)  # as autograd hands it over
        di = (r_o.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, valid, r_l, r_m, do, di, scale)
        dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args)
        dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(*args)
        want = mhsa_bwd_plain(q, k, v, valid, r_o, r_l, r_m, do, scale)
        torch.cuda.synchronize()
        errs = {n: _rel_errs(got, w) for n, got, w in
                zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        bd = FLASH_BWD_BOUNDS[name]
        ctrl = None
        if dtype == torch.bfloat16:
            # control: the plain backward without rounding p and ds (do and
            # k widened to float32, exactly, so they round to float32)
            c = mhsa_bwd_plain(q, k.float(), v, valid, r_o, r_l, r_m,
                               do.float(), scale)
            ctrl = min(_rel_errs(a, w)[1] for a, w in zip(c, want))
        # kernels of tens of microseconds: device_ms, so that the host's
        # launches do not set the pace
        dkv_ms, dkv_plain = in_turns(
            lambda: mhsa_bwd_plain(*args[:4], r_o, r_l, r_m, do, scale),
            lambda: cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args), 10, 50,
            device_ms)
        dq_ms, dq_plain = in_turns(
            lambda: mhsa_bwd_plain(*args[:4], r_o, r_l, r_m, do, scale),
            lambda: cuda_flash_attn.flash_attn_bwd_dq_cuda(*args), 10, 50,
            device_ms)
        # the backward as FlashAttention runs it (di, dkv, dq) against
        # SDPA's, which also computes its own di
        bwd_ms = device_ms(lambda: mhsa_bwd_cuda(*args[:4], r_o, r_l, r_m,
                                                 do, scale), 50)
        sdpa_bwd = (device_ms(lambda: torch.autograd.grad(sdpa(), leaves, do),
                              50) - device_ms(sdpa, 50))
        # operations on the pairs the segment mask leaves: dkv computes s,
        # dp and its shares of dv and dk (4 dot products of dh, 8 dh
        # flops), dq s, dp and dq (6 dh). Bytes: q, k, v, do, l, m, di and
        # the mask read once, the outputs written once
        common = 4 * tensor + 3 * bht * 4 + B * ATTN_T * 4
        b_dkv = bound_ms(8 * ATTN_H * ATTN_DH * pairs, common + 2 * tensor,
                         name)
        b_dq = bound_ms(6 * ATTN_H * ATTN_DH * pairs, common + tensor, name)
        case = {"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                "dh": ATTN_DH, "pairs_per_head": pairs,
                "errors_rel_to_max": errs, "bound": bd,
                "control_mean_rel_err": ctrl, "dkv_ms": dkv_ms,
                "dq_ms": dq_ms, "bwd_ms": bwd_ms,
                "skipped_tile_pairs": skipped,
                "plain_bwd_ms": (dkv_plain + dq_plain) / 2,
                "dkv_bound_ms": b_dkv[0], "dkv_bound_by": b_dkv[1],
                "dq_bound_ms": b_dq[0], "dq_bound_by": b_dq[1],
                "sdpa_bwd_ms": sdpa_bwd}
        cases.append(case)
        print(f"[kernel] flash_attn_bwd B={B} H={ATTN_H} T'={ATTN_T} "
              f"dh={ATTN_DH} {name}: max/mean abs err rel to max|grad| "
              + ", ".join(f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in
                          errs.items())
              + f" (bounds {bd['max']:.1e}/{bd['mean']:.0e})"
              + (f", control without p/ds rounding: mean {ctrl:.2e}"
                 if ctrl is not None else "")
              + f"; dkv {dkv_ms:.4f} ms (bound {b_dkv[0]:.4f}, "
              f"{b_dkv[1]}), dq {dq_ms:.4f} ms (bound {b_dq[0]:.4f}, "
              f"{b_dq[1]}), plain backward (all three) "
              f"{case['plain_bwd_ms']:.4f} ms; di + dkv + dq "
              f"(FlashAttention.backward) {bwd_ms:.4f} ms; "
              f"F.scaled_dot_product_attention backward {sdpa_bwd:.4f} ms; "
              f"{skipped:.4f} of the 64 x 64 tile pairs skipped")
        for n, (mx, mean) in errs.items():
            check(mx <= bd["max"] and mean <= bd["mean"],
                  f"flash_attn_bwd {name}: {n} max {mx}, mean {mean} > {bd}")
        check(ctrl is None or ctrl > bd["mean"],
              f"the {name} mean bound does not tell apart a backward that "
              "skips the rounding of p and ds")
    return cases


def joint_inputs(dev, dtype):
    """The fused joint's inputs at the transducer's train shape (B=64 x 5
    s: T'=201 frames, labels of 60 symbols, J=256, A=28) from a seed: e and
    g as the projections hand them over (~N(0, 1/4)), W Xavier-normal, a
    small bias; ragged frame and label lengths (the full lengths and 1
    among them), labels 0-padded; cotangents gb, gy ~ N(0, 1) on the cells
    the loss reads and 0 elsewhere, as the lattice loss gives them. ->
    (e, g, W, b, labels), gb, gy, (frame_lens, label_lens)"""
    import torch

    g_ = torch.Generator().manual_seed(SEED)
    U, A, J = JOINT_U, JOINT_A, JOINT_J
    e = torch.randn(B, ATTN_T, J, generator=g_) * 0.5
    g = torch.randn(B, U + 1, J, generator=g_) * 0.5
    W = torch.randn(J, A, generator=g_) * (2.0 / (J + A)) ** 0.5
    b = torch.randn(A, generator=g_) * 0.1
    fl = torch.randint(1, ATTN_T + 1, (B,), generator=g_)
    ll = torch.randint(1, U + 1, (B,), generator=g_)
    fl[0], fl[1], ll[0], ll[1] = ATTN_T, 1, U, 1
    labels = torch.randint(1, A, (B, U), generator=g_)
    labels[torch.arange(U)[None] >= ll[:, None]] = 0
    t_ok = torch.arange(ATTN_T)[None, :, None] < fl[:, None, None]
    u_ok = torch.arange(U + 1)[None, None, :] <= ll[:, None, None]
    gb = torch.randn(B, ATTN_T, U + 1, generator=g_) * (t_ok & u_ok)
    gy = torch.randn(B, ATTN_T, U, generator=g_) * (t_ok & u_ok)[..., :U]
    args = tuple(t.to(dev, dtype) for t in (e, g, W, b)) + (labels.to(dev),)
    return args, gb.to(dev), gy.to(dev), (fl, ll)


def unfused_joint(e, g, W, b, labels):
    """The port's unfused composition at the inputs' dtype (the default
    path, fused_joint False): the (B, T, U+1, J) tanh, the head, then
    joint_log_probs in float32."""
    import torch

    from pg_asr_tpu_torch.ops.transducer import joint_log_probs

    return joint_log_probs(torch.tanh(e[:, :, None] + g[:, None]) @ W + b,
                           labels)


def phase_joint(dev):
    """joint_fwd and joint_bwd vs their plain versions at the transducer's
    train shape, float32 and bfloat16: errors against stated bounds,
    CUDA-event times in turns, each kernel's bound, and the port's unfused
    composition (forward, forward + backward) as the yardstick."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_joint
    from pg_asr_tpu_torch.ops.joint import (fused_joint_bwd_plain,
                                            fused_joint_plain)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        args, gb, gy, (fl, ll) = joint_inputs(dev, dtype)
        U, A, J = JOINT_U, JOINT_A, JOINT_J
        s = args[0].element_size()
        lpb, lpy = cuda_joint.joint_fwd_cuda(*args)
        rb, ry = fused_joint_plain(*args)
        grads = cuda_joint.joint_bwd_cuda(*args, gb, gy)
        want = fused_joint_bwd_plain(*args, gb, gy)
        torch.cuda.synchronize()
        check(lpb.dtype == lpy.dtype == torch.float32
              and lpb.shape == (B, ATTN_T, U + 1)
              and lpy.shape == (B, ATTN_T, U), "joint_fwd dtype/shape")
        check(all(g.dtype == dtype for g in grads), "joint_bwd dtypes")
        check(all(torch.equal(g, a) for g, a in zip(
            grads, cuda_joint.joint_bwd_cuda(*args, gb, gy))),
            "joint_bwd is not deterministic")
        lp_err = {"lp_blank": _errs(lpb, rb), "lp_label": _errs(lpy, ry)}
        g_err = {n: _rel_errs(g, w) for n, g, w in
                 zip(("de", "dg", "dW", "db"), grads, want)}
        bd = JOINT_BOUNDS[name]
        # the work: per lattice cell J adds and J tanh (one operation
        # each), the head's J x A multiply-adds (2 flops each) and ~4 A for
        # the log-sum-exp; the backward recomputes the head and adds the
        # products dz . W^T and h^T dz, ~7 J elementwise ops and ~8 A.
        # Float32 math on CUDA cores in both types: the float32 peak.
        # Bytes: each input read once, each output written once (the
        # backward's scratch is not the function's)
        cells = B * ATTN_T * (U + 1)
        f_fwd = cells * (2 * J * A + 2 * J + 4 * A)
        f_bwd = cells * (3 * 2 * J * A + 7 * J + 8 * A)
        ins = (B * ATTN_T * J + B * (U + 1) * J + J * A + A) * s + B * U * 4
        outs = B * ATTN_T * (2 * U + 1) * 4
        b_fwd = bound_ms(f_fwd, ins + outs, "float32")
        b_bwd = bound_ms(f_bwd, ins + outs + ins - B * U * 4, "float32")
        fwd_ms, fwd_plain = in_turns(
            lambda: fused_joint_plain(*args),
            lambda: cuda_joint.joint_fwd_cuda(*args), 3, 20)
        bwd_ms, bwd_plain = in_turns(
            lambda: fused_joint_bwd_plain(*args, gb, gy),
            lambda: cuda_joint.joint_bwd_cuda(*args, gb, gy), 3, 20)

        # the yardstick: the port's unfused composition in this dtype
        leaves = [a.detach().requires_grad_(True) for a in args[:4]]

        def unfused_train():
            lb, ly = unfused_joint(*leaves, args[4])
            torch.autograd.grad((lb * gb).sum() + (ly * gy).sum(), leaves)

        def fused_train():
            cuda_joint.joint_fwd_cuda(*args)
            cuda_joint.joint_bwd_cuda(*args, gb, gy)

        with torch.no_grad():
            unf_ms = time_ms(lambda: unfused_joint(*args), 10)
        # in_turns(plain, kernel) returns (kernel ms, plain ms)
        fused_train_ms, unf_train_ms = in_turns(unfused_train, fused_train,
                                                5, 5)
        ub, uy = unfused_joint(*args)
        unf_err = max(_errs(ub, rb)[0], _errs(uy, ry)[0])
        case = {"dtype": name, "B": B, "T": ATTN_T, "U": U, "J": J, "A": A,
                "cells": cells, "valid_cells": int(
                    (fl * (ll + 1)).sum()), "lp_errors": lp_err,
                "grad_errors_rel_to_max": g_err, "bound": bd,
                "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain,
                "fwd_bound_ms": b_fwd[0], "fwd_bound_by": b_fwd[1],
                "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain,
                "bwd_bound_ms": b_bwd[0], "bwd_bound_by": b_bwd[1],
                "fwd_gflop": f_fwd / 1e9, "bwd_gflop": f_bwd / 1e9,
                "unfused_fwd_ms": unf_ms,
                "unfused_fwd_bwd_ms": unf_train_ms,
                "fused_fwd_bwd_ms": fused_train_ms,
                "unfused_max_abs_err_to_plain": unf_err}
        cases.append(case)
        print(f"[kernel] joint_fwd B={B} T'={ATTN_T} U+1={U + 1} J={J} "
              f"A={A} {name}: " + ", ".join(
                  f"{k} max {v[0]:.2e} mean {v[1]:.2e}" for k, v in
                  lp_err.items())
              + f" (bounds {bd['lp_max']:.0e} / {bd['lp_mean']:.0e}); "
              f"kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, bound "
              f"{b_fwd[0]:.4f} ms ({b_fwd[1]}, {f_fwd / 1e9:.2f} GFLOP); "
              f"unfused composition ({name}) {unf_ms:.4f} ms (max diff to "
              f"plain {unf_err:.1e})")
        print(f"[kernel] joint_bwd {name}: max/mean abs err rel to "
              f"max|grad| " + ", ".join(
                  f"{n} {e[0]:.2e}/{e[1]:.2e}" for n, e in g_err.items())
              + f" (bounds {bd['grad_max']:.1e}/{bd['grad_mean']:.0e}); "
              f"kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, bound "
              f"{b_bwd[0]:.4f} ms ({b_bwd[1]}, {f_bwd / 1e9:.2f} GFLOP); "
              f"forward + backward: fused kernels {fused_train_ms:.4f} ms, "
              f"unfused composition {unf_train_ms:.4f} ms")
        for k, (mx, mean) in lp_err.items():
            check(mx <= bd["lp_max"] and mean <= bd["lp_mean"],
                  f"joint_fwd {name}: {k} max {mx}, mean {mean} > {bd}")
        for k, (mx, mean) in g_err.items():
            check(mx <= bd["grad_max"] and mean <= bd["grad_mean"],
                  f"joint_bwd {name}: {k} max {mx}, mean {mean} > {bd}")
    return cases


def phase_shapes(dev):
    """The shapes past the first kernels' limits, each on its kernel (its
    launch counter rises by one a call, nothing falls back) against its
    plain version within the bounds of phases 3b-3e: the LSTM at H=512
    float32 and 1024 bfloat16; the joint at A=256, J=640 (a BPE
    vocabulary, joint_dim 640); flash attention at dh=128 (d_model 512
    with 4 heads) and 256 (the wide kernels) at phase 3c's shape, forward
    and backward, device-timed beside SDPA; the beam at K=64 over A=5000 (the block
    form) and at K=16 over A=5000 (the warp form), M=6 and exact, best
    and n-best. -> {"lstm": [...], "joint": [...], "flash": [...],
    "beam": [...]}"""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.decoding import beam, cuda_beam
    from pg_asr_tpu_torch.ops import cuda_flash_attn, cuda_joint
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_bwd_plain, mhsa_plain
    from pg_asr_tpu_torch.ops.joint import (fused_joint_bwd_plain,
                                            fused_joint_plain)

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_bwd_plain, lstm_scan_plain

    out = {"lstm": [], "bilstm": [], "joint": [], "flash": [], "beam": []}
    # --- the LSTM at phase 3's B and T past 512 units (U's columns from L2):
    # H=512 float32, H=1024 bfloat16 and H=2048 (fewer rows a cluster, a
    # thread looping over units) in both, forward scan, both forms and the
    # backward on the plain forward's residuals, within phase 3's bounds
    for dtype, lH in ((torch.float32, 512), (torch.bfloat16, 1024),
                      (torch.float32, 2048), (torch.bfloat16, 2048)):
        name = str(dtype).split(".")[1]
        g_ = torch.Generator().manual_seed(SEED)
        lens = torch.randint(1, T + 1, (B,), generator=g_)
        lens[0], lens[1] = T, 1
        mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
        xp = (0.5 * torch.randn(B, T, 4 * lH, generator=g_)).to(dev, dtype)
        U = ((torch.rand(lH, 4 * lH, generator=g_) * 2 - 1)
             / math.sqrt(lH)).to(dev, dtype)
        gy = torch.randn(B, T, lH, generator=g_).to(dev, dtype)
        c0 = (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
              cuda_lstm.BWD_LAUNCHES)
        got = cuda_lstm.lstm_scan_cuda(xp, U, mask, False)
        o_r, h_r, c_r = cuda_lstm.lstm_scan_residual_cuda(xp, U, mask, False)
        ref = lstm_scan_plain(xp, U, mask, False, residuals=True)
        dxp, dU = cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, ref[1], ref[2],
                                               gy, False)
        r_dxp, r_dU = lstm_scan_bwd_plain(xp, U, mask, ref[1], ref[2], gy,
                                          False)
        torch.cuda.synchronize()
        check((cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
               cuda_lstm.BWD_LAUNCHES) == (c0[0] + 1, c0[1] + 1, c0[2] + 1),
              f"lstm H={lH}: launches")
        check(torch.equal(o_r, got), f"lstm H={lH}: the residual form's out")
        errs = {"out": _errs(got, ref[0]), "hprev": _errs(h_r, ref[1]),
                "cprev": _errs(c_r, ref[2])}
        bb = BWD_BOUNDS[name]
        e_dxp, e_du = _errs(dxp, r_dxp), _errs(dU, r_dU)
        dxp_max = bb.get("dxp_max", bb.get("dxp_rel", 0)
                         * r_dxp.float().abs().max().item())
        # phase 3's max bounds hold at any H. Its bf16 mean bounds were set
        # from readings at H=256, and more products per sum move more
        # bf16 roundings of h by an ulp (out mean 2.1e-6 at H=1024 against
        # 3.7e-7 at 256); what the mean must show, that h and dpre round
        # to bf16 where the Pallas body rounds them, is held here against
        # a control of the plain version without those roundings (U
        # widened to float32): the kernel's mean at most a third of it
        means = {k: v[1] for k, v in errs.items()}
        means["dxp"] = e_dxp[1]
        if dtype == torch.bfloat16:
            c_ref = lstm_scan_plain(xp, U.float(), mask, False,
                                    residuals=True)
            c_dxp, _ = lstm_scan_bwd_plain(xp, U.float(), mask, ref[1],
                                           ref[2], gy, False)
            ctrl = {k: _errs(c, r)[1] for k, c, r in zip(
                ("out", "hprev", "cprev"), c_ref, ref)}
            ctrl["dxp"] = _errs(c_dxp, r_dxp)[1]
            mean_ok = {k: means[k] <= ctrl[k] / 3 for k in means}
        else:
            ctrl = None
            mean_ok = {k: means[k] <= (CPREV_BOUNDS if k == "cprev"
                                       else BOUNDS)[name]["mean"]
                       for k in errs}
            mean_ok["dxp"] = means["dxp"] <= bb["dxp_mean"]
        for k, (mx, mean) in errs.items():
            bd = CPREV_BOUNDS[name] if k == "cprev" else BOUNDS[name]
            check(mx <= bd["max"] and mean_ok[k],
                  f"lstm_fwd H={lH} {name}: {k} max {mx}, mean {mean} "
                  f"(bounds {bd}, control {ctrl})")
        check(e_dxp[0] <= dxp_max and mean_ok["dxp"],
              f"lstm_bwd H={lH} {name}: dxp {e_dxp} out of bounds (control "
              f"{ctrl})")
        check(e_du[0] <= bb["du_rel"] * r_dU.float().abs().max().item(),
              f"lstm_bwd H={lH} {name}: dU {e_du} out of bounds")
        fwd_ms, fwd_plain = in_turns(
            lambda: lstm_scan_plain(xp, U, mask, False),
            lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, False), 1, 5)
        bwd_ms = time_ms(lambda: cuda_lstm.lstm_scan_bwd_cuda(
            xp, U, mask, ref[1], ref[2], gy, False), 3)
        out["lstm"].append({"dtype": name, "B": B, "T": T, "H": lH,
                            "errors": errs, "control_means": ctrl,
                            "dxp_errors": e_dxp,
                            "du_errors": e_du, "fwd_ms": fwd_ms,
                            "fwd_plain_ms": fwd_plain, "bwd_ms": bwd_ms})
        print(f"[shapes] lstm B={B} T={T} H={lH} {name} (U from L2): "
              f"lstm_fwd, its residual form and lstm_bwd launched once each; "
              + ", ".join(f"{k} max {v[0]:.2e} mean {v[1]:.2e}"
                          for k, v in errs.items())
              + (f" (controls without the bf16 roundings: {ctrl})" if ctrl
                 else "")
              + f"; dxp max {e_dxp[0]:.2e} mean {e_dxp[1]:.2e}, dU max "
              f"{e_du[0]:.2e}; lstm_fwd {fwd_ms:.3f} ms (plain "
              f"{fwd_plain:.3f} ms), lstm_bwd {bwd_ms:.3f} ms")

    # --- the fused directions at phase 3's B and T and H=1024 (refused by
    # the first fused kernels): bilstm_fwd (both forms) and bilstm_bwd, each
    # direction equal bit for bit to lstm_fwd / lstm_bwd, against the plain
    # versions within phase 3's max bounds; timed beside two single-direction
    # launches
    from pg_asr_tpu_torch.ops.lstm import (bilstm_scan_bwd_plain,
                                           bilstm_scan_plain)
    for dtype in (torch.float32, torch.bfloat16):
        lH, name = 1024, str(dtype).split(".")[1]
        g_ = torch.Generator().manual_seed(SEED + 3)
        lens = torch.randint(1, T + 1, (B,), generator=g_)
        lens[0], lens[1] = T, 1
        mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
        xpf, xpb = ((0.5 * torch.randn(B, T, 4 * lH, generator=g_)).to(
            dev, dtype) for _ in range(2))
        Uf, Ub = (((torch.rand(lH, 4 * lH, generator=g_) * 2 - 1)
                   / math.sqrt(lH)).to(dev, dtype) for _ in range(2))
        gy = torch.randn(B, T, 2 * lH, generator=g_).to(dev, dtype)
        args = (xpf, xpb, Uf, Ub, mask)
        c0 = lstm_counts()
        res = cuda_lstm.bilstm_scan_residual_cuda(*args)
        y = cuda_lstm.bilstm_scan_cuda(*args)
        ref = bilstm_scan_plain(*args, residuals=True)
        bwd = cuda_lstm.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        c1 = lstm_counts()
        r_bwd = bilstm_scan_bwd_plain(*args, *ref[1:], gy)
        sf = cuda_lstm.lstm_scan_residual_cuda(xpf, Uf, mask, False)
        sb = cuda_lstm.lstm_scan_residual_cuda(xpb, Ub, mask, True)
        gyf, gyb = gy[..., :lH].contiguous(), gy[..., lH:].contiguous()
        s_f = cuda_lstm.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf,
                                           False)
        s_b = cuda_lstm.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb,
                                           True)
        torch.cuda.synchronize()
        check({k: c1[k] - c0[k] for k in c0} == {
            **dict.fromkeys(c0, 0), "bilstm_fwd": 1, "bilstm_fwd_residual": 1,
            "bilstm_bwd": 1}, f"bilstm H={lH}: launches")
        check(torch.equal(y, res[0]), f"bilstm H={lH}: the forms' y differ")
        equal = all(torch.equal(a, b) for a, b in zip(
            (*res, *bwd), (torch.cat([sf[0], sb[0]], -1), sf[1], sf[2],
                           sb[1], sb[2], s_f[0], s_b[0], s_f[1], s_b[1])))
        check(equal, f"bilstm H={lH} {name}: bits differ from two "
                     "single-direction launches")
        errs = {k: _errs(g, r)[0] for k, g, r in zip(
            ("y", "hpf", "cpf", "hpb", "cpb"), res, ref)}
        for k, mx in errs.items():
            bd = CPREV_BOUNDS[name] if k.startswith("c") else BOUNDS[name]
            check(mx <= bd["max"], f"bilstm_fwd H={lH} {name}: {k} {mx}")
        bb = BWD_BOUNDS[name]
        for k, g_b, r_b in zip(("dxpf", "dxpb", "dUf", "dUb"), bwd, r_bwd):
            ref_max = r_b.float().abs().max().item()
            lim = (bb["du_rel"] * ref_max if k.startswith("dU")
                   else bb.get("dxp_max", bb.get("dxp_rel", 0) * ref_max))
            errs[k] = _errs(g_b, r_b)[0]
            check(errs[k] <= lim, f"bilstm_bwd H={lH} {name}: {k} "
                                  f"{errs[k]} > {lim}")
        t = turns({
            "fwd": lambda: cuda_lstm.bilstm_scan_cuda(*args),
            "two_fwd": lambda: (cuda_lstm.lstm_scan_cuda(xpf, Uf, mask, False),
                                cuda_lstm.lstm_scan_cuda(xpb, Ub, mask, True)),
            "bwd": lambda: cuda_lstm.bilstm_scan_bwd_cuda(*args, *ref[1:], gy),
            "two_bwd": lambda: (
                cuda_lstm.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2],
                                             gyf, False),
                cuda_lstm.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4],
                                             gyb, True))},
            dict.fromkeys(("fwd", "two_fwd", "bwd", "two_bwd"), 2))
        out["bilstm"].append({"dtype": name, "B": B, "T": T, "H": lH,
                              "max_abs_errors": errs, **{
                                  f"{k}_ms": v for k, v in t.items()}})
        print(f"[shapes] bilstm B={B} T={T} H={lH} {name}: bilstm_fwd (both "
              f"forms) and bilstm_bwd launched once each, each direction "
              f"equal bit for bit to lstm_fwd / lstm_bwd; max abs errors "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; in turns: bilstm_fwd {t['fwd']:.3f} ms (2 x lstm_fwd "
              f"{t['two_fwd']:.3f}), bilstm_bwd {t['bwd']:.3f} ms (2 x "
              f"lstm_bwd {t['two_bwd']:.3f})")

    # --- the joint: a few utterances at A=256, J=640
    jB, jT, jU, jJ, jA = 4, 51, 20, 640, 256
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        g_ = torch.Generator().manual_seed(SEED)
        e, g, W, b = (torch.randn(*sh, generator=g_) * sc for sh, sc in (
            ((jB, jT, jJ), 0.5), ((jB, jU + 1, jJ), 0.5),
            ((jJ, jA), (2.0 / (jJ + jA)) ** 0.5), ((jA,), 0.1)))
        labels = torch.randint(1, jA, (jB, jU), generator=g_)
        gb = torch.randn(jB, jT, jU + 1, generator=g_).to(dev)
        gy = torch.randn(jB, jT, jU, generator=g_).to(dev)
        args = tuple(t.to(dev, dtype) for t in (e, g, W, b)) + (
            labels.to(dev),)
        c0 = (cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES)
        lpb, lpy = cuda_joint.joint_fwd_cuda(*args)
        grads = cuda_joint.joint_bwd_cuda(*args, gb, gy)
        torch.cuda.synchronize()
        check((cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES)
              == (c0[0] + 1, c0[1] + 1), "joint A=256 J=640: launches")
        bd = JOINT_BOUNDS[name]
        lp_err = {k: _errs(got, ref) for k, got, ref in zip(
            ("lp_blank", "lp_label"), (lpb, lpy), fused_joint_plain(*args))}
        g_err = {n: _rel_errs(gr, w) for n, gr, w in zip(
            ("de", "dg", "dW", "db"), grads,
            fused_joint_bwd_plain(*args, gb, gy))}
        for k, (mx, mean) in lp_err.items():
            check(mx <= bd["lp_max"] and mean <= bd["lp_mean"],
                  f"joint_fwd A={jA} J={jJ} {name}: {k} {mx}, {mean}")
        for k, (mx, mean) in g_err.items():
            check(mx <= bd["grad_max"] and mean <= bd["grad_mean"],
                  f"joint_bwd A={jA} J={jJ} {name}: {k} {mx}, {mean}")
        check(all(torch.equal(gr, a) for gr, a in zip(
            grads, cuda_joint.joint_bwd_cuda(*args, gb, gy))),
            "joint_bwd A=256 J=640 is not deterministic")
        fwd_ms = time_ms(lambda: cuda_joint.joint_fwd_cuda(*args), 5)
        bwd_ms = time_ms(lambda: cuda_joint.joint_bwd_cuda(*args, gb, gy), 5)
        out["joint"].append({"dtype": name, "B": jB, "T": jT, "U": jU,
                             "J": jJ, "A": jA, "lp_errors": lp_err,
                             "grad_errors_rel_to_max": g_err,
                             "fwd_ms": fwd_ms, "bwd_ms": bwd_ms})
        print(f"[shapes] joint B={jB} T'={jT} U+1={jU + 1} J={jJ} A={jA} "
              f"{name}: joint_fwd and joint_bwd launched once each; "
              + ", ".join(f"{k} {v[0]:.2e}" for k, v in lp_err.items())
              + ", " + ", ".join(f"{n} {e[0]:.2e}" for n, e in g_err.items())
              + f" (max, grads rel to max|grad|); repeats its bits; "
              f"joint_fwd {fwd_ms:.4f} ms, joint_bwd {bwd_ms:.4f} ms")

    # --- flash attention at dh=128 (an instance), 256 (the wide kernels)
    # and 512 (the wide kernels in two pieces), phase 3c's shape
    for dh, dtype in ((128, torch.float32), (128, torch.bfloat16),
                      (256, torch.float32), (256, torch.bfloat16),
                      (512, torch.float32), (512, torch.bfloat16)):
        scale = dh ** -0.5
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype, dh)
        c0 = flash_counts()
        got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
        ref, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        do = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            SEED)).to(dev, dtype)
        di = (ref.float() * do.float()).sum(-1).contiguous()
        dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(
            q, k, v, valid, r_l, r_m, do, di, scale)
        dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(q, k, v, valid, r_l, r_m,
                                                    do, di, scale)
        torch.cuda.synchronize()
        c1 = flash_counts()
        check((c1["flash_attn"], c1["flash_attn_bwd_dkv"],
               c1["flash_attn_bwd_dq"]) == (
            c0["flash_attn"] + 1, c0["flash_attn_bwd_dkv"] + 1,
            c0["flash_attn_bwd_dq"] + 1), f"flash dh={dh}: launches")
        err = (got.float() - ref.float()).abs().max().item()
        bound = FLASH_BOUNDS[name] * (v.float().abs().max().item()
                                      if name == "bfloat16" else 1.0)
        check(err <= bound, f"flash_attn dh={dh} {name}: {err} > {bound}")
        bwd_err = {n: _rel_errs(gr, w) for n, gr, w in zip(
            ("dq", "dk", "dv"), (dq, dk, dv),
            mhsa_bwd_plain(q, k, v, valid, ref, r_l, r_m, do, scale))}
        for n, (mx, _) in bwd_err.items():
            check(mx <= FLASH_BWD_BOUNDS[name]["max"],
                  f"flash_attn_bwd dh={dh} {name}: {n} {mx}")
        k_ms, p_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale),
            5, 50, device_ms)
        same = valid[:, None, :, None] == valid[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale), 50)
        dkv_ms = device_ms(lambda: cuda_flash_attn.flash_attn_bwd_dkv_cuda(
            q, k, v, valid, r_l, r_m, do, di, scale), 50)
        dq_ms = device_ms(lambda: cuda_flash_attn.flash_attn_bwd_dq_cuda(
            q, k, v, valid, r_l, r_m, do, di, scale), 50)
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        flops = 4 * ATTN_H * dh * pairs
        nbytes = 4 * B * ATTN_H * ATTN_T * dh * q.element_size() + B * ATTN_T * 4
        b_ms, b_by = bound_ms(flops, nbytes, name)
        out["flash"].append({"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                             "dh": dh, "max_abs_err": err, "bound": bound,
                             "bwd_errors_rel_to_max": bwd_err, "ms": k_ms,
                             "plain_ms": p_ms, "library_ms": lib_ms,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "dkv_ms": dkv_ms, "dq_ms": dq_ms})
        print(f"[shapes] flash_attn B={B} H={ATTN_H} T'={ATTN_T} dh={dh} "
              f"{name}: flash_attn, dkv, dq launched once each; o max abs "
              f"err {err:.2e} (bound {bound:.2e}), " + ", ".join(
                  f"{n} {e[0]:.2e}" for n, e in bwd_err.items())
              + f" (rel to max|grad|); device-timed: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); dkv {dkv_ms:.4f} ms, dq "
              f"{dq_ms:.4f} ms")

    # --- the beam over A=5000: K=64 (the block form), K=16 (the warp form)
    rng = np.random.default_rng(SEED)
    bB, bT, bA = 8, 101, 5000
    x = rng.standard_normal((bB, bT, bA)) * 2.0
    lp = torch.from_numpy((x - np.log(np.exp(x).sum(-1, keepdims=True)))
                          .astype(np.float32)).to(dev)
    fl_np = rng.integers(1, bT + 1, bB).astype(np.int32)
    fl_np[:3] = [bT, 1, 2]
    fl = torch.from_numpy(fl_np).to(dev)
    for K in (64, 16):
        for M in (6, beam._prune_m(bA, K, None)):
            c0 = cuda_beam.LAUNCHES
            _, rel, _ = beam_vs_plain(lp, fl, M, bT, K=K)
            check(cuda_beam.LAUNCHES == c0 + 1, f"ctc_beam K={K}: launches")
            ms = time_ms(lambda: cuda_beam.ctc_beam_cuda(lp, fl, K=K, M=M,
                                                         Lmax=bT), 3)
            out["beam"].append({"B": bB, "T": bT, "A": bA, "K": K, "M": M,
                                "nll_max_rel_err": rel, "ms": ms})
            print(f"[shapes] ctc_beam B={bB} T={bT} A={bA} K={K} M={M}: "
                  f"launched once; labels, lens, parents, syms identical to "
                  f"the plain scan, nll rel err {rel:.1e}; kernel {ms:.3f} ms")
        got = beam.beam_decode_nbest(lp, fl, beam_size=K, max_label_len=bT)
        want = beam.beam_decode_nbest(lp, fl, beam_size=K, max_label_len=bT,
                                      use_kernel=False)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ctc_beam n-best K={K} A={bA} differs from the plain version")
        rel = ((got[2] - want[2]).abs() / want[2].abs().clamp(min=1)).max()
        check(rel.item() <= BEAM_NLL_REL, f"ctc_beam n-best K={K}: nll {rel}")
        print(f"[shapes] ctc_beam n-best B={bB} A={bA} K={K}: identical, nll "
              f"rel err {rel.item():.1e}")
    return out


def make_corpus(d):
    from pg_asr_tpu_torch.data import make_synthetic_corpus

    t0 = time.perf_counter()
    corpus, alphabet = make_synthetic_corpus(
        os.path.join(d, "corpus"), n_utts=N_UTTS, seed=SEED, min_dur=1.0,
        max_dur=5.0, words=WORDS)
    print(f"[corpus] {N_UTTS} synthetic utterances of 1-5 s in "
          f"{time.perf_counter() - t0:.1f} s")
    return corpus, alphabet


def run_cli(argv):
    """cli.main(argv) with its stdout captured; returns (rc, stdout)."""
    from pg_asr_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    print(out.getvalue().rstrip())
    return rc, out.getvalue()


def phase_predict(dev, corpus, alphabet, d, bi):
    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.models import bilstm_ctc
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import forward, load_model

    bs = 32  # the CLI's default, which the run below does not override
    cfg = Config(model=ModelConfig(vocab_size=alphabet.size))
    params = bilstm_ctc.init_params(cfg.model,
                                    torch.Generator().manual_seed(SEED))
    model_dir = os.path.join(d, "model")
    save_model(model_dir, params, cfg)
    n_params = sum(p.numel() for p in params.values())
    utts = load_manifest(os.path.join(corpus, "test.tsv"),
                         os.path.join(corpus, "clips"))
    n_batches = -(-len(utts) // bs)
    print(f"[predict] BiLSTM-CTC {cfg.model.num_layers}x"
          f"{cfg.model.hidden_size}/dir, proj {cfg.model.input_proj_dim}, "
          f"vocab {alphabet.size}, {n_params} params; {len(utts)} test "
          f"utterances in {n_batches} batches of <= {bs}")

    inf, _, _, per_batch = route_counters()
    reset_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model_dir, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lstm_counts()
    print(f"[predict] rc={rc} in {wall:.2f} s (host clock, first run: "
          f"includes data loading and warm-up); LSTM launches {launches}")
    check(rc == 0, "predict failed")
    check("CER:" in out and "WER:" in out, "CER/WER not printed")
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        rows = fo.read().splitlines()
    check(len(rows) == len(utts) and all("|" in r for r in rows),
          f"predicted.txt has {len(rows)} rows for {len(utts)} utts")
    check(launches == {**dict.fromkeys(launches, 0),
                       inf: per_batch * n_batches},
          f"LSTM launches {launches}, expected {per_batch} {inf} x "
          f"{n_batches} batches")

    # one batch: the forward with the kernel vs with the plain recurrence
    params_d, cfg_d = load_model(model_dir, alphabet, device=dev)
    batch = next(iter(BatchIterator(utts, alphabet, bs, shuffle=False)))
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    lp_k, _, _ = forward(params_d, wave, ns, cfg_d)
    lp_p, _, _ = forward(params_d, wave, ns, cfg_d, use_kernel=False)
    torch.cuda.synchronize()
    T_b = batch.wave.shape[1] // cfg.features.hop_length + 1
    check(tuple(lp_k.shape) == (len(batch.texts), T_b, alphabet.size),
          f"log-probs shape {tuple(lp_k.shape)}")
    check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
    err = (lp_k - lp_p).abs().max().item()
    print(f"[predict] batch log-probs {tuple(lp_k.shape)}: kernel vs plain "
          f"max_abs_err {err:.3e} (bound {LOGPROB_BOUND:.0e})")
    check(err <= LOGPROB_BOUND, f"log-probs disagree: {err}")

    # the forward (features + model) at the kernel phase's batch shape
    wave64, ns64 = flagship_batch(dev)[:2]
    for dtype in ("float32", "bfloat16"):
        p_d, c_d = load_model(model_dir, alphabet, device=dev, dtype=dtype)
        f_k = time_ms(lambda: forward(p_d, wave64, ns64, c_d), 5)
        fused = next(c for c in bi["cases"] if c["dtype"] == dtype)
        lstm = per_batch * fused["fwd_ms"]
        print(f"[predict] forward B={B} x 5 s (T={T}), {dtype}: with kernel "
              f"{f_k:.2f} ms; the {per_batch} {inf} launches at phase 3f's "
              f"time: {lstm:.2f} ms ({lstm / f_k:.0%})")

    beam_launches = run_beam_predict(dev, corpus, model_dir, len(utts))
    # the beam batch's log-probs: ctc_beam vs the plain scan. Random weights
    # give nearly flat posteriors, so near-ties abound; the two compute the
    # same float32 operations in the same order, so they must still agree
    # exactly on labels, lens, parents and syms.
    batch = next(iter(BatchIterator(utts, alphabet, BEAM_B, shuffle=False)))
    lp, _, fl = forward(params_d, torch.from_numpy(batch.wave).to(dev),
                        torch.from_numpy(batch.num_samples).to(dev), cfg_d)
    Lmax = min(cfg_d.decode.max_label_len, lp.shape[1])
    out, rel, _ = beam_vs_plain(lp, fl.to(torch.int32).contiguous(),
                                cfg_d.decode.beam_prune, Lmax)
    print(f"[predict] beam batch {tuple(lp.shape)}: ctc_beam (M="
          f"{cfg_d.decode.beam_prune}) identical to the plain scan, nll rel "
          f"err {rel:.1e}; mean label length "
          f"{out.nb_lens.float().mean().item():.1f}")
    return launches, beam_launches


def run_beam_predict(dev, corpus, model_dir, n_utts: int) -> int:
    """`--mode predict --decoder beam` through the CLI (default batch 128,
    K=16, prune 6); checks its outputs and that each batch launched ctc_beam
    once and the encoder's route its LSTM kernels (route_counters). Returns
    the ctc_beam launches."""
    import torch

    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_lstm

    n_batches = -(-n_utts // BEAM_B)
    inf, _, _, per_batch = route_counters()
    reset_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "predict", "--decoder", "beam",
                       "--corpus_path", corpus, "--model_path", model_dir,
                       "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, lstm = cuda_beam.LAUNCHES, lstm_counts()
    print(f"[predict] --decoder beam: rc={rc} in {wall:.2f} s (host clock); "
          f"{n_utts} utterances in {n_batches} batch(es) of <= {BEAM_B}; "
          f"ctc_beam launches {launches}, LSTM launches {lstm}")
    check(rc == 0, "beam predict failed")
    check("CER:" in out and "WER:" in out, "beam predict: CER/WER not printed")
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        rows = fo.read().splitlines()
    check(len(rows) == n_utts and all("|" in r for r in rows),
          f"beam predict: predicted.txt has {len(rows)} rows for {n_utts}")
    check(launches == n_batches,
          f"ctc_beam launched {launches} times for {n_batches} batches")
    check(lstm == {**dict.fromkeys(lstm, 0), inf: per_batch * n_batches},
          f"beam predict: LSTM launches {lstm}, expected {per_batch} {inf} "
          f"x {n_batches}")
    return launches


def flagship_batch(dev, label_len: int = 60, vocab: int = 28,
                   batch: int = B):
    """`batch` (default B=64) utterances of 5 s (WAVE_SAMPLES, T=401
    frames) with random labels of 60 symbols (the length of 5 s of read
    English): int16 waves, lengths, labels, label lengths on the device."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    wave = (torch.randn(batch, WAVE_SAMPLES, generator=g) * 3000).to(
        torch.int16)
    ns = torch.full((batch,), WAVE_SAMPLES, dtype=torch.int32)
    labels = torch.randint(1, vocab, (batch, label_len), generator=g,
                           dtype=torch.int32)
    lens = torch.full((batch,), label_len, dtype=torch.int32)
    return tuple(a.to(dev) for a in (wave, ns, labels, lens))


def phase_train(dev, corpus, alphabet, d, bi):
    import numpy as np
    import torch

    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        loss_and_grads)

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    n_train = len(load_manifest(os.path.join(corpus, "train.tsv"), clips))
    dev_utts = load_manifest(os.path.join(corpus, "dev.tsv"), clips)
    n_test = len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
    steps, n_dev = -(-n_train // bs), -(-len(dev_utts) // bs)
    model_dir = os.path.join(d, "trained")
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model_dir, "--device", str(dev), "--seed", str(SEED)]

    inf, res, bwd, per = route_counters()  # launches per forward
    reset_counts()
    t0 = time.perf_counter()
    rc, out = run_cli(argv + ["--num_epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lstm_counts()
    print(f"[train] rc={rc}, 1 epoch of {n_train} utterances ({steps} "
          f"steps of <= {bs}) + validation on {len(dev_utts)} in {wall:.2f} "
          f"s (host clock, includes WAV decode); launches {counts}")
    check(rc == 0, "train failed")
    check(counts == {**dict.fromkeys(counts, 0), res: per * steps,
                     bwd: per * steps, inf: per * n_dev},
          f"LSTM launches {counts}, expected {per} {res} and {per} {bwd} x "
          f"{steps} steps, {per} {inf} x {n_dev} dev batches")
    for name in ("model_best.pt", "model_last.pt", "train_loss.npy",
                 "val_losses.npy", "config.json"):
        check(os.path.exists(os.path.join(model_dir, name)), f"no {name}")
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    vl = np.load(os.path.join(model_dir, "val_losses.npy"))
    check(tl.shape == vl.shape == (1,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"losses {tl} {vl}")

    rc, out = run_cli(argv + ["--num_epochs", "2"])
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    check(rc == 0 and "resumed from epoch 1" in out and tl.shape == (2,)
          and np.isfinite(tl).all(), f"resume failed: {tl}")
    reset_counts()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model_dir, "--device", str(dev)])
    check(rc == 0 and "CER:" in out and "WER:" in out,
          "predict on the trained model failed")
    got = lstm_counts()
    check(got == {**dict.fromkeys(got, 0), inf: per * -(-n_test // bs)},
          f"predict on the trained model: LSTM launches {got}")
    counts["ctc_beam"] = run_beam_predict(dev, corpus, model_dir, n_test)

    # one batch: loss and every parameter gradient, kernel vs plain path
    params, cfg = load_model(model_dir, alphabet, device=dev)
    cfg = cfg.replace(model=ModelConfig(**{**cfg.model.__dict__,
                                           "dropout": 0.0}))
    utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    batch = next(iter(BatchIterator(utts, alphabet, bs, shuffle=False)))
    arrays = batch_to_device(batch, dev)
    loss_k, g_k = loss_and_grads(params, arrays, cfg)
    loss_p, g_p = loss_and_grads(params, arrays, cfg, use_kernel=False)
    torch.cuda.synchronize()
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max()).item() for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[train] one batch {tuple(batch.wave.shape)}, kernel vs plain "
          f"path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"train loss disagrees: {loss_k.item()} vs {loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()), f"gradients disagree: {grad_rel}")

    # one full train step at B=64 x 5 s, both dtypes
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    steps_ms = {}
    for dtype in ("float32", "bfloat16"):
        p_d, c_d = load_model(model_dir, alphabet, device=dev, dtype=dtype)
        opt = AdamW(c_d, p_d)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def step():
            _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
            opt.update(p_d, grads)

        ms = time_ms(step, 5)
        steps_ms[dtype] = ms
        fused = next(c for c in bi["cases"] if c["dtype"] == dtype)
        f, b = per * fused["res_ms"], per * fused["bwd_ms"]
        print(f"[train] step B={B} x 5 s (T={T}, labels 60), {dtype}: "
              f"{ms:.2f} ms; at phase 3f's times the {per} {res} launches "
              f"{f:.2f} ms ({f / ms:.0%}) and the {per} {bwd} launches "
              f"{b:.2f} ms ({b / ms:.0%})")
    return counts, steps_ms


def phase_attention(dev, corpus, alphabet, d, family, flash_cases):
    """One attention family at its full default width, flash_attention in
    config.json: `--mode predict` through the CLI, greedy and beam, with
    the flash_attn launch counts; the same weights with flash_attention
    false (no launch); kernel vs plain log-probs on one batch; the forward
    at B=64 x 5 s with and without the kernel, float32 and bfloat16."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.models import conformer_ctc, transformer_ctc
    from pg_asr_tpu_torch.ops import cuda_flash_attn, cuda_lstm
    from pg_asr_tpu_torch.predict import forward, load_model

    mod = conformer_ctc if family == "conformer" else transformer_ctc
    base = Config(model=ModelConfig(family=family, vocab_size=alphabet.size))
    sub = getattr(base, family)
    cfgs = {flash: base.replace(**{family: dataclasses.replace(
        sub, flash_attention=flash)}) for flash in (True, False)}
    params = mod.init_params(base.model, sub,
                             torch.Generator().manual_seed(SEED))
    dirs = {flash: os.path.join(d, f"{family}_{'flash' if flash else 'dense'}")
            for flash in (True, False)}
    for flash in (True, False):
        save_model(dirs[flash], params, cfgs[flash])
    n_params = sum(p.numel() for p in params.values())
    utts = load_manifest(os.path.join(corpus, "test.tsv"),
                         os.path.join(corpus, "clips"))
    per = sub.num_layers  # one attention per block
    print(f"[{family}] {sub.num_layers} blocks, d_model {sub.d_model}, "
          f"{sub.num_heads} heads, ffn {sub.ffn_dim}, vocab {alphabet.size}, "
          f"{n_params} params")

    counts = {}
    for name, flash, extra, bs in (("greedy", True, [], 32),
                                   ("beam", True, ["--decoder", "beam"],
                                    BEAM_B),
                                   ("greedy_dense", False, [], 32)):
        n_batches = -(-len(utts) // bs)
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", dirs[flash], "--device", str(dev),
                           *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, beams = cuda_flash_attn.LAUNCHES, cuda_beam.LAUNCHES
        print(f"[{family}] predict {name} (flash_attention {flash}): rc={rc} "
              f"in {wall:.2f} s (host clock); {len(utts)} utterances in "
              f"{n_batches} batch(es) of <= {bs}; flash_attn launches "
              f"{launches}, ctc_beam launches {beams}")
        check(rc == 0 and "CER:" in out and "WER:" in out,
              f"{family} predict {name} failed")
        with open(os.path.join(dirs[flash], "predicted.txt")) as fo:
            rows = fo.read().splitlines()
        check(len(rows) == len(utts) and all("|" in r for r in rows),
              f"{family} {name}: predicted.txt has {len(rows)} rows")
        want = per * n_batches if flash else 0
        check(launches == want, f"{family} {name}: flash_attn launched "
              f"{launches} times, expected {want}")
        check(beams == (n_batches if extra else 0)
              and not any(lstm_counts().values()),
              f"{family} {name}: ctc_beam {beams}, LSTM {lstm_counts()} "
              "launches")
        counts[name] = launches

    # one batch: the forward with the kernel vs with the plain attention
    params_d, cfg_d = load_model(dirs[True], alphabet, device=dev)
    batch = next(iter(BatchIterator(utts, alphabet, 32, shuffle=False)))
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    lp_k, mask_k, lens_k = forward(params_d, wave, ns, cfg_d)
    lp_p, _, _ = forward(params_d, wave, ns, cfg_d, use_kernel=False)
    torch.cuda.synchronize()
    T_b = batch.wave.shape[1] // cfg_d.features.hop_length + 1
    To = -(-T_b // sub.subsample)
    check(tuple(lp_k.shape) == (len(batch.texts), To, alphabet.size)
          and bool(torch.isfinite(lp_k).all()),
          f"{family} log-probs {tuple(lp_k.shape)}")
    check(int(lens_k.max()) <= To and bool((mask_k.sum(1) == lens_k).all()),
          f"{family} out_lens / out_mask disagree")
    err = (lp_k - lp_p).abs().max().item()
    print(f"[{family}] batch log-probs {tuple(lp_k.shape)}: kernel vs plain "
          f"attention max_abs_err {err:.3e} (bound {LOGPROB_BOUND:.0e})")
    check(err <= LOGPROB_BOUND, f"{family} log-probs disagree: {err}")

    # the forward (features + model) at B=64 x 5 s, dense and flash in
    # turns, then where its device time goes
    wave64, ns64 = flagship_batch(dev)[:2]
    fwd_ms, breakdown = {}, {}
    for dtype in ("float32", "bfloat16"):
        run = {}
        for flash in (True, False):
            p_d, c_d = load_model(dirs[flash], alphabet, device=dev,
                                  dtype=dtype)
            run[flash] = (lambda p_d=p_d, c_d=c_d:
                          forward(p_d, wave64, ns64, c_d))
        ms = dict(zip((True, False), in_turns(run[False], run[True], 10, 10)))
        for flash in (True, False):
            key = f"{dtype}_{'flash' if flash else 'dense'}"
            fwd_ms[key] = ms[flash]
            breakdown[key] = device_breakdown(run[flash])
            busy = sum(breakdown[key].values())
            print(f"[{family}] forward B={B} x 5 s (T={T}, T'={ATTN_T}), "
                  f"{dtype}, flash_attention {flash}: {ms[flash]:.2f} ms "
                  f"(in turns); device time per forward {busy:.2f} ms: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in
                              breakdown[key].items())
                  + f"; device idle {max(0.0, 1 - busy / ms[flash]):.0%}")
    return {"launches": counts, "logprob_max_abs_err": err,
            "forward_ms": fwd_ms, "device_ms": breakdown}


def flash_counts() -> dict:
    from pg_asr_tpu_torch.ops import cuda_flash_attn as c

    return {"flash_attn": c.LAUNCHES, "flash_attn_residual": c.RES_LAUNCHES,
            "flash_attn_bwd_dkv": c.DKV_LAUNCHES,
            "flash_attn_bwd_dq": c.DQ_LAUNCHES}


def reset_counts() -> None:
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_flash_attn as c
    from pg_asr_tpu_torch.ops import cuda_joint, cuda_lstm

    c.LAUNCHES = c.RES_LAUNCHES = c.DKV_LAUNCHES = c.DQ_LAUNCHES = 0
    cuda_lstm.LAUNCHES = cuda_lstm.RES_LAUNCHES = cuda_lstm.BWD_LAUNCHES = 0
    cuda_lstm.BI_LAUNCHES = cuda_lstm.BI_RES_LAUNCHES = 0
    cuda_lstm.BI_BWD_LAUNCHES = 0
    cuda_beam.LAUNCHES = 0
    cuda_joint.FWD_LAUNCHES = cuda_joint.BWD_LAUNCHES = 0


def phase_attention_train(dev, corpus, alphabet, d, family):
    """Training one attention family at its full default width with
    flash_attention through the CLI: launch counts, artifacts, a resume
    that omits --model and --flash_attention, predict on the trained model;
    kernel vs plain gradients; a --remat step; the train step at B=64 x 5 s
    in turns with flash_attention on and off, and its device breakdown."""
    import dataclasses

    import numpy as np
    import torch

    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import AdamW, batch_to_device, loss_and_grads

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    train_utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    n_test = len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
    steps = -(-len(train_utts) // bs)
    model_dir = os.path.join(d, f"{family}_trained")
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model_dir, "--device", str(dev), "--seed", str(SEED)]
    per = 6  # attention blocks of the default width
    want = {"flash_attn": per * n_dev, "flash_attn_residual": per * steps,
            "flash_attn_bwd_dkv": per * steps,
            "flash_attn_bwd_dq": per * steps}

    def no_lstm_or_beam():
        return sum(lstm_counts().values()) + cuda_beam.LAUNCHES == 0

    counts = {}
    for epochs, extra in ((1, ["--model", family, "--flash_attention"]),
                          (2, [])):
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(argv + ["--num_epochs", str(epochs), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = flash_counts()
        print(f"[{family} train] epoch {epochs}: rc={rc} in {wall:.2f} s "
              f"(host clock, includes WAV decode); {steps} steps of <= {bs} "
              f"+ {n_dev} dev batches; launches {got}")
        check(rc == 0, f"{family} train epoch {epochs} failed")
        check(got == want and no_lstm_or_beam(),
              f"{family} train epoch {epochs}: launches {got}, expected "
              f"{want} and no lstm or beam launch")
        counts[f"epoch{epochs}"] = got
    check("resumed from epoch 1" in out
          and f"resuming with model family '{family}'" in out,
          f"{family}: the second run did not resume the family")
    with open(os.path.join(model_dir, "config.json")) as fo:
        saved = json.load(fo)
    check(saved["model"]["family"] == family
          and saved[family]["flash_attention"] is True,
          f"{family}: the resume lost the family's config")
    for name in ("model_best.pt", "model_last.pt", "val_losses.npy"):
        check(os.path.exists(os.path.join(model_dir, name)), f"no {name}")
    tl = np.load(os.path.join(model_dir, "train_loss.npy"))
    vl = np.load(os.path.join(model_dir, "val_losses.npy"))
    check(tl.shape == vl.shape == (2,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"{family} losses {tl} {vl}")
    print(f"[{family} train] train losses {tl.tolist()}, val losses "
          f"{vl.tolist()}")

    for decoder, n_batches in (("greedy", -(-n_test // bs)),
                               ("beam", -(-n_test // BEAM_B))):
        reset_counts()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", model_dir, "--device", str(dev),
                           "--decoder", decoder])
        got = flash_counts()
        check(rc == 0 and "CER:" in out and "WER:" in out,
              f"{family} predict {decoder} on the trained model failed")
        check(got["flash_attn"] == per * n_batches
              and got["flash_attn_residual"] == got["flash_attn_bwd_dkv"]
              == got["flash_attn_bwd_dq"] == 0
              and cuda_beam.LAUNCHES == (n_batches if decoder == "beam"
                                         else 0),
              f"{family} predict {decoder}: launches {got}, ctc_beam "
              f"{cuda_beam.LAUNCHES}")
        counts[f"predict_{decoder}"] = got

    # one batch: loss and every parameter gradient, kernel vs plain path
    params, cfg = load_model(model_dir, alphabet, device=dev)
    sub = getattr(cfg, family)
    cfg0 = cfg.replace(**{family: dataclasses.replace(sub, dropout=0.0)})
    batch = next(iter(BatchIterator(train_utts, alphabet, bs,
                                    shuffle=False)))
    arrays = batch_to_device(batch, dev)
    loss_k, g_k = loss_and_grads(params, arrays, cfg0)
    loss_p, g_p = loss_and_grads(params, arrays, cfg0, use_kernel=False)
    torch.cuda.synchronize()
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max()).item() for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[{family} train] one batch {tuple(batch.wave.shape)}, kernel vs "
          f"plain path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"{family} train loss disagrees: {loss_k.item()} vs "
          f"{loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()),
          f"{family} gradients disagree: {grad_rel}")

    # one --remat step at the trained config's dropout: the forward kernel
    # runs twice per block, and the gradients equal those without remat
    remat = {}
    for on in (False, True):
        c = cfg.replace(model=dataclasses.replace(cfg.model, remat=on))
        reset_counts()
        remat[on] = loss_and_grads(params, arrays, c, torch.Generator(
            device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        counts["remat_step" if on else "step"] = flash_counts()
    r_rel = max(((remat[True][1][k] - remat[False][1][k]).abs().max()
                 / remat[False][1][k].abs().max()).item() for k in g_p)
    print(f"[{family} train] --remat step (dropout {sub.dropout}): launches "
          f"{counts['remat_step']} (without: {counts['step']}); gradients vs "
          f"without remat: worst max|diff|/max|grad| {r_rel:.2e} (bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(counts["remat_step"] == {
        "flash_attn": 0, "flash_attn_residual": 2 * per,
        "flash_attn_bwd_dkv": per, "flash_attn_bwd_dq": per},
        f"{family} --remat step launches {counts['remat_step']}")
    check(r_rel <= TRAIN_GRAD_REL, f"{family} --remat gradients differ")

    # the train step at B=64 x 5 s, flash on and off in turns, both dtypes
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    step_ms, breakdown = {}, {}
    for dtype in ("float32", "bfloat16"):
        run = {}
        for flash in (True, False):
            p_d, c_d = load_model(model_dir, alphabet, device=dev,
                                  dtype=dtype)
            c_d = c_d.replace(**{family: dataclasses.replace(
                getattr(c_d, family), flash_attention=flash)})
            opt = AdamW(c_d, p_d)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def step(p_d=p_d, c_d=c_d, opt=opt, gen=gen):
                _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
                opt.update(p_d, grads)

            run[flash] = step
        ms = dict(zip((True, False), in_turns(run[False], run[True], 5, 5)))
        for flash in (True, False):
            key = f"{dtype}_{'flash' if flash else 'dense'}"
            step_ms[key] = ms[flash]
            breakdown[key] = device_breakdown(run[flash])
            busy = sum(breakdown[key].values())
            print(f"[{family} train] step B={B} x 5 s (T={T}, T'={ATTN_T}, "
                  f"labels 60), {dtype}, flash_attention {flash}: "
                  f"{ms[flash]:.2f} ms (in turns); device time per step "
                  f"{busy:.2f} ms: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in breakdown[key].items())
                  + f"; device idle {max(0.0, 1 - busy / ms[flash]):.0%}")
    return {"launches": counts, "loss_rel": loss_rel,
            "worst_grad_rel": grad_rel[worst], "remat_grad_rel": r_rel,
            "step_ms": step_ms, "device_ms": breakdown}


def joint_counts() -> dict:
    from pg_asr_tpu_torch.ops import cuda_joint as j

    return {"joint_fwd": j.FWD_LAUNCHES, "joint_bwd": j.BWD_LAUNCHES}


def load_trained(model_dir, dev, dtype=None, **changes):
    """A trained model's params (LayerNorm float32) and config, with the
    compute dtype and any config sections replaced by `changes`."""
    import dataclasses

    from pg_asr_tpu_torch.checkpoint import checkpoint_path, load_checkpoint
    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.models import cast_params
    from pg_asr_tpu_torch.models.bilstm_ctc import torch_dtype

    with open(os.path.join(model_dir, "config.json")) as fo:
        cfg = Config.from_json(fo.read())
    if dtype:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype))
    cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                         for k, v in changes.items()})
    state = load_checkpoint(checkpoint_path(model_dir, "last"))["params"]
    return cast_params(state, torch_dtype(cfg.model.dtype), dev), cfg


def phase_transducer_train(dev, corpus, alphabet, d, joint_cases):
    """Training the RNN-T transducer at full default width (conformer
    encoder, 6 blocks, d_model 256, flash_attention; prediction net
    128/256, joint 256): the CLI (unfused joint: no joint launch), then
    train(config=...) with fused_joint (one joint_fwd and one joint_bwd
    per step, one joint_fwd per dev batch), a CLI resume that keeps it;
    kernel vs plain gradients; one step with the BiLSTM
    and the transformer encoders; the train step at B=64 x 5 s fused and
    unfused, float32 and bfloat16, in turns, with a device breakdown and
    the lattice loss timed alone."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         ModelConfig, TrainConfig,
                                         TransducerConfig, TransformerConfig)
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.models import transducer
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.transducer import transducer_loss_mean
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        init_model_params, loss_and_grads,
                                        train)

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    train_utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    steps = -(-len(train_utts) // bs)
    per = 6  # conformer blocks of the default width
    flash_want = {"flash_attn": per * n_dev, "flash_attn_residual": per * steps,
                  "flash_attn_bwd_dkv": per * steps,
                  "flash_attn_bwd_dq": per * steps}

    def no_lstm_or_beam():
        return sum(lstm_counts().values()) + cuda_beam.LAUNCHES == 0

    def check_run(tag, model_dir, n_epochs, joint_want):
        got = {**flash_counts(), **joint_counts()}
        want = {**flash_want, **joint_want}
        check(got == want and no_lstm_or_beam(),
              f"transducer {tag}: launches {got}, expected {want} and no "
              "lstm or beam launch")
        for name in ("model_best.pt", "model_last.pt", "config.json"):
            check(os.path.exists(os.path.join(model_dir, name)),
                  f"transducer {tag}: no {name}")
        tl = np.load(os.path.join(model_dir, "train_loss.npy"))
        vl = np.load(os.path.join(model_dir, "val_losses.npy"))
        check(tl.shape == vl.shape == (n_epochs,) and np.isfinite(tl).all()
              and np.isfinite(vl).all(), f"transducer {tag}: losses {tl} {vl}")
        return got, tl.tolist(), vl.tolist()

    counts, losses = {}, {}
    # 1. the CLI: the default unfused joint
    cli_dir = os.path.join(d, "transducer_cli")
    reset_counts()
    t0 = time.perf_counter()
    rc, _ = run_cli(["--mode", "train", "--corpus_path", corpus,
                     "--model_path", cli_dir, "--device", str(dev), "--seed",
                     str(SEED), "--num_epochs", "1", "--model", "transducer",
                     "--flash_attention"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, "transducer CLI train failed")
    counts["cli_unfused"], tl, vl = check_run(
        "CLI epoch (unfused)", cli_dir, 1, {"joint_fwd": 0, "joint_bwd": 0})
    print(f"[transducer train] CLI epoch (fused_joint false): {wall:.2f} s "
          f"(host clock, includes WAV decode); {steps} steps of <= {bs} + "
          f"{n_dev} dev batches; launches {counts['cli_unfused']}; train "
          f"loss {tl}, val loss {vl}")

    # 2. train(config=...) with fused_joint, then 3. a CLI resume
    fused_dir = os.path.join(d, "transducer_fused")
    cfg = Config(model=ModelConfig(family="transducer",
                                   vocab_size=alphabet.size),
                 conformer=ConformerConfig(flash_attention=True),
                 transducer=TransducerConfig(fused_joint=True),
                 train=TrainConfig(num_epochs=1, seed=SEED))
    joint_want = {"joint_fwd": steps + n_dev, "joint_bwd": steps}
    reset_counts()
    t0 = time.perf_counter()
    train(corpus, fused_dir, config=cfg, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["train_fused"], tl, vl = check_run("train(config=...) epoch",
                                              fused_dir, 1, joint_want)
    print(f"[transducer train] train(config=...) epoch, fused_joint true: "
          f"{wall:.2f} s; launches {counts['train_fused']}; train loss {tl}, "
          f"val loss {vl}")
    reset_counts()
    rc, out = run_cli(["--mode", "train", "--corpus_path", corpus,
                       "--model_path", fused_dir, "--device", str(dev),
                       "--num_epochs", "2"])
    check(rc == 0 and "resumed from epoch 1" in out
          and "resuming with model family 'transducer'" in out,
          "transducer: the CLI resume failed")
    counts["resume_fused"], tl, vl = check_run("resumed epoch", fused_dir,
                                               2, joint_want)
    with open(os.path.join(fused_dir, "config.json")) as fo:
        saved = json.load(fo)
    check(saved["transducer"]["fused_joint"] is True
          and saved["conformer"]["flash_attention"] is True,
          "transducer: the resume lost fused_joint or flash_attention")
    losses.update(train_losses=tl, val_losses=vl)
    print(f"[transducer train] resumed epoch 2 (CLI, no --model): launches "
          f"{counts['resume_fused']}; train losses {tl}, val losses {vl}")

    # 5. one batch: loss and every parameter gradient, kernel vs plain path
    params, cfg0 = load_trained(fused_dir, dev, model={"dropout": 0.0},
                                conformer={"dropout": 0.0})
    batch = next(iter(BatchIterator(train_utts, alphabet, bs,
                                    shuffle=False)))
    arrays = batch_to_device(batch, dev)
    reset_counts()
    loss_k, g_k = loss_and_grads(params, arrays, cfg0)
    torch.cuda.synchronize()
    counts["step"] = {**flash_counts(), **joint_counts()}
    loss_p, g_p = loss_and_grads(params, arrays, cfg0, use_kernel=False)
    torch.cuda.synchronize()
    check(counts["step"] == {**{k: per for k in flash_want}, "flash_attn": 0,
                             "joint_fwd": 1, "joint_bwd": 1},
          f"transducer step launches {counts['step']}")
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max()).item() for k in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"[transducer train] one batch {tuple(batch.wave.shape)}, kernel "
          f"vs plain path (float32, dropout 0): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
          f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
          f"{TRAIN_GRAD_REL:.0e})")
    check(math.isfinite(loss_k.item()) and loss_rel <= TRAIN_LOSS_REL,
          f"transducer loss disagrees: {loss_k.item()} vs {loss_p.item()}")
    check(all(math.isfinite(v) and v <= TRAIN_GRAD_REL
              for v in grad_rel.values()),
          f"transducer gradients disagree: {grad_rel}")

    # 6. one kernel-path step with the BiLSTM and the transformer encoders
    _, res, bwd, per = route_counters()
    want_by_enc = {
        "bilstm": {res: per, bwd: per},
        "transformer": {"flash_attn_residual": 6, "flash_attn_bwd_dkv": 6,
                        "flash_attn_bwd_dq": 6}}
    for enc, want in want_by_enc.items():
        c = Config(model=ModelConfig(family="transducer",
                                     vocab_size=alphabet.size),
                   transformer=TransformerConfig(flash_attention=True),
                   transducer=TransducerConfig(encoder=enc,
                                               fused_joint=True))
        p = init_model_params(c, torch.Generator().manual_seed(SEED), dev)
        reset_counts()
        loss, g = loss_and_grads(p, arrays, c, torch.Generator(
            device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        got = {**{k: v for k, v in flash_counts().items() if v},
               **{k: v for k, v in lstm_counts().items() if v},
               **joint_counts()}
        counts[f"step_{enc}"] = got
        print(f"[transducer train] one step, {enc} encoder (default width, "
              f"dropout on): loss {loss.item():.4f}, launches {got}")
        check(math.isfinite(loss.item()) and all(
            bool(torch.isfinite(v).all()) for v in g.values()),
            f"transducer {enc}: non-finite loss or gradient")
        check(got == {**want, "joint_fwd": 1, "joint_bwd": 1},
              f"transducer {enc} step launches {got}")

    # 7. the train step at B=64 x 5 s, fused and unfused in turns
    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    step_ms, breakdown = {}, {}
    for dtype in ("float32", "bfloat16"):
        run = {}
        for fused in (True, False):
            p_d, c_d = load_trained(fused_dir, dev, dtype,
                                    transducer={"fused_joint": fused})
            opt = AdamW(c_d, p_d)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def step(p_d=p_d, c_d=c_d, opt=opt, gen=gen):
                _, grads = loss_and_grads(p_d, arrays64, c_d, gen)
                opt.update(p_d, grads)

            run[fused] = step
        torch.cuda.reset_peak_memory_stats()
        ms = dict(zip((True, False), in_turns(run[False], run[True], 3, 3)))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for fused in (True, False):
            key = f"{dtype}_{'fused' if fused else 'unfused'}"
            step_ms[key] = ms[fused]
            breakdown[key] = device_breakdown(run[fused])
            busy = sum(breakdown[key].values())
            kern = ""
            if fused:
                jk = next(c for c in joint_cases if c["dtype"] == dtype)
                jms = jk["fwd_ms"] + jk["bwd_ms"]
                kern = (f"; joint_fwd + joint_bwd at phase 3e's times "
                        f"{jms:.2f} ms ({jms / ms[fused]:.0%})")
            print(f"[transducer train] step B={B} x 5 s (T'={ATTN_T}, "
                  f"labels 60), {dtype}, fused_joint {fused}: "
                  f"{ms[fused]:.2f} ms (in turns); device time per step "
                  f"{busy:.2f} ms: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in breakdown[key].items())
                  + f"; device idle {max(0.0, 1 - busy / ms[fused]):.0%}"
                  + kern)
        print(f"[transducer train] {dtype}: peak device memory over both "
              f"steps {peak_gb:.2f} GB")

    # the lattice loss alone, forward + backward, on the step's tables
    p_d, c_d = load_trained(fused_dir, dev, "float32")
    with torch.no_grad():
        from pg_asr_tpu_torch.ops.features import extract_features

        feats, mask, flens = extract_features(*arrays64[:2], c_d.features)
        out = transducer.apply_lattice(p_d, feats, mask, flens,
                                       *arrays64[2:], c_d)
    lb, ly = (t.detach().requires_grad_(True) for t in out[:2])

    def lattice_loss():
        loss = transducer_loss_mean(lb, ly, out[2], arrays64[3])
        torch.autograd.grad(loss, (lb, ly))

    loss_ms = time_ms(lattice_loss, 5)
    loss_dev = sum(device_breakdown(lattice_loss).values())
    print(f"[transducer train] lattice loss alone (T'+U = {ATTN_T + 60} "
          f"diagonals), forward + backward: {loss_ms:.2f} ms, device time "
          f"{loss_dev:.2f} ms")
    return {"launches": counts, "losses": losses, "loss_rel": loss_rel,
            "worst_grad_rel": grad_rel[worst], "step_ms": step_ms,
            "device_ms": breakdown, "lattice_loss_ms": loss_ms,
            "lattice_loss_device_ms": loss_dev}


def phase_transducer_predict(dev, corpus, alphabet, model_dir):
    """Transcription with the transducer phase 8 trained (conformer encoder,
    flash_attention): `--mode predict` through the CLI, greedy (batch 32)
    and beam (batch 128, K=16), with 6 flash_attn launches per batch and no
    other kernel; one batch's labels on the kernel path against the plain
    path; the encoder and each decoder timed apart at B=64 x 5 s (greedy)
    and B=128 x 5 s (beam), host clock and device time."""
    import re

    import torch

    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.decoding.transducer import (
        transducer_beam_decode, transducer_greedy_decode)
    from pg_asr_tpu_torch.models import transducer
    from pg_asr_tpu_torch.ops.features import extract_features

    utts = load_manifest(os.path.join(corpus, "test.tsv"),
                         os.path.join(corpus, "clips"))
    per, K = 6, 16  # conformer blocks of the default width; the beam width

    def others_zero():
        return (sum(lstm_counts().values()) + cuda_beam.LAUNCHES
                + sum(joint_counts().values())) == 0

    counts, stats = {}, {}
    for decoder, bs in (("greedy", 32), ("beam", 128)):
        extra = ["--decoder", "beam"] if decoder == "beam" else []
        n_batches = -(-len(utts) // bs)
        path = os.path.join(model_dir, "predicted.txt")
        if os.path.exists(path):
            os.remove(path)
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", model_dir, "--device", str(dev),
                           *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[decoder] = flash_counts()["flash_attn"]
        m = re.search(r"CER: (\S+) WER: (\S+)", out)
        check(rc == 0 and m is not None, f"transducer predict {decoder} failed")
        cer, wer = float(m.group(1)), float(m.group(2))
        with open(path) as fo:
            lines = fo.read().splitlines()
        check(len(lines) == len(utts) and all("|" in ln for ln in lines)
              and math.isfinite(cer) and math.isfinite(wer),
              f"transducer predict {decoder}: {len(lines)} lines, CER {cer}, "
              f"WER {wer}")
        check(counts[decoder] == per * n_batches and others_zero()
              and flash_counts()["flash_attn_residual"] == 0,
              f"transducer predict {decoder}: flash_attn launches "
              f"{counts[decoder]}, expected {per * n_batches} and no other "
              "kernel")
        stats[decoder] = {"cer": cer, "wer": wer, "wall_s": wall,
                          "batches": n_batches}
        print(f"[transducer predict] CLI --decoder {decoder}: {wall:.2f} s "
              f"(host clock, includes WAV decode), {len(utts)} utterances in "
              f"{n_batches} batches of <= {bs}; {counts[decoder]} flash_attn "
              f"launches; CER {cer:.4f} WER {wer:.4f}")

    # one batch: the kernel path against the plain path (use_kernel=False)
    params, cfg = load_trained(model_dir, dev)
    L = cfg.decode.max_label_len
    batch = next(iter(BatchIterator(utts, alphabet, 32, shuffle=False)))
    wave = torch.from_numpy(batch.wave).to(dev)
    ns = torch.from_numpy(batch.num_samples).to(dev)
    res = {}
    with torch.inference_mode():
        feats, mask, flens = extract_features(wave, ns, cfg.features)
        for use_kernel in (True, False):
            reset_counts()
            enc, _, olens = transducer.encode(params, feats, mask, flens, cfg,
                                              use_kernel=use_kernel)
            res[use_kernel] = (
                enc, transducer_greedy_decode(params, enc, olens, cfg,
                                              max_label_len=L),
                transducer_beam_decode(params, enc, olens, cfg, beam_size=K,
                                       max_label_len=L),
                flash_counts()["flash_attn"])
    torch.cuda.synchronize()
    (enc_k, g_k, b_k, n_k), (enc_p, g_p, b_p, n_p) = res[True], res[False]
    enc_err = _errs(enc_k, enc_p)[0]
    nll_rel = ((b_k[2] - b_p[2]).abs() / b_p[2].abs()).max().item()
    print(f"[transducer predict] one batch of {wave.shape[0]}, kernel vs "
          f"plain path (float32): encoder states max abs diff {enc_err:.2e}; "
          f"greedy labels equal {torch.equal(g_k[0], g_p[0])}, beam labels "
          f"equal {torch.equal(b_k[0], b_p[0])}, beam nll rel diff "
          f"{nll_rel:.2e} (bound {TRANSDUCER_NLL_REL:.0e}); flash_attn "
          f"launches {n_k} / {n_p}")
    check(n_k == per and n_p == 0, f"flash_attn launches {n_k} / {n_p}")
    check(all(torch.equal(a, b) for a, b in zip(g_k, g_p))
          and torch.equal(b_k[0], b_p[0]) and torch.equal(b_k[1], b_p[1])
          and nll_rel <= TRANSDUCER_NLL_REL,
          "transducer decode: kernel path and plain path disagree")

    # the encoder and each decoder apart: CUDA events for the encoder, host
    # clock around a synchronised decode, device time from a profiler trace
    timing = {}
    for decoder, nb in (("greedy", B), ("beam", BEAM_B)):
        wave, ns = flagship_batch(dev, vocab=alphabet.size, batch=nb)[:2]
        with torch.inference_mode():
            feats, mask, flens = extract_features(wave, ns, cfg.features)

            def encode():
                with torch.inference_mode():
                    return transducer.encode(params, feats, mask, flens, cfg)

            enc, _, olens = encode()

            def decode():
                with torch.inference_mode():
                    if decoder == "beam":
                        return transducer_beam_decode(
                            params, enc, olens, cfg, beam_size=K,
                            max_label_len=L)[:2]
                    return transducer_greedy_decode(params, enc, olens, cfg,
                                                    max_label_len=L)

            enc_ms = time_ms(encode, 3)
            decode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels, lens = decode()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            dev_ms = sum(device_breakdown(decode, reps=1).values())
        check(bool((lens >= 0).all()) and labels.shape == (nb, L),
              f"transducer {decoder} decode output")
        timing[decoder] = {"batch": nb, "encoder_ms": enc_ms,
                           "decode_host_ms": host_ms,
                           "decode_device_ms": dev_ms,
                           "mean_labels": lens.float().mean().item()}
        print(f"[transducer predict] {decoder} at B={nb} x 5 s (T'="
              f"{ATTN_T}, K={K if decoder == 'beam' else 1}, float32): "
              f"encoder {enc_ms:.2f} ms (CUDA events); decode {host_ms:.2f} "
              f"ms host clock, {dev_ms:.2f} ms device time "
              f"({1 - dev_ms / host_ms:.0%} idle); "
              f"{timing[decoder]['mean_labels']:.1f} labels per utterance")
    return {"launches": counts, "stats": stats, "enc_max_abs_diff": enc_err,
            "beam_nll_rel": nll_rel, "timing": timing}


def all_counts() -> dict:
    """Every launch counter of the port, by kernel row name."""
    from pg_asr_tpu_torch.decoding import cuda_beam

    return {**lstm_counts(), **flash_counts(), **joint_counts(),
            "ctc_beam": cuda_beam.LAUNCHES}


@contextlib.contextmanager
def fixed_draws(paths, nbest):
    """rl/reinforce.py's loss takes these sampled paths and this n-best in
    place of its sampler's and its beam's (both restored after), so that
    the kernel path and the plain path score the same hypotheses."""
    from pg_asr_tpu_torch.rl import reinforce as rl

    saved = rl._sample_paths, rl.beam_decode_nbest
    rl._sample_paths = lambda generator, lp, S, temperature: paths
    rl.beam_decode_nbest = lambda *args, **kwargs: nbest
    try:
        yield
    finally:
        rl._sample_paths, rl.beam_decode_nbest = saved


def phase_pg(dev, corpus, alphabet, d, bi, beam_cases, train_steps_ms):
    """10. Policy-gradient fine-tuning (`--mode finetune_pg`) of the
    BiLSTM-CTC phase 5 trained and of the transducer phase 8 trained, through
    the CLI: launch counts per step and per dev batch, the artifacts, a
    resumed run, predict on the result; kernel vs plain path on one batch;
    the PG step at B=64 x 5 s timed with its breakdown."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.decoding.beam import beam_decode_nbest
    from pg_asr_tpu_torch.decoding.greedy import greedy_decode
    from pg_asr_tpu_torch.ops.edit_distance import cer_from_ids
    from pg_asr_tpu_torch.predict import forward, load_model
    from pg_asr_tpu_torch.rl import reinforce as rl
    from pg_asr_tpu_torch.rl.reward import sequence_reward
    from pg_asr_tpu_torch.train import (AdamW, batch_to_device,
                                        value_and_grad)

    bs = 32  # the CLI's default
    clips = os.path.join(corpus, "clips")
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    n_test = -(-len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
               // bs)
    inf, res, bwd, per = route_counters()
    src = os.path.join(d, "trained")  # phase 5's BiLSTM-CTC
    space = alphabet.char2ind.get(" ", -1)
    out_counts = {}

    def run_pg(model_dir, steps, every, *extra):
        reset_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(["--mode", "finetune_pg", "--corpus_path", corpus,
                           "--model_path", model_dir, "--device", str(dev),
                           "--pg_steps", str(steps), "--pg_eval_every",
                           str(every), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"finetune_pg {extra} failed")
        return out, wall, all_counts()

    def want(steps, evals, beams=0):
        w = dict.fromkeys(all_counts(), 0)
        w.update({res: per * steps, bwd: per * steps,
                  inf: per * n_dev * evals, "ctc_beam": beams})
        return w

    def rewards_of(model_dir, n):
        r = np.load(os.path.join(model_dir, "pg_rewards.npy"))
        check(r.shape == (n,) and np.isfinite(r).all(),
              f"pg_rewards.npy: {r}")
        return r

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    # 1. REINFORCE through the CLI, 20 steps and dev CER every 10, resumed
    model = os.path.join(d, "pg_reinforce")
    shutil.copytree(src, model)
    out, wall, counts = run_pg(model, 20, 10)
    print(f"[pg] REINFORCE: 20 steps of {bs} + 2 x {n_dev} dev batches in "
          f"{wall:.2f} s (host clock, includes WAV decode); launches "
          f"{nonzero(counts)}")
    check(counts == want(20, 2),
          f"REINFORCE launches {counts}, expected {per} {res} and {per} "
          f"{bwd} a step, {per} {inf} a dev batch")
    out_counts["finetune_pg_reinforce"] = counts
    r = rewards_of(model, 20)
    cer = np.load(os.path.join(model, "pg_dev_cer.npy"))
    check(cer.shape == (2, 2) and cer[:, 0].tolist() == [10, 20]
          and np.isfinite(cer).all(), f"pg_dev_cer.npy: {cer}")
    last = load_checkpoint(os.path.join(model, "model_last.pt"))
    check(last["epoch"] == -1 and last["step"] == 20,
          f"model_last: epoch {last['epoch']}, step {last['step']}")
    print(f"[pg] rewards {r[0]:.4f} .. {r[-1]:.4f}, dev CER "
          f"{cer[:, 1].tolist()}")
    out, wall, counts = run_pg(model, 30, 10)
    check("[pg] resumed from model_last at step 20" in out
          and "[pg] 30 steps" in out, "REINFORCE: the resume failed")
    check(counts == want(10, 1), f"resumed run's launches {counts}")
    rewards_of(model, 10)
    check(load_checkpoint(os.path.join(model, "model_last.pt"))["step"]
          == 30, "the resumed run did not end at step 30")
    print(f"[pg] resumed at step 20, ended at 30 in {wall:.2f} s; launches "
          f"{nonzero(counts)}")
    reset_counts()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model, "--device", str(dev)])
    got = lstm_counts()
    check(rc == 0 and "CER:" in out and got == {
        **dict.fromkeys(got, 0), inf: per * n_test},
        f"predict on the fine-tuned model: rc {rc}, launches {got}")

    # 2. MWER through the CLI (K=4): one ctc_beam launch a step
    model = os.path.join(d, "pg_mwer")
    shutil.copytree(src, model)
    out, wall, counts = run_pg(model, 4, 4, "--pg_objective", "mwer",
                               "--mwer_beam", "4")
    print(f"[pg] MWER (K=4): 4 steps + {n_dev} dev batches in {wall:.2f} s; "
          f"launches {nonzero(counts)}")
    check(counts == want(4, 1, beams=4), f"MWER launches {counts}")
    out_counts["finetune_pg_mwer"] = counts
    rewards_of(model, 4)

    # 3. one batch, kernel path vs plain path: the same paths and n-best
    params, cfg = load_model(src, alphabet, device=dev)
    utts = load_manifest(os.path.join(corpus, "train.tsv"), clips)
    batch = next(iter(BatchIterator(utts, alphabet, bs, shuffle=False)))
    arrays = batch_to_device(batch, dev)
    lp, _, fl = forward(params, arrays[0], arrays[1], cfg)
    L = arrays[2].shape[1]
    paths = rl._sample_paths(torch.Generator(device=dev).manual_seed(SEED),
                             lp, cfg.rl.num_samples, cfg.rl.temperature)
    nbest = beam_decode_nbest(lp, fl, beam_size=4, max_label_len=L)
    plain = beam_decode_nbest(lp, fl, beam_size=4, max_label_len=L,
                              use_kernel=False)
    check(torch.equal(nbest[0], plain[0]) and torch.equal(nbest[1], plain[1]),
          "the n-best of ctc_beam differs from the plain scan's")
    nll_rel = ((nbest[2] - plain[2]).abs() / plain[2].abs().clamp(min=1))
    nll_rel = nll_rel[plain[2] < 1e29].max().item()
    check(nll_rel <= BEAM_NLL_REL, f"n-best nll rel error {nll_rel}")
    compare = {"nbest_nll_rel": nll_rel}
    for objective in ("reinforce", "mwer"):
        c = cfg.replace(rl=dataclasses.replace(
            cfg.rl, objective=objective, baseline="mean", mwer_beam=4,
            space_id=space))
        got = {}
        with fixed_draws(paths, nbest):
            for use_kernel in (True, False):
                (loss, _), grads = value_and_grad(
                    lambda p: rl.pg_loss_fn(p, *arrays, None, c, use_kernel),
                    params)
                got[use_kernel] = loss.item(), grads
        (loss_k, g_k), (loss_p, g_p) = got[True], got[False]
        loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-6)
        grad_rel = {k: ((g_k[k] - g_p[k]).abs().max()
                        / g_p[k].abs().max().clamp(min=1e-30)).item()
                    for k in g_p}
        worst = max(grad_rel, key=grad_rel.get)
        print(f"[pg] {objective}, one batch {tuple(batch.wave.shape)}, "
              f"kernel vs plain path (float32, same paths / n-best): loss "
              f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, bound "
              f"{PG_LOSS_REL:.0e}); {len(grad_rel)} gradients, worst "
              f"max|diff|/max|grad| {grad_rel[worst]:.2e} ({worst}; bound "
              f"{PG_GRAD_REL:.0e})")
        check(math.isfinite(loss_k) and loss_rel <= PG_LOSS_REL,
              f"{objective}: PG loss disagrees: {loss_k} vs {loss_p}")
        check(all(math.isfinite(v) and v <= PG_GRAD_REL
                  for v in grad_rel.values()),
              f"{objective}: gradients disagree: {grad_rel}")
        compare[objective] = {"loss_rel": loss_rel,
                              "grad_rel_worst": grad_rel[worst]}

    # 4. the PG step at B=64 x 5 s, both objectives, float32 and bfloat16
    wave64, ns64, labels64, lens64 = arrays64 = flagship_batch(
        dev, vocab=alphabet.size)
    timing = {}
    for dtype in ("float32", "bfloat16"):
        fused = next(c for c in bi["cases"] if c["dtype"] == dtype)
        for objective in ("reinforce", "mwer"):
            p_d, c_d = load_model(src, alphabet, device=dev, dtype=dtype)
            c_d = c_d.replace(rl=dataclasses.replace(
                c_d.rl, objective=objective, space_id=space))
            opt = AdamW(c_d, p_d, learning_rate=c_d.train.learning_rate * 0.1,
                        weight_decay=1e-4)
            step = rl.make_pg_step(c_d, opt)
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def run():
                return step(p_d, gen, *arrays64)

            reset_counts()
            run()
            torch.cuda.synchronize()
            counts = all_counts()
            check(counts == want(1, 0, beams=int(objective == "mwer")),
                  f"PG step launches {counts}")
            ms = time_ms(run, 5)
            groups = device_breakdown(run, 3, PG_GROUPS, pg_group)
            dev_ms = sum(groups.values())
            kern = per * (fused["res_ms"] + fused["bwd_ms"])
            timing[f"{objective}_{dtype}"] = {
                "ms": ms, "device_ms": dev_ms, "idle": 1 - dev_ms / ms,
                "groups": groups, "lstm_at_phase_3f_ms": kern}
            print(f"[pg] {objective} step B={B} x 5 s (T={T}, labels 60), "
                  f"{dtype}: {ms:.2f} ms (supervised step, phase 5: "
                  f"{train_steps_ms[dtype]:.2f}); at phase 3f's times the "
                  f"{per} {res} + {per} {bwd} launches {kern:.2f} ms; device "
                  f"{dev_ms:.2f} ms ({1 - dev_ms / ms:.0%} idle): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in groups.items()))

    # the reward DP and the n-best alone, on the float32 model's log-probs
    p32, c32 = load_model(src, alphabet, device=dev)
    lp64, mask64, fl64 = forward(p32, wave64, ns64, c32)
    S, K = c32.rl.num_samples, 4
    paths64 = rl._sample_paths(torch.Generator(device=dev).manual_seed(SEED),
                               lp64, S, c32.rl.temperature)

    def reinforce_rewards():
        R, _, _ = rl._path_rewards(paths64, mask64, labels64, lens64,
                                   "neg_cer")
        ids, n = greedy_decode(lp64, mask64)
        return R, sequence_reward(labels64, lens64, ids, n)

    hyp = beam_decode_nbest(lp64, fl64, beam_size=K, max_label_len=60)

    def mwer_risk():
        return cer_from_ids(labels64.repeat_interleave(K, 0),
                            lens64.repeat_interleave(K),
                            hyp[0].flatten(0, 1), hyp[1].flatten())

    dp = {"reinforce_rewards": {"host_ms": host_ms(reinforce_rewards, 5),
                                "device_ops": device_ops(reinforce_rewards)},
          "mwer_risk": {"host_ms": host_ms(mwer_risk, 5),
                        "device_ops": device_ops(mwer_risk)},
          "nbest_ms": time_ms(lambda: beam_decode_nbest(
              lp64, fl64, beam_size=K, max_label_len=60), 5)}
    print(f"[pg] B={B} x 5 s, float32: REINFORCE rewards (S={S} paths of "
          f"{T} frames against 60 labels, + the greedy baseline) "
          f"{dp['reinforce_rewards']['host_ms']:.2f} ms host, "
          f"{dp['reinforce_rewards']['device_ops']} device ops; MWER risk "
          f"(B x K = {B * K} rows) {dp['mwer_risk']['host_ms']:.2f} ms, "
          f"{dp['mwer_risk']['device_ops']} device ops; the n-best (one "
          f"ctc_beam launch, K={K}, exact) {dp['nbest_ms']:.3f} ms "
          f"(phase 3b, K=16 at B=128: {beam_cases[0]['ms']:.3f} ms at M=6)")

    # 5. the transducer phase 8 trained (fused_joint, conformer encoder with
    # flash attention): MWER through the CLI
    tdir = os.path.join(d, "pg_transducer")
    shutil.copytree(os.path.join(d, "transducer_fused"), tdir)
    out, wall, counts = run_pg(tdir, 2, 0, "--mwer_beam", "4")
    blocks = 6  # conformer blocks of the default width
    tr_want = {**dict.fromkeys(counts, 0), "joint_fwd": 4, "joint_bwd": 4,
               "flash_attn_residual": 2 * blocks,
               "flash_attn_bwd_dkv": 2 * blocks,
               "flash_attn_bwd_dq": 2 * blocks}
    print(f"[pg] transducer MWER (K=4, fused joint): 2 steps of {bs} in "
          f"{wall:.2f} s; launches {nonzero(counts)}")
    check("[pg] transducer family: using the MWER objective" in out,
          "the transducer did not switch to MWER")
    check(counts == tr_want, f"transducer PG launches {counts}, expected "
          "a joint_fwd and a joint_bwd for the n-best and for the anchor "
          "each step")
    out_counts["finetune_pg_transducer"] = counts
    rewards_of(tdir, 2)
    return {"launches": out_counts, "compare": compare, "timing": timing,
            "reward_dp": dp}


# phase 11: the supervised training recipe through the CLI
RECIPE = ["--specaugment", "--speed_perturb", "0.9,1.1", "--wave_noise",
          "0.1", "--wave_gain_db", "3", "--accum_steps", "2", "--ema_decay",
          "0.999", "--keep_ckpts", "2", "--save_every_steps", "5",
          "--val_metric", "cer", "--loader_threads", "2", "--cache_audio_mb",
          "64", "--profile_steps", "2", "--num_epochs", "3"]
# an interrupted-and-resumed run vs an uninterrupted one on the card: the
# batches, the steps and every draw are the same (the step generator's
# state is in the checkpoint), and only F.ctc_loss's CUDA backward (atomic
# adds) sums in another order, so the epochs after the resume may differ by
# float32 rounding carried through a few dozen AdamW steps at a warmup rate
RESUME_LOSS_REL = 5e-3


@contextlib.contextmanager
def recorded_batches():
    """Every batch the trainer moves to the device (train and dev), as
    (texts, total samples), in order."""
    from pg_asr_tpu_torch import train as train_mod

    seen, inner = [], train_mod.batch_to_device

    def record(batch, dev):
        seen.append([list(batch.texts), int(batch.num_samples.sum())])
        return inner(batch, dev)

    train_mod.batch_to_device = record
    try:
        yield seen
    finally:
        train_mod.batch_to_device = inner


def recipe_worker(record_path: str, argv: list[str]) -> int:
    """`python3 chip_smoke.py --recipe-worker OUT ARGV...`: cli.main(ARGV),
    then the batches it trained on into OUT (phase 11's interrupted run)."""
    from pg_asr_tpu_torch import cli

    with recorded_batches() as seen:
        rc = cli.main(argv)
    with open(record_path, "w") as fo:
        json.dump(seen, fo)
    return rc


def phase_recipe(dev, corpus, alphabet, d, bi, train_steps_ms):
    """11. The supervised training recipe (every option of `--mode train`
    on one device) on the full-width BiLSTM-CTC: the CLI run with its
    launches and artifacts, a SIGTERM mid-epoch in a subprocess and the
    resumed run against the uninterrupted one, `--ckpt avg` predict, one
    emit of two micro-batches kernel vs plain path, the options' timings,
    and the convergence recipe of examples/pg_improves_cer.py."""
    import signal

    import numpy as np
    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import load_manifest

    bs = 32
    clips = os.path.join(corpus, "clips")
    steps = -(-len(load_manifest(os.path.join(corpus, "train.tsv"), clips))
              // bs)
    n_dev = -(-len(load_manifest(os.path.join(corpus, "dev.tsv"), clips))
              // bs)
    n_test = len(load_manifest(os.path.join(corpus, "test.tsv"), clips))
    epochs = 3
    inf, res, bwd, per = route_counters()
    out_counts, result = {}, {}

    def argv_for(model):
        return ["--mode", "train", "--corpus_path", corpus, "--model_path",
                model, "--device", str(dev), "--seed", str(SEED), *RECIPE]

    # 1. the recipe through the CLI: per micro-batch 3 residual bilstm_fwd
    # + 3 bilstm_bwd; per dev batch 3 bilstm_fwd for the loss and 3 for the
    # greedy CER (--val_metric cer), on the EMA weights
    model = os.path.join(d, "recipe")
    reset_counts()
    t0 = time.perf_counter()
    with recorded_batches() as full_seen:
        rc, out = run_cli(argv_for(model))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = all_counts()
    want = {**dict.fromkeys(counts, 0), res: per * steps * epochs,
            bwd: per * steps * epochs, inf: 2 * per * n_dev * epochs}
    print(f"[recipe] rc={rc}: {epochs} epochs of {steps} micro-batches of "
          f"{bs} (accumulation 2) + {n_dev} dev batches (loss and CER) in "
          f"{wall:.2f} s; launches { {k: v for k, v in counts.items() if v} }")
    check(rc == 0, "the recipe's train run failed")
    check(counts == want, f"recipe launches {counts}, expected {want}")
    out_counts["recipe_train"] = counts
    tl = np.load(os.path.join(model, "train_loss.npy"))
    vl = np.load(os.path.join(model, "val_losses.npy"))
    check(tl.shape == vl.shape == (epochs,) and np.isfinite(tl).all()
          and np.isfinite(vl).all(), f"losses {tl} {vl}")
    check(out.count("val_cer=") == epochs, "no dev CER per epoch")
    for name in ("model_best.pt", "model_last.pt"):
        state = load_checkpoint(os.path.join(model, name))
        check(set(state.get("ema_params", {})) == set(state["params"]),
              f"{name} holds no ema_params")
    last = load_checkpoint(os.path.join(model, "model_last.pt"))
    check(last["step"] == steps * epochs
          and last["opt_state"]["count"] == steps * epochs // 2,
          f"model_last step {last['step']}, count "
          f"{last['opt_state']['count']}")
    snaps = sorted(n for n in os.listdir(model) if n.startswith("model_epoch"))
    check(snaps == ["model_epoch0002.pt", "model_epoch0003.pt"],
          f"rolling snapshots {snaps}")
    traces = os.listdir(os.path.join(model, "trace"))
    check(traces == ["steps_3-5.pt.trace.json"], f"trace {traces}")
    line = next(x for x in out.splitlines() if x.startswith("[train] loader"))
    check(" 0 by the Python one" in line and "by the native" in line
          and not line.startswith("[train] loader: 0 "),
          f"the native WAV decoder did not run: {line}")
    result["train"] = {"wall_s": wall, "train_losses": tl.tolist(),
                       "val_losses": vl.tolist(), "loader": line}

    # 2. the same command in a subprocess, SIGTERM after its first
    # mid-epoch save (batch 5), then resumed here
    model2 = os.path.join(d, "recipe_sigterm")
    record = os.path.join(d, "recipe_worker.json")
    log = os.path.join(d, "recipe_worker.log")
    t0 = time.perf_counter()
    with open(log, "w") as fo:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--recipe-worker",
             record, *argv_for(model2)], stdout=fo, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            last_path = os.path.join(model2, "model_last.pt")
            while not os.path.exists(last_path) and proc.poll() is None:
                time.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as fo:
        worker_out = fo.read()
    saved = load_checkpoint(os.path.join(model2, "model_last.pt"))
    done = int(saved["batches_done"])
    print(f"[recipe] SIGTERM in a subprocess: rc={rc} after "
          f"{time.perf_counter() - t0:.1f} s, model_last at epoch "
          f"{saved['epoch']} batch {done}")
    check(rc == 0 and f"SIGTERM: saved model_last at epoch 1 batch {done}"
          in worker_out, f"the interrupted run: rc {rc}\n{worker_out[-3000:]}")
    check(saved["epoch"] == 1 and 0 < done < steps,
          f"not a mid-epoch save: epoch {saved['epoch']} batch {done}")
    reset_counts()
    with recorded_batches() as resumed_seen:
        rc, out = run_cli(argv_for(model2))
    counts = all_counts()
    out_counts["recipe_resume"] = counts
    with open(record) as fo:
        worker_seen = json.load(fo)
    last2 = load_checkpoint(os.path.join(model2, "model_last.pt"))
    tl2 = np.load(os.path.join(model2, "train_loss.npy"))
    rel = [abs(a - b) / abs(b) for a, b in zip(tl2[1:], tl[1:])]
    drift = max((last2["params"][k] - last["params"][k]).abs().max().item()
                / last["params"][k].abs().max().item() for k in last["params"])
    print(f"[recipe] resumed at epoch 1 batch {done}: rc={rc}, step "
          f"{last2['step']} (uninterrupted {last['step']}); batch order "
          f"{'the same' if worker_seen + resumed_seen == full_seen else 'DIFFERS'}"
          f"; epoch 2-3 train losses {tl2[1:].tolist()} vs "
          f"{tl[1:].tolist()} (rel {max(rel):.2e}, bound "
          f"{RESUME_LOSS_REL:.0e}); final params max|diff|/max|p| "
          f"{drift:.2e}")
    check(rc == 0 and f"resumed from epoch 1 batch {done}" in out,
          "the resumed run failed")
    check(last2["step"] == last["step"], "the resumed run's step count")
    check(worker_seen + resumed_seen == full_seen,
          "the resumed run's batches are not the uninterrupted run's")
    check(counts[res] == per * (steps * epochs - done),
          f"resumed run launches {counts}")
    check(len(tl2) == epochs and all(r <= RESUME_LOSS_REL for r in rel),
          f"resumed losses {tl2} vs {tl}")
    result["resume"] = {"batches_done": done, "loss_rel": max(rel),
                        "params_drift": drift}

    # 3. predict on the average of the two snapshots' EMA weights
    n_batches = -(-n_test // bs)
    for decoder, want_counts in (
            ("greedy", {inf: per * n_batches}),
            ("beam", {inf: per * -(-n_test // BEAM_B), "ctc_beam": 1})):
        reset_counts()
        rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                           "--model_path", model, "--device", str(dev),
                           "--ckpt", "avg", "--decoder", decoder])
        counts = all_counts()
        with open(os.path.join(model, "predicted.txt")) as fo:
            rows = fo.read().splitlines()
        cer = float(out.split("CER: ")[1].split()[0]) if "CER: " in out \
            else math.nan
        check(rc == 0 and "averaged 2 epoch snapshots" in out
              and len(rows) == n_test and math.isfinite(cer),
              f"--ckpt avg --decoder {decoder}: rc {rc}, CER {cer}")
        check(counts == {**dict.fromkeys(counts, 0), **want_counts},
              f"--ckpt avg {decoder} launches {counts}")
        out_counts[f"recipe_predict_avg_{decoder}"] = counts
        result[f"predict_avg_{decoder}_cer"] = cer

    result["compare"] = recipe_step_vs_plain(dev, alphabet, model, corpus)
    result["timing"] = recipe_timing(dev, alphabet, model, corpus, bi,
                                     train_steps_ms)
    result["convergence"] = recipe_convergence(dev, d)
    return {"launches": out_counts, **result}


def recipe_step_vs_plain(dev, alphabet, model, corpus):
    """One emit (2 micro-batches of 32) with every augmentation, from the
    recipe's model_last (its params, AdamW state and EMA), dropout 0, the
    same draws (a CUDA generator of one seed each): kernel vs plain path,
    phase 5's bounds on the losses and on the change of every parameter and
    of the EMA (plus 4 float32 ulps of the value the change is added to)."""
    import dataclasses

    import torch

    from pg_asr_tpu_torch.checkpoint import load_checkpoint
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.models import cast_params
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (AdamW, _copy, _ema_update,
                                        batch_to_device, loss_and_grads)

    _, cfg = load_model(model, alphabet, device=dev)
    # the full rate (no warmup): the change then stands well above the
    # float32 rounding of the values it is added to
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.0),
                      train=dataclasses.replace(cfg.train, warmup_steps=0))
    state = load_checkpoint(os.path.join(model, "model_last.pt"))
    it = BatchIterator(load_manifest(os.path.join(corpus, "train.tsv"),
                                     os.path.join(corpus, "clips")),
                       alphabet, 32, shuffle=False)
    batches = []
    for batch in it:
        batches.append(batch_to_device(batch, dev))
        if len(batches) == 2:
            break
    start = cast_params(state["params"], torch.float32, dev)
    start_ema = cast_params(state["ema_params"], torch.float32, dev)
    got = {}
    for use_kernel in (True, False):
        # copies: the optimizer and the EMA update in place
        params, ema = _copy(start), _copy(start_ema)
        opt = AdamW(cfg, params)
        opt.load_state_dict(state["opt_state"], dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        losses = []
        for arrays in batches:
            loss, grads = loss_and_grads(params, arrays, cfg, gen,
                                         use_kernel=use_kernel)
            opt.update(params, grads)
            _ema_update(ema, params, cfg.train.ema_decay)
            losses.append(loss.item())
        got[use_kernel] = losses, params, ema
    (lk, pk, ek), (lp, pp, ep) = got[True], got[False]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    eps = torch.finfo(torch.float32).eps
    worst, raw = {}, {}
    for name, k_, p_, s_ in (("params", pk, pp, start),
                             ("ema", ek, ep, start_ema)):
        for k in p_:
            change = max((p_[k] - s_[k]).abs().max().item(), 1e-30)
            diff = (k_[k] - p_[k]).abs().max().item()
            excess = diff - 4 * eps * p_[k].abs().max().item()
            worst[f"{name}:{k}"] = max(excess, 0.0) / change
            raw[f"{name}:{k}"] = diff / change
    key, key_raw = max(worst, key=worst.get), max(raw, key=raw.get)
    print(f"[recipe] one emit of 2 micro-batches of 32 (augmented, EMA, "
          f"full rate), kernel vs plain path: losses {lk} vs {lp} (rel "
          f"{loss_rel:.2e}, bound {TRAIN_LOSS_REL:.0e}); worst change error "
          f"beyond 4 ulps {worst[key]:.2e} of the change ({key}; bound "
          f"{TRAIN_GRAD_REL:.0e}), max|diff|/change {raw[key_raw]:.2e} "
          f"({key_raw})")
    check(all(math.isfinite(x) for x in lk) and loss_rel <= TRAIN_LOSS_REL,
          f"recipe losses disagree: {lk} vs {lp}")
    check(all(v <= TRAIN_GRAD_REL for v in worst.values()),
          f"recipe params / EMA disagree: {key} {worst[key]}")
    return {"loss_rel": loss_rel, "change_rel_worst": worst[key],
            "diff_over_change_max": raw[key_raw]}


def recipe_timing(dev, alphabet, model, corpus, bi, train_steps_ms):
    """The recipe's options at B=64 x 5 s: wave_augment and spec_augment
    (float32 whatever the model's type), the EMA update and the train
    micro-step with every option, float32 and bfloat16, beside phase 5's
    plain step; the loader's host ms per batch."""
    import numpy as np
    import torch

    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.ops.augment import spec_augment, wave_augment
    from pg_asr_tpu_torch.ops.features import extract_features
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (AdamW, _copy, _ema_update,
                                        make_train_step)
    from pg_asr_tpu_torch.utils.profiling import memory_stats

    arrays64 = flagship_batch(dev, vocab=alphabet.size)
    _, cfg = load_model(model, alphabet, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    feats, mask, _ = extract_features(arrays64[0], arrays64[1], cfg.features)
    out = {"wave_augment_ms": device_ms(lambda: wave_augment(
               arrays64[0], arrays64[1], gen, cfg.augment), 20),
           "spec_augment_ms": device_ms(lambda: spec_augment(
               feats, mask, gen, cfg.augment), 20)}
    for dtype in ("float32", "bfloat16"):
        params, c = load_model(model, alphabet, device=dev, dtype=dtype)
        ema = _copy(params)
        out[f"ema_ms_{dtype}"] = time_ms(
            lambda: _ema_update(ema, params, c.train.ema_decay), 10)
        opt = AdamW(c, params)
        step = make_train_step(c, opt)

        def micro_step():
            step(params, gen, *arrays64)
            _ema_update(ema, params, c.train.ema_decay)

        torch.cuda.reset_peak_memory_stats()
        out[f"step_ms_{dtype}"] = time_ms(micro_step, 6)  # 3 emits
        peak = memory_stats()[str(dev)]["peak_bytes_in_use"] / 2 ** 30
        out[f"step_peak_gib_{dtype}"] = peak
        print(f"[recipe] B={B} x 5 s, {dtype}: micro-step with every "
              f"augmentation, accumulation 2 and EMA "
              f"{out[f'step_ms_{dtype}']:.2f} ms (phase 5's plain step "
              f"{train_steps_ms[dtype]:.2f} ms), peak {peak:.2f} GiB "
              f"allocated; EMA update {out[f'ema_ms_{dtype}']:.3f} ms")
    print(f"[recipe] B={B} x 5 s: wave_augment (speed, noise, gain) "
          f"{out['wave_augment_ms']:.3f} ms, spec_augment (2 + 2 masks) "
          f"{out['spec_augment_ms']:.3f} ms (device time)")

    utts = load_manifest(os.path.join(corpus, "train.tsv"),
                         os.path.join(corpus, "clips"))
    loader = {}
    for name, kw in (("python_0", dict(decoder="python")),
                     ("native_0", dict(decoder="native")),
                     ("native_2", dict(decoder="native", num_workers=2)),
                     ("native_2_cache", dict(decoder="native", num_workers=2,
                                             cache_mb=4096))):
        it = BatchIterator(utts, alphabet, 32, seed=SEED, **kw)
        n = sum(1 for _ in it)  # lengths known (and the cache filled)
        t0 = time.perf_counter()
        check(sum(1 for _ in it) == n, "loader epoch length")
        loader[name] = (time.perf_counter() - t0) * 1e3 / n
    print(f"[recipe] loader host ms per batch of 32 (1-5 s, second epoch): "
          + ", ".join(f"{k} {v:.2f}" for k, v in loader.items()))
    out["loader_ms_per_batch"] = loader
    return out


def recipe_convergence(dev, d):
    """examples/pg_improves_cer.py's recipe on the port's phonetic corpus
    (96 utterances, seed 0): logmel 40, projection 128, 2 x BiLSTM 64,
    dropout 0.1, 16 epochs of batch 8, lr 3e-3, warmup 50, then 120
    REINFORCE steps; the test CER after each. The JAX package's run of the
    same recipe from the same initial weights: tests/test_torch_convergence.py
    run as a script, on a CPU."""
    from pg_asr_tpu_torch.config import (Config, FeatureConfig, ModelConfig,
                                         TrainConfig)
    from pg_asr_tpu_torch.data import make_phonetic_corpus
    from pg_asr_tpu_torch.predict import predict
    from pg_asr_tpu_torch.rl.reinforce import finetune_pg
    from pg_asr_tpu_torch.train import train

    corpus, _ = make_phonetic_corpus(os.path.join(d, "phonetic"), n_utts=96,
                                     seed=0)
    model = os.path.join(d, "phonetic_model")
    cfg = Config(
        features=FeatureConfig(kind="logmel", n_mels=40, n_fft=256,
                               win_length=256, hop_length=128),
        model=ModelConfig(family="ctc", vocab_size=8, input_dim=40,
                          input_proj_dim=128, hidden_size=64, num_layers=2,
                          dropout=0.1),
        train=TrainConfig(num_epochs=16, batch_size=8, learning_rate=3e-3,
                          warmup_steps=50, log_every=10000, prefetch_depth=0))
    args = (os.path.join(corpus, "test.tsv"), os.path.join(corpus, "clips"),
            os.path.join(corpus, "alphabet.txt"), model)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = train(corpus, model, config=cfg, device=str(dev))
        t_train = time.perf_counter() - t0
        before = predict(*args, batch_size=8, device=str(dev))
        t0 = time.perf_counter()
        finetune_pg(corpus, model, num_steps=120, batch_size=8, config=cfg,
                    device=str(dev))
        t_pg = time.perf_counter() - t0
        after = predict(*args, batch_size=8, which_ckpt="last",
                        device=str(dev))
    res = {"cer_train": before["cer"], "wer_train": before["wer"],
           "cer_pg": after["cer"], "wer_pg": after["wer"],
           "train_losses": out["train_losses"],
           "val_losses": out["val_losses"], "train_s": t_train, "pg_s": t_pg}
    print(f"[recipe] convergence (phonetic corpus, 96 utterances): test CER "
          f"{before['cer']:.4f} after 16 epochs ({t_train:.1f} s), "
          f"{after['cer']:.4f} after 120 REINFORCE steps ({t_pg:.1f} s); "
          f"train losses {[round(x, 4) for x in out['train_losses']]}")
    check(all(math.isfinite(res[k]) for k in ("cer_train", "cer_pg")),
          f"convergence CER {res}")
    return res


def attention_group(name: str) -> str:
    """The kernel group of a device_breakdown: flash_attn (the forward in
    either form), flash_bwd (dkv and dq), joint (joint_fwd, joint_bwd and
    its reduction passes), GEMMs, convolutions (the STFT and the depthwise
    conv), LayerNorm, and the rest (elementwise, softmax, copies, the CTC
    and lattice losses, the optimizer)."""
    # a convolution first: cuDNN names some of its kernels "...gemm"
    return ("flash_bwd" if "flash_attn_bwd" in name else
            "flash_attn" if "flash_attn" in name else
            "joint" if "joint_" in name else
            "conv" if "conv" in name else
            "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma"))
            else "layer_norm" if "layer_norm" in name else "other")


ATTENTION_GROUPS = ("flash_attn", "flash_bwd", "joint", "gemm", "conv",
                    "layer_norm", "other")


def pg_group(name: str) -> str:
    """The kernel group of a PG step: the LSTM kernels (bilstm_fwd's walk,
    bilstm_bwd's three launches), ctc_beam, the CTC loss (F.ctc_loss's
    kernels), GEMMs, and the rest (the edit-distance DP, sampling, the
    entropy, elementwise passes, the optimizer)."""
    return ("lstm" if "lstm" in name else
            "ctc_beam" if "ctc_beam" in name else
            "ctc_loss" if "ctc_loss" in name else
            "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma"))
            else "other")


PG_GROUPS = ("lstm", "ctc_beam", "ctc_loss", "gemm", "other")


def device_breakdown(fn, reps: int = 3, groups=ATTENTION_GROUPS,
                     classify=attention_group) -> dict:
    """Kernel time per call of fn on the card, by group (`classify` maps a
    kernel's name to one of `groups`), from a torch.profiler trace of `reps`
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        out[classify(e.key.lower())] += e.self_device_time_total / 1e3 / reps
    check(sum(out.values()) > 0, "the profiler saw no kernel time")
    return out


def device_ops(fn) -> int:
    """Device operations (kernel launches and copies) of one call of fn,
    counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA)


def host_ms(fn, reps: int) -> float:
    """Host-clock ms per call of fn, synchronised at the end (for work
    whose time is its launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernels_line(cases, lib, predict_launches, train_counts, attention,
                 attention_train, tr, bi):
    def head(rows):
        return next(c for c in rows if c["dtype"] == "float32"
                    and not c["reverse"])

    f, r, b = head(cases["fwd"]), head(cases["res"]), head(cases["bwd"])
    beam = cases["beam"][0]  # M=6, the default prune
    flash = next(c for c in cases["flash"] if c["dtype"] == "float32")
    fb = next(c for c in cases["flash_bwd"] if c["dtype"] == "float32")
    src = "pg_asr_tpu_torch/csrc/"
    lib_fa = "jax/experimental/pallas/ops/tpu/flash_attention.py"

    def train_launches(name):
        return {f"{fam}_{path}": n[name] for fam, r in attention_train.items()
                for path, n in r["launches"].items()}

    conformer_epoch = attention_train["conformer"]["launches"]["epoch1"]
    jf = next(c for c in cases["joint"] if c["dtype"] == "float32")
    # the BiLSTM-CTC's model paths (predict, train), counts set to 0 before
    # each; where the encoder's route fuses the directions, the
    # single-direction kernels run on bilstm_layer(fuse_directions=False),
    # the JAX package's default of that entry point (phase 3f)
    route = {"predict": predict_launches[0],
             "train": {k: train_counts[k] for k in predict_launches[0]}}

    def launches(name, layer):
        by_path = {path: n[name] for path, n in route.items()}
        own = bi["layer_launches"][layer][name]
        return {"launches": sum(by_path.values()) or own,
                "launches_by_path": {**by_path, (
                    "bilstm_layer(fuse_directions=False)"): own}}

    return [{
        "name": "lstm_fwd", "route": "cuda", "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        **launches("lstm_fwd", "unfused_no_grad"),
        "max_abs_err": max(c["max_abs_err"] for c in cases["fwd"]
                           if c["dtype"] == "float32"),
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": lib["fwd_ms"],
        "cases": cases["fwd"], "shapes": cases["shapes"]["lstm"],
    }, {
        "name": "lstm_fwd_residual", "route": "cuda",
        "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        **launches("lstm_fwd_residual", "unfused_autograd"),
        "max_abs_err": max(max(v[0] for v in c["errors"].values())
                           for c in cases["res"] if c["dtype"] == "float32"),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": lib["train_fwd_ms"],
        "cases": cases["res"],
    }, {
        "name": "lstm_bwd", "route": "cuda", "source": src + "lstm_bwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:122",
        **launches("lstm_bwd", "unfused_autograd"),
        "max_abs_err": max(c["dxp_max_abs_err"] for c in cases["bwd"]
                           if c["dtype"] == "float32"),
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": lib["bwd_ms"],
        "cases": cases["bwd"],
    }, *bilstm_rows(bi, src, route), {
        "name": "ctc_beam", "route": "cuda", "source": src + "ctc_beam.cu",
        "replaces": "pg_asr_tpu/decoding/pallas_beam.py:67",
        "launches": predict_launches[1],
        "launches_by_path": {"predict": predict_launches[1],
                             "train_then_predict": train_counts["ctc_beam"]},
        "max_abs_err": max(c["nll_max_abs_err"] for c in cases["beam"]),
        "ms": beam["ms"], "plain_ms": beam["plain_ms"],
        "bound_ms": beam["bound_ms"], "bound_by": beam["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a CTC prefix beam "
                        "search",
        "cases": cases["beam"], "shapes": cases["shapes"]["beam"],
    }, {
        "name": "flash_attn", "route": "cuda", "source": src + "flash_attn.cu",
        "replaces": "pg_asr_tpu/ops/flash_attn.py:62",
        "launches": attention["conformer"]["launches"]["greedy"],
        "launches_by_path": {
            **{f"{fam}_{path}": n for fam, r in attention.items()
               for path, n in r["launches"].items()},
            **train_launches("flash_attn")},
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_note": "F.scaled_dot_product_attention with the boolean "
                        "segment-equality mask",
        "cases": cases["flash"], "models": attention,
        "shapes": cases["shapes"]["flash"],
    }, {
        "name": "flash_attn_residual", "route": "cuda",
        "source": src + "flash_attn.cu",
        "replaces": "pg_asr_tpu/ops/flash_attn.py:62 (" + lib_fa
                    + " _flash_attention_fwd, save_residuals)",
        "launches": conformer_epoch["flash_attn_residual"],
        "launches_by_path": train_launches("flash_attn_residual"),
        "max_abs_err": max(c["m_max_abs_err"] for c in cases["flash"]
                           if c["dtype"] == "float32"),
        "ms": flash["res_ms"], "plain_ms": flash["res_plain_ms"],
        "bound_ms": flash["res_bound_ms"], "bound_by": flash["res_bound_by"],
        "library_ms": flash["sdpa_train_fwd_ms"],
        "library_note": "F.scaled_dot_product_attention forward on inputs "
                        "that require grad",
    }, {
        "name": "flash_attn_bwd_dkv", "route": "cuda",
        "source": src + "flash_attn_bwd.cu",
        "replaces": lib_fa + ":941 (_flash_attention_bwd_dkv, pallas_call "
                    ":1121, kernel :796)",
        "launches": conformer_epoch["flash_attn_bwd_dkv"],
        "launches_by_path": train_launches("flash_attn_bwd_dkv"),
        "max_abs_err": max(c["errors_rel_to_max"][n][0]
                           for c in cases["flash_bwd"] for n in ("dk", "dv")
                           if c["dtype"] == "float32"),
        "max_abs_err_note": "relative to max|grad|",
        "ms": fb["dkv_ms"], "plain_ms": fb["plain_bwd_ms"],
        "bound_ms": fb["dkv_bound_ms"], "bound_by": fb["dkv_bound_by"],
        "library_ms": fb["sdpa_bwd_ms"],
        "library_note": "the backward of F.scaled_dot_product_attention "
                        "(dq, dk and dv together); plain_ms is "
                        "mhsa_bwd_plain, all three",
        "cases": cases["flash_bwd"], "models": attention_train,
    }, {
        "name": "flash_attn_bwd_dq", "route": "cuda",
        "source": src + "flash_attn_bwd.cu",
        "replaces": lib_fa + ":1287 (_flash_attention_bwd_dq, pallas_call "
                    ":1456, kernel :1146)",
        "launches": conformer_epoch["flash_attn_bwd_dq"],
        "launches_by_path": train_launches("flash_attn_bwd_dq"),
        "max_abs_err": max(c["errors_rel_to_max"]["dq"][0]
                           for c in cases["flash_bwd"]
                           if c["dtype"] == "float32"),
        "max_abs_err_note": "relative to max|grad|",
        "ms": fb["dq_ms"], "plain_ms": fb["plain_bwd_ms"],
        "bound_ms": fb["dq_bound_ms"], "bound_by": fb["dq_bound_by"],
        "library_ms": fb["sdpa_bwd_ms"],
        "library_note": "the backward of F.scaled_dot_product_attention "
                        "(dq, dk and dv together); plain_ms is "
                        "mhsa_bwd_plain, all three",
    }, {
        "name": "joint_fwd", "route": "cuda", "source": src + "joint_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_joint.py:69",
        "launches": tr["launches"]["train_fused"]["joint_fwd"],
        "launches_by_path": {path: n["joint_fwd"] for path, n in
                             tr["launches"].items()},
        "max_abs_err": max(v[0] for c in cases["joint"]
                           for v in c["lp_errors"].values()),
        "ms": jf["fwd_ms"], "plain_ms": jf["fwd_plain_ms"],
        "bound_ms": jf["fwd_bound_ms"], "bound_by": jf["fwd_bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused joint; "
                        "unfused_ms is the port's unfused composition (the "
                        "4-D tanh, the head, joint_log_probs)",
        "unfused_ms": jf["unfused_fwd_ms"], "cases": cases["joint"],
        "models": {"transducer": tr}, "shapes": cases["shapes"]["joint"],
    }, {
        "name": "joint_bwd", "route": "cuda", "source": src + "joint_bwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_joint.py:92",
        "launches": tr["launches"]["train_fused"]["joint_bwd"],
        "launches_by_path": {path: n["joint_bwd"] for path, n in
                             tr["launches"].items()},
        "max_abs_err": max(c["grad_errors_rel_to_max"][n][0]
                           for c in cases["joint"] for n in
                           ("de", "dg", "dW", "db")
                           if c["dtype"] == "float32"),
        "max_abs_err_note": "relative to max|grad|, float32",
        "ms": jf["bwd_ms"], "plain_ms": jf["bwd_plain_ms"],
        "bound_ms": jf["bwd_bound_ms"], "bound_by": jf["bwd_bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused joint's "
                        "gradient; unfused_fwd_bwd_ms is the unfused "
                        "composition forward + backward, fused_fwd_bwd_ms "
                        "joint_fwd + joint_bwd",
        "unfused_fwd_bwd_ms": jf["unfused_fwd_bwd_ms"],
        "fused_fwd_bwd_ms": jf["fused_fwd_bwd_ms"],
    }]


def bilstm_rows(bi, src, route_counts):
    """The kernels line's rows 3 (both forms) and 4, float32 times:
    launches from the model paths the encoder's route takes through them
    (route_counts: {path: {counter: launches}}, counts set to 0 before each
    path), beside the fused layer's own runs in phase 3f."""
    c = next(c for c in bi["cases"] if c["dtype"] == "float32")
    note = ("cuDNN nn.LSTM(512, 256, bidirectional=True), which also does "
            "the input projection, timed in turns with the kernel")
    rows = []
    for name, key, layer in (
            ("bilstm_fwd", "fwd", bi["layer_launches"]["no_grad"]),
            ("bilstm_fwd_residual", "res", bi["layer_launches"]["autograd"]),
            ("bilstm_bwd", "bwd", bi["layer_launches"]["autograd"])):
        errs = c["bwd_errors" if key == "bwd" else "fwd_errors"]
        two = {"fwd": "two_lstm_fwd_ms", "res": "two_lstm_fwd_residual_ms",
               "bwd": "two_lstm_bwd_ms"}[key]
        by_path = {path: n.get(name, 0) for path, n in route_counts.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": src + ("lstm_bwd.cu" if key == "bwd"
                             else "lstm_fwd.cu"),
            "replaces": "pg_asr_tpu/ops/pallas_lstm.py:"
                        + ("357" if key == "bwd" else "318"),
            "launches": sum(by_path.values()) or layer[name],
            "launches_by_path": {**by_path,
                                 "bilstm_layer(fuse_directions=True)":
                                     layer[name]},
            "max_abs_err": max(v[0] for k, v in errs.items()
                               if k.startswith(("y", "h", "c", "dxp"))),
            "ms": c[f"{key}_ms"], "plain_ms": c[f"{key}_plain_ms"],
            "bound_ms": c[f"{key}_bound_ms"],
            "bound_by": c[f"{key}_bound_by"],
            "library_ms": c[f"{key}_cudnn_ms"],
            "library_note": note, two: c[two],
            "cases": bi["cases"] if key == "fwd" else None,
        })
    return rows


def main() -> int:
    if sys.argv[1:2] == ["--recipe-worker"]:
        return recipe_worker(sys.argv[2], sys.argv[3:])
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    cases = phase_kernels(dev)
    cases["beam"] = phase_beam(dev)
    cases["flash"] = phase_flash(dev)
    cases["flash_bwd"] = phase_flash_bwd(dev)
    cases["joint"] = phase_joint(dev)
    cases["shapes"] = phase_shapes(dev)
    bi = phase_bilstm(dev)
    lib = phase_library(dev)
    with tempfile.TemporaryDirectory() as d:
        corpus, alphabet = make_corpus(d)
        predict_launches = phase_predict(dev, corpus, alphabet, d, bi)
        train_counts, train_steps_ms = phase_train(dev, corpus, alphabet,
                                                   d, bi)
        attention = {family: phase_attention(dev, corpus, alphabet, d, family,
                                             cases["flash"])
                     for family in ("conformer", "transformer")}
        attention_train = {family: phase_attention_train(dev, corpus,
                                                         alphabet, d, family)
                           for family in ("conformer", "transformer")}
        tr = phase_transducer_train(dev, corpus, alphabet, d, cases["joint"])
        tr["predict"] = phase_transducer_predict(
            dev, corpus, alphabet, os.path.join(d, "transducer_fused"))
        pg = phase_pg(dev, corpus, alphabet, d, bi, cases["beam"],
                      train_steps_ms)
        recipe = phase_recipe(dev, corpus, alphabet, d, bi, train_steps_ms)

    import torch

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "pg_asr_tpu"))
    check(not bad, f"the port imported {bad}")
    print(json.dumps({"finetune_pg": pg}))
    print(json.dumps({"recipe": recipe}))
    print(f"[smoke] total wall time {time.perf_counter() - t_start:.1f} s")
    rows = kernels_line(cases, lib, predict_launches, train_counts, attention,
                        attention_train, tr, bi)
    for row in rows:  # the policy-gradient and recipe paths (phases 10, 11)
        row["launches_by_path"].update(
            {path: n[row["name"]] for path, n in
             {**pg["launches"], **recipe["launches"]}.items()})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
