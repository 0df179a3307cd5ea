#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg_asr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back to
the CPU or to a kernel's plain version):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the hand-written kernels from pg_asr_tpu_torch/csrc
     (one nvcc per source, started together).
  3. kernels: each kernel vs its plain PyTorch version on the card at
     B=64, T=401, H=256 (5 s of audio, the default hidden size), float32
     and bfloat16, forward and reverse: lstm_fwd in its inference and
     residual forms, lstm_bwd with a random output gradient. Max and mean
     abs errors against stated bounds, CUDA-event times (kernel and plain
     in turns), the time of cuDNN's nn.LSTM at the same shape as a
     yardstick, and the least time the card could take (bound).
  3b. beam kernel: ctc_beam vs the plain hash scan on the card at the
     beam's default batch and width (B=128, T=401, A=28, K=16) on sharp
     posteriors from a seed with ragged frame lengths, for the default
     prune (M=6 symbols per frame) and the exact search (M=18): labels,
     lens, parents and syms identical, nll within a stated bound; the
     n-best mode likewise; CUDA-event times in turns and the bound.
  3c. flash-attention kernel: flash_attn vs its plain version
     (ops/flash_attn.mhsa_plain) on the card at the conformer's attention
     shape at B=64 x 5 s (H=4, T'=201, dh=64), q, k, v read in place from
     a fused (B, T', 3, H, dh) projection, float32 and bfloat16, ragged
     lengths: max abs errors against stated bounds, CUDA-event times in
     turns, the bound over the pairs the segment mask leaves, and the time
     of F.scaled_dot_product_attention with the same boolean mask.
  3d. flash-attention backward: at phase 3c's shape and inputs, float32
     and bfloat16, the residual form (flash_attn with l and m) against
     mhsa_plain(residuals=True), and flash_attn_bwd_dkv and
     flash_attn_bwd_dq against mhsa_bwd_plain on the same l, m and a
     random output gradient: max and mean abs errors relative to max|grad|
     against stated bounds (in bf16 a control without the rounding of p
     and ds must exceed the mean bound), CUDA-event times in turns, each
     kernel's bound, and the backward of F.scaled_dot_product_attention
     (its autograd.grad minus its forward) as the yardstick.
  3e. fused RNN-T joint: joint_fwd and joint_bwd vs their plain versions
     (ops/joint.fused_joint_plain, fused_joint_bwd_plain) at the
     transducer's train shape at B=64 x 5 s (T'=201, U+1=61, J=256, A=28),
     float32 and bfloat16 inputs, ragged frame and label lengths, random
     cotangents on the cells the loss reads: errors against stated bounds
     (the tables absolute, the gradients relative to max|grad|), the
     backward run twice with equal bits, CUDA-event times in turns, each
     kernel's bound, and the port's unfused composition (forward, forward
     + backward) as the yardstick.
  3f. fused-direction BiLSTM: bilstm_fwd (inference and residual forms)
     and bilstm_bwd vs their plain versions on the card at phase 3's shape
     (B=64, T=401, H=256 per direction), float32 and bfloat16, ragged
     lengths, against the phase 3 bounds; each against two single-direction
     launches (equal bits), the backward run twice (equal bits);
     CUDA-event times in turns against the plain versions, against 2 x
     lstm_fwd / lstm_bwd on one stream and against cuDNN's bidirectional
     nn.LSTM; the bound. Then bilstm_layer(fuse_directions=True) at the
     flagship's first layer (input 512) under autograd (one residual
     bilstm_fwd and one bilstm_bwd launch, no single-direction launch) and
     without (one bilstm_fwd), its output and gradients against
     fuse_directions=False.
  4. predict slice: batch transcription through the port's CLI
     (`--mode predict --device cuda`, default batch 32) of 96 synthetic
     utterances of 1-5 s with the full-width default BiLSTM-CTC (random
     weights from a seed); checks predicted.txt, CER/WER, that every LSTM
     direction of every batch went through lstm_fwd, and one batch's
     log-probs against the plain recurrence; times the forward at
     B=64 x 5 s. Then `--decoder beam` (default batch 128, K=16, prune 6:
     one batch): the same checks, one ctc_beam launch per batch, and the
     kernel against the plain scan on that batch's log-probs.
  5. train slice: `--mode train --device cuda` through the CLI, one epoch
     of the synthetic train split (576 utterances, 18 steps at the default
     batch 32) with validation on dev; checks the launch counts of the
     residual forward and the backward (6 per step) and of the inference
     forward (6 per dev batch), the artifacts and finite losses, a resumed
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
 10. prints its total wall time, a JSON line of kernel results, then as
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


def in_turns(plain, kernel, plain_reps: int, kernel_reps: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1 = time_ms(plain, plain_reps), time_ms(kernel, kernel_reps)
    k2, p2 = time_ms(kernel, kernel_reps), time_ms(plain, plain_reps)
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

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {os.path.relpath(path)} in "
          f"{time.perf_counter() - t0:.1f} s")


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
            ref_out, ref_h, ref_c = lstm_scan_plain(xp, U, mask, reverse,
                                                    residuals=True)
            torch.cuda.synchronize()
            err, mean_err = _errs(got, ref_out)
            check(got.dtype == dtype and got.shape == (B, T, H),
                  "kernel output dtype/shape")
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


def phase_library(dev, bidirectional: bool = False):
    """cuDNN nn.LSTM at the kernels' shape, float32, full-length batch: one
    direction (yardstick of lstm_fwd / lstm_bwd) or both (of bilstm_fwd /
    bilstm_bwd): the one PyTorch call that computes the same recurrence (it
    also does the x@W input projection, from a 512-wide input, which the
    kernels receive precomputed). A yardstick only; the port never calls
    it."""
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

    lib = {"fwd_ms": time_ms(infer, 20), "train_fwd_ms": time_ms(train_fwd, 20),
           "bwd_ms": time_ms(backward, 20)}
    print(f"[library] cuDNN nn.LSTM(512, {H}{', bidirectional=True' * bidirectional}) "
          f"B={B} T={T} float32, {('one direction', 'both directions')[n_dir - 1]}: "
          f"forward {lib['fwd_ms']:.3f} ms (no grad), "
          f"{lib['train_fwd_ms']:.3f} ms (training), backward "
          f"{lib['bwd_ms']:.3f} ms")
    return lib


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


def phase_bilstm(dev):
    """3f: bilstm_fwd (both forms) and bilstm_bwd vs their plain versions
    and vs two single-direction launches, timed in turns against both;
    cuDNN's bidirectional nn.LSTM as the yardstick; then
    bilstm_layer(fuse_directions=True) at the flagship's first layer,
    under autograd and without, against fuse_directions=False."""
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm as cl
    from pg_asr_tpu_torch.ops.lstm import (bilstm_layer,
                                           bilstm_scan_bwd_plain,
                                           bilstm_scan_plain)

    mask, *inputs32, valid = bi_inputs(dev)
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
        single = (torch.cat([sf[0], sb[0]], -1), sf[1], sf[2], sb[1], sb[2])
        check(all(torch.equal(a, b) for a, b in zip(res, single)),
              f"bilstm_fwd {name}: not bit-equal to two lstm_fwd launches")
        k_ms, p_ms = in_turns(lambda: bilstm_scan_plain(*args),
                              lambda: cl.bilstm_scan_cuda(*args), 2, 20)
        two_ms = time_ms(lambda: (cl.lstm_scan_cuda(xpf, Uf, mask, False),
                                  cl.lstm_scan_cuda(xpb, Ub, mask, True)), 20)
        kr_ms, pr_ms = in_turns(
            lambda: bilstm_scan_plain(*args, residuals=True),
            lambda: cl.bilstm_scan_residual_cuda(*args), 2, 20)
        two_r_ms = time_ms(
            lambda: (cl.lstm_scan_residual_cuda(xpf, Uf, mask, False),
                     cl.lstm_scan_residual_cuda(xpb, Ub, mask, True)), 20)
        b_ms, b_by = bound_ms(f_fwd, io_fwd, name)
        br_ms, br_by = bound_ms(f_fwd, io_res, name)
        case.update(fwd_errors=errs, fwd_ms=k_ms, fwd_plain_ms=p_ms,
                    two_lstm_fwd_ms=two_ms, fwd_bound_ms=b_ms,
                    fwd_bound_by=b_by, res_ms=kr_ms, res_plain_ms=pr_ms,
                    two_lstm_fwd_residual_ms=two_r_ms, res_bound_ms=br_ms,
                    res_bound_by=br_by)
        print(f"[kernel] bilstm_fwd {tag}: " + ", ".join(
            f"{k} max {v[0]:.3e} mean {v[1]:.3e}" for k, v in errs.items())
            + f" (bounds {BOUNDS[name]}, c {CPREV_BOUNDS[name]}); equal bits "
            f"to 2 x lstm_fwd; inference form {k_ms:.3f} ms (plain "
            f"{p_ms:.3f}, 2 x lstm_fwd {two_ms:.3f}, bound {b_ms:.3f} "
            f"{b_by}); residual form {kr_ms:.3f} ms (plain {pr_ms:.3f}, 2 x "
            f"lstm_fwd residual {two_r_ms:.3f}, bound {br_ms:.3f} {br_by})")

        # --- backward, on the plain forward's residuals
        bwd = cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        again = cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy)
        r_bwd = bilstm_scan_bwd_plain(*args, *ref[1:], gy)
        s_f = cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2],
                                    gy[..., :H].contiguous(), False)
        s_b = cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4],
                                    gy[..., H:].contiguous(), True)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(bwd, again)),
              f"bilstm_bwd {name}: two runs differ")
        check(all(torch.equal(a, b) for a, b in
                  zip(bwd, (s_f[0], s_b[0], s_f[1], s_b[1]))),
              f"bilstm_bwd {name}: not bit-equal to two lstm_bwd launches")
        bb = BWD_BOUNDS[name]
        berrs = {}
        for k, g_, r_ in zip(("dxpf", "dxpb", "dUf", "dUb"), bwd, r_bwd):
            mx, mean = _errs(g_, r_)
            ref_max = r_.float().abs().max().item()
            if k.startswith("dxp"):
                lim = bb.get("dxp_max", bb.get("dxp_rel", 0) * ref_max)
                ok = mx <= lim and mean <= bb["dxp_mean"]
            else:
                lim = bb["du_rel"] * ref_max
                ok = mx <= lim
            berrs[k] = (mx, mean, lim)
            check(ok, f"bilstm_bwd {name}: {k} max {mx} mean {mean} out of "
                      f"bounds ({lim}, {bb})")
        kb_ms, pb_ms = in_turns(
            lambda: bilstm_scan_bwd_plain(*args, *ref[1:], gy),
            lambda: cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy), 1, 10)
        gyf, gyb = gy[..., :H].contiguous(), gy[..., H:].contiguous()
        two_b_ms = time_ms(
            lambda: (cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1], ref[2], gyf,
                                           False),
                     cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3], ref[4], gyb,
                                           True)), 10)
        bb_ms, bb_by = bound_ms(f_bwd, io_bwd, name)
        case.update(bwd_errors=berrs, bwd_ms=kb_ms, bwd_plain_ms=pb_ms,
                    two_lstm_bwd_ms=two_b_ms, bwd_bound_ms=bb_ms,
                    bwd_bound_by=bb_by)
        print(f"[kernel] bilstm_bwd {tag}: " + ", ".join(
            f"{k} max {v[0]:.3e} (bound {v[2]:.3e}) mean {v[1]:.3e}"
            for k, v in berrs.items()) + f"; equal bits run to run and to 2 "
            f"x lstm_bwd; kernel {kb_ms:.3f} ms (plain {pb_ms:.3f}, 2 x "
            f"lstm_bwd {two_b_ms:.3f}, bound {bb_ms:.3f} {bb_by})")
        cases.append(case)

    lib = phase_library(dev, bidirectional=True)

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
        y_inf = bilstm_layer(p, x0, mask, fuse_directions=True)
    torch.cuda.synchronize()
    launches["no_grad"] = lstm_counts()
    zero = dict.fromkeys(lstm_counts(), 0)
    check(launches[True] == {**zero, "bilstm_fwd_residual": 1,
                             "bilstm_bwd": 1},
          f"fused layer under autograd launched {launches[True]}")
    check(launches["no_grad"] == {**zero, "bilstm_fwd": 1},
          f"fused layer without grad launched {launches['no_grad']}")
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(grads[True], grads[False])]
    equal = all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    inf_equal = torch.equal(y_inf, grads[True][0])
    print(f"[kernel] bilstm_layer(fuse_directions=True) B={B} T={T} I={I} "
          f"H={H} float32 vs fuse_directions=False: output and 8 gradients "
          f"worst max|diff|/max {max(rel):.2e} (bound {TRAIN_GRAD_REL:.0e}), "
          f"equal bits {equal}; inference form equal bits {inf_equal}; "
          f"launches under autograd {launches[True]}, without "
          f"{launches['no_grad']}")
    check(max(rel) <= TRAIN_GRAD_REL and inf_equal,
          f"fused layer disagrees with the unfused one: {rel}")
    return {"cases": cases, "library": lib, "layer_launches": {
        "autograd": launches[True], "no_grad": launches["no_grad"]},
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


def beam_vs_plain(lp, fl, M: int, Lmax: int):
    """ctc_beam and the plain scan + backtrack on the same inputs: checks
    labels, lens, parents and syms identical and the nll; returns the
    kernel's output and the worst nll relative error."""
    import torch

    from pg_asr_tpu_torch.decoding import beam, cuda_beam

    A = lp.shape[-1]
    prune = None if M == beam._prune_m(A, BEAM_K, None) else M
    out = cuda_beam.ctc_beam_cuda(lp, fl, K=BEAM_K, M=M, Lmax=Lmax)
    lens, scores, parents, syms = beam._scan_hash(
        lp, fl, K=BEAM_K, A=A, Lmax=Lmax, blank=0, prune=prune)
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


def attn_inputs(dev, dtype):
    """q, k, v as (B, H, T', dh) views of one fused (B, T', 3, H, dh)
    projection (the layout the models hand over) and a ragged (B, T')
    validity mask with lengths T' and 1 among them, from a seed."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(B, ATTN_T, 3, ATTN_H, ATTN_DH, generator=g)
    lens = torch.randint(1, ATTN_T + 1, (B,), generator=g)
    lens[0], lens[1] = ATTN_T, 1
    valid = (torch.arange(ATTN_T)[None] < lens[:, None]).to(dev)
    qkv = qkv.to(dev, dtype)
    return (*(qkv[:, :, i].transpose(1, 2) for i in range(3)), valid,
            lens.tolist())


def phase_flash(dev):
    """flash_attn vs mhsa_plain at the conformer's attention shape, float32
    and bfloat16; the bound and F.scaled_dot_product_attention beside."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_plain

    scale = ATTN_DH ** -0.5
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype)
        got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
        ref = mhsa_plain(q, k, v, valid, scale)
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
        same = valid[:, None, :, None] == valid[:, None, None, :]
        k_ms, p_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale),
            10, 50)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale), 50)
        lib_err = (F.scaled_dot_product_attention(
            q, k, v, attn_mask=same, scale=scale).float()
            - ref.float()).abs().max().item()
        # operations on the (query, key) pairs the segment mask leaves: a
        # valid query meets the len valid keys, a padded one the T' - len
        # padded keys; q . k and p . v are 2 flops per multiply-add each.
        # Bytes: q, k, v read once, the output written once, the int32 mask
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        flops = 4 * ATTN_H * ATTN_DH * pairs
        nbytes = (4 * B * ATTN_H * ATTN_T * ATTN_DH * q.element_size()
                  + B * ATTN_T * 4)
        b_ms, b_by = bound_ms(flops, nbytes, name)
        case = {"dtype": name, "B": B, "H": ATTN_H, "T": ATTN_T,
                "dh": ATTN_DH, "pairs_per_head": pairs,
                "max_abs_err": err.max().item(),
                "mean_abs_err": err.mean().item(), "bound": bound,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms,
                "library_max_abs_err": lib_err}
        cases.append(case)
        print(f"[kernel] flash_attn B={B} H={ATTN_H} T'={ATTN_T} "
              f"dh={ATTN_DH} {name} (q, k, v views of the fused qkv): "
              f"max_abs_err {case['max_abs_err']:.3e} (bound {bound:.3e}), "
              f"mean {case['mean_abs_err']:.3e}; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{flops / 1e9:.3f} GFLOP on {pairs} pairs x {ATTN_H} heads, "
              f"{nbytes / 1e6:.1f} MB); F.scaled_dot_product_attention "
              f"{lib_ms:.4f} ms (max diff to plain {lib_err:.1e})")
    return cases


def _rel_errs(got, ref):
    """(max, mean) abs error of got relative to max|ref|."""
    top = ref.float().abs().max().item()
    d = (got.float() - ref.float()).abs()
    return d.max().item() / top, d.mean().item() / top


def phase_flash_bwd(dev):
    """The residual form of flash_attn and flash_attn_bwd_dkv / _dq vs
    their plain versions at phase 3c's shape, float32 and bfloat16; the
    bounds and the backward of F.scaled_dot_product_attention beside."""
    import torch
    import torch.nn.functional as F

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_bwd_plain, mhsa_plain

    scale = ATTN_DH ** -0.5
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, valid, lens = attn_inputs(dev, dtype)
        s = q.element_size()
        # --- the residual form
        o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                  residuals=True)
        r_o, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        torch.cuda.synchronize()
        check(l.dtype == m.dtype == torch.float32
              and l.shape == m.shape == q.shape[:3], "l, m dtype/shape")
        check(torch.equal(o, cuda_flash_attn.flash_attn_cuda(
            q, k, v, valid, scale)), "the residual form's o differs from "
            "the inference form's")
        l_rel = ((l - r_l).abs() / r_l).max().item()
        m_err = (m - r_m).abs().max().item()
        print(f"[kernel] flash_attn residual {name}: l max rel err "
              f"{l_rel:.2e} (bound {FLASH_L_REL:.0e}), m max abs err "
              f"{m_err:.2e} (bound {FLASH_M_ABS:.0e})")
        check(l_rel <= FLASH_L_REL and m_err <= FLASH_M_ABS,
              f"flash_attn residual {name}: l {l_rel}, m {m_err}")
        pairs = sum(n * n + (ATTN_T - n) ** 2 for n in lens)
        bht = B * ATTN_H * ATTN_T
        tensor = bht * ATTN_DH * s  # bytes of one (B, H, T', dh) tensor
        b_res = bound_ms(4 * ATTN_H * ATTN_DH * pairs,
                         4 * tensor + B * ATTN_T * 4 + 2 * bht * 4, name)
        k_ms, p_ms = in_turns(
            lambda: mhsa_plain(q, k, v, valid, scale, residuals=True),
            lambda: cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                    residuals=True), 10, 50)
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
        dkv_ms, dkv_plain = in_turns(
            lambda: mhsa_bwd_plain(*args[:4], r_o, r_l, r_m, do, scale),
            lambda: cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args), 10, 50)
        dq_ms, dq_plain = in_turns(
            lambda: mhsa_bwd_plain(*args[:4], r_o, r_l, r_m, do, scale),
            lambda: cuda_flash_attn.flash_attn_bwd_dq_cuda(*args), 10, 50)
        sdpa_fwd = time_ms(sdpa, 50)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, do),
                           50) - sdpa_fwd
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
                "l_max_rel_err": l_rel, "m_max_abs_err": m_err,
                "res_ms": k_ms, "res_plain_ms": p_ms, "res_bound_ms": b_res[0],
                "res_bound_by": b_res[1], "sdpa_train_fwd_ms": sdpa_fwd,
                "errors_rel_to_max": errs, "bound": bd,
                "control_mean_rel_err": ctrl, "dkv_ms": dkv_ms,
                "dq_ms": dq_ms, "plain_bwd_ms": (dkv_plain + dq_plain) / 2,
                "dkv_bound_ms": b_dkv[0], "dkv_bound_by": b_dkv[1],
                "dq_bound_ms": b_dq[0], "dq_bound_by": b_dq[1],
                "sdpa_bwd_ms": sdpa_bwd}
        cases.append(case)
        print(f"[kernel] flash_attn residual {name}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_res[0]:.4f} ms ({b_res[1]}); "
              f"F.scaled_dot_product_attention training forward "
              f"{sdpa_fwd:.4f} ms")
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
              f"{case['plain_bwd_ms']:.4f} ms; "
              f"F.scaled_dot_product_attention backward {sdpa_bwd:.4f} ms")
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
        unf_train_ms, fused_train_ms = in_turns(unfused_train, fused_train,
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


def phase_predict(dev, corpus, alphabet, d, kernel_cases):
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

    cuda_lstm.LAUNCHES = 0
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model_dir, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_lstm.LAUNCHES
    print(f"[predict] rc={rc} in {wall:.2f} s (host clock, first run: "
          f"includes data loading and warm-up); lstm_fwd launches {launches}")
    check(rc == 0, "predict failed")
    check("CER:" in out and "WER:" in out, "CER/WER not printed")
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        rows = fo.read().splitlines()
    check(len(rows) == len(utts) and all("|" in r for r in rows),
          f"predicted.txt has {len(rows)} rows for {len(utts)} utts")
    per_batch = 2 * cfg.model.num_layers
    check(launches == per_batch * n_batches,
          f"lstm_fwd launched {launches} times, expected {per_batch} x "
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
        lstm = per_batch * sum(c["ms"] for c in kernel_cases["fwd"]
                               if c["dtype"] == dtype) / 2
        print(f"[predict] forward B={B} x 5 s (T={T}), {dtype}: with kernel "
              f"{f_k:.2f} ms; the 6 LSTM directions at phase 3's kernel "
              f"times: {lstm:.2f} ms ({lstm / f_k:.0%})")

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
    once and lstm_fwd 6 times. Returns the ctc_beam launches."""
    import torch

    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_lstm

    n_batches = -(-n_utts // BEAM_B)
    per_batch = 2 * Config().model.num_layers
    cuda_lstm.LAUNCHES = cuda_beam.LAUNCHES = 0
    t0 = time.perf_counter()
    rc, out = run_cli(["--mode", "predict", "--decoder", "beam",
                       "--corpus_path", corpus, "--model_path", model_dir,
                       "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, lstm = cuda_beam.LAUNCHES, cuda_lstm.LAUNCHES
    print(f"[predict] --decoder beam: rc={rc} in {wall:.2f} s (host clock); "
          f"{n_utts} utterances in {n_batches} batch(es) of <= {BEAM_B}; "
          f"ctc_beam launches {launches}, lstm_fwd launches {lstm}")
    check(rc == 0, "beam predict failed")
    check("CER:" in out and "WER:" in out, "beam predict: CER/WER not printed")
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        rows = fo.read().splitlines()
    check(len(rows) == n_utts and all("|" in r for r in rows),
          f"beam predict: predicted.txt has {len(rows)} rows for {n_utts}")
    check(launches == n_batches,
          f"ctc_beam launched {launches} times for {n_batches} batches")
    check(lstm == per_batch * n_batches,
          f"beam predict: lstm_fwd launched {lstm} times, expected "
          f"{per_batch} x {n_batches}")
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


def phase_train(dev, corpus, alphabet, d, kernel_cases):
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
    per = 2 * Config().model.num_layers  # LSTM directions per forward
    model_dir = os.path.join(d, "trained")
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model_dir, "--device", str(dev), "--seed", str(SEED)]

    cuda_lstm.LAUNCHES = cuda_lstm.RES_LAUNCHES = cuda_lstm.BWD_LAUNCHES = 0
    cuda_lstm.BI_LAUNCHES = cuda_lstm.BI_RES_LAUNCHES = 0
    cuda_lstm.BI_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    rc, out = run_cli(argv + ["--num_epochs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"lstm_fwd": cuda_lstm.LAUNCHES,
              "lstm_fwd_residual": cuda_lstm.RES_LAUNCHES,
              "lstm_bwd": cuda_lstm.BWD_LAUNCHES}
    print(f"[train] rc={rc}, 1 epoch of {n_train} utterances ({steps} "
          f"steps of <= {bs}) + validation on {len(dev_utts)} in {wall:.2f} "
          f"s (host clock, includes WAV decode); launches {counts}")
    check(rc == 0, "train failed")
    check(counts["lstm_bwd"] == per * steps,
          f"lstm_bwd launched {counts['lstm_bwd']} times, expected {per} x "
          f"{steps} steps")
    check(counts["lstm_fwd_residual"] == per * steps,
          f"residual lstm_fwd launched {counts['lstm_fwd_residual']} times, "
          f"expected {per} x {steps} steps")
    check(counts["lstm_fwd"] == per * n_dev,
          f"inference lstm_fwd launched {counts['lstm_fwd']} times, expected "
          f"{per} x {n_dev} dev batches")
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
    cuda_lstm.LAUNCHES = 0
    rc, out = run_cli(["--mode", "predict", "--corpus_path", corpus,
                       "--model_path", model_dir, "--device", str(dev)])
    check(rc == 0 and "CER:" in out and "WER:" in out,
          "predict on the trained model failed")
    check(cuda_lstm.LAUNCHES == per * -(-n_test // bs),
          f"predict on the trained model: {cuda_lstm.LAUNCHES} lstm_fwd "
          "launches")
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
        f = per * sum(c["ms"] for c in kernel_cases["res"]
                      if c["dtype"] == dtype) / 2
        b = per * sum(c["ms"] for c in kernel_cases["bwd"]
                      if c["dtype"] == dtype) / 2
        print(f"[train] step B={B} x 5 s (T={T}, labels 60), {dtype}: "
              f"{ms:.2f} ms; at phase 3's kernel times the 6 residual "
              f"forwards {f:.2f} ms ({f / ms:.0%}) and the 6 backwards "
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
        cuda_flash_attn.LAUNCHES = cuda_beam.LAUNCHES = cuda_lstm.LAUNCHES = 0
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
        check(beams == (n_batches if extra else 0) and cuda_lstm.LAUNCHES == 0,
              f"{family} {name}: ctc_beam {beams}, lstm_fwd "
              f"{cuda_lstm.LAUNCHES} launches")
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
        return (cuda_lstm.LAUNCHES + cuda_lstm.RES_LAUNCHES
                + cuda_lstm.BWD_LAUNCHES + cuda_beam.LAUNCHES) == 0

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
        return (cuda_lstm.LAUNCHES + cuda_lstm.RES_LAUNCHES
                + cuda_lstm.BWD_LAUNCHES + cuda_beam.LAUNCHES) == 0

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
    want_by_enc = {
        "bilstm": {"lstm_fwd_residual": 6, "lstm_bwd": 6},
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
               **{k: v for k, v in (("lstm_fwd_residual",
                                     cuda_lstm.RES_LAUNCHES),
                                    ("lstm_bwd", cuda_lstm.BWD_LAUNCHES),
                                    ("lstm_fwd", cuda_lstm.LAUNCHES)) if v},
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


def device_breakdown(fn, reps: int = 3) -> dict:
    """Kernel time per call of fn on the card, by group, from a
    torch.profiler trace of `reps` calls: flash_attn (the forward in either
    form), flash_bwd (dkv and dq), joint (joint_fwd, joint_bwd and its
    reduction passes), GEMMs, convolutions (the STFT and the depthwise
    conv), LayerNorm, and the rest (elementwise, softmax, copies, the CTC
    and lattice losses, the optimizer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = dict.fromkeys(("flash_attn", "flash_bwd", "joint", "gemm",
                            "conv", "layer_norm", "other"), 0.0)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        # a convolution first: cuDNN names some of its kernels "...gemm"
        group = ("flash_bwd" if "flash_attn_bwd" in name else
                 "flash_attn" if "flash_attn" in name else
                 "joint" if "joint_" in name else
                 "conv" if "conv" in name else
                 "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma"))
                 else "layer_norm" if "layer_norm" in name else "other")
        groups[group] += e.self_device_time_total / 1e3 / reps
    check(sum(groups.values()) > 0, "the profiler saw no kernel time")
    return groups


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
    return [{
        "name": "lstm_fwd", "route": "cuda", "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        "launches": predict_launches[0],
        "launches_by_path": {"predict": predict_launches[0],
                             "train": train_counts["lstm_fwd"]},
        "max_abs_err": max(c["max_abs_err"] for c in cases["fwd"]
                           if c["dtype"] == "float32"),
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": lib["fwd_ms"],
        "cases": cases["fwd"],
    }, {
        "name": "lstm_fwd_residual", "route": "cuda",
        "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        "launches": train_counts["lstm_fwd_residual"],
        "max_abs_err": max(max(v[0] for v in c["errors"].values())
                           for c in cases["res"] if c["dtype"] == "float32"),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": lib["train_fwd_ms"],
        "cases": cases["res"],
    }, {
        "name": "lstm_bwd", "route": "cuda", "source": src + "lstm_bwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:122",
        "launches": train_counts["lstm_bwd"],
        "max_abs_err": max(c["dxp_max_abs_err"] for c in cases["bwd"]
                           if c["dtype"] == "float32"),
        "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": lib["bwd_ms"],
        "cases": cases["bwd"],
    }, *bilstm_rows(bi, src), {
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
        "cases": cases["beam"],
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
    }, {
        "name": "flash_attn_residual", "route": "cuda",
        "source": src + "flash_attn.cu",
        "replaces": "pg_asr_tpu/ops/flash_attn.py:62 (" + lib_fa
                    + " _flash_attention_fwd, save_residuals)",
        "launches": conformer_epoch["flash_attn_residual"],
        "launches_by_path": train_launches("flash_attn_residual"),
        "max_abs_err": max(c["m_max_abs_err"] for c in cases["flash_bwd"]
                           if c["dtype"] == "float32"),
        "ms": fb["res_ms"], "plain_ms": fb["res_plain_ms"],
        "bound_ms": fb["res_bound_ms"], "bound_by": fb["res_bound_by"],
        "library_ms": fb["sdpa_train_fwd_ms"],
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
        "models": {"transducer": tr},
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


def bilstm_rows(bi, src):
    """The kernels line's rows 3 (both forms) and 4: launches from the
    fused layer's runs in phase 3f (with counts set to 0 just before each),
    float32 times."""
    c = next(c for c in bi["cases"] if c["dtype"] == "float32")
    lib = bi["library"]
    note = ("cuDNN nn.LSTM(512, 256, bidirectional=True), which also does "
            "the input projection")
    rows = []
    for name, key, lib_key, launches in (
            ("bilstm_fwd", "fwd", "fwd_ms", bi["layer_launches"]["no_grad"]),
            ("bilstm_fwd_residual", "res", "train_fwd_ms",
             bi["layer_launches"]["autograd"]),
            ("bilstm_bwd", "bwd", "bwd_ms", bi["layer_launches"]["autograd"])):
        errs = c["bwd_errors" if key == "bwd" else "fwd_errors"]
        two = {"fwd": "two_lstm_fwd_ms", "res": "two_lstm_fwd_residual_ms",
               "bwd": "two_lstm_bwd_ms"}[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": src + ("bilstm_bwd.cu" if key == "bwd"
                             else "bilstm_fwd.cu"),
            "replaces": "pg_asr_tpu/ops/pallas_lstm.py:"
                        + ("357" if key == "bwd" else "318"),
            "launches": launches[name],
            "max_abs_err": max(v[0] for k, v in errs.items()
                               if k.startswith(("y", "h", "c", "dxp"))),
            "ms": c[f"{key}_ms"], "plain_ms": c[f"{key}_plain_ms"],
            "bound_ms": c[f"{key}_bound_ms"],
            "bound_by": c[f"{key}_bound_by"], "library_ms": lib[lib_key],
            "library_note": note, two: c[two],
            "cases": bi["cases"] if key == "fwd" else None,
        })
    return rows


def main() -> int:
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    cases = phase_kernels(dev)
    cases["beam"] = phase_beam(dev)
    cases["flash"] = phase_flash(dev)
    cases["flash_bwd"] = phase_flash_bwd(dev)
    cases["joint"] = phase_joint(dev)
    bi = phase_bilstm(dev)
    lib = phase_library(dev)
    with tempfile.TemporaryDirectory() as d:
        corpus, alphabet = make_corpus(d)
        predict_launches = phase_predict(dev, corpus, alphabet, d, cases)
        train_counts, _ = phase_train(dev, corpus, alphabet, d, cases)
        attention = {family: phase_attention(dev, corpus, alphabet, d, family,
                                             cases["flash"])
                     for family in ("conformer", "transformer")}
        attention_train = {family: phase_attention_train(dev, corpus,
                                                         alphabet, d, family)
                           for family in ("conformer", "transformer")}
        tr = phase_transducer_train(dev, corpus, alphabet, d, cases["joint"])
        tr["predict"] = phase_transducer_predict(
            dev, corpus, alphabet, os.path.join(d, "transducer_fused"))

    import torch

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "pg_asr_tpu"))
    check(not bad, f"the port imported {bad}")
    print(f"[smoke] total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels_line(cases, lib, predict_launches,
                                              train_counts, attention,
                                              attention_train, tr, bi)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
