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
  4. predict slice: batch transcription through the port's CLI
     (`--mode predict --device cuda`, default batch 32) of 96 synthetic
     utterances of 1-5 s with the full-width default BiLSTM-CTC (random
     weights from a seed); checks predicted.txt, CER/WER, that every LSTM
     direction of every batch went through lstm_fwd, and one batch's
     log-probs against the plain recurrence; times the forward at
     B=64 x 5 s.
  5. train slice: `--mode train --device cuda` through the CLI, one epoch
     of the synthetic train split (576 utterances, 18 steps at the default
     batch 32) with validation on dev; checks the launch counts of the
     residual forward and the backward (6 per step) and of the inference
     forward (6 per dev batch), the artifacts and finite losses, a resumed
     second epoch, and `--mode predict` on the trained model; then one
     batch's loss and every parameter gradient, kernel path vs plain path,
     with dropout 0; then times one full train step at B=64 x 5 s in
     float32 and bfloat16.
  6. prints a JSON line of kernel results, then as the last line
     {"ok": true, "device": {...}}.

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


def phase_library(dev):
    """cuDNN nn.LSTM, one direction, full-length batch, at the kernels'
    shape, float32: the one PyTorch call that computes the same recurrence
    (it also does the x@W input projection, from a 512-wide input, which
    the kernels receive precomputed). A yardstick only; the port never
    calls it."""
    import torch

    lstm = torch.nn.LSTM(512, H, batch_first=True).to(dev)
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn(B, T, 512, generator=g).to(dev).requires_grad_(True)
    gy = torch.randn(B, T, H, generator=g).to(dev)

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
    print(f"[library] cuDNN nn.LSTM(512, {H}) B={B} T={T} float32, one "
          f"direction: forward {lib['fwd_ms']:.3f} ms (no grad), "
          f"{lib['train_fwd_ms']:.3f} ms (training), backward "
          f"{lib['bwd_ms']:.3f} ms")
    return lib


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
    return launches


def flagship_batch(dev, label_len: int = 60, vocab: int = 28):
    """B=64 utterances of 5 s (WAVE_SAMPLES, T=401 frames) with random
    labels of 60 symbols (the length of 5 s of read English): int16 waves,
    lengths, labels, label lengths on the device."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    wave = (torch.randn(B, WAVE_SAMPLES, generator=g) * 3000).to(torch.int16)
    ns = torch.full((B,), WAVE_SAMPLES, dtype=torch.int32)
    labels = torch.randint(1, vocab, (B, label_len), generator=g,
                           dtype=torch.int32)
    lens = torch.full((B,), label_len, dtype=torch.int32)
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


def kernels_line(cases, lib, predict_launches, train_counts):
    def head(rows):
        return next(c for c in rows if c["dtype"] == "float32"
                    and not c["reverse"])

    f, r, b = head(cases["fwd"]), head(cases["res"]), head(cases["bwd"])
    src = "pg_asr_tpu_torch/csrc/"
    return [{
        "name": "lstm_fwd", "route": "cuda", "source": src + "lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        "launches": predict_launches,
        "launches_by_path": {"predict": predict_launches,
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
    }]


def main() -> int:
    dev = phase_device()
    phase_build()
    cases = phase_kernels(dev)
    lib = phase_library(dev)
    with tempfile.TemporaryDirectory() as d:
        corpus, alphabet = make_corpus(d)
        predict_launches = phase_predict(dev, corpus, alphabet, d, cases)
        train_counts, _ = phase_train(dev, corpus, alphabet, d, cases)

    import torch

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "pg_asr_tpu"))
    check(not bad, f"the port imported {bad}")
    print(json.dumps({"kernels": kernels_line(cases, lib, predict_launches,
                                              train_counts)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
