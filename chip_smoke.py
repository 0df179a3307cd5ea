#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pg_asr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back to
the CPU or to a kernel's plain version):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the hand-written kernels from pg_asr_tpu_torch/csrc.
  3. kernels: each kernel vs its plain PyTorch version on the card, at the
     shapes the predict path gives it, with max-abs error and CUDA-event
     times.
  4. slice: batch transcription through the port's CLI (`--mode predict
     --device cuda`, default batch size 32) of 96 synthetic utterances of
     1-5 s with the full-width default BiLSTM-CTC (random weights from a
     seed); checks predicted.txt, CER/WER, that every LSTM direction of every
     batch went through the kernel, and one batch's log-probs against the
     same forward with the plain recurrence; times the forward at B=64 x 5 s.
  5. prints a JSON line of kernel results, then as the last line
     {"ok": true, "device": {...}}.

It imports only the port (pg_asr_tpu_torch) and fails if jax or flax was
imported.
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
# the synthetic corpus puts n_utts // 8 utterances in its test split: 96,
# three batches at the CLI's default batch size of 32
N_UTTS = 768
# kernel vs plain bounds at B=64, T=401, H=256 (max and mean abs error).
# float32 differs only in the summation order of h@U (max ~1.5e-7).
# bfloat16: both round their output to bf16, so a slightly different sum can
# land one ulp away; 4e-3 is one ulp in [0.5, 1). The max cannot tell whether
# the kernel rounds h to bf16 before the product as the Pallas kernel does (a
# plain run without that rounding is also 1-2 ulps off at most); the mean
# can: ~1e-7 with the rounding, ~1e-5 without, and its bound lies between.
# The script checks that this control run exceeds the mean bound.
BOUNDS = {"float32": {"max": 1e-5, "mean": 1e-7},
          "bfloat16": {"max": 4e-3, "mean": 1e-6}}
# end-to-end log-probs (3 BiLSTM layers + head + log-softmax, float32)
LOGPROB_BOUND = 1e-3


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


def phase_kernels(dev):
    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm

    B, T, H = 64, 401, 256  # 5 s at hop 200, the default hidden size
    g = torch.Generator().manual_seed(SEED)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0], lens[1] = T, 1
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
    xp32 = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    U32 = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        xp, U = xp32.to(dtype), U32.to(dtype)
        name = str(dtype).split(".")[1]
        bound = BOUNDS[name]
        for reverse in (False, True):
            got = cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)
            ref = cuda_lstm.lstm_scan_plain(xp, U, mask, reverse)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err, mean_err = diff.max().item(), diff.mean().item()
            check(got.dtype == dtype and got.shape == (B, T, H),
                  "kernel output dtype/shape")
            check(bool(torch.all(got[mask == 0] == 0)),
                  "kernel output not zero at padded steps")

            def k(xp=xp, U=U, reverse=reverse):
                cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse)

            def p(xp=xp, U=U, reverse=reverse):
                cuda_lstm.lstm_scan_plain(xp, U, mask, reverse)

            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (time_ms(p, 3), time_ms(k, 20), time_ms(k, 20),
                              time_ms(p, 3))
            case = {"dtype": name, "reverse": reverse, "max_abs_err": err,
                    "mean_abs_err": mean_err, "bound": bound,
                    "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
            ctrl = ""
            if dtype == torch.bfloat16:
                # control: the plain version with h kept in float32
                skip = cuda_lstm.lstm_scan_plain(xp, U.float(), mask, reverse)
                case["control_mean_abs_err"] = (
                    skip.float() - ref.float()).abs().mean().item()
                ctrl = (f", control without h rounding: mean "
                        f"{case['control_mean_abs_err']:.3e}")
            print(f"[kernel] lstm_fwd B={B} T={T} H={H} {name} "
                  f"{'reverse' if reverse else 'forward'}: max_abs_err "
                  f"{err:.3e} (bound {bound['max']:.0e}), mean_abs_err "
                  f"{mean_err:.3e} (bound {bound['mean']:.0e}){ctrl}; kernel "
                  f"{case['ms']:.3f} ms, plain {case['plain_ms']:.3f} ms")
            check(err <= bound["max"] and mean_err <= bound["mean"],
                  f"lstm_fwd {name} reverse={reverse} disagrees with the "
                  f"plain version: max {err}, mean {mean_err} > {bound}")
            check(case.get("control_mean_abs_err", math.inf) > bound["mean"],
                  f"the {name} mean bound does not tell apart a recurrence "
                  "that skips the rounding of h")
            cases.append(case)
    return cases


def phase_slice(dev, kernel_cases):
    import torch

    from pg_asr_tpu_torch import cli
    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import Config, ModelConfig
    from pg_asr_tpu_torch.data import (BatchIterator, load_manifest,
                                       make_synthetic_corpus)
    from pg_asr_tpu_torch.models import bilstm_ctc
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.predict import forward, load_model

    bs = 32  # the CLI's default, which the run below does not override
    with tempfile.TemporaryDirectory() as d:
        corpus, alphabet = make_synthetic_corpus(
            os.path.join(d, "corpus"), n_utts=N_UTTS, seed=SEED, min_dur=1.0,
            max_dur=5.0, words=WORDS)
        cfg = Config()
        cfg = cfg.replace(model=ModelConfig(vocab_size=alphabet.size))
        params = bilstm_ctc.init_params(
            cfg.model, torch.Generator().manual_seed(SEED))
        model_dir = os.path.join(d, "model")
        save_model(model_dir, params, cfg)
        n_params = sum(p.numel() for p in params.values())
        test_tsv = os.path.join(corpus, "test.tsv")
        clips = os.path.join(corpus, "clips")
        utts = load_manifest(test_tsv, clips)
        n_batches = -(-len(utts) // bs)
        print(f"[slice] BiLSTM-CTC {cfg.model.num_layers}x"
              f"{cfg.model.hidden_size}/dir, proj {cfg.model.input_proj_dim},"
              f" vocab {alphabet.size}, {n_params} params; {len(utts)} test "
              f"utterances in {n_batches} batches of <= {bs}")

        argv = ["--mode", "predict", "--corpus_path", corpus, "--model_path",
                model_dir, "--device", str(dev)]
        out = io.StringIO()
        cuda_lstm.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_lstm.LAUNCHES
        print(out.getvalue().rstrip())
        print(f"[slice] predict rc={rc} in {wall:.2f} s (host clock, first "
              f"run: includes data loading and warm-up); lstm_fwd launches "
              f"{launches}")
        check(rc == 0, "predict failed")
        check("CER:" in out.getvalue() and "WER:" in out.getvalue(),
              "CER/WER not printed")
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
        lp_k, mask, _ = forward(params_d, wave, ns, cfg_d)
        lp_p, _, _ = forward(params_d, wave, ns, cfg_d, use_kernel=False)
        torch.cuda.synchronize()
        T = batch.wave.shape[1] // cfg.features.hop_length + 1
        check(tuple(lp_k.shape) == (len(batch.texts), T, alphabet.size),
              f"log-probs shape {tuple(lp_k.shape)}")
        check(bool(torch.isfinite(lp_k).all()), "non-finite log-probs")
        err = (lp_k - lp_p).abs().max().item()
        print(f"[slice] batch log-probs {tuple(lp_k.shape)}: kernel vs plain "
              f"max_abs_err {err:.3e} (bound {LOGPROB_BOUND:.0e})")
        check(err <= LOGPROB_BOUND, f"log-probs disagree: {err}")

        # the forward (features + model) at the kernel phase's batch shape
        g = torch.Generator().manual_seed(SEED)
        wave64 = (torch.randn(64, 80000, generator=g) * 3000).to(
            torch.int16).to(dev)
        ns64 = torch.full((64,), 80000, dtype=torch.int64, device=dev)
        for dtype in ("float32", "bfloat16"):
            p_d, c_d = load_model(model_dir, alphabet, device=dev, dtype=dtype)
            f_k = time_ms(lambda: forward(p_d, wave64, ns64, c_d), 5)
            lstm = 2 * cfg.model.num_layers * sum(
                c["ms"] for c in kernel_cases if c["dtype"] == dtype) / 2
            plain = ""
            if dtype == "float32":
                f_p = time_ms(lambda: forward(p_d, wave64, ns64, c_d,
                                              use_kernel=False), 2)
                plain = f", with plain recurrence {f_p:.2f} ms"
            print(f"[slice] forward B=64 x 5 s (T=401), {dtype}: with kernel "
                  f"{f_k:.2f} ms{plain}; the 6 LSTM directions at phase 3's "
                  f"kernel times: {lstm:.2f} ms ({lstm / f_k:.0%})")
    return launches


def main() -> int:
    dev = phase_device()
    phase_build()
    cases = phase_kernels(dev)
    launches = phase_slice(dev, cases)

    import torch

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
    check(not bad, f"the port imported {bad}")
    head = next(c for c in cases if c["dtype"] == "float32"
                and not c["reverse"])
    kernels = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "pg_asr_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "pg_asr_tpu/ops/pallas_lstm.py:80",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["dtype"] == "float32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
