#!/usr/bin/env python3
"""Time the kernels of two trees of this repository on one GPU, in turns.

    python3 kernel_ab.py [lstm] A_ROOT B_ROOT
    python3 kernel_ab.py flash_bwd A_ROOT B_ROOT

Runs four fresh processes in the order A, B, B, A. Each imports
pg_asr_tpu_torch from its root (building that tree's kernels there at
first use) and times its kernels with CUDA events over 20 launches after a
warm-up (flash_bwd: the launches queued behind a sleep kernel, so that the
events time the card, not the host's launches). It prints the card's name and power limit, each kernel's time in
each turn and its mean per tree; the last line is one JSON object with all
of it.

lstm: lstm_fwd (inference and residual forms) and lstm_bwd at
chip_smoke.py's phase-3 shape (B=64, T=401, H=256, ragged lengths from
seed 0), float32 and bfloat16, forward and reverse; whether the two trees'
outputs have the same bits. Exits non-zero when they differ.

flash_bwd: flash_attn_bwd_dkv and flash_attn_bwd_dq at chip_smoke.py's
phase-3d shape and inputs (B=64, H=4, T'=201, dh=64, q, k, v views of a
fused projection, ragged lengths from seed 0, the plain forward's l and m),
float32 and bfloat16. The trees may sum in other orders, so their bits are
not compared; each tree's dq, dk and dv are held against its plain
backward (mhsa_bwd_plain) within chip_smoke.py's FLASH_BWD_BOUNDS, and the
run exits non-zero when one is not. Then, for tree B, what `nvcc -Xptxas
-v` reports for each backward kernel (registers, stack frame, spills) and
how many HMMA (tensor-core) and FFMA instructions `cuobjdump -sass` finds
in each, where the toolkit has them.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

REPS = 20
# chip_smoke.py FLASH_BWD_BOUNDS: abs errors relative to max|grad|
FLASH_BWD_BOUNDS = {"float32": {"max": 2e-5, "mean": 2e-7},
                    "bfloat16": {"max": 2.0 ** -7, "mean": 1e-6}}


def _time_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _device_ms(fn):
    """As _time_ms, but the launches queue behind a sleep kernel long
    enough for the host to enqueue all of them: the events then time the
    card's work back to back, not the rate at which Python launches
    kernels of tens of microseconds."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 100000)  # > 2 x host_s at 2 GHz
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _digest(*ts):
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def lstm_worker() -> dict:
    import math

    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_plain

    B, T, H = 64, 401, 256
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0], lens[1] = T, 1
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
    xp32 = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    U32 = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    gy32 = torch.randn(B, T, H, generator=g).to(dev)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        xp, U, gy = xp32.to(dtype), U32.to(dtype), gy32.to(dtype)
        for rev in (False, True):
            tag = f"{str(dtype).split('.')[1]}_{'rev' if rev else 'fwd'}"
            _, hp, cp = lstm_scan_plain(xp, U, mask, rev, residuals=True)
            runs = {
                "lstm_fwd": lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, rev),
                "lstm_fwd_residual": lambda: cuda_lstm.lstm_scan_residual_cuda(
                    xp, U, mask, rev),
                "lstm_bwd": lambda: cuda_lstm.lstm_scan_bwd_cuda(
                    xp, U, mask, hp, cp, gy, rev)}
            for name, fn in runs.items():
                res = fn()
                res = res if isinstance(res, tuple) else (res,)
                out[f"{name}_{tag}"] = {"ms": _time_ms(fn),
                                        "digest": _digest(*res)}
    return out


def flash_bwd_worker() -> dict:
    import torch

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_bwd_plain, mhsa_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, T, dh = 64, 4, 201, 64
    dev = torch.device("cuda", 0)
    scale = dh ** -0.5
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        # chip_smoke.py attn_inputs and phase_flash_bwd's do
        g = torch.Generator().manual_seed(0)
        qkv = torch.randn(B, T, 3, H, dh, generator=g)
        lens = torch.randint(1, T + 1, (B,), generator=g)
        lens[0], lens[1] = T, 1
        valid = (torch.arange(T)[None] < lens[:, None]).to(dev)
        qkv = qkv.to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o, l, m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        g = torch.Generator().manual_seed(1)
        do = torch.randn(B, T, H, dh, generator=g).to(dev, dtype).transpose(
            1, 2)
        di = (o.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, valid, l, m, do, di, scale)
        dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args)
        dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(*args)
        want = mhsa_bwd_plain(q, k, v, valid, o, l, m, do, scale)
        errs = {}
        for n, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            top = w.float().abs().max().item()
            d = (got.float() - w.float()).abs()
            errs[n] = [d.max().item() / top, d.mean().item() / top]
        for kind, outs in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
            fn = getattr(cuda_flash_attn, f"flash_attn_bwd_{kind}_cuda")
            out[f"flash_attn_bwd_{kind}_{name}"] = {
                "ms": _device_ms(lambda: fn(*args)),
                "errors_rel_to_max": {n: errs[n] for n in outs}}
    return out


WORKERS = {"lstm": lstm_worker, "flash_bwd": flash_bwd_worker}


def compile_report(root: str) -> dict:
    """Registers, stack frame and spills (`nvcc -Xptxas -v`) and HMMA /
    FFMA counts (`cuobjdump -sass` of the built library) of each kernel of
    root's csrc/flash_attn_bwd.cu, labelled kernel[type, dh]."""
    sys.path.insert(0, root)
    from pg_asr_tpu_torch import _build

    def label(mangled):
        kind = "dkv" if "bwd_dkv_kernel" in mangled else "dq"
        dtype = "bfloat16" if "bfloat16" in mangled else "float32"
        dh = re.search(r"Li(\d+)E", mangled)
        return f"flash_attn_bwd_{kind}[{dtype}, {dh.group(1) if dh else '?'}]"

    nvcc = _build.nvcc_path()
    report: dict = {}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        proc = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "bwd.o"),
             os.path.join(_build.CSRC, "flash_attn_bwd.cu")],
            capture_output=True, text=True)
    current = None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            current = (label(m.group(1)) if "flash_attn_bwd" in m.group(1)
                       else None)
            continue
        if current is None:
            continue
        entry = report.setdefault(current, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    if proc.returncode != 0:
        report["nvcc_error"] = proc.stderr[-2000:]
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", _build.build()],
                              capture_output=True, text=True).stdout
        current = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                current = (label(m.group(1)) if "flash_attn_bwd" in m.group(1)
                           else None)
                continue
            if current is not None:
                entry = report.setdefault(current, {})
                for op in ("HMMA", "FFMA"):
                    if re.search(rf"\b{op}\b", line):
                        entry[op] = entry.get(op, 0) + 1
    else:
        report["cuobjdump"] = "not in the toolkit"
    return report


def main(mode: str, a_root: str, b_root: str) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    turns = []
    for label, root in (("A", a_root), ("B", b_root), ("B", b_root),
                        ("A", a_root)):
        proc = subprocess.run([sys.executable, __file__, "--worker", mode,
                               root], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            raise SystemExit(f"worker on {root} failed ({proc.returncode})")
        turns.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    ok = True
    summary = {}
    for key in turns[0][1]:
        ms = {lab: [t[key]["ms"] for l, t in turns if l == lab]
              for lab in ("A", "B")}
        mean = {lab: sum(v) / len(v) for lab, v in ms.items()}
        row = {"ms": ms, "mean_ms": mean}
        line = (f"{key}: A {mean['A']:.4f} ms {ms['A']}, B {mean['B']:.4f} ms "
                f"{ms['B']} (B/A {mean['B'] / mean['A']:.3f})")
        if mode == "lstm":
            same = len({t[key]["digest"] for _, t in turns}) == 1
            row["same_bits"] = same
            ok &= same
            line += f"; same bits {same}"
        else:
            bound = FLASH_BWD_BOUNDS[key.rsplit("_", 1)[1]]
            # the largest over the kernel's outputs and the tree's turns
            errs = {lab: {n: max(e[i] for l, t in turns if l == lab
                                 for e in t[key]["errors_rel_to_max"].values())
                          for i, n in ((0, "max"), (1, "mean"))}
                    for lab in ("A", "B")}
            within = all(errs[lab]["max"] <= bound["max"]
                         and errs[lab]["mean"] <= bound["mean"]
                         for lab in errs)
            row.update(errors_rel_to_max=errs, within_bounds=within)
            ok &= within
            line += (f"; max/mean err rel to max|grad| A {errs['A']['max']:.2e}"
                     f"/{errs['A']['mean']:.2e}, B {errs['B']['max']:.2e}/"
                     f"{errs['B']['mean']:.2e} (bounds {bound['max']:.1e}/"
                     f"{bound['mean']:.0e}): within {within}")
        summary[key] = row
        print(line)
    result = {"device": smi, "mode": mode, "kernels": summary, "ok": ok}
    if mode == "flash_bwd":
        result["compile_b"] = compile_report(b_root)
        for name, entry in sorted(result["compile_b"].items()):
            print(f"[compile B] {name}: {entry}")
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.path.insert(0, sys.argv[3])
        print(json.dumps(WORKERS[sys.argv[2]]()))
        sys.exit(0)
    argv = sys.argv[1:]
    if len(argv) == 2:
        argv = ["lstm", *argv]
    if len(argv) != 3 or argv[0] not in WORKERS:
        raise SystemExit(__doc__)
    sys.exit(main(*argv))
