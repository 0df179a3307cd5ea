#!/usr/bin/env python3
"""Time the single-direction LSTM kernels of two trees of this repository
on one GPU, in turns, and compare their outputs bit for bit.

    python3 kernel_ab.py A_ROOT B_ROOT

Runs four fresh processes in the order A, B, B, A. Each imports
pg_asr_tpu_torch from its root (building that tree's kernels there at
first use) and times lstm_fwd (inference and residual forms) and lstm_bwd
at chip_smoke.py's phase-3 shape (B=64, T=401, H=256, ragged lengths from
seed 0), float32 and bfloat16, forward and reverse: CUDA events over 20
launches after a warm-up. It prints the card's name and power limit, each
kernel's time in each turn and its mean per tree, and whether the two
trees' outputs have the same bits; the last line is one JSON object with
all of it. Exits non-zero when the outputs differ.
"""

from __future__ import annotations

import json
import subprocess
import sys

B, T, H, REPS = 64, 401, 256, 20


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import hashlib
    import math

    import torch

    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_plain

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    lens = torch.randint(1, T + 1, (B,), generator=g)
    lens[0], lens[1] = T, 1
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.float32)
    xp32 = (0.5 * torch.randn(B, T, 4 * H, generator=g)).to(dev)
    U32 = ((torch.rand(H, 4 * H, generator=g) * 2 - 1) / math.sqrt(H)).to(dev)
    gy32 = torch.randn(B, T, H, generator=g).to(dev)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def time_ms(fn):
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
                out[f"{name}_{tag}"] = {"ms": time_ms(fn),
                                        "digest": digest(*res)}
    return out


def main(a_root: str, b_root: str) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    turns = []
    for label, root in (("A", a_root), ("B", b_root), ("B", b_root),
                        ("A", a_root)):
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            raise SystemExit(f"worker on {root} failed ({proc.returncode})")
        turns.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    same_bits = True
    summary = {}
    for key in turns[0][1]:
        ms = {lab: [t[key]["ms"] for l, t in turns if l == lab]
              for lab in ("A", "B")}
        digests = {t[key]["digest"] for _, t in turns}
        same_bits &= len(digests) == 1
        mean = {lab: sum(v) / len(v) for lab, v in ms.items()}
        summary[key] = {"ms": ms, "mean_ms": mean, "same_bits":
                        len(digests) == 1}
        print(f"{key}: A {mean['A']:.4f} ms {ms['A']}, B {mean['B']:.4f} ms "
              f"{ms['B']} (B/A {mean['B'] / mean['A']:.3f}); same bits "
              f"{len(digests) == 1}")
    print(json.dumps({"device": smi, "kernels": summary,
                      "same_bits": same_bits}))
    return 0 if same_bits else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
