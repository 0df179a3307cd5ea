#!/usr/bin/env python3
"""Time the kernels of two trees of this repository on one GPU, in turns.

    python3 kernel_ab.py [lstm] A_ROOT B_ROOT
    python3 kernel_ab.py flash_fwd A_ROOT B_ROOT
    python3 kernel_ab.py flash_bwd A_ROOT B_ROOT
    python3 kernel_ab.py joint A_ROOT B_ROOT
    python3 kernel_ab.py beam A_ROOT B_ROOT
    python3 kernel_ab.py bilstm A_ROOT B_ROOT

Runs four fresh processes in the order A, B, B, A. Each imports
pg_asr_tpu_torch from its root (building that tree's kernels there at
first use) and times its kernels with CUDA events over 20 launches after a
warm-up (flash_fwd, flash_bwd: the launches queued behind a sleep kernel,
so that the events time the card, not the host's launches). It prints the
card's name and power limit, each kernel's time in each turn and its mean
per tree; then, for tree B, what `nvcc -Xptxas -v` reports for each kernel
of the mode's source (registers, stack frame, spills) and how many HMMA
(tensor-core) and FFMA instructions `cuobjdump -sass` finds in each, where
the toolkit has them. The last line is one JSON object with all of it. It
exits non-zero when a check below fails.

lstm: lstm_fwd (inference and residual forms) and lstm_bwd at
chip_smoke.py's phase-3 shape (B=64, T=401, H=256, ragged lengths from
seed 0), float32 and bfloat16, forward and reverse. Both kernels sum in
other orders since their cluster designs, so each tree is held against
the plain versions, and a second launch must repeat its bits: lstm_fwd's
out, hprev and cprev against lstm_scan_plain within chip_smoke.py's BOUNDS
and CPREV_BOUNDS (max and mean abs error); lstm_bwd's dxp and dU against
the plain backward (lstm_scan_bwd_plain) on the plain forward's residuals
within the card test's bounds (float32 dxp 1e-5, dU 1e-5 x max|dU|;
bfloat16 2e-2 x max|ref| each). Compile report: csrc/lstm_fwd.cu and
csrc/lstm_bwd.cu.

flash_fwd: flash_attn in its inference and residual forms at
chip_smoke.py's phase-3c shape and inputs (B=64, H=4, T'=201, dh=64, q, k,
v views of a fused projection, ragged lengths from seed 0), float32 and
bfloat16; each tree's o, l and m held against mhsa_plain(residuals=True)
within chip_smoke.py's FLASH_BOUNDS, FLASH_L_REL and FLASH_M_ABS; float32's
o, l and m must have the same bits in both trees. Compile report:
csrc/flash_attn.cu.

flash_bwd: flash_attn_bwd_dkv and flash_attn_bwd_dq at chip_smoke.py's
phase-3d shape and inputs (phase 3c's, the plain forward's l and m),
float32 and bfloat16; each tree's dq, dk and dv held against the plain
backward (mhsa_bwd_plain) within chip_smoke.py's FLASH_BWD_BOUNDS.
Compile report: csrc/flash_attn_bwd.cu.

joint: joint_fwd and joint_bwd at chip_smoke.py's phase-3e shape and
inputs (B=64, T'=201, U+1=61, J=256, A=28, ragged lengths and cotangents
from seed 0: chip_smoke.joint_inputs), float32 and bfloat16; each tree's
tables and gradients held against the plain versions within
chip_smoke.py's JOINT_BOUNDS, and a second launch must repeat its bits.
joint_fwd is also timed alone behind a sleep kernel (device-timed).
Then the fused pair (joint_fwd + joint_bwd, the work of one training
step) beside the port's unfused composition (chip_smoke.unfused_joint
under autograd): each over 20 launches, the pair also device-timed, and
both by phase 3e's protocol (5 launches, unfused and fused in turns).
Compile report: csrc/joint_fwd.cu and csrc/joint_bwd.cu.

beam: ctc_beam at chip_smoke.py's phase-3b shape and inputs (B=128,
T=401, A=28, K=16, sharp posteriors and ragged lengths from seed 0:
chip_smoke.beam_inputs), M=6 (the default prune) and M=18 (exact); each
tree's labels, lens, parents and syms must equal the plain scan's
(decoding/beam.py _scan_hash + _backtrack_batch), its nll within
chip_smoke.py's BEAM_NLL_REL, and both trees must give the same bits.
Compile report: csrc/ctc_beam.cu.

bilstm: the fused directions at chip_smoke.py's phase-3f shape and inputs
(B=64, T=401, H=256 per direction, ragged lengths from seed 0:
chip_smoke.bi_inputs), float32 and bfloat16: bilstm_fwd (inference and
residual forms) and bilstm_bwd, each tree's outputs held against the plain
versions (bilstm_scan_plain, bilstm_scan_bwd_plain on the plain forward's
residuals) within chip_smoke.py's BOUNDS, CPREV_BOUNDS and the card test's
backward bounds, a second launch repeating its bits; beside them two
single-direction launches of each (2 x lstm_fwd in both forms, 2 x
lstm_bwd, forward and reverse on one stream) and lstm_fwd / lstm_bwd alone
(one forward-scan direction). Compile report: csrc/lstm_fwd.cu and
csrc/lstm_bwd.cu.

Any tree can be passed: a copy of pg_asr_tpu_torch/ with a constant
changed makes a variant (its worker alone: `kernel_ab.py --worker MODE
ROOT` prints one JSON line).
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
# chip_smoke.py FLASH_BOUNDS (max abs error of o; bf16 relative to
# max|v|) and FLASH_L_REL, FLASH_M_ABS (the residual form's l and m)
FLASH_BOUNDS = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
FLASH_L_REL, FLASH_M_ABS = 1e-5, 1e-5
# tests/test_torch_cuda.py test_lstm_bwd_kernel_matches_plain: float32 dxp
# atol 1e-5 and dU atol 1e-5 x max|dU|; bfloat16 both 2e-2 x max|ref|
LSTM_BWD_REL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def _abs_err(got, ref):
    return (got.float() - ref.float()).abs().max().item()



def lstm_worker() -> dict:
    import math

    import torch

    import chip_smoke as cs  # phase 3's bounds
    from pg_asr_tpu_torch.ops import cuda_lstm
    from pg_asr_tpu_torch.ops.lstm import lstm_scan_bwd_plain, lstm_scan_plain

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
        name = str(dtype).split(".")[1]
        for rev in (False, True):
            tag = f"{name}_{'rev' if rev else 'fwd'}"
            ref = lstm_scan_plain(xp, U, mask, rev, residuals=True)
            _, hp, cp = ref
            for form, fn in (
                    ("lstm_fwd",
                     lambda: cuda_lstm.lstm_scan_cuda(xp, U, mask, rev)),
                    ("lstm_fwd_residual",
                     lambda: cuda_lstm.lstm_scan_residual_cuda(xp, U, mask,
                                                               rev))):
                res = fn()
                res = res if isinstance(res, tuple) else (res,)
                again = fn()
                again = again if isinstance(again, tuple) else (again,)
                errors, bounds = {}, {}
                for k, got, want in zip(("out", "hprev", "cprev"), res, ref):
                    bd = (cs.CPREV_BOUNDS if k == "cprev"
                          else cs.BOUNDS)[name]
                    errors[f"{k}_max"], errors[f"{k}_mean"] = cs._errs(
                        got, want)
                    bounds[f"{k}_max"], bounds[f"{k}_mean"] = (bd["max"],
                                                               bd["mean"])
                out[f"{form}_{tag}"] = {
                    "ms": _time_ms(fn), "errors": errors, "bounds": bounds,
                    "repeats_its_bits": _digest(*res) == _digest(*again)}
            # lstm_bwd sums in another order than the parent's: each tree
            # is held against the plain backward, not against the other
            bwd = lambda: cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, hp, cp,
                                                       gy, rev)
            dxp, dU = bwd()
            again = bwd()
            r_dxp, r_dU = lstm_scan_bwd_plain(xp, U, mask, hp, cp, gy, rev)
            rel = LSTM_BWD_REL[name]
            out[f"lstm_bwd_{tag}"] = {
                "ms": _time_ms(bwd),
                "errors": {"dxp": _abs_err(dxp, r_dxp),
                           "dU": _abs_err(dU, r_dU)},
                "bounds": {"dxp": rel * (1.0 if name == "float32" else
                                         r_dxp.float().abs().max().item()),
                           "dU": rel * r_dU.float().abs().max().item()},
                "repeats_its_bits": _digest(dxp, dU) == _digest(*again)}
    return out


def bilstm_worker() -> dict:
    import torch

    import chip_smoke as cs  # phase 3f's inputs and phase 3's bounds
    from pg_asr_tpu_torch.ops import cuda_lstm as cl
    from pg_asr_tpu_torch.ops.lstm import (bilstm_scan_bwd_plain,
                                           bilstm_scan_plain)

    dev = torch.device("cuda", 0)
    mask, *inputs32, _ = cs.bi_inputs(dev)
    H = cs.H
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        xpf, xpb, Uf, Ub, gy = (t.to(dtype) for t in inputs32)
        args = (xpf, xpb, Uf, Ub, mask)
        name = str(dtype).split(".")[1]
        ref = bilstm_scan_plain(*args, residuals=True)
        r_bwd = bilstm_scan_bwd_plain(*args, *ref[1:], gy)
        gyf, gyb = gy[..., :H].contiguous(), gy[..., H:].contiguous()
        for key, fn, want in (
                ("bilstm_fwd", lambda: cl.bilstm_scan_cuda(*args), ref[:1]),
                ("bilstm_fwd_residual",
                 lambda: cl.bilstm_scan_residual_cuda(*args), ref),
                ("bilstm_bwd",
                 lambda: cl.bilstm_scan_bwd_cuda(*args, *ref[1:], gy),
                 r_bwd)):
            res = fn()
            res = res if isinstance(res, tuple) else (res,)
            again = fn()
            again = again if isinstance(again, tuple) else (again,)
            errors, bounds = {}, {}
            for k, got, w in zip(("dxpf", "dxpb", "dUf", "dUb")
                                 if key == "bilstm_bwd" else
                                 ("y", "hpf", "cpf", "hpb", "cpb"), res, want):
                if key == "bilstm_bwd":
                    rel = LSTM_BWD_REL[name]
                    errors[k] = _abs_err(got, w)
                    bounds[k] = rel * (1.0 if name == "float32"
                                       and k.startswith("dxp")
                                       else w.float().abs().max().item())
                else:
                    bd = (cs.CPREV_BOUNDS if k.startswith("c")
                          else cs.BOUNDS)[name]
                    errors[f"{k}_max"], errors[f"{k}_mean"] = cs._errs(got, w)
                    bounds[f"{k}_max"], bounds[f"{k}_mean"] = (bd["max"],
                                                               bd["mean"])
            out[f"{key}_{name}"] = {
                "ms": _time_ms(fn), "errors": errors, "bounds": bounds,
                "repeats_its_bits": _digest(*res) == _digest(*again)}
        for key, fn in (
                ("2x_lstm_fwd", lambda: (cl.lstm_scan_cuda(xpf, Uf, mask),
                                         cl.lstm_scan_cuda(xpb, Ub, mask,
                                                           True))),
                ("2x_lstm_fwd_residual",
                 lambda: (cl.lstm_scan_residual_cuda(xpf, Uf, mask),
                          cl.lstm_scan_residual_cuda(xpb, Ub, mask, True))),
                ("2x_lstm_bwd",
                 lambda: (cl.lstm_scan_bwd_cuda(xpf, Uf, mask, ref[1],
                                                ref[2], gyf),
                          cl.lstm_scan_bwd_cuda(xpb, Ub, mask, ref[3],
                                                ref[4], gyb, True))),
                ("lstm_fwd", lambda: cl.lstm_scan_cuda(xpf, Uf, mask)),
                ("lstm_fwd_residual",
                 lambda: cl.lstm_scan_residual_cuda(xpf, Uf, mask)),
                ("lstm_bwd", lambda: cl.lstm_scan_bwd_cuda(
                    xpf, Uf, mask, ref[1], ref[2], gyf))):
            out[f"{key}_{name}"] = {"ms": _time_ms(fn)}
    return out


def flash_fwd_worker() -> dict:
    import torch

    from pg_asr_tpu_torch.ops import cuda_flash_attn
    from pg_asr_tpu_torch.ops.flash_attn import mhsa_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, T, dh = 64, 4, 201, 64
    dev = torch.device("cuda", 0)
    scale = dh ** -0.5
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        # chip_smoke.py attn_inputs
        g = torch.Generator().manual_seed(0)
        qkv = torch.randn(B, T, 3, H, dh, generator=g)
        lens = torch.randint(1, T + 1, (B,), generator=g)
        lens[0], lens[1] = T, 1
        valid = (torch.arange(T)[None] < lens[:, None]).to(dev)
        qkv = qkv.to(dev, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        r_o, r_l, r_m = mhsa_plain(q, k, v, valid, scale, residuals=True)
        o_bound = FLASH_BOUNDS[name] * (v.float().abs().max().item()
                                        if name == "bfloat16" else 1.0)
        o = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
        out[f"flash_attn_{name}"] = {
            "ms": _device_ms(lambda: cuda_flash_attn.flash_attn_cuda(
                q, k, v, valid, scale)),
            "errors": {"o": _abs_err(o, r_o)}, "bounds": {"o": o_bound}}
        o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                                  residuals=True)
        # float32 keeps the first kernel's summation order: the same bits
        # in both trees (bfloat16 moved to the tensor cores)
        digest = {"digest": _digest(o, l, m)} if name == "float32" else {}
        out[f"flash_attn_residual_{name}"] = {**digest,
            "ms": _device_ms(lambda: cuda_flash_attn.flash_attn_cuda(
                q, k, v, valid, scale, residuals=True)),
            "errors": {"o": _abs_err(o, r_o),
                       "l_rel": ((l - r_l).abs() / r_l).max().item(),
                       "m": _abs_err(m, r_m)},
            "bounds": {"o": o_bound, "l_rel": FLASH_L_REL, "m": FLASH_M_ABS}}
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
        bound = FLASH_BWD_BOUNDS[name]
        errs, bounds = {}, {}
        for n, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            top = w.float().abs().max().item()
            d = (got.float() - w.float()).abs()
            errs[f"{n}_max"] = d.max().item() / top
            errs[f"{n}_mean"] = d.mean().item() / top
            bounds[f"{n}_max"] = bound["max"]
            bounds[f"{n}_mean"] = bound["mean"]
        for kind, outs in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
            fn = getattr(cuda_flash_attn, f"flash_attn_bwd_{kind}_cuda")
            out[f"flash_attn_bwd_{kind}_{name}"] = {
                "ms": _device_ms(lambda: fn(*args)),
                "errors": {e: errs[e] for e in errs if e[:2] in outs},
                "bounds": {e: bounds[e] for e in bounds if e[:2] in outs}}
    return out


def joint_worker() -> dict:
    import torch

    import chip_smoke as cs  # phase 3e's inputs, bounds and yardstick
    from pg_asr_tpu_torch.ops import cuda_joint
    from pg_asr_tpu_torch.ops.joint import (fused_joint_bwd_plain,
                                            fused_joint_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        args, gb, gy, _ = cs.joint_inputs(dev, dtype)
        bd = cs.JOINT_BOUNDS[name]
        fwd = lambda: cuda_joint.joint_fwd_cuda(*args)
        bwd = lambda: cuda_joint.joint_bwd_cuda(*args, gb, gy)
        errors, bounds = {}, {}
        for k, got, ref in zip(("lp_blank", "lp_label"), fwd(),
                               fused_joint_plain(*args)):
            errors[f"{k}_max"], errors[f"{k}_mean"] = cs._errs(got, ref)
            bounds[f"{k}_max"], bounds[f"{k}_mean"] = (bd["lp_max"],
                                                       bd["lp_mean"])
        out[f"joint_fwd_{name}"] = {
            "ms": _time_ms(fwd), "errors": errors, "bounds": bounds,
            "repeats_its_bits": _digest(*fwd()) == _digest(*fwd())}
        out[f"joint_fwd_device_{name}"] = {"ms": _device_ms(fwd)}
        grads = bwd()
        errors, bounds = {}, {}
        for k, got, ref in zip(("de", "dg", "dW", "db"), grads,
                               fused_joint_bwd_plain(*args, gb, gy)):
            errors[f"{k}_max"], errors[f"{k}_mean"] = cs._rel_errs(got, ref)
            bounds[f"{k}_max"], bounds[f"{k}_mean"] = (bd["grad_max"],
                                                       bd["grad_mean"])
        out[f"joint_bwd_{name}"] = {
            "ms": _time_ms(bwd), "errors": errors, "bounds": bounds,
            "repeats_its_bits": _digest(*grads) == _digest(*bwd())}

        # the pair beside the unfused composition (one training step's work)
        leaves = [t.detach().requires_grad_(True) for t in args[:4]]

        def unfused():
            lb, ly = cs.unfused_joint(*leaves, args[4])
            torch.autograd.grad((lb * gb).sum() + (ly * gy).sum(), leaves)

        def pair():
            fwd()
            bwd()

        out[f"joint_pair_{name}"] = {"ms": _time_ms(pair)}
        out[f"joint_pair_device_{name}"] = {"ms": _device_ms(pair)}
        out[f"unfused_pair_{name}"] = {"ms": _time_ms(unfused)}
        fused_ms, unfused_ms = cs.in_turns(unfused, pair, 5, 5)
        out[f"joint_pair_phase3e_{name}"] = {"ms": fused_ms}
        out[f"unfused_pair_phase3e_{name}"] = {"ms": unfused_ms}
    return out


def beam_worker() -> dict:
    import torch

    import chip_smoke as cs  # phase 3b's inputs and bound
    from pg_asr_tpu_torch.decoding import beam, cuda_beam

    dev = torch.device("cuda", 0)
    lp, fl = cs.beam_inputs(dev)
    K, A, T = cs.BEAM_K, cs.BEAM_A, cs.T
    out = {}
    for M in (6, beam._prune_m(A, K, None)):
        prune = None if M == beam._prune_m(A, K, None) else M

        def run():
            return cuda_beam.ctc_beam_cuda(lp, fl, K=K, M=M, Lmax=T)

        got = run()
        lens, scores, parents, syms = beam._scan_hash(
            lp, fl, K=K, A=A, Lmax=T, blank=0, prune=prune)
        labels, blens, nll = beam._backtrack_batch(parents, syms, lens,
                                                   scores, T)
        same = all(torch.equal(g, w) for g, w in (
            (got.parents, parents), (got.syms, syms), (got.lens, lens),
            (got.labels[:, 0], labels), (got.nb_lens[:, 0], blens)))
        rel = ((got.nll[:, 0] - nll).abs() / nll.abs().clamp(min=1)).max()
        again = run()
        out[f"ctc_beam_M{M}"] = {
            "ms": _time_ms(run), "device_ms": _device_ms(run),
            "errors": {"nll_rel": rel.item(), "differs": float(not same)},
            "bounds": {"nll_rel": cs.BEAM_NLL_REL, "differs": 0.0},
            "repeats_its_bits": _digest(*got) == _digest(*again),
            "digest": _digest(got.parents, got.syms, got.labels)}
    return out


WORKERS = {"lstm": lstm_worker, "flash_bwd": flash_bwd_worker,
           "flash_fwd": flash_fwd_worker, "joint": joint_worker,
           "beam": beam_worker, "bilstm": bilstm_worker}


def _label(mangled: str) -> str | None:
    """kernel[type, template ints] of a mangled name of one of the kernels
    the compile report covers, else None."""
    for name in ("flash_attn_bwd_dkv_kernel", "flash_attn_bwd_dq_kernel",
                 "flash_attn_kernel", "lstm_fwd_cc", "lstm_fwd_bf16",
                 "lstm_bwd_kernel", "lstm_bwd_gemm_mma", "lstm_bwd_gemm",
                 "joint_fwd_kernel", "joint_bwd_kernel",
                 "joint_bwd_chunked_kernel", "joint_bwd_reduce_de",
                 "joint_bwd_reduce_w", "ctc_beam_warp", "ctc_beam_block"):
        if name in mangled:
            dtype = "bfloat16" if "bfloat16" in mangled else "float32"
            ints = re.findall(r"Li(\d+)E", mangled)
            args = ", ".join([dtype, *ints])
            return f"{name.removesuffix('_kernel')}[{args}]"
    return None


# the sources each mode's compile report covers
REPORT_SOURCES = {"lstm": ("lstm_fwd.cu", "lstm_bwd.cu"),
                  "bilstm": ("lstm_fwd.cu", "lstm_bwd.cu"),
                  "flash_bwd": ("flash_attn_bwd.cu",),
                  "flash_fwd": ("flash_attn.cu",),
                  "joint": ("joint_fwd.cu", "joint_bwd.cu"),
                  "beam": ("ctc_beam.cu",)}


def compile_report(root: str, sources) -> dict:
    """Registers, stack frame and spills (`nvcc -Xptxas -v`) and HMMA /
    FFMA counts (`cuobjdump -sass` of the built library) of each kernel of
    root's csrc/<sources>, labelled kernel[type, template ints]."""
    sys.path.insert(0, root)
    from pg_asr_tpu_torch import _build

    nvcc = _build.nvcc_path()
    report: dict = {}
    log = ""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for src in sources:
            proc = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, src + ".o"), os.path.join(_build.CSRC, src)],
                capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                report[f"nvcc_error {src}"] = proc.stderr[-2000:]
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)'?", line)
        if m:
            current = _label(m.group(1))
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
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", _build.build()],
                              capture_output=True, text=True).stdout
        current = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                label = _label(m.group(1))
                current = label if label in report else None
                continue
            if current is not None:
                entry = report[current]
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
        if "digest" in turns[0][1][key]:  # the same bits in both trees
            same = len({t[key]["digest"] for _, t in turns}) == 1
            row["same_bits"] = same
            ok &= same
            line += f"; same bits {same}"
        if "errors" in turns[0][1][key]:  # each tree within the bounds
            bounds = turns[0][1][key]["bounds"]
            errs = {lab: {n: max(t[key]["errors"][n] for l, t in turns
                                 if l == lab) for n in bounds}
                    for lab in ("A", "B")}
            within = all(errs[lab][n] <= b for lab in errs
                         for n, b in bounds.items())
            repeats = all(t[key].get("repeats_its_bits", True)
                          for _, t in turns)
            row.update(errors=errs, bounds=bounds, within_bounds=within,
                       repeats_its_bits=repeats)
            ok &= within and repeats
            line += ("; errors A " + ", ".join(
                f"{n} {e:.2e}" for n, e in errs["A"].items()) + ", B "
                + ", ".join(f"{n} {e:.2e}" for n, e in errs["B"].items())
                + " (bounds " + ", ".join(f"{n} {b:.1e}" for n, b in
                                          bounds.items())
                + f"): within {within}; repeats its bits {repeats}")
        summary[key] = row
        print(line)
    result = {"device": smi, "mode": mode, "kernels": summary, "ok": ok}
    if mode in REPORT_SOURCES:
        result["compile_b"] = compile_report(b_root, REPORT_SOURCES[mode])
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
