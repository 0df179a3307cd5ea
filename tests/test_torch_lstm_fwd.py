"""The summation order of the port's LSTM forward kernel
(pg_asr_tpu_torch/csrc/lstm_fwd.cu, thread-block clusters) vs the JAX
package's Pallas forward in interpret mode (``_pallas_forward`` and
``_pallas_forward_train``, as tests/test_pallas_lstm.py runs them on the
CPU) and the port's plain version, on the same seeded numpy inputs.

A plain function walks the recurrence the way the kernel partitions it:
the batch in clusters of ``rows`` rows (the last one ragged), each walked
on its own; the H units over the CS blocks of a cluster (H // CS or one
more each); the gate sums h @ U in the kernel's order. float32: k in
``256 // njmax`` slices of ``ceil(H / slices)`` units (njmax, the most
units a block has, sets how many threads share a unit's columns), each
slice's product formed alone and the slices added in order, then xp.
bfloat16: h rounded to bf16 (the Pallas body's ``h.astype(U.dtype)``), the
product in k-steps of 16 (mma.sync m16n8k16), the even and the odd k-steps
of each warp's range of 8 k-steps summed apart, then added (even + odd),
the ranges added in order, then xp.

Tolerances: float32 rtol 1e-4, atol 1e-5 against Pallas (as
tests/test_torch_lstm.py: the same algorithm in the same precision, only
the order of the sums differs) and atol 1e-5 against the plain version
(the card's bound). bfloat16: atol 2e-2 against Pallas (a few bf16 ulps of
O(1) values, as tests/test_torch_lstm_bwd.py) and 4e-3 against the plain
version (the card's bound: one bf16 ulp of a value in [0.5, 1), where an
output rounded from a slightly different float32 sum may land).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.ops.pallas_lstm import _pallas_forward, _pallas_forward_train
from pg_asr_tpu_torch.ops.lstm import lstm_scan_plain


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INTERPRET = jax.default_backend() != "tpu"
F32_THREADS = 256  # csrc/lstm_fwd.cu kF32Threads
K_STEP, WARP_K_STEPS = 16, 8  # mma.sync's k; k-steps a bf16 warp holds


def _gate_sums(h, U32, cs, bf16):
    """h (R, H) float32 -> h @ U (R, 4H) in lstm_fwd.cu's order."""
    H = U32.shape[0]
    if not bf16:
        njmax = -(-H // cs)
        slices = F32_THREADS // njmax
        kl = -(-H // slices)
        total = torch.zeros(h.shape[0], 4 * H)
        for pk in range(slices):
            lo, hi = min(H, pk * kl), min(H, pk * kl + kl)
            if lo < hi:
                total = total + h[:, lo:hi] @ U32[lo:hi]
        return total
    h = h.to(torch.bfloat16).float()
    steps = [slice(k, min(H, k + K_STEP)) for k in range(0, H, K_STEP)]
    total = torch.zeros(h.shape[0], 4 * H)
    for k0 in range(0, len(steps), WARP_K_STEPS):
        chains = [torch.zeros(h.shape[0], 4 * H) for _ in range(2)]
        for i, k in enumerate(steps[k0:k0 + WARP_K_STEPS]):
            chains[i % 2] = chains[i % 2] + h[:, k] @ U32[k]
        total = total + (chains[0] + chains[1])
    return total


def _fwd_in_cluster_order(xp, U, mask, reverse, cs, rows):
    """lstm_scan_plain(residuals=True) with the kernel's partition ->
    (out (B, T, H), hprev, cprev (T, B, H)); out and hprev in xp's type."""
    B, T, H4 = xp.shape
    H = H4 // 4
    bf16 = xp.dtype == torch.bfloat16
    U32 = U.float()
    out = torch.empty(B, T, H, dtype=xp.dtype)
    hprev = torch.empty(T, B, H, dtype=xp.dtype)
    cprev = torch.empty(T, B, H)
    for b0 in range(0, B, rows):  # clusters never meet
        rs = slice(b0, min(B, b0 + rows))
        h = torch.zeros(rs.stop - b0, H)
        c = torch.zeros_like(h)
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            hprev[t, rs], cprev[t, rs] = h.to(xp.dtype), c
            pre = xp[rs, t].float() + _gate_sums(h, U32, cs, bf16)
            i, f = torch.sigmoid(pre[:, :H]), torch.sigmoid(pre[:, H:2 * H])
            g, o = torch.tanh(pre[:, 2 * H:3 * H]), torch.sigmoid(pre[:, 3 * H:])
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            m = mask[rs, t, None]
            out[rs, t] = (h_new * m).to(xp.dtype)
            h = torch.where(m > 0, h_new, h)
            c = torch.where(m > 0, c_new, c)
    return out, hprev, cprev


def _inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    lens = np.array([T, 1, *rng.integers(1, T + 1, B - 2)])
    xp = (0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32)
    U = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return xp, U, mask


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


TOLS = {"float32": {"pallas": (1e-4, 1e-5), "plain": (0.0, 1e-5)},
        "bfloat16": {"pallas": (0.0, 2e-2), "plain": (0.0, 4e-3)}}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# H = 20: ragged units over clusters of 8 and 16 blocks (3 / 2 and 2 / 1
# units a block), 2 k-steps; H = 272: 17 k-steps, so three bf16 warps take
# 8, 8 and 1, and 15 float32 slices of 19 units at 16 blocks; rows per
# cluster 3 and 5 of 11 (the last cluster ragged: 2 and 1 rows)
@pytest.mark.parametrize("H,cs,rows", [(20, 8, 3), (20, 16, 5),
                                       (272, 16, 5)])
def test_forward_in_the_cluster_kernels_order(H, cs, rows, dtype, reverse):
    """The kernel's order stays within the stated tolerances of
    _pallas_forward (inference form) and _pallas_forward_train (out, hprev,
    cprev) in interpret mode and of the plain version, with exact zeros at
    padded steps."""
    B, T = 11, 9 if H > 64 else 12
    xp, U, mask = _inputs(50 + H + cs, B, T, H)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xp_t, U_t = torch.from_numpy(xp).to(tdt), torch.from_numpy(U).to(tdt)
    mask_t = torch.from_numpy(mask)
    got = _fwd_in_cluster_order(xp_t, U_t, mask_t, reverse, cs, rows)
    plain = lstm_scan_plain(xp_t, U_t, mask_t, reverse, residuals=True)
    xp_j, U_j = jnp.asarray(xp, jdt), jnp.asarray(U, jdt)
    r_inf = _pallas_forward(xp_j, U_j, jnp.asarray(mask), reverse, INTERPRET)
    r_out, r_h, r_c = _pallas_forward_train(xp_j, U_j, jnp.asarray(mask),
                                            reverse, INTERPRET)
    pallas = (_f32(r_out), _f32(r_h)[:T], _f32(r_c)[:T])
    np.testing.assert_array_equal(_f32(r_inf), pallas[0])
    tol = TOLS[dtype]
    for name, g, p, r in zip(("out", "hprev", "cprev"), got, plain, pallas):
        assert g.dtype == p.dtype, name
        g = g.float().numpy()
        np.testing.assert_allclose(g, r, *tol["pallas"],
                                   err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(g, p.float().numpy(), *tol["plain"],
                                   err_msg=f"{name} vs the plain version")
    assert np.all(got[0].float().numpy()[mask == 0] == 0.0)
