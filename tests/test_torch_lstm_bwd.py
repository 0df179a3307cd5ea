"""The port's LSTM residual forward, backward and autograd Function
(pg_asr_tpu_torch/ops/lstm.py) vs the JAX package's Pallas kernels in
interpret mode (as tests/test_pallas_lstm.py runs them on the CPU):
``_pallas_forward_train``, ``_pallas_backward`` and ``jax.vjp`` of
``pallas_lstm_scan``.

Tolerances: float32 rtol 1e-4, atol 1e-5 (the same algorithm in the same
precision; only the summation order of the products differs). bfloat16:
outputs and dxp atol 2e-2, a few bf16 ulps of O(1) values from rounding at
different points of a sum; dU atol 2e-2 x max|dU|, since dU is a float32
sum of B*T rounded products and one bf16 ulp of its largest entry is
2^-8 of it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.ops.pallas_lstm import (_pallas_backward,
                                        _pallas_forward_train,
                                        pallas_lstm_scan)
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.ops.lstm import (LSTMScan, lstm_scan_bwd_plain,
                                       lstm_scan_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards: importing this module changes no
    process-wide state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

INTERPRET = jax.default_backend() != "tpu"
B, T, H = 3, 10, 8
LENS = np.array([T, 1, 6])  # full length, length 1 and a middle length


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32)
    U = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)
    gy = rng.standard_normal((B, T, H)).astype(np.float32)
    return xp, U, mask, gy


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_residual_forward_matches_pallas(reverse):
    xp, U, mask, _ = _inputs(0)
    out, hprev, cprev = lstm_scan_plain(_t(xp), _t(U), _t(mask), reverse,
                                        residuals=True)
    r_out, r_h, r_c = _pallas_forward_train(jnp.asarray(xp), jnp.asarray(U),
                                            jnp.asarray(mask), reverse,
                                            INTERPRET)
    assert hprev.shape == cprev.shape == (T, B, H)
    assert hprev.dtype == torch.float32 and cprev.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _f32(r_out), rtol=1e-4, atol=1e-5)
    # JAX pads the residuals to a chunk multiple of time; the port does not
    np.testing.assert_allclose(hprev.numpy(), _f32(r_h)[:T], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(cprev.numpy(), _f32(r_c)[:T], rtol=1e-4,
                               atol=1e-5)
    # the inference form is the residual form's first output
    torch.testing.assert_close(lstm_scan_plain(_t(xp), _t(U), _t(mask),
                                               reverse), out, rtol=0, atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_backward_plain_matches_pallas(reverse):
    """Both sides get the JAX forward's residuals, so this holds the
    backward alone against _kernel_bwd."""
    xp, U, mask, gy = _inputs(1)
    _, r_h, r_c = _pallas_forward_train(jnp.asarray(xp), jnp.asarray(U),
                                        jnp.asarray(mask), reverse, INTERPRET)
    r_dxp, r_dU = _pallas_backward(jnp.asarray(xp), jnp.asarray(U),
                                   jnp.asarray(mask), r_h, r_c,
                                   jnp.asarray(gy), reverse, INTERPRET)
    dxp, dU = lstm_scan_bwd_plain(_t(xp), _t(U), _t(mask), _t(_f32(r_h)[:T]),
                                  _t(_f32(r_c)[:T]), _t(gy), reverse)
    assert dxp.shape == (B, T, 4 * H) and dU.shape == (H, 4 * H)
    np.testing.assert_allclose(dxp.numpy(), _f32(r_dxp), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dU.numpy(), _f32(r_dU), rtol=1e-4, atol=1e-5)
    # padded steps get no gradient
    assert np.all(dxp.numpy()[mask == 0] == 0.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_autograd_function_matches_jax_vjp(reverse):
    xp, U, mask, gy = _inputs(2)
    out_j, vjp = jax.vjp(
        lambda a, u: pallas_lstm_scan(a, u, jnp.asarray(mask), reverse,
                                      INTERPRET),
        jnp.asarray(xp), jnp.asarray(U))
    r_dxp, r_dU = vjp(jnp.asarray(gy))

    xp_t = _t(xp).requires_grad_(True)
    U_t = _t(U).requires_grad_(True)
    before = (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
              cuda_lstm.BWD_LAUNCHES)
    out = LSTMScan.apply(xp_t, U_t, _t(mask), reverse, True)
    out.backward(_t(gy))
    # CPU tensors: the wrappers ran the plain versions and launched nothing
    assert (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
            cuda_lstm.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out.detach().numpy(), _f32(out_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(xp_t.grad.numpy(), _f32(r_dxp), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(U_t.grad.numpy(), _f32(r_dU), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_matches_pallas_bf16(reverse):
    xp, U, mask, gy = _inputs(3)
    bf = jnp.bfloat16
    xp_b, U_b, gy_b = (_t(a, torch.bfloat16) for a in (xp, U, gy))
    jx, ju, jg = (jnp.asarray(a.float().numpy(), bf) for a in (xp_b, U_b, gy_b))
    r_out, r_h, r_c = _pallas_forward_train(jx, ju, jnp.asarray(mask),
                                            reverse, INTERPRET)
    out, hprev, cprev = lstm_scan_plain(xp_b, U_b, _t(mask), reverse,
                                        residuals=True)
    assert out.dtype == hprev.dtype == torch.bfloat16
    assert cprev.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), _f32(r_out), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(hprev.float().numpy(), _f32(r_h)[:T], rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(cprev.numpy(), _f32(r_c)[:T], rtol=0,
                               atol=2e-2)

    r_dxp, r_dU = _pallas_backward(jx, ju, jnp.asarray(mask), r_h, r_c, jg,
                                   reverse, INTERPRET)
    dxp, dU = lstm_scan_bwd_plain(
        xp_b, U_b, _t(mask), _t(_f32(r_h)[:T], torch.bfloat16),
        _t(_f32(r_c)[:T]), gy_b, reverse)
    assert dxp.dtype == dU.dtype == torch.bfloat16
    np.testing.assert_allclose(dxp.float().numpy(), _f32(r_dxp), rtol=0,
                               atol=2e-2)
    ref_dU = _f32(r_dU)
    np.testing.assert_allclose(dU.float().numpy(), ref_dU, rtol=0,
                               atol=2e-2 * np.abs(ref_dU).max())


def test_bwd_wrappers_take_plain_versions_for_cpu_tensors():
    """On CPU tensors LSTMScan's residual forward and backward are the plain
    versions and launch nothing; the kernel launchers refuse CPU tensors
    instead of falling back."""
    xp, U, mask, gy = (_t(a) for a in _inputs(4))
    before = (cuda_lstm.RES_LAUNCHES, cuda_lstm.BWD_LAUNCHES)
    xp_g, U_g = xp.clone().requires_grad_(True), U.clone().requires_grad_(True)
    LSTMScan.apply(xp_g, U_g, mask, True, True).backward(gy)
    assert (cuda_lstm.RES_LAUNCHES, cuda_lstm.BWD_LAUNCHES) == before
    _, hprev, cprev = lstm_scan_plain(xp, U, mask, True, residuals=True)
    ref = lstm_scan_bwd_plain(xp, U, mask, hprev, cprev, gy, True)
    torch.testing.assert_close(xp_g.grad, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(U_g.grad, ref[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_scan_residual_cuda(xp, U, mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, hprev, cprev, gy)


def test_inference_keeps_the_form_without_residuals(monkeypatch):
    """Under torch.no_grad (and for inputs that need no gradient) the layer
    runs the inference form; under autograd it runs LSTMScan."""
    from pg_asr_tpu_torch.ops import lstm as lstm_mod

    calls = []
    real = lstm_mod.lstm_scan_plain

    def spy(*a, residuals=False, **k):
        calls.append(residuals)
        return real(*a, residuals=residuals, **k)

    monkeypatch.setattr(lstm_mod, "lstm_scan_plain", spy)
    rng = np.random.default_rng(5)
    params = {"W": _t(rng.standard_normal((6, 4 * H)) / 4).requires_grad_(),
              "U": _t(rng.standard_normal((H, 4 * H)) / 4).requires_grad_(),
              "b": _t(np.zeros(4 * H)).requires_grad_()}
    x = _t(rng.standard_normal((B, T, 6)))
    mask = _t(np.ones((B, T)))
    with torch.no_grad():
        y0 = lstm_mod.lstm_layer(params, x, mask)
    assert calls == [False] and not y0.requires_grad
    y1 = lstm_mod.lstm_layer(params, x, mask)
    assert calls == [False, True] and y1.requires_grad
    torch.testing.assert_close(y0, y1.detach(), rtol=0, atol=0)


def _bwd_in_cluster_order(xp, U, mask, hprev, cprev, gy, reverse, cs,
                          splits):
    """The backward with csrc/lstm_bwd.cu's summation orders, float32: the
    H units split over ``cs`` blocks (H // cs or one more each, in order)
    and each block's units in two halves, each half's partial dh =
    dpre_mx[:, its gate columns] @ U[:, those]^T, the partials added in
    block order, halves in order within a block; dU after the walk as
    ``splits`` partial products hprev^T @ dxp over consecutive ranges of
    the (t, b) pairs (t-major), added in order -> (dxp, dU), float32."""
    B, T, H4 = xp.shape
    H = H4 // 4
    cols, u0 = [], 0
    for q in range(cs):
        nj = H // cs + (q < H % cs)
        for lo, hi in ((0, nj // 2), (nj // 2, nj)):
            cols.append(torch.cat([torch.arange(u0 + lo, u0 + hi) + g * H
                                   for g in range(4)]))
        u0 += nj
    U32 = U.float()
    dh = torch.zeros(B, H)
    dc = torch.zeros(B, H)
    dxp = torch.empty(B, T, H4)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hp, cp, m = hprev[t].float(), cprev[t].float(), mask[:, t, None]
        pre = xp[:, t].float() + hp @ U32
        i, f = torch.sigmoid(pre[:, :H]), torch.sigmoid(pre[:, H:2 * H])
        g, o = torch.tanh(pre[:, 2 * H:3 * H]), torch.sigmoid(pre[:, 3 * H:])
        th = torch.tanh(f * cp + i * g)
        dhn = m * (dh + gy[:, t].float())
        dct = m * dc + dhn * o * (1.0 - th * th)
        dpre = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                          dct * i * (1.0 - g * g),
                          dhn * th * o * (1.0 - o)], dim=1)
        dxp[:, t] = dpre
        partial = torch.zeros(B, H)
        for c in cols:
            partial = partial + dpre[:, c] @ U32[:, c].T
        dh = (1.0 - m) * dh + partial
        dc = (1.0 - m) * dc + dct * f
    # pair k = t B + b: hprev's rows in order, dxp's transposed to match
    hk = hprev.float().reshape(T * B, H)
    dk = dxp.transpose(0, 1).reshape(T * B, H4)
    per = -(-T * B // splits)
    du = torch.zeros(H, H4)
    for z in range(splits):
        rows = slice(z * per, (z + 1) * per)
        du = du + hk[rows].T @ dk[rows]
    return dxp, du


@pytest.mark.parametrize("reverse", [False, True])
# clusters of 8 and 16 blocks (H = 20 makes both unit splits ragged), dU in
# 3 and 5 ranges of the 132 (t, b) pairs
@pytest.mark.parametrize("cs,splits", [(8, 3), (16, 5)])
def test_backward_in_the_cluster_kernels_order(reverse, cs, splits):
    """The summation orders of csrc/lstm_bwd.cu (dh as per-half-block
    partial sums over gate-column slices, dU as partial products over
    ranges of the (t, b) pairs added in order) stay within 1e-5 x max|ref|
    of the plain backward and of _pallas_backward in interpret mode: the
    card test's float32 bound covers the reordering."""
    Bc, Tc, Hc = 11, 12, 20
    rng = np.random.default_rng(40 + cs)
    lens = np.array([Tc, 1, *rng.integers(1, Tc + 1, Bc - 2)])
    xp = (0.5 * rng.standard_normal((Bc, Tc, 4 * Hc))).astype(np.float32)
    U = (rng.uniform(-1, 1, (Hc, 4 * Hc)) / np.sqrt(Hc)).astype(np.float32)
    mask = (np.arange(Tc)[None] < lens[:, None]).astype(np.float32)
    gy = rng.standard_normal((Bc, Tc, Hc)).astype(np.float32)
    _, r_h, r_c = _pallas_forward_train(jnp.asarray(xp), jnp.asarray(U),
                                        jnp.asarray(mask), reverse, INTERPRET)
    r_dxp, r_dU = _pallas_backward(jnp.asarray(xp), jnp.asarray(U),
                                   jnp.asarray(mask), r_h, r_c,
                                   jnp.asarray(gy), reverse, INTERPRET)
    hprev, cprev = _t(_f32(r_h)[:Tc]), _t(_f32(r_c)[:Tc])
    got = _bwd_in_cluster_order(_t(xp), _t(U), _t(mask), hprev, cprev,
                                _t(gy), reverse, cs, splits)
    plain = lstm_scan_bwd_plain(_t(xp), _t(U), _t(mask), hprev, cprev,
                                _t(gy), reverse)
    for name, g, p, r in zip(("dxp", "dU"), got, plain,
                             (_f32(r_dxp), _f32(r_dU))):
        atol = 1e-5 * np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{name} vs the plain backward")
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol,
                                   err_msg=f"{name} vs _pallas_backward")
    assert np.all(got[0].numpy()[mask == 0] == 0.0)
