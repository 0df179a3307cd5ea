"""The port's fused-direction BiLSTM (pg_asr_tpu_torch/ops/lstm.py
``bilstm_scan_plain``, ``bilstm_scan_bwd_plain``, ``BiLSTMScan``,
``bilstm_layer(fuse_directions=True)``) vs the JAX package's
``pallas_bilstm_scan`` (its Pallas kernels ``_kernel_bi`` and
``_kernel_bi_bwd`` in interpret mode on the CPU, as
tests/test_pallas_lstm.py runs them) and both branches of its
``bilstm_layer(fuse_directions=True)``: the Pallas one and the XLA scan
over a 2B-stacked batch.

Sizes: B=4, T=12, I=8, H=16, lengths 12, 7, 1, 3 (full, ragged, one step).
Tolerances: float32 rtol 1e-4, atol 1e-5 on outputs and gradients (the same
algorithm in the same precision, summation order of the products only).
bfloat16 (the Pallas kernels' numerics: float32 carries, h and dpre rounded
to bf16 before the products): outputs atol 2e-2, a few bf16 ulps of O(1)
values, as tests/test_torch_lstm.py's; gradients atol 2e-2 x max|grad|
(dpre rounded to bf16 is fed back into the dh carry, so a one-ulp split at
one step moves later steps by a few ulps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.ops.lstm import bilstm_layer as jax_bilstm_layer
from pg_asr_tpu.ops.pallas_lstm import pallas_bilstm_scan
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.ops.lstm import (BiLSTMScan, bilstm_layer, bilstm_scan,
                                       bilstm_scan_bwd_plain,
                                       bilstm_scan_plain)

INTERPRET = jax.default_backend() != "tpu"
B, T, I, H = 4, 12, 8, 16
LENS = np.array([12, 7, 1, 3])
MASK = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed):
    rng = np.random.default_rng(seed)
    xpf, xpb = (0.5 * rng.standard_normal((2, B, T, 4 * H))).astype(
        np.float32)
    Uf, Ub = (rng.uniform(-1, 1, (2, H, 4 * H)) / np.sqrt(H)).astype(
        np.float32)
    gy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    return xpf, xpb, Uf, Ub, gy


def _pallas_value_and_grads(xpf, xpb, Uf, Ub, gy, dtype):
    def f(*args):
        y = pallas_bilstm_scan(*args, jnp.asarray(MASK), INTERPRET)
        return jnp.sum(y.astype(jnp.float32) * gy), y

    args = [jnp.asarray(a, dtype) for a in (xpf, xpb, Uf, Ub)]
    (_, y), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                       has_aux=True)(*args)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, *grads)]


def _port_value_and_grads(xpf, xpb, Uf, Ub, gy, dtype):
    args = [torch.from_numpy(a).to(dtype).requires_grad_(True)
            for a in (xpf, xpb, Uf, Ub)]
    y = BiLSTMScan.apply(*args, torch.from_numpy(MASK), True)
    y.backward(torch.from_numpy(gy).to(dtype))
    assert y.dtype == dtype and all(a.grad.dtype == dtype for a in args)
    return [t.detach().float().numpy() for t in (y, *(a.grad for a in args))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_scan_and_grads_match_pallas(dtype):
    """Output y (B, T, 2H) and dxpf, dxpb, dUf, dUb of BiLSTMScan (on the
    CPU: bilstm_scan_plain's residual form and bilstm_scan_bwd_plain) vs
    pallas_bilstm_scan and its custom VJP."""
    inputs = _scan_inputs(0)
    ref = _pallas_value_and_grads(*inputs, jnp.dtype(dtype))
    got = _port_value_and_grads(*inputs, getattr(torch, dtype))
    for name, g, r in zip(("y", "dxpf", "dxpb", "dUf", "dUb"), got, ref):
        if dtype == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            tol = 2e-2 if name == "y" else 2e-2 * np.abs(r).max()
            np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)
    assert np.all(got[0][MASK == 0] == 0.0)  # padded steps emit zeros


def test_plain_forward_residuals_and_backward_walk():
    """The residual form's carries are the inference form's h, c before each
    step; the backward of a cotangent on one direction leaves the other
    direction's gradients at zero."""
    xpf, xpb, Uf, Ub, gy = (torch.from_numpy(a) for a in _scan_inputs(1))
    mask = torch.from_numpy(MASK)
    y, hpf, cpf, hpb, cpb = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask,
                                              residuals=True)
    torch.testing.assert_close(y, bilstm_scan_plain(xpf, xpb, Uf, Ub, mask),
                               rtol=0, atol=0)
    assert hpf.shape == cpb.shape == (T, B, H) and cpf.dtype == torch.float32
    # the first step's carry is zero in each direction: time 0 forward,
    # time T-1 backward
    assert torch.all(hpf[0] == 0) and torch.all(hpb[T - 1] == 0)
    # a frozen carry at padded steps: row 2 (length 1) keeps its step-0
    # state forward, and its backward walk starts from zero at time 0
    torch.testing.assert_close(hpf[5, 2], hpf[1, 2], rtol=0, atol=0)
    assert torch.all(hpb[0, 2] == 0)
    g_f = gy.clone()
    g_f[..., H:] = 0
    dxpf, dxpb, dUf, dUb = bilstm_scan_bwd_plain(xpf, xpb, Uf, Ub, mask,
                                                 hpf, cpf, hpb, cpb, g_f)
    assert torch.all(dxpb == 0) and torch.all(dUb == 0)
    assert dxpf.abs().max() > 0 and torch.all(dxpf[mask == 0] == 0)


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    params = {d: {"W": (rng.uniform(-1, 1, (I, 4 * H)) / 4).astype(np.float32),
                  "U": (rng.uniform(-1, 1, (H, 4 * H)) / 4).astype(np.float32),
                  "b": rng.standard_normal(4 * H).astype(np.float32)}
              for d in ("fwd", "bwd")}
    gy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    return x, params, gy


def _jax_layer_grads(x, params, gy, use_pallas):
    def f(p, x):
        y = jax_bilstm_layer(p, x, jnp.asarray(MASK), use_pallas=use_pallas,
                             fuse_directions=True, interpret=INTERPRET)
        return jnp.sum(y * gy), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return [np.asarray(y), np.asarray(gx)] + [
        np.asarray(gp[d][k]) for d in ("fwd", "bwd") for k in ("W", "U", "b")]


def _port_layer_grads(x, params, gy, fuse):
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {d: {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()} for d, p in params.items()}
    y = bilstm_layer(tp, tx, torch.from_numpy(MASK), fuse_directions=fuse)
    y.backward(torch.from_numpy(gy))
    return [y.detach().numpy(), tx.grad.numpy()] + [
        tp[d][k].grad.numpy() for d in ("fwd", "bwd") for k in ("W", "U", "b")]


@pytest.mark.parametrize("use_pallas", [True, False])
def test_bilstm_layer_fused_matches_jax_branches(use_pallas):
    """The port's fused layer vs JAX's fused layer on its Pallas branch
    (pallas_bilstm_scan in interpret mode) and on its XLA branch (one scan
    over the 2B-stacked, time-flipped batch): output and the gradients of
    x, W, U and b of both directions, float32."""
    x, params, gy = _layer_inputs(2)
    ref = _jax_layer_grads(x, params, gy, use_pallas)
    got = _port_layer_grads(x, params, gy, fuse=True)
    assert got[0].shape == (B, T, 2 * H)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=i)


def test_bilstm_layer_fused_matches_unfused():
    """Fused and unfused layers, float32 on the CPU: each direction of the
    fused plain versions runs the single-direction step code, so output and
    gradients agree to float32 rounding of the summed x-gradient."""
    x, params, gy = _layer_inputs(3)
    fused = _port_layer_grads(x, params, gy, fuse=True)
    unfused = _port_layer_grads(x, params, gy, fuse=False)
    for i, (a, b) in enumerate(zip(fused, unfused)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=i)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    """On CPU tensors the fused layer runs the plain versions and launches
    nothing, in the inference form and under autograd; the kernel entry
    points refuse CPU tensors instead of falling back."""
    xpf, xpb, Uf, Ub, gy = (torch.from_numpy(a) for a in _scan_inputs(4))
    mask = torch.from_numpy(MASK)
    counts = (cuda_lstm.BI_LAUNCHES, cuda_lstm.BI_RES_LAUNCHES,
              cuda_lstm.BI_BWD_LAUNCHES, cuda_lstm.LAUNCHES,
              cuda_lstm.RES_LAUNCHES, cuda_lstm.BWD_LAUNCHES)
    got = bilstm_scan(xpf, xpb, Uf, Ub, mask)
    torch.testing.assert_close(got, bilstm_scan_plain(xpf, xpb, Uf, Ub, mask),
                               rtol=0, atol=0)
    x, params, g = _layer_inputs(5)
    _port_layer_grads(x, params, g, fuse=True)
    assert (cuda_lstm.BI_LAUNCHES, cuda_lstm.BI_RES_LAUNCHES,
            cuda_lstm.BI_BWD_LAUNCHES, cuda_lstm.LAUNCHES,
            cuda_lstm.RES_LAUNCHES, cuda_lstm.BWD_LAUNCHES) == counts
    _, *res = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask, residuals=True)
    for launch, args in (
            (cuda_lstm.bilstm_scan_cuda, (xpf, xpb, Uf, Ub, mask)),
            (cuda_lstm.bilstm_scan_residual_cuda, (xpf, xpb, Uf, Ub, mask)),
            (cuda_lstm.bilstm_scan_bwd_cuda,
             (xpf, xpb, Uf, Ub, mask, *res, gy))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(*args)
