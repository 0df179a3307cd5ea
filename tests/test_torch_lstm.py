"""Port's LSTM recurrence (pg_asr_tpu_torch/ops/lstm.py, ops/cuda_lstm.py)
vs the JAX package's Pallas kernel (interpret mode on CPU, as
tests/test_pallas_lstm.py runs it) and its lax.scan reference.

Tolerances (float32): rtol 1e-4, atol 1e-5 — the same algorithm in the same
precision, differing only in summation order of the h@U product.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.ops.lstm import bilstm_layer as jax_bilstm_layer
from pg_asr_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from pg_asr_tpu.ops.pallas_lstm import pallas_lstm_scan
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.ops.lstm import (bilstm_layer, lstm_scan,
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
LENS = np.array([12, 7, 1, 3])  # ragged, including length 1 and full T


def _inputs(seed, B=4, T=12, H=16):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((B, T, 4 * H))).astype(np.float32)
    U = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    mask = (np.arange(T)[None] < LENS[:B, None]).astype(np.float32)
    return xp, U, mask


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_and_scan(reverse):
    xp, U, mask = _inputs(0)
    got = lstm_scan_plain(torch.from_numpy(xp), torch.from_numpy(U),
                          torch.from_numpy(mask), reverse).numpy()
    pallas = pallas_lstm_scan(jnp.asarray(xp), jnp.asarray(U),
                              jnp.asarray(mask), reverse, INTERPRET)
    scan = jax_lstm_scan(jnp.asarray(xp), jnp.asarray(U), jnp.asarray(mask),
                         U.shape[0], reverse=reverse)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(scan), rtol=1e-4, atol=1e-5)
    # padded steps emit exact zeros
    assert np.all(got[mask == 0] == 0.0)


def test_plain_bf16_matches_pallas_bf16():
    """bf16 inputs: f32 carries, h rounded to bf16 before the product, output
    in bf16 — the Pallas kernel's numerics. Tolerance 2e-2 (a few bf16 ulps
    of O(1) outputs, from rounding at different points of the sum)."""
    xp, U, mask = _inputs(1)
    xp_b = torch.from_numpy(xp).to(torch.bfloat16)
    U_b = torch.from_numpy(U).to(torch.bfloat16)
    got = lstm_scan_plain(xp_b, U_b, torch.from_numpy(mask), False)
    assert got.dtype == torch.bfloat16
    ref = pallas_lstm_scan(jnp.asarray(xp_b.float().numpy(), jnp.bfloat16),
                           jnp.asarray(U_b.float().numpy(), jnp.bfloat16),
                           jnp.asarray(mask), False, INTERPRET)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_bilstm_layer_matches_jax():
    rng = np.random.default_rng(2)
    B, T, I, H = 4, 12, 8, 16
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    mask = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)
    params = {d: {"W": (rng.uniform(-1, 1, (I, 4 * H)) / 4).astype(np.float32),
                  "U": (rng.uniform(-1, 1, (H, 4 * H)) / 4).astype(np.float32),
                  "b": rng.standard_normal(4 * H).astype(np.float32)}
              for d in ("fwd", "bwd")}
    ref = jax_bilstm_layer(jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(x), jnp.asarray(mask))
    tparams = {d: {k: torch.from_numpy(v) for k, v in p.items()}
               for d, p in params.items()}
    got = bilstm_layer(tparams, torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    # fuse_directions: both directions in one walk, the same function
    ref = jax_bilstm_layer(jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(x), jnp.asarray(mask),
                           fuse_directions=True)
    fused = bilstm_layer(tparams, torch.from_numpy(x), torch.from_numpy(mask),
                         fuse_directions=True)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(fused, got, rtol=0, atol=0)


def test_bilstm_layer_above_512_units_matches_pallas():
    """H = 520, past the CUDA kernels' limit of 512: the port's layer (the
    plain recurrence on CPU tensors) against pallas_lstm_scan in interpret
    mode, one direction each way, on x @ W + b; rtol 1e-4, atol 1e-5."""
    rng = np.random.default_rng(520)
    B, T, I, H = 2, 5, 8, 520
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([T, 2])[:, None]).astype(np.float32)
    params = {d: {"W": (rng.uniform(-1, 1, (I, 4 * H)) / 4).astype(np.float32),
                  "U": (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(
                      np.float32),
                  "b": rng.standard_normal(4 * H).astype(np.float32)}
              for d in ("fwd", "bwd")}
    ref = [pallas_lstm_scan(jnp.asarray(x @ p["W"] + p["b"]),
                            jnp.asarray(p["U"]), jnp.asarray(mask), reverse,
                            INTERPRET)
           for p, reverse in ((params["fwd"], False), (params["bwd"], True))]
    tparams = {d: {k: torch.from_numpy(v) for k, v in p.items()}
               for d, p in params.items()}
    got = bilstm_layer(tparams, torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), np.concatenate(
        [np.asarray(r) for r in ref], -1), rtol=1e-4, atol=1e-5)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    """On CPU tensors lstm_scan is the plain version and launches nothing;
    the kernel entry point refuses CPU tensors instead of falling back."""
    xp, U, mask = _inputs(3)
    args = (torch.from_numpy(xp), torch.from_numpy(U), torch.from_numpy(mask))
    before = cuda_lstm.LAUNCHES
    got = lstm_scan(*args, reverse=True)
    assert cuda_lstm.LAUNCHES == before
    torch.testing.assert_close(got, lstm_scan_plain(*args, reverse=True),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_scan_cuda(*args)
