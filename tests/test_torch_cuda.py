"""CUDA-only tests of the port's hand-written kernels against their plain
PyTorch versions, on the card. They skip on a host without a GPU.

This file imports neither jax nor the JAX package's device code, so it runs
on a GPU host that has only torch:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
(--noconftest: tests/conftest.py configures JAX.)

Tolerances of the forward: float32 atol 1e-5 (the kernel and the plain
version differ only in the summation order of h@U, ~1e-7 at the slice's
shape); bfloat16 atol 4e-3, one bf16 ulp of an output in [0.5, 1): both
round their output to bf16, and a slightly different f32 sum can round to
the neighbouring value.
Tolerances of the backward (given the same residuals): float32 dxp atol
1e-5, dU atol 1e-5 x max|dU| (sums of B*T terms in another order); bfloat16
dxp atol 2e-2 x max|dxp| and dU atol 2e-2 x max|dU|: dpre is rounded to
bf16 and fed back into the dh carry, so a one-ulp difference at one step
moves the later steps by a few ulps.
"""

import numpy as np
import pytest
import torch

from pg_asr_tpu_torch.config import ModelConfig
from pg_asr_tpu_torch.models import bilstm_ctc
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.ops.lstm import (LSTMScan, lstm_scan,
                                       lstm_scan_bwd_plain, lstm_scan_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py also runs these "
                    "comparisons at the slice's shape)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("reverse", [False, True])
# H=64: one hidden unit per block; H=256 and H=200: two
@pytest.mark.parametrize("B,T,H", [(5, 37, 64), (3, 11, 256), (2, 9, 200)])
def test_lstm_kernel_matches_plain(cuda, B, T, H, reverse, dtype, atol):
    rng = np.random.default_rng(H + T)
    lens = np.clip(rng.integers(1, T + 1, B), 1, T)
    lens[0], lens[-1] = T, 1
    xp = torch.from_numpy(0.5 * rng.standard_normal((B, T, 4 * H)))
    U = torch.from_numpy(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H))
    mask = torch.from_numpy(np.arange(T)[None] < lens[:, None])
    xp, U = xp.to(cuda, dtype), U.to(cuda, dtype)
    mask = mask.to(cuda, torch.float32)
    before = cuda_lstm.LAUNCHES
    got = lstm_scan(xp, U, mask, reverse)
    torch.cuda.synchronize()
    assert cuda_lstm.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (B, T, H)
    ref = lstm_scan_plain(xp, U, mask, reverse)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)
    assert torch.all(got[mask == 0] == 0)


@pytest.mark.cuda
def test_lstm_kernel_rejects_bad_inputs(cuda):
    xp = torch.zeros(2, 3, 64, device=cuda)
    U = torch.zeros(16, 64, device=cuda)
    mask = torch.ones(2, 3, device=cuda)
    with pytest.raises(TypeError):
        cuda_lstm.lstm_scan_cuda(xp.double(), U.double(), mask)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan_cuda(xp, U[:8], mask)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan_cuda(xp.transpose(0, 1), U, mask.T)
    # above 2 hidden units per SM's block: refused, not launched
    H = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count + 2
    before = cuda_lstm.LAUNCHES
    with pytest.raises(RuntimeError, match="hidden size"):
        cuda_lstm.lstm_scan_cuda(torch.zeros(1, 2, 4 * H, device=cuda),
                                 torch.zeros(H, 4 * H, device=cuda),
                                 torch.ones(1, 2, device=cuda))
    assert cuda_lstm.LAUNCHES == before


@pytest.mark.cuda
def test_bilstm_ctc_kernel_matches_plain(cuda):
    """The whole model forward on the card: kernel vs plain recurrence.
    Log-probs atol 1e-3: f32 summation-order differences through two
    BiLSTM layers, the head and the log-softmax."""
    cfg = ModelConfig(vocab_size=12, input_proj_dim=64, hidden_size=32,
                      num_layers=2)
    params = bilstm_ctc.init_params(cfg, torch.Generator().manual_seed(0),
                                    cuda)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((3, 40, 80)).astype(
        np.float32)).to(cuda)
    mask = (torch.arange(40)[None] < torch.tensor([40, 17, 1])[:, None]).to(
        cuda, torch.float32)
    before = cuda_lstm.LAUNCHES
    got = bilstm_ctc.apply(params, feats, mask, cfg)
    assert cuda_lstm.LAUNCHES == before + 2 * cfg.num_layers
    ref = bilstm_ctc.apply(params, feats, mask, cfg, use_kernel=False)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)


def _case(cuda, B, T, H, dtype, seed):
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.integers(1, T + 1, B), 1, T)
    lens[0], lens[-1] = T, 1
    xp = torch.from_numpy(0.5 * rng.standard_normal((B, T, 4 * H)))
    U = torch.from_numpy(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H))
    gy = torch.from_numpy(rng.standard_normal((B, T, H)))
    mask = torch.from_numpy(np.arange(T)[None] < lens[:, None])
    return (xp.to(cuda, dtype), U.to(cuda, dtype),
            mask.to(cuda, torch.float32), gy.to(cuda, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(5, 37, 64), (3, 11, 256), (2, 9, 200)])
def test_lstm_residual_kernel_matches_plain(cuda, B, T, H, reverse, dtype,
                                            atol):
    xp, U, mask, _ = _case(cuda, B, T, H, dtype, H + T)
    before = cuda_lstm.RES_LAUNCHES
    out, hprev, cprev = cuda_lstm.lstm_scan_residual_cuda(xp, U, mask,
                                                          reverse)
    torch.cuda.synchronize()
    assert cuda_lstm.RES_LAUNCHES == before + 1
    assert hprev.dtype == dtype and cprev.dtype == torch.float32
    assert hprev.shape == cprev.shape == (T, B, H)
    # the residual form computes the same out as the inference form
    torch.testing.assert_close(out, cuda_lstm.lstm_scan_cuda(xp, U, mask,
                                                             reverse),
                               rtol=0, atol=0)
    ref = lstm_scan_plain(xp, U, mask, reverse, residuals=True)
    for got, want in zip((out, hprev, cprev), ref):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,H", [(5, 37, 64), (3, 11, 256), (2, 9, 200),
                                   (70, 5, 32)])
def test_lstm_bwd_kernel_matches_plain(cuda, B, T, H, reverse, dtype, rel):
    """Both get the plain forward's residuals, so this holds the backward
    alone. B=70 takes two passes of the block's row loops."""
    xp, U, mask, gy = _case(cuda, B, T, H, dtype, 7 * H + T)
    _, hprev, cprev = lstm_scan_plain(xp, U, mask, reverse, residuals=True)
    before = cuda_lstm.BWD_LAUNCHES
    dxp, dU = cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, hprev, cprev, gy,
                                           reverse)
    torch.cuda.synchronize()
    assert cuda_lstm.BWD_LAUNCHES == before + 1
    assert dxp.dtype == dU.dtype == dtype
    ref_dxp, ref_dU = lstm_scan_bwd_plain(xp, U, mask, hprev, cprev, gy,
                                          reverse)
    dxp_tol = 1e-5 if dtype == torch.float32 else rel * ref_dxp.abs().max()
    torch.testing.assert_close(dxp.float(), ref_dxp.float(), rtol=0,
                               atol=float(dxp_tol))
    torch.testing.assert_close(dU.float(), ref_dU.float(), rtol=0,
                               atol=float(rel * ref_dU.abs().max()))
    assert torch.all(dxp[mask == 0] == 0)


@pytest.mark.cuda
def test_autograd_function_launches_both_kernels(cuda):
    xp, U, mask, gy = _case(cuda, 4, 21, 128, torch.float32, 3)
    xp.requires_grad_(True)
    U.requires_grad_(True)
    counts = (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
              cuda_lstm.BWD_LAUNCHES)
    LSTMScan.apply(xp, U, mask, True, True).backward(gy)
    torch.cuda.synchronize()
    assert (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
            cuda_lstm.BWD_LAUNCHES) == (counts[0], counts[1] + 1,
                                        counts[2] + 1)
    g_k = (xp.grad.clone(), U.grad.clone())
    xp.grad, U.grad = None, None
    LSTMScan.apply(xp, U, mask, True, False).backward(gy)
    torch.testing.assert_close(g_k[0], xp.grad, rtol=0, atol=1e-5)
    torch.testing.assert_close(g_k[1], U.grad, rtol=0,
                               atol=float(1e-5 * U.grad.abs().max()))


@pytest.mark.cuda
def test_train_gradients_kernel_match_plain(cuda):
    """Loss and every parameter gradient of a small BiLSTM-CTC train step on
    the card: kernels + F.ctc_loss vs the plain recurrence + the plain CTC
    recursion. rtol 1e-3 and atol 1e-4 x max|grad|: float32 sums in other
    orders through two layers, the head and two CTC implementations."""
    from pg_asr_tpu_torch.config import Config
    from pg_asr_tpu_torch.train import loss_and_grads

    cfg = Config(model=ModelConfig(vocab_size=12, input_proj_dim=64,
                                   hidden_size=32, num_layers=2, dropout=0.0))
    params = bilstm_ctc.init_params(cfg.model,
                                    torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(2)
    ns = np.array([6400, 3000, 2000])
    wave = (rng.standard_normal((3, 6400)) * 3000 * (np.arange(6400)[None]
                                                     < ns[:, None]))
    labels = rng.integers(1, 12, (3, 8))
    arrays = [torch.from_numpy(a).to(cuda) for a in (
        wave.astype(np.int16), ns.astype(np.int32), labels.astype(np.int32),
        np.array([8, 5, 0], np.int32))]
    before = cuda_lstm.BWD_LAUNCHES
    loss_k, g_k = loss_and_grads(params, arrays, cfg)
    assert cuda_lstm.BWD_LAUNCHES == before + 2 * cfg.model.num_layers
    loss_p, g_p = loss_and_grads(params, arrays, cfg, use_kernel=False)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-4, atol=1e-5)
    for k in g_p:
        torch.testing.assert_close(g_k[k], g_p[k], rtol=1e-3,
                                   atol=float(1e-4 * g_p[k].abs().max()))
