"""CUDA-only tests of the port's hand-written kernels against their plain
PyTorch versions, on the card. They skip on a host without a GPU.

This file imports neither jax nor the JAX package's device code, so it runs
on a GPU host that has only torch:
    python -m pytest tests/test_torch_cuda.py --noconftest -q
(--noconftest: tests/conftest.py configures JAX.)

Tolerances: float32 atol 1e-5 (the kernel and the plain version differ only
in the summation order of h@U, ~1e-7 at the slice's shape); bfloat16 atol
4e-3, one bf16 ulp of an output in [0.5, 1): both round their output to bf16,
and a slightly different f32 sum can round to the neighbouring value.
"""

import numpy as np
import pytest
import torch

from pg_asr_tpu_torch.config import ModelConfig
from pg_asr_tpu_torch.models import bilstm_ctc
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.ops.lstm import lstm_scan_plain


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
    got = cuda_lstm.lstm_scan(xp, U, mask, reverse)
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
        cuda_lstm.lstm_scan(xp.double(), U.double(), mask)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp, U[:8], mask)
    with pytest.raises(ValueError):
        cuda_lstm.lstm_scan(xp.transpose(0, 1), U, mask.T)
    # above 2 hidden units per SM's block: refused, not launched
    H = 2 * torch.cuda.get_device_properties(cuda).multi_processor_count + 2
    before = cuda_lstm.LAUNCHES
    with pytest.raises(RuntimeError, match="hidden size"):
        cuda_lstm.lstm_scan(torch.zeros(1, 2, 4 * H, device=cuda),
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
