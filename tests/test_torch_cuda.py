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
Tolerances of the fused RNN-T joint (kernel vs plain version, float32 math
in both whatever the inputs' type): the emission tables atol 2e-5 (sums of
J products in another order, then a log-sum-exp); the gradients atol
2e-5 x max|grad| in float32 (sums over up to B*T*(U+1) cells in another
order), 2^-7 x max|grad| in bfloat16 (each is a float32 sum rounded once
to bf16, so the two may round one ulp apart).
The fused-direction kernels (bilstm_fwd, bilstm_bwd) hold the
single-direction tolerances against their plain versions, and each
direction equals a single-direction launch bit for bit (the same partial
sums in the same order; see csrc/bilstm_fwd.cu).
"""

import numpy as np
import pytest
import torch

from pg_asr_tpu_torch.config import ModelConfig
from pg_asr_tpu_torch.decoding import beam, cuda_beam
from pg_asr_tpu_torch.models import bilstm_ctc
from pg_asr_tpu_torch.ops import (cuda_flash_attn, cuda_joint, cuda_lstm,
                                  flash_attn, joint)
from pg_asr_tpu_torch.ops.lstm import (LSTMScan, bilstm_layer,
                                       bilstm_scan_bwd_plain,
                                       bilstm_scan_plain, lstm_scan,
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


# --- CTC prefix beam search: csrc/ctc_beam.cu vs decoding/beam.py's plain
# scan. Labels, lens, parents and syms exact; scores and nll rtol 1e-6 (the
# two compute the same float32 operations in the same order; only expf /
# log1pf of nvcc's and of torch's CUDA build could round apart, by an ulp).
# Sharp posteriors (logits x 2) from a numpy seed keep distinct candidates
# apart by far more than an ulp.

def _beam_case(cuda, B, T, A, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, A)) * 2.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    fl = rng.integers(1, T + 1, B).astype(np.int32)
    fl[0] = T
    fl[1:3] = [1, 2]
    return torch.from_numpy(lp).to(cuda), torch.from_numpy(fl).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [None, 6])
# the beam's default batch and width at 5 s; a small case with K=4, 8
@pytest.mark.parametrize("B,T,A,K", [(128, 401, 28, 16), (5, 37, 6, 4),
                                     (4, 50, 12, 8)])
def test_ctc_beam_kernel_matches_plain(cuda, B, T, A, K, prune):
    lp, fl = _beam_case(cuda, B, T, A, B + T + K)
    M = beam._prune_m(A, K, prune)
    out = cuda_beam.ctc_beam_cuda(lp, fl, K=K, M=M, Lmax=T)
    lens, scores, parents, syms = beam._scan_hash(lp, fl, K=K, A=A, Lmax=T,
                                                  blank=0, prune=prune)
    labels, blens, nll = beam._backtrack_batch(parents, syms, lens, scores, T)
    torch.cuda.synchronize()
    for got, want in ((out.parents, parents), (out.syms, syms),
                      (out.lens, lens), (out.labels[:, 0], labels),
                      (out.nb_lens[:, 0], blens)):
        assert torch.equal(got, want)
    torch.testing.assert_close(out.scores, scores, rtol=1e-6, atol=0)
    torch.testing.assert_close(out.nll[:, 0], nll, rtol=1e-6, atol=0)
    assert int(blens.max()) > 0


@pytest.mark.cuda
def test_ctc_beam_nbest_kernel_matches_plain(cuda):
    """All K slots by score, dead ones (K above the distinct prefixes of a
    2-frame utterance) included."""
    lp, fl = _beam_case(cuda, 6, 30, 8, 3)
    before = cuda_beam.LAUNCHES
    got = beam.beam_decode_nbest(lp, fl, beam_size=16, max_label_len=40)
    assert cuda_beam.LAUNCHES == before + 1
    want = beam.beam_decode_nbest(lp, fl, beam_size=16, max_label_len=40,
                             use_kernel=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    assert bool((got[2] > 1e29).any())


@pytest.mark.cuda
def test_beam_decode_launches_the_kernel_once(cuda):
    lp, fl = _beam_case(cuda, 8, 60, 28, 1)
    before = cuda_beam.LAUNCHES
    labels, lens, nll = beam.beam_decode(lp.to(torch.bfloat16), fl, prune=6)
    assert cuda_beam.LAUNCHES == before + 1
    assert labels.shape == (8, 256) and labels.dtype == torch.int32
    ref = beam.beam_decode(lp.to(torch.bfloat16), fl, prune=6,
                           use_kernel=False)
    assert cuda_beam.LAUNCHES == before + 1
    assert torch.equal(labels, ref[0]) and torch.equal(lens, ref[1])


@pytest.mark.cuda
def test_ctc_beam_launcher_rejects_bad_inputs(cuda):
    lp, fl = _beam_case(cuda, 3, 10, 8, 0)
    before = cuda_beam.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_beam.ctc_beam_cuda(lp.cpu(), fl.cpu(), K=4, M=6, Lmax=10)
    with pytest.raises(ValueError, match="supports"):
        cuda_beam.ctc_beam_cuda(lp, fl, K=33, M=8, Lmax=10)
    with pytest.raises(ValueError, match="supports"):
        cuda_beam.ctc_beam_cuda(lp, fl, K=4, M=9, Lmax=10)  # M > A
    with pytest.raises(TypeError):
        cuda_beam.ctc_beam_cuda(lp.double(), fl, K=4, M=6, Lmax=10)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_beam.ctc_beam_cuda(lp.repeat(1, 1, 2)[..., ::2], fl, K=4, M=6,
                                Lmax=10)
    assert cuda_beam.LAUNCHES == before


# --- segment-masked attention: csrc/flash_attn.cu vs ops/flash_attn.py's
# mhsa_plain. float32 atol 2e-5: the online softmax over 64-key tiles and
# the dot products in another order change the result by float32 rounding
# only (outputs are convex mixes of v, |v| < ~5). bfloat16 atol 2^-6 x
# max|v|: p is rounded to bf16 against the running max of its tile (the
# plain version against the row's max) and the output is rounded to bf16,
# each at most 2^-9 relative, so two results may differ by a few ulps.

def _attn_case(cuda, B, H, T, dh, dtype, seed, fused=False):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, B)
    lens[0], lens[-1] = T, 1
    valid = torch.from_numpy(np.arange(T)[None] < lens[:, None]).to(cuda)
    if fused:  # views of a (B, T, 3, H, dh) projection, as the models pass
        qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, dh))).to(
            cuda, dtype)
        return (*(qkv[:, :, i].transpose(1, 2) for i in range(3)), valid)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, dh))).to(
        cuda, dtype) for _ in range(3))
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
# T not a multiple of the 64-row tiles; one tile; the conformer's T'=201
@pytest.mark.parametrize("B,H,T,fused", [(5, 2, 37, False), (3, 4, 130, True),
                                         (4, 4, 201, True), (2, 1, 64, False)])
def test_flash_attn_kernel_matches_plain(cuda, B, H, T, dh, dtype, fused):
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, dtype, B + T + dh, fused)
    before = cuda_flash_attn.LAUNCHES
    got = flash_attn.mhsa(q, k, v, valid, dh ** -0.5)
    torch.cuda.synchronize()
    assert cuda_flash_attn.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (B, H, T, dh)
    ref = flash_attn.mhsa_plain(q, k, v, valid, dh ** -0.5)
    atol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * v.abs().max().item()
    # every row, padded queries (which attend the padded keys) included
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_flash_attn_launcher_rejects_bad_inputs(cuda):
    q, k, v, valid = _attn_case(cuda, 2, 2, 9, 32, torch.float32, 0)
    before = cuda_flash_attn.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attn.flash_attn_cuda(q.cpu(), k.cpu(), v.cpu(),
                                        valid.cpu(), 0.1)
    with pytest.raises(ValueError, match="head dims"):
        cuda_flash_attn.flash_attn_cuda(q[..., :16], k[..., :16],
                                        v[..., :16], valid, 0.1)
    with pytest.raises(TypeError):
        cuda_flash_attn.flash_attn_cuda(q.double(), k.double(), v.double(),
                                        valid, 0.1)
    with pytest.raises(ValueError, match="shape"):
        cuda_flash_attn.flash_attn_cuda(q, k[:, :, :5], v, valid, 0.1)
    with pytest.raises(ValueError, match="valid_mask"):
        cuda_flash_attn.flash_attn_cuda(q, k, v, valid[:, :5], 0.1)
    assert cuda_flash_attn.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_attention_model_kernel_matches_plain(cuda, family):
    """The whole model forward on the card: one flash_attn launch per
    block; log-probs atol 1e-4 against the plain attention (float32
    rounding through 2 blocks, the head and the log-softmax)."""
    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         TransformerConfig)
    from pg_asr_tpu_torch.models import conformer_ctc, transformer_ctc

    kw = dict(num_layers=2, d_model=64, num_heads=2, ffn_dim=128,
              flash_attention=True)
    mod, sub = ((transformer_ctc, TransformerConfig(**kw))
                if family == "transformer" else
                (conformer_ctc, ConformerConfig(conv_kernel=7, **kw)))
    mcfg = ModelConfig(family=family, vocab_size=12)
    params = mod.init_params(mcfg, sub, torch.Generator().manual_seed(0),
                             cuda)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((3, 41, 80)).astype(
        np.float32)).to(cuda)
    lens = torch.tensor([41, 17, 1], dtype=torch.int32, device=cuda)
    mask = (torch.arange(41, device=cuda)[None] < lens[:, None]).float()
    before = cuda_flash_attn.LAUNCHES
    got, omask, olens = mod.apply(params, feats, mask, lens, mcfg, sub)
    assert cuda_flash_attn.LAUNCHES == before + 2
    ref = mod.apply(params, feats, mask, lens, mcfg, sub, use_kernel=False)
    assert cuda_flash_attn.LAUNCHES == before + 2
    assert olens.tolist() == [21, 9, 1] and torch.equal(omask, ref[1])
    torch.testing.assert_close(got, ref[0], rtol=0, atol=1e-4)


# --- the flash-attention gradient: the residual form of csrc/flash_attn.cu
# and csrc/flash_attn_bwd.cu (dkv, dq) vs ops/flash_attn.py's mhsa_plain
# (residuals=True) and mhsa_bwd_plain. l rtol 1e-5 (a sum of up to T terms
# in [0, 1], online against tile maxima), m atol 1e-5 (the same scores in
# another summation order). The backward kernels get the plain forward's
# residuals, so this holds them alone: float32 dq, dk, dv atol 2e-5 x
# max|grad| (sums over T in another order); bfloat16 atol 2^-7 x max|grad|:
# both round p and ds to bf16 at the same points, but from scores summed in
# another order, so a rounding can land one ulp apart, and each output is
# rounded to bf16 (two ulps of the largest value).

FLASH_BWD_REL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}


def _flash_counts():
    return (cuda_flash_attn.LAUNCHES, cuda_flash_attn.RES_LAUNCHES,
            cuda_flash_attn.DKV_LAUNCHES, cuda_flash_attn.DQ_LAUNCHES)


def _assert_rel(got, want, rel, what):
    bound = rel * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
# T not a multiple of the 64-row tiles; the conformer's T'=201; one tile
@pytest.mark.parametrize("B,H,T,fused", [(5, 2, 37, False), (3, 4, 130, True),
                                         (4, 4, 201, True), (2, 1, 64, False)])
def test_flash_attn_bwd_kernels_match_plain(cuda, B, H, T, dh, dtype, fused):
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, dtype, 3 * B + T + dh,
                                fused)
    scale = dh ** -0.5
    c0 = _flash_counts()
    o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                              residuals=True)
    torch.cuda.synchronize()
    assert _flash_counts() == (c0[0], c0[1] + 1, c0[2], c0[3])
    r_o, r_l, r_m = flash_attn.mhsa_plain(q, k, v, valid, scale,
                                          residuals=True)
    assert l.dtype == m.dtype == torch.float32 and l.shape == (B, H, T)
    # the residual form's o is the inference form's
    torch.testing.assert_close(o, cuda_flash_attn.flash_attn_cuda(
        q, k, v, valid, scale), rtol=0, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    torch.testing.assert_close(m, r_m, rtol=0, atol=1e-5)

    # do as autograd hands it over: a (B, H, T, dh) view of (B, T, H, dh)
    rng = np.random.default_rng(T)
    do = torch.from_numpy(rng.standard_normal((B, T, H, dh))).to(
        cuda, dtype).transpose(1, 2)
    di = (r_o.float() * do.float()).sum(-1).contiguous()
    c1 = _flash_counts()
    dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(q, k, v, valid, r_l, r_m,
                                                     do, di, scale)
    dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(q, k, v, valid, r_l, r_m, do,
                                                di, scale)
    torch.cuda.synchronize()
    assert _flash_counts() == (c1[0], c1[1], c1[2] + 1, c1[3] + 1)
    want = flash_attn.mhsa_bwd_plain(q, k, v, valid, r_o, r_l, r_m, do,
                                     scale)
    # every row, padded queries and keys included
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(g, w, FLASH_BWD_REL[dtype], f"{name} {dtype} T={T}")


@pytest.mark.cuda
def test_flash_attn_bwd_launchers_reject_bad_inputs(cuda):
    q, k, v, valid = _attn_case(cuda, 2, 2, 9, 32, torch.float32, 0)
    ones = torch.ones(2, 2, 9, device=cuda)
    before = _flash_counts()
    for fn in (cuda_flash_attn.flash_attn_bwd_dkv_cuda,
               cuda_flash_attn.flash_attn_bwd_dq_cuda):
        with pytest.raises(ValueError, match="do must"):
            fn(q, k, v, valid, ones, ones, q.double(), ones, 0.1)
        with pytest.raises(ValueError, match="l must"):
            fn(q, k, v, valid, ones[:, :, :5], ones, q, ones, 0.1)
        with pytest.raises(ValueError, match="di must"):
            fn(q, k, v, valid, ones, ones, q, ones.double(), 0.1)
        with pytest.raises(ValueError, match="head dims"):
            fn(q[..., :16], k[..., :16], v[..., :16], valid, ones, ones,
               q[..., :16], ones, 0.1)
    assert _flash_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_kernel_matches_plain(cuda, dtype):
    """FlashAttention through ops/flash_attn.mhsa under autograd, q, k, v
    views of one fused leaf: one residual forward, one dkv and one dq
    launch; the leaf's gradient against the plain Function's."""
    B, H, T, dh = 3, 4, 77, 64
    rng = np.random.default_rng(5)
    lens = torch.tensor([T, 40, 1], device=cuda)
    valid = torch.arange(T, device=cuda)[None] < lens[:, None]
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, dh))).to(
        cuda, dtype).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((B, H, T, dh))).to(cuda, dtype)
    grads = {}
    for use_kernel in (True, False):
        c0 = _flash_counts()
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = flash_attn.mhsa(q, k, v, valid, dh ** -0.5, use_kernel=use_kernel)
        grads[use_kernel], = torch.autograd.grad((o.float() * w.float())
                                                 .sum(), qkv)
        torch.cuda.synchronize()
        n = int(use_kernel)
        assert _flash_counts() == (c0[0], c0[1] + n, c0[2] + n, c0[3] + n)
    for i, name in enumerate(("dq", "dk", "dv")):
        _assert_rel(grads[True][:, :, i], grads[False][:, :, i],
                    FLASH_BWD_REL[dtype], f"{name} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["transformer", "conformer"])
@pytest.mark.parametrize("remat", [False, True])
def test_attention_train_gradients_kernel_match_plain(cuda, family, remat):
    """Loss and every parameter gradient of a small attention-family train
    step with flash_attention on the card, kernels + F.ctc_loss vs the
    plain attention + the plain CTC recursion, dropout 0: rtol 1e-3 and
    atol 1e-4 x max|grad| (float32 sums in other orders through two blocks,
    the head and two CTC implementations). Per step one residual forward,
    one dkv and one dq launch per block; with remat the forward runs again
    in the recompute."""
    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         TransformerConfig)
    from pg_asr_tpu_torch.train import init_model_params, loss_and_grads

    kw = dict(num_layers=2, d_model=64, num_heads=2, ffn_dim=128,
              dropout=0.0, flash_attention=True)
    cfg = Config(model=ModelConfig(family=family, vocab_size=12, remat=remat),
                 transformer=TransformerConfig(**kw),
                 conformer=ConformerConfig(**kw))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(2)
    ns = np.array([6400, 3000, 2000])
    wave = (rng.standard_normal((3, 6400)) * 3000 * (np.arange(6400)[None]
                                                     < ns[:, None]))
    arrays = [torch.from_numpy(a).to(cuda) for a in (
        wave.astype(np.int16), ns.astype(np.int32),
        rng.integers(1, 12, (3, 6)).astype(np.int32),
        np.array([6, 4, 0], np.int32))]
    c0 = _flash_counts()
    loss_k, g_k = loss_and_grads(params, arrays, cfg)
    torch.cuda.synchronize()
    fwd = 2 * (2 if remat else 1)
    assert _flash_counts() == (c0[0], c0[1] + fwd, c0[2] + 2, c0[3] + 2)
    loss_p, g_p = loss_and_grads(params, arrays, cfg, use_kernel=False)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-4, atol=1e-5)
    for k in g_p:
        torch.testing.assert_close(g_k[k], g_p[k], rtol=1e-3,
                                   atol=float(1e-4 * g_p[k].abs().max()))


@pytest.mark.cuda
def test_conformer_depthwise_conv_runs_in_full_float32(cuda):
    """The conformer's depthwise conv, forward and backward, in float32 on
    the card with cuDNN's TF32 allowed (its default) vs float64 on the CPU,
    atol 1e-5 x max|ref|: float32 rounding over 15 taps is ~1e-7 relative,
    TF32's 10-bit mantissa ~1e-3. The whole conv module (pointwise, GLU,
    depthwise, LayerNorm, swish, pointwise), float32 on the card vs on the
    CPU, at the same bound."""
    from pg_asr_tpu_torch.config import ConformerConfig
    from pg_asr_tpu_torch.models import conformer_ctc

    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rng = np.random.default_rng(4)
        x64 = torch.from_numpy(rng.standard_normal((4, 256, 215)))
        w64 = torch.from_numpy(rng.standard_normal((256, 1, 15)))
        gy64 = torch.from_numpy(rng.standard_normal((4, 256, 201)))
        ref, got = [], []
        for t, dev, dt in ((ref, "cpu", torch.float64),
                           (got, cuda, torch.float32)):
            x = x64.to(dev, dt).requires_grad_(True)
            w = w64.to(dev, dt).requires_grad_(True)
            y = conformer_ctc.DepthwiseConv.apply(x, w)
            t.extend([y, *torch.autograd.grad(y, (x, w), gy64.to(dev, dt))])
        for name, g, r in zip(("y", "dx", "dw"), got, ref):
            _assert_rel(g.cpu().double(), r, 1e-5, f"depthwise conv {name}")

        ccfg = ConformerConfig(d_model=256)
        mcfg = ModelConfig(family="conformer", vocab_size=12)
        params = conformer_ctc.init_params(mcfg, ccfg,
                                           torch.Generator().manual_seed(0))
        pre = "blocks.0"
        names = [k for k in params if k.startswith(pre + ".conv")
                 or k.startswith(pre + ".ln_mid")]
        xin = torch.from_numpy(rng.standard_normal((4, 201, 256)).astype(
            np.float32))
        mask = (torch.arange(201)[None] < torch.tensor([201, 150, 77, 1])[
            :, None]).float()
        out = {}
        for dev in ("cpu", cuda):
            p = {k: params[k].to(dev).requires_grad_(True) for k in names}
            x = xin.to(dev).requires_grad_(True)
            y = conformer_ctc._conv_module(p, pre, x, mask.to(dev), 15)
            gs = torch.autograd.grad(y.square().sum(), [x, *p.values()])
            out[str(dev)] = [y, *gs]
        for name, g, r in zip(["y", "dx", *names], out[str(cuda)],
                              out["cpu"]):
            _assert_rel(g.cpu(), r, 1e-5, f"conv module {name}")
    finally:
        torch.backends.cudnn.allow_tf32 = old


JOINT_GRAD_REL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}


def _joint_case(cuda, B, T, U, J, A, dtype, seed):
    rng = np.random.default_rng(seed)
    e, g, W, b = (torch.from_numpy(rng.standard_normal(s) * sc).to(cuda, dtype)
                  for s, sc in (((B, T, J), 0.5), ((B, U + 1, J), 0.5),
                                ((J, A), (2 / (J + A)) ** 0.5), ((A,), 0.1)))
    labels = torch.from_numpy(rng.integers(1, A, (B, U))).to(cuda)
    labels[0, U // 2:] = 0  # a padded label row
    gb = torch.from_numpy(rng.standard_normal((B, T, U + 1))).to(
        cuda, torch.float32)
    gy = torch.from_numpy(rng.standard_normal((B, T, U))).to(
        cuda, torch.float32)
    return (e, g, W, b, labels), gb, gy


def _joint_counts():
    return cuda_joint.FWD_LAUNCHES, cuda_joint.BWD_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# T not a multiple of the 8-frame tiles or of a block's 32-frame walk; U+1
# across two 32-row u-tiles; U = 0; the vocab padded to 8, 16 and 32
@pytest.mark.parametrize("B,T,U,J,A", [(3, 37, 5, 32, 9), (2, 45, 40, 100, 28),
                                       (4, 11, 0, 48, 5), (2, 70, 63, 256, 32),
                                       (1, 1, 1, 8, 2)])
def test_joint_kernels_match_plain(cuda, B, T, U, J, A, dtype):
    args, gb, gy = _joint_case(cuda, B, T, U, J, A, dtype, B + T + U + A)
    c0 = _joint_counts()
    lpb, lpy = cuda_joint.joint_fwd_cuda(*args)
    grads = cuda_joint.joint_bwd_cuda(*args, gb, gy)
    torch.cuda.synchronize()
    assert _joint_counts() == (c0[0] + 1, c0[1] + 1)
    rb, ry = joint.fused_joint_plain(*args)
    assert lpb.dtype == lpy.dtype == torch.float32
    assert lpb.shape == (B, T, U + 1) and lpy.shape == (B, T, U)
    torch.testing.assert_close(lpb, rb, rtol=0, atol=2e-5)
    torch.testing.assert_close(lpy, ry, rtol=0, atol=2e-5)
    want = joint.fused_joint_bwd_plain(*args, gb, gy)
    for name, g, w in zip(("de", "dg", "dW", "db"), grads, want):
        _assert_rel(g, w, JOINT_GRAD_REL[dtype], f"{name} {dtype} T={T} U={U}")
    # no atomics: a second run gives the same bits
    for g, again in zip(grads, cuda_joint.joint_bwd_cuda(*args, gb, gy)):
        assert torch.equal(g, again)


@pytest.mark.cuda
def test_fused_joint_function_launches_the_kernels(cuda):
    """FusedJoint under autograd on CUDA tensors: one joint_fwd and one
    joint_bwd launch; use_kernel=False none; the gradients agree."""
    args, gb, gy = _joint_case(cuda, 2, 19, 7, 64, 28, torch.float32, 1)
    grads = {}
    for use_kernel in (True, False):
        leaves = [a.clone().requires_grad_(True) for a in args[:4]]
        c0 = _joint_counts()
        lb, ly = joint.fused_joint(*leaves, args[4], use_kernel=use_kernel)
        grads[use_kernel] = torch.autograd.grad(
            (lb * gb).sum() + (ly * gy).sum(), leaves)
        torch.cuda.synchronize()
        n = int(use_kernel)
        assert _joint_counts() == (c0[0] + n, c0[1] + n)
    for name, g, w in zip(("de", "dg", "dW", "db"), grads[True],
                          grads[False]):
        _assert_rel(g, w, JOINT_GRAD_REL[torch.float32], name)


@pytest.mark.cuda
def test_joint_launchers_reject_bad_inputs(cuda):
    args, gb, gy = _joint_case(cuda, 2, 9, 3, 16, 6, torch.float32, 0)
    e, g, W, b, labels = args
    before = _joint_counts()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_joint.joint_fwd_cuda(*(a.cpu() for a in args))
    with pytest.raises(TypeError):
        cuda_joint.joint_fwd_cuda(e.double(), g, W, b, labels)
    with pytest.raises(TypeError):
        cuda_joint.joint_fwd_cuda(e, g.bfloat16(), W, b, labels)
    with pytest.raises(ValueError, match="shapes"):
        cuda_joint.joint_fwd_cuda(e, g[:, :3], W, b, labels)
    with pytest.raises(ValueError, match="vocab"):
        wide = torch.zeros(16, 40, device=cuda)
        cuda_joint.joint_fwd_cuda(e, g, wide, torch.zeros(40, device=cuda),
                                  labels)
    with pytest.raises(ValueError, match="gy must"):
        cuda_joint.joint_bwd_cuda(*args, gb, gy[:, :, :2])
    with pytest.raises(RuntimeError, match="shared memory"):
        big = torch.zeros(2, 9, 4096, device=cuda)
        cuda_joint.joint_fwd_cuda(big, torch.zeros(2, 4, 4096, device=cuda),
                                  torch.zeros(4096, 6, device=cuda), b,
                                  labels)
    assert _joint_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["bilstm", "conformer"])
def test_transducer_train_gradients_kernel_match_plain(cuda, encoder):
    """Loss and every parameter gradient of a small transducer train step
    with fused_joint on the card, the joint kernels (and the encoder's
    kernels) vs the plain versions, dropout 0: rtol 1e-3 and atol 1e-4 x
    max|grad|, as the attention families' test. One joint_fwd and one
    joint_bwd launch per step; "auto" on CUDA is the fused joint too."""
    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         TransducerConfig)
    from pg_asr_tpu_torch.train import init_model_params, loss_and_grads

    kw = dict(num_layers=2, d_model=64, num_heads=2, ffn_dim=128,
              dropout=0.0, flash_attention=True)
    rng = np.random.default_rng(3)
    ns = np.array([6400, 3000, 2000])
    wave = (rng.standard_normal((3, 6400)) * 3000 * (np.arange(6400)[None]
                                                     < ns[:, None]))
    arrays = [torch.from_numpy(a).to(cuda) for a in (
        wave.astype(np.int16), ns.astype(np.int32),
        rng.integers(1, 12, (3, 6)).astype(np.int32),
        np.array([6, 4, 0], np.int32))]
    for flag in (True, "auto"):
        cfg = Config(model=ModelConfig(family="transducer", vocab_size=12,
                                       hidden_size=64, input_proj_dim=64,
                                       num_layers=2, dropout=0.0),
                     conformer=ConformerConfig(**kw),
                     transducer=TransducerConfig(
                         encoder=encoder, pred_embed_dim=16, pred_hidden=32,
                         joint_dim=64, fused_joint=flag, ctc_weight=0.3))
        params = init_model_params(cfg, torch.Generator().manual_seed(0),
                                   cuda)
        c0 = _joint_counts()
        loss_k, g_k = loss_and_grads(params, arrays, cfg)
        torch.cuda.synchronize()
        assert _joint_counts() == (c0[0] + 1, c0[1] + 1)
    loss_p, g_p = loss_and_grads(params, arrays, cfg, use_kernel=False)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-4, atol=1e-5)
    for k in g_p:
        torch.testing.assert_close(g_k[k], g_p[k], rtol=1e-3,
                                   atol=float(1e-4 * g_p[k].abs().max()))


# --- fused-direction BiLSTM: csrc/bilstm_fwd.cu, csrc/bilstm_bwd.cu

def _bi_counts():
    return (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
            cuda_lstm.BWD_LAUNCHES, cuda_lstm.BI_LAUNCHES,
            cuda_lstm.BI_RES_LAUNCHES, cuda_lstm.BI_BWD_LAUNCHES)


def _bi_case(cuda, B, T, H, dtype, seed):
    xpf, Uf, mask, gyf = _case(cuda, B, T, H, dtype, seed)
    xpb, Ub, _, gyb = _case(cuda, B, T, H, dtype, seed + 1)
    return xpf, xpb, Uf, Ub, mask, torch.cat([gyf, gyb], -1)


# blocks hold 1 (H=64), 2 (H=100) or 4 (H=256, 200) hidden units of one
# direction; B=70 takes two passes of the block's row loops
BI_SHAPES = [(5, 37, 64), (4, 13, 100), (3, 11, 256), (2, 9, 200),
             (70, 5, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("B,T,H", BI_SHAPES)
def test_bilstm_fwd_kernel_matches_plain(cuda, B, T, H, dtype, atol):
    xpf, xpb, Uf, Ub, mask, _ = _bi_case(cuda, B, T, H, dtype, H + T)
    before = _bi_counts()
    y = cuda_lstm.bilstm_scan_cuda(xpf, xpb, Uf, Ub, mask)
    res = cuda_lstm.bilstm_scan_residual_cuda(xpf, xpb, Uf, Ub, mask)
    torch.cuda.synchronize()
    assert _bi_counts() == (*before[:3], before[3] + 1, before[4] + 1,
                            before[5])
    assert y.dtype == dtype and y.shape == (B, T, 2 * H)
    assert torch.equal(res[0], y)
    ref = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask, residuals=True)
    for got, want in zip(res, ref):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)
    # each direction equals a single-direction launch bit for bit
    sf = cuda_lstm.lstm_scan_residual_cuda(xpf, Uf, mask, False)
    sb = cuda_lstm.lstm_scan_residual_cuda(xpb, Ub, mask, True)
    assert torch.equal(y, torch.cat([sf[0], sb[0]], -1))
    for got, want in zip(res[1:], (*sf[1:], *sb[1:])):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H", BI_SHAPES)
def test_bilstm_bwd_kernel_matches_plain(cuda, B, T, H, dtype, rel):
    """Given the plain forward's residuals, as the single-direction test."""
    xpf, xpb, Uf, Ub, mask, gy = _bi_case(cuda, B, T, H, dtype, 7 * H + T)
    _, *res = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask, residuals=True)
    before = cuda_lstm.BI_BWD_LAUNCHES
    got = cuda_lstm.bilstm_scan_bwd_cuda(xpf, xpb, Uf, Ub, mask, *res, gy)
    again = cuda_lstm.bilstm_scan_bwd_cuda(xpf, xpb, Uf, Ub, mask, *res, gy)
    torch.cuda.synchronize()
    assert cuda_lstm.BI_BWD_LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = bilstm_scan_bwd_plain(xpf, xpb, Uf, Ub, mask, *res, gy)
    for g, want in zip(got, ref):
        assert g.dtype == dtype and g.shape == want.shape
        tol = (1e-5 if dtype == torch.float32 and g.dim() == 3
               else rel * want.float().abs().max())
        torch.testing.assert_close(g.float(), want.float(), rtol=0,
                                   atol=float(tol))
    single = (*cuda_lstm.lstm_scan_bwd_cuda(xpf, Uf, mask, *res[:2],
                                            gy[..., :H].contiguous(), False),
              *cuda_lstm.lstm_scan_bwd_cuda(xpb, Ub, mask, *res[2:],
                                            gy[..., H:].contiguous(), True))
    for g, want in zip(got, (single[0], single[2], single[1], single[3])):
        assert torch.equal(g, want)


@pytest.mark.cuda
def test_bilstm_launchers_reject_bad_inputs(cuda):
    xp = torch.zeros(2, 3, 64, device=cuda)
    U = torch.zeros(16, 64, device=cuda)
    mask = torch.ones(2, 3, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.bilstm_scan_cuda(xp.cpu(), xp.cpu(), U.cpu(), U.cpu(),
                                   mask.cpu())
    with pytest.raises(ValueError, match="differ"):
        cuda_lstm.bilstm_scan_cuda(xp, xp.bfloat16(), U, U.bfloat16(), mask)
    with pytest.raises(TypeError):
        cuda_lstm.bilstm_scan_cuda(xp, xp, U, U.bfloat16(), mask)
    # H above 4 hidden units per SM's block: refused, not launched
    H = 4 * torch.cuda.get_device_properties(cuda).multi_processor_count
    before = _bi_counts()
    with pytest.raises(RuntimeError, match="hidden size"):
        x = torch.zeros(1, 2, 4 * H, device=cuda)
        u = torch.zeros(H, 4 * H, device=cuda)
        cuda_lstm.bilstm_scan_cuda(x, x, u, u, torch.ones(1, 2, device=cuda))
    assert _bi_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_layer_fused_autograd_launches_the_kernels(cuda, dtype):
    """bilstm_layer(fuse_directions=True) under autograd: one residual
    bilstm_fwd and one bilstm_bwd launch, no single-direction launch; its
    output and the gradients of x, W, U and b equal the unfused layer's
    (each direction equals a single-direction launch bit for bit)."""
    rng = np.random.default_rng(11)
    B, T, I, H = 6, 23, 48, 256
    lens = np.array([23, 1, 9, 17, 23, 4])
    mask = torch.from_numpy(np.arange(T)[None] < lens[:, None]).to(
        cuda, torch.float32)
    x0 = torch.from_numpy(rng.standard_normal((B, T, I))).to(cuda, dtype)
    p0 = {d: {"W": torch.from_numpy(rng.uniform(-1, 1, (I, 4 * H)) / 8),
              "U": torch.from_numpy(rng.uniform(-1, 1, (H, 4 * H)) / 16),
              "b": torch.from_numpy(rng.standard_normal(4 * H) / 4)}
          for d in ("fwd", "bwd")}
    gy = torch.from_numpy(rng.standard_normal((B, T, 2 * H))).to(cuda, dtype)
    out = {}
    for fuse in (True, False):
        x = x0.clone().requires_grad_(True)
        p = {d: {k: v.to(cuda, dtype).requires_grad_(True)
                 for k, v in q.items()} for d, q in p0.items()}
        before = _bi_counts()
        y = bilstm_layer(p, x, mask, fuse_directions=fuse)
        y.backward(gy)
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(_bi_counts(), before))
        assert delta == ((0, 0, 0, 0, 1, 1) if fuse else (0, 2, 2, 0, 0, 0))
        out[fuse] = [y, x.grad] + [p[d][k].grad for d in ("fwd", "bwd")
                                   for k in ("W", "U", "b")]
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)
    with torch.no_grad():
        before = _bi_counts()
        y = bilstm_layer(p, x0, mask, fuse_directions=True)
        assert _bi_counts()[3] == before[3] + 1
        assert torch.equal(y, out[True][0])


# --- transducer decoding on the card vs the CPU (plain PyTorch both)

@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["bilstm", "conformer"])
def test_transducer_decode_on_card_matches_cpu(cuda, encoder):
    """Greedy and beam (K=4) of a small transducer, from features through
    its encoder: the card's labels and lens equal the CPU's, the beam's nll
    within rtol 1e-5 (float32 sums in other orders; joint_out.w scaled x4
    keeps the argmaxes apart). The BiLSTM encoder runs lstm_fwd on the
    card, the conformer's flash_attention the flash kernel."""
    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         TransducerConfig)
    from pg_asr_tpu_torch.decoding import transducer as dec
    from pg_asr_tpu_torch.models import transducer

    cfg = Config(
        model=ModelConfig(family="transducer", vocab_size=9,
                          input_proj_dim=32, hidden_size=16, num_layers=2,
                          dropout=0.0),
        conformer=ConformerConfig(num_layers=2, d_model=64, num_heads=2,
                                  ffn_dim=128, dropout=0.0,
                                  flash_attention=True),  # head dim 32
        transducer=TransducerConfig(encoder=encoder, pred_embed_dim=8,
                                    pred_hidden=16, joint_dim=32))
    params = transducer.init_params(cfg, torch.Generator().manual_seed(0))
    params["joint_out.w"] = params["joint_out.w"] * 4
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((4, 60, 80)).astype(
        np.float32))
    flens = torch.tensor([60, 31, 1, 47])
    fmask = (torch.arange(60)[None] < flens[:, None]).float()
    out = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        with torch.no_grad():
            enc, _, olens = transducer.encode(
                p, feats.to(dev), fmask.to(dev), flens.to(dev), cfg)
            out[str(dev)] = (
                dec.transducer_greedy_decode(p, enc, olens, cfg,
                                             max_label_len=32),
                dec.transducer_beam_decode(p, enc, olens, cfg, beam_size=4,
                                           max_label_len=32))
    (g_cpu, b_cpu), (g_gpu, b_gpu) = out["cpu"], out[str(cuda)]
    for a, b in zip(g_gpu + b_gpu[:2], g_cpu + b_cpu[:2]):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(b_gpu[2].cpu(), b_cpu[2], rtol=1e-5, atol=0)
    assert g_cpu[1].sum() > 0
