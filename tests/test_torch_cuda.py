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
single-direction tolerances against their plain versions, and each of
their directions equals a single-direction launch (lstm_fwd, lstm_bwd) bit
for bit: one kernel serves both, and the summation orders do not depend on
the rows a cluster carries. Every kernel repeats its bits from launch to
launch.
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


def _bi_counts():
    """Launch counts of the six LSTM launchers, in this order."""
    return (cuda_lstm.LAUNCHES, cuda_lstm.RES_LAUNCHES,
            cuda_lstm.BWD_LAUNCHES, cuda_lstm.BI_LAUNCHES,
            cuda_lstm.BI_RES_LAUNCHES, cuda_lstm.BI_BWD_LAUNCHES)


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
# clusters of 8 blocks: H=64 (8 units a block), 256, 200 (ragged units);
# H=264 and 320: float32 clusters of 16 (a slice of k fits a thread's
# registers), and in bfloat16 three warps per unit group at 320; B=70:
# more clusters than 8 rows each would need, B=13 a ragged last cluster;
# H=448, 512, 1024: U's columns read from L2 (the CUDA-core walk, bf16
# too); 1536 and 2048: fewer rows a cluster, threads looping over units;
# 8300: past a block's shared memory for h (one row a cluster, h through
# global memory)
@pytest.mark.parametrize("B,T,H", [(5, 37, 64), (3, 11, 256), (2, 9, 200),
                                   (13, 7, 264), (70, 5, 32), (3, 6, 320),
                                   (8, 64, 448), (8, 64, 512),
                                   (8, 64, 1024), (6, 9, 1536), (5, 7, 2048),
                                   (2, 3, 8300)])
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
    # the same bits from a second launch
    assert torch.equal(got, cuda_lstm.lstm_scan_cuda(xp, U, mask, reverse))


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
    with pytest.raises(ValueError, match="mask"):
        cuda_lstm.lstm_scan_cuda(xp, U, mask[:, :2])
    with pytest.raises(ValueError, match="empty"):
        cuda_lstm.lstm_scan_cuda(xp[:0], U, mask[:0])
    # above 1024 hidden units, which the first kernels refused: launched
    H = 1030
    before = cuda_lstm.LAUNCHES
    out = cuda_lstm.lstm_scan_cuda(torch.zeros(1, 2, 4 * H, device=cuda),
                                   torch.zeros(H, 4 * H, device=cuda),
                                   torch.ones(1, 2, device=cuda))
    torch.cuda.synchronize()
    assert cuda_lstm.LAUNCHES == before + 1
    assert torch.equal(out, torch.zeros(1, 2, H, device=cuda))


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
    before = _bi_counts()
    got = bilstm_ctc.apply(params, feats, mask, cfg)
    # the encoder's route: one bilstm_fwd a layer
    want = [0] * 6
    want[3] = cfg.num_layers
    assert [a - b for a, b in zip(_bi_counts(), before)] == want
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
@pytest.mark.parametrize("B,T,H", [(5, 37, 64), (3, 11, 256), (2, 9, 200),
                                   (13, 7, 264), (70, 5, 32), (3, 6, 320),
                                   (8, 64, 448), (8, 64, 512),
                                   (8, 64, 1024), (6, 9, 1536), (5, 7, 2048),
                                   (2, 3, 8300)])
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
                                   (70, 5, 32), (1, 9, 256), (13, 7, 200),
                                   (3, 6, 264), (8, 64, 448), (8, 64, 512),
                                   (8, 64, 1024), (6, 9, 1536), (5, 7, 2048),
                                   (2, 3, 8300)])
def test_lstm_bwd_kernel_matches_plain(cuda, B, T, H, reverse, dtype, rel):
    """Both get the plain forward's residuals, so this holds the backward
    alone. One row; B = 13 and 70, not multiples of the rows per cluster
    (70 also more clusters than fit at once); H = 200, ragged units per
    block; H = 264, the first kernel's largest at 132 SMs (clusters of
    16); H = 448 .. 2048: U's columns read from L2, a thread looping over
    units above 512, fewer rows a cluster above 1024; H = 8300: past a
    thread per unit of a row (one row a cluster, the partial dh through
    global memory)."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_kernel_repeats_its_bits(cuda, dtype):
    """No atomics: the dh partials are added in rank order and the dU
    partials in cluster order, so a second launch gives the same bits."""
    xp, U, mask, gy = _case(cuda, 64, 23, 256, dtype, 9)
    _, hprev, cprev = lstm_scan_plain(xp, U, mask, False, residuals=True)
    runs = [cuda_lstm.lstm_scan_bwd_cuda(xp, U, mask, hprev, cprev, gy)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dxp", "dU"), *runs):
        assert torch.equal(_bits(a), _bits(b)), name


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
    before = _bi_counts()
    loss_k, g_k = loss_and_grads(params, arrays, cfg)
    # the encoder's route: a residual bilstm_fwd and a bilstm_bwd a layer
    want = [0] * 6
    want[4] = want[5] = cfg.model.num_layers
    assert [a - b for a, b in zip(_bi_counts(), before)] == want
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
                                     (4, 50, 12, 8),
                                     # the warp form with a lane's symbols
                                     # in registers (A <= 128) and read
                                     # from the row (A above; 5000 not a
                                     # multiple of 32 or 4)
                                     (8, 101, 100, 32), (8, 101, 5000, 16),
                                     # the block form (K > 32)
                                     (8, 101, 256, 48), (8, 101, 5000, 64),
                                     # a BPE vocabulary (the default 256)
                                     # at the beam's default batch
                                     (128, 401, 256, 16)])
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
@pytest.mark.parametrize("A,K", [(256, 48), (5000, 64), (5000, 16)])
def test_ctc_beam_wide_nbest_kernel_matches_plain(cuda, A, K):
    """The n-best of beams wider than a warp and vocabularies over 1024,
    exact M = K + 2."""
    lp, fl = _beam_case(cuda, 8, 101, A, A + K)
    before = cuda_beam.LAUNCHES
    got = beam.beam_decode_nbest(lp, fl, beam_size=K, max_label_len=101)
    assert cuda_beam.LAUNCHES == before + 1
    want = beam.beam_decode_nbest(lp, fl, beam_size=K, max_label_len=101,
                                  use_kernel=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)


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


# --- CTC forced alignment (ops/align.py, plain PyTorch on the tensors'
# device) and the timing decoder: the card's backpointers, end states,
# scores and spans equal the CPU's (the same float32 operations in the
# same order: max, compare, add), on random and on exactly tied log-probs.

@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_viterbi_on_card_matches_cpu(cuda, tied):
    from pg_asr_tpu_torch.ops import align

    rng = np.random.default_rng(4)
    B, T, A, L = 32, 401, 256, 60
    if tied:
        lp = np.full((B, T, A), -np.log(A), np.float32)
    else:
        x = rng.standard_normal((B, T, A)).astype(np.float32)
        lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(
            np.float32)
    labels = rng.integers(1, A, (B, L)).astype(np.int32)
    labels[:, 1] = labels[:, 0]  # a repeat
    label_lens = rng.integers(1, L + 1, B).astype(np.int32)
    frame_lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    frame_lens[0], label_lens[1], frame_lens[1] = T, L, 10  # infeasible
    args = [torch.from_numpy(a) for a in (lp, frame_lens, labels,
                                          label_lens)]
    got = align.ctc_viterbi_backpointers(*[a.to(cuda) for a in args])
    want = align.ctc_viterbi_backpointers(*args)
    assert all(g.is_cuda for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    spans = align.ctc_forced_align(*[a.to(cuda) for a in args])
    assert spans == align.ctc_forced_align(*args)
    assert spans[1] == [] and len(spans[0]) == label_lens[0]


@pytest.mark.cuda
def test_greedy_timing_on_card_matches_cpu(cuda):
    from pg_asr_tpu_torch.decoding import greedy

    lp, fl = _beam_case(cuda, 16, 120, 40, 9)
    mask = (torch.arange(120, device=cuda)[None] < fl[:, None]).float()
    got = greedy.greedy_decode_with_timing(lp, mask)
    want = greedy.greedy_decode_with_timing(lp.cpu(), mask.cpu())
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_ctc_beam_launcher_rejects_bad_inputs(cuda):
    lp, fl = _beam_case(cuda, 3, 10, 8, 0)
    before = cuda_beam.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_beam.ctc_beam_cuda(lp.cpu(), fl.cpu(), K=4, M=6, Lmax=10)
    with pytest.raises(ValueError, match="takes"):
        cuda_beam.ctc_beam_cuda(lp, fl, K=0, M=8, Lmax=10)
    with pytest.raises(ValueError, match="takes"):
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

# the mean abs error relative to max|o| that tells apart a bf16 forward
# rounding p where the library does (~2e-8) from one keeping p in float32
# (~4e-5)
FLASH_FWD_BF16_MEAN = 1e-6


def _attn_case(cuda, B, H, T, dh, dtype, seed, fused=False, lens=None):
    """q, k, v and a (B, T) validity mask from a seed; lengths ``lens``, or
    random ones with T and 1 among them."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(1, T + 1, B)
        lens[0], lens[-1] = T, 1
    lens = np.asarray(lens)
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


def _tile_walk_bf16(q, k, v, seg, scale, round_p=True, tile=64):
    """The library forward's rounding points, test-local: for each query
    tile the key tiles in order, the online softmax in float32, p = exp(s
    - m_running) rounded to bf16 (or not, with ``round_p`` False) before
    p . v, which accumulates in float32; the output rounded to bf16."""
    B, H, T, _ = q.shape
    n = -(-T // tile)
    mask_value = flash_attn.DEFAULT_MASK_VALUE
    o = torch.empty_like(q)
    qf, kf, vf = q.float(), k.float(), v.float()
    for b in range(B):
        for i in range(n):
            rows = slice(i * tile, min(T, (i + 1) * tile))
            m = torch.full((H, rows.stop - rows.start), -torch.inf,
                           device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros(H, rows.stop - rows.start, q.shape[-1],
                              device=q.device)
            for j in range(n):
                keys = slice(j * tile, min(T, (j + 1) * tile))
                s = qf[b, :, rows] @ kf[b, :, keys].transpose(-1, -2) * scale
                same = seg[b, rows, None] == seg[b, None, keys]
                s = s + torch.where(same, 0.0, mask_value)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = alpha * l + p.sum(-1)
                pv = p.to(torch.bfloat16).float() if round_p else p
                acc = alpha[..., None] * acc + pv @ vf[b, :, keys]
                m = m_new
            o[b, :, rows] = (acc / l[..., None]).to(q.dtype)
    return o


@pytest.mark.cuda
def test_flash_attn_bf16_rounds_p_where_the_library_does(cuda):
    """The library rounds p = exp(s - m) to bf16 against the running max of
    the key tiles walked so far. The mean error tells that apart (the max
    cannot): the kernel lies within FLASH_FWD_BF16_MEAN x max|o| of a
    test-local walk with those rounding points, a walk that keeps p in
    float32 lies beyond it. A CPU estimate at this shape, float64 against
    float32 sums with the same roundings: 2.4e-8; without the rounding of
    p: 4.4e-5."""
    B, H, T, dh = 8, 4, 201, 64
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, torch.bfloat16, 31, True)
    seg = valid.to(torch.int32)
    got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, dh ** -0.5)
    want = _tile_walk_bf16(q, k, v, seg, dh ** -0.5)
    control = _tile_walk_bf16(q, k, v, seg, dh ** -0.5, round_p=False)
    top = want.float().abs().max()
    mean = ((got.float() - want.float()).abs().mean() / top).item()
    ctrl = ((control.float() - want.float()).abs().mean() / top).item()
    assert mean <= FLASH_FWD_BF16_MEAN < ctrl, (mean, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["ragged", "random_int32"])
def test_flash_attn_skips_masked_tile_pairs_without_a_change(cuda, dtype,
                                                              kind):
    """Segment layouts that empty whole 64 x 64 tile pairs (lengths 1, 64,
    65, 128 and T; runs of random int32 segment ids, sorted in one row),
    which the kernel skips: both forms against mhsa_plain within the
    usual bounds, l and m included."""
    B, H, T, dh = 5, 2, 257, 64
    rng = np.random.default_rng(37)
    if kind == "ragged":
        seg = np.arange(T)[None] < np.array([1, 64, 65, 128, T])[:, None]
    else:
        ids = rng.integers(-2 ** 31, 2 ** 31, (B, 9), dtype=np.int64)
        ids[0] = np.sort(ids[0])
        cuts = np.sort(rng.choice(np.arange(1, T), (B, 8)), axis=1)
        seg = np.stack([np.repeat(ids[r], np.diff(np.r_[0, cuts[r], T]))
                        for r in range(B)])
    seg = torch.from_numpy(seg.astype(np.int32)).to(cuda)
    assert not flash_attn.kept_tile_pairs(seg).all()
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, dh))).to(
        cuda, dtype) for _ in range(3))
    scale = dh ** -0.5
    o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, seg, scale,
                                              residuals=True)
    r_o, r_l, r_m = flash_attn.mhsa_plain(q, k, v, seg, scale,
                                          residuals=True)
    atol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * v.abs().max().item()
    torch.testing.assert_close(o.float(), r_o.float(), rtol=0, atol=atol)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    torch.testing.assert_close(m, r_m, rtol=0, atol=1e-5)
    torch.testing.assert_close(o, cuda_flash_attn.flash_attn_cuda(
        q, k, v, seg, scale), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_launcher_copies_unaligned_inputs(cuda, dtype):
    """Inputs whose address or strides are not multiples of 16 bytes (as
    16-byte cp.async needs) are copied first, not refused."""
    B, H, T, dh = 3, 2, 70, 32
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, dtype, 29, True)
    wide = torch.zeros(B, H, T, dh + 3, dtype=dtype, device=cuda)
    wide[..., 1:dh + 1] = q
    q_odd = wide[..., 1:dh + 1]  # 2 or 4 bytes past alignment, odd strides
    assert q_odd.data_ptr() % 16 != 0
    got = cuda_flash_attn.flash_attn_cuda(q_odd, k, v, valid, dh ** -0.5)
    torch.testing.assert_close(got, cuda_flash_attn.flash_attn_cuda(
        q, k, v, valid, dh ** -0.5), rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attn_launcher_rejects_bad_inputs(cuda):
    q, k, v, valid = _attn_case(cuda, 2, 2, 9, 32, torch.float32, 0)
    before = cuda_flash_attn.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_flash_attn.flash_attn_cuda(q.cpu(), k.cpu(), v.cpu(),
                                        valid.cpu(), 0.1)
    with pytest.raises(ValueError, match="empty"):
        none = q[..., :0]  # no head dim (any dh >= 1 runs)
        cuda_flash_attn.flash_attn_cuda(none, none, none, valid, 0.1)
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
# the mean abs error relative to max|grad| of chip_smoke.py's bf16 bound
# (FLASH_BWD_BOUNDS): ~2e-8 when p and ds round where the library rounds
# them, ~6e-5 for a backward that keeps them in float32
FLASH_BWD_BF16_MEAN = 1e-6


def _flash_counts():
    return (cuda_flash_attn.LAUNCHES, cuda_flash_attn.RES_LAUNCHES,
            cuda_flash_attn.DKV_LAUNCHES, cuda_flash_attn.DQ_LAUNCHES)


def _assert_rel(got, want, rel, what, scale=None):
    """max|got - want| <= rel x max|scale| (scale: want by default)."""
    bound = rel * (want if scale is None else scale).float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
# T not a multiple of the 64-row tiles; the conformer's T'=201; one tile;
# one row; one row past a tile; lengths that empty whole tile pairs (the
# kernels skip those); every length T (no pair skipped)
@pytest.mark.parametrize("B,H,T,fused,lens", [
    (5, 2, 37, False, None), (3, 4, 130, True, None),
    (4, 4, 201, True, None), (2, 1, 64, False, None), (3, 2, 1, True, None),
    (4, 2, 65, False, None), (5, 2, 257, True, (1, 64, 65, 128, 257)),
    (3, 4, 201, True, (201, 201, 201))])
def test_flash_attn_bwd_kernels_match_plain(cuda, B, H, T, dh, dtype, fused,
                                            lens):
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, dtype, 3 * B + T + dh,
                                fused, lens)
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
    # every row, padded queries and keys included. At T = 1 each query
    # attends only itself: ds = (dp - di) p scale is the difference of two
    # float32 sums of the same products, so dq and dk are rounding noise in
    # both versions and max|dq| is no scale for their error: all three are
    # held relative to max|dv| there (dv = do)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(g, w, FLASH_BWD_REL[dtype], f"{name} {dtype} T={T}",
                    scale=want[2] if T == 1 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# head dims on the instance next up: 16 and 20 (32), 48 (64), 80 and 128
# (128); 20 and 17 are not whole 16-byte vectors in bf16 (17 nor in f32):
# their rows are read element by element; 129, 200 and 256 on the wide
# kernels, 320 and 512 on them in pieces of 256 (a ragged last piece, two
# whole ones)
@pytest.mark.parametrize("dh", [16, 20, 48, 80, 128, 17, 129, 200, 256, 320,
                                512])
@pytest.mark.parametrize("fused", [False, True])
def test_flash_attn_head_dims_match_plain(cuda, dh, dtype, fused):
    """Forward (both forms) and backward at B=2, H=4, T'=201 against the
    plain versions, with the tolerances above."""
    B, H, T = 2, 4, 201
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, dtype, dh + 7, fused)
    scale = dh ** -0.5
    c0 = _flash_counts()
    got = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale)
    o, l, m = cuda_flash_attn.flash_attn_cuda(q, k, v, valid, scale,
                                              residuals=True)
    torch.cuda.synchronize()
    assert _flash_counts() == (c0[0] + 1, c0[1] + 1, c0[2], c0[3])
    assert got.shape == (B, H, T, dh) and got.dtype == dtype
    r_o, r_l, r_m = flash_attn.mhsa_plain(q, k, v, valid, scale,
                                          residuals=True)
    atol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * v.abs().max().item()
    torch.testing.assert_close(got.float(), r_o.float(), rtol=0, atol=atol)
    torch.testing.assert_close(o, got, rtol=0, atol=0)
    torch.testing.assert_close(l, r_l, rtol=1e-5, atol=0)
    torch.testing.assert_close(m, r_m, rtol=0, atol=1e-5)
    rng = np.random.default_rng(dh)
    do = torch.from_numpy(rng.standard_normal((B, T, H, dh))).to(
        cuda, dtype).transpose(1, 2)
    di = (r_o.float() * do.float()).sum(-1).contiguous()
    dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(q, k, v, valid, r_l, r_m,
                                                     do, di, scale)
    dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(q, k, v, valid, r_l, r_m, do,
                                                di, scale)
    torch.cuda.synchronize()
    want = flash_attn.mhsa_bwd_plain(q, k, v, valid, r_o, r_l, r_m, do,
                                     scale)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(g, w, FLASH_BWD_REL[dtype], f"{name} {dtype} dh={dh}")


def _bwd_inputs(cuda, B, H, T, dh, dtype, seed, lens=None):
    """Fused q, k, v views, their mask, the plain forward's o, l, m, a
    (B, H, T, dh) view of a (B, T, H, dh) do, and di."""
    q, k, v, valid = _attn_case(cuda, B, H, T, dh, dtype, seed, True, lens)
    o, l, m = flash_attn.mhsa_plain(q, k, v, valid, dh ** -0.5,
                                    residuals=True)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((B, T, H, dh))).to(
        cuda, dtype).transpose(1, 2)
    di = (o.float() * do.float()).sum(-1).contiguous()
    return q, k, v, valid, o, l, m, do, di


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_bwd_kernels_repeat_their_bits(cuda, dtype):
    """No atomics: each output row is summed by one block in a fixed order,
    so a second launch of each kernel gives the same bits."""
    q, k, v, valid, _, l, m, do, di = _bwd_inputs(cuda, 6, 4, 201, 64, dtype,
                                                  17)
    args = (q, k, v, valid, l, m, do, di, 0.125)
    runs = [(*cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args),
             cuda_flash_attn.flash_attn_bwd_dq_cuda(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv", "dq"), *runs):
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.cuda
def test_flash_attn_bwd_bf16_rounds_p_and_ds_where_the_library_does(cuda):
    """The mean error tells the roundings apart (the max cannot): the
    kernels' dq, dk, dv lie within FLASH_BWD_BF16_MEAN of the plain
    backward, a plain backward that keeps p and ds in float32 (do and k
    widened exactly) lies beyond it."""
    B, H, T, dh = 8, 4, 201, 64
    q, k, v, valid, o, l, m, do, di = _bwd_inputs(
        cuda, B, H, T, dh, torch.bfloat16, 23)
    scale = dh ** -0.5
    args = (q, k, v, valid, l, m, do, di, scale)
    dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args)
    dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(*args)
    want = flash_attn.mhsa_bwd_plain(q, k, v, valid, o, l, m, do, scale)
    control = flash_attn.mhsa_bwd_plain(q, k.float(), v, valid, o, l, m,
                                        do.float(), scale)

    def mean_rel(got, ref):
        return ((got.float() - ref.float()).abs().mean()
                / ref.float().abs().max()).item()

    for name, g, c, w in zip(("dq", "dk", "dv"), (dq, dk, dv), control,
                             want):
        assert mean_rel(g, w) <= FLASH_BWD_BF16_MEAN, name
        assert mean_rel(c, w) > FLASH_BWD_BF16_MEAN, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_bwd_launchers_copy_unaligned_inputs(cuda, dtype):
    """Inputs whose address or strides are not multiples of 16 bytes (as
    16-byte cp.async needs) are copied first, not refused."""
    B, H, T, dh = 3, 2, 70, 32
    q, k, v, valid, o, l, m, do, di = _bwd_inputs(cuda, B, H, T, dh, dtype,
                                                  29)
    wide = torch.zeros(B, H, T, dh + 3, dtype=dtype, device=cuda)
    wide[..., 1:dh + 1] = q
    q_odd = wide[..., 1:dh + 1]  # 2 or 4 bytes past alignment, odd strides
    assert q_odd.data_ptr() % 16 != 0
    args = (q_odd, k, v, valid, l, m, do, di, dh ** -0.5)
    dk, dv = cuda_flash_attn.flash_attn_bwd_dkv_cuda(*args)
    dq = cuda_flash_attn.flash_attn_bwd_dq_cuda(*args)
    want = flash_attn.mhsa_bwd_plain(q, k, v, valid, o, l, m, do, dh ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_rel(g, w, FLASH_BWD_REL[dtype], f"{name} {dtype}")


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
        with pytest.raises(ValueError, match="empty"):
            none = q[..., :0]  # no head dim (any dh >= 1 runs)
            fn(none, none, none, valid, ones, ones, none, ones, 0.1)
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
# T not a multiple of a tile's frames or of a block's walk; U+1 across two
# 32-row u-tiles; U = 0; vocabularies inside one chunk of 32 and over
# several (33, 256, 1024: the backward's chunked form), joint dims over
# one piece of 256 (640, 1024)
@pytest.mark.parametrize("B,T,U,J,A", [(3, 37, 5, 32, 9), (2, 45, 40, 100, 28),
                                       (4, 11, 0, 48, 5), (2, 70, 63, 256, 32),
                                       (1, 1, 1, 8, 2), (2, 23, 7, 640, 33),
                                       (2, 19, 40, 256, 256),
                                       (2, 13, 9, 1024, 256),
                                       (1, 9, 5, 640, 1024),
                                       (2, 11, 6, 1024, 1024)])
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
    with pytest.raises(ValueError, match="empty"):
        cuda_joint.joint_fwd_cuda(e, g, W[:, :0], b[:0], labels)
    with pytest.raises(ValueError, match="gy must"):
        cuda_joint.joint_bwd_cuda(*args, gb, gy[:, :, :2])
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


# --- fused-direction BiLSTM: both directions in one launch of
# csrc/lstm_fwd.cu (bilstm_fwd) and one call of csrc/lstm_bwd.cu (bilstm_bwd)

def _bi_case(cuda, B, T, H, dtype, seed):
    xpf, Uf, mask, gyf = _case(cuda, B, T, H, dtype, seed)
    xpb, Ub, _, gyb = _case(cuda, B, T, H, dtype, seed + 1)
    return xpf, xpb, Uf, Ub, mask, torch.cat([gyf, gyb], -1)


# clusters of 8 blocks (H=64, 100, 256, 200 ragged); B=70 more clusters
# than fit at once; B=64 at H=256: 10 rows a cluster (float32) or two n8
# tiles (bfloat16), both directions resident at once; shapes the first
# fused kernels refused: H=300 (clusters of 16), 512, 1024 and 1536 (U's
# columns from L2, fewer rows a cluster past 1024), 8300 (one row a
# cluster, h and the partial dh through global memory)
BI_SHAPES = [(5, 37, 64), (4, 13, 100), (3, 11, 256), (2, 9, 200),
             (70, 5, 32), (64, 9, 256), (3, 7, 300), (4, 6, 512),
             (3, 5, 1024), (2, 4, 1536), (2, 3, 8300)]


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
    for got, want in zip(res, (torch.cat([sf[0], sb[0]], -1), *sf[1:],
                               *sb[1:])):
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,H", BI_SHAPES)
def test_bilstm_bwd_kernel_matches_plain(cuda, B, T, H, dtype, rel):
    """Given the plain forward's residuals, as the single-direction test;
    a second call gives the same bits, and each direction equals a
    single-direction call's bits."""
    xpf, xpb, Uf, Ub, mask, gy = _bi_case(cuda, B, T, H, dtype, 7 * H + T)
    _, *res = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask, residuals=True)
    before = cuda_lstm.BI_BWD_LAUNCHES
    got = cuda_lstm.bilstm_scan_bwd_cuda(xpf, xpb, Uf, Ub, mask, *res, gy)
    again = cuda_lstm.bilstm_scan_bwd_cuda(xpf, xpb, Uf, Ub, mask, *res, gy)
    torch.cuda.synchronize()
    assert cuda_lstm.BI_BWD_LAUNCHES == before + 2
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, again))
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
        assert torch.equal(_bits(g), _bits(want))


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
    # H = 4 hidden units per SM's block, which the first fused kernels
    # refused: launched, both directions zero
    H = 4 * torch.cuda.get_device_properties(cuda).multi_processor_count
    before = _bi_counts()
    x = torch.zeros(1, 2, 4 * H, device=cuda)
    u = torch.zeros(H, 4 * H, device=cuda)
    y = cuda_lstm.bilstm_scan_cuda(x, x, u, u, torch.ones(1, 2, device=cuda))
    torch.cuda.synchronize()
    assert _bi_counts()[3] == before[3] + 1
    assert torch.equal(y, torch.zeros(1, 2, 2 * H, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilstm_layer_fused_autograd_launches_the_kernels(cuda, dtype):
    """bilstm_layer(fuse_directions=True) under autograd: one residual
    bilstm_fwd and one bilstm_bwd launch, no single-direction launch; its
    output equals the unfused layer's bit for bit (each direction is
    lstm_fwd's), and the gradients of x, W, U and b agree within the
    backward's tolerances relative to max|grad| (1e-5 float32, 2e-2
    bfloat16; autograd may add x's two contributions in either order)."""
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
    assert torch.equal(_bits(out[True][0]), _bits(out[False][0]))
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(out[True][1:], out[False][1:]):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=float(rel * b.float().abs().max()))
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


# --- policy-gradient fine-tuning (rl/reinforce.py) on the card

def _pg_case(cuda, dtype, objective):
    """A small BiLSTM-CTC (2 layers, H=32, vocab 12) in `dtype` and one
    batch of three utterances (the last with no labels)."""
    from pg_asr_tpu_torch.config import Config, RLConfig

    cfg = Config(model=ModelConfig(vocab_size=12, input_proj_dim=64,
                                   hidden_size=32, num_layers=2, dropout=0.0,
                                   dtype=dtype),
                 rl=RLConfig(objective=objective, baseline="mean",
                             mwer_beam=4, space_id=1))
    params = bilstm_ctc.init_params(cfg.model,
                                    torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(3)
    ns = np.array([6400, 3000, 2000])
    wave = (rng.standard_normal((3, 6400)) * 3000 * (np.arange(6400)[None]
                                                     < ns[:, None]))
    labels = rng.integers(1, 12, (3, 8))
    labels[1, 5:] = 0
    arrays = [torch.from_numpy(a).to(cuda) for a in (
        wave.astype(np.int16), ns.astype(np.int32), labels.astype(np.int32),
        np.array([8, 5, 0], np.int32))]
    return cfg, params, arrays


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,loss_rtol,grad_rel", [
    ("float32", 1e-4, 1e-3), ("bfloat16", 2e-2, 2.0 ** -4)])
@pytest.mark.parametrize("objective", ["reinforce", "mwer"])
def test_pg_loss_and_gradients_kernel_match_plain(cuda, monkeypatch,
                                                  objective, dtype, loss_rtol,
                                                  grad_rel):
    """The PG loss and every parameter gradient, kernel path (bilstm_fwd /
    bilstm_bwd, F.ctc_loss for the n-best re-scoring and the anchor) vs
    plain path (plain recurrence, CTC recursion), on the same sampled paths
    and the same n-best (both fixed from the kernel path's log-probs, so a
    near-tie cannot send the two paths to other hypotheses; the n-best of
    ctc_beam equals the plain scan's). float32: loss rtol 1e-4, gradients
    atol 1e-3 x max|grad| (as the train step: sums in other orders through
    two layers and two CTC implementations). bfloat16: loss rtol 2e-2,
    gradients atol 2^-4 x max|grad|: h and dpre round to bf16 in both, and
    an ulp apart at one step moves the later steps and the next layer."""
    from pg_asr_tpu_torch.decoding.beam import beam_decode_nbest
    from pg_asr_tpu_torch.predict import forward
    from pg_asr_tpu_torch.rl import reinforce as rl
    from pg_asr_tpu_torch.train import value_and_grad

    cfg, params, arrays = _pg_case(cuda, dtype, objective)
    lp, _, fl = forward(params, arrays[0], arrays[1], cfg)
    paths = rl._sample_paths(torch.Generator(device=cuda).manual_seed(1), lp,
                             4, 1.0)
    L = arrays[2].shape[1]
    nbest = beam_decode_nbest(lp, fl, beam_size=4, max_label_len=L)
    plain = beam_decode_nbest(lp, fl, beam_size=4, max_label_len=L,
                              use_kernel=False)
    assert torch.equal(nbest[0], plain[0]) and torch.equal(nbest[1], plain[1])
    monkeypatch.setattr(rl, "_sample_paths", lambda g, x, S, t: paths)
    monkeypatch.setattr(rl, "beam_decode_nbest", lambda *a, **k: nbest)
    out = {}
    for use_kernel in (True, False):
        (loss, _), grads = value_and_grad(
            lambda p: rl.pg_loss_fn(p, *arrays, None, cfg, use_kernel),
            params)
        out[use_kernel] = loss, grads
    (loss_k, g_k), (loss_p, g_p) = out[True], out[False]
    assert torch.isfinite(loss_k)
    torch.testing.assert_close(loss_k, loss_p, rtol=loss_rtol, atol=1e-6)
    for k in g_p:
        ref = g_p[k].float()
        torch.testing.assert_close(g_k[k].float(), ref, rtol=0,
                                   atol=float(grad_rel * ref.abs().max()),
                                   msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["reinforce", "mwer"])
def test_pg_step_launches_the_kernels(cuda, objective):
    """One PG step: a residual bilstm_fwd and a bilstm_bwd per layer, no
    single-direction or inference launch, and for MWER one ctc_beam launch
    (the n-best); finite parameters after the update."""
    from pg_asr_tpu_torch.rl import reinforce as rl
    from pg_asr_tpu_torch.train import AdamW

    cfg, params, arrays = _pg_case(cuda, "float32", objective)
    step = rl.make_pg_step(cfg, AdamW(cfg, params, learning_rate=5e-5,
                                      weight_decay=1e-4))
    before, beams = _bi_counts(), cuda_beam.LAUNCHES
    loss, metrics = step(params, torch.Generator(device=cuda).manual_seed(0),
                         *arrays)
    torch.cuda.synchronize()
    n = cfg.model.num_layers
    assert [a - b for a, b in zip(_bi_counts(), before)] == [0, 0, 0, 0, n, n]
    assert cuda_beam.LAUNCHES - beams == (objective == "mwer")
    assert torch.isfinite(loss) and torch.isfinite(metrics["reward_mean"])
    assert all(bool(torch.isfinite(p).all()) for p in params.values())


@pytest.mark.cuda
def test_edit_distances_on_card_match_cpu(cuda):
    """The reward DP on CUDA tensors: distances, prefix distances, word
    hashes and WER equal the CPU results (integers, so bit for bit)."""
    from pg_asr_tpu_torch.ops import edit_distance as ed

    rng = np.random.default_rng(4)
    ref = torch.from_numpy(rng.integers(1, 6, (64, 60)).astype(np.int32))
    hyp = torch.from_numpy(rng.integers(1, 6, (64, 401)).astype(np.int32))
    rl = torch.from_numpy(rng.integers(0, 61, 64).astype(np.int32))
    hl = torch.from_numpy(rng.integers(0, 402, 64).astype(np.int32))
    for args in ((ref, rl, hyp, hl), (hyp, hl, ref, rl)):
        on_card = [a.to(cuda) for a in args]
        assert torch.equal(ed.edit_distance(*on_card).cpu(),
                           ed.edit_distance(*args))
        for a, b in zip(ed.edit_distance_prefixes(*on_card),
                        ed.edit_distance_prefixes(*args)):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(ed.word_hash_sequences(on_card[0], on_card[1], 1),
                        ed.word_hash_sequences(args[0], args[1], 1)):
            assert torch.equal(a.cpu(), b)
        assert torch.equal(ed.wer_from_ids(*on_card, 1).cpu(),
                           ed.wer_from_ids(*args, 1))


# --- the supervised recipe's options on the card (plain PyTorch: the JAX
# package computes them in XLA, no kernel): the augmentation applies, the
# accumulated AdamW step and the EMA update on CUDA tensors equal the CPU
# on the same draws and gradients, and a train step with all of them runs
# the encoder's kernels, equal to the plain path on the same draws.

@pytest.mark.cuda
def test_augment_applies_on_card_match_cpu(cuda):
    """The draws made on the CPU, applied on both: float32 within 1e-6
    (sums in other orders), lengths exact; draws from a CUDA generator
    repeat with its seed."""
    from pg_asr_tpu_torch.config import SpecAugmentConfig
    from pg_asr_tpu_torch.ops import augment

    g = torch.Generator().manual_seed(0)
    B, N, T, F = 8, 16000, 101, 80
    ns = torch.randint(1, N + 1, (B,), generator=g, dtype=torch.int32)
    wave = (torch.randn(B, N, generator=g) * 3000).to(torch.int16)
    wave[torch.arange(N)[None] >= ns[:, None]] = 0
    f = torch.rand(B, 1, generator=g) * 0.2 + 0.9
    noise = torch.randn(B, N, generator=g)
    gain = torch.rand(B, 1, generator=g) * 6 - 3
    cpu = augment._wave_apply(wave, ns, f, noise, gain, 0.1)
    card = augment._wave_apply(*(x.to(cuda) for x in (wave, ns, f, noise,
                                                       gain)), 0.1)
    assert torch.equal(card[1].cpu(), cpu[1])
    assert (card[0].cpu() - cpu[0]).abs().max() <= 1e-6

    mask = (torch.arange(T)[None] < (ns[:, None] // 160 + 1)).float()
    feats = torch.randn(B, T, F, generator=g) * mask[:, :, None]
    draws = [*augment._mask_draws(g, 2, 40, mask.sum(1).int(), B, "cpu"),
             *augment._mask_draws(g, 2, 15, torch.full((B,), F), B, "cpu")]
    cpu = augment._spec_apply(feats, mask, *draws)
    card = augment._spec_apply(feats.to(cuda), mask.to(cuda),
                               *(d.to(cuda) for d in draws))
    assert (card.cpu() - cpu).abs().max() <= 1e-6

    cfg = SpecAugmentConfig(enabled=True, speed_min=0.9, speed_max=1.1,
                            noise_std=0.1, gain_db=3.0)
    runs = [augment.wave_augment(wave.to(cuda), ns.to(cuda),
                                 torch.Generator(device=cuda).manual_seed(3),
                                 cfg) for _ in range(2)]
    assert runs[0][0].is_cuda and torch.equal(runs[0][0], runs[1][0])
    out = augment.spec_augment(feats.to(cuda), mask.to(cuda),
                               torch.Generator(device=cuda).manual_seed(3),
                               cfg)
    assert out.is_cuda and out.shape == feats.shape


def _opt_case(device, dtype, scale):
    g = torch.Generator().manual_seed(1)
    params = {f"p{i}": torch.randn(shape, generator=g).to(device, dtype)
              for i, shape in enumerate([(64, 32), (32,), (7, 5, 3)])}
    grads = [{k: (torch.randn(v.shape, generator=g) * s).to(device, dtype)
              for k, v in params.items()} for s in scale]
    return params, grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [False, True])
def test_accumulated_adamw_on_card_matches_cpu(cuda, dtype, clip):
    """--accum_steps 2 over 4 micro-batches on the card and on the CPU:
    unclipped, bf16 bit for bit and float32 rtol 1e-6; clipped, the global
    norm's float32 sum runs in another order, so the clip factor may differ
    in its last bit: rtol 1e-6 in float32, one bf16 ulp (2^-7 relative) in
    bfloat16."""
    from pg_asr_tpu_torch.config import Config, TrainConfig
    from pg_asr_tpu_torch.train import AdamW

    cfg = Config(train=TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                   grad_clip=1.0, weight_decay=0.1,
                                   accum_steps=2))
    scale = (0.5, 9.0, 0.2, 0.3) if clip else (1e-3, 2e-3, 1e-3, 3e-3)
    out = []
    for device in ("cpu", cuda):
        params, grads = _opt_case(device, dtype, scale)
        opt = AdamW(cfg, params)
        for g in grads:
            opt.update(params, g)
        assert opt.count == 2 and opt.mini_step == 0
        out.append((params, opt.mu, opt.nu))
    for cpu, card in zip(*out):
        for k in cpu:
            got = card[k].cpu()
            if dtype == torch.bfloat16 and not clip:
                assert torch.equal(got, cpu[k]), k
            elif dtype == torch.bfloat16:
                torch.testing.assert_close(got, cpu[k], rtol=2 ** -7,
                                           atol=0)
            else:
                torch.testing.assert_close(got, cpu[k], rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ema_update_on_card_matches_cpu(cuda, dtype):
    """Bit for bit: every operation rounds where it does on the CPU (the
    float32 multiply-add in float64, bf16 per operation)."""
    from pg_asr_tpu_torch.train import _ema_update

    out = []
    for device in ("cpu", cuda):
        ema, grads = _opt_case(device, dtype, (1.0, 1.0, 1.0))
        for decay, p in zip((0.999, 0.9, 0.999), grads):
            _ema_update(ema, p, decay)
        out.append(ema)
    assert all(torch.equal(out[1][k].cpu(), out[0][k]) for k in out[0])


@pytest.mark.cuda
def test_recipe_train_step_kernel_matches_plain(cuda):
    """Augmentation (every option), accumulation over 2 micro-batches and
    EMA, dropout 0: the kernel path (3 + 3 fused LSTM launches a
    micro-batch) and the plain path, each from a CUDA generator of one
    seed, so the same draws: losses rtol 1e-4, the parameters and the EMA
    after the emit atol 1e-3 x the largest change of each tensor
    (gradients in other float32 orders, through one AdamW step) plus 4
    float32 ulps of its largest value (the rounding of p + the change)."""
    from pg_asr_tpu_torch.config import Config, SpecAugmentConfig
    from pg_asr_tpu_torch.train import AdamW, _ema_update, make_train_step

    cfg = Config(model=ModelConfig(vocab_size=12, input_proj_dim=64,
                                   hidden_size=32, num_layers=2,
                                   dropout=0.0),
                 augment=SpecAugmentConfig(enabled=True, speed_min=0.9,
                                           speed_max=1.1, noise_std=0.1,
                                           gain_db=3.0))
    cfg = cfg.replace(train=cfg.train.__class__(
        **{**cfg.train.__dict__, "accum_steps": 2, "warmup_steps": 0}))
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(2):
        ns = np.array([6400, 3000, 2000])
        wave = (rng.standard_normal((3, 6400)) * 3000
                * (np.arange(6400)[None] < ns[:, None]))
        batches.append([torch.from_numpy(a).to(cuda) for a in (
            wave.astype(np.int16), ns.astype(np.int32),
            rng.integers(1, 12, (3, 8)).astype(np.int32),
            np.array([8, 5, 3], np.int32))])
    start = bilstm_ctc.init_params(cfg.model,
                                   torch.Generator().manual_seed(0), cuda)
    out = {}
    for use_kernel in (True, False):
        params = {k: v.clone() for k, v in start.items()}
        ema = {k: v.clone() for k, v in start.items()}
        opt = AdamW(cfg, params)
        # a run's moments (as after 100 updates), so that the emitted
        # update is smooth in the gradient (the first Adam step is
        # lr * sign(g), which a near-zero gradient can flip)
        opt.count = 100
        opt.nu = {k: torch.full_like(v, 1e-2) for k, v in params.items()}
        gen = torch.Generator(device=cuda).manual_seed(7)
        step = make_train_step(cfg, opt)
        if not use_kernel:
            from pg_asr_tpu_torch import train as train_mod

            def step(p, g, *arrays):
                loss, grads = train_mod.loss_and_grads(p, arrays, cfg, g,
                                                       use_kernel=False)
                opt.update(p, grads)
                return loss
        before = _bi_counts()
        losses = []
        for arrays in batches:
            losses.append(step(params, gen, *arrays))
            _ema_update(ema, params, 0.9)
        launched = [a - b for a, b in zip(_bi_counts(), before)]
        assert launched == ([0, 0, 0, 0, 4, 4] if use_kernel else [0] * 6)
        out[use_kernel] = torch.stack(losses), params, ema
    (lk, pk, ek), (lp, pp, ep) = out[True], out[False]
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-5)
    eps = torch.finfo(torch.float32).eps
    for got, ref in ((pk, pp), (ek, ep)):
        for k in ref:
            change = (ref[k] - start[k]).abs().max()
            assert change > 0 or "input_proj.b" in k or "ctc_head.b" in k, k
            # and a few ulps of the values the small change is added to
            bound = 1e-3 * change + 4 * eps * ref[k].abs().max()
            assert (got[k] - ref[k]).abs().max() <= bound, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("B", [1, 8])
def test_lstm_kernel_at_the_streamed_window_shapes(cuda, B, dtype, atol):
    """lstm_fwd's reverse form as the streamed LC-BLSTM window runs it:
    T = C + R = 96 frames, H=256, one stream (B=1) or a batched tick
    (B=8), where an idle slot's mask is all zeros (its outputs must stay
    zeros) and a flushed slot's window is partly valid."""
    T, H = 96, 256
    rng = np.random.default_rng(B)
    lens = np.full(B, T)
    if B > 1:
        lens[3], lens[5] = 0, 37
    xp = torch.from_numpy(0.5 * rng.standard_normal((B, T, 4 * H)))
    U = torch.from_numpy(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H))
    mask = torch.from_numpy(np.arange(T)[None] < lens[:, None])
    xp, U = xp.to(cuda, dtype), U.to(cuda, dtype)
    mask = mask.to(cuda, torch.float32)
    before = cuda_lstm.LAUNCHES
    got = lstm_scan(xp, U, mask, reverse=True)
    torch.cuda.synchronize()
    assert cuda_lstm.LAUNCHES == before + 1
    ref = lstm_scan_plain(xp, U, mask, reverse=True)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)
    assert torch.all(got[mask == 0] == 0)
    if B > 1:
        assert not got[3].any()
    assert torch.equal(got, lstm_scan(xp, U, mask, reverse=True))


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_streaming_launches_lstm_fwd_per_layer_and_matches_plain(cuda,
                                                                 decoder):
    """StreamingTranscriber and BatchedStreamingTranscriber on the card:
    one lstm_fwd launch a layer a chunk (the window's backward direction;
    3 streams batched into one launch), the text equal to the plain path
    on the card (use_kernel=False) and to a single stream."""
    from pg_asr_tpu_torch.config import Config, FeatureConfig
    from pg_asr_tpu_torch.data import Alphabet
    from pg_asr_tpu_torch.serving import (BatchedStreamingTranscriber,
                                          StreamingTranscriber)

    cfg = Config(features=FeatureConfig(kind="logmel", n_mels=16, n_fft=128,
                                        win_length=128, hop_length=64),
                 model=ModelConfig(vocab_size=8, input_dim=16,
                                   input_proj_dim=32, hidden_size=64,
                                   num_layers=2, dropout=0.0))
    params = bilstm_ctc.init_params(cfg.model,
                                    torch.Generator().manual_seed(3))
    params["ctc_head.b"] += torch.from_numpy(
        np.random.default_rng(7).standard_normal(8).astype(np.float32) * 2)
    alphabet = Alphabet.from_symbols(list("abcdefg"))
    rng = np.random.default_rng(0)
    waves = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (1600, 2300, 900)]
    kw = dict(chunk_frames=8, right_context=4, decoder=decoder, beam_size=4,
              max_label_len=32)
    single = []
    for wave in waves:
        texts = []
        for use_kernel in (True, False):
            st = StreamingTranscriber(params, cfg, alphabet, device=cuda,
                                      use_kernel=use_kernel, **kw)
            before = cuda_lstm.LAUNCHES
            texts.append(st.push(wave) + st.flush())
            n_chunks = -(-st._frames_done // 8)
            assert cuda_lstm.LAUNCHES - before == (
                2 * n_chunks if use_kernel else 0)
        assert texts[0] == texts[1]
        single.append(texts[0])
    srv = BatchedStreamingTranscriber(params, cfg, alphabet, slots=4,
                                      device=cuda, **kw)
    slots = [srv.open() for _ in waves]
    for s, wave in zip(slots, waves):
        srv.push(s, wave)
    before = cuda_lstm.LAUNCHES
    ticks = 0
    while srv.step():
        ticks += 1
    assert cuda_lstm.LAUNCHES - before == 2 * ticks
    for s in slots:
        srv.flush(s)
    assert [srv.text(s) for s in slots] == single
    assert "".join(single)


# --- the attention seq2seq family (models/seq2seq.py) on the card

def _seq2seq_case(cuda, dtype):
    """A small seq2seq (2 BiLSTM layers of 32, decoder 16 -> 64, vocab 12,
    the output weights x4 for clear argmaxes) in `dtype` on the card, and
    features of three utterances (50, 31 and 12 frames) with targets of 9,
    6 and 0 labels."""
    from pg_asr_tpu_torch.config import Config, Seq2SeqConfig
    from pg_asr_tpu_torch.models import seq2seq

    cfg = Config(model=ModelConfig(family="seq2seq", vocab_size=12,
                                   input_dim=20, input_proj_dim=48,
                                   hidden_size=32, num_layers=2, dropout=0.0,
                                   dtype=dtype),
                 seq2seq=Seq2SeqConfig(vocab_size=12, embed_dim=16,
                                       dec_hidden=64))
    params = seq2seq.init_params(cfg.model, cfg.seq2seq,
                                 torch.Generator().manual_seed(0))
    params["output.w"] *= 4
    params = {k: v.to(cuda) for k, v in params.items()}
    rng = np.random.default_rng(5)
    lens = np.array([50, 31, 12])
    mask = (np.arange(50)[None] < lens[:, None]).astype(np.float32)
    feats = rng.standard_normal((3, 50, 20)).astype(np.float32)
    targets = rng.integers(1, 12, (3, 9))
    targets[1, 6:] = 0
    targets[2] = 0
    arrays = [torch.from_numpy(a).to(cuda) for a in (
        feats, mask, targets.astype(np.int32), np.array([9, 6, 0], np.int32))]
    return cfg, params, arrays


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,loss_rtol,grad_rel", [
    ("float32", 1e-4, 1e-3), ("bfloat16", 2e-2, 2.0 ** -4)])
def test_seq2seq_forward_backward_kernel_matches_plain(cuda, dtype, loss_rtol,
                                                       grad_rel):
    """The teacher-forced loss and every parameter gradient, kernel path
    (bilstm_fwd / bilstm_bwd per encoder layer, the decoder LSTM on
    lstm_fwd's residual form and lstm_bwd: one launch each) vs plain path,
    with the bounds of the PG test above (the same recurrences); without
    autograd the decoder takes lstm_fwd's inference form."""
    from pg_asr_tpu_torch.losses import seq2seq_nll_loss
    from pg_asr_tpu_torch.models import seq2seq
    from pg_asr_tpu_torch.train import value_and_grad

    cfg, params, (feats, mask, targets, lens) = _seq2seq_case(cuda, dtype)
    out = {}
    for use_kernel in (True, False):
        before = _bi_counts()
        loss, grads = value_and_grad(
            lambda p: seq2seq_nll_loss(seq2seq.apply_teacher_forced(
                p, feats, mask, targets, cfg.model, use_kernel=use_kernel),
                targets, lens), params)
        torch.cuda.synchronize()
        n = cfg.model.num_layers
        want = [0, 1, 1, 0, n, n] if use_kernel else [0] * 6
        assert [a - b for a, b in zip(_bi_counts(), before)] == want
        out[use_kernel] = loss, grads
    (loss_k, g_k), (loss_p, g_p) = out[True], out[False]
    assert torch.isfinite(loss_k)
    torch.testing.assert_close(loss_k, loss_p, rtol=loss_rtol, atol=1e-6)
    for k in g_p:
        ref = g_p[k].float()
        torch.testing.assert_close(g_k[k].float(), ref, rtol=0,
                                   atol=float(grad_rel * ref.abs().max()),
                                   msg=k)
    before = _bi_counts()
    with torch.no_grad():
        seq2seq.apply_teacher_forced(params, feats, mask, targets, cfg.model)
    assert [a - b for a, b in zip(_bi_counts(), before)] == [
        1, 0, 0, cfg.model.num_layers, 0, 0]


@pytest.mark.cuda
def test_seq2seq_greedy_and_beam_kernel_match_plain(cuda):
    """Greedy and beam (K=4) decoding over 12 steps, float32: the encoder
    on its kernels vs its plain recurrence, the decoder loops the same:
    equal tokens and lengths, log-probs atol 1e-4, normalized scores rtol
    1e-5; the same on the CPU (plain path)."""
    from pg_asr_tpu_torch.models import seq2seq

    cfg, params, (feats, mask, _, _) = _seq2seq_case(cuda, "float32")
    with torch.no_grad():
        got = {}
        for use_kernel in (True, False):
            toks, lp = seq2seq.greedy_generate(params, feats, mask, cfg.model,
                                               max_steps=12,
                                               use_kernel=use_kernel)
            beam = seq2seq.beam_generate(params, feats, mask, cfg.model,
                                         beam_size=4, max_steps=12,
                                         use_kernel=use_kernel)
            got[use_kernel] = toks, lp, beam
        cpu = {k: v.cpu() for k, v in params.items()}
        toks_c, _ = seq2seq.greedy_generate(cpu, feats.cpu(), mask.cpu(),
                                            cfg.model, max_steps=12)
    (tk, lk, bk), (tp, lpl, bp) = got[True], got[False]
    assert torch.equal(tk, tp) and torch.equal(tk.cpu(), toks_c)
    torch.testing.assert_close(lk, lpl, rtol=0, atol=1e-4)
    assert torch.equal(bk[0], bp[0]) and torch.equal(bk[1], bp[1])
    torch.testing.assert_close(bk[2], bp[2], rtol=1e-5, atol=0)
    assert (tk != 0).any()


def _lm_case(device, vocab: int = 28, seed: int = 0):
    from pg_asr_tpu_torch.decoding.neural_lm import init_lm_params

    return init_lm_params(torch.Generator().manual_seed(seed), vocab,
                          device=device)


@pytest.mark.cuda
def test_lm_teacher_forced_pass_launches_the_kernels(cuda):
    """lm_sequence_logp on CUDA tensors: one inference lstm_fwd a layer
    without autograd, one residual lstm_fwd + one lstm_bwd a layer under
    it; the log-probs within 1e-4 of the plain recurrence's and the
    gradients within 1e-5 x max|grad| (float32 sums in other orders)."""
    from pg_asr_tpu_torch.decoding.neural_lm import lm_sequence_logp
    from pg_asr_tpu_torch.train import value_and_grad

    params = _lm_case(cuda)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 28, (32, 60))).to(cuda)
    lens = torch.from_numpy(rng.integers(0, 61, 32)).to(cuda)
    before = _bi_counts()
    with torch.no_grad():
        got = lm_sequence_logp(params, ids, lens)
    want = lm_sequence_logp(params, ids, lens, use_kernel=False)
    assert [a - b for a, b in zip(_bi_counts(), before)] == [2, 0, 0, 0, 0, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    grads = {}
    for use_kernel in (True, False):
        before = _bi_counts()
        _, grads[use_kernel] = value_and_grad(
            lambda p: -lm_sequence_logp(p, ids, lens, use_kernel).sum()
            / lens.sum(), params)
        if use_kernel:
            assert [a - b for a, b in zip(_bi_counts(), before)] == [
                0, 2, 2, 0, 0, 0]
    for k, g in grads[True].items():
        ref = grads[False][k]
        torch.testing.assert_close(g, ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_rescore_and_fused_search_on_card_match_cpu(cuda):
    """rescore_nbest on CUDA tensors: one ctc_beam launch (the exact
    n-best) and one lstm_fwd a layer (the LM pass), the CPU's labels and
    lens, scores within 1e-5 relative; the fused searches (n-gram and
    neural) on the card launch no kernel: the CPU's labels and lens, nll
    within 1e-5 relative (expf / log1pf of nvcc's and the CPU's, and in
    the neural LM's products float32 sums in another order)."""
    from pg_asr_tpu_torch.decoding.rescore import rescore_nbest

    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 80, 28)) * 2
    lp = torch.from_numpy((x - np.log(np.exp(x).sum(-1, keepdims=True)))
                          .astype(np.float32))
    fl = torch.from_numpy(rng.integers(20, 81, 16).astype(np.int32))
    nlm = _lm_case("cpu")
    before, beams = _bi_counts(), cuda_beam.LAUNCHES
    got = rescore_nbest(lp.to(cuda), fl.to(cuda), nlm, beam_size=16,
                        max_label_len=80)
    assert cuda_beam.LAUNCHES - beams == 1
    assert [a - b for a, b in zip(_bi_counts(), before)] == [2, 0, 0, 0, 0, 0]
    want = rescore_nbest(lp, fl, nlm, beam_size=16, max_label_len=80)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=0)
    tab = np.log(rng.dirichlet(np.ones(28), (28, 28))).astype(np.float32)
    for kw in ({"lm": tab}, {"lm": tab[0]}, {"neural_lm": nlm}):
        before, beams = _bi_counts(), cuda_beam.LAUNCHES
        got = beam.beam_decode(lp.to(cuda), fl.to(cuda), beam_size=16,
                               max_label_len=80, lm_weight=0.5,
                               length_bonus=0.2, **kw)
        assert cuda_beam.LAUNCHES == beams and _bi_counts() == before
        want = beam.beam_decode(lp, fl, beam_size=16, max_label_len=80,
                                lm_weight=0.5, length_bonus=0.2, **kw)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=0)


# --- the serving ops (ops/registry.py) and the exported program
# (exporting.py) on the card: each pgasr op's CUDA implementation launches
# its kernel once and holds the tolerances above against its plain version;
# an artifact exported on the card gives the live forward's ids.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 4e-3)])
def test_pgasr_bilstm_fwd_op_matches_plain(cuda, dtype, atol):
    g = torch.Generator().manual_seed(7)
    B, T, H = 6, 40, 64
    lens = torch.tensor([T, 1, 17, 33, 2, 40])
    mask = (torch.arange(T)[None] < lens[:, None]).float().to(cuda)
    xpf, xpb = ((0.5 * torch.randn(B, T, 4 * H, generator=g)).to(cuda, dtype)
                for _ in range(2))
    Uf, Ub = (((torch.rand(H, 4 * H, generator=g) * 2 - 1) / 8).to(
        cuda, dtype) for _ in range(2))
    before = _bi_counts()
    got = torch.ops.pgasr.bilstm_fwd(xpf, xpb, Uf, Ub, mask)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_bi_counts(), before)] == [0, 0, 0, 1, 0, 0]
    want = bilstm_scan_plain(xpf, xpb, Uf, Ub, mask)
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("nbest", [False, True])
def test_pgasr_ctc_beam_op_matches_plain(cuda, nbest):
    lp, fl = _beam_case(cuda, 16, 120, 28, 5)
    before = cuda_beam.LAUNCHES
    got = torch.ops.pgasr.ctc_beam(lp, fl, 16, 6, 120, 0, nbest)
    assert cuda_beam.LAUNCHES == before + 1
    want = beam.ctc_beam_plain(lp, fl, 16, 6, 120, 0, nbest)
    assert got[0].shape == (16, 16 if nbest else 1, 120)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    assert int(want[1].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pgasr_flash_attn_op_matches_plain(cuda, dtype):
    q, k, v, valid = _attn_case(cuda, 4, 4, 201, 64, dtype, 11, fused=True)
    before = cuda_flash_attn.LAUNCHES
    got = torch.ops.pgasr.flash_attn(q, k, v, valid, 0.125)
    torch.cuda.synchronize()
    assert cuda_flash_attn.LAUNCHES == before + 1
    assert got.shape == (4, 201, 4, 64) and got.is_contiguous()
    want = flash_attn.mhsa_plain(q, k, v, valid, 0.125).transpose(1, 2)
    atol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * v.abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("family,decoder", [("ctc", "beam"),
                                            ("conformer", "greedy"),
                                            ("transducer", "greedy")])
def test_exported_artifact_on_card_equals_live(cuda, tmp_path, family,
                                               decoder):
    """A small model (random weights from a seed) exported on the card
    (cpu,cuda for the BiLSTM-CTC): the loaded program's ids and lens equal
    the live serving function's on the card (and on the CPU), and the
    program launches the kernels of its pgasr nodes."""
    from pg_asr_tpu_torch.checkpoint import save_model
    from pg_asr_tpu_torch.config import (Config, ConformerConfig,
                                         FeatureConfig)
    from pg_asr_tpu_torch.data import Alphabet, make_synthetic_corpus
    from pg_asr_tpu_torch.exporting import (EXPORT_DIR, ExportedModel,
                                            export_model, make_serving_fn)
    from pg_asr_tpu_torch.ops import registry
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import init_model_params

    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, n_utts=4, seed=11, min_dur=0.2, max_dur=0.3)
    alphabet = Alphabet.load(corpus + "/alphabet.txt")
    cfg = Config(features=FeatureConfig(kind="logmel", n_mels=16),
                 model=ModelConfig(family=family, vocab_size=alphabet.size,
                                   input_dim=16, input_proj_dim=32,
                                   hidden_size=32, num_layers=2, dropout=0.0),
                 conformer=ConformerConfig(num_layers=2, d_model=64,
                                           num_heads=2, ffn_dim=64,
                                           flash_attention=True))
    model_dir = str(tmp_path / family)
    save_model(model_dir, init_model_params(
        cfg, torch.Generator().manual_seed(3), "cpu"), cfg)
    platforms = ("cpu", "cuda") if family == "ctc" else ()
    m = export_model(model_dir, corpus, batch_size=4, max_seconds=2.0,
                     decoder=decoder, beam_size=8 if decoder == "beam" else 0,
                     platforms=platforms, device="cuda")
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((4, 32000)) * 0.1).astype(np.float32)
    ns = np.array([32000, 9000, 20000, 4000], np.int32)
    params, cfg = load_model(model_dir, alphabet, device=cuda)
    fn = make_serving_fn(params, cfg, decoder=decoder,
                         beam_size=m["beam_size"])
    with torch.inference_mode():
        want = fn(torch.from_numpy(wave).to(cuda), torch.from_numpy(ns).to(
            cuda))
    for dev in (platforms or ("cuda",)):
        ex = ExportedModel(f"{model_dir}/{EXPORT_DIR}", device=dev)
        before = {op: getattr(mod, name)
                  for op, (mod, name) in registry.OPS.items()}
        ids, lens = ex(wave, ns)
        launched = {op: getattr(mod, name) - before[op]
                    for op, (mod, name) in registry.OPS.items()}
        assert np.array_equal(ids, want[0].cpu().numpy()), dev
        assert np.array_equal(lens, want[1].cpu().numpy()), dev
        if dev == "cuda":
            assert {op: n for op, n in launched.items() if n} == m[
                "pgasr_ops"]
        else:
            assert not any(launched.values())
    assert m["pgasr_ops"]


# ------------------------------------------------ the switch-MoE transformer
# (parallel/moe.py: no kernel of its own; its expert products are
# torch.bmm). Card vs CPU in float32: the routing (expert, slot, kept)
# equal on every valid token where the router's top-2 margin exceeds 1e-5
# (asserted), the FFN's output atol 1e-5 and its gradients atol 1e-5 x
# max|grad| (cuBLAS against the CPU's sums); one MoE loss and every
# gradient, loss rtol 1e-5, gradients atol 1e-4 x max|grad| (through two
# blocks and the CTC loss, F.ctc_loss's CUDA backward against its CPU one).

def _moe_block(E, seed):
    from pg_asr_tpu_torch.parallel import moe

    g = torch.Generator().manual_seed(seed)
    d, f = 32, 64
    p = {"b.router.w": torch.randn(d, E, generator=g),
         "b.router.b": torch.full((E,), 0.1),
         "b.w1": torch.randn(E, d, f, generator=g) * 0.2,
         "b.b1": torch.full((E, f), 0.1),
         "b.w2": torch.randn(E, f, d, generator=g) * 0.2,
         "b.b2": torch.full((E, d), 0.1)}
    x = torch.randn(4, 37, d, generator=g)
    valid = torch.arange(37)[None] < torch.tensor([37, 30, 12, 1])[:, None]
    return moe, p, x, valid


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [148, 20])
def test_moe_ffn_on_card_matches_cpu(cuda, capacity):
    moe, p, x, valid = _moe_block(4, seed=0)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    res = {}
    for dev in ("cpu", cuda):
        q = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        r = moe.route(q, "b", xd, valid.to(dev), capacity)
        out, aux = moe._moe_ffn(q, "b", xd, valid.to(dev), capacity)
        grads = torch.autograd.grad((out * cot.to(dev)).sum() + aux,
                                    [xd, *q.values()])
        res[str(dev)] = (r, out.detach().cpu(), aux.item(),
                         [g.cpu() for g in grads])
    (rc, oc, ac, gc), (rg, og, ag, gg) = res["cpu"], res[str(cuda)]
    v = valid.reshape(-1)
    top2 = rc.probs.detach().topk(2, dim=-1).values
    assert (top2[:, 0] - top2[:, 1])[v].min() > 1e-5
    for f in ("expert", "pos", "kept"):
        assert torch.equal(getattr(rg, f).cpu()[v], getattr(rc, f)[v]), f
    assert (~rc.kept[v]).any() == (capacity < 148)
    torch.testing.assert_close(og, oc, rtol=0, atol=1e-5)
    assert abs(ag - ac) <= 1e-6 * abs(ac)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


@pytest.mark.cuda
def test_moe_loss_on_card_matches_cpu(cuda):
    from pg_asr_tpu_torch.config import Config, TransformerConfig
    from pg_asr_tpu_torch.train import init_model_params, loss_and_grads

    cfg = Config(model=ModelConfig(family="transformer", vocab_size=9,
                                   input_dim=80),
                 transformer=TransformerConfig(num_layers=2, d_model=32,
                                               num_heads=2, ffn_dim=64,
                                               dropout=0.0, num_experts=4))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    ns = np.array([16000, 9000, 4000], np.int32)
    wave = np.where(np.arange(16000)[None] < ns[:, None],
                    rng.standard_normal((3, 16000)) * 3000,
                    0).astype(np.int16)
    labels = rng.integers(1, 9, (3, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 2], np.int32)
    batch = [torch.from_numpy(a) for a in (wave, ns, labels, label_lens)]
    loss_c, g_c = loss_and_grads(params, batch, cfg)
    loss_g, g_g = loss_and_grads({k: v.to(cuda) for k, v in params.items()},
                                 [a.to(cuda) for a in batch], cfg)
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    for k, g in g_c.items():
        torch.testing.assert_close(g_g[k].cpu(), g, rtol=0,
                                   atol=1e-4 * g.abs().max().item(),
                                   msg=lambda m, k=k: f"{k}: {m}")
    assert g_c["blocks.0.router.w"].abs().max() > 0


def _mesh_case():
    """A BiLSTM-CTC of 2 layers of 64 units (dropout 0, a constant rate)
    and a global batch of 6 ragged rows of int16 audio, on the host."""
    from pg_asr_tpu_torch.config import Config, TrainConfig
    from pg_asr_tpu_torch.train import init_model_params

    cfg = Config(model=ModelConfig(vocab_size=9, input_dim=80,
                                   input_proj_dim=64, hidden_size=64,
                                   num_layers=2, dropout=0.0),
                 train=TrainConfig(warmup_steps=0, learning_rate=1e-3))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    ns = np.array([16000, 9000, 12000, 4000, 16000, 7000], np.int32)
    wave = np.where(np.arange(16000)[None] < ns[:, None],
                    rng.standard_normal((6, 16000)) * 3000,
                    0).astype(np.int16)
    labels = rng.integers(1, 9, (6, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 6, 2, 8, 4], np.int32)
    return cfg, params, (wave, ns, labels, label_lens)


@pytest.mark.cuda
def test_world1_nccl_step_equals_the_step_without_a_mesh(cuda):
    """In an NCCL group of one: the data-parallel step's loss equals the
    one-device step's bit for bit from the same state, its gradient
    all-reduce is the identity, and the kernels launch as without a mesh."""
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.train import (AdamW, loss_and_grads,
                                        make_train_step)

    cfg, params, batch = _mesh_case()
    arrays = [torch.from_numpy(a).to(cuda) for a in batch]
    mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                          device=cuda)
    try:
        dp = mesh.GroupRank(cuda)
        runs = {}
        for name, with_dp in (("plain", mesh.ONE_DEVICE), ("mesh", dp)):
            p = {k: v.to(cuda) for k, v in params.items()}
            before = _bi_counts()
            loss = make_train_step(cfg, AdamW(cfg, p), with_dp)(
                p, torch.Generator(device=cuda).manual_seed(0), *arrays)
            runs[name] = (loss, p, tuple(
                a - b for a, b in zip(_bi_counts(), before)))
        _, grads = loss_and_grads(runs["plain"][1], arrays, cfg)
        summed = dp.sum_grads(grads)
    finally:
        mesh.destroy_distributed()
    assert torch.equal(runs["mesh"][0], runs["plain"][0])
    assert runs["mesh"][2] == runs["plain"][2] == (0, 0, 0, 0, 2, 2)
    assert all(torch.equal(summed[k], grads[k]) for k in grads)
    for k, v in runs["plain"][1].items():  # F.ctc_loss's atomic backward
        torch.testing.assert_close(runs["mesh"][1][k], v, rtol=1e-5,
                                   atol=1e-6)


# one of two ranks on the card over gloo: its rows of the global batch, two
# data-parallel steps; losses, launches, the first step's all-reduced
# gradients and the parameters into OUT
_CUDA_RANK = r"""
import sys
import numpy as np
import torch
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.parallel import mesh
from pg_asr_tpu_torch.train import AdamW, make_train_step

spec_path, out, rank, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
spec = torch.load(spec_path, weights_only=False)
dev = torch.device("cuda", 0)
mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=dev)
summed = []


class Recorded(mesh.GroupRank):
    def sum_grads(self, grads):
        out = super().sum_grads(grads)
        if not summed:
            summed.append({k: v.cpu() for k, v in out.items()})
        return out


dp = Recorded(dev)
cfg = Config.from_json(spec["config"])
params = {k: v.to(dev) for k, v in spec["params"].items()}
arrays = [torch.from_numpy(a).to(dev)
          for a in mesh.local_rows(spec["batch"], rank, 2)]
step = make_train_step(cfg, AdamW(cfg, params), dp)
gen = torch.Generator().manual_seed(0)
losses = [step(params, gen, *arrays).item() for _ in range(2)]
torch.save({"losses": losses, "launches": (cuda_lstm.BI_RES_LAUNCHES,
                                           cuda_lstm.BI_BWD_LAUNCHES),
            "grads": summed[0],
            "params": {k: v.cpu() for k, v in params.items()}}, out)
mesh.destroy_distributed()
"""


@pytest.mark.cuda
def test_two_rank_gloo_step_on_the_card_matches_one_process(cuda, tmp_path):
    """Two rank processes on cuda:0 over gloo (NCCL takes one rank a
    device), 3 rows each of a global batch of 6: the first step's
    all-reduced gradients equal the whole batch's gradients, every element,
    within rtol 1e-4 / atol 1e-5 of the tensor's largest (a mean for the
    sum, or a rank counted twice, would be off by half or more); after 2
    steps the losses and parameters hold the one-process steps' within the
    CPU tests' rtol 1e-4 / atol 1e-5 (the parameters where every step's
    gradient exceeds the CPU tests' 1e-6: AdamW's direction is rounding
    noise below), each rank launching the kernels on its rows."""
    import os
    import subprocess
    import sys

    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.train import AdamW, loss_and_grads

    cfg, params, batch = _mesh_case()
    spec = str(tmp_path / "spec.pt")
    torch.save({"config": cfg.to_json(), "params": params, "batch": batch},
               spec)
    script = str(tmp_path / "rank.py")
    with open(script, "w") as fo:
        fo.write(_CUDA_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    port = str(mesh.free_port())
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, script, spec, outs[r], str(r),
                               port], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(o, weights_only=False) for o in outs]

    p_ref = {k: v.to(cuda) for k, v in params.items()}
    arrays = [torch.from_numpy(a).to(cuda) for a in batch]
    opt, losses, first = AdamW(cfg, p_ref), [], None
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p_ref.items()}
    for _ in range(2):
        loss, grads = loss_and_grads(p_ref, arrays, cfg)
        losses.append(loss.item())
        first = first or {k: g.cpu() for k, g in grads.items()}
        sure = {k: sure[k] & (grads[k].abs() > 1e-6) for k in sure}
        opt.update(p_ref, grads)
    for rk in ranks:
        np.testing.assert_allclose(rk["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        assert rk["launches"] == (4, 4)  # 2 layers x 2 steps, each
        for k, g in first.items():  # every element, no mask
            np.testing.assert_allclose(
                rk["grads"][k].numpy(), g.numpy(), rtol=1e-4,
                atol=1e-5 * g.abs().max().item(), err_msg=k)
        for k, v in p_ref.items():
            m = sure[k].cpu()
            np.testing.assert_allclose(rk["params"][k][m].numpy(),
                                       v.cpu()[m].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in p_ref)


_CUDA_TENSOR_RANK = r"""
import dataclasses, sys
import torch
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.ops import cuda_flash_attn, flash_attn
from pg_asr_tpu_torch.parallel import mesh
from pg_asr_tpu_torch.train import AdamW, make_plan, make_train_step

spec_path, out, rank, port = sys.argv[1:5]
spec = torch.load(spec_path, weights_only=False)
dev = torch.device("cuda", 0)
mesh.init_distributed(f"127.0.0.1:{port}", 2, int(rank), backend="gloo",
                      device=dev)
cfg = Config.from_json(spec["config"])
cfg = cfg.replace(train=dataclasses.replace(cfg.train, mesh_shape=(2,),
                                            mesh_axes=("model",)))
dp = mesh.GroupRank(dev, make_plan(cfg))
params = dp.shard({k: v.to(dev) for k, v in spec["params"].items()})
arrays = [torch.from_numpy(a).to(dev) for a in spec["batch"]]
heads, mhsa = set(), flash_attn.mhsa


def counted(q, *args, **kwargs):
    heads.add(int(q.shape[1]))
    return mhsa(q, *args, **kwargs)


flash_attn.mhsa = counted
step = make_train_step(cfg, AdamW(cfg, params, dp=dp), dp)
gen = torch.Generator().manual_seed(0)
losses = [step(params, gen, *arrays).item() for _ in range(2)]
torch.save({"losses": losses, "heads": sorted(heads),
            "launches": (cuda_flash_attn.RES_LAUNCHES,
                         cuda_flash_attn.DKV_LAUNCHES,
                         cuda_flash_attn.DQ_LAUNCHES),
            "params": {k: v.cpu() for k, v in dp.unshard(params).items()}},
           out)
mesh.destroy_distributed()
"""


@pytest.mark.cuda
def test_two_rank_model_axis_on_the_card_matches_one_process(cuda, tmp_path):
    """model=2 on a conformer of 2 blocks, d 64, 4 heads, with
    flash_attention: two rank processes on cuda:0 over gloo, each running
    its 2 heads through the flash kernels (residual forward, dkv, dq: one
    launch a block a step) and its halves of the FFNs and the convolution
    module, against the one-process steps on the same batch: the losses
    and the gathered parameters after 2 steps within rtol 1e-4 / atol
    1e-5 (where every step's gradient exceeds 1e-6), the ranks equal."""
    import os
    import subprocess
    import sys

    from pg_asr_tpu_torch.config import Config, ConformerConfig, TrainConfig
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.train import AdamW, init_model_params, loss_and_grads

    _, _, batch = _mesh_case()
    cfg = Config(model=ModelConfig(family="conformer", vocab_size=9,
                                   input_dim=80, dropout=0.0),
                 conformer=ConformerConfig(num_layers=2, d_model=64,
                                           num_heads=4, ffn_dim=128,
                                           dropout=0.0, flash_attention=True),
                 train=TrainConfig(warmup_steps=0, learning_rate=1e-3))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = str(tmp_path / "spec.pt")
    torch.save({"config": cfg.to_json(), "params": params, "batch": batch},
               spec)
    script = str(tmp_path / "rank.py")
    with open(script, "w") as fo:
        fo.write(_CUDA_TENSOR_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    port = str(mesh.free_port())
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, script, spec, outs[r], str(r),
                               port], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(o, weights_only=False) for o in outs]

    p_ref = {k: v.to(cuda) for k, v in params.items()}
    arrays = [torch.from_numpy(a).to(cuda) for a in batch]
    opt, losses = AdamW(cfg, p_ref), []
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p_ref.items()}
    for _ in range(2):
        loss, grads = loss_and_grads(p_ref, arrays, cfg)
        losses.append(loss.item())
        sure = {k: sure[k] & (grads[k].abs() > 1e-6) for k in sure}
        opt.update(p_ref, grads)
    for rk in ranks:
        np.testing.assert_allclose(rk["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        assert rk["heads"] == [2]
        assert rk["launches"] == (4, 4, 4)  # 2 blocks x 2 steps
        for k, v in p_ref.items():
            m = sure[k].cpu()
            np.testing.assert_allclose(rk["params"][k][m].numpy(),
                                       v.cpu()[m].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in p_ref)


# one of two ranks of an expert=2 or fsdp=2 mesh on the card over gloo: the
# whole global batch (expert) or its rows (fsdp), its parts of the split
# leaves, two steps; losses, launches, the first step's reduced gradients
# (its parts), the gathered parameters and its resident bytes into OUT
_CUDA_SHARD_RANK = r"""
import dataclasses, sys
import torch
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.ops import cuda_lstm
from pg_asr_tpu_torch.parallel import mesh
from pg_asr_tpu_torch.parallel.driver import parse_mesh_spec
from pg_asr_tpu_torch.train import AdamW, make_plan, make_train_step

spec_path, out, rank, port, spec_mesh = sys.argv[1:6]
rank = int(rank)
spec = torch.load(spec_path, weights_only=False)
dev = torch.device("cuda", 0)
mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device=dev)
summed = []


class Recorded(mesh.GroupRank):
    def sum_grads(self, grads):
        out = super().sum_grads(grads)
        if not summed:
            summed.append({k: v.cpu() for k, v in out.items()})
        return out


cfg = Config.from_json(spec["config"])
shape, axes = parse_mesh_spec(spec_mesh)
cfg = cfg.replace(train=dataclasses.replace(cfg.train, mesh_shape=shape,
                                            mesh_axes=axes))
dp = Recorded(dev, make_plan(cfg))
params = dp.shard({k: v.to(dev) for k, v in spec["params"].items()})
arrays = [torch.from_numpy(a).to(dev)
          for a in mesh.local_rows(spec["batch"], dp.rank, dp.world)]
opt = AdamW(cfg, params, dp=dp)
step = make_train_step(cfg, opt, dp)
gen = torch.Generator().manual_seed(0)
losses = [step(params, gen, *arrays).item() for _ in range(2)]
resident = sum(t.numel() * t.element_size()
               for tree in (params, opt.mu, opt.nu) for t in tree.values())
torch.save({"losses": losses, "launches": (cuda_lstm.BI_RES_LAUNCHES,
                                           cuda_lstm.BI_BWD_LAUNCHES),
            "grads": summed[0], "resident": resident,
            "params": {k: v.cpu() for k, v in dp.unshard(params).items()}},
           out)
mesh.destroy_distributed()
"""


def _moe_case():
    """A switch-MoE transformer of 2 blocks, d 64, 4 experts (dropout 0, a
    constant rate) and _mesh_case's batch, on the host."""
    from pg_asr_tpu_torch.config import Config, TrainConfig, TransformerConfig
    from pg_asr_tpu_torch.train import init_model_params

    _, _, batch = _mesh_case()
    cfg = Config(model=ModelConfig(family="transformer", vocab_size=9,
                                   input_dim=80, dropout=0.0),
                 transformer=TransformerConfig(
                     num_layers=2, d_model=64, num_heads=4, ffn_dim=128,
                     dropout=0.0, num_experts=4, capacity_factor=1.25),
                 train=TrainConfig(warmup_steps=0, learning_rate=1e-3))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("spec_mesh", ["expert=2", "fsdp=2"])
def test_two_rank_sharded_step_on_the_card_matches_one_process(
        cuda, tmp_path, spec_mesh):
    """expert=2 on the switch-MoE (the ranks take the same rows and half
    the experts each) and fsdp=2 on the BiLSTM-CTC (their own rows, half
    of every divisible leaf): two rank processes on cuda:0 over gloo
    against the one-process steps, as the data axis's card test holds it:
    the first step's reduced gradients (each rank's part) equal the
    whole batch's, every element, within rtol 1e-4 / atol 1e-5 of the
    tensor's largest; after 2 steps the losses and the gathered parameters
    within rtol 1e-4 / atol 1e-5 (where every step's gradient exceeds
    1e-6), the ranks equal; each rank holds less than one process's
    parameters and moments, and under fsdp launches the BiLSTM kernels on
    its rows."""
    import os
    import subprocess
    import sys

    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.parallel.driver import (ParallelPlan,
                                                  parse_mesh_spec)
    from pg_asr_tpu_torch.train import AdamW, loss_and_grads

    cfg, params, batch = (_moe_case() if spec_mesh == "expert=2"
                          else _mesh_case())
    spec = str(tmp_path / "spec.pt")
    torch.save({"config": cfg.to_json(), "params": params, "batch": batch},
               spec)
    script = str(tmp_path / "rank.py")
    with open(script, "w") as fo:
        fo.write(_CUDA_SHARD_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    port = str(mesh.free_port())
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, script, spec, outs[r], str(r),
                               port, spec_mesh], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(o, weights_only=False) for o in outs]

    plan = ParallelPlan(cfg, *parse_mesh_spec(spec_mesh))
    p_ref = {k: v.to(cuda) for k, v in params.items()}
    arrays = [torch.from_numpy(a).to(cuda) for a in batch]
    opt, losses, first = AdamW(cfg, p_ref), [], None
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p_ref.items()}
    for _ in range(2):
        loss, grads = loss_and_grads(p_ref, arrays, cfg)
        losses.append(loss.item())
        first = first or {k: g.cpu() for k, g in grads.items()}
        sure = {k: sure[k] & (grads[k].abs() > 1e-6) for k in sure}
        opt.update(p_ref, grads)
    whole = sum(t.numel() * t.element_size()
                for tree in (p_ref, opt.mu, opt.nu) for t in tree.values())
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        assert rk["resident"] < 0.8 * whole
        assert rk["launches"] == ((0, 0) if spec_mesh == "expert=2"
                                  else (4, 4))  # 2 layers x 2 steps
        coords = plan.coords(r)
        for k, g in first.items():  # every element, no mask
            where = plan.placement(k, tuple(g.shape))
            if where is not None:
                g = mesh.shard_leaf(g, where[1], coords[where[0]], 2)
            np.testing.assert_allclose(
                rk["grads"][k].numpy(), g.numpy(), rtol=1e-4,
                atol=1e-5 * g.abs().max().item(), err_msg=k)
        for k, v in p_ref.items():
            m = sure[k].cpu()
            np.testing.assert_allclose(rk["params"][k][m].numpy(),
                                       v.cpu()[m].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in p_ref)


# one of two ranks of a pipe=2 or seq=2 mesh on the card over gloo (the
# pipeline's activations and gradients staged through the host, the seq
# group's gathers and reduce-scatters): the whole global batch, two steps;
# losses, the flash launches and the gathered parameters into OUT
_CUDA_PIPE_RANK = r"""
import dataclasses, sys
import torch
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.ops import cuda_flash_attn
from pg_asr_tpu_torch.parallel import mesh
from pg_asr_tpu_torch.parallel.driver import parse_mesh_spec
from pg_asr_tpu_torch.train import AdamW, make_plan, make_train_step

spec_path, out, rank, port, spec_mesh = sys.argv[1:6]
spec = torch.load(spec_path, weights_only=False)
dev = torch.device("cuda", 0)
mesh.init_distributed(f"127.0.0.1:{port}", 2, int(rank), backend="gloo",
                      device=dev)
cfg = Config.from_json(spec["config"])
shape, axes = parse_mesh_spec(spec_mesh)
cfg = cfg.replace(train=dataclasses.replace(cfg.train, mesh_shape=shape,
                                            mesh_axes=axes))
dp = mesh.GroupRank(dev, make_plan(cfg))
params = dp.shard({k: v.to(dev) for k, v in spec["params"].items()})
arrays = [torch.from_numpy(a).to(dev) for a in spec["batch"]]
step = make_train_step(cfg, AdamW(cfg, params, dp=dp), dp)
gen = torch.Generator().manual_seed(0)
losses = [step(params, gen, *arrays).item() for _ in range(2)]
torch.save({"losses": losses,
            "launches": (cuda_flash_attn.LAUNCHES,
                         cuda_flash_attn.RES_LAUNCHES,
                         cuda_flash_attn.DKV_LAUNCHES,
                         cuda_flash_attn.DQ_LAUNCHES),
            "held": sorted(params),
            "params": {k: v.cpu() for k, v in dp.unshard(params).items()}},
           out)
mesh.destroy_distributed()
"""


@pytest.mark.cuda
@pytest.mark.parametrize("spec_mesh", ["pipe=2", "seq=2"])
def test_two_rank_pipe_and_seq_on_the_card_match_one_process(cuda, tmp_path,
                                                             spec_mesh):
    """pipe=2 (M=2) and seq=2 on a transformer of 2 blocks, d 64, 4 heads,
    with flash_attention: two rank processes on cuda:0 over gloo (the
    pipeline's sends staged through the host) against the one-process
    steps (the flash kernels) on the same batch: the losses and the
    gathered parameters after 2 steps within rtol 1e-4 / atol 1e-5 (where
    every step's gradient exceeds 1e-6), the ranks equal; the mesh launches
    no flash kernel (the dense attention, as the JAX package's pipe and
    seq steps), and a pipe rank holds its stage's block only."""
    import os
    import subprocess
    import sys

    from pg_asr_tpu_torch.config import Config, TrainConfig, TransformerConfig
    from pg_asr_tpu_torch.parallel import mesh
    from pg_asr_tpu_torch.train import AdamW, init_model_params, loss_and_grads

    _, _, batch = _mesh_case()
    cfg = Config(model=ModelConfig(family="transformer", vocab_size=9,
                                   input_dim=80, dropout=0.0),
                 transformer=TransformerConfig(num_layers=2, d_model=64,
                                               num_heads=4, ffn_dim=128,
                                               dropout=0.0,
                                               flash_attention=True),
                 train=TrainConfig(warmup_steps=0, learning_rate=1e-3))
    params = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = str(tmp_path / "spec.pt")
    torch.save({"config": cfg.to_json(), "params": params, "batch": batch},
               spec)
    script = str(tmp_path / "rank.py")
    with open(script, "w") as fo:
        fo.write(_CUDA_PIPE_RANK)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    port = str(mesh.free_port())
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, script, spec, outs[r], str(r),
                               port, spec_mesh], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = [torch.load(o, weights_only=False) for o in outs]

    p_ref = {k: v.to(cuda) for k, v in params.items()}
    arrays = [torch.from_numpy(a).to(cuda) for a in batch]
    opt, losses = AdamW(cfg, p_ref), []
    sure = {k: torch.ones_like(v, dtype=torch.bool) for k, v in p_ref.items()}
    for _ in range(2):
        loss, grads = loss_and_grads(p_ref, arrays, cfg)
        losses.append(loss.item())
        sure = {k: sure[k] & (grads[k].abs() > 1e-6) for k in sure}
        opt.update(p_ref, grads)
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        assert rk["launches"] == (0, 0, 0, 0)
        blocks = {k.split(".")[1] for k in rk["held"]
                  if k.startswith("blocks.")}
        assert blocks == ({str(r)} if spec_mesh == "pipe=2" else {"0", "1"})
        for k, v in p_ref.items():
            m = sure[k].cpu()
            np.testing.assert_allclose(rk["params"][k][m].numpy(),
                                       v.cpu()[m].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in p_ref)
