"""The BiLSTM encoder's route through the fused-direction layer
(pg_asr_tpu_torch/models/bilstm_ctc.py ``encode``: each layer's two
directions in one walk, ``bilstm_layer(fuse_directions=True)``), and the
fused layer at a hidden size the first fused-direction kernels refused, vs
the JAX package on the same seeded numpy inputs and converted weights.

On CPU tensors the route runs the plain versions (``bilstm_scan_plain``,
``bilstm_scan_bwd_plain``), as the kernels' wrappers do for any CPU tensor;
the kernel entry points refuse CPU tensors.

Tolerances (float32): log-probs atol 1e-4 (tests/test_torch_bilstm_ctc.py's:
the same algorithm through two BiLSTM layers, summation order only); the
loss rtol 1e-4 and each gradient rtol 1e-4, atol 3e-5 x max|grad| of its
tensor (float32 sums in other orders through two layers and the CTC
recursion: the worst at this batch is 1.3e-5 x max|grad|, the same on the
fused layers and two single-direction walks a layer, which give equal
bits); the fused layer's output and gradients rtol 1e-4, atol 1e-5
(tests/test_torch_bilstm_fused.py's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.ops.lstm import bilstm_layer as jax_bilstm_layer
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.models import bilstm_ctc
from pg_asr_tpu_torch.ops import cuda_lstm, lstm
from pg_asr_tpu_torch.train import loss_and_grads

INTERPRET = jax.default_backend() != "tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JCFG = JConfig(model=JModelConfig(vocab_size=9, input_proj_dim=32,
                                  hidden_size=16, num_layers=2, dropout=0.0,
                                  use_pallas_lstm=False))
CFG = Config.from_json(JCFG.to_json())


def _jax_tree(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed),
                                          JCFG.model))


def _wave_batch(seed=0):
    rng = np.random.default_rng(seed)
    ns = np.array([6400, 4000, 2500], np.int32)
    wave = np.where(np.arange(6400)[None] < ns[:, None],
                    rng.standard_normal((3, 6400)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, 9, (3, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 3], np.int32)
    for b in range(3):
        labels[b, label_lens[b]:] = 0
    return wave, ns, labels, label_lens


def _fuse_flags(monkeypatch, force=None):
    """Record the fuse_directions of every bilstm_layer the encoder calls;
    where ``force`` is not None, run each layer with that value instead."""
    flags = []
    layer = bilstm_ctc.bilstm_layer

    def spy(*args, **kwargs):
        flags.append(kwargs.get("fuse_directions", False))
        if force is not None:
            kwargs["fuse_directions"] = force
        return layer(*args, **kwargs)

    monkeypatch.setattr(bilstm_ctc, "bilstm_layer", spy)
    return flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_fuses_every_layer(monkeypatch, dtype):
    """Every layer asks for the fused walk, in both state types, CPU tensors
    included, and the fused route launches nothing on CPU tensors."""
    flags = _fuse_flags(monkeypatch)
    params = {k: v.to(dtype) for k, v in params_from_jax(_jax_tree()).items()}
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((2, 11, 80)).astype(
        np.float32))
    mask = torch.ones(2, 11)
    counts = (cuda_lstm.LAUNCHES, cuda_lstm.BI_LAUNCHES)
    cfg = Config.from_json(JConfig(model=JModelConfig(
        vocab_size=9, input_proj_dim=32, hidden_size=16, num_layers=2,
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32")).to_json())
    with torch.no_grad():
        out = bilstm_ctc.apply(params, feats, mask, cfg.model)
    assert out.shape == (2, 11, 9) and torch.isfinite(out).all()
    assert flags == [True, True]
    assert (cuda_lstm.LAUNCHES, cuda_lstm.BI_LAUNCHES) == counts


def test_routed_log_probs_match_jax():
    """The encoder on its route (CPU tensors: the plain versions) vs the
    JAX package's apply: log-probs of a ragged batch, float32."""
    tree = _jax_tree()
    rng = np.random.default_rng(2)
    lens = np.array([30, 17, 1, 24])
    mask = (np.arange(30)[None] < lens[:, None]).astype(np.float32)
    feats = rng.standard_normal((4, 30, 80)).astype(np.float32) * mask[
        :, :, None]
    ref = jax_model.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(feats), jnp.asarray(mask), JCFG.model)
    got = bilstm_ctc.apply(params_from_jax(tree), torch.from_numpy(feats),
                           torch.from_numpy(mask), CFG.model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert np.all(got.numpy()[mask == 0] == 0.0)


def test_routed_ctc_loss_and_gradients_match_jax(monkeypatch):
    """The train path's CTC loss and every parameter gradient, through the
    encoder's route under autograd (BiLSTMScan's plain residual forward and
    bilstm_scan_bwd_plain), vs the JAX package's compute_loss and jax.grad,
    dropout 0; and the same bits as two single-direction walks a layer."""
    flags = _fuse_flags(monkeypatch)
    tree = _jax_tree(3)
    batch = _wave_batch(4)
    key = jax.random.PRNGKey(1)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: jax_train.compute_loss(p, *map(jnp.asarray, batch), JCFG,
                                         train=True, dropout_rng=key))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    r_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads))
    arrays = [torch.from_numpy(a) for a in batch]
    loss, grads = loss_and_grads(params_from_jax(tree), arrays, CFG)
    assert flags == [True, True]
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-4)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=3e-5 * np.abs(ref).max(), err_msg=k)
    # each layer as two single-direction walks: equal bits
    _fuse_flags(monkeypatch, force=False)
    other_loss, other = loss_and_grads(params_from_jax(tree), arrays, CFG)
    assert flags[2:] == [False, False]
    assert torch.equal(other_loss, loss)
    assert all(torch.equal(other[k], g) for k, g in grads.items())


# H = 67: odd, and past #SMs / 2 at 132 SMs, a size the first fused-
# direction kernels refused (they held 1, 2 or 4 units of a direction per
# SM's block)
B, T, I, H = 3, 9, 8, 67
LENS = np.array([9, 4, 1])
MASK = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)


def test_fused_layer_at_odd_h_matches_jax_pallas():
    """bilstm_layer(fuse_directions=True) vs JAX's bilstm_layer(use_pallas=
    True, fuse_directions=True) (pallas_bilstm_scan in interpret mode, as
    tests/test_torch_bilstm_fused.py runs it) at H=67: output and the
    gradients of x, W, U and b of both directions, float32."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    params = {d: {"W": (rng.uniform(-1, 1, (I, 4 * H)) / 4).astype(np.float32),
                  "U": (rng.uniform(-1, 1, (H, 4 * H)) / 8).astype(np.float32),
                  "b": rng.standard_normal(4 * H).astype(np.float32)}
              for d in ("fwd", "bwd")}
    gy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)

    def f(p, x):
        y = jax_bilstm_layer(p, x, jnp.asarray(MASK), use_pallas=True,
                             fuse_directions=True, interpret=INTERPRET)
        return jnp.sum(y * gy), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    ref = [np.asarray(y), np.asarray(gx)] + [
        np.asarray(gp[d][k]) for d in ("fwd", "bwd") for k in ("W", "U", "b")]

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {d: {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()} for d, p in params.items()}
    ty = lstm.bilstm_layer(tp, tx, torch.from_numpy(MASK),
                           fuse_directions=True)
    ty.backward(torch.from_numpy(gy))
    got = [ty.detach().numpy(), tx.grad.numpy()] + [
        tp[d][k].grad.numpy() for d in ("fwd", "bwd") for k in ("W", "U", "b")]
    assert got[0].shape == (B, T, 2 * H)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=i)


def _launch_cases():
    rng = np.random.default_rng(8)
    xpf, xpb = (torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(
        np.float32)) for _ in range(2))
    Uf, Ub = (torch.from_numpy(rng.uniform(-1, 1, (H, 4 * H)).astype(
        np.float32) / 8) for _ in range(2))
    mask = torch.from_numpy(MASK)
    gy = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(
        np.float32))
    _, hpf, cpf, hpb, cpb = lstm.bilstm_scan_plain(xpf, xpb, Uf, Ub, mask,
                                                   residuals=True)
    return {
        "lstm_scan_cuda": (xpf, Uf, mask),
        "lstm_scan_residual_cuda": (xpf, Uf, mask, True),
        "lstm_scan_bwd_cuda": (xpf, Uf, mask, hpf, cpf,
                               gy[..., :H].contiguous()),
        "bilstm_scan_cuda": (xpf, xpb, Uf, Ub, mask),
        "bilstm_scan_residual_cuda": (xpf, xpb, Uf, Ub, mask),
        "bilstm_scan_bwd_cuda": (xpf, xpb, Uf, Ub, mask, hpf, cpf, hpb, cpb,
                                 gy),
    }


@pytest.mark.parametrize("launcher", sorted(_launch_cases()))
def test_launchers_refuse_cpu_tensors(launcher):
    """Every launcher of csrc/lstm_fwd.cu and csrc/lstm_bwd.cu checks its
    arguments before it builds or launches anything: CPU tensors raise, no
    counter moves, and no plain version runs in its place."""
    args = _launch_cases()[launcher]
    names = ("LAUNCHES", "RES_LAUNCHES", "BWD_LAUNCHES", "BI_LAUNCHES",
             "BI_RES_LAUNCHES", "BI_BWD_LAUNCHES")
    before = [getattr(cuda_lstm, n) for n in names]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(cuda_lstm, launcher)(*args)
    assert [getattr(cuda_lstm, n) for n in names] == before
