"""The switch-MoE transformer in the port (pg_asr_tpu_torch/parallel/moe.py
and its wiring: models.acoustic_forward, train.py, the CLI, finetune_pg,
export, the flax reader) vs the JAX package's (pg_asr_tpu/parallel/moe.py),
on the same seeded numpy inputs and the same weights carried across by
``convert.params_from_jax``.

Sizes: the switch FFN alone at B=3, T=9 (valid 9, 6, 2), d 32, ffn 64; the
encoder at 2 blocks, d_model 32, 2 heads, ffn 64, E=4, on 3 utterances of
0.4, 0.25 and 0.16 s (T' = 17, 11 and 7); the CLI at the full default
width (6 blocks, d_model 256, E=4) on a corpus of 16 clips of 0.2-0.4 s.

Tolerances (float32): the FFN's outputs atol 1e-5 and aux rtol 1e-6 (the
same algorithm, summation order only: torch.bmm against XLA's dot); the
routing (expert, slot, kept) exactly equal, which is well posed because
the JAX router's top-2 probability margin exceeds 1e-5 on every valid
token (asserted); log-probs atol 1e-4 and the loss and every gradient rtol
1e-4 of the max |grad| (tests/test_torch_attn_train.py's bounds, through
two blocks, the CTC loss and their gradients). bfloat16: the frameworks
round at different points, so the FFN output may move by a few bf16 ulps
of its largest value (atol 2^-5 x max|out|) and the log-probs by those of
the activations (tests/test_torch_conformer.py's atol 0.15, mean 1e-2).
The index dispatch against the one-hot einsum form: bit for bit in
float32, forward and gradients.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.checkpoint import save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig, TrainConfig, TransformerConfig
from pg_asr_tpu.ops.features import extract_features
from pg_asr_tpu.ops.quant import quantize_tree as jax_quantize_tree
from pg_asr_tpu.parallel import moe as jm
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.exporting import ExportedModel, make_serving_fn
from pg_asr_tpu_torch.models import acoustic_forward, transformer_ctc
from pg_asr_tpu_torch.models.bilstm_ctc import linear
from pg_asr_tpu_torch.ops.quant import quantize_tree
from pg_asr_tpu_torch.parallel import moe
from pg_asr_tpu_torch.predict import forward, load_model
from pg_asr_tpu_torch.train import AdamW, init_model_params, loss_and_grads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 9
B, T, D, FF = 3, 9, 32, 64
LENS = np.array([9, 6, 2])


def _config(E=4, dropout=0.0, capacity_factor=1.25) -> JConfig:
    return JConfig(
        model=ModelConfig(family="transformer", vocab_size=VOCAB,
                          input_dim=80),
        transformer=TransformerConfig(num_layers=2, d_model=32, num_heads=2,
                                      ffn_dim=64, dropout=dropout,
                                      num_experts=E,
                                      capacity_factor=capacity_factor),
        train=TrainConfig(warmup_steps=0, learning_rate=1e-3))


def _batch():
    rng = np.random.default_rng(0)
    ns = np.array([6400, 4000, 2500], np.int32)
    wave = np.where(np.arange(6400)[None] < ns[:, None],
                    rng.standard_normal((3, 6400)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, VOCAB, (3, 6)).astype(np.int32)
    label_lens = np.array([6, 4, 0], np.int32)  # row 2: no labels
    for b in range(3):
        labels[b, label_lens[b]:] = 0
    return wave, ns, labels, label_lens


def _features(batch):
    feats, mask, lens = extract_features(
        *(jnp.asarray(a) for a in batch[:2]), JConfig().features)
    return tuple(np.asarray(a) for a in (feats, mask, lens))


def _tree(jcfg: JConfig, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_train.init_model_params(
        jax.random.PRNGKey(seed), jcfg))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_moe_apply(jcfg):
    return jax.jit(lambda p, f, m, n: jm.moe_apply(p, f, m, n, jcfg))


# ------------------------------------------------------- the switch FFN

def _ffn_inputs(E, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    valid = np.arange(T)[None] < LENS[:, None]
    blk = {"router": {"w": rng.standard_normal((D, E)).astype(np.float32),
                      "b": np.full((E,), 0.1, np.float32)},
           "w1": (rng.standard_normal((E, D, FF)) * 0.2).astype(np.float32),
           "b1": np.full((E, FF), 0.1, np.float32),
           "w2": (rng.standard_normal((E, FF, D)) * 0.2).astype(np.float32),
           "b2": np.full((E, D), 0.1, np.float32)}
    return x, valid, blk


def _port_block(blk, dtype=torch.float32):
    return {f"b.{k}": v.to(dtype) for k, v in params_from_jax(blk).items()}


def _jax_routing(blk, x, valid, capacity):
    """The JAX package's routing lines (parallel/moe.py _moe_ffn) on its
    router: expert, slot, kept, and the top-2 probability margin."""
    N = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(N, -1)
    tv = jnp.asarray(valid).reshape(N).astype(jnp.float32)
    logits = (xt @ blk["router"]["w"] + blk["router"]["b"]).astype(
        jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, probs.shape[1]) * tv[:, None]
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot,
                  axis=-1).astype(jnp.int32)
    top2 = jnp.sort(probs, axis=-1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0]) if probs.shape[1] > 1 else None
    return (np.asarray(expert), np.asarray(pos), np.asarray(pos < capacity),
            None if margin is None else np.asarray(margin))


# capacities per expert count: ample (every token kept) and tight (some
# valid tokens dropped)
CAPACITIES = {1: (27, 10), 2: (27, 5), 4: (27, 3)}


@pytest.mark.parametrize("which", [0, 1], ids=["ample", "tight"])
@pytest.mark.parametrize("E", [1, 2, 4])
def test_moe_ffn_matches_jax(E, which):
    capacity = CAPACITIES[E][which]
    x, valid, blk = _ffn_inputs(E)
    j_out, j_aux = jm._moe_ffn(_jnp(blk), jnp.asarray(x), jnp.asarray(valid),
                               capacity)
    p = _port_block(blk)
    out, aux = moe._moe_ffn(p, "b", torch.from_numpy(x),
                            torch.from_numpy(valid), capacity)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-6)

    expert, pos, kept, margin = _jax_routing(_jnp(blk), x, valid, capacity)
    v = valid.reshape(-1)
    if margin is not None:
        assert margin[v].min() > 1e-5
    r = moe.route(p, "b", torch.from_numpy(x), torch.from_numpy(valid),
                  capacity)
    assert np.array_equal(r.expert.numpy()[v], expert[v])
    assert np.array_equal(r.pos.numpy()[v], pos[v])
    assert np.array_equal(r.kept.numpy()[v], kept[v])
    assert not r.kept.numpy()[~v].any()
    dropped = v & ~r.kept.numpy()
    assert dropped.any() == (which == 1)
    # a dropped or padded token's FFN output is exactly 0
    assert (out.reshape(-1, D)[torch.from_numpy(~r.kept.numpy())] == 0).all()


def test_moe_ffn_bf16_matches_jax():
    E, capacity = 4, 3
    x, valid, blk = _ffn_inputs(E)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), blk)
    j_out, j_aux = jm._moe_ffn(bf, jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(valid), capacity)
    p = _port_block(blk, torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, aux = moe._moe_ffn(p, "b", xb, torch.from_numpy(valid), capacity)
    ref = np.asarray(j_out.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -5 * np.abs(ref).max())
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-2)


def _one_hot_ffn(params, pre, x, token_valid, capacity):
    """The JAX package's dispatch and combine through the (N, E, C)
    one-hot tensor and einsums, in torch: the oracle of the index form."""
    Bx, Tx, d = x.shape
    N = Bx * Tx
    xt = x.reshape(N, d)
    tv = token_valid.reshape(N).float()
    probs = torch.softmax(linear(params, f"{pre}.router", xt).float(), -1)
    E = probs.shape[1]
    expert = torch.argmax(probs, -1)
    gate = torch.amax(probs, -1)
    onehot = F.one_hot(expert, E).float() * tv[:, None]
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1).long()
    keep = (pos < capacity).float()
    slot = (pos[:, None] == torch.arange(capacity)[None]).float()
    dispatch = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
    xin = torch.einsum("nec,nd->ecd", dispatch, xt.float()).to(x.dtype)
    h = F.gelu(torch.einsum("ecd,edf->ecf", xin, params[f"{pre}.w1"])
               + params[f"{pre}.b1"][:, None, :], approximate="tanh")
    y = (torch.einsum("ecf,efd->ecd", h, params[f"{pre}.w2"])
         + params[f"{pre}.b2"][:, None, :])
    out = torch.einsum("nec,ecd->nd", dispatch, y.float())
    out = (out * gate[:, None]).to(x.dtype).reshape(Bx, Tx, d)
    n_valid = torch.clamp(tv.sum(), min=1.0)
    frac = onehot.sum(0) / n_valid
    mean_p = (probs * tv[:, None]).sum(0) / n_valid
    return out, E * torch.sum(frac * mean_p)


@pytest.mark.parametrize("E", [2, 4])
def test_index_dispatch_is_bit_equal_to_one_hot_form(E):
    """Forward and every gradient (x, router, experts) of sum(out * g) +
    aux, equal bit for bit, at a capacity that drops tokens."""
    capacity = CAPACITIES[E][1]
    x, valid, blk = _ffn_inputs(E, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        x.shape).astype(np.float32))
    res = []
    for fn in (moe._moe_ffn, _one_hot_ffn):
        p = {k: v.requires_grad_(True) for k, v in _port_block(blk).items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        out, aux = fn(p, "b", xt, torch.from_numpy(valid), capacity)
        leaves = [xt, *p.values()]
        grads = torch.autograd.grad((out * g).sum() + aux, leaves)
        res.append((out.detach(), aux.detach(), grads))
    (o1, a1, g1), (o2, a2, g2) = res
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert g1[1].abs().max() > 0  # the router's gradient


def test_one_expert_equals_dense_and_jax_anchor():
    """With one expert and ample capacity the MoE encoder is the dense
    transformer (gate 1): the port's MoE log-probs equal its dense ones,
    and its make_moe_loss equals the JAX package's (aux = 1 exactly)."""
    jcfg = _config(E=0)
    cfg = Config.from_json(jcfg.to_json())
    dense_tree = _tree(jcfg)
    feats = _features(_batch())
    tf = [torch.from_numpy(a) for a in feats]
    dense = params_from_jax(dense_tree)
    want, _, _ = transformer_ctc.apply(dense, *tf, cfg.model,
                                       cfg.transformer)
    one = moe.moe_params_from_dense(dense, 1, torch.Generator().manual_seed(0))
    x, out_mask, _, aux = moe.moe_encode(one, *tf, cfg, capacity=10_000)
    got, _ = transformer_ctc.ctc_head(one, x, out_mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert aux.item() == 1.0

    j_moe = jm.moe_params_from_dense(_jnp(dense_tree), 1,
                                     jax.random.PRNGKey(1))
    batch = _batch()
    N = 3 * 17
    j_loss = jax.jit(jm.make_moe_loss(jcfg, 1, capacity=N))(
        j_moe, *map(jnp.asarray, batch))
    t_loss = moe.make_moe_loss(cfg, 1, capacity=N, use_kernel=False)(
        params_from_jax(jax.tree_util.tree_map(np.asarray, j_moe)),
        *(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)


# ------------------------------------------------------------ the encoder

def _router_margin(monkeypatch, fn):
    """fn() with the port's route recorded -> (fn's result, the smallest
    top-2 router margin over the valid tokens of every block)."""
    margins = []
    real = moe.route

    def recording(params, pre, x, token_valid, capacity):
        r = real(params, pre, x, token_valid, capacity)
        if r.probs.shape[1] > 1:
            top2 = r.probs.detach().float().topk(2, dim=-1).values
            m = (top2[:, 0] - top2[:, 1])[token_valid.reshape(-1)]
            margins.append(m.min().item())
        return r

    monkeypatch.setattr(moe, "route", recording)
    out = fn()
    monkeypatch.setattr(moe, "route", real)
    return out, min(margins)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(dtype, monkeypatch):
    jcfg = _config()
    jcfg = jcfg.replace(model=ModelConfig(**{**jcfg.model.__dict__,
                                             "dtype": dtype}))
    cfg = Config.from_json(jcfg.to_json())
    tree = _tree(jcfg)
    feats = _features(_batch())
    ref, ref_mask, ref_lens = _jax_moe_apply(jcfg)(
        _jnp(tree), *map(jnp.asarray, feats))
    params = {k: v for k, v in params_from_jax(tree).items()}
    (got, mask, lens), margin = _router_margin(monkeypatch, lambda: (
        acoustic_forward(params, *(torch.from_numpy(a) for a in feats),
                         cfg)))
    if dtype == "float32":
        assert margin > 1e-4
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))
    assert np.array_equal(lens.numpy(), np.asarray(ref_lens))
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    else:
        err = np.abs(got.float().numpy() - ref)
        assert err.max() < 0.15 and err.mean() < 1e-2, (err.max(),
                                                         err.mean())


def test_moe_loss_terms_and_gradients_match_jax():
    jcfg = _config()
    cfg = Config.from_json(jcfg.to_json())
    tree = _tree(jcfg, seed=3)
    feats = _features(_batch())
    labels, label_lens = _batch()[2:]
    args = (*feats, labels, label_lens)

    def j_loss(p):
        num, den = jm.moe_loss_terms(p, *map(jnp.asarray, args), jcfg)
        return jnp.sum(num / jnp.maximum(den, 1.0)), (num, den)

    (r_loss, (r_num, r_den)), r_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(_jnp(tree))
    r_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads))

    from pg_asr_tpu_torch.train import value_and_grad

    def t_loss(p):
        num, den = moe.moe_loss_terms(
            p, *(torch.from_numpy(a) for a in args), cfg, use_kernel=False)
        return torch.sum(num / torch.clamp(den, min=1.0)), num, den

    (loss, num, den), grads = value_and_grad(t_loss, params_from_jax(tree))
    np.testing.assert_allclose(num.detach().numpy(), np.asarray(r_num),
                               rtol=1e-4)
    np.testing.assert_array_equal(den.numpy(), np.asarray(r_den))
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-4)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    assert grads["blocks.0.router.w"].abs().max() > 0


def test_moe_capacity_matches_jax():
    jcfg, cfg = _config(), Config.from_json(_config().to_json())
    for b in (1, 3, 64):
        for frames in (1, 7, 401, 1000):
            for E in (1, 2, 4, 8):
                for cf in (0.5, 1.0, 1.25, 2.0):
                    assert moe.moe_capacity(cfg, b, frames, E, cf) == \
                        jm.moe_capacity(jcfg, b, frames, E, cf)


def test_dropout_sites_match_jax(monkeypatch):
    """The same uint8 bits, site by site in call order (1 + 2L sites, the
    dense transformer's), into both packages' MoE encoders."""
    from pg_asr_tpu.models import bilstm_ctc as jax_bilstm

    jcfg = _config(dropout=0.1)
    cfg = Config.from_json(jcfg.to_json())
    feats = _features(_batch())
    tree = _tree(jcfg)
    keys = [jax.random.PRNGKey(100 + i) for i in range(8)]
    j_shapes, t_shapes = [], []
    real = jax_bilstm._dropout

    def jax_dropout(x, rate, rng, train):
        key = keys[len(j_shapes)]
        j_shapes.append(tuple(x.shape))
        return real(x, rate, key, train)

    def port_bits(x, rate, generator, train):
        key = keys[len(t_shapes)]
        t_shapes.append(tuple(x.shape))
        return torch.from_numpy(np.array(jax.random.bits(
            key, tuple(x.shape), dtype=jnp.uint8)))

    monkeypatch.setattr(jax_bilstm, "_dropout", jax_dropout)
    monkeypatch.setattr(moe, "dropout_bits", port_bits)
    cap = jm.moe_capacity(jcfg, 3, feats[0].shape[1], 4, 1.25)
    x, _, _, aux = jm.moe_encode(_jnp(tree), *map(jnp.asarray, feats), jcfg,
                                 cap, train=True,
                                 dropout_rng=jax.random.PRNGKey(9))
    got, _, _, t_aux = moe.moe_encode(
        params_from_jax(tree), *(torch.from_numpy(a) for a in feats), cfg,
        cap, train=True, generator=torch.Generator())
    assert len(t_shapes) == 5 and j_shapes == t_shapes
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(x), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(t_aux.item(), float(aux), rtol=1e-5)


def test_one_train_step_matches_jax():
    """Loss, every gradient and every updated parameter of one train step
    (dropout 0) vs the JAX package's make_train_step."""
    jcfg = _config()
    cfg = Config.from_json(jcfg.to_json())
    batch = _batch()
    tree = _tree(jcfg, seed=4)
    key = jax.random.PRNGKey(1)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train.compute_loss(p, *map(jnp.asarray, batch), jcfg,
                                         train=True, dropout_rng=key)))(
        _jnp(tree))
    opt = jax_train.make_optimizer(jcfg)
    j_params = _jnp(tree)
    new_j, _, _, j_loss = jax_train.make_train_step(jcfg, opt)(
        j_params, opt.init(j_params), key, *map(jnp.asarray, batch))
    new_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    r_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads))

    params = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in r_grads.items()}
    params = params_from_jax(tree)
    loss, grads = loss_and_grads(params, [torch.from_numpy(a) for a in batch],
                                 cfg)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    # the updated params: the port's AdamW on JAX's gradients and on its
    # own, where |g| >> Adam's eps = 1e-8 (the first step moves a param by
    # lr * g / (|g| + eps), ill-conditioned in g where |g| is near eps, as
    # the key bias's gradient, ~0 by the softmax's shift invariance; the
    # jitted step's gradients differ from the eager ones by rounding)
    on_ref = {k: v.clone() for k, v in params.items()}
    AdamW(cfg, on_ref).update(on_ref, r_grads)
    AdamW(cfg, params).update(params, grads)
    for k, p in params.items():
        want = new_j[k].numpy()
        sure = np.abs(r_grads[k].numpy()) > 1e-6
        for got in (on_ref[k], p):
            np.testing.assert_allclose(got.numpy()[sure], want[sure], rtol=0,
                                       atol=1e-5, err_msg=k)


def test_flax_checkpoint_of_an_moe_model_is_served(tmp_path):
    """A model_best.ckpt written by the JAX package's checkpoint code is
    read by the port (no flax), its tree carried both ways exactly, and its
    log-probs equal the JAX package's."""
    jcfg = _config()
    tree = _tree(jcfg, seed=5)
    d = str(tmp_path / "jax_moe")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    save_checkpoint(os.path.join(d, "model_best.ckpt"), {"params": tree})

    class Alpha:  # load_model reads only the size
        size = VOCAB

    params, cfg = load_model(d, Alpha(), device="cpu")
    assert cfg.transformer.num_experts == 4
    assert params["blocks.1.w1"].shape == (4, 32, 64)
    back = params_to_jax(params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        assert np.array_equal(got, leaf), path
    wave, ns = _batch()[:2]
    got, _, _ = forward(params, torch.from_numpy(wave), torch.from_numpy(ns),
                        cfg)
    feats = _features(_batch())
    ref, _, _ = _jax_moe_apply(jcfg)(_jnp(tree), *map(jnp.asarray, feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def moe_slice(tmp_path_factory):
    """`--mode train --model moe` at full width for an epoch, a resume for
    a second without --model; the JAX package's model dir of its weights."""
    d = tmp_path_factory.mktemp("moe_slice")
    corpus, alphabet = make_synthetic_corpus(str(d / "corpus"), n_utts=16,
                                             seed=0, min_dur=0.2,
                                             max_dur=0.4)
    model = str(d / "model")
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path",
            model, "--batch_size", "4", "--device", "cpu"]
    assert cli.main(argv + ["--num_epochs", "1", "--model", "moe"]) == 0
    assert cli.main(argv + ["--num_epochs", "2"]) == 0
    jax_dir = str(d / "jax_model")
    os.makedirs(jax_dir)
    shutil.copy(os.path.join(model, "config.json"), jax_dir)
    state = load_checkpoint(os.path.join(model, "model_best.pt"))
    save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                    {"params": params_to_jax(state["params"])})
    return corpus, alphabet, model, jax_dir


def test_cli_moe_train_resume(moe_slice, capsys):
    corpus, _, model, _ = moe_slice
    with open(os.path.join(model, "config.json")) as fo:
        saved = json.load(fo)
    assert saved["model"]["family"] == "transformer"
    assert saved["transformer"]["num_experts"] == 4
    assert saved["transformer"]["capacity_factor"] == 1.25
    state = torch.load(os.path.join(model, "model_last.pt"),
                       weights_only=True)
    assert state["step"] == 6 and state["epoch"] == 2
    assert state["params"]["blocks.5.w1"].shape == (4, 256, 1024)
    assert state["params"]["blocks.5.router.w"].shape == (256, 4)
    tl = np.load(os.path.join(model, "train_loss.npy"))
    assert tl.shape == (2,) and np.isfinite(tl).all()


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_cli_moe_predict_matches_jax_package(moe_slice, decoder, capsys,
                                             monkeypatch):
    """The same predicted.txt as the JAX package's predict on the same
    weights and batches (the capacity follows the padded batch in both).
    Fair bar: every valid frame's top two log-probs lie more than 2e-4
    apart and every router's top two probabilities more than 1e-4 apart
    (asserted)."""
    corpus, alphabet, model, jax_dir = moe_slice
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest

    params, cfg = load_model(model, alphabet, device="cpu")
    utts = load_manifest(paths["test_path"], paths["aud_path"])
    for b in BatchIterator(utts, alphabet, 32, shuffle=False):
        (lp, mask, _), margin = _router_margin(monkeypatch, lambda: forward(
            params, torch.from_numpy(b.wave),
            torch.from_numpy(b.num_samples), cfg))
        assert margin > 1e-4
        top2 = lp.topk(2, dim=-1).values
        assert (top2[..., 0] - top2[..., 1])[mask > 0].min() > 2e-4
    jax_predict(**paths, model_path=jax_dir, batch_size=32, decoder=decoder,
                beam_size=4)
    with open(os.path.join(jax_dir, "predicted.txt")) as fo:
        ref_txt = fo.read()
    capsys.readouterr()
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", model, "--device", "cpu", "--decoder",
                     decoder, "--batch_size", "32", "--beam_size", "4"]) == 0
    assert "CER:" in capsys.readouterr().out
    with open(os.path.join(model, "predicted.txt")) as fo:
        got_txt = fo.read()
    assert got_txt == ref_txt
    assert any(line.split("|")[1] for line in got_txt.splitlines())


def test_cli_moe_flags_are_stored_in_config(moe_slice, tmp_path):
    corpus = moe_slice[0]
    model = str(tmp_path / "m")
    assert cli.main(["--mode", "train", "--corpus_path", corpus,
                     "--model_path", model, "--batch_size", "4",
                     "--num_epochs", "1", "--device", "cpu", "--model",
                     "moe", "--moe_experts", "2", "--capacity_factor",
                     "2.0"]) == 0
    with open(os.path.join(model, "config.json")) as fo:
        saved = json.load(fo)["transformer"]
    assert saved["num_experts"] == 2 and saved["capacity_factor"] == 2.0
    state = torch.load(os.path.join(model, "model_best.pt"),
                       weights_only=True)
    assert state["params"]["blocks.0.w2"].shape == (2, 1024, 256)


@pytest.mark.parametrize("objective", ["reinforce", "mwer"])
def test_cli_moe_finetune_pg_step(moe_slice, tmp_path, objective):
    corpus, _, model, _ = moe_slice
    d = str(tmp_path / "pg")
    os.makedirs(d)
    for name in ("config.json", "model_best.pt"):
        shutil.copy(os.path.join(model, name), d)
    assert cli.main(["--mode", "finetune_pg", "--corpus_path", corpus,
                     "--model_path", d, "--pg_steps", "1", "--batch_size",
                     "4", "--pg_eval_every", "0", "--pg_objective",
                     objective, "--mwer_beam", "2", "--device",
                     "cpu"]) == 0
    rewards = np.load(os.path.join(d, "pg_rewards.npy"))
    assert rewards.shape == (1,) and np.isfinite(rewards).all()
    before = load_checkpoint(os.path.join(model, "model_best.pt"))["params"]
    after = load_checkpoint(os.path.join(d, "model_last.pt"))["params"]
    assert not torch.equal(before["blocks.0.w1"], after["blocks.0.w1"])


@pytest.mark.parametrize("flags", [[], ["--decoder", "beam", "--beam_size",
                                        "4"], ["--export_quantize", "int8"]],
                         ids=["greedy", "beam", "int8"])
def test_cli_moe_export(moe_slice, flags):
    """The artifact's ids equal the live serving function's; the int8 tree
    (expert stacks included) equals the JAX package's quantize_tree."""
    corpus, alphabet, d, _ = moe_slice
    assert cli.main(["--mode", "export", "--corpus_path", corpus,
                     "--model_path", d, "--export_batch", "2",
                     "--export_seconds", "0.5", "--device", "cpu",
                     *flags]) == 0
    ex = ExportedModel(os.path.join(d, "export"), device="cpu")
    m = ex.manifest
    params, cfg = load_model(d, alphabet, device="cpu")
    quant = "int8" if "int8" in flags else ""
    live = make_serving_fn(params, cfg, decoder=m["decoder"],
                           beam_size=m["beam_size"], quantize=quant)
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    ns = np.array([8000, 5000], np.int32)
    ids, lens = ex(wave, ns)
    with torch.inference_mode():
        want_ids, want_lens = live(torch.from_numpy(wave),
                                   torch.from_numpy(ns))
    assert np.array_equal(ids, want_ids.numpy())
    assert np.array_equal(lens, want_lens.numpy())
    assert m["pgasr_ops"] == ({"pgasr::ctc_beam": 1} if "beam" in flags
                              else {})
    if quant:
        tree = params_to_jax(params)
        ref = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_quantize_tree(_jnp(tree))))
        got = quantize_tree(params)
        assert set(got) == set(ref)
        for k in ("blocks.0.w1", "blocks.0.b1", "blocks.0.w2", "blocks.0.b2",
                  "blocks.0.router.w"):
            assert isinstance(got[k], dict), k
        for k, v in got.items():
            if isinstance(v, dict):
                for f in ("q8", "s"):
                    assert torch.equal(v[f], ref[k][f]), (k, f)
            else:
                assert torch.equal(v, ref[k]), k


def test_cli_moe_timestamps_lm_align_pseudolabel(moe_slice):
    """The CTC family's other paths take the MoE model through
    acoustic_forward: --timestamps, the n-gram fused beam, --mode align
    and --mode pseudolabel."""
    corpus, _, model, _ = moe_slice
    base = ["--corpus_path", corpus, "--model_path", model, "--device",
            "cpu"]
    for extra in (["--timestamps"],
                  ["--decoder", "beam", "--beam_size", "4", "--lm_order",
                   "2"]):
        assert cli.main(["--mode", "predict", *base, *extra]) == 0
    assert cli.main(["--mode", "align", *base]) == 0
    assert cli.main(["--mode", "pseudolabel", *base, "--min_conf",
                     "0"]) == 0
    for name in ("timestamps.jsonl", "alignments.jsonl"):
        with open(os.path.join(model, name)) as fo:
            assert len(fo.read().splitlines()) == 2, name
    with open(os.path.join(model, "pseudo.tsv")) as fo:
        assert len(fo.read().splitlines()) == 1 + 16


def test_cli_moe_stream_is_refused_as_the_jax_cli(moe_slice):
    corpus, _, model, _ = moe_slice
    wav = os.path.join(corpus, "clips", sorted(os.listdir(
        os.path.join(corpus, "clips")))[0])
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "stream", "--corpus_path", corpus,
                  "--model_path", model, "--wav", wav, "--device", "cpu"])
    assert str(e.value) == "MoE encoders have no streaming path yet"


# ------------------------------------- the transducer's dense transformer

def test_transducer_transformer_encoder_ignores_num_experts():
    """A transducer with the transformer encoder and num_experts > 0 has
    JAX's dense-encoder params and one train step's loss and gradients
    (num_experts matters only to the transformer family)."""
    from pg_asr_tpu.config import TransducerConfig

    jcfg = JConfig(
        model=ModelConfig(family="transducer", vocab_size=VOCAB,
                          input_dim=80, dropout=0.0),
        transformer=TransformerConfig(num_layers=1, d_model=32, num_heads=2,
                                      ffn_dim=64, dropout=0.0,
                                      num_experts=2),
        transducer=TransducerConfig(encoder="transformer", pred_embed_dim=16,
                                    pred_hidden=32, joint_dim=32),
        train=TrainConfig(warmup_steps=0))
    cfg = Config.from_json(jcfg.to_json())
    tree = _tree(jcfg, seed=6)
    got = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = params_from_jax(tree)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert "encoder.blocks.0.ffn_in.w" in got
    batch = _batch()
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train.compute_loss(p, *map(jnp.asarray, batch), jcfg,
                                         train=True)))(_jnp(tree))
    r_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads))
    loss, grads = loss_and_grads(params_from_jax(tree),
                                 [torch.from_numpy(a) for a in batch], cfg)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
