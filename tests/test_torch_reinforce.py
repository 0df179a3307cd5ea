"""The port's policy-gradient losses, sampler and PG optimizer
(pg_asr_tpu_torch/rl/reinforce.py, train.AdamW's constant-rate form) vs the
JAX package's (pg_asr_tpu/rl/reinforce.py), on the same seeded numpy inputs
and the same weights (convert.params_from_jax).

JAX's draws cannot be reproduced in torch, so the loss tests give both
packages the same paths: each module's ``_sample_paths`` is monkeypatched
to return them (nothing in the JAX package changes). The port's sampler is
held by its statistics instead.

Tolerances (float32): losses and metrics rtol 1e-4, atol 1e-6; gradients
rtol 1e-4, atol 1e-5 x the largest reference value of each tensor (the same
algorithms in the same precision: summation order only, through two
BiLSTM layers and the CTC recursion); parameters after an optimizer step
rtol 1e-5, atol 1e-5, as tests/test_torch_train.py; the bf16 optimizer step
equal element for element.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransducerConfig as JTransducerConfig
from pg_asr_tpu.rl import reinforce as jrl
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.rl import reinforce as rl
from pg_asr_tpu_torch.train import AdamW, value_and_grad

SPACE = 1  # the space symbol's id in these tests' alphabets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg: JConfig) -> Config:
    return Config.from_json(jcfg.to_json())


def _batch(seed=0, B=3, L=6, V=8):
    """int16 waves of 0.3 / 0.2 / 0.125 s (25, 17, 11 frames) and labels;
    with B > 2 the last row has no labels (a padding row)."""
    rng = np.random.default_rng(seed)
    ns = np.array([4800, 3200, 2000][:B], np.int32)
    wave = np.where(np.arange(4800)[None] < ns[:, None],
                    rng.standard_normal((B, 4800)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    label_lens = np.array([6, 4, 0][:B], np.int32)
    labels[0, 2] = SPACE
    for b in range(B):
        labels[b, label_lens[b]:] = 0
    return wave, ns, labels, label_lens


def _paths(S, B, T, V=8, seed=1):
    """Seeded alignment paths, half blanks, the rest uniform symbols."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(1, V, (S, B, T))
    return np.where(rng.random((S, B, T)) < 0.5, 0, sym).astype(np.int32)


def _ctc_cfg(**rl_kw) -> JConfig:
    return JConfig(
        model=JModelConfig(vocab_size=8, input_proj_dim=32, hidden_size=16,
                           num_layers=2, dropout=0.0, use_pallas_lstm=False),
        rl=JRLConfig(space_id=SPACE, **rl_kw))


@pytest.fixture(scope="module")
def ctc_tree():
    return jax.tree_util.tree_map(np.asarray, jax_train.init_model_params(
        jax.random.PRNGKey(0), _ctc_cfg()))


def _jax_loss_and_grads(jcfg, tree, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jrl.pg_loss_fn(p, *map(jnp.asarray, batch),
                                 jax.random.PRNGKey(3), jcfg),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            params_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


def _port_loss_and_grads(cfg, params, batch, use_kernel=False):
    arrays = [torch.from_numpy(a) for a in batch]
    (loss, metrics), grads = value_and_grad(
        lambda p: rl.pg_loss_fn(p, *arrays, None, cfg, use_kernel), params)
    return (loss.item(), {k: v.item() for k, v in metrics.items()}, grads)


def _check_same(got, want):
    loss, metrics, grads = got
    r_loss, r_metrics, r_grads = want
    np.testing.assert_allclose(loss, r_loss, rtol=1e-4, atol=1e-6)
    assert set(metrics) == set(r_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, r_metrics[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def _same_paths(monkeypatch, paths):
    monkeypatch.setattr(jrl, "_sample_paths",
                        lambda key, lp, S, temp: jnp.asarray(paths))
    monkeypatch.setattr(rl, "_sample_paths",
                        lambda gen, lp, S, temp: torch.from_numpy(
                            paths.astype(np.int64)))


# ------------------------------------------------------------------ sampler

@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampler_frequencies_follow_the_tempered_softmax(temperature):
    """Counts of 20 000 draws per frame against softmax(lp / temperature):
    Pearson's chi-square with 3 degrees of freedom (4 symbols with
    probability above 0) below 25, which a correct sampler exceeds with
    probability ~1.5e-5 per frame (6 frames, seeded); symbol 4 (log-prob
    -inf) is never drawn."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 3, 5)).astype(np.float32)
    logits[..., 4] = -np.inf
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    S = 20000
    paths = rl._sample_paths(torch.Generator().manual_seed(0), lp, S,
                             temperature)
    assert paths.shape == (S, 2, 3)
    assert int(paths.min()) >= 0 and int(paths.max()) <= 3
    p = torch.softmax(lp / temperature, -1).numpy()
    for b in range(2):
        for t in range(3):
            counts = np.bincount(paths[:, b, t].numpy(), minlength=5)
            assert counts[4] == 0
            expect = S * p[b, t, :4]
            chi2 = float(((counts[:4] - expect) ** 2 / expect).sum())
            assert chi2 < 25.0, (b, t, chi2)


def test_sampler_is_reproducible_from_its_generator():
    lp = torch.log_softmax(torch.randn(3, 7, 6), -1)
    a = rl._sample_paths(torch.Generator().manual_seed(5), lp, 4, 1.0)
    b = rl._sample_paths(torch.Generator().manual_seed(5), lp, 4, 1.0)
    c = rl._sample_paths(torch.Generator().manual_seed(6), lp, 4, 1.0)
    assert a.dtype == torch.int64 and torch.equal(a, b)
    assert not torch.equal(a, c)


# ------------------------------------------------------------- path rewards

@pytest.mark.parametrize("kind", ["neg_cer", "neg_wer", "stepwise_ed"])
def test_path_rewards_match_jax(kind):
    S, B, T = 3, 4, 15
    paths = _paths(S, B, T, seed=2)
    paths[0, 0] = [0, 2, 2, 0, 2, SPACE, 3, 3, 0, 0, 4, 0, 0, 0, 5]
    mask = (np.arange(T)[None] < np.array([15, 11, 6, 1])[:, None]).astype(
        np.float32)
    rng = np.random.default_rng(3)
    labels = rng.integers(1, 8, (B, 6)).astype(np.int32)
    label_lens = np.array([5, 6, 2, 0], np.int32)
    labels[0, :5] = [2, 2, SPACE, 3, 4]
    for b in range(B):
        labels[b, label_lens[b]:] = 0
    want = jrl._path_rewards(*map(jnp.asarray, (paths, mask, labels,
                                                label_lens)), kind, SPACE)
    got = rl._path_rewards(*map(torch.from_numpy, (
        paths.astype(np.int64), mask, labels, label_lens)), kind, SPACE)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if kind == "stepwise_ed":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-6)
    else:
        assert got[1] is None and want[1] is None


# ---------------------------------------------------------------- REINFORCE

@pytest.mark.parametrize("baseline", ["greedy", "mean", "none"])
@pytest.mark.parametrize("reward", ["neg_cer", "neg_wer", "stepwise_ed"])
def test_reinforce_loss_and_gradients_match_jax(monkeypatch, ctc_tree,
                                                baseline, reward):
    """pg_loss_fn (REINFORCE + entropy + CTC anchor) and every parameter
    gradient on the same paths. stepwise_ed with a greedy or mean baseline
    runs at B=1: the JAX package divides a (1, B) baseline by a (1, B, 1)
    frame count, which broadcasts to (1, B, B) and raises for other B; the
    port gives every row the B=1 result (ROADMAP.md, the reference's
    differences)."""
    B = 1 if reward == "stepwise_ed" and baseline != "none" else 3
    batch = _batch(B=B)
    jcfg = _ctc_cfg(num_samples=3, baseline=baseline, reward=reward)
    _same_paths(monkeypatch, _paths(3, B, 25))
    want = _jax_loss_and_grads(jcfg, ctc_tree, batch)
    got = _port_loss_and_grads(_port_cfg(jcfg), params_from_jax(ctc_tree),
                               batch)
    _check_same(got, want)


def test_transducer_needs_mwer_and_unknown_objectives_raise():
    cfg = Config.from_json(JConfig(model=JModelConfig(
        family="transducer")).to_json())
    batch = [torch.from_numpy(a) for a in _batch(B=1)]
    with pytest.raises(ValueError, match="MWER objective"):
        rl.pg_loss_terms({}, *batch, None, cfg)
    cfg = _port_cfg(_ctc_cfg(objective="scst"))
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_train.init_model_params(jax.random.PRNGKey(0),
                                                _ctc_cfg())))
    with pytest.raises(ValueError, match="unknown rl.objective"):
        rl.pg_loss_terms(params, *batch, None, cfg)


# --------------------------------------------------------------------- MWER

def test_mwer_combine_matches_jax_with_all_dead_rows():
    """Values and the gradient of num / den w.r.t. the log-likelihoods: a
    row whose n-best is all dead and a padding row drop out and leave
    finite (zero) gradients."""
    rng = np.random.default_rng(4)
    B, K = 5, 4
    logp = (rng.standard_normal((B, K)) * 3 - 5).astype(np.float32)
    risk = rng.random((B, K)).astype(np.float32)
    live = rng.random((B, K)) < 0.7
    live[:, 0] = True
    live[2] = False  # all dead
    valid = np.array([True, True, True, False, True])

    def jfn(x):
        num, den, m = jrl._mwer_combine(x, *map(jnp.asarray, (risk, live,
                                                               valid)))
        return num / den, (num, den, m)

    (j_loss, (j_num, j_den, j_m)), j_grad = jax.value_and_grad(
        jfn, has_aux=True)(jnp.asarray(logp))
    x = torch.from_numpy(logp).requires_grad_(True)
    num, den, m = rl._mwer_combine(x, *map(torch.from_numpy,
                                           (risk, live, valid)))
    (num / den).backward()
    assert den.item() == float(j_den) == 3.0
    np.testing.assert_allclose(num.item(), float(j_num), rtol=1e-5)
    for k, v in m.items():
        np.testing.assert_allclose(v.item(), float(j_m[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert torch.isfinite(x.grad).all()
    assert torch.all(x.grad[[2, 3]] == 0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=1e-5,
                               atol=1e-7)


def _mwer_case(seed=5):
    """Sharp posteriors (so the beam's n-best holds several distinct
    labelings) with ragged frames; row 3 a padding row (no labels), row 4 a
    single frame."""
    rng = np.random.default_rng(seed)
    B, T, A = 5, 12, 6
    logits = (rng.standard_normal((B, T, A)) * 3).astype(np.float32)
    frame_lens = np.array([12, 9, 7, 5, 1], np.int32)
    labels = rng.integers(1, A, (B, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 4, 0, 1], np.int32)
    labels[0, 2] = SPACE
    for b in range(B):
        labels[b, label_lens[b]:] = 0
    mask = (np.arange(T)[None] < frame_lens[:, None]).astype(np.float32)
    return logits, mask, frame_lens, labels, label_lens


@pytest.mark.parametrize("reward", ["neg_cer", "neg_wer"])
def test_mwer_terms_match_jax(reward):
    """_mwer_terms on the same log-probs (K=4): num, den, metrics and the
    gradient of num / den w.r.t. the logits behind the log-softmax, for the
    plain path (the CTC recursion, as JAX) and the kernel path's re-scoring
    (F.ctc_loss over all B x K rows, whose log-prob gradient is right only
    after a log-softmax)."""
    logits, mask, fl, labels, ll = _mwer_case()
    jrl_cfg = JRLConfig(objective="mwer", mwer_beam=4, reward=reward,
                        space_id=SPACE)

    def jfn(x):
        lp = jax.nn.log_softmax(x, -1) * jnp.asarray(mask)[:, :, None]
        num, den, m = jrl._mwer_terms(lp, *map(jnp.asarray, (mask, fl, labels,
                                                             ll)), jrl_cfg)
        return num / den, (num, den, m)

    (_, (j_num, j_den, j_m)), j_grad = jax.value_and_grad(
        jfn, has_aux=True)(jnp.asarray(logits))
    assert float(j_den) == 4.0  # the padding row drops out
    port_rl = dataclasses.replace(Config().rl, objective="mwer", mwer_beam=4,
                                  reward=reward, space_id=SPACE)
    for use_kernel in (False, True):
        x = torch.from_numpy(logits).requires_grad_(True)
        lp = torch.log_softmax(x, -1) * torch.from_numpy(mask)[:, :, None]
        num, den, m = rl._mwer_terms(lp, *map(torch.from_numpy, (
            mask, fl, labels, ll)), port_rl, use_kernel=use_kernel)
        (num / den).backward()
        assert den.item() == 4.0
        np.testing.assert_allclose(num.item(), float(j_num), rtol=1e-4)
        for k, v in m.items():
            np.testing.assert_allclose(v.item(), float(j_m[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        ref = np.asarray(j_grad)
        np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max())


def test_mwer_loss_and_gradients_match_jax_kernel_and_plain_paths(ctc_tree):
    """The whole MWER loss (+ entropy + CTC anchor) and every parameter
    gradient of the BiLSTM-CTC, both of the port's paths against JAX: the
    kernel path's F.ctc_loss (n-best re-scoring and anchor) reaches the
    parameters through the model's log-softmax with the true gradient."""
    batch = _batch()
    jcfg = _ctc_cfg(objective="mwer", mwer_beam=3)
    want = _jax_loss_and_grads(jcfg, ctc_tree, batch)
    for use_kernel in (False, True):
        got = _port_loss_and_grads(_port_cfg(jcfg), params_from_jax(ctc_tree),
                                   batch, use_kernel)
        _check_same(got, want)


def test_mwer_transducer_matches_jax():
    """_mwer_transducer_terms through pg_loss_fn on a tiny transducer
    (BiLSTM encoder, unfused joint; K=3): the loss, its metrics and every
    parameter gradient; and the fused joint's plain version gives the same
    (its tables in float32 like the unfused path's)."""
    jcfg = JConfig(
        model=JModelConfig(family="transducer", vocab_size=8,
                           input_proj_dim=16, hidden_size=8, num_layers=1,
                           dropout=0.0, use_pallas_lstm=False),
        transducer=JTransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                     pred_hidden=8, joint_dim=16,
                                     fused_joint=False),
        rl=JRLConfig(objective="mwer", mwer_beam=3, space_id=SPACE))
    tree = jax.tree_util.tree_map(np.asarray, jax_train.init_model_params(
        jax.random.PRNGKey(1), jcfg))
    batch = _batch(seed=2)
    want = _jax_loss_and_grads(jcfg, tree, batch)
    cfg = _port_cfg(jcfg)
    _check_same(_port_loss_and_grads(cfg, params_from_jax(tree), batch),
                want)
    fused = cfg.replace(transducer=dataclasses.replace(cfg.transducer,
                                                       fused_joint=True))
    _check_same(_port_loss_and_grads(fused, params_from_jax(tree), batch),
                want)


# ---------------------------------------------------------------- optimizer

def _pg_optax(lr, clip):
    return optax.chain(optax.clip_by_global_norm(clip),
                       optax.adamw(lr * 0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [True, False])
def test_constant_rate_adamw_matches_finetune_pgs_optax(dtype, clip):
    """AdamW(learning_rate=lr * 0.1, weight_decay=1e-4) against
    finetune_pg's optax.chain(clip_by_global_norm, adamw(lr * 0.1)), three
    updates: float32 within rtol 1e-5, atol 1e-6; bfloat16 equal element for
    element (params and both moments)."""
    lr = 3e-3
    jcfg = JConfig(train=JTrainConfig(learning_rate=lr, grad_clip=1.0,
                                      weight_decay=0.5, warmup_steps=7))
    rng = np.random.default_rng(7 + clip)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = {"a": jnp.asarray(rng.standard_normal((6, 5)), jdt),
              "b": [jnp.asarray(rng.standard_normal((7,)), jdt)
                    for _ in range(3)]}
    scale = 1.0 if clip else 0.01
    grads = [jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * scale, jdt),
        params) for _ in range(3)]
    assert (float(optax.global_norm(grads[0])) >= 1.0) == clip

    opt = _pg_optax(lr, jcfg.train.grad_clip)
    state = opt.init(params)
    t_params = params_from_jax(params)
    t_opt = AdamW(_port_cfg(jcfg), t_params, learning_rate=lr * 0.1,
                  weight_decay=1e-4)
    for g in grads:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        t_opt.update(t_params, params_from_jax(g))
        want = params_from_jax(params)
        for k, v in t_params.items():
            assert v.dtype == want[k].dtype, k
            if dtype == "bfloat16":
                assert torch.equal(v, want[k]), k
            else:
                torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-6)
    if dtype == "bfloat16":
        for got, ref in ((t_opt.mu, state[1][0].mu), (t_opt.nu,
                                                      state[1][0].nu)):
            ref = params_from_jax(ref)
            assert all(torch.equal(v, ref[k]) for k, v in got.items())


# ----------------------------------------------------------------- one step

def test_one_pg_step_matches_make_pg_step(monkeypatch, ctc_tree):
    """One full step (forward, gradients, clip + constant-rate AdamW) against
    the JAX package's jitted make_pg_step on the same paths: the loss and
    every updated parameter."""
    batch = _batch()
    jcfg = _ctc_cfg(num_samples=2, baseline="greedy")
    jcfg = jcfg.replace(train=JTrainConfig(learning_rate=1e-2))
    _same_paths(monkeypatch, _paths(2, 3, 25, seed=8))
    opt = _pg_optax(jcfg.train.learning_rate, jcfg.train.grad_clip)
    j_params = jax.tree_util.tree_map(jnp.asarray, ctc_tree)
    new_j, _, _, j_loss, _ = jrl.make_pg_step(jcfg, opt)(
        j_params, opt.init(j_params), jax.random.PRNGKey(0),
        *map(jnp.asarray, batch))
    new_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))

    cfg = _port_cfg(jcfg)
    params = params_from_jax(ctc_tree)
    t_opt = AdamW(cfg, params, learning_rate=cfg.train.learning_rate * 0.1,
                  weight_decay=1e-4)
    loss, metrics = rl.make_pg_step(cfg, t_opt, use_kernel=False)(
        params, None, *[torch.from_numpy(a) for a in batch])
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert t_opt.count == 1 and set(metrics) >= {"reward_mean", "entropy"}
    for k, p in params.items():
        np.testing.assert_allclose(p.numpy(), new_j[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_mesh_is_refused():
    # the data axis runs (tests/test_torch_mesh.py), the model axis too
    # (tests/test_torch_tensor.py), the pipe axis too
    # (tests/test_torch_pipeline.py): for policy-gradient fine-tuning its
    # ranks are replicas of the data step on any family, as the JAX
    # package's replicated step; training refuses the BiLSTM-CTC there
    from pg_asr_tpu_torch.train import check_ported, make_plan

    cfg = Config()
    assert check_ported(cfg.replace(train=dataclasses.replace(
        cfg.train, mesh_shape=(2,), mesh_axes=("data",)))) == 2
    assert check_ported(cfg.replace(train=dataclasses.replace(
        cfg.train, mesh_shape=(1, 2), mesh_axes=("data", "model")))) == 2
    piped = cfg.replace(train=dataclasses.replace(
        cfg.train, mesh_shape=(1, 2), mesh_axes=("data", "pipe")))
    plan = make_plan(piped, replicas=True)
    assert (plan.world, plan.strategy, plan.copies) == (2, "data",
                                                        ("pipe", "seq"))
    with pytest.raises(ValueError, match="'pipe' axis requires the dense "
                       "transformer family"):
        check_ported(piped)
