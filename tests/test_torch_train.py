"""The port's training slice (pg_asr_tpu_torch/ops/ctc.py, models/
bilstm_ctc.py dropout, train.py) vs the JAX package, on the same seeded
numpy inputs; plus the port's `--mode train` CLI end to end on the CPU.

Tolerances (float32): rtol 1e-4, atol 1e-5 for values computed by the same
algorithm in the same precision (summation order only). Where stated below,
a test scales atol by the largest reference value of a tensor.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.ops import ctc as jax_ctc
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.models import bilstm_ctc
from pg_asr_tpu_torch.ops import ctc
from pg_asr_tpu_torch.train import AdamW, loss_and_grads
from tests.test_torch_predict import PORTED_FLAGS, UNPORTED_FLAGS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards: importing this module changes no
    process-wide state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg: JConfig) -> Config:
    """The port's Config from the JAX config's JSON (one schema)."""
    return Config.from_json(jcfg.to_json())


# ---------------------------------------------------------------- CTC loss

def _ctc_case(seed=0, B=5, T=12, A=6, L=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, A)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = rng.integers(1, A, (B, L)).astype(np.int32)
    labels[2, :3] = [3, 3, 3]  # repeats need blanks between them
    label_lens = np.array([4, 3, 3, 0, 4], np.int32)  # row 3: no labels
    # row 2 needs 5 frames (3 labels + 2 repeats) and gets 4: no alignment
    frame_lens = np.array([12, 9, 4, 7, 5], np.int32)
    for b in range(B):
        labels[b, label_lens[b]:] = 0
    return lp, frame_lens, labels, label_lens


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_ctc_loss_matches_jax_values_and_gradients():
    lp, fl, lab, ll = _ctc_case()
    ref = np.asarray(jax_ctc.ctc_loss(*map(jnp.asarray, (lp, fl, lab, ll))))
    lp_t, fl_t, lab_t, ll_t = _t(lp, fl, lab, ll)
    got = ctc.ctc_loss(lp_t, fl_t, lab_t, ll_t)
    finite = ref < 0.5e30
    assert list(finite) == [True, True, False, True, True]
    np.testing.assert_allclose(got.numpy()[finite], ref[finite], rtol=1e-4,
                               atol=1e-5)
    assert got[2].item() > 0.5e30  # NEG = -1e30: a finite "no alignment"

    def jmean(x):
        return jax_ctc.ctc_loss_mean(x, *map(jnp.asarray, (fl, lab, ll)))

    r_loss, r_grad = jax.value_and_grad(jmean)(jnp.asarray(lp))
    lp_t.requires_grad_(True)
    loss = ctc.ctc_loss_mean(lp_t, fl_t, lab_t, ll_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(lp_t.grad.numpy(), np.asarray(r_grad),
                               rtol=1e-4, atol=1e-5)
    # the dropped rows (no alignment, no labels) get no gradient
    assert np.all(lp_t.grad.numpy()[[2, 3]] == 0.0)


@pytest.mark.parametrize("label_normalize", [True, False])
def test_ctc_terms_match_jax(label_normalize):
    lp, fl, lab, ll = _ctc_case(1)
    r_num, r_den = jax_ctc.ctc_loss_terms(
        *map(jnp.asarray, (lp, fl, lab, ll)), label_normalize=label_normalize)
    num, den = ctc.ctc_loss_terms(*_t(lp, fl, lab, ll),
                                  label_normalize=label_normalize)
    np.testing.assert_allclose(num.item(), float(r_num), rtol=1e-4)
    assert den.item() == float(r_den) == 3.0


def test_fused_ctc_matches_plain_on_guards_and_parameter_gradients():
    """F.ctc_loss's gradient w.r.t. log_probs is not the true one; through
    the model's log_softmax (and the frame-mask multiply) the gradient
    w.r.t. the logits, and so every parameter, is. Values and logit
    gradients agree with the plain recursion, including the rows dropped
    for no alignment and for no labels."""
    lp, fl, lab, ll = _ctc_case(2)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(lp.shape).astype(np.float32)
    mask = (np.arange(lp.shape[1])[None] < fl[:, None]).astype(np.float32)
    out = []
    for terms in (ctc.ctc_loss_terms, ctc.ctc_loss_terms_fused):
        x = torch.from_numpy(logits).requires_grad_(True)
        lp_t = torch.log_softmax(x, -1) * torch.from_numpy(mask)[:, :, None]
        num, den = terms(lp_t, *_t(fl, lab, ll))
        (num / den.clamp(min=1)).backward()
        out.append((num.item(), den.item(), x.grad.numpy()))
    (n0, d0, g0), (n1, d1, g1) = out
    assert d0 == d1 == 3.0
    np.testing.assert_allclose(n1, n0, rtol=1e-5)
    np.testing.assert_allclose(g1, g0, rtol=1e-4, atol=1e-6)
    assert np.all(g1[[2, 3]] == 0.0)


def test_alignable_counts_repeats():
    labels = torch.tensor([[1, 1, 2, 0], [1, 2, 3, 0], [4, 4, 4, 4]])
    lens = torch.tensor([3, 3, 4])
    # needs: 3 + 1 repeat, 3, 4 + 3 repeats
    assert ctc.alignable(torch.tensor([4, 3, 7]), labels, lens).tolist() == [
        True, True, True]
    assert ctc.alignable(torch.tensor([3, 2, 6]), labels, lens).tolist() == [
        False, False, False]


# ---------------------------------------------------------------- dropout

def test_dropout_rule_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 7, 33)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    for rate in (0.3, 0.1, 0.5):
        ref = jax_model._dropout(jnp.asarray(x), rate, key, True)
        bits = np.array(jax.random.bits(key, x.shape, dtype=jnp.uint8))
        got = bilstm_ctc.dropout_from_bits(torch.from_numpy(x), rate,
                                           torch.from_numpy(bits))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=0)
        thresh, keep_p = bilstm_ctc.dropout_threshold(rate)
        kept = got.numpy() != 0
        np.testing.assert_array_equal(kept, bits >= thresh)
        np.testing.assert_allclose(got.numpy()[kept], x[kept] / keep_p,
                                   rtol=1e-6)


def test_dropout_threshold_clamp_and_train_only():
    assert bilstm_ctc.dropout_threshold(0.3) == (77, 1 - 77 / 256)
    assert bilstm_ctc.dropout_threshold(1e-4) == (1, 1 - 1 / 256)
    assert bilstm_ctc.dropout_threshold(0.9999) == (255, 1 - 255 / 256)
    x = torch.ones(8, 16)
    g = torch.Generator().manual_seed(0)
    assert bilstm_ctc._dropout(x, 0.3, g, train=False) is x
    assert bilstm_ctc._dropout(x, 0.0, g, train=True) is x
    y = bilstm_ctc._dropout(x, 0.5, g, train=True)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    # training with dropout needs its bits' generator: none is an error,
    # not a run without dropout
    with pytest.raises(ValueError, match="generator"):
        bilstm_ctc._dropout(x, 0.3, None, train=True)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("grad_scale,clip", [(1.0, True), (0.01, False)])
@pytest.mark.parametrize("warmup,schedule", [(0, "warmup_constant"),
                                             (2, "warmup_constant"),
                                             (2, "warmup_cosine")])
def test_optimizer_matches_optax(grad_scale, clip, warmup, schedule):
    """Three updates of clip-by-global-norm + AdamW + the lr schedule on
    the same gradients as optax (the JAX package's make_optimizer)."""
    jcfg = JConfig(train=JTrainConfig(
        learning_rate=1e-2, warmup_steps=warmup, lr_schedule=schedule,
        decay_steps=5 if schedule == "warmup_cosine" else 0, grad_clip=1.0,
        weight_decay=0.1))
    rng = np.random.default_rng(warmup)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (grad_scale * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in params.items()} for _ in range(3)]
    norm = np.sqrt(sum((g ** 2).sum() for g in grads[0].values()))
    assert (norm >= 1.0) == clip

    opt = jax_train.make_optimizer(jcfg)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_opt = AdamW(_port_cfg(jcfg), t_params)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        t_opt.update(t_params, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(),
                                       np.asarray(j_params[k]), rtol=1e-5,
                                       atol=1e-6)
    assert t_opt.count == 3


def test_first_warmup_update_has_lr_zero():
    cfg = Config()  # warmup_steps 500 from 0
    p = {"w": torch.ones(3)}
    opt = AdamW(cfg, p)
    opt.update(p, {"w": torch.ones(3)})
    assert torch.equal(p["w"], torch.ones(3))
    opt.update(p, {"w": torch.ones(3)})
    assert torch.all(p["w"] < 1.0)


# ---------------------------------------------------------------- train step

def test_one_train_step_matches_jax():
    """Loss, every gradient and every updated parameter of one train step
    of a small BiLSTM-CTC (2 layers, H=16, dropout 0, no warmup) vs the
    JAX package's make_train_step on the same params and batch. Gradients
    atol 1e-5 x max|grad| of each tensor; updated params atol 1e-5."""
    jcfg = JConfig(
        model=JModelConfig(vocab_size=9, input_proj_dim=32, hidden_size=16,
                           num_layers=2, dropout=0.0, use_pallas_lstm=False),
        train=JTrainConfig(warmup_steps=0, learning_rate=1e-3))
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(0)
    ns = np.array([6400, 4000, 2500], np.int32)
    wave = np.where(np.arange(6400)[None] < ns[:, None],
                    rng.standard_normal((3, 6400)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, 9, (3, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 0], np.int32)
    for b in range(3):
        labels[b, label_lens[b]:] = 0
    batch = (wave, ns, labels, label_lens)

    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg.model))
    key = jax.random.PRNGKey(1)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: jax_train.compute_loss(p, *map(jnp.asarray, batch), jcfg,
                                         train=True, dropout_rng=key))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    opt = jax_train.make_optimizer(jcfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    new_j, _, _, j_loss = jax_train.make_train_step(jcfg, opt)(
        j_params, opt.init(j_params), key, *map(jnp.asarray, batch))
    new_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    r_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads))

    params = params_from_jax(tree)
    arrays = [torch.from_numpy(a) for a in batch]
    loss, grads = loss_and_grads(params, arrays, cfg)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-4)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)
    AdamW(cfg, params).update(params, grads)
    for k, p in params.items():
        np.testing.assert_allclose(p.numpy(), new_j[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _bf16_tree(mixed: bool, scale: float, seed: int):
    """A parameter tree of the JAX package's shape: 11 blocks (so the list
    order 0, 1, 2, .. 10 differs from the names' string order), bf16
    leaves and, when `mixed`, float32 LayerNorm leaves among them; its
    gradients at `scale`."""
    rng = np.random.default_rng(seed)

    def leaf(shape, ln=False):
        return jnp.asarray(rng.standard_normal(shape),
                           jnp.float32 if (ln and mixed) else jnp.bfloat16)

    def tree(ln_scale=1.0):
        return {"input_proj": {"w": leaf((40, 24)), "b": leaf((24,))},
                "blocks": [{"ln1": {"scale": leaf((24,), True),
                                    "bias": leaf((24,), True)},
                            "qkv": {"w": leaf((24, 72)), "b": leaf((72,))}}
                           for _ in range(11)],
                "ctc_head": {"w": leaf((24, 9)), "b": leaf((9,))}}

    params = tree()
    grads = jax.tree_util.tree_map(lambda x: (x * scale).astype(x.dtype),
                                   tree())
    return params, grads


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("clip", [True, False])
def test_optimizer_matches_optax_in_bfloat16(clip, mixed):
    """One update of bf16 parameters, clipped (global norm ~35 > 1) and
    unclipped (~0.35), against optax.chain(clip_by_global_norm, adamw) as
    the JAX package builds it, run op by op: the parameters and both
    moments equal element for element. The global norm is optax's: bf16
    leaf sums added in tree order. With float32 LayerNorm leaves in the
    tree (the attention families in bf16) the norm sums in float32 from the
    first such leaf on, and ``jnp.sum`` and torch sum a float32 leaf in
    different orders: there the float32 leaves agree to rtol 1e-6 (the
    norm's last bit), the bf16 leaves still exactly."""
    jcfg = JConfig(train=JTrainConfig(learning_rate=5e-4, warmup_steps=0,
                                      grad_clip=1.0, weight_decay=0.01))
    params, grads = _bf16_tree(mixed, 0.02 if clip else 2e-4, seed=4)
    norm = float(optax.global_norm(grads))
    assert (norm >= 1.0) == clip, norm
    opt = jax_train.make_optimizer(jcfg)
    state = opt.init(params)
    upd, state = opt.update(grads, state, params)
    want = params_from_jax(optax.apply_updates(params, upd))
    want_mu = params_from_jax(state[1][0].mu)
    want_nu = params_from_jax(state[1][0].nu)

    t_params = params_from_jax(params)
    t_opt = AdamW(_port_cfg(jcfg), t_params)
    t_opt.update(t_params, params_from_jax(grads))
    for got, ref in ((t_params, want), (t_opt.mu, want_mu),
                     (t_opt.nu, want_nu)):
        assert set(got) == set(ref)
        for k, v in got.items():
            assert v.dtype == ref[k].dtype, k
            if v.dtype == torch.bfloat16:
                assert torch.equal(v, ref[k]), k
            else:
                torch.testing.assert_close(v, ref[k], rtol=1e-6, atol=0)


def test_bf16_train_step_of_an_attention_family_matches_jax():
    """One bf16 train step of a small transformer-CTC (LayerNorm params
    float32) against make_train_step. The two frameworks round the
    activations to bf16 at their own points, so: the loss rtol 1e-3; every
    gradient atol 2^-5 x its max |grad|; the port's AdamW on JAX's own
    gradients gives the jitted step's parameters up to XLA's fusions (at
    most 1 in 200 elements differ: bf16 leaves by one ulp, the float32
    LayerNorm leaves by rtol 1e-5, the jitted clip's float32 norm);
    the port's whole step moves no parameter further than 2 lr from JAX's
    (a gradient whose sign differs turns Adam's first step around) plus one
    bf16 ulp of the parameter."""
    from pg_asr_tpu.config import TransformerConfig

    lr = 1e-3
    jcfg = JConfig(model=JModelConfig(family="transformer", vocab_size=9,
                                      dtype="bfloat16"),
                   transformer=TransformerConfig(num_layers=2, d_model=64,
                                                 num_heads=2, ffn_dim=128,
                                                 dropout=0.0),
                   train=JTrainConfig(warmup_steps=0, learning_rate=lr))
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(0)
    ns = np.array([6400, 4000, 2500], np.int32)
    wave = np.where(np.arange(6400)[None] < ns[:, None],
                    rng.standard_normal((3, 6400)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, 9, (3, 6)).astype(np.int32)
    label_lens = np.array([6, 4, 0], np.int32)
    for b in range(3):
        labels[b, label_lens[b]:] = 0
    batch = (wave, ns, labels, label_lens)
    tree = jax.tree_util.tree_map(np.asarray, jax_train.init_model_params(
        jax.random.PRNGKey(0), jcfg))
    key = jax.random.PRNGKey(1)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: jax_train.compute_loss(p, *map(jnp.asarray, batch), jcfg,
                                         train=True, dropout_rng=key))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    opt = jax_train.make_optimizer(jcfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    new_j, _, _, j_loss = jax_train.make_train_step(jcfg, opt)(
        j_params, opt.init(j_params), key, *map(jnp.asarray, batch))
    new_j = params_from_jax(new_j)
    r_grads = params_from_jax(r_grads)

    params = params_from_jax(tree)
    assert params["blocks.0.ln1.scale"].dtype == torch.float32
    assert params["blocks.0.qkv.w"].dtype == torch.bfloat16
    loss, grads = loss_and_grads(params, [torch.from_numpy(a) for a in batch],
                                 cfg)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-3)
    for k, g in grads.items():
        ref = r_grads[k].float()
        torch.testing.assert_close(g.float(), ref, rtol=0,
                                   atol=2.0 ** -5 * ref.abs().max().item(),
                                   msg=k)
    on_ref = {k: v.clone() for k, v in params.items()}
    AdamW(cfg, on_ref).update(on_ref, r_grads)
    AdamW(cfg, params).update(params, grads)
    n = sum(v.numel() for v in params.values())
    off = 0
    for k, p in params.items():
        want = new_j[k].float()
        if p.dtype == torch.bfloat16:  # one bf16 ulp of the parameter
            tol = 2.0 ** (torch.floor(torch.log2(
                want.abs().clamp(min=2 ** -126))) - 7)
        else:
            tol = 1e-5 * want.abs()
        near = (on_ref[k].float() - want).abs()
        assert torch.all(near <= tol), k
        off += int((near > 0).sum())
        assert torch.all((p.float() - want).abs() <= 2 * lr + tol), k
    assert off <= n // 200, (off, n)


# ---------------------------------------------------------------- data

def test_corpus_batches_and_metrics_match_jax(tmp_path):
    """The port's copies of the data modules write the same synthetic
    corpus and build the same shuffled batches, epoch after epoch (and
    after skip_epochs, as a resume does), as the JAX package's; its metrics
    score the same."""
    from pg_asr_tpu import metrics as jax_metrics
    from pg_asr_tpu.data import dataset as jax_data
    from pg_asr_tpu_torch import metrics
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest

    j_root, j_alpha = jax_data.make_synthetic_corpus(
        str(tmp_path / "j"), n_utts=24, seed=4, min_dur=0.2, max_dur=1.3)
    t_root, t_alpha = make_synthetic_corpus(
        str(tmp_path / "t"), n_utts=24, seed=4, min_dur=0.2, max_dur=1.3)
    assert j_alpha.symbols == t_alpha.symbols
    for name in ("train.tsv", "dev.tsv", "test.tsv", "alphabet.txt"):
        with open(os.path.join(j_root, name)) as a, \
                open(os.path.join(t_root, name)) as b:
            assert a.read() == b.read(), name
    manifest = os.path.join(t_root, "train.tsv")
    clips = os.path.join(t_root, "clips")
    j_it = jax_data.BatchIterator(jax_data.load_manifest(manifest, clips),
                                  j_alpha, 5, seed=7)
    t_it = BatchIterator(load_manifest(manifest, clips), t_alpha, 5, seed=7)
    t_skip = BatchIterator(load_manifest(manifest, clips), t_alpha, 5, seed=7)
    t_skip.skip_epochs(1)
    assert len(t_it) == len(j_it) == 4
    for epoch in range(2):
        got = list(t_it)
        if epoch == 1:
            got_skip = list(t_skip)
        for i, ref in enumerate(j_it):
            for b in ([got[i], got_skip[i]] if epoch == 1 else [got[i]]):
                for f in ("wave", "num_samples", "labels", "label_lens"):
                    np.testing.assert_array_equal(getattr(b, f),
                                                  getattr(ref, f))
                assert b.texts == ref.texts

    refs = ["the quick fox", "a", "lazy dog", ""]
    hyps = ["the quik fox", "", "lazy dog jumps", "x"]
    assert metrics.evaluate_corpus(refs, hyps) == \
        jax_metrics.evaluate_corpus(refs, hyps)
    for r, h in zip(refs, hyps):
        assert metrics.edit_dist(r, h) == jax_metrics.edit_dist(r, h)


# ---------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_corpus")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=16, seed=0,
                                      min_dur=0.2, max_dur=0.4)
    return corpus


def test_cli_train_resume_predict_cpu(tiny_corpus, tmp_path, capsys):
    model = str(tmp_path / "model")
    argv = ["--mode", "train", "--corpus_path", tiny_corpus, "--model_path",
            model, "--batch_size", "4", "--device", "cpu"]
    assert cli.main(argv + ["--num_epochs", "1"]) == 0
    for name in ("model_best.pt", "model_last.pt", "train_loss.npy",
                 "val_losses.npy", "config.json"):
        assert os.path.exists(os.path.join(model, name)), name
    state = torch.load(os.path.join(model, "model_last.pt"),
                       weights_only=True)
    assert state["step"] == 3 and state["epoch"] == 1
    assert state["opt_state"]["count"] == 3
    assert set(state["opt_state"]["mu"]) == set(state["params"])
    with open(os.path.join(model, "config.json")) as fo:
        assert json.load(fo)["train"]["batch_size"] == 4

    assert cli.main(argv + ["--num_epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    tl = np.load(os.path.join(model, "train_loss.npy"))
    vl = np.load(os.path.join(model, "val_losses.npy"))
    assert tl.shape == vl.shape == (2,) and np.isfinite(tl).all()
    state = torch.load(os.path.join(model, "model_last.pt"),
                       weights_only=True)
    assert state["step"] == 6 and state["epoch"] == 2

    assert cli.main(["--mode", "predict", "--corpus_path", tiny_corpus,
                     "--model_path", model, "--device", "cpu"]) == 0
    assert "CER:" in capsys.readouterr().out
    with open(os.path.join(model, "predicted.txt")) as fo:
        assert len(fo.read().splitlines()) == 2


def test_cli_seq2seq_train_predict_round_trip(tiny_corpus, tmp_path,
                                             capsys):
    """--model seq2seq at the default width through the CLI: one epoch,
    then --mode predict without --model (the family comes from
    config.json), greedy and with the decoder's beam; the artifacts, a
    finite loss, and predicted.txt with every test utterance."""
    model = str(tmp_path / "model")
    assert cli.main(["--mode", "train", "--corpus_path", tiny_corpus,
                     "--model_path", model, "--batch_size", "4",
                     "--num_epochs", "1", "--model", "seq2seq",
                     "--device", "cpu"]) == 0
    with open(os.path.join(model, "config.json")) as fo:
        cfg = json.load(fo)
    assert cfg["model"]["family"] == "seq2seq"
    assert cfg["seq2seq"]["vocab_size"] == cfg["model"]["vocab_size"]
    state = torch.load(os.path.join(model, "model_last.pt"),
                       weights_only=True)
    assert state["step"] == 3
    assert {"embed", "dec_lstm.U", "output.w",
            "encoder.lstm.2.bwd.U"} <= set(state["params"])
    assert np.isfinite(np.load(os.path.join(model, "train_loss.npy"))).all()
    for extra in ([], ["--decoder", "beam", "--beam_size", "4"]):
        assert cli.main(["--mode", "predict", "--corpus_path", tiny_corpus,
                         "--model_path", model, "--device", "cpu",
                         *extra]) == 0
        assert "CER:" in capsys.readouterr().out
        with open(os.path.join(model, "predicted.txt")) as fo:
            assert len(fo.read().splitlines()) == 2


# ported run options of the JAX CLI: each sets up the run, not the model
RUN_FLAGS = (["--mesh", "data=2"], ["--max_restarts", "1"],
             ["--fault_step", "3"], ["--mesh", "fsdp=8"])


@pytest.mark.parametrize("extra,message", [
    (["--mesh", "data=2"], "mesh"),
    (["--max_restarts", "1"], "max_restarts"),
    (["--fault_step", "3"], "fault_step"),
    # the switch-MoE transformer trains since it was ported
    # (tests/test_torch_moe.py); --microbatches sets the config's pipeline
    # microbatches since the pipe axis was (tests/test_torch_pipeline.py)
    (["--model", "moe", "--microbatches", "2"], "microbatches"),
    (["--mesh", "fsdp=8"], "mesh"),
    *UNPORTED_FLAGS,
])
def test_cli_train_unported_options_exit_with_message(tiny_corpus, tmp_path,
                                                      extra, message):
    if message in PORTED_FLAGS or extra in RUN_FLAGS:
        # ported since --mode export is (the export flags), since the
        # switch-MoE transformer is (--moe_experts and --capacity_factor
        # set its config, as in the JAX CLI), since NaN checks are
        # (--debug_nans is no config field) and since the data axis and the
        # elastic supervisor are (--mesh data=2 sets the config's mesh; the
        # run options --max_restarts and --fault_step are no config
        # fields, tests/test_torch_mesh.py and test_torch_elastic.py run
        # them), since the fsdp axis is (--mesh fsdp=8 sets the mesh of
        # 8 ranks, tests/test_torch_fsdp.py runs it) and since the pipe
        # axis is (--microbatches sets the pipeline's microbatches,
        # tests/test_torch_pipeline.py runs it); the others change nothing
        # in a train run, as in the JAX CLI
        base = ["--mode", "train", "--corpus_path", tiny_corpus,
                "--model_path", str(tmp_path / "m")]
        parser = cli.build_parser()
        args = parser.parse_args(base + extra)
        want_world = {"data=2": 2, "fsdp=8": 8}.get(args.mesh, 1)
        assert cli._mesh_world(args) == want_world
        cfg, want = cli.train_config(args), cli.train_config(
            parser.parse_args(base))
        moe = {"moe_experts": ("num_experts", 4),
               "capacity_factor": ("capacity_factor", 1.5)}
        if message in moe:
            field, value = moe[message]
            assert getattr(cfg.transformer, field) == value
            want = want.replace(transformer=cfg.transformer)
        if message == "mesh":
            assert (cfg.train.mesh_shape, cfg.train.mesh_axes) == (
                (want_world,), (args.mesh.split("=")[0],))
            want = want.replace(train=cfg.train)
        if message == "microbatches":
            assert cfg.train.pipeline_microbatches == 2
            want = want.replace(model=cfg.model,
                                transformer=cfg.transformer,
                                train=cfg.train)
        assert cfg == want
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "train", "--corpus_path", tiny_corpus,
                  "--model_path", str(tmp_path / "m"), "--device", "cpu",
                  *extra])
    assert "not yet ported" in str(e.value) and message in str(e.value)
    assert not os.path.exists(tmp_path / "m" / "model_last.pt")


@pytest.mark.parametrize("extra", [
    ["--lm_weight", "0.5"], ["--lm_type", "neural"], ["--lm_steps", "10"],
    ["--lm_pass", "rescore"], ["--length_bonus", "0.1"]])
def test_cli_train_takes_the_lm_flags_as_the_jax_cli(extra):
    """The LM flags (predict's and stream's) are accepted by a train run and
    change nothing in it, as in the JAX CLI: the same Config as without
    them, and no refusal."""
    base = ["--mode", "train", "--corpus_path", "c", "--model_path", "m"]
    parser = cli.build_parser()
    args = parser.parse_args(base + extra)
    assert cli._mesh_world(args) == 1
    assert cli.train_config(args) == cli.train_config(parser.parse_args(base))
