"""Training the transformer-CTC and conformer-CTC families in the port
(models/transformer_ctc.py, models/conformer_ctc.py with ``train=True``,
train.py, cli.py) vs the JAX package, on the same seeded numpy inputs and
the same weights; plus the port's `--mode train` CLI for both families on
the CPU (plain versions of the kernels).

Sizes: 2 blocks, d_model 64, 2 heads (dh 32), ffn 128, conv kernel 15; 3
utterances of 0.4, 0.25 and 0.16 s (T' = 17, 11 and 7 after frame
stacking).

Tolerances (float32): the loss rtol 1e-5 and every gradient atol 1e-4 x
its max |grad| (the same algorithm at the same precision through 2 blocks,
the CTC loss and their gradients, summation order only); the updated
params atol 1e-5 (AdamW moves each by at most ~lr = 1e-3, so a 1e-4
relative gradient difference moves it by far less, except where |g| is
near Adam's eps, see the test). Log-probs atol 1e-4,
as tests/test_torch_conformer.py. With ``flash_attention`` the JAX package
pads T' to 128 frames and runs its dense path on the CPU; the padded
frames are masked out of the loss, so loss and gradients compare directly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import (ConformerConfig, ModelConfig, TrainConfig,
                               TransformerConfig)
from pg_asr_tpu.models import conformer_ctc as jax_conformer
from pg_asr_tpu.models import transformer_ctc as jax_transformer
from pg_asr_tpu.ops.features import extract_features
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.models import conformer_ctc, transformer_ctc
from pg_asr_tpu_torch.train import AdamW, init_model_params, loss_and_grads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {"transformer": (jax_transformer, transformer_ctc,
                            TransformerConfig),
            "conformer": (jax_conformer, conformer_ctc, ConformerConfig)}
VOCAB = 9


def _config(family, flash=False, dropout=0.0, remat=False) -> JConfig:
    sub = FAMILIES[family][2](num_layers=2, d_model=64, num_heads=2,
                              ffn_dim=128, dropout=dropout,
                              flash_attention=flash)
    return JConfig(model=ModelConfig(family=family, vocab_size=VOCAB,
                                     input_dim=80, remat=remat),
                   train=TrainConfig(warmup_steps=0, learning_rate=1e-3),
                   **{family: sub})


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


def _tree(jcfg: JConfig, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_train.init_model_params(
        jax.random.PRNGKey(seed), jcfg))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_one_train_step_matches_jax(family, flash):
    """Loss, every gradient and every updated parameter of one train step
    (dropout 0) vs the JAX package's make_train_step on the same params and
    batch; with flash_attention the port runs FlashAttention's plain
    forward and backward."""
    jcfg = _config(family, flash)
    cfg = Config.from_json(jcfg.to_json())
    batch = _batch()
    tree = _tree(jcfg)
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
    loss, grads = loss_and_grads(params, [torch.from_numpy(a) for a in batch],
                                 cfg)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    # the updated params: the port's AdamW on JAX's gradients, every
    # element; on its own gradients, where |g| >> Adam's eps = 1e-8 (the
    # first step moves a param by lr * g / (|g| + eps), ill-conditioned in
    # g where |g| is near eps)
    on_ref = {k: v.clone() for k, v in params.items()}
    AdamW(cfg, on_ref).update(on_ref, r_grads)
    AdamW(cfg, params).update(params, grads)
    for k, p in params.items():
        want = new_j[k].numpy()
        np.testing.assert_allclose(on_ref[k].numpy(), want, rtol=0,
                                   atol=1e-5, err_msg=k)
        sure = np.abs(r_grads[k].numpy()) > 1e-6
        np.testing.assert_allclose(p.numpy()[sure], want[sure], rtol=0,
                                   atol=1e-5, err_msg=k)


def _features(batch):
    feats, mask, lens = extract_features(
        *(jnp.asarray(a) for a in batch[:2]), JConfig().features)
    return tuple(np.asarray(a) for a in (feats, mask, lens))


@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_dropout_sites_match_jax(family, monkeypatch):
    """The same uint8 bits, site by site in call order, into both packages
    (the tests' own substitution of the bit source; the models are
    untouched): 1 + 2L sites for the transformer, 1 + 4L for the
    conformer, on the same shapes; the log-probs agree at float32."""
    jcfg = _config(family, dropout=0.1)
    cfg = Config.from_json(jcfg.to_json())
    jmod, tmod, _ = FAMILIES[family]
    feats = _features(_batch())
    tree = _tree(jcfg)
    site_keys = [jax.random.PRNGKey(100 + i) for i in range(16)]
    j_shapes, t_shapes = [], []
    real_dropout = jmod._dropout

    def jax_dropout(x, rate, rng, train):
        key = site_keys[len(j_shapes)]
        j_shapes.append(x.shape)
        return real_dropout(x, rate, key, train)

    def port_bits(x, rate, generator, train):
        if not train:
            return None
        key = site_keys[len(t_shapes)]
        t_shapes.append(tuple(x.shape))
        return torch.from_numpy(np.array(jax.random.bits(
            key, tuple(x.shape), dtype=jnp.uint8)))

    monkeypatch.setattr(jmod, "_dropout", jax_dropout)
    monkeypatch.setattr(tmod, "dropout_bits", port_bits)
    sub = getattr(jcfg, family)
    x, out_mask, _ = jmod.encode(jax.tree_util.tree_map(jnp.asarray, tree),
                                 *(jnp.asarray(a) for a in feats), jcfg.model,
                                 sub, train=True,
                                 dropout_rng=jax.random.PRNGKey(9))
    logits = jnp.matmul(x, tree["ctc_head"]["w"]) + tree["ctc_head"]["b"]
    ref = np.asarray(jax.nn.log_softmax(logits, -1)
                     * out_mask[:, :, None])
    got, _, _ = tmod.apply(params_from_jax(tree),
                           *(torch.from_numpy(a) for a in feats), cfg.model,
                           getattr(cfg, family), train=True,
                           generator=torch.Generator())
    per_block = 2 if family == "transformer" else 4
    assert len(t_shapes) == 1 + per_block * 2
    assert [tuple(s) for s in j_shapes] == t_shapes
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-4)
    # dropout did something: without it the log-probs move
    plain, _, _ = tmod.apply(params_from_jax(tree),
                             *(torch.from_numpy(a) for a in feats),
                             cfg.model, getattr(cfg, family))
    assert (plain - got).abs().max().item() > 1e-2


@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_remat_gives_the_same_gradients_with_dropout(family):
    """--remat recomputes each block in the backward; the dropout bits are
    drawn before the block, so the recompute applies the same masks and the
    gradients equal those without remat (the same operations in the same
    order on the CPU: atol 1e-6 x max|grad|)."""
    batch = [torch.from_numpy(a) for a in _batch()]
    out = {}
    for remat in (False, True):
        cfg = Config.from_json(_config(family, flash=True, dropout=0.1,
                                       remat=remat).to_json())
        params = init_model_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        out[remat] = loss_and_grads(params, batch, cfg,
                                    torch.Generator().manual_seed(3))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert l0.item() == l1.item()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0,
                                   atol=1e-6 * g0[k].abs().max().item())
    # and the bits matter: another generator seed moves the gradients
    _, g2 = loss_and_grads(params, batch, cfg,
                           torch.Generator().manual_seed(4))
    assert any((g2[k] - g1[k]).abs().max() > 1e-4 for k in g1)


@pytest.mark.parametrize("family", ["ctc", "transformer", "conformer"])
def test_init_model_params_dispatches_by_family(family):
    jcfg = (JConfig(model=ModelConfig(vocab_size=VOCAB, hidden_size=16,
                                      input_proj_dim=32, num_layers=1))
            if family == "ctc" else _config(family))
    cfg = Config.from_json(jcfg.to_json())
    got = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = params_from_jax(_tree(jcfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def test_moe_transformer_is_refused():
    # ported since the switch-MoE transformer is (tests/test_torch_moe.py):
    # init_model_params dispatches num_experts > 0 to the MoE tree, with
    # the JAX package's shapes
    jcfg = _config("transformer")
    jcfg = jcfg.replace(transformer=jcfg.transformer.__class__(
        **{**jcfg.transformer.__dict__, "num_experts": 4}))
    cfg = Config.from_json(jcfg.to_json())
    got = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = params_from_jax(_tree(jcfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert got["blocks.1.w1"].shape == (4, 64, 128)


# ---------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("attn_train_corpus")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=16, seed=0,
                                      min_dur=0.2, max_dur=0.4)
    return corpus


@pytest.mark.parametrize("family,extra", [
    ("transformer", []),
    ("conformer", ["--dtype", "bfloat16", "--remat"])])
def test_cli_train_resume_predict_cpu(tiny_corpus, tmp_path, capsys, family,
                                      extra):
    """Full default width (6 blocks, d_model 256) on the tiny corpus:
    train an epoch with --flash_attention, resume for a second one with
    neither --model nor --flash_attention (the family and its config come
    from config.json; LayerNorm params stay float32 in a bf16 run), then
    predict greedy and beam."""
    model = str(tmp_path / "model")
    argv = ["--mode", "train", "--corpus_path", tiny_corpus, "--model_path",
            model, "--batch_size", "4", "--device", "cpu"]
    assert cli.main(argv + ["--num_epochs", "1", "--model", family,
                            "--flash_attention", *extra]) == 0
    assert cli.main(argv + ["--num_epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    assert f"resuming with model family '{family}'" in out
    with open(os.path.join(model, "config.json")) as fo:
        saved = json.load(fo)
    assert saved["model"]["family"] == family
    assert saved[family]["flash_attention"] is True
    assert saved["model"]["remat"] == ("--remat" in extra)
    tl = np.load(os.path.join(model, "train_loss.npy"))
    assert tl.shape == (2,) and np.isfinite(tl).all()
    state = torch.load(os.path.join(model, "model_last.pt"),
                       weights_only=True)
    assert state["step"] == 6 and state["epoch"] == 2
    dtype = torch.bfloat16 if "bfloat16" in extra else torch.float32
    for k, v in state["params"].items():
        is_ln = k.split(".")[-2].startswith("ln")
        assert v.dtype == (torch.float32 if is_ln else dtype), k
    assert state["params"]["blocks.5.qkv.w"].shape == (256, 768)

    for decoder in ("greedy", "beam"):
        assert cli.main(["--mode", "predict", "--corpus_path", tiny_corpus,
                         "--model_path", model, "--device", "cpu",
                         "--decoder", decoder, "--beam_size", "4"]) == 0
        assert "CER:" in capsys.readouterr().out
        with open(os.path.join(model, "predicted.txt")) as fo:
            assert len(fo.read().splitlines()) == 2
