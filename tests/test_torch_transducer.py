"""The port's RNN-T transducer training slice (pg_asr_tpu_torch/
ops/transducer.py, models/transducer.py, the transducer branches of
train.py and cli.py) vs the JAX package, on the same seeded numpy inputs
and the same weights (through convert.params_from_jax).

Sizes: vocab 9; BiLSTM encoder 2 x 16/dir (proj 32); transformer and
conformer encoders 2 blocks, d_model 32, 2 heads, ffn 64; prediction net
8/16, joint 32; 3 utterances of 0.4, 0.25 and 0.16 s (T = 33, 21, 13
frames) with 5, 3 and 0 labels (the last row is batch padding).

Tolerances (float32: the same algorithm in the same precision, summation
order only): the loss and its terms rtol 1e-5; lattice tables atol 1e-4
(through the encoder, as tests/test_torch_attn_train.py's log-probs); every
gradient atol 1e-4 x its max |grad|; updated params atol 1e-5 (AdamW moves
each by ~lr = 1e-3). bfloat16 bounds are stated where they are used.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import (ConformerConfig, ModelConfig, TrainConfig,
                               TransducerConfig, TransformerConfig)
from pg_asr_tpu.models import transducer as jax_tr
from pg_asr_tpu.ops import transducer as jax_ops
from pg_asr_tpu.ops.features import extract_features
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.data import load_manifest, make_synthetic_corpus
from pg_asr_tpu_torch.models import cast_params, transducer
from pg_asr_tpu_torch.ops import transducer as ops
from pg_asr_tpu_torch.ops.lstm import lstm_scan_plain
from pg_asr_tpu_torch.train import (AdamW, init_model_params, loss_and_grads,
                                    train)

VOCAB = 9
ENCODERS = ("bilstm", "transformer", "conformer")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(encoder="bilstm", fused=False, ctc_weight=0.0, dtype="float32"
            ) -> JConfig:
    attn = dict(num_layers=2, d_model=32, num_heads=2, ffn_dim=64,
                dropout=0.0)
    return JConfig(
        model=ModelConfig(family="transducer", vocab_size=VOCAB,
                          input_proj_dim=32, hidden_size=16, num_layers=2,
                          dropout=0.0, dtype=dtype),
        transformer=TransformerConfig(**attn),
        conformer=ConformerConfig(**attn),
        transducer=TransducerConfig(encoder=encoder, pred_embed_dim=8,
                                    pred_hidden=16, joint_dim=32,
                                    fused_joint=fused, ctc_weight=ctc_weight),
        train=TrainConfig(warmup_steps=0, learning_rate=1e-3))


def _batch():
    rng = np.random.default_rng(0)
    ns = np.array([6400, 4000, 2500], np.int32)
    wave = np.where(np.arange(6400)[None] < ns[:, None],
                    rng.standard_normal((3, 6400)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, VOCAB, (3, 5)).astype(np.int32)
    label_lens = np.array([5, 3, 0], np.int32)  # row 2: no labels
    for b in range(3):
        labels[b, label_lens[b]:] = 0
    return wave, ns, labels, label_lens


def _tree(jcfg: JConfig, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_tr.init_params(
        jax.random.PRNGKey(seed), jcfg))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's fused joint on the CPU: its Pallas kernels in
    interpret mode (patched here, as tests/test_pallas_joint.py does;
    pg_asr_tpu is untouched)."""
    import pg_asr_tpu.ops.pallas_joint as pj

    orig = pj.fused_joint_log_probs

    def interp(e, g, W, b, onehot, interpret=False):
        return orig(e, g, W, b, onehot, True)

    monkeypatch.setattr(pj, "fused_joint_log_probs", interp)


# ---------------------------------------------------------------- the loss

def _lattice(seed=0, B=5, T=9, U=4, A=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, A)).astype(np.float32)
    labels = rng.integers(1, A, (B, U)).astype(np.int32)
    # rows: full, shorter, one frame, no labels (padding), no frames
    frame_lens = np.array([T, 6, 1, 4, 0], np.int32)
    label_lens = np.array([U, 2, 3, 0, 2], np.int32)
    for b in range(B):
        labels[b, label_lens[b]:] = 0
    return logits, labels, frame_lens, label_lens


def test_joint_log_probs_matches_jax():
    logits, labels, _, _ = _lattice()
    ref = jax_ops.joint_log_probs(jnp.asarray(logits), jnp.asarray(labels))
    got = ops.joint_log_probs(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("label_normalize", [True, False])
def test_loss_values_terms_and_gradients_match_jax(label_normalize):
    """transducer_loss per row (padding rows included), the terms, and
    the gradient of the mean with respect to the logits (autograd through
    the diagonal recursion vs jax.grad): atol 1e-6 on the gradient."""
    logits, labels, fl, ll = _lattice()
    j_lab, j_fl, j_ll = (jnp.asarray(a) for a in (labels, fl, ll))

    def j_mean(x):
        lb, ly = jax_ops.joint_log_probs(x, j_lab)
        return jax_ops.transducer_loss_mean(lb, ly, j_fl, j_ll,
                                            label_normalize)

    lb, ly = jax_ops.joint_log_probs(jnp.asarray(logits), j_lab)
    ref_nll = np.asarray(jax_ops.transducer_loss(lb, ly, j_fl, j_ll))
    ref_terms = jax_ops.transducer_loss_terms(lb, ly, j_fl, j_ll,
                                              label_normalize)
    ref_grad = np.asarray(jax.grad(j_mean)(jnp.asarray(logits)))

    x = torch.from_numpy(logits).requires_grad_(True)
    t_lab, t_fl, t_ll = (torch.from_numpy(a) for a in (labels, fl, ll))
    tb, ty = ops.joint_log_probs(x, t_lab)
    nll = ops.transducer_loss(tb, ty, t_fl, t_ll)
    np.testing.assert_allclose(nll.detach().numpy(), ref_nll, rtol=1e-5)
    num, den = ops.transducer_loss_terms(tb, ty, t_fl, t_ll,
                                         label_normalize)
    np.testing.assert_allclose(num.item(), float(ref_terms[0]), rtol=1e-5)
    assert den.item() == float(ref_terms[1]) == 4.0  # the padding row out
    ops.transducer_loss_mean(tb, ty, t_fl, t_ll, label_normalize).backward()
    np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=0, atol=1e-6)
    assert not x.grad[3].any()  # the padding row has no gradient


def test_loss_without_labels_matches_jax():
    """U = 0: the lattice is one column of blanks."""
    rng = np.random.default_rng(1)
    lb = rng.standard_normal((2, 5, 1)).astype(np.float32)
    ly = np.zeros((2, 5, 0), np.float32)
    fl, ll = np.array([5, 3], np.int32), np.array([0, 0], np.int32)
    ref = jax_ops.transducer_loss(*(jnp.asarray(a) for a in (lb, ly, fl, ll)))
    got = ops.transducer_loss(*(torch.from_numpy(a) for a in (lb, ly, fl,
                                                              ll)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


# ------------------------------------------------- model pieces vs JAX

def _feats(batch):
    feats, mask, lens = extract_features(
        *(jnp.asarray(a) for a in batch[:2]), JConfig().features)
    return tuple(np.asarray(a) for a in (feats, mask, lens))


# bf16 prediction states (|g| < 1) against JAX's XLA scan: both round h,
# c, h @ U and every gate operation (jax.nn.sigmoid is 1 / (1 + exp(-x)),
# each step rounded) to bf16 at the same points, and agree exactly here.
# Bounds: max 2^-8 (one bf16 ulp near 1, for a stray rounding on another
# host) and mean 2e-5; the control with the Pallas kernel's numerics
# (float32 carries, lstm_scan_plain) differs by ~1.2e-4 on the mean and
# must fail the mean bound.
PRED_BF16 = {"max": 2.0 ** -8, "mean": 2e-5}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_states_match_jax(dtype):
    jcfg = _config(dtype=dtype)
    cfg = Config.from_json(jcfg.to_json())
    tree = _tree(jcfg)
    _, _, labels, ll = _batch()
    ref = np.asarray(jax_tr.predict_states(
        _jtree(tree), jnp.asarray(labels), jnp.asarray(ll), jcfg
    ).astype(jnp.float32))
    params = params_from_jax(tree)
    got = transducer.predict_states(params, torch.from_numpy(labels),
                                    torch.from_numpy(ll), cfg)
    assert got.dtype == params["pred_lstm.W"].dtype
    err = np.abs(got.float().numpy() - ref)
    if dtype == "float32":
        assert err.max() <= 1e-6
        return
    # the control: the same net through the Pallas kernel's numerics
    x = params["pred_embed"][torch.nn.functional.pad(
        torch.from_numpy(labels).long(), (1, 0))]
    xp = x @ params["pred_lstm.W"] + params["pred_lstm.b"]
    umask = (torch.arange(6)[None] <= torch.from_numpy(ll)[:, None]).float()
    control = lstm_scan_plain(xp, params["pred_lstm.U"], umask)
    ctrl = np.abs(control.float().numpy() - ref).mean()
    assert err.max() <= PRED_BF16["max"], err.max()
    assert err.mean() <= PRED_BF16["mean"] < ctrl, (err.mean(), ctrl)


# bf16 lattice tables of the attention encoders vs JAX: each framework
# rounds the encoder's activations to bf16 at its own points, so the
# tables (log-probs of magnitude ~2-5) differ by a few bf16 ulps of the
# joint's inputs; a bound of 0.1 on the max and 0.01 on the mean absolute
# error still catches a wrong table (errors of order 1)
LATTICE_BF16 = {"max": 0.1, "mean": 0.01}


@pytest.mark.parametrize("encoder,dtype,with_ctc", [
    ("bilstm", "float32", False), ("bilstm", "float32", True),
    ("transformer", "float32", False), ("transformer", "bfloat16", True),
    ("conformer", "float32", True), ("conformer", "bfloat16", False)])
def test_apply_lattice_matches_jax(encoder, dtype, with_ctc):
    """The lattice tables (and with_ctc the auxiliary CTC log-probs) of
    each encoder; the BiLSTM in float32 only (the JAX package's CPU path
    runs the XLA scan, whose bf16 carries differ from the Pallas numerics
    the port's encoder follows)."""
    jcfg = _config(encoder, ctc_weight=0.3 if with_ctc else 0.0, dtype=dtype)
    cfg = Config.from_json(jcfg.to_json())
    tree = _tree(jcfg)
    feats, mask, lens = _feats(_batch())
    _, _, labels, ll = _batch()
    ref = jax_tr.apply_lattice(_jtree(tree), *(jnp.asarray(a) for a in
                                               (feats, mask, lens, labels,
                                                ll)), jcfg, with_ctc=with_ctc)
    got = transducer.apply_lattice(
        params_from_jax(tree), *(torch.from_numpy(a) for a in
                                 (feats, mask, lens, labels, ll)), cfg,
        with_ctc=with_ctc)
    assert len(got) == len(ref) == (4 if with_ctc else 3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for name, g, r in zip(("lp_blank", "lp_label", "ctc_lp"),
                          (got[0], got[1], *got[3:]),
                          (ref[0], ref[1], *ref[3:])):
        assert g.dtype == torch.float32, name
        d = np.abs(g.numpy() - np.asarray(r, np.float32))
        if dtype == "float32":
            assert d.max() <= 1e-4, (name, d.max())
        else:
            assert (d.max() <= LATTICE_BF16["max"]
                    and d.mean() <= LATTICE_BF16["mean"]), (name, d.max(),
                                                            d.mean())


# ------------------------------------------------- one train step vs JAX

def _jax_step(jcfg, tree, batch, key):
    r_loss, r_grads = jax.value_and_grad(
        lambda p: jax_train.compute_loss(p, *map(jnp.asarray, batch), jcfg,
                                         train=True, dropout_rng=key))(
        _jtree(tree))
    opt = jax_train.make_optimizer(jcfg)
    j_params = _jtree(tree)
    new_j, _, _, j_loss = jax_train.make_train_step(jcfg, opt)(
        j_params, opt.init(j_params), key, *map(jnp.asarray, batch))
    return (float(r_loss), float(j_loss),
            params_from_jax(jax.tree_util.tree_map(np.asarray, r_grads)),
            params_from_jax(jax.tree_util.tree_map(np.asarray, new_j)))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("encoder", ENCODERS)
def test_one_train_step_matches_jax(encoder, fused, pallas_interpret):
    """Loss, every gradient and every updated parameter of one train step
    (dropout 0) vs the JAX package's make_train_step on the same params and
    batch; fused: the port's plain fused joint against the Pallas kernels
    in interpret mode."""
    jcfg = _config(encoder, fused=fused)
    cfg = Config.from_json(jcfg.to_json())
    batch = _batch()
    tree = _tree(jcfg)
    r_loss, j_loss, r_grads, new_j = _jax_step(jcfg, tree, batch,
                                               jax.random.PRNGKey(1))
    params = params_from_jax(tree)
    loss, grads = loss_and_grads(params, [torch.from_numpy(a) for a in batch],
                                 cfg)
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    # the updated params, on JAX's gradients and on the port's, where |g|
    # >> Adam's eps = 1e-8: the first step moves a param by lr * g / (|g| +
    # eps), ill-conditioned in g where |g| is near eps (the attention's key
    # bias has a gradient of ~1e-9 that jit and eager JAX already disagree
    # on)
    on_ref = {k: v.clone() for k, v in params.items()}
    AdamW(cfg, on_ref).update(on_ref, r_grads)
    AdamW(cfg, params).update(params, grads)
    for k, p in params.items():
        want = new_j[k].numpy()
        sure = np.abs(r_grads[k].numpy()) > 1e-6
        for got in (on_ref[k], p):
            np.testing.assert_allclose(got.numpy()[sure], want[sure], rtol=0,
                                       atol=1e-5, err_msg=k)


def test_hybrid_ctc_weight_loss_matches_jax():
    """L = L_rnnt + 0.3 L_ctc through the auxiliary head: the loss, its
    gradients (the head's included) vs jax.grad, and the two parts."""
    jcfg = _config("conformer", ctc_weight=0.3)
    cfg = Config.from_json(jcfg.to_json())
    batch = _batch()
    tree = _tree(jcfg)
    assert "ctc_head" in tree
    r_loss, _, r_grads, _ = _jax_step(jcfg, tree, batch,
                                      jax.random.PRNGKey(1))
    params = params_from_jax(tree)
    arrays = [torch.from_numpy(a) for a in batch]
    loss, grads = loss_and_grads(params, arrays, cfg)
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    assert grads["ctc_head.w"].abs().max() > 0
    # the hybrid adds 0.3 x a positive CTC loss to the transducer's
    plain, _ = loss_and_grads(
        {k: v for k, v in params.items() if not k.startswith("ctc_head.")},
        arrays, cfg.replace(transducer=dataclasses.replace(
            cfg.transducer, ctc_weight=0.0)))
    assert loss.item() > plain.item()
    # both CTC implementations give the same hybrid loss
    ref_path, _ = loss_and_grads(params, arrays, cfg, use_kernel=False)
    np.testing.assert_allclose(ref_path.item(), loss.item(), rtol=1e-5)


# ------------------------------------------------- parameters

@pytest.mark.parametrize("encoder,ctc_weight", [
    ("bilstm", 0.0), ("transformer", 0.5), ("conformer", 0.0)])
def test_init_params_and_convert_round_trip(encoder, ctc_weight):
    """The port's init has the JAX init's names, shapes and dtypes;
    params_from_jax / params_to_jax round-trip the tree exactly; cast_params
    keeps the encoder's LayerNorm params float32 in bf16."""
    jcfg = _config(encoder, ctc_weight=ctc_weight)
    cfg = Config.from_json(jcfg.to_json())
    tree = _tree(jcfg)
    ref = params_from_jax(tree)
    got = init_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in ref.items()}
    assert ("ctc_head.w" in got) == (ctc_weight > 0)
    back = params_to_jax(ref)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bf = cast_params(got, torch.bfloat16, "cpu")
    for k, v in bf.items():
        is_ln = k.startswith("encoder.") and k.split(".")[-2].startswith("ln")
        assert v.dtype == (torch.float32 if is_ln else torch.bfloat16), k
    assert any(k.startswith("encoder.") and ".ln" in k for k in bf) == (
        encoder != "bilstm")


def test_fused_joint_resolution(monkeypatch):
    """"auto" is unfused on CPU tensors (fused only on CUDA); True is the
    fused joint (its plain versions on the CPU); False unfused."""
    calls = []
    real = transducer.fused_joint

    def counting(*a, **k):
        calls.append(k.get("use_kernel"))
        return real(*a, **k)

    monkeypatch.setattr(transducer, "fused_joint", counting)
    feats, mask, lens = _feats(_batch())
    _, _, labels, ll = _batch()
    out = {}
    for flag in (False, "auto", True):
        jcfg = _config(fused=flag)
        cfg = Config.from_json(jcfg.to_json())
        assert cfg.transducer.fused_joint == flag
        params = params_from_jax(_tree(jcfg))
        calls.clear()
        out[flag] = transducer.apply_lattice(
            params, *(torch.from_numpy(a) for a in
                      (feats, mask, lens, labels, ll)), cfg)
        assert calls == ([True] if flag is True else []), flag
    for a, b in zip(out[True][:2], out[False][:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- CLI

@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("transducer_corpus")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=16, seed=0,
                                      min_dur=0.2, max_dur=0.4)
    return corpus


def test_cli_train_then_resume_then_predict_is_refused(tiny_corpus, tmp_path,
                                                       capsys):
    """--model transducer with a BiLSTM encoder and the hybrid CTC head
    through the CLI (full default width, dropout on), a resumed second
    epoch that omits --model and keeps the transducer's config, then
    --mode predict on the trained model, greedy and beam (predicted.txt,
    CER/WER); --lm_order is refused with the JAX package's message."""
    model = str(tmp_path / "model")
    argv = ["--mode", "train", "--corpus_path", tiny_corpus, "--model_path",
            model, "--batch_size", "4", "--device", "cpu"]
    assert cli.main(argv + ["--num_epochs", "1", "--model", "transducer",
                            "--transducer_encoder", "bilstm",
                            "--transducer_ctc_weight", "0.2"]) == 0
    assert cli.main(argv + ["--num_epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out
    with open(os.path.join(model, "config.json")) as fo:
        saved = json.load(fo)
    assert saved["model"]["family"] == "transducer"
    assert saved["transducer"]["encoder"] == "bilstm"
    assert saved["transducer"]["ctc_weight"] == 0.2
    tl = np.load(os.path.join(model, "train_loss.npy"))
    vl = np.load(os.path.join(model, "val_losses.npy"))
    assert tl.shape == vl.shape == (2,) and np.isfinite(tl).all()
    state = torch.load(os.path.join(model, "model_last.pt"),
                       weights_only=True)
    assert state["step"] == 6 and state["epoch"] == 2
    with open(os.path.join(tiny_corpus, "alphabet.txt")) as fo:
        vocab = 1 + len(fo.read().splitlines())
    assert state["params"]["joint_out.w"].shape == (256, vocab)
    assert "ctc_head.w" in state["params"]

    predict = ["--mode", "predict", "--corpus_path", tiny_corpus,
               "--model_path", model, "--device", "cpu"]
    n_test = len(load_manifest(os.path.join(tiny_corpus, "test.tsv"),
                               os.path.join(tiny_corpus, "clips")))
    for extra in ([], ["--decoder", "beam", "--beam_size", "2"]):
        assert cli.main(predict + extra) == 0
        assert "CER:" in capsys.readouterr().out
        with open(os.path.join(model, "predicted.txt")) as fo:
            lines = fo.read().splitlines()
        assert len(lines) == n_test and all("|" in ln for ln in lines)
    with pytest.raises(SystemExit) as e:
        cli.main(predict + ["--decoder", "beam", "--lm_order", "2"])
    assert "IS its language model" in str(e.value)


def test_resume_keeps_fused_joint_from_config_json(tiny_corpus, tmp_path,
                                                   monkeypatch, capsys):
    """fused_joint has no CLI flag: train(config=...) sets it, and a CLI
    resume without --model keeps it from config.json (its steps go through
    the fused joint)."""
    model = str(tmp_path / "model")
    jcfg = _config("transformer", fused=True)
    cfg = Config.from_json(jcfg.to_json())
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, num_epochs=1, batch_size=4, warmup_steps=2))
    calls = []
    real = transducer.fused_joint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(transducer, "fused_joint", counting)
    out = train(tiny_corpus, model, config=cfg, device="cpu")
    first = len(calls)
    assert first == out["steps"] + 1  # 3 steps + 1 dev batch
    calls.clear()
    assert cli.main(["--mode", "train", "--corpus_path", tiny_corpus,
                     "--model_path", model, "--batch_size", "4",
                     "--device", "cpu", "--num_epochs", "2"]) == 0
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert len(calls) == first
    with open(os.path.join(model, "config.json")) as fo:
        saved = json.load(fo)
    assert saved["transducer"]["fused_joint"] is True
    assert saved["transducer"]["encoder"] == "transformer"
    assert saved["transformer"]["d_model"] == 32
