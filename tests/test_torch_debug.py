"""`--debug_nans` and the NaN helpers of the port (pg_asr_tpu_torch/utils/
debug.py) vs the JAX package's (pg_asr_tpu/utils/debug.py): the helpers on
the same arrays, and a model whose weights hold a NaN, which the JAX
package's NaN checks stop at its first step and the port's CLI stops with
the same FloatingPointError in train and finetune_pg (without the flag the
port's run goes on, as the JAX package's does), and in predict (greedy and
beam), align, pseudolabel, stream, export and the dev pass. As under the
JAX package's jax_debug_nans, a NaN raises and +-Inf passes: an infinite
loss and an infinite gradient go through in both packages."""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.models import transformer_ctc as jax_transformer
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig, TransformerConfig
from pg_asr_tpu.utils import debug as jax_debug
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.utils import debug


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    b[[1, 3]] = [np.nan, -np.inf]
    c = rng.standard_normal((2, 2)).astype(np.float32)
    c[0, 0] = np.inf
    return {"blocks.0.qkv.w": a, "blocks.0.qkv.b": b, "ctc_head.w": c,
            "step": np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize("replace", [0.0, -1.5])
def test_sanitize_pytree_matches_jax(replace):
    arrays = _arrays()
    ref = jax_debug.sanitize_pytree(
        {k: jnp.asarray(v) for k, v in arrays.items()}, replace)
    got = debug.sanitize_pytree(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, replace)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == torch.from_numpy(arrays[k]).dtype
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("finite", [False, True])
def test_assert_all_finite_matches_jax(finite):
    arrays = _arrays()
    if finite:
        arrays = {k: np.nan_to_num(v) for k, v in arrays.items()}
    nested = {"params": arrays, "count": np.float32(np.nan if not finite
                                                    else 1.0)}
    for tree in (arrays, nested):
        want = None
        try:
            jax_debug.assert_all_finite(jax.tree_util.tree_map(
                jnp.asarray, tree), "grads")
        except FloatingPointError as e:
            want = str(e)
        torch_tree = jax.tree_util.tree_map(torch.as_tensor, tree)
        if want is None:
            debug.assert_all_finite(torch_tree, "grads")
        else:
            with pytest.raises(FloatingPointError) as e:
                debug.assert_all_finite(torch_tree, "grads")
            assert str(e.value) == want
    assert (want is None) == finite


def test_enable_nan_checks_sets_anomaly_mode():
    assert not debug.nan_checks_enabled()
    debug.enable_nan_checks()
    try:
        assert debug.nan_checks_enabled()
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    finally:
        debug.enable_nan_checks(False)
    assert not debug.nan_checks_enabled() and not torch.is_anomaly_enabled()


def test_jax_package_nan_checks_stop_a_nan_model():
    """The reference behaviour: under the JAX package's NaN checks (its
    CLI's --debug_nans) a step on weights that hold a NaN raises
    FloatingPointError."""
    jcfg = JConfig(model=ModelConfig(family="transformer", vocab_size=9,
                                     input_dim=80),
                   transformer=TransformerConfig(num_layers=1, d_model=16,
                                                 num_heads=2, ffn_dim=32,
                                                 dropout=0.0))
    tree = jax_train.init_model_params(jax.random.PRNGKey(0), jcfg)
    tree["input_proj"]["w"] = tree["input_proj"]["w"].at[0, 0].set(jnp.nan)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.standard_normal((2, 20, 80)), jnp.float32)
    mask = jnp.arange(20)[None] < jnp.asarray([20, 12])[:, None]
    jax_debug.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError):
            jax.grad(lambda p: jnp.sum(jax_transformer.apply(
                p, feats, mask, jnp.asarray([20, 12]), jcfg.model,
                jcfg.transformer)[0]))(tree)
    finally:
        jax_debug.enable_nan_checks(False)


@pytest.fixture(scope="module")
def nan_model(tmp_path_factory):
    """One CLI epoch of the default transformer-CTC on a tiny corpus, then
    a NaN written into one weight of model_best and model_last."""
    d = tmp_path_factory.mktemp("nan_model")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=16, seed=0,
                                      min_dur=0.2, max_dur=0.4)
    model = str(d / "model")
    assert cli.main(["--mode", "train", "--corpus_path", corpus,
                     "--model_path", model, "--batch_size", "4",
                     "--num_epochs", "1", "--model", "transformer",
                     "--device", "cpu"]) == 0
    for name in ("model_best.pt", "model_last.pt"):
        path = os.path.join(model, name)
        state = load_checkpoint(path)
        state["params"]["blocks.0.qkv.w"][0, 0] = float("nan")
        save_checkpoint(path, state)
    return corpus, model


@pytest.mark.parametrize("debug_nans", [True, False])
def test_cli_train_debug_nans(nan_model, tmp_path, debug_nans):
    corpus, model = nan_model
    d = str(tmp_path / "m")
    shutil.copytree(model, d)
    argv = ["--mode", "train", "--corpus_path", corpus, "--model_path", d,
            "--batch_size", "4", "--num_epochs", "2", "--device", "cpu"]
    if debug_nans:
        with pytest.raises(FloatingPointError, match="NaN values in the "
                           "loss"):
            cli.main(argv + ["--debug_nans"])
        assert not debug.nan_checks_enabled()  # off again after the run
        assert not torch.is_anomaly_enabled()
    else:
        assert cli.main(argv) == 0
        assert np.isnan(np.load(os.path.join(d, "train_loss.npy"))[-1])


def test_cli_finetune_pg_debug_nans(nan_model, tmp_path):
    corpus, model = nan_model
    d = str(tmp_path / "pg")
    shutil.copytree(model, d)
    with pytest.raises(FloatingPointError, match="NaN values"):
        cli.main(["--mode", "finetune_pg", "--corpus_path", corpus,
                  "--model_path", d, "--pg_steps", "1", "--batch_size", "4",
                  "--pg_eval_every", "0", "--device", "cpu",
                  "--debug_nans"])
    assert not debug.nan_checks_enabled()


def test_debug_nans_checks_the_gradients():
    """A finite loss whose gradient is NaN: sqrt(w) - sqrt(w) at 0, whose
    two paths bring inf and -inf to w (their sum is no backward function's
    output, so the gradient check, not the anomaly mode, finds it). An
    infinite gradient, sqrt at 0, passes under the flag, as under the JAX
    package's jax_debug_nans."""
    from pg_asr_tpu_torch.train import value_and_grad

    params = {"w": torch.zeros(3)}

    def loss(p):
        return (torch.sqrt(p["w"]) - torch.sqrt(p["w"])).sum()

    value_and_grad(loss, params)  # no checks: no raise
    debug.enable_nan_checks()
    try:
        _, grads = value_and_grad(lambda p: torch.sqrt(p["w"]).sum(), params)
        assert torch.isinf(grads["w"]).all()  # inf passes
        with pytest.raises(FloatingPointError) as e:
            value_and_grad(loss, params)
        assert str(e.value) == "NaN values in the gradients: [\"['w']\"]"
    finally:
        debug.enable_nan_checks(False)


# the modes the flag reaches beyond the steps, each on the NaN model: its
# forward's outputs hold a NaN, which raises under --debug_nans
NAN_MODES = {
    "predict": ["--mode", "predict"],
    "predict_beam": ["--mode", "predict", "--decoder", "beam",
                     "--beam_size", "2"],
    "align": ["--mode", "align"],
    "pseudolabel": ["--mode", "pseudolabel"],
    "stream": ["--mode", "stream", "--left_context", "64"],
    "export": ["--mode", "export", "--export_batch", "1",
               "--export_seconds", "0.5"],
}


@pytest.mark.parametrize("mode", list(NAN_MODES))
def test_cli_modes_debug_nans(nan_model, tmp_path, mode):
    corpus, model = nan_model
    d = str(tmp_path / "m")
    shutil.copytree(model, d)
    argv = [*NAN_MODES[mode], "--corpus_path", corpus, "--model_path", d,
            "--batch_size", "4", "--device", "cpu"]
    if mode == "stream":
        argv += ["--wav", os.path.join(corpus, "clips", "utt0000.wav")]
    with pytest.raises(FloatingPointError, match="NaN values in the "):
        cli.main(argv + ["--debug_nans"])
    assert not debug.nan_checks_enabled()


def test_debug_nans_checks_the_dev_pass(nan_model):
    """The dev pass's loss (train.make_eval_step) and its greedy CER
    (train.corpus_cer) on the NaN model's weights."""
    from pg_asr_tpu_torch.data import BatchIterator, load_manifest
    from pg_asr_tpu_torch.predict import load_model
    from pg_asr_tpu_torch.train import (batch_to_device, corpus_cer,
                                        make_eval_step)
    from pg_asr_tpu_torch.data.text import Alphabet

    corpus, model = nan_model
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    params, cfg = load_model(model, alphabet, device="cpu")
    rows = load_manifest(os.path.join(corpus, "dev.tsv"),
                         os.path.join(corpus, "clips"))
    batch = next(iter(BatchIterator(rows, alphabet, 4, shuffle=False)))
    arrays = batch_to_device(batch, "cpu")
    eval_step = make_eval_step(cfg)
    assert torch.isnan(eval_step(params, *arrays))  # no checks: no raise
    debug.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match="NaN values in the "
                           "dev loss"):
            eval_step(params, *arrays)
        with pytest.raises(FloatingPointError, match="NaN values in the "
                           "log-probs"):
            corpus_cer(params, rows, alphabet, cfg, 4)
    finally:
        debug.enable_nan_checks(False)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_debug_nans_passes_inf_and_stops_nan_log_probs(package):
    """In both packages under their NaN checks: an infinite loss (and its
    finite gradient) passes; a NaN in predict's forward (its log-probs, the
    transformer-CTC with a NaN weight) raises FloatingPointError."""
    jcfg = JConfig(model=ModelConfig(family="transformer", vocab_size=9,
                                     input_dim=80),
                   transformer=TransformerConfig(num_layers=1, d_model=16,
                                                 num_heads=2, ffn_dim=32,
                                                 dropout=0.0))
    tree = jax_train.init_model_params(jax.random.PRNGKey(0), jcfg)
    tree["input_proj"]["w"] = tree["input_proj"]["w"].at[0, 0].set(jnp.nan)
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((2, 3200)) * 0.1).astype(np.float32)
    ns = np.array([3200, 2400], np.int32)
    w = np.zeros(3, np.float32)
    if package == "jax":
        from pg_asr_tpu import predict as jax_predict

        jax_debug.enable_nan_checks()
        try:
            loss, grad = jax.value_and_grad(
                lambda x: jnp.sum(x) + jnp.inf)(jnp.asarray(w))
            assert np.isinf(float(loss)) and np.all(np.asarray(grad) == 1)
            with pytest.raises(FloatingPointError):
                jax_predict._forward(tree, jnp.asarray(wave), jnp.asarray(ns),
                                     jcfg)
        finally:
            jax_debug.enable_nan_checks(False)
        return
    from pg_asr_tpu_torch.convert import params_from_jax
    from pg_asr_tpu_torch.predict import forward
    from pg_asr_tpu_torch.train import value_and_grad

    cfg = Config.from_json(jcfg.to_json())
    params = params_from_jax(tree)
    debug.enable_nan_checks()
    try:
        loss, grads = value_and_grad(lambda p: p["w"].sum() + math.inf,
                                     {"w": torch.from_numpy(w)})
        assert math.isinf(loss.item()) and bool((grads["w"] == 1).all())
        with pytest.raises(FloatingPointError, match="NaN values in the "
                           "log-probs"):
            forward(params, torch.from_numpy(wave), torch.from_numpy(ns), cfg)
    finally:
        debug.enable_nan_checks(False)
