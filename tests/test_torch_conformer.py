"""The port's transformer-CTC and conformer-CTC (models/transformer_ctc.py,
models/conformer_ctc.py, inference) vs the JAX package's, on the same
features and the same weights carried across by ``convert.params_from_jax``;
the parameter bridge both ways; and the predict slice through the CLI.
(Their training: tests/test_torch_attn_train.py.)

Sizes: 2 layers, d_model 64, 2 heads (dh 32), ffn 128; the waveform
workload of tests/test_flash_attn.py (2 utterances, 1.5 s and 0.75 s).

Tolerances. float32: log-probs atol 1e-4 on every frame of the port's T'
(the same algorithm at the same precision through 2 blocks; ~2e-6 in
development), out_mask and out_lens exactly equal. With flash_attention
the JAX package pads T' to 128 frames for its TPU kernel (on the CPU it
then runs its dense path), so the comparison takes its [:, :T']. bfloat16:
the two frameworks round at different places (XLA's CPU backend may keep
float32 across fused elementwise ops, torch rounds after each op), so each
log-prob may move by a few bf16 ulps of the activations; atol 0.15 (~4e-2
seen in development) and mean abs error 1e-2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_asr_tpu.checkpoint import save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import (ConformerConfig, FeatureConfig, ModelConfig,
                               TransformerConfig)
from pg_asr_tpu.data.dataset import (BatchIterator, load_manifest,
                                     make_synthetic_corpus)
from pg_asr_tpu.models import conformer_ctc as jax_conformer
from pg_asr_tpu.models import transformer_ctc as jax_transformer
from pg_asr_tpu.ops.features import extract_features
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import save_model
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.models import conformer_ctc, transformer_ctc
from pg_asr_tpu_torch.predict import forward, load_model
from pg_asr_tpu_torch.predict import predict as torch_predict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {"transformer": (jax_transformer, transformer_ctc,
                            TransformerConfig),
            "conformer": (jax_conformer, conformer_ctc, ConformerConfig)}
# (family, flash_attention, attn_softmax_bf16); the transformer has no flag
CASES = [("transformer", False, None), ("transformer", True, None)] + [
    ("conformer", flash, sm) for flash in (False, True) for sm in (True,
                                                                   False)]


def _config(family, flash=False, softmax_bf16=None, dtype="float32",
            vocab=16) -> JConfig:
    kw = dict(num_layers=2, d_model=64, num_heads=2, ffn_dim=128,
              dropout=0.0, flash_attention=flash)
    if softmax_bf16 is not None:
        kw["attn_softmax_bf16"] = softmax_bf16
    mcfg = ModelConfig(family=family, vocab_size=vocab, input_dim=80,
                       dtype=dtype)
    return JConfig(model=mcfg, **{family: FAMILIES[family][2](**kw)})


def _tree(jcfg: JConfig, seed=0):
    family = jcfg.model.family
    params = FAMILIES[family][0].init_params(
        jax.random.PRNGKey(seed), jcfg.model, getattr(jcfg, family))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def workload():
    """tests/test_flash_attn.py's waveform workload, as numpy features."""
    rng = np.random.default_rng(3)
    B, n = 2, 24000
    wave = jnp.asarray(rng.standard_normal((B, n)) * 0.1, jnp.float32)
    ns = jnp.asarray([n, n // 2], jnp.int32)
    feats, mask, lens = extract_features(wave, ns, FeatureConfig(
        kind="logmel", n_mels=80))
    return tuple(np.array(a) for a in (feats, mask, lens))


def _both(jcfg: JConfig, tree, workload):
    family = jcfg.model.family
    jmod, tmod, _ = FAMILIES[family]
    ref = jmod.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                     *(jnp.asarray(a) for a in workload), jcfg.model,
                     getattr(jcfg, family))
    pcfg = Config.from_json(jcfg.to_json())
    got = tmod.apply(params_from_jax(tree),
                     *(torch.from_numpy(a) for a in workload), pcfg.model,
                     getattr(pcfg, family))
    return [np.asarray(r) for r in ref], got


@pytest.mark.parametrize("family,flash,softmax_bf16", CASES)
def test_apply_matches_jax_float32(workload, family, flash, softmax_bf16):
    jcfg = _config(family, flash, softmax_bf16)
    (lp, mask, lens), (glp, gmask, glens) = _both(jcfg, _tree(jcfg),
                                                   workload)
    To = -(-workload[0].shape[1] // 2)
    assert glp.shape == (2, To, 16) and glp.dtype == torch.float32
    assert lp.shape[1] == (128 if flash else To)
    np.testing.assert_array_equal(glens.numpy(), lens)
    np.testing.assert_array_equal(gmask.numpy(), mask[:, :To])
    np.testing.assert_allclose(glp.numpy(), lp[:, :To], rtol=0, atol=1e-4)
    assert glens.tolist() == [61, 31]  # ragged: the second row is padded
    assert np.all(glp.numpy()[gmask.numpy() == 0] == 0.0)


@pytest.mark.parametrize("family,flash,softmax_bf16", CASES)
def test_apply_matches_jax_bfloat16(workload, family, flash, softmax_bf16):
    jcfg = _config(family, flash, softmax_bf16, dtype="bfloat16")
    tree = _tree(jcfg)
    (lp, _, lens), (glp, gmask, glens) = _both(jcfg, tree, workload)
    To = glp.shape[1]
    np.testing.assert_array_equal(glens.numpy(), lens)
    err = np.abs(glp.numpy() - lp[:, :To])[gmask.numpy() > 0]
    assert err.max() <= 0.15 and err.mean() <= 1e-2, (err.max(), err.mean())


@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_params_round_trip_is_exact(family):
    jcfg = _config(family, dtype="bfloat16")
    tree = _tree(jcfg)
    state = params_from_jax(tree)
    blk = "blocks.1."
    assert {"input_proj.w", "ln_final.scale", "ctc_head.b", blk + "qkv.w",
            blk + "attn_out.b"} <= set(state)
    if family == "conformer":
        assert tuple(state[blk + "conv_dw"].shape) == (15, 1, 64)
        assert state[blk + "ln_mid.scale"].dtype == torch.float32
    else:
        assert state[blk + "ln2.bias"].dtype == torch.float32
    assert state[blk + "qkv.w"].dtype == torch.bfloat16
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_init_params_match_jax_shapes_and_dtypes(family):
    jcfg = _config(family, dtype="bfloat16")
    ref = params_from_jax(_tree(jcfg))
    pcfg = Config.from_json(jcfg.to_json())
    got = FAMILIES[family][1].init_params(pcfg.model, getattr(pcfg, family),
                                          torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in ref.items()}
    for k, v in got.items():
        if k.endswith((".b", ".scale", ".bias")):  # constants: equal
            torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


# --- the predict slice: the CLI on the CPU vs JAX's predict

CORPUS_SEED, MODEL_SEED, BATCH = 3, 1, 4


@pytest.fixture(scope="module")
def attention_slice(tmp_path_factory):
    """One corpus; per family a JAX checkpoint and the port's, same weights,
    flash_attention set in config.json."""
    d = tmp_path_factory.mktemp("attention_slice")
    corpus, alphabet = make_synthetic_corpus(
        str(d / "corpus"), n_utts=32, seed=CORPUS_SEED, min_dur=0.3,
        max_dur=1.0)
    dirs = {}
    for family in FAMILIES:
        jcfg = _config(family, flash=True, vocab=alphabet.size)
        tree = _tree(jcfg, MODEL_SEED)
        jax_dir, torch_dir = str(d / f"jax_{family}"), str(d / family)
        os.makedirs(jax_dir)
        with open(os.path.join(jax_dir, "config.json"), "w") as fo:
            fo.write(jcfg.to_json())
        save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                        {"params": tree})
        save_model(torch_dir, params_from_jax(tree),
                   Config.from_json(jcfg.to_json()))
        dirs[family] = (jax_dir, torch_dir)
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    return paths, alphabet, dirs


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
@pytest.mark.parametrize("family", ["transformer", "conformer"])
def test_cli_predict_matches_jax_package(attention_slice, family, decoder,
                                         capsys):
    """Same predicted.txt byte for byte and the same CER/WER. Fair bar:
    every valid frame's top two log-probs lie more than 2e-4 apart
    (asserted), twice the model parity bound of 1e-4, so no greedy argmax
    can flip; the beam searches the same posteriors in float32."""
    paths, alphabet, dirs = attention_slice
    jax_dir, torch_dir = dirs[family]
    params, cfg = load_model(torch_dir, alphabet, device="cpu")
    assert getattr(cfg, family).flash_attention
    margin = np.inf
    utts = load_manifest(paths["test_path"], paths["aud_path"])
    for b in BatchIterator(utts, alphabet, BATCH, shuffle=False):
        lp, mask, _ = forward(params, torch.from_numpy(b.wave),
                              torch.from_numpy(b.num_samples), cfg)
        top2 = lp.topk(2, dim=-1).values
        margin = min(margin, (top2[..., 0] - top2[..., 1])[mask > 0].min()
                     .item())
    assert margin > 2e-4

    ref = jax_predict(**paths, model_path=jax_dir, batch_size=BATCH,
                      decoder=decoder)
    with open(os.path.join(jax_dir, "predicted.txt")) as fo:
        ref_txt = fo.read()
    capsys.readouterr()
    assert cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                     "--aud_path", paths["aud_path"], "--alphabet",
                     paths["alphabet_path"], "--model_path", torch_dir,
                     "--batch_size", str(BATCH), "--decoder", decoder,
                     "--device", "cpu"]) == 0
    assert "CER:" in capsys.readouterr().out
    with open(os.path.join(torch_dir, "predicted.txt")) as fo:
        got_txt = fo.read()
    assert got_txt == ref_txt
    assert len(got_txt.splitlines()) == len(utts) == ref["num_utts"]
    assert any(line.split("|")[1] for line in got_txt.splitlines())
    got = torch_predict(**paths, model_path=torch_dir, batch_size=BATCH,
                        decoder=decoder, device="cpu")
    assert got == ref


@pytest.mark.parametrize("model", ["moe"])
def test_cli_train_of_attention_families_exits_not_ported(tmp_path, model):
    # the switch-MoE transformer trains since it was ported
    # (tests/test_torch_moe.py), on an expert mesh since that was
    # (tests/test_torch_expert.py), on an expert x model mesh since the
    # model axis was (tests/test_torch_tensor.py); a pipe x model mesh,
    # ported since (tests/test_torch_pipeline.py), refuses it before any
    # rank starts, with the JAX package's message
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "train", "--model", model, "--flash_attention",
                  "--mesh", "data=1,pipe=2,model=2",
                  "--corpus_path", str(tmp_path / "corpus"), "--model_path",
                  str(tmp_path / "model"), "--device", "cpu"])
    assert str(e.value) == (
        "--mesh data=1,pipe=2,model=2: 'pipe' axis requires the dense "
        "transformer family (got family='transformer', num_experts=4)")
