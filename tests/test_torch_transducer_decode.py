"""The port's RNN-T decoders (pg_asr_tpu_torch/decoding/transducer.py) and
the transducer branch of its predict entry point vs the JAX package
(pg_asr_tpu/decoding/transducer.py, pg_asr_tpu/predict.py), on the same
seeded inputs and the same weights (through convert.params_from_jax).

Sizes: vocab 7; prediction net 8/16; joint 16; encoder states of width 16
fed directly (3 utterances of 9, 5 and 1 valid frames); beam K=4; at most 2
labels per frame; labels up to 16. The weights are the JAX init from a
seed with ``joint_out.w`` scaled x4 and the encoder states drawn x2, so
that the joint's argmaxes and the beam's rankings are not near ties and
exact label equality is a fair bar.

Tolerances: labels and lengths equal in both dtypes. float32: the nll and
the n-best scores rtol 1e-5 (the same float32 operations; the products sum
in another order). bfloat16: rtol 1e-2 (1.7e-3 measured), a few bf16 ulps
of the joint's inputs (each framework rounds its bf16 products at its own
points) carried into nlls of magnitude ~3-50.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.checkpoint import save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig, TransducerConfig
from pg_asr_tpu.decoding import transducer as jax_dec
from pg_asr_tpu.models.bilstm_ctc import linear as jax_linear
from pg_asr_tpu.models import transducer as jax_tr
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import save_model
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.decoding import transducer as dec
from pg_asr_tpu_torch.predict import predict as torch_predict

VOCAB, K, MAX_SYMBOLS, L = 7, 4, 2, 16
LENS = np.array([9, 5, 1], np.int32)
NLL_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(dtype="float32", vocab=VOCAB) -> JConfig:
    return JConfig(
        model=ModelConfig(family="transducer", vocab_size=vocab,
                          input_proj_dim=16, hidden_size=8, num_layers=1,
                          dropout=0.0, dtype=dtype),
        transducer=TransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                    pred_hidden=16, joint_dim=16,
                                    max_symbols_per_frame=MAX_SYMBOLS))


def _tree(jcfg: JConfig, seed: int) -> dict:
    tree = jax.tree_util.tree_map(np.asarray, jax_tr.init_params(
        jax.random.PRNGKey(seed), jcfg))
    w = tree["joint_out"]["w"]
    tree["joint_out"]["w"] = (w * 4).astype(w.dtype)  # sharp argmaxes
    return tree


def _setup(dtype, seed=1):
    jcfg = _config(dtype)
    tree = _tree(jcfg, seed)
    rng = np.random.default_rng(seed)
    enc = (rng.standard_normal((3, 9, 16)) * 2.0).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jargs = (jax.tree_util.tree_map(jnp.asarray, tree),
             jnp.asarray(enc, jdt), jnp.asarray(LENS), jcfg)
    targs = (params_from_jax(tree), torch.from_numpy(enc).to(
        getattr(torch, dtype)), torch.from_numpy(LENS),
             Config.from_json(jcfg.to_json()))
    return jargs, targs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_matches_jax(dtype):
    jargs, targs = _setup(dtype)
    want = jax_dec.transducer_greedy_decode(*jargs, max_label_len=L)
    got = dec.transducer_greedy_decode(*targs, max_label_len=L)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].min() >= 1  # the comparison is not vacuous


def test_greedy_scan_streaming_cap_matches_jax():
    """greedy_scan's streaming arguments: labels already emitted (pos_offset)
    and a whole-stream cap stop the emissions where JAX stops them."""
    (jp, jenc, jlens, _), (tp, tenc, tlens, _) = _setup("float32", seed=2)
    offset, cap = np.array([0, 3, 1], np.int32), 4
    want = jax_dec.greedy_scan(
        jp, jax_linear(jp["joint_enc"], jenc), jlens,
        jax_dec.init_decode_state(jp, 3, jenc.dtype), L, MAX_SYMBOLS,
        pos_offset=jnp.asarray(offset), global_cap=cap)
    E = tenc @ tp["joint_enc.w"] + tp["joint_enc.b"]
    got = dec.greedy_scan(tp, E, tlens, dec.init_decode_state(tp, 3,
                                                              tenc.dtype),
                          L, MAX_SYMBOLS, pos_offset=torch.from_numpy(offset),
                          global_cap=cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy() + offset <= cap, True)
    for g, w in zip(got[2], want[2]):  # the carried decoder state
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_matches_jax(dtype):
    jargs, targs = _setup(dtype)
    want = jax_dec.transducer_beam_decode(*jargs, beam_size=K,
                                          max_label_len=L)
    got = dec.transducer_beam_decode(*targs, beam_size=K, max_label_len=L)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=NLL_RTOL[dtype])
    assert got[1][:2].min() >= 1  # the comparison is not vacuous


def test_beam_nbest_matches_jax():
    """The whole pool of K histories per utterance, in the beam's order."""
    jargs, targs = _setup("float32", seed=3)
    want = jax_dec.transducer_beam_nbest(*jargs, beam_size=K,
                                         max_label_len=L)
    got = dec.transducer_beam_nbest(*targs, beam_size=K, max_label_len=L)
    assert got[0].shape == (3, K, L)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    assert (got[2] > dec.NEG / 2).all()  # every slot holds a history


def test_hash_wraps_like_int32():
    """The rolling history hash overflows int32 as JAX's does."""
    h = torch.tensor([2 ** 31 - 1, -2 ** 31, 123456789], dtype=torch.int32)
    s = torch.tensor([5, 1, 26])
    want = np.asarray(jnp.asarray(h.numpy()) * jax_dec._HASH_M
                      + jnp.asarray(s.numpy(), jnp.int32) + 1)
    np.testing.assert_array_equal(dec._hash_step(h, s).numpy(), want)


# -------------------------------------------------- the predict entry point

@pytest.fixture(scope="module")
def predict_setup(tmp_path_factory):
    """A tiny BiLSTM-encoder transducer with the same weights as a JAX
    checkpoint and a port checkpoint (joint_out.w scaled x4, as above)."""
    d = tmp_path_factory.mktemp("transducer_predict")
    corpus, alphabet = make_synthetic_corpus(
        str(d / "corpus"), n_utts=24, seed=5, min_dur=0.3, max_dur=0.6)
    jcfg = _config(vocab=alphabet.size)
    tree = _tree(jcfg, seed=6)
    jax_dir, torch_dir = str(d / "jax_model"), str(d / "torch_model")
    os.makedirs(jax_dir)
    with open(os.path.join(jax_dir, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                    {"params": tree})
    save_model(torch_dir, params_from_jax(tree),
               Config.from_json(jcfg.to_json()))
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    return paths, jax_dir, torch_dir


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_predict_matches_jax_package(predict_setup, decoder):
    """predict() on the CPU gives JAX's predicted.txt byte for byte (one
    batch of the 3 test utterances, so JAX compiles once)."""
    paths, jax_dir, torch_dir = predict_setup
    kw = dict(batch_size=8, decoder=decoder, beam_size=K)
    ref = jax_predict(**paths, model_path=jax_dir, **kw)
    got = torch_predict(**paths, model_path=torch_dir, device="cpu", **kw)
    with open(os.path.join(jax_dir, "predicted.txt")) as fo:
        ref_txt = fo.read()
    with open(os.path.join(torch_dir, "predicted.txt")) as fo:
        got_txt = fo.read()
    assert got_txt == ref_txt
    assert any(line.split("|")[1] for line in got_txt.splitlines())
    assert got == ref


@pytest.mark.parametrize("extra,message", [
    (["--timestamps"], "label-synchronous"),
    (["--timestamps", "--decoder", "beam"], "greedy decoder only"),
    (["--decoder", "beam", "--lm_order", "2"], "IS its language model"),
])
def test_cli_refuses_what_jax_refuses(predict_setup, extra, message):
    """--timestamps and --lm_order exit with the JAX package's messages for
    a transducer, not with "not yet ported"."""
    paths, _, torch_dir = predict_setup
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                  "--aud_path", paths["aud_path"], "--alphabet",
                  paths["alphabet_path"], "--model_path", torch_dir,
                  "--device", "cpu", *extra])
    assert message in str(e.value) and "not yet ported" not in str(e.value)
