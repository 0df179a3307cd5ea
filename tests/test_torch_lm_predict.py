"""``--mode predict`` with LM fusion through both CLIs, in process, on the
committed flax fixture (pg_asr_tpu_torch/testdata/flax_bilstm_tiny: a
JAX-trained BiLSTM-CTC), copied into a model directory per test, and a
synthetic corpus of the fixture's words; the port on CPU tensors.

Parity bar: the same predicted.txt, byte for byte, for the n-gram fused
beam (orders 2 and 3) and for the neural LM's rescoring and fused passes.
The neural LM is the JAX package's: its CLI trains it in a few --lm_steps
and leaves lm_neural.ckpt + lm_neural.ckpt.json, which the port serves
without training one. The port's own LM cache (lm_neural.pt) is checked
for its key: a rerun reuses it, other --lm_steps retrain.
"""

import os
import shutil

import pytest
import torch

from pg_asr_tpu import cli as jax_cli
from pg_asr_tpu.data.dataset import make_synthetic_corpus
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.decoding import neural_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "pg_asr_tpu_torch", "testdata",
                       "flax_bilstm_tiny")
WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm_predict") / "corpus")
    make_synthetic_corpus(d, n_utts=24, seed=5, min_dur=0.3, max_dur=1.0,
                          words=WORDS)
    return d


def _model_dir(tmp_path, name="model") -> str:
    d = str(tmp_path / name)
    shutil.copytree(FIXTURE, d)
    return d


def _predict(main, corpus, model_dir, capsys, *extra, port=True):
    argv = ["--mode", "predict", "--corpus_path", corpus, "--model_path",
            model_dir, "--decoder", "beam", "--batch_size", "4", *extra]
    assert main(argv + (["--device", "cpu"] if port else [])) == 0
    with open(os.path.join(model_dir, "predicted.txt")) as fo:
        return fo.read(), capsys.readouterr().out


@pytest.mark.parametrize("order", ["2", "3"])
def test_ngram_fusion_predicted_txt_matches_jax(tmp_path, corpus, capsys,
                                                order):
    extra = ("--lm_order", order, "--lm_weight", "0.6", "--length_bonus",
             "0.2")
    want, _ = _predict(jax_cli.main, corpus, _model_dir(tmp_path, "jax"),
                       capsys, *extra, port=False)
    got, out = _predict(cli.main, corpus, _model_dir(tmp_path), capsys,
                        *extra)
    assert got == want and "CER:" in out
    assert any(line.split("|")[1] for line in got.splitlines())


def test_port_serves_the_jax_neural_lm(tmp_path, corpus, capsys):
    """The JAX CLI trains the neural LM (3 steps) and rescores; the port,
    in the same model directory, reuses its lm_neural.ckpt (writes no
    lm_neural.pt) and writes the same predicted.txt, rescored and fused."""
    d = _model_dir(tmp_path)
    extra = ("--lm_order", "2", "--lm_type", "neural", "--lm_steps", "3")
    for lm_pass in ("rescore", "fused"):
        want, jout = _predict(jax_cli.main, corpus, d, capsys, *extra,
                              "--lm_pass", lm_pass, port=False)
        assert os.path.exists(os.path.join(d, neural_lm.JAX_LM_FILE))
        got, out = _predict(cli.main, corpus, d, capsys, *extra,
                            "--lm_pass", lm_pass)
        assert got == want, lm_pass
        assert "neural LM reused from" in out and "lm_neural.ckpt" in out
        assert not os.path.exists(os.path.join(d, neural_lm.LM_FILE))


def test_port_trains_and_keys_its_neural_lm(tmp_path, corpus, capsys):
    """The port trains its LM on the device asked for, caches it with the
    JAX package's key, reuses it on a rerun and retrains for other
    --lm_steps; the cache is preferred to a JAX package file of the same
    key."""
    d = _model_dir(tmp_path)
    extra = ("--lm_order", "3", "--lm_type", "neural", "--lm_pass",
             "rescore")
    first, out = _predict(cli.main, corpus, d, capsys, *extra,
                          "--lm_steps", "2")
    assert "neural LM trained (2 steps)" in out
    path = os.path.join(d, neural_lm.LM_FILE)
    assert os.path.exists(path) and os.path.exists(path + ".json")
    again, out = _predict(cli.main, corpus, d, capsys, *extra,
                          "--lm_steps", "2")
    assert again == first and "reused from" in out and path in out
    _, out = _predict(cli.main, corpus, d, capsys, *extra, "--lm_steps", "1")
    assert "neural LM trained (1 steps)" in out
