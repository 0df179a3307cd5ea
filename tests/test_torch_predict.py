"""The predict slice as a whole: the port's predict (on CPU) vs the JAX
package's predict, on one synthetic corpus with the same weights; plus the
port's import hygiene and CLI.

Parity bar: the same predicted.txt, byte for byte, and the same CER/WER.
With random weights an argmax near-tie could flip one symbol, so the seeds
are chosen such that every valid frame's top two log-probs lie more than
1e-4 apart (asserted below), well above the ~1e-5 log-prob difference the
model parity test allows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pg_asr_tpu.checkpoint import save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig
from pg_asr_tpu.data.dataset import (BatchIterator, load_manifest,
                                     make_synthetic_corpus)
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint, save_model
from pg_asr_tpu_torch.checkpoint import save_checkpoint as save_checkpoint_pt
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.predict import forward, load_model
from pg_asr_tpu_torch.predict import predict as torch_predict


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards: importing this module changes no
    process-wide state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_SEED, MODEL_SEED, BATCH = 3, 4, 2


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    corpus, alphabet = make_synthetic_corpus(
        str(d / "corpus"), n_utts=32, seed=CORPUS_SEED, min_dur=0.3,
        max_dur=1.0)
    jcfg = JConfig(model=ModelConfig(vocab_size=alphabet.size,
                                     input_proj_dim=32, hidden_size=16,
                                     num_layers=2))
    cfg = Config.from_json(jcfg.to_json())  # the port's, from the same JSON
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(MODEL_SEED),
                                          jcfg.model))
    jax_dir, torch_dir = str(d / "jax_model"), str(d / "torch_model")
    os.makedirs(jax_dir)
    with open(os.path.join(jax_dir, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                    {"params": tree})
    save_model(torch_dir, params_from_jax(tree), cfg)
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    return paths, alphabet, cfg, jax_dir, torch_dir


def test_predict_matches_jax_package(slice_setup):
    paths, alphabet, cfg, jax_dir, torch_dir = slice_setup
    # the margin that makes exact text equality a fair bar
    params, cfg_t = load_model(torch_dir, alphabet, device="cpu")
    utts = load_manifest(paths["test_path"], paths["aud_path"])
    margin = np.inf
    for b in BatchIterator(utts, alphabet, BATCH, shuffle=False):
        lp, mask, _ = forward(params, torch.from_numpy(b.wave),
                              torch.from_numpy(b.num_samples), cfg_t)
        top2 = lp.topk(2, dim=-1).values
        margin = min(margin, (top2[..., 0] - top2[..., 1])[mask > 0].min()
                     .item())
    assert margin > 1e-4

    ref = jax_predict(**paths, model_path=jax_dir, batch_size=BATCH)
    got = torch_predict(**paths, model_path=torch_dir, batch_size=BATCH,
                        device="cpu")
    with open(os.path.join(jax_dir, "predicted.txt")) as fo:
        ref_txt = fo.read()
    with open(os.path.join(torch_dir, "predicted.txt")) as fo:
        got_txt = fo.read()
    assert got_txt == ref_txt
    assert len(got_txt.splitlines()) == len(utts) == got["num_utts"]
    # random weights still emit text, so the comparison is not vacuous
    assert any(line.split("|")[1] for line in got_txt.splitlines())
    assert got == ref


def test_checkpoint_round_trip(slice_setup, tmp_path):
    _, _, cfg, _, torch_dir = slice_setup
    state = load_checkpoint(os.path.join(torch_dir, "model_best.pt"))["params"]
    save_model(str(tmp_path), state, cfg, which=("last",))
    again = load_checkpoint(os.path.join(tmp_path, "model_last.pt"))["params"]
    assert set(again) == set(state)
    for k in state:
        torch.testing.assert_close(again[k], state[k], rtol=0, atol=0)
    with open(os.path.join(tmp_path, "config.json")) as fo:
        assert Config.from_json(fo.read()) == cfg


def test_cli_predict_cpu(slice_setup, capsys):
    paths, _, _, _, torch_dir = slice_setup
    rc = cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                   "--aud_path", paths["aud_path"], "--alphabet",
                   paths["alphabet_path"], "--model_path", torch_dir,
                   "--batch_size", "3", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "CER:" in out and "WER:" in out


@pytest.mark.parametrize("extra,message", [
    (["--decoder", "beam", "--lm_order", "2"], "beam"),
    (["--timestamps"], "timestamps"),
])
def test_cli_unported_options_exit_with_message(slice_setup, extra, message):
    paths, _, _, _, torch_dir = slice_setup
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                  "--aud_path", paths["aud_path"], "--alphabet",
                  paths["alphabet_path"], "--model_path", torch_dir,
                  "--device", "cpu", *extra])
    assert "not yet ported" in str(e.value) and message in str(e.value)


def test_cli_unported_family_exits_with_message(slice_setup, tmp_path):
    """The model family comes from the checkpoint's config.json (seq2seq
    is not ported; the transducer is served since it got its decoders)."""
    paths, _, cfg, _, torch_dir = slice_setup
    seq2seq = cfg.replace(model=cfg.model.__class__(
        **{**cfg.model.__dict__, "family": "seq2seq"}))
    save_model(str(tmp_path), load_checkpoint(
        os.path.join(torch_dir, "model_best.pt"))["params"], seq2seq)
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                  "--aud_path", paths["aud_path"], "--alphabet",
                  paths["alphabet_path"], "--model_path", str(tmp_path),
                  "--device", "cpu"])
    assert "not yet ported" in str(e.value) and "seq2seq" in str(e.value)


def test_cli_other_modes_not_ported():
    with pytest.raises(SystemExit, match="not yet ported"):
        cli.main(["--mode", "stream", "--device", "cpu"])


def _run(code_or_args, **kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES",)}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120, **kw)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import pg_asr_tpu_torch.predict, pg_asr_tpu_torch.cli\n"
            "import pg_asr_tpu_torch.ops.cuda_lstm, pg_asr_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_cuda_without_gpu_exits_nonzero(slice_setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    paths, _, _, _, torch_dir = slice_setup
    proc = _run(["-m", "pg_asr_tpu_torch", "--mode", "predict",
                 "--test_path", paths["test_path"], "--aud_path",
                 paths["aud_path"], "--alphabet", paths["alphabet_path"],
                 "--model_path", torch_dir, "--device", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr


@pytest.mark.parametrize("ema_decay,with_ema,served", [
    (0.0, True, "params"), (0.999, True, "ema_params"),
    (0.999, False, "params")])
def test_load_model_serves_ema_params_as_the_jax_package(
        slice_setup, tmp_path, capsys, ema_decay, with_ema, served):
    """pg_asr_tpu/predict.py: with train.ema_decay > 0 the checkpoint's
    ema_params are served, else (or when it has none) its params."""
    _, alphabet, cfg, _, torch_dir = slice_setup
    params = load_checkpoint(os.path.join(torch_dir, "model_best.pt"))[
        "params"]
    state = {"params": params}
    if with_ema:
        state["ema_params"] = {k: v + 1.0 for k, v in params.items()}
    save_checkpoint_pt(os.path.join(tmp_path, "model_best.pt"), state)
    ecfg = cfg.replace(train=cfg.train.__class__(
        **{**cfg.train.__dict__, "ema_decay": ema_decay}))
    got, _ = load_model(str(tmp_path), alphabet, config=ecfg, device="cpu")
    want = state[served]
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k].to(got[k].dtype), rtol=0,
                                   atol=0)
    said = "predates EMA" in capsys.readouterr().out
    assert said == (ema_decay > 0 and not with_ema)
