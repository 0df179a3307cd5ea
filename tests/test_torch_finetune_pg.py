"""The port's `--mode finetune_pg` end to end on the CPU
(pg_asr_tpu_torch/rl/reinforce.finetune_pg through cli.main), on a tiny
model the port trained, and its dev CER (train.corpus_cer) against the JAX
package's sharded_corpus_cer on the same weights.

Tolerances: the corpus CER is a ratio of integer counts from the same
greedy labels, so it must be equal; the recorded dev CERs equal
corpus_cer's recomputation from the saved checkpoint.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.data.dataset import load_manifest as jax_load_manifest
from pg_asr_tpu.data.text import Alphabet as JAlphabet
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import (Config, ModelConfig, TrainConfig,
                                     TransducerConfig)
from pg_asr_tpu_torch.convert import params_to_jax
from pg_asr_tpu_torch.data import (Alphabet, load_manifest,
                                   make_synthetic_corpus)
from pg_asr_tpu_torch.predict import load_model
from pg_asr_tpu_torch.rl import reinforce
from pg_asr_tpu_torch.train import corpus_cer, train


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**model_kw) -> Config:
    return Config(model=ModelConfig(input_proj_dim=32, hidden_size=16,
                                    num_layers=2, **model_kw),
                  train=TrainConfig(num_epochs=1, batch_size=4))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 16-utterance corpus (12 train, 2 dev, 2 test) and a BiLSTM-CTC the
    port trained on it for one epoch (supervised model_best / model_last,
    epoch 1)."""
    d = tmp_path_factory.mktemp("pg")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=16, seed=1,
                                      min_dur=0.2, max_dur=0.35)
    train(corpus, str(d / "model"), config=_tiny(), device="cpu")
    return corpus, str(d / "model")


def _copy(trained, tmp_path) -> str:
    dst = str(tmp_path / "model")
    shutil.copytree(trained[1], dst)
    return dst


def _pg(corpus, model, *extra):
    return cli.main(["--mode", "finetune_pg", "--corpus_path", corpus,
                     "--model_path", model, "--device", "cpu",
                     "--batch_size", "4", *extra])


def test_reinforce_artifacts_best_on_dev_cer_and_resume(trained, tmp_path,
                                                        capsys):
    corpus, _ = trained
    model = _copy(trained, tmp_path)
    assert _pg(corpus, model, "--pg_steps", "10", "--pg_eval_every",
               "4") == 0
    out = capsys.readouterr().out
    rewards = np.load(os.path.join(model, "pg_rewards.npy"))
    assert rewards.shape == (10,) and np.isfinite(rewards).all()
    dev_cer = np.load(os.path.join(model, "pg_dev_cer.npy"))
    assert dev_cer[:, 0].tolist() == [4, 8, 10]
    assert "[pg] step 4: new best dev CER" in out  # best starts at +inf
    assert "[pg] 10 steps, final reward" in out
    with open(os.path.join(model, "metrics.jsonl")) as fo:
        pg_lines = [json.loads(ln) for ln in fo if "pg_loss" in ln]
    assert [r["step"] for r in pg_lines] == [10]
    assert all(np.isfinite(r[k]) for r in pg_lines
               for k in ("pg_loss", "reward", "entropy"))

    last = load_checkpoint(os.path.join(model, "model_last.pt"))
    best = load_checkpoint(os.path.join(model, "model_best.pt"))
    assert (last["epoch"], last["step"], best["epoch"]) == (-1, 10, -1)
    best_cer = dev_cer[:, 1].min()
    assert best["best_val_loss"] == last["best_val_loss"] == best_cer
    assert best["step"] == int(dev_cer[np.argmax(dev_cer[:, 1] == best_cer),
                                       0])
    # the saved best reproduces its dev CER
    cfg = Config.from_json(open(os.path.join(model, "config.json")).read())
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    params, cfg = load_model(model, alphabet, cfg, device="cpu")
    rows = load_manifest(os.path.join(corpus, "dev.tsv"),
                         os.path.join(corpus, "clips"))
    assert corpus_cer(params, rows, alphabet, cfg, 4) == best_cer

    # a PG model_last resumes: 2 more steps to 12
    assert _pg(corpus, model, "--pg_steps", "12", "--pg_eval_every",
               "4") == 0
    out = capsys.readouterr().out
    assert "[pg] resumed from model_last at step 10" in out
    assert np.load(os.path.join(model, "pg_rewards.npy")).shape == (2,)
    assert load_checkpoint(os.path.join(model, "model_last.pt"))["step"] == 12


def test_supervised_model_last_is_left_alone(trained, tmp_path, capsys):
    """A supervised model_last (epoch 1) does not resume: the run starts
    from model_best; without a dev set it selects on the mean reward."""
    corpus, _ = trained
    model = _copy(trained, tmp_path)
    assert load_checkpoint(os.path.join(model, "model_last.pt"))["epoch"] == 1
    assert _pg(corpus, model, "--pg_steps", "3", "--pg_eval_every", "0",
               "--pg_objective", "mwer", "--mwer_beam", "2") == 0
    out = capsys.readouterr().out
    assert "resumed" not in out
    rewards = np.load(os.path.join(model, "pg_rewards.npy"))
    assert rewards.shape == (3,) and np.isfinite(rewards).all()
    assert not os.path.exists(os.path.join(model, "pg_dev_cer.npy"))
    best = load_checkpoint(os.path.join(model, "model_best.pt"))
    assert best["epoch"] == -1 and best["step"] == 3
    assert best["best_val_loss"] == pytest.approx(-rewards[-10:].mean(),
                                                  rel=1e-6)


class _PreemptAfter:
    """Reports a preemption from the 3rd per-step poll on."""

    def __init__(self):
        self.calls = 0

    def is_set(self):
        self.calls += 1
        return self.calls >= 3


def test_sigterm_saves_model_last_and_the_rerun_resumes(trained, tmp_path,
                                                        monkeypatch, capsys):
    corpus, _ = trained
    model = _copy(trained, tmp_path)
    cfg = cli.pg_config(cli.build_parser().parse_args(
        ["--mode", "finetune_pg", "--model_path", model]))
    monkeypatch.setattr(reinforce, "install_preemption_handler",
                        lambda: (_PreemptAfter(), lambda: None))
    out = reinforce.finetune_pg(corpus, model, num_steps=6, batch_size=4,
                                config=cfg, eval_every=0, device="cpu")
    assert out["interrupted"] is True and len(out["rewards"]) == 3
    assert "SIGTERM: saved model_last at step 3" in capsys.readouterr().out
    last = load_checkpoint(os.path.join(model, "model_last.pt"))
    assert (last["epoch"], last["step"]) == (-1, 3)
    monkeypatch.undo()
    out = reinforce.finetune_pg(corpus, model, num_steps=6, batch_size=4,
                                config=cfg, eval_every=0, device="cpu")
    assert "resumed from model_last at step 3" in capsys.readouterr().out
    assert "interrupted" not in out and len(out["rewards"]) == 3


def test_preemption_handler_sets_the_event_then_terminates(tmp_path):
    """In a child process (a SIGTERM must not reach the test worker): the
    first SIGTERM sets the event, a second one terminates; restore()
    reinstates the previous disposition."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import os, signal, sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pg_asr_tpu_torch.utils.preempt import "
        "install_preemption_handler\n"
        "prev = signal.getsignal(signal.SIGTERM)\n"
        "event, restore = install_preemption_handler()\n"
        "restore()\n"
        "assert signal.getsignal(signal.SIGTERM) is prev\n"
        "event, restore = install_preemption_handler()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "assert event.wait(5.0)\n"
        "print('FIRST_OK', flush=True)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(30)\n"
        "print('NOT_KILLED', flush=True)\n")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=60)
    assert "FIRST_OK" in r.stdout and "NOT_KILLED" not in r.stdout
    assert r.returncode == -signal.SIGTERM


@pytest.mark.parametrize("extra,message", [
    (["--max_restarts", "1"], "--max_restarts"),
    (["--mesh", "data:2"], "--mesh"),
])
def test_unported_options_are_refused(trained, extra, message):
    corpus, model = trained
    with pytest.raises(SystemExit) as e:
        _pg(corpus, model, "--pg_steps", "1", *extra)
    assert "not yet ported" in str(e.value) and message in str(e.value)


def test_seq2seq_is_refused(trained, tmp_path):
    corpus, _ = trained
    model = _copy(trained, tmp_path)
    cfg = _tiny(family="seq2seq")
    with open(os.path.join(model, "config.json"), "w") as fo:
        fo.write(cfg.to_json())
    with pytest.raises(SystemExit) as e:
        _pg(corpus, model, "--pg_steps", "1")
    assert "not yet ported" in str(e.value) and "seq2seq" in str(e.value)


def test_mwer_beam_below_two_is_refused(trained):
    corpus, model = trained
    with pytest.raises(SystemExit, match="--mwer_beam must be >= 2"):
        _pg(corpus, model, "--pg_objective", "mwer", "--mwer_beam", "1")


def test_neg_wer_needs_a_space_in_the_alphabet(trained, tmp_path):
    corpus, model = trained
    no_space = str(tmp_path / "corpus")
    shutil.copytree(corpus, no_space)
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    Alphabet.from_symbols([s for s in alphabet.symbols[1:] if s != " "]).save(
        os.path.join(no_space, "alphabet.txt"))
    with pytest.raises(SystemExit, match="needs an alphabet with a space"):
        _pg(no_space, model, "--pg_reward", "neg_wer", "--pg_steps", "1")


def test_transducer_switches_to_mwer(trained, tmp_path, capsys):
    corpus, _ = trained
    model = str(tmp_path / "transducer")
    train(corpus, model, device="cpu", config=Config(
        model=ModelConfig(family="transducer", input_proj_dim=16,
                          hidden_size=8, num_layers=1),
        transducer=TransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                    pred_hidden=8, joint_dim=16),
        train=TrainConfig(num_epochs=1, batch_size=4)))
    assert _pg(corpus, model, "--pg_steps", "2", "--pg_eval_every", "2",
               "--mwer_beam", "2") == 0
    out = capsys.readouterr().out
    assert "[pg] transducer family: using the MWER objective" in out
    assert np.isfinite(np.load(os.path.join(model, "pg_rewards.npy"))).all()
    assert np.load(os.path.join(model, "pg_dev_cer.npy")).shape == (1, 2)


def test_corpus_cer_matches_jax_sharded_corpus_cer(trained):
    """The port's one-host corpus CER against the JAX package's on the
    port-trained weights (params_to_jax) and the dev split."""
    corpus, model = trained
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    params, cfg = load_model(model, alphabet, device="cpu")
    clips = os.path.join(corpus, "clips")
    got = corpus_cer(params, load_manifest(os.path.join(corpus, "dev.tsv"),
                                           clips), alphabet, cfg, 4)
    jcfg = JConfig.from_json(cfg.to_json())
    want = jax_train.sharded_corpus_cer(
        params_to_jax(params),
        jax_load_manifest(os.path.join(corpus, "dev.tsv"), clips),
        JAlphabet.load(os.path.join(corpus, "alphabet.txt")), jcfg, 4)
    assert 0.0 < got == want
