"""The elastic supervisor of the port (pg_asr_tpu_torch/utils/elastic.py,
``--max_restarts`` and ``--fault_step``) vs the JAX package's
(pg_asr_tpu/utils/elastic.py).

``run_elastic`` of both packages on the same stub commands gives the same
return code and the same restarts: a child that always fails exhausts the
budget, a clean exit never restarts, and a SIGTERM to the supervisor is
forwarded to the child and ends the supervision without a restart. Then
the CLI: a train run under ``--max_restarts 1 --fault_step 4`` dies with
exit code 17 at global step 4, is relaunched once, resumes from the
mid-epoch model_last and ends with the uninterrupted run's parameters,
bit for bit; under ``--mesh data=2`` the launcher supervises its two rank
processes as one group: one relaunch starts both again at a new
rendezvous, and the two-rank run ends with the uninterrupted two-rank
run's parameters, bit for bit. Each
multi-process test has a hard timeout of its own.
"""

import os
import shutil
import signal
import sys
import time

import pytest
import torch

from pg_asr_tpu.utils import elastic as jax_elastic
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.utils import elastic
from tests.test_torch_mesh import TIMEOUT, _start, _tiny_model, _wait

PACKAGES = {"jax": jax_elastic, "torch": elastic}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# child code -> (return code, restarts as (attempt, child's exit code))
STUBS = {"budget": ("import sys; sys.exit(9)", (9, [(1, 9), (2, 9)])),
         "clean": ("print('fine')", (0, []))}


@pytest.mark.parametrize("package", list(PACKAGES))
@pytest.mark.parametrize("case", list(STUBS))
def test_run_elastic_matches_jax(package, case):
    code, want = STUBS[case]
    seen = []
    rc = PACKAGES[package].run_elastic(
        [sys.executable, "-c", code], max_restarts=2, backoff_s=0.0,
        on_restart=lambda n, rc: seen.append((n, rc)))
    assert (rc, seen) == want


# a supervisor of a child that waits for SIGTERM (and then exits 5)
_SUPERVISOR = r"""
import sys
from {pkg}.utils.elastic import run_elastic

child = ("import signal, sys, time\n"
         "signal.signal(signal.SIGTERM, lambda *a: sys.exit(5))\n"
         "print('CHILD_UP', flush=True)\n"
         "time.sleep(60)\n")
seen = []
rc = run_elastic([sys.executable, "-c", child], max_restarts=3,
                 backoff_s=0.0, on_restart=lambda n, rc: seen.append(n))
print(f"SUPERVISED rc={{rc}} restarts={{seen}}", flush=True)
"""


@pytest.mark.parametrize("package", ["pg_asr_tpu", "pg_asr_tpu_torch"])
def test_sigterm_is_forwarded_without_a_restart(package):
    p = _start([sys.executable, "-c", _SUPERVISOR.format(pkg=package)])
    end = time.monotonic() + TIMEOUT
    first = p.stdout.readline()
    while "CHILD_UP" not in first and time.monotonic() < end:
        first = p.stdout.readline()
    assert "CHILD_UP" in first
    p.send_signal(signal.SIGTERM)
    (out,) = _wait([p])
    assert p.returncode == 0, out
    assert "SUPERVISED rc=5 restarts=[]" in out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """16 utterances of 0.25 s (12 train: 3 steps an epoch at batch 4) and
    the tiny model, one epoch done: the CLI runs resume it for a second."""
    d = tmp_path_factory.mktemp("elastic")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=16, seed=0,
                                      min_dur=0.25, max_dur=0.25)
    model = str(d / "tiny")
    _tiny_model(corpus, model)
    return corpus, model


def _params(model):
    return load_checkpoint(os.path.join(model, "model_last.pt"))["params"]


def _args(corpus, model, *extra):
    return ["--mode", "train", "--corpus_path", corpus, "--model_path", model,
            "--num_epochs", "2", "--batch_size", "4", "--save_every_steps",
            "1", "--device", "cpu", *extra]


def _supervised(corpus, model, *extra):
    """The CLI with --max_restarts 1 --fault_step 4 (the tiny model's epoch
    took steps 1-2 at batch 8; epoch 2 takes 3-5 at batch 4, and step 4 is
    its batch 2): (its output, the supervisors' relaunch lines)."""
    p = _start([sys.executable, "-m", "pg_asr_tpu_torch",
                *_args(corpus, model, "--max_restarts", "1",
                       "--fault_step", "4", *extra)])
    (out,) = _wait([p])
    assert p.returncode == 0, out
    with open(os.path.join(model, ".fault_injected")) as fo:
        assert fo.read() == "4"
    return out, [line for line in out.splitlines()
                 if line.startswith("[elastic] child exited")]


def test_cli_crash_relaunch_matches_uninterrupted(tiny, tmp_path):
    corpus, model = tiny
    plain, faulted = str(tmp_path / "plain"), str(tmp_path / "faulted")
    shutil.copytree(model, plain)
    shutil.copytree(model, faulted)
    assert cli.main(_args(corpus, plain)) == 0
    out, relaunches = _supervised(corpus, faulted)
    # the child died at step 4 (epoch 2, batch 2: model_last saved there
    # first) with the fault's code, once; the relaunch resumed there
    assert relaunches == ["[elastic] child exited rc=17; restart 1/1 in "
                          "1.0s (the relaunch resumes from model_last)"]
    assert "resumed from epoch 2 batch 2" in out
    want, got = _params(plain), _params(faulted)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_max_restarts_composes_with_the_mesh(tiny, tmp_path):
    corpus, model = tiny
    plain, faulted = str(tmp_path / "plain"), str(tmp_path / "faulted")
    shutil.copytree(model, plain)
    shutil.copytree(model, faulted)
    p = _start([sys.executable, "-m", "pg_asr_tpu_torch",
                *_args(corpus, plain, "--mesh", "data=2")])
    (out,) = _wait([p])
    assert p.returncode == 0, out
    out, relaunches = _supervised(corpus, faulted, "--mesh", "data=2")
    # one rank died with the fault's code (its peer failed or was stopped
    # after the grace period); the launcher relaunched the group once, and
    # both ranks formed a new group and resumed
    # (the group's code is the first failure seen: the fault's 17, or the
    # peer's when both ended within one poll)
    assert len(relaunches) == 1 and "restart 1/1" in relaunches[0], out
    assert out.count("resumed from epoch 2 batch 2") == 2
    assert out.count("torch.distributed initialized (process") == 4
    want, got = _params(plain), _params(faulted)
    assert all(torch.equal(got[k], want[k]) for k in want)
