"""The data mesh axis of the port (pg_asr_tpu_torch/parallel/driver.py,
parallel/mesh.py and the data-parallel steps of train.py and
rl/reinforce.py) vs the JAX package's (pg_asr_tpu/parallel/driver.py,
parallel/mesh.py, make_train_step / make_eval_step / make_pg_step on a
``data=2`` mesh of the forced host devices), on the same seeded numpy
batches and the same weights carried across by ``convert.params_from_jax``.

The port runs two CPU processes joined over gloo (one rank each, the
global batch split as the JAX mesh splits it: ``mesh.local_rows``), the
JAX package one process over two devices. Both sum the loss's
denominators and the gradients over the shards, so they compute the same
global step: the losses and every parameter after 2 steps within rtol
1e-4, atol 1e-5 (the JAX package's own data-parallel tests' tolerances:
summation order only), with dropout 0, on a ragged batch of 5 rows (the
second shard padded with a zero row). Cases: the BiLSTM-CTC train and
eval steps, the MWER policy-gradient step of the BiLSTM-CTC and of the
seq2seq (sampling-free, so one key serves both), the hybrid transducer's
train and eval steps (its loss two stacked num/den components), and the
switch-MoE train and eval steps, whose expert slots follow the global
token order.

Then the CLI: ``--mesh data=2 --device cpu`` on tests/test_multihost.py's
equal-length corpus equals the one-process run's train_loss.npy at rtol
1e-4 (both resume a tiny model, dropout 0, trained here), only rank 0
writes, and predict reads the result; a misconfigured cluster raises; and a
SIGTERM to one of two rank processes started by the user
(``PGASR_DISTRIBUTED=1``) stops both at the same step with one
model_last. Every multi-process test has a hard timeout of its own.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransducerConfig as JTransducerConfig
from pg_asr_tpu.config import TransformerConfig as JTransformerConfig
from pg_asr_tpu.parallel import driver as jax_driver
from pg_asr_tpu.parallel import mesh as jax_mesh
from pg_asr_tpu.rl import reinforce as jrl
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.config import (Config, FeatureConfig, ModelConfig,
                                     TrainConfig)
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.parallel import driver, mesh
from pg_asr_tpu_torch.train import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, each multi-process test
WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("PGASR_DISTRIBUTED", "PGASR_COORDINATOR",
              "PGASR_NUM_PROCESSES", "PGASR_PROCESS_ID"):
        env.pop(k, None)
    env.update(extra)
    return env


def _wait(procs, timeout=TIMEOUT) -> list[str]:
    """Each process's output; every process (and what it started: each
    runs in a session of its own) killed when the time is up."""
    end = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(end - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
        raise
    return outs


def _start(cmd, **env) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


# ------------------------------------------------------ specs and padding

SPECS = ["data=2", "data=2,pipe=2", " data = 4 ,", "model=2,data=1",
         "foo=2", "data=2,data=2", "data=x", "data=0", "", ",", "data"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_driver.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            driver.parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert driver.parse_mesh_spec(spec) == want
    assert driver.MESH_AXES == jax_driver.MESH_AXES


@pytest.mark.parametrize("batch,multiple", [(5, 2), (6, 3), (3, 8), (1, 1)])
def test_pad_batch_to_multiple_matches_jax(batch, multiple):
    rng = np.random.default_rng(batch)
    arrays = (rng.standard_normal((batch, 7)).astype(np.float32),
              rng.integers(0, 9, (batch,)).astype(np.int32),
              (rng.standard_normal((batch, 3, 2)) * 99).astype(np.int16))
    want = jax_mesh.pad_batch_to_multiple(arrays, multiple)
    got = mesh.pad_batch_to_multiple(arrays, multiple)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_local_rows_are_the_mesh_shards():
    """Each rank's rows are the rows the JAX package's data=2 mesh places
    on that device (shard_batch_arrays), the zero row included."""
    m2 = jax_mesh.make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    arrays = _batch(B=5)
    placed = jax_mesh.shard_batch_arrays(arrays, m2)
    for rank in range(WORLD):
        mine = mesh.local_rows(arrays, rank, WORLD)
        for a, g in zip(placed, mine):
            shard = next(s for s in a.addressable_shards
                         if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(np.asarray(shard.data), g)


def test_other_axes_are_refused_with_their_item():
    # the expert and fsdp axes run since they were ported
    # (tests/test_torch_expert.py, tests/test_torch_fsdp.py), the model
    # axis alone, with data and with expert too (tests/test_torch_tensor.py),
    # the seq and pipe axes with --microbatches and data x pipe x model
    # too (tests/test_torch_sequence.py, tests/test_torch_pipeline.py): a
    # family they do not take is refused with the JAX package's message
    cfg = Config()
    assert driver.ParallelPlan(cfg, (), ()).world == 1
    assert driver.ParallelPlan(cfg, (4, 1), ("data", "model")).world == 4
    moe = cfg.replace(model=dataclasses.replace(cfg.model,
                                                family="transformer"),
                      transformer=dataclasses.replace(cfg.transformer,
                                                      num_experts=4))
    for spec, c, world in (("model=2", cfg, 2), ("data=2,model=2", cfg, 4),
                           ("model=2,expert=2", moe, 4)):
        plan = driver.ParallelPlan(c, *driver.parse_mesh_spec(spec))
        assert plan.world == world and plan.tp
    dense = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  family="transformer"))
    for spec, axis, world in (("seq=2", "seq", 2), ("pipe=2", "pipe", 2),
                              ("data=2,pipe=2,model=2", "pipe", 8)):
        plan = driver.ParallelPlan(dense, *driver.parse_mesh_spec(spec))
        assert plan.world == world and plan.strategy == axis
        with pytest.raises(ValueError, match=f"'{axis}' axis requires the "
                           "dense transformer family"):
            driver.ParallelPlan(cfg, *driver.parse_mesh_spec(spec))
    # microbatches without a pipe axis change nothing, as in the JAX package
    plan = driver.ParallelPlan(cfg, (2,), ("data",), microbatches=2)
    assert plan.world == 2 and plan.batch_multiple == 2


# ------------------------------------------- the 2-rank steps vs the JAX mesh

# one rank: joins the group, takes its rows of each case's global batch and
# runs the port's data-parallel steps; writes losses and parameters
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.parallel import mesh
from pg_asr_tpu_torch.rl.reinforce import make_pg_step
from pg_asr_tpu_torch.train import AdamW, make_eval_step, make_train_step

d, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
mesh.init_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=60)
dp = mesh.GroupRank("cpu")
out = {}
for name, kind in json.load(open(os.path.join(d, "cases.json"))).items():
    with open(os.path.join(d, name + ".json")) as fo:
        cfg = Config.from_json(fo.read())
    params = torch.load(os.path.join(d, name + ".pt"))
    npz = np.load(os.path.join(d, name + ".npz"))
    arrays = [torch.from_numpy(a) for a in mesh.local_rows(
        tuple(npz[k] for k in ("wave", "ns", "labels", "label_lens")),
        rank, world)]
    gen = torch.Generator().manual_seed(0)
    res = {"losses": []}
    if kind == "train":
        res["eval"] = make_eval_step(cfg, dp)(params, *arrays).item()
        step = make_train_step(cfg, AdamW(cfg, params), dp)
    else:
        step = make_pg_step(cfg, AdamW(
            cfg, params, learning_rate=cfg.train.learning_rate * 0.1,
            weight_decay=1e-4), dp=dp)
    for _ in range(2):
        loss = step(params, gen, *arrays)
        res["losses"].append((loss[0] if kind == "pg" else loss).item())
    res["params"] = params
    out[name] = res
torch.save(out, os.path.join(d, f"rank{rank}.pt"))
mesh.destroy_distributed()
print("RANK_OK", flush=True)
"""


def _batch(B=5, V=8, seed=0):
    """B ragged rows of int16 audio (0.3 s down to 0.125 s) with labels;
    the 4th row has no labels."""
    rng = np.random.default_rng(seed)
    ns = np.array([4800, 3200, 2000, 4000, 2800][:B], np.int32)
    wave = np.where(np.arange(4800)[None] < ns[:, None],
                    rng.standard_normal((B, 4800)) * 3000, 0).astype(np.int16)
    labels = rng.integers(2, V, (B, 6)).astype(np.int32)
    label_lens = np.array([6, 4, 3, 0, 5][:B], np.int32)
    labels[0, 2] = 1
    for b in range(B):
        labels[b, label_lens[b]:] = 0
    return wave, ns, labels, label_lens


def _cases() -> dict:
    """name -> (JAX config, step kind)."""
    train = JTrainConfig(batch_size=5, warmup_steps=0, learning_rate=1e-2)
    ctc = JModelConfig(vocab_size=8, input_proj_dim=32, hidden_size=16,
                       num_layers=1, dropout=0.0, use_pallas_lstm=False)
    return {
        "train_ctc": (JConfig(model=ctc, train=train), "train"),
        "pg_mwer_ctc": (JConfig(model=ctc, train=train, rl=JRLConfig(
            objective="mwer", mwer_beam=3, space_id=1)), "pg"),
        "pg_mwer_seq2seq": (JConfig(
            model=JModelConfig(family="seq2seq", vocab_size=8,
                               input_proj_dim=16, hidden_size=8,
                               num_layers=1, dropout=0.0,
                               use_pallas_lstm=False),
            seq2seq=JSeq2SeqConfig(vocab_size=8, embed_dim=8, dec_hidden=16),
            train=train, rl=JRLConfig(objective="mwer", mwer_beam=3,
                                      space_id=1)), "pg"),
        "train_transducer": (JConfig(
            model=JModelConfig(family="transducer", vocab_size=8,
                               input_proj_dim=16, hidden_size=8,
                               num_layers=1, dropout=0.0,
                               use_pallas_lstm=False),
            transducer=JTransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                         pred_hidden=8, joint_dim=16,
                                         ctc_weight=0.3),
            train=train), "train"),
        "train_moe": (JConfig(
            model=JModelConfig(family="transformer", vocab_size=8,
                               input_dim=80),
            transformer=JTransformerConfig(num_layers=2, d_model=32,
                                           num_heads=2, ffn_dim=64,
                                           dropout=0.0, num_experts=4,
                                           capacity_factor=1.0),
            train=train), "train"),
    }


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Every case through two gloo ranks at once: {case: [rank0, rank1]}."""
    d = str(tmp_path_factory.mktemp("ranks"))
    cases, trees = _cases(), {}
    for name, (jcfg, _) in cases.items():
        trees[name] = jax.tree_util.tree_map(
            np.asarray, jax_train.init_model_params(jax.random.PRNGKey(0),
                                                    jcfg))
        with open(os.path.join(d, name + ".json"), "w") as fo:
            fo.write(jcfg.to_json())
        torch.save(params_from_jax(trees[name]), os.path.join(d, name + ".pt"))
        np.savez(os.path.join(d, name + ".npz"),
                 **dict(zip(("wave", "ns", "labels", "label_lens"), _batch())))
    with open(os.path.join(d, "cases.json"), "w") as fo:
        json.dump({k: kind for k, (_, kind) in cases.items()}, fo)
    worker = os.path.join(d, "worker.py")
    with open(worker, "w") as fo:
        fo.write(_WORKER)
    port = str(mesh.free_port())
    procs = [_start([sys.executable, worker, d, str(r), str(WORLD), port])
             for r in range(WORLD)]
    outs = _wait(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in out, out
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"))
             for r in range(WORLD)]
    return {name: ([r[name] for r in ranks], trees[name])
            for name in cases}


def _jax_steps(jcfg, kind, tree):
    """The JAX package's 2 steps on the data=2 mesh: (losses, params,
    the eval step's loss before them)."""
    m2 = jax_mesh.make_mesh((WORLD,), ("data",), devices=jax.devices()[:WORLD])
    arrays = jax_mesh.shard_batch_arrays(_batch(), m2)
    params = jax_mesh.replicate(jax.tree_util.tree_map(jnp.asarray, tree), m2)
    ev = None
    if kind == "train":
        ev = float(jax_train.make_eval_step(jcfg, m2)(params, *arrays))
        opt = jax_train.make_optimizer(jcfg)
        step = jax_train.make_train_step(jcfg, opt, m2)
    else:
        opt = optax.chain(optax.clip_by_global_norm(jcfg.train.grad_clip),
                          optax.adamw(jcfg.train.learning_rate * 0.1))
        step = jrl.make_pg_step(jcfg, opt, m2)
    opt_state = jax_mesh.replicate(opt.init(params), m2)
    rng, losses, seen = jax.random.PRNGKey(0), [], []
    for _ in range(2):
        seen.append(jax.tree_util.tree_map(np.asarray, params))
        params, opt_state, rng, loss, *_ = step(params, opt_state, rng,
                                                *arrays)
        losses.append(float(loss))
    return losses, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params)), ev, seen


@pytest.mark.parametrize("case", list(_cases()))
def test_two_rank_step_matches_jax_data2(rank_results, case):
    ranks, tree = rank_results[case]
    jcfg, kind = _cases()[case]
    want_losses, want_params, want_eval, seen = _jax_steps(jcfg, kind, tree)
    sure = {k: np.ones(v.shape, bool) for k, v in want_params.items()}
    if kind == "train":
        # as tests/test_torch_moe.py: AdamW moves a parameter by about lr *
        # g / (|g| + 1e-8), ill-conditioned where |g| is near that eps (the
        # attention's key bias, whose gradient is ~0 by the softmax's shift
        # invariance; a gradient that crosses 0 between the steps); the
        # elements whose gradient at either step's parameters (on the
        # padded global batch: the MoE's capacity follows it) is within
        # 1e-6 of 0 are left out
        padded = jax_mesh.pad_batch_to_multiple(_batch(), WORLD)
        loss = jax.jit(jax.grad(lambda p: jax_train.compute_loss(
            p, *map(jnp.asarray, padded), jcfg, train=True)))
        for p in seen:
            grads = params_from_jax(jax.tree_util.tree_map(
                np.asarray, loss(jax.tree_util.tree_map(jnp.asarray, p))))
            sure = {k: sure[k] & (np.abs(g.numpy()) > 1e-6)
                    for k, g in grads.items()}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-4,
                                   atol=1e-5)
        if kind == "train":
            np.testing.assert_allclose(r["eval"], want_eval, rtol=1e-4,
                                       atol=1e-5)
        for k, v in want_params.items():
            np.testing.assert_allclose(r["params"][k].numpy()[sure[k]],
                                       v.numpy()[sure[k]], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    # the ranks hold the same parameters, bit for bit
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    assert ranks[0]["losses"] == ranks[1]["losses"]


# --------------------------------------------------------------- the CLI

def _tiny_model(corpus: str, model: str) -> None:
    """One epoch of tests/test_multihost.py's tiny BiLSTM-CTC (dropout 0):
    a CLI run on this model directory resumes it, its model from
    config.json."""
    train(corpus, model, device="cpu", config=Config(
        features=FeatureConfig(kind="logmel", n_mels=16, n_fft=128,
                               win_length=128, hop_length=64),
        model=ModelConfig(vocab_size=8, input_dim=16, input_proj_dim=32,
                          hidden_size=16, num_layers=1, dropout=0.0),
        train=TrainConfig(num_epochs=1, batch_size=8, learning_rate=1e-3,
                          warmup_steps=0, log_every=1000)))


@pytest.fixture(scope="module")
def equal_corpus(tmp_path_factory):
    """tests/test_multihost.py's corpus (10 utterances of 0.25 s: 8 train,
    one batch of 8 whether from one process or two ranks of 4) and the
    tiny model trained on it for one epoch."""
    d = tmp_path_factory.mktemp("equal")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=10, seed=5,
                                      min_dur=0.25, max_dur=0.25)
    model = str(d / "tiny")
    _tiny_model(corpus, model)
    return corpus, model


def test_cli_mesh_data2_matches_one_process(equal_corpus, tmp_path):
    corpus, tiny = equal_corpus
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    shutil.copytree(tiny, one)
    shutil.copytree(tiny, two)
    argv = ["--mode", "train", "--corpus_path", corpus, "--num_epochs", "2",
            "--batch_size", "8", "--device", "cpu"]
    assert cli.main(argv + ["--model_path", one]) == 0
    p = _start([sys.executable, "-m", "pg_asr_tpu_torch", *argv,
                "--model_path", two, "--mesh", "data=2"])
    (out,) = _wait([p])
    assert p.returncode == 0, out
    assert out.count("torch.distributed initialized (process") == 2
    assert out.count("[train] epoch 2/2") == 1  # rank 0 prints
    np.testing.assert_allclose(np.load(os.path.join(two, "train_loss.npy")),
                               np.load(os.path.join(one, "train_loss.npy")),
                               rtol=1e-4)
    # rank 0 wrote, in the one-device layout; the one dev row is fewer
    # than the ranks, so no rank validated (nor a val_losses.npy beyond
    # the tiny run's)
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    assert len(np.load(os.path.join(two, "val_losses.npy"))) == 1
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", two, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(two, "predicted.txt"))


def test_misconfigured_cluster_fails_loudly(monkeypatch, tmp_path):
    """A configured cluster that cannot be joined raises (the JAX package's
    message); asking for more CUDA ranks than the host has exits."""
    with pytest.raises(RuntimeError, match="init_process_group failed for "
                       "the configured cluster") as e:
        mesh.init_distributed("127.0.0.1:1", 2, None)
    assert "process_id=None" in str(e.value)
    with pytest.raises(RuntimeError, match="init_process_group failed"):
        # nobody serves the coordinator's port: the rendezvous times out
        mesh.init_distributed(f"127.0.0.1:{mesh.free_port()}", 2, 1,
                              timeout_s=1)
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("PGASR_DISTRIBUTED", "1")
    monkeypatch.setenv("PGASR_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PGASR_NUM_PROCESSES", "2")
    monkeypatch.delenv("PGASR_PROCESS_ID", raising=False)
    argv = ["--mode", "train", "--corpus_path", str(tmp_path / "c"),
            "--model_path", str(tmp_path / "m"), "--mesh", "data=2"]
    with pytest.raises(RuntimeError, match="init_process_group failed"):
        cli.main(argv + ["--device", "cpu"])
    monkeypatch.delenv("PGASR_DISTRIBUTED")
    with pytest.raises(SystemExit, match="no CUDA device|only .* CUDA"):
        cli.main(argv + ["--device", "cuda"])
    assert not os.path.exists(tmp_path / "m")


def test_sigterm_to_one_rank_stops_both(equal_corpus, tmp_path):
    """Two rank processes started by the user (the PGASR_* contract); a
    SIGTERM to rank 1 stops both at the same step, rank 0 saves the one
    model_last, and both exit 0."""
    corpus, tiny = equal_corpus
    model = str(tmp_path / "m")
    shutil.copytree(tiny, model)
    port = mesh.free_port()
    procs = [_start([sys.executable, "-m", "pg_asr_tpu_torch", "--mode",
                     "train", "--corpus_path", corpus, "--model_path", model,
                     "--num_epochs", "100000", "--batch_size", "8",
                     "--mesh", "data=2", "--device", "cpu"],
                    PGASR_DISTRIBUTED="1",
                    PGASR_COORDINATOR=f"127.0.0.1:{port}",
                    PGASR_NUM_PROCESSES="2", PGASR_PROCESS_ID=str(r))
             for r in range(WORLD)]
    losses = os.path.join(model, "train_loss.npy")
    end = time.monotonic() + TIMEOUT
    while time.monotonic() < end and all(p.poll() is None for p in procs):
        try:  # (rank 0 may be writing it)
            if len(np.load(losses)) >= 3:
                break
        except (OSError, ValueError, EOFError):
            pass
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    outs = _wait(procs)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "SIGTERM: saved model_last" in outs[0]
    assert "SIGTERM" not in outs[1]  # rank 1 stopped, rank 0 saved
    last = torch.load(os.path.join(model, "model_last.pt"))
    assert 3 <= last["step"] < 100000
    assert [n for n in os.listdir(model) if "last" in n] == ["model_last.pt"]
