"""The pipe mesh axis of the port (GPipe pipeline parallelism:
pg_asr_tpu_torch/parallel/pipeline.py, the plan of parallel/driver.py, the
stages' placement and point-to-point moves of parallel/mesh.py, the steps
of train.py, finetune_pg's replicas) vs the JAX package
(pg_asr_tpu/parallel/pipeline.py, parallel/driver.py's ``ParallelPlan``).

The plan first, without processes: it refuses what the JAX ``ParallelPlan``
refuses, with its message (a family other than the dense transformer, L
not divisible into the stages, a model axis that does not divide the heads
and the FFN under ``pipe``), takes its microbatches and batch multiple, and
puts each block on the stage the JAX stacking puts it. Then the steps, in
four gloo rank processes (tests/test_torch_mesh_ranks.py), on a 4-layer
tiny transformer (tests/test_pipeline.py's shapes) and a ragged batch of 5
rows: ``pipe=2`` at M=2 and 4, ``pipe=4``, ``data=2,pipe=2`` and
``pipe=2,model=2`` against the JAX package's steps on the same mesh of
forced host devices, and 2 MWER steps of ``finetune_pg``'s step under
``pipe=2`` (replicas of the data step) against the port's one-process
steps (the JAX PG step on any mesh is one replicated step), at
tests/test_torch_mesh.py's tolerances with the clip engaged; every rank
holds its stage's blocks and the whole leaves only, and the ranks end
bit-equal. And the CLI (its four rank processes run beside the others):
``--mesh data=2,pipe=2 --microbatches 2 --device cpu`` trains a tiny
transformer on four rank processes as one process does, writes the
canonical checkpoint, and one-device predict and a run without a mesh
take it.
"""

import dataclasses
import math
import os
import shutil
import signal
import sys

import numpy as np
import pytest
import torch

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import FeatureConfig as JFeatureConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransformerConfig as JTransformerConfig
from pg_asr_tpu.parallel import driver as jax_driver
from pg_asr_tpu.parallel.pipeline import stack_pipeline_params
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import (Config, FeatureConfig, ModelConfig,
                                     TrainConfig, TransformerConfig)
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.parallel import driver
from pg_asr_tpu_torch.rl.reinforce import make_pg_step
from pg_asr_tpu_torch.train import AdamW, train
from tests.test_torch_mesh import _batch, _start, _wait
from tests.test_torch_mesh_ranks import (CLIP, assert_matches, jax_cases,
                                         jax_names, jax_tree, mesh_devices,
                                         mesh_of, moved, run_ranks)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FEATURES = dict(kind="logmel", n_mels=16, n_fft=128, win_length=128,
                hop_length=64)


def tiny(spec: str = "data=1", microbatches: int = 0, layers: int = 4,
         family: str = "transformer", **kw) -> JConfig:
    """tests/test_pipeline.py's 4-layer transformer (d 32, 2 heads, FFN 64,
    dropout 0) on mesh `spec`, the clip engaged; `family` "moe" gives it
    2 experts, "ctc" is a tiny BiLSTM-CTC."""
    train_cfg = JTrainConfig(batch_size=5, warmup_steps=0, learning_rate=0.05,
                             grad_clip=CLIP,
                             pipeline_microbatches=microbatches,
                             **mesh_of(spec))
    attn = dict(num_layers=layers, d_model=32, num_heads=2, ffn_dim=64,
                dropout=0.0, subsample=2)
    attn.update(kw)
    if family == "ctc":
        return JConfig(features=JFeatureConfig(**FEATURES),
                       model=JModelConfig(vocab_size=8, input_dim=16,
                                          input_proj_dim=16, hidden_size=8,
                                          num_layers=1, dropout=0.0),
                       train=train_cfg)
    return JConfig(
        features=JFeatureConfig(**FEATURES),
        model=JModelConfig(family="transformer", vocab_size=8, input_dim=16,
                           dropout=0.0),
        transformer=JTransformerConfig(
            **attn, num_experts=2 if family == "moe" else 0),
        train=train_cfg)


# ------------------------------------------------------------------ plan

PLAN_CASES = [
    ("pipe=2", {}), ("pipe=4", {}), ("pipe=2", dict(microbatches=3)),
    ("data=2,pipe=2", dict(microbatches=2)), ("pipe=3", {}),
    ("pipe=4", dict(layers=6)), ("pipe=2,model=2", {}),
    ("data=2,pipe=2,model=2", dict(microbatches=4)),
    ("pipe=2,model=2", dict(num_heads=4, ffn_dim=65)),
    ("pipe=2,model=2", dict(num_heads=1)),
    ("pipe=2", dict(family="ctc")), ("pipe=2", dict(family="moe")),
    ("pipe=2,seq=2", {}), ("pipe=2,expert=2", dict(family="moe")),
    ("data=2", dict(microbatches=2)),
]


@pytest.mark.parametrize("spec,kw", PLAN_CASES)
def test_plan_matches_jax(spec, kw):
    """The port's plan refuses what JAX's ParallelPlan refuses, with its
    message, and otherwise takes its strategy, microbatches and batch
    multiple; each block leaf lies on the stage whose slice of the JAX
    stacked layout holds it, every other leaf on every stage."""
    jcfg = tiny(**kw)
    m, _ = mesh_devices(spec)
    cfg = Config.from_json(jcfg.to_json())
    shape, axes = driver.parse_mesh_spec(spec)
    try:
        want = jax_driver.ParallelPlan(jcfg, m)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            driver.ParallelPlan(cfg, shape, axes,
                                jcfg.train.pipeline_microbatches)
        assert str(got.value) == str(e)
        return
    plan = driver.ParallelPlan(cfg, shape, axes,
                               jcfg.train.pipeline_microbatches)
    assert plan.world == math.prod(shape)
    assert (plan.strategy, plan.tp) == (want.strategy, want.tp)
    assert plan.batch_multiple == want.batch_multiple
    if want.strategy != "pipe":
        return
    assert plan.microbatches == want.microbatches
    S = plan.sizes["pipe"]
    tree = jax_tree(jcfg)
    stages = stack_pipeline_params(tree, S)["stages"]
    k = jcfg.transformer.num_layers // S
    for name, leaf in jax_names(tree).items():
        stage = plan.stage(name)
        if not name.startswith("blocks."):
            assert stage is None, name
            assert plan.splits(name, leaf.shape) == (), name
            continue
        i = int(name.split(".")[1])
        node = stages
        for part in name.split(".")[2:]:
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node)[stage, i % k], leaf)


# ------------------------------------------------ the steps on four ranks

# name -> (mesh, microbatches, kind); "train" also holds the eval step
STEP_CASES = {
    "p4": ("pipe=4", 0, "steps"),
    "d2p2": ("data=2,pipe=2", 2, "train"),
    "p2t2": ("pipe=2,model=2", 2, "steps"),
    "p2m2": ("pipe=2", 2, "steps"),
    "p2_pg": ("pipe=2", 0, "pg"),
    "p2m4": ("pipe=2", 4, "steps"),
}

_MWER = JRLConfig(objective="mwer", mwer_beam=3, space_id=1)


def _case_config(spec: str, microbatches: int, kind: str) -> JConfig:
    """A case's config; a PG case's rate is ten times its training's
    (finetune_pg steps at a tenth of it)."""
    jcfg = tiny(spec, microbatches)
    if kind != "pg":
        return jcfg
    return jcfg.replace(rl=_MWER, train=dataclasses.replace(
        jcfg.train, learning_rate=10 * jcfg.train.learning_rate))


def _pg_reference(jcfg: JConfig, tree: dict) -> dict:
    """The port's one-process MWER steps (held to the JAX package's in
    tests/test_torch_reinforce.py): the JAX PG step on any mesh is one
    replicated step, which the pipe group's replicas are."""
    cfg = Config.from_json(jcfg.to_json())
    params = params_from_jax(tree)
    step = make_pg_step(cfg, AdamW(cfg, params,
                                   learning_rate=cfg.train.learning_rate * 0.1,
                                   weight_decay=1e-4))
    gen = torch.Generator().manual_seed(0)
    arrays = [torch.from_numpy(a) for a in _batch()]
    return {"losses": [step(params, gen, *arrays)[0].item()
                       for _ in range(2)],
            "eval": None, "params": params, "ema": None}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cli_run):
    """Every case through the four processes: {case: [rank results]},
    "tree" the weights and "meanwhile" the JAX steps on the same meshes
    (the CLI's four ranks of ``cli_run`` run meanwhile too)."""
    d = str(tmp_path_factory.mktemp("pipe_ranks"))
    tree = jax_tree(tiny())
    cases, refs = {}, {}
    for name, (spec, mbs, kind) in STEP_CASES.items():
        jcfg = _case_config(spec, mbs, kind)
        cases[name] = (jcfg.to_json(), kind, 2, tree, _batch())
        if kind != "pg":
            refs[name] = (jcfg, kind, 2, tree, _batch())

    def meanwhile():
        out = jax_cases(refs)
        out["p2_pg"] = _pg_reference(_case_config("pipe=2", 0, "pg"), tree)
        return out

    out = run_ranks(d, cases, [
        ([0, 1, 2, 3], ["p4", "d2p2", "p2t2"]),
        ([0, 1], ["p2m2", "p2_pg"]),
        ([2, 3], ["p2m4"]),
    ], meanwhile=meanwhile)
    out["tree"] = tree
    return out


def _held(spec: str, microbatches: int, rank: int, full: dict) -> dict:
    """The shapes the rank at `rank` holds: its stage's blocks (their model
    parts) and every whole leaf."""
    cfg = Config.from_json(tiny(spec, microbatches).to_json())
    plan = driver.ParallelPlan(cfg, *driver.parse_mesh_spec(spec),
                               microbatches)
    me = plan.coords(rank)
    want = {}
    for k, v in full.items():
        if plan.stage(k) not in (None, me["pipe"]):
            continue
        shape = list(v.shape)
        for axis, dim in plan.splits(k, tuple(v.shape)):
            shape[dim] //= plan.sizes[axis]
        want[k] = tuple(shape)
    return want


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_jax(ranks, case):
    spec, mbs, kind = STEP_CASES[case]
    want, got = ranks["meanwhile"][case], ranks[case]
    assert len(got) == math.prod(driver.parse_mesh_spec(spec)[0])
    assert_matches(got, want)
    assert moved(got, ranks["tree"]) > 100 * 1e-5
    full = params_from_jax(ranks["tree"])
    whole = sum(v.numel() * 4 for v in full.values()) * 3
    for r, res in enumerate(got):
        shapes = (_held(spec, mbs, r, full) if kind != "pg"
                  else {k: tuple(v.shape) for k, v in full.items()})
        assert {k: tuple(s) for k, s in res["shapes"].items()} == shapes
        held = sum(math.prod(s) * 4 for s in shapes.values()) * 3
        assert res["resident"] == held
        assert (held < whole) == (kind != "pg")


# --------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """tests/test_multihost.py's equal-length corpus (8 train utterances of
    0.25 s: one batch of 8 from one process or two data ranks of 4) and a
    2-layer tiny transformer (dropout 0) trained on it for one epoch, in
    "tiny"; a copy of it in "one" and another in "four", which the CLI
    started here (the process in "proc", its arguments in "argv") goes on
    training for an epoch under ``--mesh data=2,pipe=2 --microbatches 2``
    on four rank processes while the other fixtures run."""
    d = tmp_path_factory.mktemp("pipe_cli")
    corpus, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=10, seed=5,
                                      min_dur=0.25, max_dur=0.25)
    model = str(d / "tiny")
    train(corpus, model, device="cpu", config=Config(
        features=FeatureConfig(**FEATURES),
        model=ModelConfig(family="transformer", vocab_size=8, input_dim=16,
                          dropout=0.0),
        transformer=TransformerConfig(num_layers=2, d_model=16, num_heads=2,
                                      ffn_dim=32, dropout=0.0),
        train=TrainConfig(num_epochs=1, batch_size=8, learning_rate=1e-3,
                          warmup_steps=0, log_every=1000)))
    one, four = str(d / "one"), str(d / "four")
    shutil.copytree(model, one)
    shutil.copytree(model, four)
    argv = ["--mode", "train", "--corpus_path", corpus, "--batch_size", "8",
            "--device", "cpu"]
    p = _start([sys.executable, "-m", "pg_asr_tpu_torch", *argv,
                "--model_path", four, "--num_epochs", "2", "--mesh",
                "data=2,pipe=2", "--microbatches", "2"])
    try:
        yield {"corpus": corpus, "one": one, "four": four, "argv": argv,
               "proc": p}
    finally:
        if p.poll() is None:  # no test waited for it
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


def test_cli_mesh_data2_pipe2_matches_one_process(cli_run, ranks):
    corpus, one, four = cli_run["corpus"], cli_run["one"], cli_run["four"]
    argv, p = cli_run["argv"], cli_run["proc"]
    try:
        assert cli.main(argv + ["--model_path", one, "--num_epochs", "3"]) \
            == 0
    finally:
        (out,) = _wait([p])
    assert p.returncode == 0, out
    assert out.count("torch.distributed initialized (process") == 4
    assert out.count("[train] epoch 2/2") == 1  # rank 0 prints
    # the checkpoint holds the one-device tree: every block, the canonical
    # shapes (a run without a mesh goes on from it as the one process)
    last = load_checkpoint(os.path.join(four, "model_last.pt"))
    ref = load_checkpoint(os.path.join(one, "model_last.pt"))
    shapes = {k: v.shape for k, v in ref["params"].items()}
    assert {k: v.shape for k, v in last["params"].items()} == shapes
    assert {k: v.shape for k, v in last["opt_state"]["mu"].items()} == shapes
    with open(os.path.join(four, "config.json")) as fo:
        saved = Config.from_json(fo.read()).train
    assert (saved.mesh_axes, saved.pipeline_microbatches) == (
        ("data", "pipe"), 2)
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", four, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(four, "predicted.txt"))
    assert cli.main(argv + ["--model_path", four, "--num_epochs", "3"]) == 0
    np.testing.assert_allclose(np.load(os.path.join(four, "train_loss.npy")),
                               np.load(os.path.join(one, "train_loss.npy")),
                               rtol=1e-4)
    got = load_checkpoint(os.path.join(four, "model_last.pt"))["params"]
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_cli_microbatches_below_one_exits():
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "train", "--corpus_path", "c", "--model_path",
                  "m", "--mesh", "pipe=2", "--microbatches", "0",
                  "--device", "cpu"])
    assert str(e.value) == "--microbatches must be >= 1"
