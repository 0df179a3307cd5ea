"""The expert mesh axis of the port (the expert placement of
pg_asr_tpu_torch/parallel/moe.py, the plan of parallel/driver.py, the
ranks of parallel/mesh.py, the steps of train.py and rl/reinforce.py) vs the
JAX package's (pg_asr_tpu/parallel/moe.py's ``moe_param_specs`` and
``shard_moe_params``, driver.ParallelPlan and its GSPMD steps on a mesh of
the forced host devices).

The placement first: each rank holds the slice of every leaf that the
JAX placement gives its mesh position (E/X experts of each stack, the rest
whole), and the plan refuses what JAX's refuses, with its message. Then
the steps, in four gloo rank processes (tests/test_torch_mesh_ranks.py): the
switch-MoE's train steps under ``expert=2`` and train and eval steps
under ``data=2,expert=2``, each against JAX's steps on the same mesh,
arrays and weights, and its MWER policy-gradient steps under
``expert=2`` against the port's one process, at tests/test_torch_mesh.py's
tolerances, with the clip engaged. Last, the
CLI: ``--mesh expert=2 --device cpu`` resumes a tiny MoE model on two rank
processes as one process goes, writes the full shapes, and one-device
predict and a run without a mesh take its checkpoint.
"""

import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransformerConfig as JTransformerConfig
from pg_asr_tpu.parallel import driver as jax_driver
from pg_asr_tpu.parallel import moe as jax_moe
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import (Config, FeatureConfig, ModelConfig,
                                     TrainConfig, TransformerConfig)
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.parallel import driver, moe
from pg_asr_tpu_torch.rl.reinforce import make_pg_step
from pg_asr_tpu_torch.train import AdamW, train
from tests.test_torch_mesh import _batch, _start, _wait, equal_corpus  # noqa: F401
from tests.test_torch_mesh_ranks import (CLIP, assert_matches,
                                         jax_cases, jax_names, jax_tree,
                                         mesh_devices, mesh_of, moved,
                                         run_ranks)

E = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe(experts: int = E, **train) -> JConfig:
    """tests/test_torch_mesh.py's tiny switch-MoE transformer (2 blocks:
    the first's output, summed over the expert group, feeds the second's
    router)."""
    return JConfig(
        model=JModelConfig(family="transformer", vocab_size=8, input_dim=80),
        transformer=JTransformerConfig(num_layers=2, d_model=32, num_heads=2,
                                       ffn_dim=64, dropout=0.0,
                                       num_experts=experts,
                                       capacity_factor=1.0),
        train=JTrainConfig(batch_size=5, warmup_steps=0, learning_rate=0.05,
                           grad_clip=CLIP, **train))


def _other(family: str) -> JConfig:
    if family == "dense":
        return _moe(experts=0)
    return JConfig(model=JModelConfig(vocab_size=8, input_proj_dim=32,
                                      hidden_size=16, num_layers=1))


# ------------------------------------------------------------ placement

PLAN_CASES = [
    ("expert=2", "moe"), ("data=2,expert=2", "moe"), ("expert=4", "moe"),
    ("expert=3", "moe"),  # 4 experts over 3
    ("expert=2", "dense"), ("expert=2", "ctc"),
    ("expert=2,fsdp=2", "moe"), ("seq=2,expert=2", "moe"),
    ("expert=2,data=2", "moe"),
]


@pytest.mark.parametrize("spec,family", PLAN_CASES)
def test_plan_matches_jax(spec, family):
    """The port's plan refuses what JAX's ParallelPlan refuses, with its
    message, and otherwise takes the same batch multiple."""
    shape, axes = driver.parse_mesh_spec(spec)
    jcfg = _moe() if family == "moe" else _other(family)
    m, _ = mesh_devices(spec)
    cfg = Config.from_json(jcfg.to_json())
    try:
        want = jax_driver.ParallelPlan(jcfg, m)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            driver.ParallelPlan(cfg, shape, axes)
        assert str(got.value) == str(e)
        return
    plan = driver.ParallelPlan(cfg, shape, axes)
    assert plan.world == math.prod(shape)
    assert plan.batch_multiple == want.batch_multiple


def test_model_with_expert_stays_refused():
    """JAX composes data x model x expert, and the port runs it since the
    model axis was ported (tests/test_torch_tensor.py): the expert stacks
    split on both axes; a pipe axis, ported since (tests/
    test_torch_pipeline.py), refuses the switch-MoE with the JAX package's
    message."""
    cfg = Config.from_json(_moe().to_json())
    plan = driver.ParallelPlan(cfg, *driver.parse_mesh_spec(
        "data=1,model=2,expert=2"))
    assert plan.world == 4 and plan.strategy == "expert" and plan.tp
    assert plan.placement("blocks.0.w1", (E, 32, 64)) == (
        ("expert", 0), ("model", 2))
    with pytest.raises(ValueError, match="'pipe' axis requires the dense "
                       r"transformer family \(got family='transformer', "
                       f"num_experts={E}\\)"):
        driver.ParallelPlan(cfg, *driver.parse_mesh_spec(
            "data=1,pipe=2,model=2"))


@pytest.mark.parametrize("spec", ["expert=2", "data=2,expert=2",
                                  "expert=2,data=2"])
def test_shards_are_the_jax_shards(spec):
    """Each rank's leaves are the slices of the JAX placement
    (``shard_moe_params``: ``moe_param_specs``) that the device at its mesh
    position holds: E/2 experts of each stack, the router and the dense
    leaves whole."""
    jcfg = _moe()
    tree = jax_tree(jcfg)
    m, devices = mesh_devices(spec)
    cfg = Config.from_json(jcfg.to_json())
    plan = driver.ParallelPlan(cfg, *driver.parse_mesh_spec(spec))
    full = params_from_jax(tree)
    spec_for = jax_moe.moe_param_specs(m)
    want_specs = {k: tuple(spec_for(tuple(k.split("."))))
                  for k in full}
    assert moe.moe_param_specs(full) == want_specs
    jax_leaves = jax_names(jax_moe.shard_moe_params(tree, m))
    for rank, device in enumerate(devices):
        mine = moe.shard_moe_params(full, plan.sizes["expert"],
                                    plan.coords(rank)["expert"])
        for k, v in mine.items():
            shard = next(s for s in jax_leaves[k].addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(v.numpy(), np.asarray(shard.data),
                                          err_msg=f"rank {rank} {k}")
            if moe.moe_leaf_dim(k) == 0:
                assert v.shape[0] == E // 2
            assert plan.placement(k, tuple(full[k].shape)) == (
                None if moe.moe_leaf_dim(k) is None else ("expert", 0))


# ------------------------------------------------ the steps on four ranks

def _step_cases() -> dict:
    """name -> (JAX config with its mesh, kind, steps)."""
    return {
        "d2x2_train": (_moe(**mesh_of("data=2,expert=2")), "train", 2),
        "x2_train": (_moe(**mesh_of("expert=2")), "steps", 2),
    }


def _pg_config() -> JConfig:
    """MWER fine-tuning under expert=2 (held against the port's one
    process; the JAX comparison of an MWER step on a mesh is
    tests/test_torch_fsdp.py's)."""
    return _moe(**mesh_of("expert=2")).replace(rl=JRLConfig(
        objective="mwer", mwer_beam=3, space_id=1))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every step case through the four processes: {case: [rank
    results]}, "trees" the weights and "meanwhile" the JAX steps."""
    d = str(tmp_path_factory.mktemp("expert_ranks"))
    tree = jax_tree(_moe())  # the cases' one model, from one key
    steps = {name: (jcfg, kind, n, tree, _batch())
             for name, (jcfg, kind, n) in _step_cases().items()}
    cases = {name: (c[0].to_json(), *c[1:]) for name, c in steps.items()}
    cases["x2_pg_mwer"] = (_pg_config().to_json(), "pg", 2, tree, _batch())
    out = run_ranks(d, cases, [
        ([0, 1, 2, 3], ["d2x2_train"]),
        ([0, 1], ["x2_train"]),
        ([2, 3], ["x2_pg_mwer"]),
    ], meanwhile=lambda: jax_cases(steps))
    out["tree"] = tree
    return out


@pytest.mark.parametrize("case", list(_step_cases()))
def test_steps_match_jax(ranks, case):
    jcfg = _step_cases()[case][0]
    want, got = ranks["meanwhile"][case], ranks[case]
    assert len(got) == math.prod(jcfg.train.mesh_shape)
    assert_matches(got, want)
    assert moved(got, ranks["tree"]) > 100 * 1e-5
    # the ranks of one expert group hold the same rows, half the experts
    full = params_from_jax(ranks["tree"])
    for r in got:
        for k, shape in r["shapes"].items():
            want_shape = list(full[k].shape)
            if moe.moe_leaf_dim(k) == 0:
                want_shape[0] //= 2
            assert tuple(shape) == tuple(want_shape), k


def test_pg_step_matches_one_process(ranks):
    """2 MWER policy-gradient steps under expert=2 (finetune_pg's
    optimizer) against the port's one-process steps on the same batch, at
    tests/test_torch_mesh.py's tolerances, the clip engaged."""
    cfg = Config.from_json(_pg_config().to_json())
    params = params_from_jax(ranks["tree"])
    step = make_pg_step(cfg, AdamW(cfg, params,
                                   learning_rate=cfg.train.learning_rate * 0.1,
                                   weight_decay=1e-4))
    gen = torch.Generator().manual_seed(0)
    arrays = [torch.from_numpy(a) for a in _batch()]
    want = {"losses": [step(params, gen, *arrays)[0].item()
                       for _ in range(2)],
            "eval": None, "params": params, "ema": None}
    assert_matches(ranks["x2_pg_mwer"], want)
    assert moved(ranks["x2_pg_mwer"], ranks["tree"]) > 100 * 1e-5


# --------------------------------------------------------------- the CLI

def _tiny_moe(corpus: str, model: str) -> None:
    """One epoch of a tiny switch-MoE (dropout 0, tests/test_multihost.py's
    features): a CLI run on this directory resumes it, its model from
    config.json."""
    train(corpus, model, device="cpu", config=Config(
        features=FeatureConfig(kind="logmel", n_mels=16, n_fft=128,
                               win_length=128, hop_length=64),
        model=ModelConfig(family="transformer", vocab_size=8, input_dim=16,
                          dropout=0.0),
        transformer=TransformerConfig(num_layers=2, d_model=32, num_heads=2,
                                      ffn_dim=64, dropout=0.0,
                                      num_experts=E, capacity_factor=2.0),
        train=TrainConfig(num_epochs=1, batch_size=8, learning_rate=1e-3,
                          warmup_steps=0, log_every=1000)))


def test_cli_mesh_expert2_matches_one_process(equal_corpus, tmp_path):  # noqa: F811
    corpus, _ = equal_corpus
    tiny = str(tmp_path / "tiny")
    _tiny_moe(corpus, tiny)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    shutil.copytree(tiny, one)
    shutil.copytree(tiny, two)
    argv = ["--mode", "train", "--corpus_path", corpus, "--batch_size", "8",
            "--device", "cpu"]
    assert cli.main(argv + ["--model_path", one, "--num_epochs", "3"]) == 0
    p = _start([sys.executable, "-m", "pg_asr_tpu_torch", *argv,
                "--model_path", two, "--num_epochs", "2", "--mesh",
                "expert=2"])
    (out,) = _wait([p])
    assert p.returncode == 0, out
    assert out.count("torch.distributed initialized (process") == 2
    assert out.count("[train] epoch 2/2") == 1  # rank 0 prints
    # the checkpoint holds the one-device shapes: every expert
    last = load_checkpoint(os.path.join(two, "model_last.pt"))
    ref = load_checkpoint(os.path.join(one, "model_last.pt"))
    shapes = {k: v.shape for k, v in ref["params"].items()}
    assert {k: v.shape for k, v in last["params"].items()} == shapes
    assert {k: v.shape for k, v in last["opt_state"]["mu"].items()} == shapes
    assert last["params"]["blocks.0.w1"].shape[0] == E
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", two, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(two, "predicted.txt"))
    # resumed without a mesh, the run goes on as the one-process run
    assert cli.main(argv + ["--model_path", two, "--num_epochs", "3"]) == 0
    np.testing.assert_allclose(np.load(os.path.join(two, "train_loss.npy")),
                               np.load(os.path.join(one, "train_loss.npy")),
                               rtol=1e-4)


def test_cli_refuses_a_mesh_the_model_cannot_take(equal_corpus, tmp_path):  # noqa: F811
    """A refused mesh exits before any rank starts, with the JAX package's
    message."""
    corpus, tiny = equal_corpus  # a BiLSTM-CTC
    with pytest.raises(SystemExit, match="'expert' axis needs a MoE model"):
        cli.main(["--mode", "train", "--corpus_path", corpus,
                  "--model_path", str(tmp_path / "m"), "--device", "cpu",
                  "--mesh", "expert=2"])
    with pytest.raises(SystemExit, match="not divisible over expert axis"):
        cli.main(["--mode", "train", "--corpus_path", corpus,
                  "--model_path", str(tmp_path / "m"), "--device", "cpu",
                  "--model", "moe", "--moe_experts", "3", "--mesh",
                  "expert=2"])
    assert not os.path.exists(tmp_path / "m")
