"""The model mesh axis of the port (Megatron tensor parallelism:
pg_asr_tpu_torch/parallel/tensor.py, the plan of parallel/driver.py, the
ranks of parallel/mesh.py, the models' pairs, the steps of train.py and
rl/reinforce.py) vs the JAX package (pg_asr_tpu/parallel/mesh.py's
``param_sharding_rules``, parallel/moe.py's ``moe_param_specs``,
parallel/pipeline.py's ``permute_qkv_for_tp`` and its one-device steps).

The placement first, without processes: every leaf of every family lies
where the JAX rules put it on the mesh (whole where the axis does not
divide it, as the port keeps it), the run layouts of ``qkv`` and
``conv_in`` are the JAX permutation and invert exactly, and the plan of a
``data=2,model=2,expert=2`` world of 8 lays its ranks and groups out as
the JAX mesh lays its devices. Then the steps, in four gloo rank processes
(tests/test_torch_mesh_ranks.py): every family under ``model=2``, the
switch-MoE under ``model=2,expert=2``, the transducer under
``data=2,model=2`` (unfused joint) and ``model=2`` (fused joint), and two
MWER policy-gradient steps, each against the JAX package's one-device
steps on the padded global batch (the transducer's MWER against the
port's one process), at tests/test_torch_mesh.py's tolerances with the
clip engaged; the ranks of a model group end bit-equal, and each holds
the share of the parameters and moments that the splits give. Last, the
CLI: ``--mesh model=2 --device cpu`` trains a tiny transformer on two rank
processes as one process does, writes the full canonical shapes, and
one-device predict and a run without a mesh take its checkpoint.
"""

import dataclasses
import math
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ConformerConfig as JConformerConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransducerConfig as JTransducerConfig
from pg_asr_tpu.config import TransformerConfig as JTransformerConfig
from pg_asr_tpu.parallel import mesh as jax_mesh
from pg_asr_tpu.parallel import moe as jax_moe
from pg_asr_tpu.parallel.pipeline import permute_qkv_for_tp
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import (Config, FeatureConfig, ModelConfig,
                                     TrainConfig, TransformerConfig)
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.parallel import driver, mesh, tensor
from pg_asr_tpu_torch.rl.reinforce import make_pg_step
from pg_asr_tpu_torch.train import AdamW, train
from tests.test_torch_mesh import _batch, _start, _wait, equal_corpus  # noqa: F401
from tests.test_torch_mesh_ranks import (CLIP, assert_matches, jax_cases,
                                         jax_tree, mesh_devices, mesh_of,
                                         moved, run_ranks)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(**kw) -> JTrainConfig:
    return JTrainConfig(batch_size=5, warmup_steps=0, learning_rate=0.05,
                        grad_clip=CLIP, **kw)


def _family(name: str, spec: str = "data=1") -> JConfig:
    """The tiny config of each family the port trains, on mesh `spec`."""
    train = _train(**mesh_of(spec))
    lstm = dict(input_proj_dim=16, hidden_size=8, num_layers=1, dropout=0.0,
                use_pallas_lstm=False)
    attn = dict(num_layers=1, d_model=16, num_heads=2, ffn_dim=32,
                dropout=0.0)
    if name == "ctc":
        return JConfig(model=JModelConfig(vocab_size=8, **lstm), train=train)
    if name == "seq2seq":
        return JConfig(model=JModelConfig(family="seq2seq", vocab_size=8,
                                          **lstm),
                       seq2seq=JSeq2SeqConfig(vocab_size=8, embed_dim=8,
                                              dec_hidden=16), train=train)
    if name in ("transformer", "moe"):
        return JConfig(
            model=JModelConfig(family="transformer", vocab_size=8,
                               input_dim=80),
            transformer=JTransformerConfig(
                **attn, num_experts=4 if name == "moe" else 0,
                capacity_factor=1.0), train=train)
    if name == "conformer":
        return JConfig(model=JModelConfig(family="conformer", vocab_size=8,
                                          input_dim=80),
                       conformer=JConformerConfig(**attn, conv_kernel=3),
                       train=train)
    # the transducer: a transformer encoder, the unfused joint and the
    # hybrid CTC head; or a conformer encoder and the fused joint
    fused = name == "transducer_fused"
    return JConfig(
        model=JModelConfig(family="transducer", vocab_size=8, input_dim=80,
                           dropout=0.0),
        transformer=JTransformerConfig(**attn),
        conformer=JConformerConfig(**attn, conv_kernel=3),
        transducer=JTransducerConfig(
            encoder="conformer" if fused else "transformer",
            pred_embed_dim=8, pred_hidden=8, joint_dim=16,
            ctc_weight=0.0 if fused else 0.3, fused_joint=fused),
        train=train)


FAMILIES = ["ctc", "transformer", "conformer", "moe", "transducer",
            "transducer_fused", "seq2seq"]


# ------------------------------------------------------------ placement

@pytest.mark.parametrize("family,spec", [
    (f, s) for f in FAMILIES
    for s in ("model=2", "data=2,model=2", "model=4", "model=3")]
    + [("moe", "model=2,expert=2")])
def test_placement_is_the_jax_spec(family, spec):
    """Every leaf's splits are the JAX rules' (``param_sharding_rules``,
    under an expert axis ``moe_param_specs``) on the mesh of `spec`,
    called on its path: the model dimension where the axis divides it (for
    the attention, the heads; for ``conv_in``, the GLU's halves), the
    leaf whole where it does not; the port's copies of the rules give the
    JAX specs."""
    jcfg = _family(family)
    full = params_from_jax(jax_tree(jcfg))
    m, _ = mesh_devices(spec)
    expert = "expert" in spec
    spec_for = (jax_moe.moe_param_specs(m) if expert
                else jax_mesh.param_sharding_rules(m))
    cfg = Config.from_json(jcfg.to_json())
    plan = driver.ParallelPlan(cfg, *driver.parse_mesh_spec(spec))
    T = plan.sizes["model"]
    heads = (jcfg.conformer if family in ("conformer", "transducer_fused")
             else jcfg.transformer).num_heads
    for k, v in full.items():
        path = tuple(k.split("."))
        want = tuple(spec_for(path))
        port = tensor.moe_spec_for(path) if expert else tensor.spec_for(path)
        assert port == want, k
        splits = dict(plan.splits(k, tuple(v.shape)))
        if "expert" in want:
            assert splits.pop("expert") == 0, k
        if "model" not in want:
            assert splits == {}, k
            continue
        dim = want.index("model")
        parts = k.split(".")
        owner = parts[-2] if parts[-1] in ("w", "b", "W", "U") else ""
        if owner in ("qkv", "attn_out"):
            fits = heads % T == 0
        elif owner == "conv_in":
            fits = v.shape[dim] % (2 * T) == 0
        else:
            fits = v.shape[dim] % T == 0
        assert splits == ({"model": dim} if fits else {}), k
    placed = plan.placement("blocks.0.w1", (4, 16, 32))
    if expert:  # both splits of an expert stack
        assert placed == (("expert", 0), ("model", 2))


def test_run_layouts_are_the_jax_permutation():
    """``qkv``'s run layout is ``permute_qkv_for_tp``'s, ``conv_in``'s is
    [T][2][d/T], and both invert exactly."""
    rng = np.random.default_rng(0)
    d, h = 16, 4
    for T in (2, 4):
        w = rng.standard_normal((d, 3 * d)).astype(np.float32)
        b = rng.standard_normal((3 * d,)).astype(np.float32)
        want = permute_qkv_for_tp({"blocks": [{"qkv": {"w": w, "b": b}}]},
                                  h, T)["blocks"][0]["qkv"]
        for name, v in (("blocks.0.qkv.w", w), ("blocks.0.qkv.b", b)):
            run = tensor.to_run(name, torch.from_numpy(v), T)
            np.testing.assert_array_equal(run.numpy(),
                                          np.asarray(want[name[-1]]))
            assert torch.equal(tensor.to_run(name, run, T, inverse=True),
                               torch.from_numpy(v))
        c = torch.from_numpy(rng.standard_normal((d, 2 * d)).astype(
            np.float32))
        run = tensor.to_run("blocks.0.conv_in.w", c, T)
        want = c.reshape(d, 2, T, d // T).transpose(1, 2).reshape(d, 2 * d)
        assert torch.equal(run, want)
        # rank t's part: its channels' a and b, in order
        part = run[:, :2 * d // T]
        assert torch.equal(part[:, :d // T], c[:, :d // T])
        assert torch.equal(part[:, d // T:], c[:, d:d + d // T])
        assert torch.equal(tensor.to_run("blocks.0.conv_in.w", run, T,
                                         inverse=True), c)
        assert tensor.to_run("blocks.0.ffn_in.w", c, T) is c


def test_world_of_eight_is_the_jax_mesh():
    """``data=2,model=2,expert=2``: each rank's coordinates are its JAX
    device's position, the groups of each axis set the ranks that differ
    only along it, and the stacks split on both axes."""
    spec = "data=2,model=2,expert=2"
    jcfg = _family("moe", spec)
    plan = driver.ParallelPlan(Config.from_json(jcfg.to_json()),
                               *driver.parse_mesh_spec(spec))
    assert plan.world == 8 and plan.batch_multiple == 2
    m, devices = mesh_devices(spec)
    where = {d: i for i, d in np.ndenumerate(np.asarray(m.devices))}
    coords = [plan.coords(r) for r in range(8)]
    for r, dev in enumerate(devices):
        assert tuple(coords[r][a] for a in ("data", "model", "expert")) \
            == where[dev]
    assert mesh.group_parts(coords, ("model",)) == (
        (0, 2), (1, 3), (4, 6), (5, 7))
    assert mesh.group_parts(coords, ("expert",)) == (
        (0, 1), (2, 3), (4, 5), (6, 7))
    assert mesh.group_parts(coords, ("data",)) == (
        (0, 4), (1, 5), (2, 6), (3, 7))
    assert mesh.group_parts(coords, ("model", "expert")) == (
        (0, 1, 2, 3), (4, 5, 6, 7))
    assert plan.placement("blocks.0.w2", (4, 32, 16)) == (
        ("expert", 0), ("model", 1))
    assert plan.placement("blocks.0.b2", (4, 16)) == ("expert", 0)
    assert plan.placement("blocks.0.router.w", (16, 4)) is None
    assert plan.placement("blocks.0.qkv.w", (16, 48)) == ("model", 1)


# ------------------------------------------------ the steps on four ranks

def _step_cases() -> dict:
    """name -> (family, mesh, kind); each held to the JAX package's
    one-device steps."""
    return {
        "d2t2_transducer": ("transducer", "data=2,model=2", "train"),
        "t2x2_moe": ("moe", "model=2,expert=2", "train"),
        "t2_ctc": ("ctc", "model=2", "steps"),
        "t2_transformer": ("transformer", "model=2", "train"),
        "t2_conformer": ("conformer", "model=2", "train"),
        "t2_moe": ("moe", "model=2", "steps"),
        "t2_transducer_fused": ("transducer_fused", "model=2", "steps"),
        "t2_seq2seq": ("seq2seq", "model=2", "steps"),
        "t2_pg_mwer": ("transformer", "model=2", "pg"),
    }


_MWER = JRLConfig(objective="mwer", mwer_beam=3, space_id=1)


def _case_config(family: str, spec: str, kind: str) -> JConfig:
    """A case's config; a PG case's rate is ten times its training's
    (finetune_pg steps at a tenth of it)."""
    jcfg = _family(family, spec)
    if kind != "pg":
        return jcfg
    return jcfg.replace(rl=_MWER, train=dataclasses.replace(
        jcfg.train, learning_rate=10 * jcfg.train.learning_rate))


def _reference(family: str, spec: str, kind: str) -> tuple:
    """The JAX package's one-device config and batch for a case: the
    global batch padded to the data axis's multiple (the fused joint's
    reference is the unfused joint: the JAX package runs its Pallas joint
    on a TPU only)."""
    jcfg = _case_config(family, "data=1", kind)
    if family == "transducer_fused":
        jcfg = jcfg.replace(transducer=dataclasses.replace(
            jcfg.transducer, fused_joint=False))
    data = dict(zip(*reversed(driver.parse_mesh_spec(spec)))).get("data", 1)
    return jcfg, mesh.pad_batch_to_multiple(_batch(), data)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case through the four processes: {case: [rank results]},
    "trees" the weights and "meanwhile" the JAX steps."""
    d = str(tmp_path_factory.mktemp("tensor_ranks"))
    trees = {f: jax_tree(_family(f)) for f in FAMILIES}
    cases, refs = {}, {}
    for name, (family, spec, kind) in _step_cases().items():
        cases[name] = (_case_config(family, spec, kind).to_json(), kind, 2,
                       trees[family], _batch())
        jcfg, batch = _reference(family, spec, kind)
        refs[name] = (jcfg, kind, 2, trees[family], batch)
    cases["t2_pg_transducer"] = (_case_config(
        "transducer", "model=2", "pg").to_json(), "pg", 2,
        trees["transducer"], _batch())
    out = run_ranks(d, cases, [
        ([0, 1, 2, 3], ["d2t2_transducer", "t2x2_moe"]),
        ([0, 1], ["t2_ctc", "t2_conformer", "t2_seq2seq", "t2_pg_mwer",
                  "t2_pg_transducer"]),
        ([2, 3], ["t2_transformer", "t2_moe", "t2_transducer_fused"]),
    ], meanwhile=lambda: jax_cases(refs))
    out["trees"] = trees
    return out


def _held_share(ranks: list, family: str, spec: str, full: dict) -> None:
    """Each rank holds its part of every split leaf (the shapes the plan's
    splits give) and, in parameters and AdamW moments, that share of the
    bytes."""
    plan = driver.ParallelPlan(Config.from_json(_family(family,
                                                        spec).to_json()),
                               *driver.parse_mesh_spec(spec))
    want = {}
    for k, v in full.items():
        shape = list(v.shape)
        for axis, dim in plan.splits(k, tuple(v.shape)):
            shape[dim] //= plan.sizes[axis]
        want[k] = tuple(shape)
    for r in ranks:
        assert {k: tuple(s) for k, s in r["shapes"].items()} == want
        held = sum(math.prod(s) * 4 for s in want.values()) * 3
        whole = sum(v.numel() * 4 for v in full.values()) * 3
        assert r["resident"] == held < whole


@pytest.mark.parametrize("case", list(_step_cases()))
def test_steps_match_jax(ranks, case):
    family, spec, kind = _step_cases()[case]
    want, got = ranks["meanwhile"][case], ranks[case]
    assert len(got) == driver.ParallelPlan(
        Config.from_json(_family(family, spec).to_json()),
        *driver.parse_mesh_spec(spec)).world
    assert_matches(got, want)
    assert moved(got, ranks["trees"][family]) > 100 * 1e-5
    _held_share(got, family, spec, params_from_jax(ranks["trees"][family]))


def test_transducer_pg_step_matches_one_process(ranks):
    """2 MWER policy-gradient steps of the transducer under model=2 (its
    beam on the pairs gathered whole, the re-scoring and the anchor split)
    against the port's one-process steps on the same batch."""
    cfg = Config.from_json(_case_config("transducer", "model=2",
                                        "pg").to_json())
    params = params_from_jax(ranks["trees"]["transducer"])
    step = make_pg_step(cfg, AdamW(cfg, params,
                                   learning_rate=cfg.train.learning_rate * 0.1,
                                   weight_decay=1e-4))
    gen = torch.Generator().manual_seed(0)
    arrays = [torch.from_numpy(a) for a in _batch()]
    want = {"losses": [step(params, gen, *arrays)[0].item()
                       for _ in range(2)],
            "eval": None, "params": params, "ema": None}
    assert_matches(ranks["t2_pg_transducer"], want)
    assert moved(ranks["t2_pg_transducer"],
                 ranks["trees"]["transducer"]) > 100 * 1e-5


# --------------------------------------------------------------- the CLI

def _tiny_transformer(corpus: str, model: str) -> None:
    """One epoch of a tiny transformer-CTC (dropout 0, tests/
    test_multihost.py's features): a CLI run on this directory resumes it,
    its model from config.json."""
    train(corpus, model, device="cpu", config=Config(
        features=FeatureConfig(kind="logmel", n_mels=16, n_fft=128,
                               win_length=128, hop_length=64),
        model=ModelConfig(family="transformer", vocab_size=8, input_dim=16,
                          dropout=0.0),
        transformer=TransformerConfig(num_layers=1, d_model=16, num_heads=2,
                                      ffn_dim=32, dropout=0.0),
        train=TrainConfig(num_epochs=1, batch_size=8, learning_rate=1e-3,
                          warmup_steps=0, log_every=1000)))


def test_cli_mesh_model2_matches_one_process(equal_corpus, tmp_path):  # noqa: F811
    corpus, _ = equal_corpus
    tiny = str(tmp_path / "tiny")
    _tiny_transformer(corpus, tiny)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    shutil.copytree(tiny, one)
    shutil.copytree(tiny, two)
    argv = ["--mode", "train", "--corpus_path", corpus, "--batch_size", "8",
            "--device", "cpu"]
    assert cli.main(argv + ["--model_path", one, "--num_epochs", "3"]) == 0
    p = _start([sys.executable, "-m", "pg_asr_tpu_torch", *argv,
                "--model_path", two, "--num_epochs", "2", "--mesh",
                "model=2"])
    (out,) = _wait([p])
    assert p.returncode == 0, out
    assert out.count("torch.distributed initialized (process") == 2
    assert out.count("[train] epoch 2/2") == 1  # rank 0 prints
    # the checkpoint holds the one-device shapes (and qkv in its canonical
    # order: a run without a mesh goes on from it as the one process)
    last = load_checkpoint(os.path.join(two, "model_last.pt"))
    ref = load_checkpoint(os.path.join(one, "model_last.pt"))
    shapes = {k: v.shape for k, v in ref["params"].items()}
    assert {k: v.shape for k, v in last["params"].items()} == shapes
    assert {k: v.shape for k, v in last["opt_state"]["mu"].items()} == shapes
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", two, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(two, "predicted.txt"))
    # resumed without a mesh, the run goes on as the one-process run
    assert cli.main(argv + ["--model_path", two, "--num_epochs", "3"]) == 0
    np.testing.assert_allclose(np.load(os.path.join(two, "train_loss.npy")),
                               np.load(os.path.join(one, "train_loss.npy")),
                               rtol=1e-4)
    got = load_checkpoint(os.path.join(two, "model_last.pt"))["params"]
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
