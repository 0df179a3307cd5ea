"""The fsdp mesh axis of the port (pg_asr_tpu_torch/parallel/fsdp.py, the
plan of parallel/driver.py, the ranks of parallel/mesh.py, the steps of
train.py and rl/reinforce.py) vs the JAX package's (pg_asr_tpu/parallel/
fsdp.py, driver.ParallelPlan and its GSPMD steps on a mesh of the forced
host devices).

The placement first: ``fsdp_leaf_spec`` and ``shardable_fraction`` equal
JAX's on tests/test_fsdp.py's shapes and on any shape, each rank's shard is
the slice of the JAX ``NamedSharding`` that its mesh position holds, and
the plan refuses what JAX's refuses, with its message. Then the steps, in
four gloo rank processes (tests/test_torch_mesh_ranks.py): the
BiLSTM-CTC's train and eval steps under ``data=2,fsdp=2`` and under
``fsdp=2`` with ``accum_steps=2`` and the EMA (2 updates of 2
micro-steps), and the MWER policy-gradient step under ``fsdp=2``, each
against JAX's steps on the same mesh, arrays and weights, at
tests/test_torch_mesh.py's tolerances, with the clip
engaged (dropout 0: the JAX step draws one global mask, the port's ranks
their own); the transducer, the seq2seq and the conformer-CTC under
``fsdp=2`` against the port's one-process steps. A rank holds its share of
the parameters and AdamW moments.
Last, a checkpoint written by a ``fsdp=2`` train() holds the full shapes,
one-device predict serves it, and a run resumes it without a mesh, as the
one-process run goes.
"""

import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ConformerConfig as JConformerConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransducerConfig as JTransducerConfig
from pg_asr_tpu.config import TransformerConfig as JTransformerConfig
from pg_asr_tpu import train as jax_train
from pg_asr_tpu.parallel import driver as jax_driver
from pg_asr_tpu.parallel import fsdp as jax_fsdp
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import Config, TrainConfig
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.parallel import driver, fsdp
from pg_asr_tpu_torch.train import (AdamW, init_model_params,
                                    make_train_step, train)
from tests.test_torch_mesh import _batch, equal_corpus  # noqa: F401
from tests.test_torch_mesh_ranks import (CLIP, assert_matches,
                                         jax_cases, jax_names, jax_tree,
                                         mesh_devices, mesh_of, moved,
                                         run_ranks)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ placement

# tests/test_fsdp.py's shapes
LEAF_CASES = [((64, 128), 4), ((128, 64), 4), ((64, 64), 4), ((3, 5), 4),
              ((), 4), ((1,), 4), ((64,), 1)]


@pytest.mark.parametrize("shape,n", LEAF_CASES)
def test_fsdp_leaf_spec_matches_jax(shape, n):
    assert fsdp.fsdp_leaf_spec(shape, n) == tuple(
        jax_fsdp.fsdp_leaf_spec(shape, n))


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(1, 12), max_size=4), st.integers(1, 6))
def test_fsdp_leaf_spec_matches_jax_on_any_shape(dims, n):
    shape = tuple(dims)
    assert fsdp.fsdp_leaf_spec(shape, n) == tuple(
        jax_fsdp.fsdp_leaf_spec(shape, n))
    leaves = {"a": np.zeros(shape), "b": np.zeros((3,))}
    assert fsdp.shardable_fraction(
        {k: torch.from_numpy(v) for k, v in leaves.items()}, n) == \
        jax_fsdp.shardable_fraction(leaves, n)


def _ctc(**train) -> JConfig:
    """The tiny BiLSTM-CTC (vocab 7: the head's bias has no divisible
    dimension, so one leaf stays whole under fsdp=2)."""
    return JConfig(
        model=JModelConfig(vocab_size=7, input_proj_dim=32, hidden_size=16,
                           num_layers=1, dropout=0.0, use_pallas_lstm=False),
        train=JTrainConfig(batch_size=5, warmup_steps=0, learning_rate=0.05,
                           grad_clip=CLIP, **train))


def _transformer(**train) -> JConfig:
    return JConfig(
        model=JModelConfig(family="transformer", vocab_size=8, input_dim=80),
        transformer=JTransformerConfig(num_layers=2, d_model=32, num_heads=2,
                                       ffn_dim=64, dropout=0.0),
        train=JTrainConfig(**train))


@pytest.mark.parametrize("n", [2, 4, 5])
@pytest.mark.parametrize("family", ["ctc", "transformer"])
def test_shardable_fraction_of_models_matches_jax(family, n):
    jcfg = _ctc() if family == "ctc" else _transformer()
    tree = jax.eval_shape(lambda: jax_train.init_model_params(
        jax.random.PRNGKey(0), jcfg))  # shapes only, as the plan's probe
    port = {k: torch.empty(v.shape, device="meta")
            for k, v in jax_names(tree).items()}
    assert fsdp.shardable_fraction(port, n) == \
        jax_fsdp.shardable_fraction(tree, n)
    specs = jax_fsdp.param_specs(tree, n)
    want = [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]
    assert [fsdp.param_specs(port, n)[k] for k in jax_names(tree)] == want


PLAN_CASES = [
    ("fsdp=2", "ctc"), ("data=2,fsdp=2", "ctc"), ("fsdp=4", "transformer"),
    ("fsdp=5", "transformer"),  # no layer dim divisible by 5
    ("fsdp=7", "ctc"), ("seq=2,fsdp=2", "transformer"),
    ("fsdp=2,expert=2", "transformer"), ("model=2,fsdp=2", "transformer"),
    ("fsdp=2,data=2", "ctc"),
]


@pytest.mark.parametrize("spec,family", PLAN_CASES)
def test_plan_matches_jax(spec, family):
    """The port's plan refuses what JAX's ParallelPlan refuses, with its
    message, and otherwise takes the same batch multiple and coverage."""
    shape, axes = driver.parse_mesh_spec(spec)
    jcfg = _ctc() if family == "ctc" else _transformer()
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
    assert plan.fsdp_coverage == pytest.approx(want.fsdp_coverage, abs=0)


@pytest.mark.parametrize("spec", ["fsdp=2", "data=2,fsdp=2", "fsdp=2,data=2"])
def test_shards_are_the_jax_shards(spec):
    """Each rank's shard of every leaf is the slice of the JAX placement
    (``shard_params_fsdp``) that the device at its mesh position holds."""
    jcfg = _ctc()
    tree = jax_tree(jcfg)
    m, devices = mesh_devices(spec)
    cfg = Config.from_json(jcfg.to_json())
    plan = driver.ParallelPlan(cfg, *driver.parse_mesh_spec(spec))
    full = params_from_jax(tree)
    jax_leaves = jax_names(jax_fsdp.shard_params_fsdp(tree, m))
    assert set(jax_leaves) == set(full)
    for rank, device in enumerate(devices):
        mine = fsdp.shard_params_fsdp(full, plan.sizes["fsdp"],
                                      plan.coords(rank)["fsdp"])
        for k, v in mine.items():
            shard = next(s for s in jax_leaves[k].addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(v.numpy(), np.asarray(shard.data),
                                          err_msg=f"rank {rank} {k}")
            where = plan.placement(k, tuple(full[k].shape))
            assert (where is None) == (v.shape == full[k].shape)


# ------------------------------------------------ the steps on four ranks

def _step_cases() -> dict:
    """name -> (JAX config with its mesh, kind, steps)."""
    return {
        "d2f2_train": (_ctc(**mesh_of("data=2,fsdp=2")), "train", 2),
        "f2_accum_ema": (_ctc(accum_steps=2, ema_decay=0.9,
                              **mesh_of("fsdp=2")), "steps", 4),
        "f2_pg_mwer": (_ctc(**mesh_of("fsdp=2")).replace(rl=JRLConfig(
            objective="mwer", mwer_beam=3, space_id=1)), "pg", 2),
    }


def _family_cases() -> dict:
    """The other families under fsdp=2 (held against the port's own
    one-process steps: the fsdp machinery is the same for every family,
    the JAX comparison is the BiLSTM-CTC's above)."""
    train = JTrainConfig(batch_size=5, warmup_steps=0, learning_rate=0.05,
                         grad_clip=CLIP, **mesh_of("fsdp=2"))
    lstm = dict(vocab_size=8, input_proj_dim=16, hidden_size=8,
                num_layers=1, dropout=0.0, use_pallas_lstm=False)
    return {
        "f2_transducer": JConfig(
            model=JModelConfig(family="transducer", **lstm),
            transducer=JTransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                         pred_hidden=8, joint_dim=16,
                                         ctc_weight=0.3), train=train),
        "f2_seq2seq": JConfig(
            model=JModelConfig(family="seq2seq", **lstm),
            seq2seq=JSeq2SeqConfig(vocab_size=8, embed_dim=8, dec_hidden=16),
            train=train),
        "f2_conformer": JConfig(
            model=JModelConfig(family="conformer", vocab_size=8,
                               input_dim=80),
            conformer=JConformerConfig(num_layers=1, d_model=32, num_heads=2,
                                       ffn_dim=64, conv_kernel=5,
                                       dropout=0.0), train=train),
    }


def _run_config(epochs: int, spec: str | None) -> Config:
    """tests/test_torch_mesh.py's tiny model's training settings."""
    return Config(train=TrainConfig(
        num_epochs=epochs, batch_size=8, learning_rate=1e-3, warmup_steps=0,
        log_every=1000, **(mesh_of(spec) if spec else {})))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, equal_corpus):  # noqa: F811
    """Every case through the four processes: {case: [rank results]}; the
    2-rank train() run leaves its model directory in "f2_run"."""
    d = str(tmp_path_factory.mktemp("fsdp_ranks"))
    corpus, tiny = equal_corpus
    run_dir = os.path.join(d, "f2_run")
    shutil.copytree(tiny, run_dir)
    steps = {name: (jcfg, kind, n, jax_tree(jcfg), _batch(V=7))
             for name, (jcfg, kind, n) in _step_cases().items()}
    cases = {name: (c[0].to_json(), *c[1:]) for name, c in steps.items()}
    cases["f2_run"] = (_run_config(2, "fsdp=2").to_json(), "run", 0,
                       (corpus, run_dir), None)
    families = {name: (jcfg, params_to_jax(init_model_params(
        Config.from_json(jcfg.to_json()), torch.Generator().manual_seed(0),
        "cpu"))) for name, jcfg in _family_cases().items()}
    cases.update({name: (jcfg.to_json(), "steps", 2, tree, _batch())
                  for name, (jcfg, tree) in families.items()})
    out = run_ranks(d, cases, [
        ([0, 1, 2, 3], ["d2f2_train"]),
        ([0, 1], ["f2_accum_ema", *families]),
        ([2, 3], ["f2_pg_mwer", "f2_run"]),
    ], meanwhile=lambda: jax_cases(steps))
    out["f2_run"] = run_dir
    out["trees"] = {name: c[3] for name, c in steps.items()}
    out["trees"].update({name: tree for name, (_, tree) in families.items()})
    return out


@pytest.mark.parametrize("case", list(_family_cases()))
def test_every_family_steps_match_one_process(ranks, case):
    """The transducer, the seq2seq and the conformer-CTC under fsdp=2: 2
    train steps of two ranks, their rows each, against the port's
    one-process steps on the whole batch (losses and gathered parameters
    at tests/test_torch_mesh.py's tolerances, the clip engaged)."""
    cfg = Config.from_json(_family_cases()[case].to_json())
    params = params_from_jax(ranks["trees"][case])
    step = make_train_step(cfg, AdamW(cfg, params))
    gen = torch.Generator().manual_seed(0)
    arrays = [torch.from_numpy(a) for a in _batch()]
    want = {"losses": [step(params, gen, *arrays).item() for _ in range(2)],
            "eval": None, "params": params, "ema": None}
    got = ranks[case]
    assert len(got) == 2
    assert_matches(got, want)
    assert moved(got, ranks["trees"][case]) > 100 * 1e-5


@pytest.mark.parametrize("case", list(_step_cases()))
def test_steps_match_jax(ranks, case):
    jcfg = _step_cases()[case][0]
    want, got = ranks["meanwhile"][case], ranks[case]
    assert len(got) == math.prod(jcfg.train.mesh_shape)
    assert_matches(got, want)
    # the steps move the parameters far past the tolerance
    assert moved(got, ranks["trees"][case]) > 100 * 1e-5


def test_resident_state_is_sharded(ranks):
    """An fsdp=2 rank holds cov/2 + (1 - cov) of the replicated bytes of
    parameters and AdamW moments (cov: the shardable fraction), and each
    sharded leaf half of its largest divisible dimension."""
    jcfg = _step_cases()["f2_accum_ema"][0]
    full = params_from_jax(ranks["trees"]["f2_accum_ema"])
    cov = fsdp.shardable_fraction(full, 2)
    assert 0.5 < cov < 1.0
    replicated = 3 * sum(v.numel() * v.element_size() for v in full.values())
    for r in ranks["f2_accum_ema"]:
        assert r["resident"] <= (cov / 2 + (1 - cov)) * replicated * 1.05
        for k, v in full.items():
            dim = fsdp.fsdp_leaf_dim(tuple(v.shape), 2)
            want = list(v.shape)
            if dim is not None:
                want[dim] //= 2
            assert tuple(r["shapes"][k]) == tuple(want), k
    assert jcfg.train.mesh_axes == ("fsdp",)


def test_checkpoint_is_full_shape_served_and_resumed(ranks, equal_corpus,  # noqa: F811
                                                     tmp_path):
    """The fsdp=2 run's checkpoint (its parameters, AdamW moments and the
    rest in the one-device shapes) is served by one-device predict and
    resumed without a mesh; its losses are the one-process run's."""
    corpus, tiny = equal_corpus
    two = ranks["f2_run"]
    one = str(tmp_path / "one")
    shutil.copytree(tiny, one)
    train(corpus, one, config=_run_config(3, None), device="cpu")
    last = load_checkpoint(os.path.join(two, "model_last.pt"))
    ref = load_checkpoint(os.path.join(one, "model_last.pt"))
    for tree in ("params",):
        assert {k: v.shape for k, v in last[tree].items()} == {
            k: v.shape for k, v in ref[tree].items()}
    for moment in ("mu", "nu"):
        assert {k: v.shape for k, v in last["opt_state"][moment].items()} \
            == {k: v.shape for k, v in ref["params"].items()}
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", two, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(two, "predicted.txt"))
    train(corpus, two, config=_run_config(3, None), device="cpu")
    np.testing.assert_allclose(np.load(os.path.join(two, "train_loss.npy")),
                               np.load(os.path.join(one, "train_loss.npy")),
                               rtol=1e-4)
