"""The seq mesh axis of the port (sequence parallelism:
pg_asr_tpu_torch/parallel/sequence.py, the plan of parallel/driver.py, the
seq group's gathers and reduce-scatters of parallel/mesh.py, the steps of
train.py) vs the JAX package (pg_asr_tpu/parallel/sequence.py,
parallel/driver.py's ``ParallelPlan``, models/transformer_ctc.py's
``frontend(pad_to_multiple=)``).

Without processes: the frontend's padding of T' to a multiple equals the
JAX frontend's (and leaves the default path as it was), and the plan
refuses what the JAX ``ParallelPlan`` refuses under ``seq``, with its
message. Then, in four gloo rank processes (tests/test_torch_mesh_ranks.py)
on tests/test_pipeline.py's 4-layer tiny transformer and a ragged batch of
5 rows whose T' (38) the seq axis pads: ``seq=4`` (T' to 40) and
``data=2,seq=2`` against the JAX package's steps on the same mesh of
forced host devices at tests/test_torch_mesh.py's tolerances with the clip
engaged (a gradient of the gathered keys counted on one rank only, not
reduce-scattered, would move every parameter off by far more), the ranks
bit-equal; and one epoch of train() with dropout under ``seq=2`` and under
``pipe=2``, whose checkpoints hold the one-device tree, which one-device
predict serves and a run without a mesh resumes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_asr_tpu.models import transformer_ctc as jax_tc
from pg_asr_tpu.ops.features import extract_features as jax_features
from pg_asr_tpu.parallel import driver as jax_driver
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import load_checkpoint
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import make_synthetic_corpus
from pg_asr_tpu_torch.models import transformer_ctc
from pg_asr_tpu_torch.ops.features import extract_features
from pg_asr_tpu_torch.parallel import driver
from tests.test_torch_mesh import _batch
from tests.test_torch_mesh_ranks import (assert_matches, jax_cases, jax_tree,
                                         mesh_devices, moved, run_ranks)
from tests.test_torch_pipeline import tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("multiple", [1, 3, 4])
def test_frontend_pad_to_multiple_matches_jax(multiple):
    """T' = 38 frames (the batch's longest row) zero-padded up to a
    multiple: the same x, mask and lengths as the JAX frontend; at 1 the
    port's default path."""
    jcfg = tiny()
    tree = jax_tree(jcfg)
    wave, ns, _, _ = _batch()
    j_feats, j_mask, j_lens = jax_features(jnp.asarray(wave), jnp.asarray(ns),
                                           jcfg.features)
    want = jax_tc.frontend(tree, j_feats, j_mask, j_lens, jcfg.model,
                           jcfg.transformer, pad_to_multiple=multiple)
    cfg = Config.from_json(jcfg.to_json())
    feats, mask, lens = extract_features(torch.from_numpy(wave),
                                         torch.from_numpy(ns), cfg.features)
    params = params_from_jax(tree)
    got = transformer_ctc.frontend(params, feats, mask, lens, cfg.model,
                                   cfg.transformer, pad_to_multiple=multiple)
    assert got[0].shape[1] == -(-38 // multiple) * multiple
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if multiple == 1:
        plain = transformer_ctc.frontend(params, feats, mask, lens,
                                         cfg.model, cfg.transformer)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


PLAN_CASES = [
    ("seq=2", {}), ("seq=4", {}), ("data=2,seq=2", {}),
    ("seq=2", dict(family="ctc")), ("seq=2", dict(family="moe")),
    ("seq=2,model=2", {}), ("seq=2,fsdp=2", {}),
]


@pytest.mark.parametrize("spec,kw", PLAN_CASES)
def test_plan_matches_jax(spec, kw):
    """The port's plan refuses what JAX's ParallelPlan refuses under seq,
    with its message, and otherwise takes its strategy and batch multiple;
    no leaf is split or staged."""
    jcfg = tiny(**kw)
    m, _ = mesh_devices(spec)
    cfg = Config.from_json(jcfg.to_json())
    shape, axes = driver.parse_mesh_spec(spec)
    try:
        want = jax_driver.ParallelPlan(jcfg, m)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            driver.ParallelPlan(cfg, shape, axes)
        assert str(got.value) == str(e)
        return
    plan = driver.ParallelPlan(cfg, shape, axes)
    assert (plan.strategy, plan.batch_multiple) == (want.strategy,
                                                    want.batch_multiple)
    for k, v in params_from_jax(jax_tree(jcfg)).items():
        assert plan.splits(k, tuple(v.shape)) == () and plan.stage(k) is None


# name -> (mesh, kind); "train" also holds the eval step
STEP_CASES = {"s4": ("seq=4", "train"), "d2s2": ("data=2,seq=2", "steps")}
RUN_CASES = {"s2_run": "seq=2", "p2_run": "pipe=2"}


def _run_config(spec: str) -> str:
    """One epoch of the tiny transformer with dropout 0.1 on mesh `spec`,
    batches of 4, the clip at 1."""
    jcfg = tiny(spec)
    cfg = Config.from_json(jcfg.to_json())
    return cfg.replace(
        transformer=cfg.transformer.__class__(
            **{**cfg.transformer.__dict__, "dropout": 0.1}),
        train=cfg.train.__class__(**{**cfg.train.__dict__,
                                     "num_epochs": 1, "batch_size": 4,
                                     "learning_rate": 1e-3,
                                     "grad_clip": 1.0})).to_json()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case through the four processes: {case: [rank results]},
    "tree" the weights, "meanwhile" the JAX steps on the same meshes,
    "corpus" and "dirs" the runs' corpus and model directories."""
    d = str(tmp_path_factory.mktemp("seq_ranks"))
    corpus, _ = make_synthetic_corpus(os.path.join(d, "corpus"), n_utts=12,
                                      seed=3, min_dur=0.2, max_dur=0.4)
    tree = jax_tree(tiny())
    cases, refs = {}, {}
    for name, (spec, kind) in STEP_CASES.items():
        jcfg = tiny(spec)
        cases[name] = (jcfg.to_json(), kind, 2, tree, _batch())
        refs[name] = (jcfg, kind, 2, tree, _batch())
    dirs = {name: os.path.join(d, name) for name in RUN_CASES}
    for name, spec in RUN_CASES.items():
        cases[name] = (_run_config(spec), "run", 0, (corpus, dirs[name]),
                       None)
    out = run_ranks(d, cases, [
        ([0, 1, 2, 3], ["s4", "d2s2"]),
        ([0, 1], ["s2_run"]),
        ([2, 3], ["p2_run"]),
    ], meanwhile=lambda: jax_cases(refs))
    out.update(tree=tree, corpus=corpus, dirs=dirs)
    return out


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_jax(ranks, case):
    got = ranks[case]
    assert len(got) == 4
    assert_matches(got, ranks["meanwhile"][case])
    assert moved(got, ranks["tree"]) > 100 * 1e-5
    # every rank holds every leaf whole
    full = params_from_jax(ranks["tree"])
    for r in got:
        assert {k: tuple(s) for k, s in r["shapes"].items()} == {
            k: tuple(v.shape) for k, v in full.items()}
        assert r["resident"] == sum(v.numel() * 4 for v in full.values()) * 3


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_checkpoint_is_canonical(ranks, case):
    """The run's checkpoint holds every block in the one-device shapes (and
    AdamW's moments too); one-device predict serves it and a run without
    a mesh resumes it."""
    corpus, model = ranks["corpus"], ranks["dirs"][case]
    # the weights' shapes but the head's, which fits the corpus's alphabet
    shapes = {k: tuple(v.shape) for k, v in params_from_jax(
        ranks["tree"]).items() if not k.startswith("ctc_head")}
    state = load_checkpoint(os.path.join(model, "model_last.pt"))
    for tree in (state["params"], state["opt_state"]["mu"]):
        assert set(tree) == set(shapes) | {"ctc_head.w", "ctc_head.b"}
        assert {k: tuple(tree[k].shape) for k in shapes} == shapes
    assert all(torch.isfinite(v).all() for v in state["params"].values())
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", model, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(model, "predicted.txt"))
    assert cli.main(["--mode", "train", "--corpus_path", corpus,
                     "--model_path", model, "--num_epochs", "2",
                     "--device", "cpu"]) == 0
    losses = np.load(os.path.join(model, "train_loss.npy"))
    assert len(losses) == 2 and np.isfinite(losses).all()
