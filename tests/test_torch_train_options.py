"""The supervised training recipe's options in the port (gradient
accumulation, EMA, rolling checkpoints and ``--ckpt avg``, mid-epoch save
and SIGTERM resume, ``--val_metric cer``, ``--init_from_torch``,
``--profile_steps``, the threaded and cached loader with the native WAV
decoder) against the JAX package on the same arrays, and the port's CLI
end to end on the CPU.

Tolerances: the accumulated AdamW step float32 rel 1e-6 (the same
operations; the global norm's float32 sum in another order), bfloat16 and
the EMA update bit for bit (every operation rounds where JAX rounds);
checkpoint averages, imported weights, batches and resumed runs bit for
bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pg_asr_tpu import checkpoint as jax_ckpt
from pg_asr_tpu import train as jax_train
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import TrainConfig as JTrainConfig
from pg_asr_tpu.config import TransducerConfig as JTransducerConfig
from pg_asr_tpu.models import torch_import as jax_import
from pg_asr_tpu_torch import cli, train
from pg_asr_tpu_torch.checkpoint import (average_checkpoints, load_checkpoint,
                                         save_checkpoint)
from pg_asr_tpu_torch.config import Config, SpecAugmentConfig
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import (Alphabet, BatchIterator, load_manifest,
                                   make_synthetic_corpus)
from pg_asr_tpu_torch.data import audio, native_io
from pg_asr_tpu_torch.models import torch_import
from pg_asr_tpu_torch.predict import load_model
from pg_asr_tpu_torch.rl import reinforce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (bit-equal runs; before the module's other
    fixtures), restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg: JConfig) -> Config:
    return Config.from_json(jcfg.to_json())


# ------------------------------------------------- accumulation, EMA, avg

def _tree(dtype, seed):
    rng = np.random.default_rng(seed)
    return {"a": jnp.asarray(rng.standard_normal((4, 3)), dtype),
            "blocks": [{"w": jnp.asarray(rng.standard_normal((5,)), dtype)}
                       for _ in range(11)]}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accum_steps_matches_optax_multisteps(dtype, k):
    """--accum_steps k over 2k micro-batches (the 2nd clipped: global norm
    above grad_clip) against optax.MultiSteps as the JAX package builds it:
    params, both moments, the count, the accumulator and the micro-step
    after every call."""
    jcfg = JConfig(train=JTrainConfig(learning_rate=1e-2, warmup_steps=2,
                                      grad_clip=1.0, weight_decay=0.1,
                                      accum_steps=k))
    params = _tree(dtype, 0)
    scales = (0.05, 3.0, 0.02, 0.04, 0.03, 0.5)[: 2 * k]
    grads = [jax.tree_util.tree_map(lambda x: x * s, _tree(dtype, i + 1))
             for i, s in enumerate(scales)]
    opt = jax_train.make_optimizer(jcfg)
    state = opt.init(params)
    t_params = params_from_jax(params)
    t_opt = train.AdamW(_port_cfg(jcfg), t_params)
    for g in grads:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        t_opt.update(t_params, params_from_jax(g))
        adam = state.inner_opt_state[1][0]
        assert t_opt.mini_step == int(state.mini_step)
        assert t_opt.count == int(adam.count)
        for got, ref in ((t_params, params), (t_opt.mu, adam.mu),
                         (t_opt.nu, adam.nu), (t_opt.acc, state.acc_grads)):
            ref = params_from_jax(ref)
            for k, v in got.items():
                assert v.dtype == ref[k].dtype, k
                if dtype == "bfloat16":
                    assert torch.equal(v, ref[k]), k
                else:
                    torch.testing.assert_close(v, ref[k], rtol=1e-6,
                                               atol=1e-7)
    assert t_opt.count == 2
    state_dict = t_opt.state_dict()
    assert state_dict["mini_step"] == 0 and set(state_dict["acc_grads"]) == \
        set(t_params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ema_update_is_bit_equal_to_jax(dtype):
    """Three updates at decay 0.999 and 0.9, a float32 leaf in a bf16 tree
    as the attention families' LayerNorm."""
    ema, params = _tree(dtype, 0), _tree(dtype, 1)
    ema["ln"] = params["ln"] = jnp.asarray(np.arange(5.0), jnp.float32)
    t_ema = params_from_jax(ema)
    for decay in (0.999, 0.9, 0.999):
        params = jax.tree_util.tree_map(lambda x: x * 1.5, params)
        ema = jax_train._ema_update(ema, params, decay)
        train._ema_update(t_ema, params_from_jax(params), decay)
        want = params_from_jax(ema)
        assert all(torch.equal(t_ema[k], want[k]) for k in want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_average_checkpoints_matches_jax(tmp_path, dtype):
    """Three checkpoints' float leaves averaged in float64 and cast back;
    an int leaf is the last checkpoint's. The JAX package's function takes
    bfloat16 leaves for non-float ones (``np.issubdtype(bfloat16,
    np.floating)`` is False for ml_dtypes' type) and returns the last
    checkpoint's; the port averages them (ROADMAP.md, the reference's
    differences)."""
    j_paths, t_paths, trees = [], [], []
    for i in range(3):
        trees.append({**_tree(dtype, i), "n": jnp.asarray([i, 7], jnp.int32)})
        j_paths.append(str(tmp_path / f"j{i}.ckpt"))
        jax_ckpt.save_checkpoint(j_paths[-1], {"params": trees[-1],
                                               "step": i})
        t_paths.append(str(tmp_path / f"t{i}.pt"))
        save_checkpoint(t_paths[-1], {"params": params_from_jax(trees[-1]),
                                      "step": i})
    want = params_from_jax(jax_ckpt.average_checkpoints(
        j_paths, {"params": trees[-1]})["params"])
    got = average_checkpoints(t_paths)
    assert set(got) == set(want)
    assert all(got[k].dtype == want[k].dtype for k in want)
    assert got["n"].tolist() == want["n"].tolist() == [2, 7]
    if dtype == "bfloat16":
        last = params_from_jax(trees[-1])
        assert all(torch.equal(want[k], last[k]) for k in want)
        trees = [params_from_jax(t) for t in trees]
        want = {k: (sum(t[k].double() for t in trees) / 3.0).to(
            torch.bfloat16) for k in want if k != "n"}
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(KeyError):
        average_checkpoints(t_paths, "ema_params")


# ------------------------------------------------------- init_from_torch

def _reference_checkpoint(path, F, P, H, layers, seed=0):
    """A synthetic reference model_best.pth: nn.DataParallel's `module.`
    prefix, the encoder's Linear and BiLSTM, a decoder tensor."""
    g = torch.Generator().manual_seed(seed)
    sd = {"module.encoder.input_layer.weight": torch.randn(P, F, generator=g),
          "module.encoder.input_layer.bias": torch.randn(P, generator=g),
          "module.decoder.embed_layer.weight": torch.randn(7, 4, generator=g)}
    for k in range(layers):
        for sfx in (f"_l{k}", f"_l{k}_reverse"):
            n_in = P if k == 0 else 2 * H
            for name, shape in (("weight_ih", (4 * H, n_in)),
                                ("weight_hh", (4 * H, H)),
                                ("bias_ih", (4 * H,)), ("bias_hh", (4 * H,))):
                sd[f"module.encoder.blstm.{name}{sfx}"] = torch.randn(
                    *shape, generator=g)
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("family", ["ctc", "transducer"])
def test_init_from_torch_matches_jax(tmp_path, family):
    jcfg = JConfig(model=JModelConfig(family=family, vocab_size=7,
                                      input_dim=80, input_proj_dim=12,
                                      hidden_size=6, num_layers=2),
                   transducer=JTransducerConfig(encoder="bilstm",
                                                pred_embed_dim=4,
                                                pred_hidden=6, joint_dim=5))
    path = str(tmp_path / "model_best.pth")
    _reference_checkpoint(path, 80, 12, 6, 2)
    tree = jax_train.init_model_params(jax.random.PRNGKey(0), jcfg)
    want, want_report = jax_import.init_from_torch_checkpoint(path, tree,
                                                              jcfg)
    got, report = torch_import.init_from_torch_checkpoint(
        path, params_from_jax(tree), _port_cfg(jcfg))
    want = params_from_jax(want)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert report.split(";")[0] == want_report.split(";")[0]
    assert "unused torch keys: decoder.embed_layer.weight" in report
    if family == "ctc":
        assert "fresh (no torch source): ctc_head" in report


def test_init_from_torch_refusals(tmp_path):
    cfg = _port_cfg(JConfig(model=JModelConfig(
        vocab_size=7, input_dim=80, input_proj_dim=12, hidden_size=6,
        num_layers=2)))
    params = train.init_model_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    path = str(tmp_path / "m.pth")
    _reference_checkpoint(path, 120, 12, 6, 2)  # the reference's MFCC input
    with pytest.raises(ValueError, match="--features mfcc"):
        torch_import.init_from_torch_checkpoint(path, params, cfg)
    pickled = str(tmp_path / "module.pth")
    torch.save(torch.nn.Linear(2, 2), pickled)
    with pytest.raises(ValueError, match="trust_torch_pickle"):
        torch_import.load_torch_state_dict(pickled)
    assert set(torch_import.load_torch_state_dict(
        pickled, allow_pickle=True)) == {"weight", "bias"}
    conformer = cfg.replace(model=dataclasses.replace(cfg.model,
                                                      family="conformer"))
    with pytest.raises(ValueError, match="no reference torch counterpart"):
        torch_import.init_from_torch_checkpoint(path, params, conformer)


# -------------------------------------------------------------- loader

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("options_corpus")
    path, _ = make_synthetic_corpus(str(d / "corpus"), n_utts=12, seed=0,
                                    min_dur=0.2, max_dur=0.4)
    # one clip at 8 kHz: the loaders' resample path
    clip = os.path.join(path, "clips", "utt0001.wav")
    x, _ = audio.read_wav(clip)
    audio.write_wav(clip, x[::2], 8000)
    return path


def _epochs(corpus, n=2, **kw):
    it = BatchIterator(load_manifest(os.path.join(corpus, "train.tsv"),
                                     os.path.join(corpus, "clips")),
                       Alphabet.load(os.path.join(corpus, "alphabet.txt")),
                       2, seed=3, **kw)
    return [[(b.wave.copy(), b.num_samples, b.labels, b.label_lens)
             for b in it] for _ in range(n)], it


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for ea, eb in zip(a, b) for ba, bb in zip(ea, eb)
               for x, y in zip(ba, bb)) and len(a) == len(b)


@pytest.mark.parametrize("workers,cache_mb", [(2, 0.0), (0, 64.0),
                                              (3, 64.0), (2, 0.2)])
def test_threads_and_cache_give_the_same_batches(corpus, workers, cache_mb):
    """Decode threads and the built-batch cache (whole, and capped below
    the corpus) change no batch of two epochs, nor a resume's skips."""
    want, _ = _epochs(corpus, decoder="python")
    got, it = _epochs(corpus, num_workers=workers, cache_mb=cache_mb)
    assert _same(got, want)
    decoded = it.decoded["native"] + it.decoded["python"]
    assert (decoded == 10) == (cache_mb == 0) and decoded >= 5
    assert it.decoded["python"] == 0  # the native decoder built them
    _, ref = _epochs(corpus, n=0)
    full = [b.texts for e in range(2) for b in ref]
    _, it = _epochs(corpus, n=0, num_workers=workers, cache_mb=cache_mb)
    it.skip_epochs(1)
    it.skip_batches(2)
    assert [b.texts for b in it] == full[5 + 2:]


def test_native_decoder_gives_the_python_samples(corpus):
    assert native_io.native_available()
    lib = native_io.library_path()
    assert lib.startswith(os.path.join(os.path.dirname(train.__file__),
                                       "_build"))
    # the port's own build, not the JAX package's native/libpgasr_io.so
    # (which a JAX test in this process may have loaded)
    assert native_io._load()._name == lib
    clips = sorted(os.path.join(corpus, "clips", n)
                   for n in os.listdir(os.path.join(corpus, "clips")))
    for clip in clips[:3]:
        x, sr = audio.read_wav(clip)
        y, sr2 = native_io.read_wav(clip)
        assert sr == sr2 and np.array_equal(x, y)
        assert native_io.wav_info(clip) == (sr, len(x))
    rows, lens, rates = native_io.load_batch([clips[0], clips[2]], 9000)
    for row, n, clip in zip(rows, lens, [clips[0], clips[2]]):
        x, sr = audio.read_wav(clip)
        assert n == len(x) and np.array_equal(row[:n], x)
        assert not row[n:].any()
    x, sr = audio.read_wav(clips[1])
    assert sr == 8000
    n_out = int(len(x) * 16000 / sr + 0.5)
    np.testing.assert_allclose(
        native_io.resample(x, n_out),
        np.interp(np.linspace(0.0, len(x) - 1.0, n_out), np.arange(len(x)),
                  x), rtol=0, atol=1e-6)
    native, _ = _epochs(corpus, n=1, decoder="native")
    python, _ = _epochs(corpus, n=1, decoder="python")
    assert _same(native, python)


# --------------------------------------------------------------- train()

def _tiny(**train_kw) -> Config:
    cfg = _port_cfg(JConfig(model=JModelConfig(
        input_proj_dim=16, hidden_size=8, num_layers=1, dropout=0.2)))
    kw = dict(batch_size=2, num_epochs=2, warmup_steps=2, learning_rate=3e-3,
              accum_steps=2, ema_decay=0.9, loader_threads=2,
              cache_audio_mb=16)
    return cfg.replace(
        augment=SpecAugmentConfig(enabled=True, time_width=4, freq_width=4,
                                  speed_min=0.9, speed_max=1.1,
                                  noise_std=0.1, gain_db=3.0),
        train=dataclasses.replace(cfg.train, **{**kw, **train_kw}))


class _PreemptAt:
    """A preemption seen from the n-th per-step poll on."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def is_set(self):
        self.calls += 1
        return self.calls >= self.n


def _final(model):
    return load_checkpoint(os.path.join(model, "model_last.pt"))


def _assert_same_state(a, b):
    for key in ("params", "ema_params"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    for key in ("mu", "nu", "acc_grads"):
        assert all(torch.equal(a["opt_state"][key][k], b["opt_state"][key][k])
                   for k in a["opt_state"][key]), key
    assert a["step"] == b["step"] and torch.equal(a["rng_state"],
                                                  b["rng_state"])


@pytest.fixture(scope="module")
def uninterrupted(corpus, tmp_path_factory):
    """2 epochs of 5 micro-batches (accumulation 2, EMA, every
    augmentation, dropout, 2 decode threads and the cache)."""
    model = str(tmp_path_factory.mktemp("full") / "model")
    out = train.train(corpus, model, config=_tiny(save_every_steps=2),
                      device="cpu")
    return model, out


@pytest.mark.parametrize("how", ["sigterm", "save_every_steps",
                                 "sigterm_at_epoch_end"])
def test_resume_equals_an_uninterrupted_run(corpus, uninterrupted, tmp_path,
                                            monkeypatch, capsys, how):
    """A SIGTERM mid-epoch (model_last at batch 3 of epoch 1, a clean
    return), a crash after a --save_every_steps save (epoch 2, batch 2,
    mid-accumulation), and
    a SIGTERM at an epoch's last batch (batches_done == its length: the
    resume starts the next epoch): each resumed run ends with the
    uninterrupted run's params, EMA, optimizer state and step, bit for
    bit, and its loss curve goes on from the saved one."""
    full, full_out = uninterrupted
    model = str(tmp_path / "model")
    cfg = _tiny(save_every_steps=2)
    if how == "save_every_steps":
        step = train.make_train_step

        def crash_at_8(cfg, optimizer):
            inner, calls = step(cfg, optimizer), []

            def run(*args):
                calls.append(1)
                if len(calls) == 8:
                    raise RuntimeError("killed")
                return inner(*args)
            return run

        monkeypatch.setattr(train, "make_train_step", crash_at_8)
        with pytest.raises(RuntimeError, match="killed"):
            train.train(corpus, model, config=cfg, device="cpu")
        want_done, want_epoch = 2, 2
    else:
        at = 3 if how == "sigterm" else 5
        monkeypatch.setattr(train, "install_preemption_handler",
                            lambda: (_PreemptAt(at), lambda: None))
        out = train.train(corpus, model, config=cfg, device="cpu")
        assert out["interrupted"] and out["steps"] == at
        assert (f"SIGTERM: saved model_last at epoch 1 batch {at}"
                in capsys.readouterr().out)
        want_done, want_epoch = at, 1
    saved = _final(model)
    assert (saved["epoch"], saved["batches_done"]) == (want_epoch, want_done)
    monkeypatch.undo()
    out = train.train(corpus, model, config=cfg, device="cpu")
    said = capsys.readouterr().out
    assert f"resumed from epoch {want_epoch} batch {want_done}" in said
    _assert_same_state(_final(model), _final(full))
    assert out["steps"] == full_out["steps"] == 10
    losses = np.load(os.path.join(model, "train_loss.npy")).tolist()
    full_losses = np.load(os.path.join(full, "train_loss.npy")).tolist()
    # an interrupted epoch's mean covers the batches after the resume (as
    # in the JAX package); the whole epochs are the uninterrupted run's
    whole = {"sigterm": [1], "save_every_steps": [0],
             "sigterm_at_epoch_end": []}[how]
    assert len(losses) == (1 if how == "sigterm_at_epoch_end" else 2)
    assert all(losses[i] == full_losses[i] for i in whole)
    if how == "sigterm_at_epoch_end":  # epoch 1's end work was lost
        assert losses == full_losses[1:]


def test_val_metric_cer_selects_as_the_jax_rule(corpus, tmp_path,
                                                monkeypatch, capsys):
    """Dev CERs (scripted) 0.5, 0.25, 0.4, 0.3 over 4 epochs: the port
    promotes model_best where the JAX package's CheckpointManager.save
    (val_loss = the CER) returns is_best, on the EMA weights."""
    cers = iter([0.5, 0.25, 0.4, 0.3])
    seen = []

    def counts(params, batch, cfg, alphabet):
        seen.append(params)
        return round(next(cers) * 100), 100

    monkeypatch.setattr(train, "_batch_cer_counts", counts)
    model = str(tmp_path / "model")
    out = train.train(corpus, model, config=_tiny(val_metric="cer",
                                                  num_epochs=4,
                                                  accum_steps=1),
                      device="cpu")
    mgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
    want = [mgr.save({"x": np.zeros(1)}, val_loss=c)
            for c in (0.5, 0.25, 0.4, 0.3)]
    said = capsys.readouterr().out
    assert [f"val_cer={c:.4f}" in said for c in (0.5, 0.25, 0.4, 0.3)] == \
        [True] * 4
    assert said.count("new best checkpoint (cer") == sum(want) == 2
    best = load_checkpoint(os.path.join(model, "model_best.pt"))
    assert best["epoch"] == 2 and best["best_val_loss"] == mgr.best_val
    assert all(p is out["ema_params"] for p in seen)


# ------------------------------------------------------------- the CLI

RECIPE = ["--specaugment", "--speed_perturb", "0.9,1.1", "--wave_noise",
          "0.1", "--wave_gain_db", "3", "--accum_steps", "2", "--ema_decay",
          "0.999", "--keep_ckpts", "2", "--save_every_steps", "2",
          "--val_metric", "cer", "--loader_threads", "2", "--cache_audio_mb",
          "64", "--profile_steps", "1"]


@pytest.fixture(scope="module")
def recipe_model(corpus, tmp_path_factory):
    """The whole recipe through the CLI (3 epochs of 3 steps of the default
    BiLSTM-CTC on the CPU)."""
    model = str(tmp_path_factory.mktemp("recipe") / "model")
    assert cli.main(["--mode", "train", "--corpus_path", corpus,
                     "--model_path", model, "--num_epochs", "3",
                     "--batch_size", "4", "--device", "cpu", *RECIPE]) == 0
    return model


def test_cli_recipe_writes_every_artifact(recipe_model):
    model = recipe_model
    names = set(os.listdir(model))
    assert {"model_best.pt", "model_last.pt", "model_epoch0002.pt",
            "model_epoch0003.pt", "trace"} <= names
    assert "model_epoch0001.pt" not in names  # the newest 2 kept
    (trace,) = os.listdir(os.path.join(model, "trace"))
    # steps 3.. of 9, cut at epoch 1's end (3 steps an epoch)
    assert trace == "steps_3-3.pt.trace.json"
    with open(os.path.join(model, "trace", trace)) as fo:
        assert json.load(fo)["traceEvents"]
    for name in ("model_best.pt", "model_last.pt"):
        state = load_checkpoint(os.path.join(model, name))
        assert set(state["ema_params"]) == set(state["params"])
        assert state["opt_state"]["count"] == state["step"] // 2
    assert np.isfinite(np.load(os.path.join(model, "train_loss.npy"))).all()
    with open(os.path.join(model, "config.json")) as fo:
        saved = json.load(fo)
    assert saved["augment"]["speed_min"] == 0.9
    assert saved["augment"]["time_masks"] == 2  # --specaugment given
    assert saved["train"]["accum_steps"] == 2
    assert saved["train"]["val_metric"] == "cer"


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_ckpt_avg_predict_through_the_cli(corpus, recipe_model, capsys,
                                          decoder):
    """--ckpt avg serves the mean of the two snapshots' ema_params."""
    assert cli.main(["--mode", "predict", "--corpus_path", corpus,
                     "--model_path", recipe_model, "--device", "cpu",
                     "--ckpt", "avg", "--decoder", decoder,
                     "--beam_size", "4"]) == 0
    out = capsys.readouterr().out
    assert "averaged 2 epoch snapshots" in out and "CER:" in out
    with open(os.path.join(recipe_model, "predicted.txt")) as fo:
        assert len(fo.read().splitlines()) == 1
    got, _ = load_model(recipe_model, Alphabet.load(
        os.path.join(corpus, "alphabet.txt")), which="avg", device="cpu")
    snaps = [load_checkpoint(os.path.join(recipe_model,
                                          f"model_epoch000{e}.pt"))
             for e in (2, 3)]
    for k, v in got.items():
        mean = (snaps[0]["ema_params"][k].double()
                + snaps[1]["ema_params"][k].double()) / 2
        assert torch.equal(v, mean.float()), k


def test_ckpt_avg_without_snapshots_exits_with_a_message(corpus, tmp_path):
    model = str(tmp_path / "m")
    train.train(corpus, model, config=_tiny(num_epochs=1), device="cpu")
    with pytest.raises(SystemExit, match="--keep_ckpts"):
        cli.main(["--mode", "predict", "--corpus_path", corpus,
                  "--model_path", model, "--device", "cpu", "--ckpt", "avg"])


def test_finetune_pg_keeps_the_ema(corpus, uninterrupted, tmp_path, capsys):
    """An EMA model fine-tunes from its averaged weights, keeps the average
    (decay 0.9) in every checkpoint, and a resumed run restores it."""
    import shutil

    model = str(tmp_path / "model")
    shutil.copytree(uninterrupted[0], model)
    start = load_checkpoint(os.path.join(model, "model_best.pt"))
    cfg = cli.pg_config(cli.build_parser().parse_args(
        ["--mode", "finetune_pg", "--model_path", model]))
    assert cfg.train.ema_decay == 0.9
    reinforce.finetune_pg(corpus, model, num_steps=2, batch_size=2,
                          config=cfg, eval_every=1, device="cpu")
    last = _final(model)
    assert last["step"] == 2 and set(last["ema_params"]) == set(
        last["params"])
    for k, e in last["ema_params"].items():
        p, e0 = last["params"][k], start["ema_params"][k]
        # two updates of decay 0.9 from the served EMA weights
        assert (e - e0).abs().max() <= (p - e0).abs().max() * 0.5 + 1e-7, k
    reinforce.finetune_pg(corpus, model, num_steps=3, batch_size=2,
                          config=cfg, eval_every=0, device="cpu")
    assert "resumed from model_last at step 2" in capsys.readouterr().out
    again = _final(model)
    assert not torch.equal(again["ema_params"]["ctc_head.w"],
                           last["ema_params"]["ctc_head.w"])


@pytest.mark.parametrize("flags,field,value", [
    (["--accum_steps", "4"], "train.accum_steps", 4),
    (["--ema_decay", "0.99"], "train.ema_decay", 0.99),
    (["--keep_ckpts", "3"], "train.keep_ckpts", 3),
    (["--save_every_steps", "50"], "train.save_every_steps", 50),
    (["--val_metric", "cer"], "train.val_metric", "cer"),
    (["--loader_threads", "0"], "train.loader_threads", 0),
    (["--cache_audio_mb", "512"], "train.cache_audio_mb", 512.0),
    (["--init_from_torch", "m.pth", "--trust_torch_pickle"],
     "train.trust_torch_pickle", True),
    (["--specaugment"], "augment.time_masks", 2),
    (["--speed_perturb", "0.9,1.1"], "augment.time_masks", 0),
    (["--wave_noise", "0.2"], "augment.noise_std", 0.2),
    (["--wave_gain_db", "6"], "augment.gain_db", 6.0),
])
def test_cli_training_options_are_ported(flags, field, value):
    cfg = cli.train_config(cli.build_parser().parse_args(
        ["--mode", "train", *flags]))
    train.check_ported(cfg)
    section, name = field.split(".")
    assert getattr(getattr(cfg, section), name) == value
    assert cfg.augment.enabled == (section == "augment")


@pytest.mark.parametrize("flags,message", [
    (["--speed_perturb", "1.1"], "MIN,MAX"),
    (["--speed_perturb", "0.4,1.1"], "0.5 <= MIN"),
    (["--wave_noise", "-1"], "--wave_noise must be >= 0"),
    (["--keep_ckpts", "-1"], "--keep_ckpts must be >= 0"),
])
def test_cli_rejects_bad_training_values(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.train_config(cli.build_parser().parse_args(
            ["--mode", "train", *flags]))
