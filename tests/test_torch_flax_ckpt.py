"""The port's reader of the JAX package's flax checkpoints
(``checkpoint.read_flax_checkpoint``: msgpack without msgpack, bfloat16
without ml_dtypes) against flax's own ``msgpack_restore``, on files the
JAX package writes here; ``load_model`` / predict / align / finetune_pg
on a JAX model directory; the refusal to resume one with ``train()``; and
the committed fixture ``pg_asr_tpu_torch/testdata/flax_bilstm_tiny/``,
which the card compares its log-probs with (chip_smoke.py phase 12).

Parity bar: the reader gives flax's arrays bit for bit (bfloat16 as its
raw 16 bits) and flax's other leaves as equal values; the port's float32
forward on a JAX checkpoint gives the JAX ``_forward``'s log-probs within
LOGPROB_TOL (float32 summation order through a 1-layer BiLSTM).

Run as a script, ``python tests/test_torch_flax_ckpt.py``, it writes the
fixture anew (a JAX-trained model: the bits differ run to run, so commit
the new files together).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp
import optax

from pg_asr_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig, TrainConfig
from pg_asr_tpu.data.dataset import make_synthetic_corpus
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.predict import _forward as jax_forward
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import (find_checkpoint, load_checkpoint,
                                         read_flax_checkpoint)
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import Alphabet
from pg_asr_tpu_torch.predict import forward, load_model
from pg_asr_tpu_torch.train import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "pg_asr_tpu_torch", "testdata",
                       "flax_bilstm_tiny")
LOGPROB_TOL = 1e-4
# the fixture's training corpus: chip_smoke.py's words, so its alphabet is
# the smoke corpus's
WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(dtype: str, seed: int = 0, vocab: int = 28):
    cfg = JConfig(model=ModelConfig(vocab_size=vocab, input_proj_dim=32,
                                    hidden_size=16, num_layers=1,
                                    dtype=dtype))
    tree = jax_model.init_params(jax.random.PRNGKey(seed), cfg.model)
    if dtype == "bfloat16":
        tree = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), tree)
    return cfg, jax.tree_util.tree_map(np.asarray, tree)


def _as_numpy(x):
    """A reader leaf as numpy (bfloat16 as its raw bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return x


def _same_tree(got, want) -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        g = np.asarray(_as_numpy(got))
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reader_matches_flax_restore(tmp_path, dtype):
    """params, ema_params, an optax AdamW state and counters, as the JAX
    trainer saves them (every leaf an array)."""
    _, tree = _jax_tree(dtype)
    opt_state = optax.adamw(1e-3).init(tree)
    state = {"params": tree, "opt_state": opt_state, "step": 7, "epoch": 3,
             "best_val_loss": 1.25, "ema_params": tree,
             "batches_done": np.int32(4)}
    path = str(tmp_path / "model_best.ckpt")
    jax_save_checkpoint(path, state)
    with open(path, "rb") as fo:
        want = flax.serialization.msgpack_restore(fo.read())
    got = read_flax_checkpoint(path)
    _same_tree(got, want)
    assert got["params"]["lstm"]["0"]["fwd"]["W"].dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    # through load_checkpoint: the port's state dicts
    ck = load_checkpoint(path)
    for key in ("params", "ema_params"):
        ref = params_from_jax(tree)
        assert set(ck[key]) == set(ref)
        for name, t in ref.items():
            assert torch.equal(ck[key][name], t), name
    assert ck["step"] == 7 and ck["best_val_loss"] == 1.25


def test_reader_takes_every_format_flax_writes(tmp_path):
    """The other leaves ``flax.serialization.to_bytes`` writes: str (fix,
    8-bit lengths), bytes, None, bool, ints of each width and sign,
    floats, numpy scalars (ext 3), empty and integer arrays, maps of more
    than 15 keys."""
    state = {"short": "x", "long": "y" * 40, "blob": b"\x00\x01", "none": None,
             "t": True, "f": False, "small": 5, "neg": -3, "neg8": -100,
             "u8": 200, "u16": 60000, "u32": 2 ** 31, "u64": 2 ** 40,
             "i16": -30000, "i32": -2 ** 31, "i64": -2 ** 40, "x": 0.25,
             "np_f32": np.float32(0.5), "np_i64": np.int64(-9),
             "np_bool": np.bool_(True), "empty": np.zeros((0, 3), np.float32),
             "i8": np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
             "u8arr": np.arange(6, dtype=np.uint8),
             "f64": np.linspace(0, 1, 5), "nested": {str(i): np.int32(i)
                                                     for i in range(20)}}
    path = str(tmp_path / "formats.ckpt")
    raw = flax.serialization.to_bytes(state)
    with open(path, "wb") as fo:
        fo.write(raw)
    want = flax.serialization.msgpack_restore(raw)
    got = read_flax_checkpoint(path)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (np.generic, np.ndarray)):
            g = _as_numpy(got[k])
            assert g.dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(g, want[k])
        elif isinstance(want[k], dict):
            _same_tree(got[k], want[k])
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k


def test_reader_unchunks_large_leaves(tmp_path, monkeypatch):
    """Leaves over flax's MAX_CHUNK_SIZE are written as
    __msgpack_chunked_array__ records; a small limit makes every leaf of
    the tiny model one."""
    _, tree = _jax_tree("float32")
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = str(tmp_path / "chunked.ckpt")
    jax_save_checkpoint(path, {"params": tree})
    with open(path, "rb") as fo:
        raw = fo.read()
    assert b"__msgpack_chunked_array__" in raw
    got = read_flax_checkpoint(path)
    _same_tree(got, flax.serialization.msgpack_restore(raw))
    w = got["params"]["lstm"]["0"]["fwd"]["W"]
    assert w.shape == tree["lstm"][0]["fwd"]["W"].shape


def test_reader_refuses_what_flax_does_not_write(tmp_path):
    path = str(tmp_path / "bad.ckpt")
    with open(path, "wb") as fo:
        fo.write(b"\xc1")  # a byte msgpack never uses
    with pytest.raises(ValueError, match="0xc1"):
        read_flax_checkpoint(path)
    with open(path, "wb") as fo:
        fo.write(b"\x81\xa1a")  # a map cut short
    with pytest.raises(ValueError, match="truncated"):
        read_flax_checkpoint(path)


def _jax_model_dir(tmp_path, corpus_alphabet, dtype="float32", ema=True):
    """A model directory as the JAX trainer leaves it: config.json and
    model_best/last.ckpt (params, ema_params, opt_state, counters), the
    EMA weights apart from the raw ones."""
    cfg, tree = _jax_tree(dtype, seed=1, vocab=corpus_alphabet.size)
    cfg = cfg.replace(train=TrainConfig(ema_decay=0.9 if ema else 0.0))
    ema_tree = jax.tree_util.tree_map(lambda x: (x * 0.5).astype(x.dtype),
                                      tree)
    d = str(tmp_path / f"jax_{dtype}")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as fo:
        fo.write(cfg.to_json())
    state = {"params": tree, "opt_state": optax.adamw(1e-3).init(tree),
             "step": 5, "epoch": 1, "best_val_loss": 3.0}
    if ema:
        state["ema_params"] = ema_tree
    for name in ("model_best.ckpt", "model_last.ckpt"):
        jax_save_checkpoint(os.path.join(d, name), state)
    return d, cfg, ema_tree if ema else tree


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("flax") / "corpus")
    make_synthetic_corpus(d, n_utts=16, seed=3, min_dur=0.2, max_dur=0.5,
                          words=WORDS)
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_model_serves_a_jax_model_dir(tmp_path, corpus, dtype):
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    d, jcfg, served = _jax_model_dir(tmp_path, alphabet, dtype)
    assert find_checkpoint(d).endswith("model_best.ckpt")
    params, cfg = load_model(d, alphabet, device="cpu", dtype="float32")
    for name, t in params_from_jax(served).items():
        assert torch.equal(params[name], t.float()), name  # ema_params
    wave = (np.random.default_rng(0).uniform(-0.5, 0.5, (2, 8000))
            * 32767).astype(np.int16)
    ns = np.array([8000, 5000], np.int32)
    f32 = jcfg.replace(model=jcfg.model.__class__(
        **{**jcfg.model.__dict__, "dtype": "float32"}))
    want, _, want_lens = jax_forward(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), served),
        jnp.asarray(wave), jnp.asarray(ns), f32)
    got, _, lens = forward(params, torch.from_numpy(wave),
                           torch.from_numpy(ns), cfg)
    assert lens.tolist() == np.asarray(want_lens).tolist()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGPROB_TOL, rtol=0)


def test_ckpt_avg_averages_the_jax_epoch_snapshots(tmp_path, corpus):
    """--ckpt avg on a JAX model directory: the mean of its
    model_epoch*.ckpt snapshots' ema_params (float32: the JAX package's
    average_checkpoints gives the same)."""
    from pg_asr_tpu.checkpoint import average_checkpoints as jax_average

    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    d, _, _ = _jax_model_dir(tmp_path, alphabet)
    trees = []
    for epoch in (1, 2):
        _, tree = _jax_tree("float32", seed=10 + epoch, vocab=alphabet.size)
        trees.append(tree)
        jax_save_checkpoint(os.path.join(d, f"model_epoch{epoch:04d}.ckpt"),
                            {"params": tree, "ema_params": tree,
                             "epoch": epoch})
    params, _ = load_model(d, alphabet, which="avg", device="cpu")
    paths = [os.path.join(d, f"model_epoch{e:04d}.ckpt") for e in (1, 2)]
    want = params_from_jax(jax_average(paths, {"ema_params": trees[0]})
                           ["ema_params"])
    assert set(params) == set(want)
    for name, t in want.items():
        torch.testing.assert_close(params[name], t, rtol=0, atol=0)


def test_cli_serves_and_finetunes_a_jax_model_dir(tmp_path, corpus, capsys):
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    d, _, _ = _jax_model_dir(tmp_path, alphabet)
    base = ["--corpus_path", corpus, "--model_path", d, "--device", "cpu",
            "--batch_size", "4"]
    assert cli.main(["--mode", "predict", *base]) == 0
    assert cli.main(["--mode", "align", *base]) == 0
    with open(os.path.join(d, "alignments.jsonl")) as fo:
        rows = [json.loads(ln) for ln in fo]
    assert len(rows) == 2 and all(r["aligned"] for r in rows)
    assert cli.main(["--mode", "finetune_pg", *base, "--pg_steps", "2",
                     "--pg_eval_every", "0"]) == 0
    out = capsys.readouterr().out
    assert "CER:" in out and "[align] 2/2" in out
    # the fine-tuned model is the port's; the JAX files stay as they were
    assert os.path.exists(os.path.join(d, "model_last.pt"))
    assert find_checkpoint(d).endswith("model_best.pt")


def test_train_refuses_to_resume_a_jax_run(tmp_path, corpus):
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    d, _, _ = _jax_model_dir(tmp_path, alphabet, ema=False)
    with open(os.path.join(d, "config.json")) as fo:
        before = fo.read()
    with pytest.raises(NotImplementedError) as e:
        train(corpus, d, config=Config(), device="cpu")
    assert "not yet ported" in str(e.value) and "optax" in str(e.value)
    with open(os.path.join(d, "config.json")) as fo:
        assert fo.read() == before
    assert not any(n.endswith(".pt") for n in os.listdir(d))


def test_finetune_pg_refuses_to_resume_a_jax_pg_run(tmp_path, corpus):
    """A directory the JAX package left mid-PG (model_last.ckpt at epoch
    -1, step below --pg_steps): the JAX package resumes it with its optax
    state, so the port refuses it rather than start over from
    model_best.ckpt, and writes nothing."""
    alphabet = Alphabet.load(os.path.join(corpus, "alphabet.txt"))
    d, _, _ = _jax_model_dir(tmp_path, alphabet, ema=False)
    _, tree = _jax_tree("float32", seed=1, vocab=alphabet.size)
    jax_save_checkpoint(os.path.join(d, "model_last.ckpt"), {
        "params": tree, "opt_state": optax.adamw(1e-4).init(tree),
        "step": 3, "epoch": -1, "best_val_loss": 0.5})
    before = sorted(os.listdir(d))
    with pytest.raises(SystemExit) as e:
        cli.main(["--mode", "finetune_pg", "--corpus_path", corpus,
                  "--model_path", d, "--device", "cpu", "--pg_steps", "5",
                  "--batch_size", "4"])
    assert "not yet ported" in str(e.value) and "optax" in str(e.value)
    assert sorted(os.listdir(d)) == before
    assert not any(n.endswith(".pt") for n in os.listdir(d))


def _fixture_inputs():
    with np.load(os.path.join(FIXTURE, "reference.npz")) as z:
        return {k: z[k] for k in z.files}


def test_fixture_reproduces_the_jax_log_probs():
    """The committed fixture's stored log-probs are the JAX package's
    _forward on its model_best.ckpt (the EMA weights) today: what the card
    compares with is the reference's output, not the port's."""
    from pg_asr_tpu.data.text import Alphabet as JAlphabet
    from pg_asr_tpu.predict import load_model as jax_load_model

    ref = _fixture_inputs()
    alphabet = JAlphabet.load(os.path.join(FIXTURE, "alphabet.txt"))
    params, cfg = jax_load_model(FIXTURE, alphabet)
    lp, _, lens = jax_forward(params, jnp.asarray(ref["wave"]),
                              jnp.asarray(ref["num_samples"]), cfg)
    np.testing.assert_array_equal(np.asarray(lens), ref["out_lens"])
    np.testing.assert_allclose(np.asarray(lp), ref["log_probs"], atol=1e-6,
                               rtol=0)
    assert cfg.train.ema_decay > 0
    # and the port, on the CPU, within the parity tolerance
    params_t, cfg_t = load_model(FIXTURE, Alphabet.load(
        os.path.join(FIXTURE, "alphabet.txt")), device="cpu")
    got, _, got_lens = forward(params_t, torch.from_numpy(ref["wave"]),
                               torch.from_numpy(ref["num_samples"]), cfg_t)
    assert got_lens.tolist() == ref["out_lens"].tolist()
    np.testing.assert_allclose(got.numpy(), ref["log_probs"],
                               atol=LOGPROB_TOL, rtol=0)
    total = sum(os.path.getsize(os.path.join(FIXTURE, f))
                for f in os.listdir(FIXTURE))
    assert total <= 300 * 1024


def make_flax_fixture(out_dir: str = FIXTURE, work: str | None = None):
    """Train a tiny BiLSTM-CTC with the JAX package (1 layer, H=16, EMA)
    on a synthetic corpus of chip_smoke.py's words, then write its
    config.json, model_best.ckpt, alphabet.txt and reference.npz (two
    seeded waves as int16, their sample counts, and the JAX _forward's
    float32 log-probs and frame counts) into out_dir."""
    import tempfile

    from pg_asr_tpu.data.text import Alphabet as JAlphabet
    from pg_asr_tpu.predict import load_model as jax_load_model
    from pg_asr_tpu.train import train as jax_train
    from pg_asr_tpu_torch.data.audio import synth_utterance

    work = work or tempfile.mkdtemp()
    corpus = os.path.join(work, "corpus")
    make_synthetic_corpus(corpus, n_utts=32, seed=11, min_dur=0.3,
                          max_dur=1.0, words=WORDS)
    cfg = JConfig(model=ModelConfig(input_proj_dim=32, hidden_size=16,
                                    num_layers=1),
                  train=TrainConfig(num_epochs=3, batch_size=8,
                                    ema_decay=0.9))
    model = os.path.join(work, "model")
    jax_train(corpus, model, config=cfg)
    os.makedirs(out_dir, exist_ok=True)
    for name in ("config.json", "model_best.ckpt"):
        shutil.copy(os.path.join(model, name), os.path.join(out_dir, name))
    shutil.copy(os.path.join(corpus, "alphabet.txt"),
                os.path.join(out_dir, "alphabet.txt"))
    alphabet = JAlphabet.load(os.path.join(out_dir, "alphabet.txt"))
    params, jcfg = jax_load_model(out_dir, alphabet)
    n = 12000
    wave = np.zeros((2, n), np.int16)
    num_samples = np.array([n, 7000], np.int32)
    for i, seed in enumerate((101, 102)):
        x = synth_utterance(np.random.default_rng(seed), num_samples[i] / 16000)
        wave[i, : len(x)] = np.clip(np.rint(x * 32768.0), -32768, 32767)
    lp, _, lens = jax_forward(params, jnp.asarray(wave),
                              jnp.asarray(num_samples), jcfg)
    np.savez(os.path.join(out_dir, "reference.npz"), wave=wave,
             num_samples=num_samples,
             log_probs=np.asarray(lp, np.float32),
             out_lens=np.asarray(lens, np.int32))


if __name__ == "__main__":
    make_flax_fixture(sys.argv[1] if len(sys.argv) > 1 else FIXTURE)
