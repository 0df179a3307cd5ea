"""``--mode preproc`` through both CLIs on the same inputs, and the
non-WAV branch of ``load_audio``.

Inputs: synthetic LibriSpeech trees (train-*, dev-*, test-* split dirs of
speaker/chapter/*.trans.txt with upper-case transcripts, a .flac beside a
.wav for one utterance; and a flat tree) and a Common Voice-style corpus
with raw sentences. Parity bar: train/dev/test.tsv, alphabet.txt,
bpe.vocab and bpe.merges byte for byte. soundfile is on neither host, so
FLAC decoding is a stub module in both packages.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import pg_asr_tpu.data.audio as jax_audio
from pg_asr_tpu.cli import main as jax_main
from pg_asr_tpu.data.dataset import BatchIterator as JaxBatchIterator
from pg_asr_tpu.data.dataset import load_manifest as jax_load_manifest
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.data import BatchIterator, load_manifest
from pg_asr_tpu_torch.data import audio
from pg_asr_tpu_torch.data.audio import synth_utterance, write_wav
from pg_asr_tpu_torch.data.bpe import load_tokenizer
from pg_asr_tpu_torch.data.dataset import make_synthetic_corpus

SR = 16000
WORDS = ["HELLO", "WORLD", "IT'S", "A", "SMALL", "TEST", "OF", "SPEECH"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubSoundfile:
    """soundfile.read for the tests' .flac files, which hold a (N, 2)
    float32 .npy array at 16 kHz (not a WAV: the native WAV decoder
    refuses them, as it would a real FLAC)."""

    @staticmethod
    def read(path, dtype="float32", always_2d=False):
        assert dtype == "float32" and not always_2d
        with open(path, "rb") as fo:
            return np.load(fo), SR


def _write_flac(path: str, mono: np.ndarray) -> None:
    """Two channels, x and x / 2, so that the mono mix shows."""
    with open(path, "wb") as fo:
        np.save(fo, np.stack([mono, 0.5 * mono], axis=1).astype(np.float32))


def _write_tree(root: str, splits, rng) -> None:
    """speaker/chapter/<id>.wav + <spk>-<chap>.trans.txt under each split
    dir ('' = the root itself); the first utterance of each chapter also
    has a .flac (which scan_librispeech prefers)."""
    for split in splits:
        for spk, chap in ((19, 198), (26, 495)):
            d = os.path.join(root, split, str(spk), str(chap))
            os.makedirs(d, exist_ok=True)
            lines = []
            for k in range(2):
                uid = f"{spk}-{chap}-{k:04d}"
                wav = synth_utterance(rng, 0.2, SR)
                write_wav(os.path.join(d, uid + ".wav"), wav, SR)
                if k == 0:
                    _write_flac(os.path.join(d, uid + ".flac"), 0.5 * wav)
                words = rng.choice(WORDS, size=int(rng.integers(1, 4)))
                lines.append(uid + " " + " ".join(words))
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as fo:
                fo.write("\n".join(lines) + "\n")


def _outputs(d: str) -> dict:
    out = {}
    for name in ("train.tsv", "dev.tsv", "test.tsv", "alphabet.txt",
                 "bpe.vocab", "bpe.merges"):
        p = os.path.join(d, name)
        if os.path.exists(p):
            with open(p, "rb") as fo:
                out[name] = fo.read()
    return out


@pytest.mark.parametrize("splits", [
    ("train-clean-100", "train-other-500", "dev-clean", "test-clean"),
    ("",),  # a flat tree: the root is all train
])
def test_librispeech_preproc_matches_jax_cli(tmp_path, splits):
    root = str(tmp_path / "LibriSpeech")
    _write_tree(root, splits, np.random.default_rng(0))
    args = ["--mode", "preproc", "--librispeech_root", root, "--units",
            "bpe", "--bpe_vocab_size", "30"]
    assert jax_main(args + ["--corpus_path", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--corpus_path", str(tmp_path / "port")]) == 0
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert got == want
    names = {"train.tsv", "alphabet.txt", "bpe.vocab", "bpe.merges"}
    if len(splits) > 1:
        names |= {"dev.tsv", "test.tsv"}
    assert set(got) == names
    rows = got["train.tsv"].decode().splitlines()[1:]
    assert len(rows) == 4 * (2 if len(splits) > 1 else 1)
    assert sum(r.split("\t")[0].endswith(".flac") for r in rows) == \
        len(rows) // 2  # .flac before .wav
    assert all(os.path.isabs(r.split("\t")[0]) for r in rows)
    assert all(r.split("\t")[1] == r.split("\t")[1].lower() for r in rows)


def test_librispeech_flac_batches_match_jax(tmp_path, monkeypatch):
    """The preprocessed tree's train split, .flac rows through the stub,
    gives the JAX package's batch."""
    monkeypatch.setattr(audio, "_sf", StubSoundfile)
    monkeypatch.setattr(jax_audio, "_sf", StubSoundfile)
    root = str(tmp_path / "LibriSpeech")
    _write_tree(root, ("train-clean-100",), np.random.default_rng(1))
    corpus = str(tmp_path / "corpus")
    assert cli.main(["--mode", "preproc", "--librispeech_root", root,
                     "--corpus_path", corpus]) == 0
    tsv = os.path.join(corpus, "train.tsv")
    alphabet = load_tokenizer(corpus, "char")
    got = next(iter(BatchIterator(load_manifest(tsv, None), alphabet, 4,
                                  shuffle=False)))
    want = next(iter(JaxBatchIterator(jax_load_manifest(tsv, None), alphabet,
                                      4, shuffle=False)))
    np.testing.assert_array_equal(got.wave, want.wave)
    np.testing.assert_array_equal(got.num_samples, want.num_samples)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.paths == want.paths and got.texts == want.texts
    assert any(p.endswith(".flac") for p in got.paths)


def test_common_voice_preproc_matches_jax_cli(tmp_path):
    base = str(tmp_path / "base")
    make_synthetic_corpus(base, n_utts=16, seed=2, min_dur=0.1, max_dur=0.2)
    raw = ["Hello, World!", "It's 2024 -- a TEST_case/slash.",
           "Ünïcödé  façade", "naïve CAFÉ... ok?", "zer—moduz"]
    for split in ("train", "dev", "test"):
        p = os.path.join(base, f"{split}.tsv")
        with open(p) as fo:
            lines = fo.read().splitlines()
        lines = [lines[0]] + [ln.split("\t")[0] + "\t" + raw[i % len(raw)]
                              for i, ln in enumerate(lines[1:])]
        with open(p, "w") as fo:
            fo.write("\n".join(lines) + "\n")
    for name in ("jax", "port"):
        shutil.copytree(base, str(tmp_path / name))
    args = ["--mode", "preproc", "--lang", "fr", "--units", "bpe",
            "--bpe_vocab_size", "24"]
    assert jax_main(args + ["--corpus_path", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--corpus_path", str(tmp_path / "port")]) == 0
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert got == want and len(got) == 6
    assert "façade" in got["train.tsv"].decode()
    assert "2024" not in got["train.tsv"].decode()


def test_preproc_ignores_device(tmp_path, capsys):
    """preproc does no tensor work: --device cuda on a host without a GPU
    is not an error there."""
    corpus = str(tmp_path / "c")
    make_synthetic_corpus(corpus, n_utts=8, seed=0, min_dur=0.1, max_dur=0.2)
    assert cli.main(["--mode", "preproc", "--corpus_path", corpus,
                     "--device", "cuda"]) == 0
    assert "[preproc] normalized TSVs + alphabet.txt" in \
        capsys.readouterr().out


def test_load_audio_non_wav_through_soundfile(tmp_path, monkeypatch):
    path = str(tmp_path / "x.flac")
    mono = synth_utterance(np.random.default_rng(3), 0.1, SR)
    _write_flac(path, mono)
    # without soundfile: the JAX package's error
    monkeypatch.setattr(audio, "_sf", None)
    monkeypatch.setattr(jax_audio, "_sf", None)
    with pytest.raises(RuntimeError) as got:
        audio.load_audio(path)
    with pytest.raises(RuntimeError) as want:
        jax_audio.load_audio(path)
    assert str(got.value) == str(want.value)
    # with it: float32 mono, the channels averaged
    monkeypatch.setattr(audio, "_sf", StubSoundfile)
    monkeypatch.setattr(jax_audio, "_sf", StubSoundfile)
    x, sr = audio.load_audio(path)
    y, sr2 = jax_audio.load_audio(path)
    assert sr == sr2 == SR and x.dtype == np.float32 and x.ndim == 1
    np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(x, 0.75 * mono, rtol=1e-6)


def test_bpe_train_then_resume_keeps_the_units(tmp_path, capsys):
    """preproc --units bpe, then train --units bpe: the model's vocabulary
    is the BPE one (F.ctc_loss at that A gives finite losses); a resume
    without --units keeps bpe and says so in the JAX package's words."""
    import json

    corpus = str(tmp_path / "c")
    make_synthetic_corpus(corpus, n_utts=12, seed=4, min_dur=0.1,
                          max_dur=0.2)
    assert cli.main(["--mode", "preproc", "--corpus_path", corpus,
                     "--units", "bpe", "--bpe_vocab_size", "20"]) == 0
    tok = load_tokenizer(corpus, "bpe")
    model = str(tmp_path / "m")
    base = ["--mode", "train", "--corpus_path", corpus, "--model_path", model,
            "--batch_size", "4", "--device", "cpu"]
    assert cli.main(base + ["--units", "bpe", "--num_epochs", "1"]) == 0
    with open(os.path.join(model, "config.json")) as fo:
        cfg = json.load(fo)
    assert cfg["text"]["units"] == "bpe"
    assert cfg["model"]["vocab_size"] == tok.size != load_tokenizer(
        corpus, "char").size
    assert np.isfinite(np.load(os.path.join(model, "train_loss.npy"))).all()
    capsys.readouterr()
    assert cli.main(base + ["--num_epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert ("[train] resuming with text.units='bpe' from the checkpoint's "
            "config.json") in out
    assert "[train] resumed from epoch 1" in out
