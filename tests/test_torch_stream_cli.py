"""``--mode stream`` through both CLIs, in process, on the committed flax
fixture (pg_asr_tpu_torch/testdata/flax_bilstm_tiny: a JAX-trained
BiLSTM-CTC, its alphabet.txt the tokenizer), the port with ``--device
cpu``; and the port's parser against the JAX CLI's.

Parity bar: the printed text (each pushed block's piece, then the flush)
and the ``--timestamps`` JSON lines equal, greedy, beam and beam with the
n-gram LM fused (``--lm_order``: the table from the corpus's train.tsv, a
copy of the fixture's alphabet.txt beside it). The clip is 22.05 kHz, so
both resample it to the model's 16 kHz first (linear, np.interp semantics
in both).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from pg_asr_tpu import cli as jax_cli
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.data.audio import synth_utterance, write_wav
from pg_asr_tpu_torch.data.text import write_tsv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "pg_asr_tpu_torch", "testdata",
                       "flax_bilstm_tiny")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """2.4 s of synthetic speech at 22.05 kHz (three 0.8 s utterances)."""
    path = str(tmp_path_factory.mktemp("stream") / "clip.wav")
    rng = np.random.default_rng(1)
    write_wav(path, np.concatenate([synth_utterance(rng, 0.8, 22050)
                                    for _ in range(3)]), 22050)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The fixture's alphabet.txt and a train.tsv of the fixture's corpus
    words (its clips are never read)."""
    d = str(tmp_path_factory.mktemp("lm_corpus"))
    shutil.copy(os.path.join(FIXTURE, "alphabet.txt"), d)
    words = ("the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog")
    rng = np.random.default_rng(2)
    write_tsv(os.path.join(d, "train.tsv"), ["path", "sentence"], [
        {"path": f"u{i}.wav",
         "sentence": " ".join(rng.choice(words, rng.integers(2, 6)))}
        for i in range(40)])
    return d


def _stream(main, clip, capsys, *extra, corpus=FIXTURE):
    rc = main(["--mode", "stream", "--corpus_path", corpus, "--model_path",
               FIXTURE, "--wav", clip, "--chunk_frames", "16",
               "--right_context", "8", "--block_ms", "70", *extra])
    assert rc == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    (), ("--timestamps",), ("--decoder", "beam", "--beam_size", "4"),
    ("--decoder", "beam", "--beam_size", "4", "--lm_order", "2"),
    ("--decoder", "beam", "--lm_order", "3", "--lm_weight", "0.8",
     "--length_bonus", "0.5")])
def test_stream_output_matches_jax_cli(clip, corpus, capsys, extra):
    got = _stream(cli.main, clip, capsys, "--device", "cpu", *extra,
                  corpus=corpus)
    want = _stream(jax_cli.main, clip, capsys, *extra, corpus=corpus)
    assert got == want
    lines = got.splitlines()
    assert lines and lines[0].strip()
    if extra == ("--timestamps",):
        assert len(lines) > 3 and lines[1].startswith('{"word": ')


def test_stream_needs_wav_and_refuses_lm(clip, corpus):
    """--wav is needed; --lm_order without --decoder beam and
    --length_bonus without --lm_order exit with the JAX package's
    ValueErrors."""
    from pg_asr_tpu.config import Config
    from pg_asr_tpu.serving import StreamingTranscriber

    with pytest.raises(SystemExit, match="--wav"):
        cli.main(["--mode", "stream", "--corpus_path", FIXTURE,
                  "--model_path", FIXTURE, "--device", "cpu"])
    for extra, kw in ((["--lm_order", "2"], {"lm": np.zeros((2, 2))}),
                      (["--length_bonus", "0.1"], {"length_bonus": 0.1})):
        with pytest.raises(ValueError) as want:
            StreamingTranscriber(None, Config(), None, **kw)
        with pytest.raises(SystemExit) as e:
            cli.main(["--mode", "stream", "--corpus_path", corpus,
                      "--model_path", FIXTURE, "--device", "cpu", "--wav",
                      clip, *extra])
        assert str(e.value) == str(want.value)


def test_parser_declares_every_jax_flag():
    """Every option string of the JAX CLI, so that argparse resolves a flag
    or a prefix of one alike; the port's only extra is --seed (its
    --device, an int there, names a torch device here)."""
    def flags(parser):
        return {o for a in parser._actions for o in a.option_strings}

    jax_flags = flags(jax_cli.build_parser())
    port_flags = flags(cli.build_parser())
    assert jax_flags <= port_flags
    assert port_flags - jax_flags == {"--seed"}
    jax_defaults = {a.dest: a.default for a in jax_cli.build_parser()._actions}
    for a in cli.build_parser()._actions:
        if a.dest in ("wav", "chunk_frames", "right_context", "left_context",
                      "block_ms", "lm_order", "lm_weight", "lm_type",
                      "lm_steps", "lm_pass", "length_bonus",
                      "export_batch", "export_seconds", "export_platforms",
                      "export_quantize", "moe_experts", "capacity_factor",
                      "debug_nans", "microbatches"):
            assert a.default == jax_defaults[a.dest], a.dest
