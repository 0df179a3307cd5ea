"""The CTC-lattice tools against the JAX package on the same inputs and
weights: ``ops/align.py`` (Viterbi backpointers and forced alignment),
``greedy_decode_with_timing``, ``assemble_word_timings``, and through the
drivers ``--mode align`` (alignments.jsonl), ``--mode predict
--timestamps`` (timestamps.jsonl) and ``--mode pseudolabel``
(pseudo.tsv), on one tiny BiLSTM-CTC, with character and BPE units.

Parity bar: backpointers, end states and spans identical (the Viterbi's
float32 sums are the same sums in the same order, so even exact ties,
uniform log-probs, break alike); every JSONL / TSV row identical but for
the confidences, which may differ by the last rounding step (the
log-probs agree within 1e-5, so a confidence within 1e-4 before rounding:
at most one unit of the 4th decimal after it). The drivers' test holds
every valid frame's top two log-probs more than 1e-4 apart, so that the
greedy tokens, and with them every onset, must agree.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from pg_asr_tpu.alignment import align_corpus as jax_align_corpus
from pg_asr_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig, TextConfig
from pg_asr_tpu.data.bpe import train_bpe as jax_train_bpe
from pg_asr_tpu.data.dataset import make_synthetic_corpus
from pg_asr_tpu.data.text import Alphabet as JAlphabet
from pg_asr_tpu.decoding import greedy as jax_greedy
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.ops import align as jax_align
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu.selftrain import pseudo_label as jax_pseudo_label
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.alignment import align_corpus
from pg_asr_tpu_torch.data import BatchIterator, load_manifest
from pg_asr_tpu_torch.data.bpe import load_tokenizer
from pg_asr_tpu_torch.decoding import greedy
from pg_asr_tpu_torch.ops import align
from pg_asr_tpu_torch.predict import forward, load_model
from pg_asr_tpu_torch.predict import predict as torch_predict
from pg_asr_tpu_torch.selftrain import pseudo_label

CONF_TOL = 1e-4
WORDS = ("abba", "cad", "bad", "cab", "dada", "ab")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice_inputs(kind: str):
    """B=5 rows, T=12, A=5: ragged frame lengths, repeated labels (which
    need a blank between them), a row whose lattice is infeasible (3
    labels with a repeat need 4 frames, it has 3) and one with no
    labels."""
    rng = np.random.default_rng(7)
    B, T, A = 5, 12, 5
    if kind == "tied":
        lp = np.full((B, T, A), -np.log(A), np.float32)
    else:
        x = rng.standard_normal((B, T, A)).astype(np.float32)
        lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    labels = np.zeros((B, 4), np.int32)
    rows = [[1, 2, 3], [2, 2], [4, 1, 1, 3], [3, 3, 1], []]
    for i, r in enumerate(rows):
        labels[i, : len(r)] = r
    label_lens = np.array([len(r) for r in rows], np.int32)
    frame_lens = np.array([12, 9, 7, 3, 5], np.int32)
    return lp, frame_lens, labels, label_lens


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_viterbi_matches_jax(kind):
    lp, fl, lab, ll = _lattice_inputs(kind)
    back, end, score = align.ctc_viterbi_backpointers(
        torch.from_numpy(lp), torch.from_numpy(fl), torch.from_numpy(lab),
        torch.from_numpy(ll))
    jb, je, js = jax_align.ctc_viterbi_backpointers(lp, fl, lab, ll)
    assert back.dtype == torch.int8 and back.shape == (12, 5, 9)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(end.numpy(), np.asarray(je))
    np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    got = align.ctc_forced_align(torch.from_numpy(lp), fl, lab, ll)
    want = jax_align.ctc_forced_align(lp, fl, lab, ll)
    assert got == want
    assert got[3] == [] and got[4] == []  # infeasible; no labels
    assert [len(s) for s in got[:3]] == [3, 2, 4]
    if kind == "tied":
        # skip before diagonal before stay, the final blank before the
        # last label: uniform log-probs take the JAX package's path
        assert back.numpy()[1, 0, 3] == 2 and back.numpy()[1, 0, 2] == 1
        assert end.tolist()[:3] == [6, 4, 8]


def test_frames_past_the_end_freeze_and_point_stay():
    lp, fl, lab, ll = _lattice_inputs("random")
    back, _, _ = align.ctc_viterbi_backpointers(
        torch.from_numpy(lp), torch.from_numpy(fl), torch.from_numpy(lab),
        torch.from_numpy(ll))
    for b, n in enumerate(fl):
        assert not back[n:, b].any()


def test_greedy_decode_with_timing_matches_jax():
    rng = np.random.default_rng(1)
    B, T, A = 4, 16, 6
    # runs of repeats and blanks, so onsets are not every frame
    frames = rng.integers(0, A, (B, T // 2)).repeat(2, axis=1)
    lp = rng.standard_normal((B, T, A)).astype(np.float32) - 3
    np.put_along_axis(lp, frames[..., None], 0.5, axis=2)
    mask = (np.arange(T)[None] < np.array([16, 11, 5, 1])[:, None]).astype(
        np.float32)
    got = greedy.greedy_decode_with_timing(torch.from_numpy(lp),
                                           torch.from_numpy(mask))
    want = jax_greedy.greedy_decode_with_timing(lp, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32
    # the ids are greedy_decode's
    labels, lens = greedy.greedy_decode(torch.from_numpy(lp),
                                        torch.from_numpy(mask))
    assert torch.equal(labels, got[0]) and torch.equal(lens, got[1])


@pytest.mark.parametrize("units", ["char", "bpe"])
def test_assemble_word_timings_matches_jax(units):
    texts = ["abba cad bad", "cab dada ab abba"]
    if units == "bpe":
        tok = jax_train_bpe(texts * 3, 16)
    else:
        tok = JAlphabet.from_texts(texts)
    ids = tok.encode(texts[1])
    onsets = np.arange(len(ids)) * 3 + 1
    logp = -np.linspace(0.1, 1.2, len(ids)).astype(np.float32)
    got = greedy.assemble_word_timings(np.array(ids), len(ids), onsets, logp,
                                       tok, 0.02)
    want = jax_greedy.assemble_word_timings(np.array(ids), len(ids), onsets,
                                            logp, tok, 0.02)
    assert got == want and [w["word"] for w in got] == texts[1].split()


def _same_rows(got: list, want: list) -> None:
    """Equal rows but for "conf"/"confidence" values, within CONF_TOL."""
    assert len(got) == len(want)

    def walk(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                if k in ("conf", "confidence"):
                    assert abs(g[k] - w[k]) <= CONF_TOL + 1e-9, (k, g, w)
                else:
                    walk(g[k], w[k])
        elif isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                walk(a, b)
        else:
            assert g == w

    walk(got, want)


def _jsonl(path):
    with open(path) as fo:
        return [json.loads(ln) for ln in fo]


def _tsv(path):
    with open(path) as fo:
        lines = fo.read().splitlines()
    rows = [ln.split("\t") for ln in lines[1:]]
    return lines[0], [{"path": p, "sentence": s, "conf": float(c)}
                      for p, s, c in rows]


@pytest.fixture(scope="module", params=["char", "bpe"])
def tools_setup(request, tmp_path_factory):
    units = request.param
    d = tmp_path_factory.mktemp(f"tools_{units}")
    corpus, alphabet = make_synthetic_corpus(
        str(d / "corpus"), n_utts=24, seed=5, min_dur=0.3, max_dur=0.8,
        words=WORDS)
    if units == "bpe":
        with open(os.path.join(corpus, "train.tsv")) as fo:
            texts = [ln.split("\t")[1] for ln in fo.read().splitlines()[1:]]
        alphabet = jax_train_bpe(texts, 14)
        alphabet.save(os.path.join(corpus, "bpe.vocab"))
    jcfg = JConfig(model=ModelConfig(vocab_size=alphabet.size,
                                     input_proj_dim=24, hidden_size=16,
                                     num_layers=1),
                   text=TextConfig(units=units))
    tree = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jax.random.PRNGKey(2), jcfg.model))
    # one JAX model directory, copied: the port serves the JAX checkpoint
    base = str(d / "jax_model")
    os.makedirs(base)
    with open(os.path.join(base, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    jax_save_checkpoint(os.path.join(base, "model_best.ckpt"),
                        {"params": tree})
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = str(d / name)
        shutil.copytree(base, dirs[name])
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    return units, corpus, paths, dirs


def _margin(corpus, paths, model_dir) -> float:
    """The smallest gap between a valid frame's top two log-probs over the
    test and train manifests."""
    from pg_asr_tpu_torch.predict import model_config, model_tokenizer

    alphabet = model_tokenizer(paths["alphabet_path"],
                               model_config(model_dir))
    params, cfg = load_model(model_dir, alphabet, device="cpu")
    margin = np.inf
    for tsv in ("test.tsv", "train.tsv"):
        utts = load_manifest(os.path.join(corpus, tsv), paths["aud_path"])
        for b in BatchIterator(utts, alphabet, 8, shuffle=False):
            lp, mask, _ = forward(params, torch.from_numpy(b.wave),
                                  torch.from_numpy(b.num_samples), cfg)
            top2 = lp.topk(2, dim=-1).values
            margin = min(margin, (top2[..., 0] - top2[..., 1])[mask > 0]
                         .min().item())
    return margin


def test_drivers_write_the_jax_rows(tools_setup):
    units, corpus, paths, dirs = tools_setup
    assert _margin(corpus, paths, dirs["port"]) > 1e-4

    jax_align_corpus(**paths, model_path=dirs["jax"], batch_size=4)
    got = align_corpus(**paths, model_path=dirs["port"], batch_size=4,
                       device="cpu")
    rows = _jsonl(got["path"])
    _same_rows(rows, _jsonl(os.path.join(dirs["jax"], "alignments.jsonl")))
    assert got["num_aligned"] == sum(r["aligned"] for r in rows) > 0
    assert any(r["words"] for r in rows)

    jax_predict(**paths, model_path=dirs["jax"], batch_size=4,
                timestamps=True)
    torch_predict(**paths, model_path=dirs["port"], batch_size=4,
                  timestamps=True, device="cpu")
    ts = _jsonl(os.path.join(dirs["port"], "timestamps.jsonl"))
    _same_rows(ts, _jsonl(os.path.join(dirs["jax"], "timestamps.jsonl")))
    assert any(r["words"] for r in ts)
    with open(os.path.join(dirs["port"], "predicted.txt")) as a, \
            open(os.path.join(dirs["jax"], "predicted.txt")) as b:
        assert a.read() == b.read()

    jax_pseudo_label(paths["aud_path"], paths["alphabet_path"], dirs["jax"],
                     batch_size=4, min_conf=0.0)
    res = pseudo_label(paths["aud_path"], paths["alphabet_path"],
                       dirs["port"], batch_size=4, min_conf=0.0, device="cpu")
    head, got_rows = _tsv(res["path"])
    want_head, want_rows = _tsv(os.path.join(dirs["jax"], "pseudo.tsv"))
    assert head == want_head == "path\tsentence\tconfidence"
    _same_rows(got_rows, want_rows)
    assert res["num_utts"] == 24 and res["num_kept"] == len(got_rows) > 0


def test_cli_modes_with_a_confidence_threshold(tools_setup, capsys):
    """The CLI flags: --min_conf keeps the JAX package's subset, --out_tsv
    moves the file, --timestamps with the beam is refused as in JAX. The
    thresholds split each model's confidences far from any one of them."""
    units, corpus, paths, dirs = tools_setup
    thr = {"char": 0.2155, "bpe": 0.1175}[units]
    jax_pseudo_label(paths["aud_path"], paths["alphabet_path"], dirs["jax"],
                     out_tsv=os.path.join(dirs["jax"], "p.tsv"), batch_size=4,
                     min_conf=thr)
    out = os.path.join(dirs["port"], "p.tsv")
    assert cli.main(["--mode", "pseudolabel", "--corpus_path", corpus,
                     "--model_path", dirs["port"], "--device", "cpu",
                     "--batch_size", "4", "--min_conf", str(thr),
                     "--out_tsv", out]) == 0
    rows = _tsv(out)[1]
    _same_rows(rows, _tsv(os.path.join(dirs["jax"], "p.tsv"))[1])
    assert "[pseudolabel] kept" in capsys.readouterr().out
    everything = pseudo_label(paths["aud_path"], paths["alphabet_path"],
                              dirs["port"], batch_size=4, min_conf=0.0,
                              device="cpu")["num_kept"]
    assert 0 < len(rows) < everything
    assert all(r["conf"] >= thr for r in rows)
    with pytest.raises(SystemExit, match="greedy decoder only"):
        cli.main(["--mode", "predict", "--corpus_path", corpus,
                  "--model_path", dirs["port"], "--device", "cpu",
                  "--timestamps", "--decoder", "beam"])
    assert cli.main(["--mode", "align", "--corpus_path", corpus,
                     "--model_path", dirs["port"], "--device", "cpu"]) == 0
    assert "[align] 3/3 utterances aligned" in capsys.readouterr().out


def test_align_and_pseudolabel_refuse_the_transducer(tmp_path):
    corpus, _ = make_synthetic_corpus(str(tmp_path / "c"), n_utts=8, seed=0,
                                      min_dur=0.2, max_dur=0.3)
    cfg = JConfig(model=ModelConfig(family="transducer"))
    d = str(tmp_path / "m")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as fo:
        fo.write(cfg.to_json())
    from pg_asr_tpu_torch.checkpoint import save_checkpoint

    save_checkpoint(os.path.join(d, "model_best.pt"), {"params": {}})
    base = ["--corpus_path", corpus, "--model_path", d, "--device", "cpu"]
    with pytest.raises(SystemExit, match="CTC-family model"):
        cli.main(["--mode", "align", *base])
    with pytest.raises(SystemExit, match="frame posteriors"):
        cli.main(["--mode", "pseudolabel", *base])


def test_bpe_units_through_beam_and_finetune_pg(tools_setup):
    """With BPE units (the char case runs the same code): the beam's
    predicted.txt and CER/WER are the JAX package's (decoded by
    BpeAlphabet.decode; the CTC beam at A = the BPE vocabulary), and
    finetune_pg --pg_reward neg_wer refuses a tokenizer with no space
    symbol with the JAX package's message."""
    from pg_asr_tpu.rl.reinforce import finetune_pg as jax_finetune_pg
    from pg_asr_tpu_torch.config import Config, RLConfig
    from pg_asr_tpu_torch.rl.reinforce import finetune_pg

    units, corpus, paths, dirs = tools_setup
    want = jax_predict(**paths, model_path=dirs["jax"], batch_size=4,
                       decoder="beam", beam_size=4)
    got = torch_predict(**paths, model_path=dirs["port"], batch_size=4,
                        decoder="beam", beam_size=4, device="cpu")
    with open(os.path.join(dirs["port"], "predicted.txt")) as a, \
            open(os.path.join(dirs["jax"], "predicted.txt")) as b:
        assert a.read() == b.read()
    assert got == want
    tok = load_tokenizer(corpus, units)
    with open(os.path.join(dirs["port"], "config.json")) as fo:
        assert Config.from_json(fo.read()).text.units == units
    params, cfg = load_model(dirs["port"], tok, device="cpu")
    assert cfg.model.vocab_size == tok.size == params["ctc_head.w"].shape[1]
    if units != "bpe":
        return
    assert " " not in tok.symbols
    from pg_asr_tpu.config import RLConfig as JRL

    with open(os.path.join(dirs["port"], "config.json")) as fo:
        text = fo.read()
    with pytest.raises(ValueError) as e_jax:
        jax_finetune_pg(corpus, dirs["jax"], num_steps=1, config=JConfig
                        .from_json(text).replace(rl=JRL(reward="neg_wer")))
    with pytest.raises(ValueError) as e_port:
        finetune_pg(corpus, dirs["port"], num_steps=1, device="cpu",
                    config=Config.from_json(text).replace(
                        rl=RLConfig(reward="neg_wer")))
    assert str(e_port.value) == str(e_jax.value)
    assert "space symbol" in str(e_port.value)


@pytest.mark.parametrize("mode", ["align", "pseudolabel"])
def test_new_modes_run_on_cuda_unless_told(tools_setup, mode, monkeypatch):
    """--device defaults to cuda: on a host without a GPU that is an
    error, never a silent CPU run."""
    _, corpus, _, dirs = tools_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--mode", mode, "--corpus_path", corpus, "--model_path",
                  dirs["port"]])
