"""The port's CTC prefix beam search (plain PyTorch, on CPU) vs the JAX
package's (pg_asr_tpu/decoding/beam.py), on the same numpy arrays.

Exact: labels, lens, and for the scan the (parent, sym) backpointers, which
show the tie order (lower index first, as lax.top_k) is kept. Scores and
nll: rtol 1e-5. The port's logaddexp is max + log1p(exp(min - max)) (the
Pallas kernel's form), jnp.logaddexp's formula on finite values, so the two
differ only where torch's and XLA's exp/log1p round differently on the CPU:
an ulp per operation, ~1e-7 relative after 45 frames in development.

Posteriors are sharp (logits x 2, as tests/test_device_beam.py makes them)
so that no two distinct candidates come within an ulp of each other.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pg_asr_tpu.checkpoint import save_checkpoint
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig
from pg_asr_tpu.data.dataset import (BatchIterator, load_manifest,
                                     make_synthetic_corpus)
from pg_asr_tpu.decoding import beam as jb
from pg_asr_tpu.decoding.host_beam import HostCTCBeamDecoder
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu.predict import predict as jax_predict
from pg_asr_tpu_torch import cli
from pg_asr_tpu_torch.checkpoint import save_model
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.decoding import beam as tb
from pg_asr_tpu_torch.decoding import cuda_beam
from pg_asr_tpu_torch.predict import forward, load_model
from pg_asr_tpu_torch.predict import predict as torch_predict

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _log_probs(rng, B, T, S, sharp=2.0):
    x = rng.standard_normal((B, T, S)) * sharp
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _frame_lens(rng, B, T):
    fl = rng.integers(1, T + 1, B).astype(np.int32)
    fl[0] = T
    fl[1:3] = [1, 2]  # the shortest utterances
    return fl


def _jax_scan(lp, fl, K, Lmax, prune):
    fn = jax.jit(jax.vmap(partial(jb._scan_hash, K=K, A=lp.shape[-1],
                                  Lmax=Lmax, blank=0, prune=prune)))
    lens, scores, parents, syms = map(np.asarray, fn(lp, fl))
    # vmap puts the batch first; the port's backpointers are (T, B, K)
    return lens, scores, parents.transpose(1, 0, 2), syms.transpose(1, 0, 2)


def _port_scan(lp, fl, K, Lmax, prune):
    out = tb._scan_hash(torch.from_numpy(lp), torch.from_numpy(fl), K=K,
                        A=lp.shape[-1], Lmax=Lmax, blank=0, prune=prune)
    return tuple(t.numpy() for t in out)


def _assert_scan_equal(got, want):
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(g, w)  # lens, parents, syms
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)


@pytest.mark.parametrize("prune", [None, 4, 6])
# beams wider than a warp's 32 lanes (the kernel's block form) over A=40
@pytest.mark.parametrize("T,S,K", [(6, 4, 4), (13, 5, 8), (20, 8, 16),
                                   (12, 40, 33), (10, 40, 40)])
def test_scan_hash_matches_jax(T, S, K, prune):
    rng = np.random.default_rng(T * 7 + S)
    lp, fl = _log_probs(rng, 5, T, S), _frame_lens(rng, 5, T)
    got = _port_scan(lp, fl, K, T, prune)
    want = _jax_scan(lp, fl, K, T, prune)
    _assert_scan_equal(got, want)
    assert (got[3][0] >= 0).any()  # some frame extends: the check is not idle
    # every slot of utterance 0, rebuilt from its backpointers
    for slot in range(K):
        np.testing.assert_array_equal(
            tb._backtrack_slot(slot, torch.from_numpy(got[2][:, 0]),
                               torch.from_numpy(got[3][:, 0]), T).numpy(),
            np.asarray(jb._backtrack_slot(slot, want[2][:, 0], want[3][:, 0],
                                          T)))


def test_scan_hash_wraps_the_int32_hash():
    """Prefixes of 5+ symbols: the rolling hash (x 1000003 per symbol)
    wraps int32 from length 2 on, many times over here."""
    T, S, K = 48, 6, 8
    rng = np.random.default_rng(11)
    lp, fl = _log_probs(rng, 4, T, S), _frame_lens(rng, 4, T)
    got = _port_scan(lp, fl, K, T, None)
    _assert_scan_equal(got, _jax_scan(lp, fl, K, T, None))
    assert got[0].max() >= 5 and 1000003 ** 5 > 2 ** 64


def _both(lp, fl, **kw):
    want = jb.beam_decode(jnp.asarray(lp), jnp.asarray(fl), **kw)
    kw.pop("interpret", None)
    if kw.get("impl") == "pallas":
        kw["impl"] = "hash"
    got = tb.beam_decode(torch.from_numpy(lp), torch.from_numpy(fl), **kw)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def _assert_decode_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)


@pytest.mark.parametrize("impl,prune", [("hash", None), ("hash", 6),
                                        ("pallas", None), ("buffer", None)])
def test_beam_decode_matches_jax(impl, prune):
    """The exact search against JAX's hash scan, its Pallas kernel (in
    interpret mode) and its buffer oracle; prune 6 against the hash scan
    (the Pallas kernel ignores prune)."""
    T, S, K = 14, 6, 8
    rng = np.random.default_rng(5)
    lp, fl = _log_probs(rng, 4, T, S), _frame_lens(rng, 4, T)
    kw = dict(beam_size=K, max_label_len=T + 4, impl=impl, prune=prune)
    if impl == "pallas":
        kw["interpret"] = True
    got, want = _both(lp, fl, **kw)
    _assert_decode_equal(got, want)
    assert got[0].shape == (4, T + 4) and got[0].dtype == np.int32


def test_beam_decode_matches_host_oracle():
    T, S, K = 12, 5, 8
    rng = np.random.default_rng(42)
    lp = _log_probs(rng, 3, T, S)
    labels, lens, nll = tb.beam_decode(torch.from_numpy(lp),
                                       torch.full((3,), T), beam_size=K,
                                       max_label_len=T)
    for b in range(3):
        ref_seq, ref_nll = HostCTCBeamDecoder().decode(
            np.exp(lp[b].astype(np.float64)), beam_size=K)
        assert tuple(labels[b, :int(lens[b])].tolist()) == tuple(ref_seq)
        assert float(nll[b]) == pytest.approx(ref_nll, rel=1e-3, abs=1e-3)


def test_beam_decode_nbest_matches_jax():
    T, S, K = 16, 6, 8
    rng = np.random.default_rng(9)
    lp, fl = _log_probs(rng, 4, T, S), _frame_lens(rng, 4, T)
    want = [np.asarray(t) for t in jb.beam_decode_nbest(
        jnp.asarray(lp), jnp.asarray(fl), beam_size=K, max_label_len=T + 2)]
    got = [t.numpy() for t in tb.beam_decode_nbest(
        torch.from_numpy(lp), torch.from_numpy(fl), beam_size=K,
        max_label_len=T + 2)]
    _assert_decode_equal(got, want)
    # slot 0 is beam_decode's answer
    top = tb.beam_decode(torch.from_numpy(lp), torch.from_numpy(fl),
                         beam_size=K, max_label_len=T + 2, prune=None)
    np.testing.assert_array_equal(got[0][:, 0], top[0].numpy())


@pytest.mark.parametrize("K", [33, 40])
def test_beam_decode_wide_beams_match_jax(K):
    """beam_decode (exact and prune 6) and beam_decode_nbest at beams wider
    than 32 over A=40 against the JAX hash scan."""
    T, S = 12, 40
    rng = np.random.default_rng(K)
    lp, fl = _log_probs(rng, 4, T, S), _frame_lens(rng, 4, T)
    for prune in (None, 6):
        got, want = _both(lp, fl, beam_size=K, max_label_len=T + 2,
                          impl="hash", prune=prune)
        _assert_decode_equal(got, want)
    want = [np.asarray(t) for t in jb.beam_decode_nbest(
        jnp.asarray(lp), jnp.asarray(fl), beam_size=K, max_label_len=T + 2)]
    got = [t.numpy() for t in tb.beam_decode_nbest(
        torch.from_numpy(lp), torch.from_numpy(fl), beam_size=K,
        max_label_len=T + 2)]
    _assert_decode_equal(got, want)


def test_rank_topk_ties_toward_the_lower_index():
    scores = np.array([1.0, 3.0, 3.0, -1e30, 2.0, 3.0, -1e30, 2.0],
                      np.float32)
    for K in (1, 3, 5, 8):
        ts, oh = tb.rank_topk(torch.from_numpy(scores), K)
        jts, joh = jb.rank_topk(jnp.asarray(scores), K)
        np.testing.assert_array_equal(oh.numpy(), np.asarray(joh))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
        vals, idx = tb._top_k(torch.from_numpy(scores), K)
        jv, ji = jax.lax.top_k(jnp.asarray(scores), K)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    # above the pairwise-compare limit the selection is a stable sort
    big = np.repeat(np.float32([0.5, 2.0, -1.0]), 400)
    ts, oh = tb.rank_topk(torch.from_numpy(big), 4)
    assert oh.shape == (1200, 4)
    assert oh.nonzero()[:, 0].tolist() == [400, 401, 402, 403]


def test_all_blank_frames_decode_to_nothing():
    T, S = 9, 5
    lp = np.full((2, T, S), np.log(0.01 / (S - 1)), np.float32)
    lp[..., 0] = np.log(0.99)
    got, want = _both(lp, np.array([T, 4], np.int32), beam_size=4,
                      max_label_len=T)
    _assert_decode_equal(got, want)
    assert (got[1] == 0).all() and (got[0] == 0).all()


def test_dead_slots():
    """K above the number of distinct prefixes: slots that stay dead
    (nll ~ 1e30) in the n-best, and their backpointer rows."""
    T, S, K = 2, 3, 16
    rng = np.random.default_rng(3)
    lp, fl = _log_probs(rng, 3, T, S), np.array([2, 1, 2], np.int32)
    want = [np.asarray(t) for t in jb.beam_decode_nbest(
        jnp.asarray(lp), jnp.asarray(fl), beam_size=K, max_label_len=T)]
    got = [t.numpy() for t in tb.beam_decode_nbest(
        torch.from_numpy(lp), torch.from_numpy(fl), beam_size=K,
        max_label_len=T)]
    _assert_decode_equal(got, want)
    assert (got[2] > 1e29).any()
    _assert_scan_equal(_port_scan(lp, fl, K, T, None),
                       _jax_scan(lp, fl, K, T, None))


def test_max_label_len_below_the_best_path():
    """Extends stop at Lmax = min(max_label_len, T); labels come back
    padded to max_label_len."""
    T, S, K = 20, 4, 8
    rng = np.random.default_rng(7)
    lp = _log_probs(rng, 3, T, S, sharp=4.0)
    fl = np.full(3, T, np.int32)
    free = tb.beam_decode(torch.from_numpy(lp), torch.from_numpy(fl),
                          beam_size=K, max_label_len=T)
    assert int(free[1].max()) > 3
    got, want = _both(lp, fl, beam_size=K, max_label_len=3)
    _assert_decode_equal(got, want)
    assert got[1].max() == 3 and got[0].shape == (3, 3)


def test_bf16_log_probs_decode_in_float32():
    T, S, K = 12, 6, 8
    rng = np.random.default_rng(4)
    lp = torch.from_numpy(_log_probs(rng, 3, T, S)).to(torch.bfloat16)
    fl = np.full(3, T, np.int32)
    want = jb.beam_decode(jnp.asarray(lp.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(fl), beam_size=K, max_label_len=T)
    got = tb.beam_decode(lp, torch.from_numpy(fl), beam_size=K,
                         max_label_len=T)
    assert got[2].dtype == torch.float32
    _assert_decode_equal([t.numpy() for t in got],
                         [np.asarray(t) for t in want])


def test_unported_and_unknown_options_raise():
    lp, fl = torch.zeros(1, 3, 4), torch.tensor([3])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tb.beam_decode(lp, fl, lm=np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="impl"):
        tb.beam_decode(lp, fl, impl="pallas")


def test_launcher_refuses_cpu_tensors():
    """The kernel's launcher never takes a CPU tensor (beam_decode sends CPU
    tensors to the plain version): it raises before building anything."""
    before = cuda_beam.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cuda_beam.ctc_beam_cuda(torch.zeros(2, 5, 6),
                                torch.full((2,), 5, dtype=torch.int32), K=4,
                                M=6, Lmax=5)
    assert cuda_beam.LAUNCHES == before


# ---------------------------------------------------------------------------
# The slice as a whole: predict(decoder="beam") and the CLI
# ---------------------------------------------------------------------------

CORPUS_SEED, MODEL_SEED, BATCH = 3, 5, 4


@pytest.fixture(scope="module")
def beam_slice(tmp_path_factory):
    d = tmp_path_factory.mktemp("beam_slice")
    corpus, alphabet = make_synthetic_corpus(
        str(d / "corpus"), n_utts=32, seed=CORPUS_SEED, min_dur=0.3,
        max_dur=1.0)
    jcfg = JConfig(model=ModelConfig(vocab_size=alphabet.size,
                                     input_proj_dim=32, hidden_size=16,
                                     num_layers=2))
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(MODEL_SEED),
                                          jcfg.model))
    jax_dir, torch_dir = str(d / "jax_model"), str(d / "torch_model")
    os.makedirs(jax_dir)
    with open(os.path.join(jax_dir, "config.json"), "w") as fo:
        fo.write(jcfg.to_json())
    save_checkpoint(os.path.join(jax_dir, "model_best.ckpt"),
                    {"params": tree})
    save_model(torch_dir, params_from_jax(tree),
               Config.from_json(jcfg.to_json()))
    paths = dict(test_path=os.path.join(corpus, "test.tsv"),
                 aud_path=os.path.join(corpus, "clips"),
                 alphabet_path=os.path.join(corpus, "alphabet.txt"))
    return paths, alphabet, jax_dir, torch_dir


@pytest.mark.parametrize("beam_prune", [None, 0])
def test_predict_beam_matches_jax_package(beam_slice, beam_prune):
    """Same predicted.txt byte for byte and the same CER/WER, at the
    default prune (6) and the exact search. Fair bar: the two packages'
    log-probs differ by ~1e-5 (the model parity test's bound); noise of
    1e-4 on the port's log-probs leaves every batch's decode unchanged, so
    no selection of the search lies that close to a tie."""
    paths, alphabet, jax_dir, torch_dir = beam_slice
    params, cfg = load_model(torch_dir, alphabet, device="cpu")
    prune = cfg.decode.beam_prune if beam_prune is None else None
    rng = np.random.default_rng(0)
    utts = load_manifest(paths["test_path"], paths["aud_path"])
    for b in BatchIterator(utts, alphabet, BATCH, shuffle=False):
        lp, _, fl = forward(params, torch.from_numpy(b.wave),
                            torch.from_numpy(b.num_samples), cfg)
        noisy = lp + torch.from_numpy(
            rng.uniform(-1e-4, 1e-4, lp.shape).astype(np.float32))
        a = tb.beam_decode(lp, fl, beam_size=16, prune=prune)
        n = tb.beam_decode(noisy, fl, beam_size=16, prune=prune)
        assert torch.equal(a[0], n[0]) and torch.equal(a[1], n[1])

    ref = jax_predict(**paths, model_path=jax_dir, batch_size=BATCH,
                      decoder="beam", beam_prune=beam_prune)
    got = torch_predict(**paths, model_path=torch_dir, batch_size=BATCH,
                        decoder="beam", beam_prune=beam_prune, device="cpu")
    with open(os.path.join(jax_dir, "predicted.txt")) as fo:
        ref_txt = fo.read()
    with open(os.path.join(torch_dir, "predicted.txt")) as fo:
        got_txt = fo.read()
    assert got_txt == ref_txt
    assert any(line.split("|")[1] for line in got_txt.splitlines())
    assert got == ref


def _cli(beam_slice, *extra):
    paths, _, _, torch_dir = beam_slice
    return cli.main(["--mode", "predict", "--test_path", paths["test_path"],
                     "--aud_path", paths["aud_path"], "--alphabet",
                     paths["alphabet_path"], "--model_path", torch_dir,
                     "--device", "cpu", *extra])


def test_cli_beam_runs_on_cpu(beam_slice, capsys):
    assert _cli(beam_slice, "--decoder", "beam", "--beam_size", "4",
                "--beam_prune", "0") == 0
    out = capsys.readouterr().out
    assert "CER:" in out and "WER:" in out


@pytest.mark.parametrize("extra,message", [
    (["--beam_prune", "3"], "--beam_prune applies to --decoder beam"),
    (["--decoder", "beam", "--beam_prune", "1"], "--beam_prune must be >= 2"),
])
def test_cli_beam_options_exit_with_message(beam_slice, extra, message):
    with pytest.raises(SystemExit) as e:
        _cli(beam_slice, *extra)
    assert message in str(e.value)
