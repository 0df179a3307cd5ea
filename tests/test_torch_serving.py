"""Streaming transcription in the port (pg_asr_tpu_torch/serving.py)
against the JAX package's (pg_asr_tpu/serving.py), on the same weights
(through convert.params_from_jax) and the same seeded waves, at the JAX
tests' tiny configuration (logmel 16 mels, n_fft 128, hop 64; 2 BiLSTM
layers of 16; vocab 8).

Parity bar, float32: ids, text, beam prefixes and lengths equal; log-probs,
beam masses (p_b, p_nb), norm statistics and LSTM carries within 1e-5
(the same float32 operations; products and sums in another order, and the
window's backward direction through ``lstm_scan_plain``, whose sigmoid
rounds once where the JAX scan's rounds per operation). Word confidences
are rounded to 4 decimals by both, so within one unit of the 4th decimal.
The BiLSTM's backward direction is the port's lstm_fwd kernel on a CUDA
tensor; here, on CPU tensors, its plain version runs (the kernel against
it: tests/test_torch_cuda.py, chip_smoke.py phase 13).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu import serving as jserving
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import (ConformerConfig, DecodeConfig, FeatureConfig,
                               ModelConfig, TransducerConfig,
                               TransformerConfig)
from pg_asr_tpu.data.text import Alphabet as JAlphabet
from pg_asr_tpu.models import bilstm_ctc as jax_bilstm
from pg_asr_tpu_torch import serving
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import Alphabet

TOL = 1e-5
CONF_TOL = 1e-4
BEAM_K, BEAM_L = 4, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(family: str = "ctc") -> JConfig:
    return JConfig(
        features=FeatureConfig(kind="logmel", n_mels=16, n_fft=128,
                               win_length=128, hop_length=64),
        model=ModelConfig(family=family, vocab_size=8, input_dim=16,
                          input_proj_dim=32, hidden_size=16, num_layers=2,
                          dropout=0.0, use_pallas_lstm=False),
        transducer=TransducerConfig(encoder="bilstm", pred_embed_dim=8,
                                    pred_hidden=8, joint_dim=12),
        transformer=TransformerConfig(num_layers=2, d_model=32, num_heads=2,
                                      ffn_dim=64, dropout=0.0, subsample=2),
        conformer=ConformerConfig(num_layers=2, d_model=32, num_heads=2,
                                  ffn_dim=64, conv_kernel=7, dropout=0.0,
                                  subsample=2),
    )


def port_cfg(jcfg: JConfig) -> Config:
    return Config.from_json(jcfg.to_json())


def _wave(seed: int, n: int = 1600) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n)
            * 0.3).astype(np.float32)


class Case:
    """One model in both packages: the JAX config and params, the port's."""

    def __init__(self, jcfg, jparams, symbols):
        self.jcfg, self.jparams = jcfg, jparams
        self.cfg, self.params = port_cfg(jcfg), params_from_jax(jparams)
        self.ja = JAlphabet.from_symbols(list(symbols))
        self.ta = Alphabet.from_symbols(list(symbols))

    def pair(self, **kw):
        """(JAX transcriber, port transcriber) with the same options."""
        return (jserving.StreamingTranscriber(self.jparams, self.jcfg,
                                              self.ja, **kw),
                serving.StreamingTranscriber(self.params, self.cfg, self.ta,
                                             device="cpu", **kw))


@pytest.fixture(scope="module")
def ctc():
    jcfg = tiny_cfg()
    return Case(jcfg, jax_bilstm.init_params(jax.random.PRNGKey(3),
                                             jcfg.model), "abcdefg")


def _perturbed(jparams, seed: int = 7, w_scale: float = 1.0,
               b_scale: float = 2.0):
    """The CTC head's weights scaled and bias perturbed, so that posteriors
    vary per frame, the beams diverge and words split (a random init emits
    near-uniform blanks)."""
    rng = np.random.default_rng(seed)
    head = dict(jparams["ctc_head"])
    head["w"] = head["w"] * w_scale
    head["b"] = head["b"] + jnp.asarray(
        rng.standard_normal(head["b"].shape) * b_scale, head["b"].dtype)
    return {**jparams, "ctc_head": head}


@pytest.fixture(scope="module")
def beam_case(ctc):
    return Case(ctc.jcfg, _perturbed(ctc.jparams), "abcdefg")


def _offline_norm(jcfg, wave):
    """The valid feature cells' scalar (mean, var) with the zero-padded
    tail the offline batched reference reads (fixed-norm CMVN)."""
    from pg_asr_tpu.ops.features import extract_features

    w = jnp.asarray(np.pad(wave, (0, 512)))[None, :]
    feats, mask, _ = extract_features(
        w, jnp.asarray([len(wave)], jnp.int32), jcfg.features)
    cells = np.asarray(feats)[0][np.asarray(mask)[0] > 0]
    return float(cells.mean()), float(cells.var())


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_scan_from_matches_jax(dtype):
    """The carried forward scan: outputs and the final carry, masked steps
    inside and at the end (the carry frozen there). bfloat16: the XLA scan's
    per-operation rounding, reproduced by ops/lstm.xla_gate_step (equal
    bits on the CPU; bound one bf16 ulp of values below 1)."""
    rng = np.random.default_rng(1)
    B, T, H = 3, 7, 5
    xp = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    U = (rng.standard_normal((H, 4 * H)) * 0.4).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    mask = np.ones((B, T), np.float32)
    mask[1, 5:] = 0
    mask[2, 2] = 0
    mask[2, 6:] = 0
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ys, (h, c) = jserving._fwd_scan_from(
        jnp.asarray(xp, jdt), jnp.asarray(U, jdt), jnp.asarray(mask),
        jnp.asarray(h0, jdt), jnp.asarray(c0, jdt), H)
    tys, (th, tc) = serving._fwd_scan_from(
        torch.from_numpy(xp).to(tdt), torch.from_numpy(U).to(tdt),
        torch.from_numpy(mask), torch.from_numpy(h0).to(tdt),
        torch.from_numpy(c0).to(tdt))
    tol = TOL if dtype == "float32" else 2.0 ** -8
    for got, want in ((tys, ys), (th, h), (tc, c)):
        assert got.dtype == tdt
        _close(got, np.asarray(want, np.float32), tol)
    assert not tys[1, 5:].any() and not tys[2, 2].any()


@pytest.mark.parametrize("fixed", [False, True])
def test_window_features_and_running_norm_match_jax(ctc, fixed):
    fcfg = ctc.jcfg.features
    rng = np.random.default_rng(2)
    Wf = 12
    L = (Wf - 1) * fcfg.hop_length + fcfg.n_fft
    win = (rng.standard_normal((2, L)) * 0.3).astype(np.float32)
    want = np.stack([np.asarray(jserving._window_features(
        jnp.asarray(w[None]), fcfg))[0] for w in win])
    got = serving._window_features(torch.from_numpy(win), ctc.cfg.features)
    assert got.shape == (2, Wf, fcfg.n_mels)
    _close(got, want, 1e-4)  # log-mels of magnitude ~10
    n_valid, n_comm = np.array([12, 9]), np.array([8, 5])
    stats0 = (np.array([0.5, 3.0]), np.array([2.0, 1.5]), np.array([0., 16.]))
    x_t, st_t = serving._running_norm(
        got, *serving._frame_masks(got, torch.from_numpy(n_valid), 0,
                                   torch.from_numpy(n_comm)),
        tuple(torch.tensor(s, dtype=torch.float32) for s in stats0), fixed,
        torch.float32)
    for b in range(2):  # the JAX function is one stream's (scalar stats)
        idx = jnp.arange(Wf)[None, :]
        valid = (idx < n_valid[b]).astype(jnp.float32)
        comm = (idx < n_comm[b]).astype(jnp.float32)
        x_j, st_j = jserving._running_norm(
            jnp.asarray(got[b:b + 1].numpy()), valid, comm,
            tuple(jnp.float32(s[b]) for s in stats0), fixed, jnp.float32)
        _close(x_t[b:b + 1], x_j)
        for t, j in zip(st_t, st_j):
            _close(t[b:b + 1], np.asarray(j)[None])


def test_chunk_step_matches_jax(beam_case):
    """One _chunk_step mid-stream, a partial committed chunk, from a
    nonzero carry and running statistics: ids equal, the rest within
    TOL."""
    c = beam_case
    C, R = 8, 4
    fcfg = c.jcfg.features
    L = (C + R - 1) * fcfg.hop_length + fcfg.n_fft
    win = _wave(4, L)
    rng = np.random.default_rng(5)
    carries = [(rng.standard_normal((1, 16)).astype(np.float32) * 0.3,
                rng.standard_normal((1, 16)).astype(np.float32) * 0.3)
               for _ in range(2)]
    stats = (np.float32(-40.0), np.float32(900.0), np.float32(64.0))
    ids, lp, st, car = jserving._chunk_step(
        c.jparams, jnp.asarray(win)[None], tuple(map(jnp.float32, stats)),
        tuple((jnp.asarray(h), jnp.asarray(cc)) for h, cc in carries),
        jnp.int32(10), jnp.int32(6), c.jcfg, C, False)
    tids, tlp, tst, tcar = serving._chunk_step(
        c.params, torch.from_numpy(win)[None],
        tuple(torch.tensor([s]) for s in stats),
        tuple((torch.from_numpy(h), torch.from_numpy(cc))
              for h, cc in carries),
        torch.tensor([10]), torch.tensor([6]), c.cfg, C, False)
    assert tids[0].tolist() == np.asarray(ids).tolist()
    _close(tlp[0], lp)
    for t, j in zip(tst, st):
        _close(t, np.asarray(j)[None], 1e-4)  # sums of ~500 cells
    for (th, tc), (jh, jc) in zip(tcar, car):
        _close(th, jh)
        _close(tc, jc)


# --------------------------------------------------------------------------
# StreamingTranscriber end to end
# --------------------------------------------------------------------------

def _run(st, blocks) -> str:
    text = "".join(st.push(b) for b in blocks) + st.flush()
    assert st.text == text
    return text


def _splits(wave):
    return ([wave], np.array_split(wave, 7),
            [wave[:1], wave[1:400], wave[400:]])


@pytest.mark.parametrize("chunk,right,norm", [
    (8, 4, "streaming"), (6, 3, "fixed"), (29, 0, "streaming"),
    (8, 26, "fixed")])
def test_greedy_text_matches_jax(beam_case, chunk, right, norm):
    """Greedy text and ids chunk by chunk for several push block sizes;
    (29, 0): the whole utterance in one chunk; (8, 26): lookahead past
    the stream end with the utterance's own statistics."""
    c = beam_case
    wave = _wave(0)
    kw = dict(chunk_frames=chunk, right_context=right)
    if norm == "fixed":
        kw["norm"] = _offline_norm(c.jcfg, wave)
    texts = set()
    for blocks in _splits(wave):
        jst, tst = c.pair(**kw)
        got = _run(tst, blocks)
        assert got == _run(jst, blocks)
        assert tst._frames_done == jst._frames_done
        texts.add(got)
    assert len(texts) == 1 and texts.pop() != ""


def test_beam_state_partial_and_final_text_match_jax(beam_case):
    """decoder='beam': the carried beam after every push (prefixes and
    lengths equal, p_b and p_nb within TOL), partial_text and the emitted
    (final) text."""
    c = beam_case
    jst, tst = c.pair(chunk_frames=6, right_context=4, decoder="beam",
                      beam_size=BEAM_K, max_label_len=BEAM_L)
    sofar = ""
    for block in np.array_split(_wave(0), 5):
        got = tst.push(block)
        assert got == jst.push(block)
        sofar += got
        assert tst.partial_text == jst.partial_text
        assert tst.partial_text.startswith(sofar)
        P, Ln, pb, pnb = (t[0] for t in tst._beam_state)
        jP, jLn, jpb, jpnb = jst._beam_state
        assert P.tolist() == np.asarray(jP).tolist()
        assert Ln.tolist() == np.asarray(jLn).tolist()
        _close(pb, jpb)
        _close(pnb, jpnb)
    final = tst.flush()
    assert final == jst.flush()
    assert tst.text == jst.text == sofar + final != ""


def test_beam_full_lookahead_matches_jax(beam_case):
    c = beam_case
    wave = _wave(0)
    jst, tst = c.pair(chunk_frames=8, right_context=26,
                      norm=_offline_norm(c.jcfg, wave), decoder="beam",
                      beam_size=BEAM_K, max_label_len=BEAM_L)
    assert _run(tst, [wave]) == _run(jst, [wave]) != ""


def _lm_table(order: int) -> np.ndarray:
    from pg_asr_tpu.decoding.lm import train_char_ngram

    return train_char_ngram(["abcabc", "bca", "cabba", "abacaba", "bbcc",
                             "gfed"], JAlphabet.from_symbols(list("abcdefg")),
                            order=order)


@pytest.mark.parametrize("order", [2, 3])
def test_beam_lm_state_and_text_match_jax(beam_case, order):
    """decoder='beam' with lm= (n-gram shallow fusion): after every push
    the carried LM beam (prefixes, hash, contexts, lengths equal; p_b, p_nb
    and the cumulative LM scores within TOL), partial_text and the emitted
    text; then the flush."""
    c = beam_case
    kw = dict(chunk_frames=6, right_context=4, decoder="beam",
              beam_size=BEAM_K, max_label_len=BEAM_L, lm=_lm_table(order),
              lm_weight=0.4, length_bonus=0.1)
    jst, tst = c.pair(**kw)
    sofar = ""
    for block in np.array_split(_wave(0), 5):
        got = tst.push(block)
        assert got == jst.push(block)
        sofar += got
        assert tst.partial_text == jst.partial_text
        for i, (t, j) in enumerate(zip(tst._beam_state, jst._beam_state)):
            if i < 5:  # prefixes, hash, last, last2, lens
                assert t[0].tolist() == np.asarray(j).tolist(), i
            else:
                _close(t[0], j)
    final = tst.flush()
    assert final == jst.flush()
    assert tst.text == jst.text == sofar + final != ""


def _offline_fused(c, wave, tab) -> tuple[str, str]:
    """The offline fused search's text on the utterance's whole-batch
    log-probs: (port, JAX package)."""
    from pg_asr_tpu.decoding.beam import beam_decode as jax_beam_decode
    from pg_asr_tpu.decoding.greedy import ids_to_strings as jax_strings
    from pg_asr_tpu.ops.features import extract_features as jax_features
    from pg_asr_tpu_torch.decoding.beam import beam_decode
    from pg_asr_tpu_torch.decoding.greedy import ids_to_strings
    from pg_asr_tpu_torch.models import acoustic_forward
    from pg_asr_tpu_torch.ops.features import extract_features

    kw = dict(beam_size=BEAM_K, max_label_len=BEAM_L, lm=tab, lm_weight=0.4,
              length_bonus=0.1)
    w, ns = np.pad(wave, (0, 512))[None], np.array([len(wave)], np.int32)
    feats, mask, flens = extract_features(torch.from_numpy(w),
                                          torch.from_numpy(ns),
                                          c.cfg.features)
    lp, _, lens = acoustic_forward(c.params, feats, mask, flens, c.cfg)
    ids, n, _ = beam_decode(lp, lens, **kw)
    jf, jm, jl = jax_features(jnp.asarray(w), jnp.asarray(ns),
                              c.jcfg.features)
    jlp = jax_bilstm.apply(c.jparams, jf, jm, c.jcfg.model, train=False)
    jids, jn, _ = jax_beam_decode(jlp, jl, **kw)
    return (ids_to_strings(ids, n, c.ta)[0],
            jax_strings(jids, jn, c.ja)[0])


@pytest.mark.parametrize("order", [2, 3])
def test_beam_lm_full_lookahead_matches_offline(beam_case, order):
    """With fixed norm and lookahead to the stream end the streamed fused
    beam is the offline fused search (beam_decode(lm=...)) of the whole
    utterance, in the port as in the JAX package."""
    c = beam_case
    wave = _wave(0)
    tab = _lm_table(order)
    T = len(wave) // c.jcfg.features.hop_length + 1
    jst, tst = c.pair(chunk_frames=8, right_context=T,
                      norm=_offline_norm(c.jcfg, wave), decoder="beam",
                      beam_size=BEAM_K, max_label_len=BEAM_L, lm=tab,
                      lm_weight=0.4, length_bonus=0.1)
    streamed = _run(tst, [wave])
    assert streamed == _run(jst, [wave])
    assert (streamed, streamed) == _offline_fused(c, wave, tab)
    assert streamed != ""


@pytest.fixture(scope="module")
def rnnt():
    from pg_asr_tpu.models import transducer

    jcfg = tiny_cfg("transducer")
    return Case(jcfg, transducer.init_params(jax.random.PRNGKey(5), jcfg),
                "abcdefg")


@pytest.mark.parametrize("cap", [None, 3])
def test_transducer_matches_jax(rnnt, cap):
    """The BiLSTM-encoder transducer: text for two push splits at C=6,
    R=4, and with the whole-stream emission cap (decode.max_label_len=3)
    at full lookahead, where the cap binds."""
    wave = _wave(1)
    c = rnnt
    if cap is not None:
        jcfg = c.jcfg.replace(decode=DecodeConfig(max_label_len=cap))
        c = Case(jcfg, c.jparams, "abcdefg")
        kw = dict(chunk_frames=8, right_context=26,
                  norm=_offline_norm(jcfg, wave))
    else:
        kw = dict(chunk_frames=6, right_context=4)
    for blocks in _splits(wave)[:2]:
        jst, tst = c.pair(**kw)
        got = _run(tst, blocks)
        assert got == _run(jst, blocks) != ""
        assert tst._emitted == jst._emitted
    if cap is not None:
        assert len(got) == cap


@pytest.fixture(scope="module", params=["transformer", "conformer"])
def attn(request):
    from pg_asr_tpu.train import init_model_params

    jcfg = tiny_cfg(request.param)
    return Case(jcfg, init_model_params(jax.random.PRNGKey(7), jcfg),
                " abcdef")


def test_attention_matches_jax(attn):
    """Overlapping windows (chunk 8, lookahead 4, left context 16: the
    window's left context grows 0, 8, 16) through the family's encode(),
    with the port's flash attention off and on (the JAX package runs its
    dense path on the CPU either way), for two push splits: text, the
    frame accounting and the word timings (subframe times) equal."""
    wave = _wave(11)
    kw = dict(chunk_frames=8, right_context=4, left_context=16,
              timestamps=True)
    jst = jserving.StreamingTranscriber(attn.jparams, attn.jcfg, attn.ja,
                                        **kw)
    want = _run(jst, np.array_split(wave, 3))
    family = attn.cfg.model.family
    for flash in (False, True):
        fcfg = attn.cfg.replace(**{family: getattr(attn.cfg, family).__class__(
            **{**getattr(attn.cfg, family).__dict__,
               "flash_attention": flash})})
        for blocks in ([wave], np.array_split(wave, 3)):
            tst = serving.StreamingTranscriber(attn.params, fcfg, attn.ta,
                                               device="cpu", **kw)
            assert _run(tst, blocks) == want
            assert tst._frames_done == jst._frames_done == 26
            _same_words(tst.words, jst.words)
    assert want.strip() != ""


def _same_words(got, want):
    assert [w["word"] for w in got] == [w["word"] for w in want]
    for g, w in zip(got, want):
        assert (g["start"], g["end"]) == (w["start"], w["end"])
        assert abs(g["conf"] - w["conf"]) <= CONF_TOL


def test_timestamps_words_match_jax():
    """Word timings under the exactness setup (fixed norm, lookahead past
    the end), an alphabet with a space so that words split."""
    jcfg = tiny_cfg()
    jparams = jax_bilstm.init_params(jax.random.PRNGKey(3), jcfg.model)
    c = Case(jcfg, _perturbed(jparams, seed=1, w_scale=4.0, b_scale=1.0),
             " abcdef")
    wave = _wave(0)
    jst, tst = c.pair(chunk_frames=8, right_context=26,
                      norm=_offline_norm(jcfg, wave), timestamps=True)
    _run(jst, [wave])
    _run(tst, [wave])
    assert len(tst.words) > 1
    _same_words(tst.words, jst.words)
    tst.reset()
    assert tst.words == [] and tst.text == ""


@pytest.mark.parametrize("change,kw,error,match", [
    ({"family": "seq2seq"}, {}, ValueError, "no streaming path"),
    ({}, {"decoder": "nope"}, ValueError, "greedy or beam"),
    ({}, {"decoder": "beam", "timestamps": True}, ValueError, "timestamps"),
    ({"family": "conformer"}, {"decoder": "beam"}, ValueError, "recurrent"),
    ({"family": "transducer"}, {"timestamps": True}, ValueError,
     "label-synchronous"),
    ({"family": "transducer", "encoder": "conformer"}, {}, ValueError,
     "bilstm"),
    ({"family": "transformer", "num_experts": 2}, {}, ValueError, "MoE"),
    ({"kind": "mfcc"}, {}, ValueError, "logmel"),
    ({}, {"lm": np.zeros((9, 9), np.float32)}, ValueError,
     "LM fusion needs decoder='beam'"),
    ({}, {"length_bonus": 0.1}, ValueError, "length_bonus applies only"),
])
def test_validation_errors_match_jax(ctc, change, kw, error, match):
    """The JAX package's ValueErrors for the same configurations, LM
    fusion's (lm= without the beam, length_bonus without lm=) included."""
    jcfg = ctc.jcfg
    if "family" in change:
        jcfg = jcfg.replace(model=jcfg.model.__class__(
            **{**jcfg.model.__dict__, "family": change["family"]}))
    if "encoder" in change:
        jcfg = jcfg.replace(transducer=TransducerConfig(encoder="conformer"))
    if "num_experts" in change:
        jcfg = jcfg.replace(transformer=TransformerConfig(num_experts=2))
    if "kind" in change:
        jcfg = jcfg.replace(features=jcfg.features.__class__(
            **{**jcfg.features.__dict__, "kind": "mfcc"}))
    with pytest.raises(error, match=match):
        serving.StreamingTranscriber(ctc.params, port_cfg(jcfg), ctc.ta,
                                     device="cpu", **kw)
    if error is ValueError:
        with pytest.raises(ValueError, match=match):
            jserving.StreamingTranscriber(ctc.jparams, jcfg, ctc.ja, **kw)


def test_flush_empty_stream_and_push_after_flush(ctc):
    st = serving.StreamingTranscriber(ctc.params, ctc.cfg, ctc.ta,
                                      device="cpu")
    assert st.flush() == "" and st.flush() == ""
    with pytest.raises(RuntimeError, match="reset"):
        st.push(_wave(0))
