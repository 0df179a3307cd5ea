"""Batched multi-session streaming in the port
(serving.BatchedStreamingTranscriber) against the JAX package's, on the
same weights and seeded waves, at the JAX tests' tiny configuration: three
streams of different lengths opened and closed at staggered ticks in four
slots, a slot reused after its close, greedy and beam.

Parity bar, float32: every slot's text equal to the JAX server's and to
the port's single-stream transcriber on the same wave; the stacked LSTM
carries and norm statistics within 1e-5 of the JAX server's; an idle
slot's device state equal bit for bit before and after a tick (its masks
are all zeros). On the CPU the window's backward direction is the
lstm_fwd kernel's plain version (the kernel at B=S with an all-zero-mask
row: tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax

from pg_asr_tpu import serving as jserving
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import FeatureConfig, ModelConfig
from pg_asr_tpu.data.text import Alphabet as JAlphabet
from pg_asr_tpu.models import bilstm_ctc as jax_bilstm
from pg_asr_tpu_torch import serving
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.data import Alphabet

TOL = 1e-5
K, L = 4, 64
C, R = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(
        features=FeatureConfig(kind="logmel", n_mels=16, n_fft=128,
                               win_length=128, hop_length=64),
        model=ModelConfig(vocab_size=8, input_dim=16, input_proj_dim=32,
                          hidden_size=16, num_layers=2, dropout=0.0,
                          use_pallas_lstm=False))
    jparams = jax_bilstm.init_params(jax.random.PRNGKey(3), jcfg.model)
    # the CTC head perturbed so that the slots emit text and beams diverge
    rng = np.random.default_rng(7)
    head = dict(jparams["ctc_head"])
    head["b"] = head["b"] + (rng.standard_normal(head["b"].shape)
                             * 2.0).astype(np.float32)
    jparams = {**jparams, "ctc_head": head}
    symbols = list("abcdefg")
    rng = np.random.default_rng(0)
    waves = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (1600, 2300, 900, 1200)]
    return (jcfg, jparams, JAlphabet.from_symbols(symbols),
            Config.from_json(jcfg.to_json()), params_from_jax(jparams),
            Alphabet.from_symbols(symbols), waves)


def _schedule(srv, waves, check_idle=None):
    """Streams 0-2 open at once, pushed in blocks of 500 samples with a
    drain every round; stream 1 joins a round late; stream 0 is flushed
    and closed as soon as its audio is in, and its slot reopened for
    stream 3. -> {stream: text}."""
    slot, cursor, texts = {}, {}, {}
    slot[0], slot[2] = srv.open(), srv.open()
    cursor.update({0: 0, 2: 0})
    rnd = 0
    while cursor:
        if rnd == 1:
            slot[1], cursor[1] = srv.open(), 0
        for k in sorted(cursor):
            srv.push(slot[k], waves[k][cursor[k]:cursor[k] + 500])
            cursor[k] += 500
        if check_idle is not None:
            check_idle(srv, slot)
        srv.drain()
        for k in sorted(cursor):
            if cursor[k] >= len(waves[k]):
                srv.flush(slot[k])
                texts[k] = srv.text(slot[k])
                srv.close(slot[k])
                del cursor[k]
                if k == 0:
                    slot[3], cursor[3] = srv.open(), 0
                    assert slot[3] == slot[0]  # the slot is reused
        rnd += 1
    return texts


def _idle_freezes(srv, slot):
    """A tick leaves the free slot's device state exactly as it was."""
    free = [i for i in range(srv.slots) if not srv._is_open[i]]
    before = [t.clone() for t in srv._stats] + [
        t.clone() for hc in srv._carries for t in hc]
    srv.step()
    after = list(srv._stats) + [t for hc in srv._carries for t in hc]
    for b, a in zip(before, after):
        assert torch.equal(b[free], a[free])


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_batched_matches_jax_and_single_stream(setup, decoder):
    jcfg, jparams, ja, cfg, params, ta, waves = setup
    kw = dict(slots=4, chunk_frames=C, right_context=R, decoder=decoder,
              beam_size=K, max_label_len=L)
    srv = serving.BatchedStreamingTranscriber(params, cfg, ta, device="cpu",
                                              **kw)
    jsrv = jserving.BatchedStreamingTranscriber(jparams, jcfg, ja, **kw)
    got = _schedule(srv, waves, _idle_freezes)
    want = _schedule(jsrv, waves)
    assert got == want
    assert sum(len(t) for t in got.values()) > 0
    for k, wave in enumerate(waves):
        st = serving.StreamingTranscriber(params, cfg, ta, device="cpu",
                                          chunk_frames=C, right_context=R,
                                          decoder=decoder, beam_size=K,
                                          max_label_len=L)
        assert st.push(wave) + st.flush() == got[k], k
    for t, j in zip(srv._stats, jsrv._stats):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=1e-4)
    for (h, c), (jh, jc) in zip(srv._carries, jsrv._carries):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh)[:, 0], atol=TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc)[:, 0], atol=TOL)


def test_capacity_and_family_validation(setup):
    jcfg, jparams, ja, cfg, params, ta, waves = setup
    srv = serving.BatchedStreamingTranscriber(params, cfg, ta, slots=2,
                                              device="cpu")
    srv.open()
    srv.open()
    with pytest.raises(RuntimeError, match="busy"):
        srv.open()
    with pytest.raises(RuntimeError, match="not open"):
        serving.BatchedStreamingTranscriber(
            params, cfg, ta, slots=1, device="cpu").push(0, waves[0])
    for change, match in (({"family": "transformer"}, "CTC"),):
        bad = cfg.replace(model=cfg.model.__class__(
            **{**cfg.model.__dict__, **change}))
        with pytest.raises(ValueError, match=match):
            serving.BatchedStreamingTranscriber(params, bad, ta,
                                                device="cpu")
    with pytest.raises(ValueError, match="slots"):
        serving.BatchedStreamingTranscriber(params, cfg, ta, slots=0,
                                            device="cpu")
