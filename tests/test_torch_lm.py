"""LM fusion in the port (decoding/lm.py, decoding/neural_lm.py,
decoding/rescore.py and the LM branches of decoding/beam.py) against the
JAX package's, on the same numpy arrays and the same LM weights (carried
across by convert.params_from_jax), on CPU tensors (the plain paths; the
teacher-forced LM pass on the LSTM kernels: tests/test_torch_cuda.py,
chip_smoke.py phase 15).

Parity bars:
  * n-gram tables: equal bit for bit (the same numpy code);
  * the fused searches (n-gram and neural): labels and lens equal, nll
    within 1e-4 (the fused key is rounded as XLA's two multiply-adds, and
    the neural LM's cell differs by float32 rounding only);
  * lm_sequence_logp within 1e-5, its gradient and one training step
    within the bounds stated there;
  * rescoring: labels and lens equal, the combined score within 1e-4.
Posteriors are sharp (logits x 2) so that no two candidates come within
those bounds of each other.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.data import bpe as jbpe
from pg_asr_tpu.data.text import Alphabet as JAlphabet
from pg_asr_tpu.decoding import beam as jb
from pg_asr_tpu.decoding import lm as jlm
from pg_asr_tpu.decoding import neural_lm as jnlm
from pg_asr_tpu.decoding.rescore import rescore_nbest as jax_rescore
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.data import Alphabet
from pg_asr_tpu_torch.data import bpe as tbpe
from pg_asr_tpu_torch.decoding import beam as tb
from pg_asr_tpu_torch.decoding import lm as tlm
from pg_asr_tpu_torch.decoding import neural_lm as tnlm
from pg_asr_tpu_torch.decoding.rescore import rescore_nbest

NLL_TOL = 1e-4
SEQ_TOL = 1e-5
SYMBOLS = list("abcdefg ")
TEXTS = ["abc gab", "bad cafe", "face bead", "ace", "dab gag", "cab bed",
         "gaffe", "beg a cab"] * 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def alphabets():
    return JAlphabet.from_symbols(SYMBOLS), Alphabet.from_symbols(SYMBOLS)


@pytest.fixture(scope="module")
def lm_pair(alphabets):
    """A random LSTM LM at the default widths (embed 48, hidden 160, 2
    layers): (JAX tree, the port's state dict)."""
    jp = jnlm.init_lm_params(jax.random.PRNGKey(1), alphabets[0].size)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _log_probs(rng, B, T, S, sharp=2.0):
    x = rng.standard_normal((B, T, S)) * sharp
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _frame_lens(rng, B, T):
    fl = rng.integers(1, T + 1, B).astype(np.int32)
    fl[0], fl[1] = T, 1
    return fl


def _same_bits(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert (got.view(np.uint32) == want.view(np.uint32)).all()


# --------------------------------------------------------------------------
# n-gram tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("units", ["char", "bpe"])
@pytest.mark.parametrize("order", [2, 3])
def test_ngram_tables_equal_bit_for_bit(alphabets, order, units):
    if units == "char":
        ja, ta = alphabets
    else:
        ja, ta = jbpe.train_bpe(TEXTS, 24), tbpe.train_bpe(TEXTS, 24)
        assert ja.size == ta.size > len(SYMBOLS)
    got = tlm.train_char_ngram(TEXTS, ta, order=order, add_k=0.5)
    want = jlm.train_char_ngram(TEXTS, ja, order=order, add_k=0.5)
    _same_bits(got, want)
    assert tlm.score_prefix(got, ta.encode("cab")) == jlm.score_prefix(
        want, ja.encode("cab"))
    with pytest.raises(ValueError, match="order must be 2 or 3"):
        tlm.train_char_ngram(TEXTS, ta, order=4)


# --------------------------------------------------------------------------
# the fused searches
# --------------------------------------------------------------------------

FUSED_CASES = [  # (lm kind, lm_weight, length_bonus)
    ("ngram2", 0.5, 0.0), ("ngram3", 0.5, 0.0), ("ngram2", 0.0, 0.0),
    ("ngram3", 0.7, 0.3), ("neural", 0.5, 0.0), ("neural", 0.8, 0.2),
]


@pytest.mark.parametrize("kind,lam,beta", FUSED_CASES)
def test_fused_beam_matches_jax(alphabets, lm_pair, kind, lam, beta):
    """beam_decode(lm=...) / beam_decode(neural_lm=...) on ragged frame
    lengths (one utterance of a single frame); lm_weight 0 with a table is
    still the fused search (the JAX package's too)."""
    ja, _ = alphabets
    rng = np.random.default_rng(len(kind) * 7 + int(lam * 10))
    B, T, K, A = 5, 24, 6, ja.size
    lp, fl = _log_probs(rng, B, T, A), _frame_lens(rng, B, T)
    if kind == "neural":
        jkw, tkw = {"neural_lm": lm_pair[0]}, {"neural_lm": lm_pair[1]}
    else:
        tab = jlm.train_char_ngram(TEXTS, ja, order=int(kind[-1]))
        jkw, tkw = {"lm": tab}, {"lm": tab}
    want = jb.beam_decode(lp, fl, beam_size=K, max_label_len=T,
                          lm_weight=lam, length_bonus=beta, **jkw)
    got = tb.beam_decode(torch.from_numpy(lp), torch.from_numpy(fl),
                         beam_size=K, max_label_len=T, lm_weight=lam,
                         length_bonus=beta, **tkw)
    labels, lens, nll = (np.asarray(w) for w in want)
    assert (got[0].numpy() == labels).all() and (got[1].numpy() == lens).all()
    assert lens.max() > 2  # the search emits
    np.testing.assert_allclose(got[2].numpy(), nll, atol=NLL_TOL, rtol=0)


def test_zero_weight_fusion_is_the_acoustic_search(alphabets):
    """lm_weight 0: the fused search picks the plain exact search's best
    (the fused nll is its nll)."""
    ja, _ = alphabets
    rng = np.random.default_rng(5)
    lp = torch.from_numpy(_log_probs(rng, 3, 20, ja.size))
    fl = torch.tensor([20, 13, 7])
    tab = jlm.train_char_ngram(TEXTS, ja, order=2)
    plain = tb.beam_decode(lp, fl, beam_size=6, max_label_len=20, prune=None)
    fused = tb.beam_decode(lp, fl, beam_size=6, max_label_len=20, lm=tab,
                           lm_weight=0.0)
    for g, w in zip(fused, plain):
        assert torch.equal(g, w)


def test_lm_context_scores_are_table_rows(alphabets):
    ja, _ = alphabets
    A = ja.size
    tab = torch.from_numpy(jlm.train_char_ngram(TEXTS, ja, order=3))
    last = torch.tensor([[-1, 3, 5]])
    last2 = torch.tensor([[-1, -1, 2]])
    got = tb.lm_context_scores(tab, last, last2)
    want = jb.lm_context_scores(jnp.asarray(tab.numpy()),
                                jnp.asarray(last[0].numpy()),
                                jnp.asarray(last2[0].numpy()))
    _same_bits(got[0].numpy(), np.asarray(want))
    assert torch.equal(got[0, 2], tab[2, 5]) and got.shape == (1, 3, A)


@pytest.mark.parametrize("kw", [
    {"lm": "tab", "neural_lm": "nlm"}, {"neural_lm": "nlm", "impl": "buffer"},
    {"lm": "tab", "impl": "buffer"}, {"lm": "tab", "impl": "pallas"},
])
def test_guard_messages_match_jax(alphabets, lm_pair, kw):
    """The JAX package's ValueErrors, word for word."""
    ja, _ = alphabets
    tab = jlm.train_char_ngram(TEXTS, ja, order=2)
    lp = np.zeros((1, 3, ja.size), np.float32)
    fl = np.array([3], np.int32)

    def args(side):
        return {k: (tab if v == "tab" else lm_pair[side] if v == "nlm"
                    else v) for k, v in kw.items()}

    with pytest.raises(ValueError) as want:
        jb.beam_decode(lp, fl, **args(0))
    with pytest.raises(ValueError) as got:
        tb.beam_decode(torch.from_numpy(lp), torch.from_numpy(fl), **args(1))
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the neural LM
# --------------------------------------------------------------------------

def _seq_batch(rng, A, B=6, T=14):
    ids = rng.integers(1, A, (B, T)).astype(np.int32)
    lens = np.array([T, 0, 3, 9, 1, T - 2][:B], np.int32)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    return ids, lens


def test_lm_pieces_match_jax(alphabets, lm_pair):
    """lm_dims, lm_init_state, lm_next_logp and lm_advance (one gathered
    symbol per row vs the JAX package's one-hot) within 1e-5; the host
    oracle within 1e-5 of the JAX package's."""
    jp, tp = lm_pair
    A = alphabets[0].size
    assert tnlm.lm_dims(tp) == jnlm.lm_dims(jp) == (2, 160, A)
    js = jnlm.lm_init_state(jp, 4)
    ts = tnlm.lm_init_state(tp, 4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SEQ_TOL)
    sym = np.array([1, 4, 0, A - 1])
    js2 = jnlm.lm_advance(jp, js, jax.nn.one_hot(sym, A))
    ts2 = tnlm.lm_advance(tp, ts, torch.from_numpy(sym))
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=SEQ_TOL)
    got = tnlm.lm_next_logp(tp, ts2).numpy()
    want = np.asarray(jnlm.lm_next_logp(jp, js2))
    assert (got[:, 0] == tlm.NEG_LM).all() and (want[:, 0] == jlm.NEG_LM).all()
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=SEQ_TOL)
    ids = [3, 1, 7, 2]
    assert tnlm.score_prefix_neural(tp, ids) == pytest.approx(
        jnlm.score_prefix_neural(jp, ids), abs=SEQ_TOL)


def test_lm_sequence_logp_and_gradient_match_jax(alphabets, lm_pair):
    """log P(ids[:len]) per row within 1e-5 (rows of length 0 and T
    included) and the gradient of the training loss within 1e-5 absolute
    (gradients here are of order 1e-2); the oracle agrees per row."""
    jp, tp = lm_pair
    ids, lens = _seq_batch(np.random.default_rng(2), alphabets[0].size)
    want = np.asarray(jnlm.lm_sequence_logp(jp, jnp.asarray(ids),
                                            jnp.asarray(lens)))
    got = tnlm.lm_sequence_logp(tp, torch.from_numpy(ids),
                                torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=SEQ_TOL, rtol=0)
    assert got[1] == 0.0
    for i in (0, 2):
        assert got[i].item() == pytest.approx(
            tnlm.score_prefix_neural(tp, ids[i, :lens[i]]), abs=SEQ_TOL)

    def jloss(p):
        return -jnp.sum(jnlm.lm_sequence_logp(p, jnp.asarray(ids),
                                              jnp.asarray(lens))) / 35

    jg = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                jax.grad(jloss)(jp)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = -tnlm.lm_sequence_logp(leaves, torch.from_numpy(ids),
                                  torch.from_numpy(lens)).sum() / 35
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (k, g) in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jg[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    assert max(g.abs().max().item() for g in grads) > 1e-3


def test_train_step_from_carried_weights_matches_jax(alphabets, lm_pair,
                                                     monkeypatch):
    """Two steps of train_neural_lm from the same weights: the same batches
    (np.random.default_rng(seed)) and optax.adam(3e-3)'s update; the
    parameters within 2e-5 after the steps (an Adam step moves each by
    about lr, a sign-like function of its gradient)."""
    ja, ta = alphabets
    jp, tp = lm_pair
    monkeypatch.setattr(jnlm, "init_lm_params", lambda *a, **k: jp)
    want = jnlm.train_neural_lm(TEXTS, ja, steps=2, batch=8, seed=3)
    got = tnlm.train_neural_lm(TEXTS, ta, steps=2, batch=8, seed=3,
                               device="cpu", params=tp)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    moved = 0.0
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)
        moved = max(moved, (v - tp[k]).abs().max().item())
    assert moved > 1e-3
    with pytest.raises(ValueError, match="no transcripts"):
        tnlm.train_neural_lm(["", ""], ta, steps=1, device="cpu")


def test_init_save_load_and_the_jax_file(alphabets, lm_pair, tmp_path):
    """init_lm_params's shapes are the JAX init's; save_lm / load_lm round
    trip bit for bit; the JAX package's lm_neural.ckpt loads as its tree
    and back (params_to_jax); a file of other widths is refused."""
    ja, ta = alphabets
    jp, tp = lm_pair
    init = tnlm.init_lm_params(torch.Generator().manual_seed(0), ta.size)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}
    path = str(tmp_path / tnlm.LM_FILE)
    tnlm.save_lm(init, path)
    back = tnlm.load_lm(path, ta.size)
    assert all(torch.equal(back[k], v) for k, v in init.items())
    jpath = str(tmp_path / tnlm.JAX_LM_FILE)
    jnlm.save_lm(jp, jpath)
    got = tnlm.load_lm(jpath, ta.size)
    assert all(torch.equal(got[k], v) for k, v in tp.items())
    ids, lens = (jnp.asarray(a) for a in _seq_batch(
        np.random.default_rng(0), ta.size))
    _same_bits(np.asarray(jnlm.lm_sequence_logp(params_to_jax(got), ids,
                                                lens)),
               np.asarray(jnlm.lm_sequence_logp(jp, ids, lens)))
    assert tnlm.load_lm(str(tmp_path / "none.pt"), ta.size) is None
    with pytest.raises(ValueError, match="do not match"):
        tnlm.load_lm(path, ta.size, hidden=32)


# --------------------------------------------------------------------------
# rescoring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lam,beta", [(0.5, 0.0), (1.5, 0.4)])
def test_rescore_matches_jax(alphabets, lm_pair, lam, beta):
    """rescore_nbest: the exact K-best, one LM pass over its B*K rows and
    the combined argmax (dead slots never win; K=8 over 7 frames leaves
    dead slots in the first rows)."""
    jp, tp = lm_pair
    rng = np.random.default_rng(int(lam * 10))
    B, T, K = 4, 16, 8
    lp = _log_probs(rng, B, T, alphabets[0].size)
    fl = np.array([T, 2, 11, 7], np.int32)
    want = [np.asarray(w) for w in jax_rescore(
        lp, fl, jp, beam_size=K, max_label_len=T, lm_weight=lam,
        length_bonus=beta)]
    got = [g.numpy() for g in rescore_nbest(
        torch.from_numpy(lp), torch.from_numpy(fl), tp, beam_size=K,
        max_label_len=T, lm_weight=lam, length_bonus=beta)]
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    np.testing.assert_allclose(got[2], want[2], atol=NLL_TOL, rtol=0)
    assert np.isfinite(got[2]).all() and not math.isinf(got[2].min())
    # the winner is not always the acoustic best: the LM moved some row
    nbest = tb.beam_decode_nbest(torch.from_numpy(lp), torch.from_numpy(fl),
                                 beam_size=K, max_label_len=T)
    if lam > 1:
        assert (nbest[0][:, 0].numpy() != got[0]).any()


def test_rescore_on_a_cpu_tensor_runs_no_kernel(alphabets, lm_pair):
    """The plain path: the beam's and the LSTM's launch counters stay."""
    from pg_asr_tpu_torch.decoding import cuda_beam
    from pg_asr_tpu_torch.ops import cuda_lstm

    before = (cuda_beam.LAUNCHES, cuda_lstm.LAUNCHES)
    lp = torch.from_numpy(_log_probs(np.random.default_rng(0), 2, 9,
                                     alphabets[0].size))
    rescore_nbest(lp, torch.tensor([9, 4]), lm_pair[1], beam_size=4,
                  max_label_len=9)
    assert (cuda_beam.LAUNCHES, cuda_lstm.LAUNCHES) == before
