"""The port's attention seq2seq family (pg_asr_tpu_torch/models/seq2seq.py,
losses.py, models/torch_import.py's seq2seq branch) vs the JAX package's
(pg_asr_tpu/models/seq2seq.py, losses.py, models/torch_import.py), on the
same seeded numpy inputs and the same weights (convert.params_from_jax).

Sizes: features 80 (the default log-mel), input projection 16, one BiLSTM
layer of 8 a direction, decoder embed 8 and LSTM 16 (= the encoder's 2 x
8, as dot attention needs), vocab 7; 3 utterances of 17, 11 and 5 valid
frames; targets of 6 steps; greedy and beam over 8 steps. The JAX results
are computed once per module.

Tolerances (float32, the same operations in another summation order):
teacher-forced and greedy log-probs atol 1e-5; the loss rtol 1e-5; each
parameter gradient atol 1e-5 x its largest reference value; the beam's
normalized scores rtol 1e-5. Tokens, lengths and the beams' order are
equal; a dead beam is compared by its score <= -1e29 alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu import losses as jlosses
from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from pg_asr_tpu.models import seq2seq as jseq
from pg_asr_tpu.models import torch_import as jimport
from pg_asr_tpu_torch import losses
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.models import seq2seq
from pg_asr_tpu_torch.models import torch_import
from pg_asr_tpu_torch.train import value_and_grad

A, F_DIM, T, TD, STEPS = 7, 80, 17, 6, 8
LENS = np.array([17, 11, 5], np.int32)
TARGET_LENS = np.array([6, 3, 0], np.int32)  # the last row is padding
# (K, EOS bias, steps): with the bias every beam ends inside the step
# budget; at K = 9 > A the first step has only A live candidates, so the
# other beams are dead (-1e30, equal after rounding: their ids follow the
# tie order), and they stay so when the search ends after that step
BEAMS = ((1, 0.0, STEPS), (3, 0.0, STEPS), (3, 2.5, STEPS), (9, 0.0, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENC = JModelConfig(family="seq2seq", vocab_size=A, input_dim=F_DIM,
                   input_proj_dim=16, hidden_size=8, num_layers=1,
                   dropout=0.0, use_pallas_lstm=False)
DEC = JSeq2SeqConfig(vocab_size=A, embed_dim=8, dec_hidden=16)
JCFG = JConfig(model=ENC, seq2seq=DEC)


def _port_enc():
    return Config.from_json(JCFG.to_json()).model


def _tree(seed=0, eos_bias=0.0):
    """The JAX init; eos_bias raises the output bias of id 0 (EOS), so
    that beams and greedy rows finish inside the step budget."""
    tree = jax.tree_util.tree_map(np.asarray, jseq.init_params(
        jax.random.PRNGKey(seed), ENC, DEC))
    tree["output"]["b"] = tree["output"]["b"].copy()
    tree["output"]["b"][0] += eos_bias
    return tree


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, T, F_DIM)).astype(np.float32)
    mask = (np.arange(T)[None] < LENS[:, None]).astype(np.float32)
    targets = rng.integers(1, A, (3, TD)).astype(np.int32)
    for b in range(3):
        targets[b, TARGET_LENS[b]:] = 0
    return feats, mask, targets


def _jax_tf_loss(tree, feats, mask, targets):
    lp = jseq.apply_teacher_forced(tree, feats, mask, targets, ENC, DEC)
    return jlosses.seq2seq_nll_loss(lp, targets, jnp.asarray(TARGET_LENS)), lp


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX result the tests compare with, computed once."""
    tree = _tree()
    feats, mask, targets = _inputs()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    (loss, lp), grads = jax.value_and_grad(_jax_tf_loss, has_aux=True)(
        jt, feats, mask, targets)
    toks, glp = jseq.greedy_generate(jt, feats, mask, ENC, DEC,
                                     max_steps=STEPS)
    beams = {}
    for k, bias, steps in BEAMS:
        t = jax.tree_util.tree_map(jnp.asarray, _tree(eos_bias=bias))
        enc = jseq.encode(t["encoder"], feats, mask, ENC)
        full = jseq.beam_scan_from_encoder(t, enc, mask, DEC, beam_size=k,
                                           max_steps=steps)
        best = jseq.beam_generate(t, feats, mask, ENC, DEC, beam_size=k,
                                  max_steps=steps)
        beams[k, bias, steps] = [np.asarray(x) for x in (*full, *best)]
    return {"tree": tree, "inputs": (feats, mask, targets),
            "loss": float(loss), "lp": np.asarray(lp),
            "grads": params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            grads)),
            "greedy": (np.asarray(toks), np.asarray(glp)), "beams": beams}


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("include_eos", [True, False])
def test_nll_terms_and_losses_match_jax(include_eos):
    """seq2seq_nll_terms (a zero-length row left out, the EOS slot in or
    out), seq2seq_nll_loss, summed_nll_loss (with and without the ignored
    id) and masked_mean_nll on the same log-probs."""
    rng = np.random.default_rng(1)
    lp = np.log(rng.dirichlet(np.ones(A), (4, 7))).astype(np.float32)
    targets = rng.integers(1, A, (4, 7)).astype(np.int32)
    lens = np.array([7, 3, 0, 5], np.int32)
    for b in range(4):
        targets[b, lens[b]:] = 0
    want = jlosses.seq2seq_nll_terms(lp, targets, lens, include_eos)
    got = losses.seq2seq_nll_terms(*_t(lp, targets, lens), include_eos)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert got[1].tolist() == ([3, 3, 3, 3, 2, 2, 1] if include_eos
                               else [3, 3, 3, 2, 2, 1, 1])
    pairs = [(losses.seq2seq_nll_loss(*_t(lp, targets, lens), include_eos),
              jlosses.seq2seq_nll_loss(lp, targets, lens, include_eos)),
             (losses.summed_nll_loss(*_t(lp, targets)),
              jlosses.summed_nll_loss(lp, targets)),
             (losses.summed_nll_loss(*_t(lp, targets), ignore_index=None),
              jlosses.summed_nll_loss(lp, targets, ignore_index=None)),
             (losses.masked_mean_nll(*_t(lp, targets)),
              jlosses.masked_mean_nll(lp, targets))]
    for g, w in pairs:
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


# ----------------------------------------------------------- teacher forced

def test_teacher_forced_log_probs_loss_and_gradients_match_jax(jax_results):
    r = jax_results
    feats, mask, targets = _t(*r["inputs"])
    params = params_from_jax(r["tree"])
    enc = _port_enc()

    def loss_fn(p):
        lp = seq2seq.apply_teacher_forced(p, feats, mask, targets, enc)
        return losses.seq2seq_nll_loss(lp, targets,
                                       torch.from_numpy(TARGET_LENS)), lp

    (loss, lp), grads = value_and_grad(loss_fn, params)
    assert lp.shape == (3, TD, A) and lp.dtype == torch.float32
    np.testing.assert_allclose(lp.detach().numpy(), r["lp"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=1e-5)
    assert set(grads) == set(r["grads"])
    for k, g in grads.items():
        ref = r["grads"][k].numpy()
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)
    # the inference form (no autograd) gives the same log-probs
    with torch.no_grad():
        lp2 = seq2seq.apply_teacher_forced(params, feats, mask, targets, enc)
    np.testing.assert_allclose(lp2.numpy(), lp.detach().numpy(), rtol=0,
                               atol=1e-6)


def test_hypotheses_share_their_utterances_states(jax_results):
    """decode_teacher_forced with K rows per utterance equals K calls with
    one row each (the rows attend over their own utterance's states)."""
    r = jax_results
    feats, mask, targets = _t(*r["inputs"])
    params = params_from_jax(r["tree"])
    with torch.no_grad():
        enc_out = seq2seq.encode(params, feats, mask, _port_enc())
        both = torch.stack([targets, targets.flip(1)], 1).reshape(6, TD)
        got = seq2seq.decode_teacher_forced(params, enc_out, mask, both)
        for k, tg in enumerate((targets, targets.flip(1))):
            one = seq2seq.decode_teacher_forced(params, enc_out, mask, tg)
            np.testing.assert_allclose(got.reshape(3, 2, TD, A)[:, k].numpy(),
                                       one.numpy(), rtol=0, atol=1e-6)


# -------------------------------------------------------------------- greedy

def test_greedy_matches_jax(jax_results):
    r = jax_results
    feats, mask, _ = _t(*r["inputs"])
    with torch.no_grad():
        toks, lp = seq2seq.greedy_generate(params_from_jax(r["tree"]), feats,
                                           mask, _port_enc(),
                                           max_steps=STEPS)
    want_toks, want_lp = r["greedy"]
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(seq2seq.generated_lengths(toks).numpy(),
                                  np.asarray(jseq.generated_lengths(
                                      want_toks)))


# ---------------------------------------------------------------------- beam

@pytest.mark.parametrize("k,bias,steps", BEAMS,
                         ids=["K1", "K3", "K3_early_eos", "K9_dead_beams"])
def test_beam_matches_jax(jax_results, k, bias, steps):
    """The whole n-best (tokens, lengths, normalized scores) and the best
    beam; with the EOS bias every beam finishes early; at K = 9 after one
    step some beams are dead."""
    feats, mask, _ = _t(*jax_results["inputs"])
    params = params_from_jax(_tree(eos_bias=bias))
    with torch.no_grad():
        enc = seq2seq.encode(params, feats, mask, _port_enc())
        got = seq2seq.beam_scan_from_encoder(params, enc, mask, beam_size=k,
                                             max_steps=steps)
        best = seq2seq.beam_generate(params, feats, mask, _port_enc(),
                                     beam_size=k, max_steps=steps)
    buf, lens, normed, b_tok, b_len, b_score = jax_results["beams"][
        k, bias, steps]
    np.testing.assert_array_equal(got[0].numpy(), buf)
    np.testing.assert_array_equal(got[1].numpy(), lens)
    live = normed > -1e29
    assert (got[2].numpy() > -1e29).tolist() == live.tolist()
    np.testing.assert_allclose(got[2].numpy()[live], normed[live], rtol=1e-5)
    np.testing.assert_array_equal(best[0].numpy(), b_tok)
    np.testing.assert_array_equal(best[1].numpy(), b_len)
    np.testing.assert_allclose(best[2].numpy(), b_score, rtol=1e-5)
    if bias:
        assert (lens < STEPS).all()
    assert (~live).any() == (k > A)


# ------------------------------------------------------------------- import

def _reference_state_dict(seed=3):
    """A reference Seq2Seq state dict of this module's sizes (the encoder
    as nn.LSTM(16, 8, bidirectional) behind Linear(80, 16), the decoder's
    embedding and LSTM(8, 16))."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    sd = {"encoder.input_layer.weight": r(16, F_DIM),
          "encoder.input_layer.bias": r(16)}
    for sfx in ("_l0", "_l0_reverse"):
        sd.update({f"encoder.blstm.weight_ih{sfx}": r(32, 16),
                   f"encoder.blstm.weight_hh{sfx}": r(32, 8),
                   f"encoder.blstm.bias_ih{sfx}": r(32),
                   f"encoder.blstm.bias_hh{sfx}": r(32)})
    sd.update({"decoder.embed_layer.weight": r(A, 8),
               "decoder.lstm.weight_ih_l0": r(64, 8),
               "decoder.lstm.weight_hh_l0": r(64, 16),
               "decoder.lstm.bias_ih_l0": r(64),
               "decoder.lstm.bias_hh_l0": r(64),
               "decoder.unused.weight": r(2)})
    return {f"module.{k}": v for k, v in sd.items()}


def test_torch_import_matches_jax(tmp_path):
    """init_from_torch_checkpoint's seq2seq branch on one saved reference
    state dict: the same tensors as the JAX package's (exact), the output
    linear left as it was, the same report."""
    path = str(tmp_path / "model_best.pth")
    torch.save(_reference_state_dict(), path)
    tree = _tree(seed=4)
    want, want_report = jimport.init_from_torch_checkpoint(path, tree, JCFG)
    params = params_from_jax(tree)
    got, report = torch_import.init_from_torch_checkpoint(
        path, params, Config.from_json(JCFG.to_json()))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["output.w"], params["output.w"])
    assert report == want_report
    assert "fresh (no torch source): output" in report
    assert "decoder.unused.weight" in report


def test_tree_order_is_the_jax_leaf_order():
    """train.tree_order sorts the seq2seq state dict's names in the order
    jax.tree.leaves walks the JAX tree (the order of optax's global norm,
    so the clip's float32 sum is the same)."""
    from pg_asr_tpu_torch.train import tree_order

    tree = _tree()
    want = ["".join(f".{getattr(k, 'key', getattr(k, 'idx', None))}"
                    for k in path)[1:]
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = sorted(params_from_jax(tree), key=tree_order)
    assert got == want
    assert got[:4] == ["dec_lstm.U", "dec_lstm.W", "dec_lstm.b", "embed"]
