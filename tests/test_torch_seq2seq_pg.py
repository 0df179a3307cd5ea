"""Policy-gradient fine-tuning of the port's attention seq2seq family
(pg_asr_tpu_torch/rl/reinforce.py: SCST and MWER; models/seq2seq.py's
sampler) vs the JAX package's (pg_asr_tpu/rl/reinforce.py), on the same
seeded numpy inputs and the same weights (convert.params_from_jax).

JAX's draws cannot be reproduced in torch, so the SCST tests give the port
the tokens that JAX's own ``sample_from_encoder`` draws with the key its
SCST receives (a deterministic call, made here outside the loss):
``seq2seq.draw_tokens`` is monkeypatched to return them step by step. The
port's sampler is held by its statistics instead.

Sizes as tests/test_torch_seq2seq.py (vocab 7, one BiLSTM layer of 8 a
direction, decoder LSTM 16); 3 utterances of 17, 12 and 6 frames with 6,
4 and 0 labels (the last row is batch padding); S = 3 samples, K = 3
beams, 6 decoder steps. The JAX results are computed once per module.

Tolerances (float32, the same algorithms in another summation order):
losses and metrics rtol 1e-4, atol 1e-6; gradients atol 1e-5 x the
largest reference value of each tensor, as tests/test_torch_reinforce.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import RLConfig as JRLConfig
from pg_asr_tpu.config import Seq2SeqConfig as JSeq2SeqConfig
from pg_asr_tpu.models import seq2seq as jseq
from pg_asr_tpu.ops.features import extract_features as jax_features
from pg_asr_tpu.rl import reinforce as jrl
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax
from pg_asr_tpu_torch.models import seq2seq
from pg_asr_tpu_torch.rl import reinforce as rl
from pg_asr_tpu_torch.train import value_and_grad

A, S, K, SPACE = 7, 3, 3, 1
KEY = 3  # the PRNG key JAX's SCST samples with
BASELINES = ("greedy", "mean", "none")
REWARDS = ("neg_cer", "neg_wer")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**rl_kw) -> JConfig:
    return JConfig(
        model=JModelConfig(family="seq2seq", vocab_size=A, input_proj_dim=16,
                           hidden_size=8, num_layers=1, dropout=0.0,
                           use_pallas_lstm=False),
        seq2seq=JSeq2SeqConfig(vocab_size=A, embed_dim=8, dec_hidden=16),
        rl=JRLConfig(space_id=SPACE, num_samples=S, mwer_beam=K, **rl_kw))


def _batch(seed=0):
    """int16 waves of 17, 12 and 6 frames; labels with a space, the last
    row a padding row."""
    rng = np.random.default_rng(seed)
    ns = np.array([3200, 2200, 1000], np.int32)
    wave = np.where(np.arange(3200)[None] < ns[:, None],
                    rng.standard_normal((3, 3200)) * 3000, 0).astype(np.int16)
    labels = rng.integers(2, A, (3, 6)).astype(np.int32)
    label_lens = np.array([6, 4, 0], np.int32)
    labels[0, 2] = SPACE
    for b in range(3):
        labels[b, label_lens[b]:] = 0
    return wave, ns, labels, label_lens


def _tree():
    """The JAX init with the EOS bias raised, so that samples and beams
    end at varied lengths inside the 6 steps."""
    tree = jax.tree_util.tree_map(np.asarray, jseq.init_params(
        jax.random.PRNGKey(0), _jcfg().model, _jcfg().seq2seq))
    tree["output"]["b"] = tree["output"]["b"].copy()
    tree["output"]["b"][0] += 1.5
    return tree


def _jax_loss_and_grads(jcfg, tree, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jrl.pg_loss_fn(p, *map(jnp.asarray, batch),
                                 jax.random.PRNGKey(KEY), jcfg),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            params_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


def _jax_samples(tree, batch, jcfg):
    """The tokens JAX's SCST draws: its sample_from_encoder on its encoder
    states with the key pg_loss_fn hands on -> (S, B, L) int32."""
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    feats, fmask, _ = jax_features(jnp.asarray(batch[0]),
                                   jnp.asarray(batch[1]), jcfg.features)
    enc = jseq.encode(jt["encoder"], feats, fmask, jcfg.model)
    toks, _, _ = jseq.sample_from_encoder(
        jt, enc, fmask, jcfg.seq2seq, jax.random.PRNGKey(KEY), S,
        max_steps=batch[2].shape[1], temperature=jcfg.rl.temperature)
    return np.asarray(toks)


@pytest.fixture(scope="module")
def jax_results():
    tree, batch = _tree(), _batch()
    out = {"tree": tree, "batch": batch,
           "toks": _jax_samples(tree, batch, _jcfg())}
    for baseline in BASELINES:
        for reward in REWARDS:
            out["scst", baseline, reward] = _jax_loss_and_grads(
                _jcfg(baseline=baseline, reward=reward), tree, batch)
    for reward in REWARDS:
        out["mwer", reward] = _jax_loss_and_grads(
            _jcfg(objective="mwer", reward=reward), tree, batch)
    return out


def _replay(monkeypatch, toks):
    """seq2seq.draw_tokens returns JAX's (S, B, L) tokens, one step a
    call, in the sampler's row order (b * S + s)."""
    steps = iter(range(toks.shape[2]))

    def draw(generator, logits):
        t = next(steps)
        return torch.from_numpy(toks[:, :, t].T.reshape(-1).astype(np.int64))

    monkeypatch.setattr(seq2seq, "draw_tokens", draw)


def _port_loss_and_grads(jcfg, tree, batch):
    cfg = Config.from_json(jcfg.to_json())
    arrays = [torch.from_numpy(a) for a in batch]
    (loss, metrics), grads = value_and_grad(
        lambda p: rl.pg_loss_fn(p, *arrays, None, cfg), params_from_jax(tree))
    return loss.item(), {k: v.item() for k, v in metrics.items()}, grads


def _check_same(got, want):
    loss, metrics, grads = got
    r_loss, r_metrics, r_grads = want
    np.testing.assert_allclose(loss, r_loss, rtol=1e-4, atol=1e-6)
    assert set(metrics) == set(r_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, r_metrics[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        ref = r_grads[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


# --------------------------------------------------------------------- SCST

@pytest.mark.parametrize("reward", REWARDS)
@pytest.mark.parametrize("baseline", BASELINES)
def test_scst_loss_metrics_and_gradients_match_jax(monkeypatch, jax_results,
                                                   baseline, reward):
    """pg_loss_fn (SCST + entropy + the per-step NLL anchor) and every
    parameter gradient on JAX's sampled tokens."""
    r = jax_results
    toks = r["toks"]
    lens = np.asarray(jseq.generated_lengths(toks))
    assert len(set(lens.ravel().tolist())) > 1  # varied sample lengths
    _replay(monkeypatch, toks)
    got = _port_loss_and_grads(_jcfg(baseline=baseline, reward=reward),
                               r["tree"], r["batch"])
    _check_same(got, r["scst", baseline, reward])


def test_sampled_log_probs_are_teacher_forced_ones(monkeypatch, jax_results):
    """The sampler starts from id 0 and teacher forcing shifts right with
    BOS 0, so each sampled token's log-prob is the teacher-forced
    log-prob of the sampled sequence at that step."""
    r = jax_results
    toks = r["toks"]
    _replay(monkeypatch, toks)
    cfg = Config.from_json(_jcfg().to_json())
    params = params_from_jax(r["tree"])
    wave, ns = (torch.from_numpy(a) for a in r["batch"][:2])
    feats, fmask, _ = rl.extract_features(wave, ns, cfg.features)
    with torch.no_grad():
        enc = seq2seq.encode(params, feats, fmask, cfg.model)
        got, tok_lp, _ = seq2seq.sample_from_encoder(
            params, enc, fmask, None, S, max_steps=toks.shape[2])
        ids = got.transpose(0, 1).reshape(-1, toks.shape[2])  # b * S + s
        lp = seq2seq.decode_teacher_forced(params, enc, fmask, ids)
    np.testing.assert_array_equal(got.numpy(), toks)
    want = torch.gather(lp, 2, ids[..., None])[..., 0]
    np.testing.assert_allclose(tok_lp.transpose(0, 1).reshape(want.shape),
                               want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_sampler_frequencies_follow_the_tempered_softmax(jax_results,
                                                         temperature):
    """The first sampled token of 20 000 samples per utterance against
    softmax(lp / temperature) of the first step (greedy's log-probs):
    Pearson's chi-square with A - 1 = 6 degrees of freedom below 35, which
    a correct sampler exceeds with probability ~5e-6 per utterance
    (seeded); the second step's tokens are drawn from other posteriors."""
    r = jax_results
    cfg = Config.from_json(_jcfg().to_json())
    params = params_from_jax(r["tree"])
    wave, ns = (torch.from_numpy(a) for a in r["batch"][:2])
    feats, fmask, _ = rl.extract_features(wave, ns, cfg.features)
    n = 20000
    with torch.no_grad():
        enc = seq2seq.encode(params, feats, fmask, cfg.model)
        _, lp0 = seq2seq.greedy_from_encoder(params, enc, fmask, 1)
        toks, _, _ = seq2seq.sample_from_encoder(
            params, enc, fmask, torch.Generator().manual_seed(0), n,
            max_steps=2, temperature=temperature)
    p = torch.softmax(lp0[:, 0] / temperature, -1).numpy()
    for b in range(3):
        counts = np.bincount(toks[:, b, 0].numpy(), minlength=A)
        expect = n * p[b]
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        assert chi2 < 35.0, (b, chi2)
    assert not torch.equal(toks[:, :, 0], toks[:, :, 1])


# --------------------------------------------------------------------- MWER

@pytest.mark.parametrize("reward", REWARDS)
def test_mwer_loss_metrics_and_gradients_match_jax(jax_results, reward):
    """MWER over the decoder beam's n-best (K=3, re-scored teacher-forced
    in one decoder call) + the anchor: the loss, its metrics and every
    parameter gradient."""
    r = jax_results
    got = _port_loss_and_grads(_jcfg(objective="mwer", reward=reward),
                               r["tree"], r["batch"])
    _check_same(got, r["mwer", reward])


# ---------------------------------------------------------- combined terms

def test_combine_terms_sums_per_step_anchor_quotients():
    """_combine_terms with the seq2seq anchor's (Td,) numerators and
    denominators equals the JAX package's (a scalar, the sum of the
    per-step means); a scalar anchor (the CTC families, the transducer)
    gives the bits of num / den as before."""
    rng = np.random.default_rng(2)
    nums = {"pg": np.float32(1.7), "ent": np.float32(3.2),
            "ctc": rng.random(5).astype(np.float32) * 4}
    dens = {"pg": np.float32(6.0), "ent": np.float32(20.0),
            "ctc": np.array([3, 3, 2, 1, 0], np.float32)}
    jcfg = _jcfg()
    want = jrl._combine_terms({k: jnp.asarray(v) for k, v in nums.items()},
                              {k: jnp.asarray(v) for k, v in dens.items()},
                              jcfg.rl)
    port_rl = Config.from_json(jcfg.to_json()).rl
    t = {k: torch.tensor(v) for k, v in nums.items()}
    d = {k: torch.tensor(v) for k, v in dens.items()}
    got = rl._combine_terms(t, d, port_rl)
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    t["ctc"], d["ctc"] = t["ctc"].sum(), d["ctc"].sum()
    pg, ent = t["pg"] / d["pg"], t["ent"] / d["ent"]
    old = (pg - port_rl.entropy_weight * ent
           + port_rl.ctc_mix_weight * t["ctc"] / d["ctc"])
    assert torch.equal(rl._combine_terms(t, d, port_rl), old)
    no_anchor = dataclasses.replace(port_rl, ctc_mix_weight=0.0)
    assert torch.equal(rl._combine_terms(t, d, no_anchor),
                       pg - port_rl.entropy_weight * ent)
