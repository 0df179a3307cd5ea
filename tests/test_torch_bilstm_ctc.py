"""Port's BiLSTM-CTC model, parameter bridge and greedy decoder vs the JAX
package, on the same seeded inputs and the same (converted) weights.

Tolerances: log-probs atol 1e-4 in float32 (same algorithm and precision,
summation order only, through two small BiLSTM layers); greedy ids and the
params_to_jax round trip must be exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig
from pg_asr_tpu.decoding import greedy as jax_greedy
from pg_asr_tpu.models import bilstm_ctc as jax_model
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.convert import params_from_jax, params_to_jax
from pg_asr_tpu_torch.decoding import greedy
from pg_asr_tpu_torch.models import bilstm_ctc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards: importing this module changes no
    process-wide state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFG = ModelConfig(vocab_size=11, input_dim=80, input_proj_dim=32,
                  hidden_size=16, num_layers=2, use_pallas_lstm=False)


def _port(model_cfg):
    """The port's ModelConfig from the JAX one's JSON (one schema)."""
    return Config.from_json(JConfig(model=model_cfg).to_json()).model


def _jax_params(seed=0):
    p = jax_model.init_params(jax.random.PRNGKey(seed), CFG)
    return jax.tree_util.tree_map(np.asarray, p)


def _batch(seed=0, B=4, T=30):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, CFG.input_dim)).astype(np.float32)
    lens = np.array([T, 17, 1, 24])[:B]
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return feats * mask[:, :, None], mask


def test_params_round_trip_is_exact():
    tree = _jax_params()
    state = params_from_jax(tree)
    assert set(state) == {"input_proj.w", "input_proj.b", "ctc_head.w",
                          "ctc_head.b"} | {
        f"lstm.{i}.{d}.{n}" for i in range(2) for d in ("fwd", "bwd")
        for n in ("W", "U", "b")}
    back = params_to_jax(state)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_params_shapes_and_distributions_match_jax():
    cfg = ModelConfig(vocab_size=11, input_dim=80, input_proj_dim=256,
                      hidden_size=64, num_layers=2)
    got = bilstm_ctc.init_params(_port(cfg), torch.Generator().manual_seed(0))
    ref_big = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(1), cfg)))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref_big.items()}
    for k, v in got.items():
        r = ref_big[k]
        assert v.dtype == torch.float32
        if k.endswith(".b"):  # deterministic biases: equal exactly
            torch.testing.assert_close(v, r, rtol=0, atol=0)
        else:  # same distribution: bounds and spread agree
            assert abs(v.std().item() - r.std().item()) < 0.1 * r.std().item()
            assert v.abs().max() <= r.abs().max() * 1.5 + 1e-6


def test_apply_matches_jax():
    tree = _jax_params()
    feats, mask = _batch()
    ref = jax_model.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(feats), jnp.asarray(mask), CFG)
    got = bilstm_ctc.apply(params_from_jax(tree), torch.from_numpy(feats),
                           torch.from_numpy(mask), _port(CFG))
    assert got.shape == (4, 30, CFG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert np.all(got.numpy()[mask == 0] == 0.0)


def test_normalize_features_matches_jax():
    feats, mask = _batch(1)
    ref = jax_model.normalize_features(jnp.asarray(feats), jnp.asarray(mask))
    got = bilstm_ctc.normalize_features(torch.from_numpy(feats),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_ids_match_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, A = 4, 40, 6
    # few symbols + repeats + blanks exercise the collapse
    lp = rng.standard_normal((B, T, A)).astype(np.float32)
    lp[:, ::3, 0] += 3.0
    mask = (np.arange(T)[None] < np.array([40, 13, 1, 0])[:, None]).astype(
        np.float32)
    ref_l, ref_n = jax_greedy.greedy_decode(jnp.asarray(lp), jnp.asarray(mask))
    got_l, got_n = greedy.greedy_decode(torch.from_numpy(lp),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))


def test_greedy_ties_take_the_first_maximum():
    lp = np.zeros((1, 4, 3), np.float32)  # three-way ties, frame 1 two-way
    lp[0, 1] = [0.0, 1.0, 1.0]
    mask = np.ones((1, 4), np.float32)
    ref_l, ref_n = jax_greedy.greedy_decode(jnp.asarray(lp), jnp.asarray(mask))
    got_l, got_n = greedy.greedy_decode(torch.from_numpy(lp),
                                        torch.from_numpy(mask))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    assert got_l[0, 0].item() == 1 and got_n.item() == 1


def test_ids_to_strings():
    from pg_asr_tpu.data.text import Alphabet as JAlphabet
    from pg_asr_tpu_torch.data import Alphabet

    labels = torch.tensor([[1, 2, 3, 4], [4, 0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([4, 1], dtype=torch.int32)
    assert greedy.ids_to_strings(labels, lens,
                                 Alphabet.from_symbols("ab c")) == \
        jax_greedy.ids_to_strings(labels.numpy(), lens.numpy(),
                                  JAlphabet.from_symbols("ab c")) == \
        ["ab c", "c"]
