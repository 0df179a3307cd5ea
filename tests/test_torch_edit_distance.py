"""The port's edit distances and rewards (pg_asr_tpu_torch/ops/
edit_distance.py, rl/reward.py) vs the JAX package's, on the same seeded
numpy inputs.

Tolerances: integer results (distances, prefix distances, word hashes, word
counts) equal bit for bit, int32; float results (CER, WER, rewards) within
1e-6 (one float32 division of the same integers).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pg_asr_tpu.ops import edit_distance as jed
from pg_asr_tpu.rl import reward as jreward
from pg_asr_tpu_torch import metrics
from pg_asr_tpu_torch.ops import edit_distance as ed
from pg_asr_tpu_torch.rl import reward


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _pairs(seed, B=9, Lr=7, Lh=11, A=4):
    """Padded id rows with lengths from 0 to the width (0-padded past them,
    as the batches are)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(1, A, (B, Lr)).astype(np.int32)
    hyp = rng.integers(1, A, (B, Lh)).astype(np.int32)
    rl = rng.integers(0, Lr + 1, B).astype(np.int32)
    hl = rng.integers(0, Lh + 1, B).astype(np.int32)
    rl[0], hl[0] = 0, 0  # both empty
    rl[1], hl[1] = Lr, Lh  # both full
    for b in range(B):
        ref[b, rl[b]:] = 0
        hyp[b, hl[b]:] = 0
    return ref, rl, hyp, hl


@pytest.mark.parametrize("Lr,Lh", [(7, 11), (12, 5), (6, 6)])
def test_edit_distance_matches_jax(Lr, Lh):
    """Either side the wider: the port walks the shorter one."""
    case = _pairs(Lr * Lh, Lr=Lr, Lh=Lh)
    want = np.asarray(jed.edit_distance(*_j(*case)))
    got = ed.edit_distance(*_t(*case))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # against the host DP, which the predict path scores with
    ref, rl, hyp, hl = case
    host = [metrics.edit_dist(list(ref[b, :rl[b]]), list(hyp[b, :hl[b]]))[0]
            for b in range(len(rl))]
    np.testing.assert_array_equal(got.numpy(), host)


def test_edit_distance_prefixes_match_jax_frozen_past_hyp_len():
    case = _pairs(3)
    want_d, want_p = map(np.asarray, jed.edit_distance_prefixes(*_j(*case)))
    got_d, got_p = ed.edit_distance_prefixes(*_t(*case))
    assert got_p.dtype == got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    hl = case[3]
    for b in range(len(hl)):  # the freeze past each row's hyp_len
        assert np.all(got_p.numpy()[b, hl[b]:] == got_d.numpy()[b])


def test_cer_matches_jax():
    case = _pairs(4)
    want = np.asarray(jed.cer_from_ids(*_j(*case)))
    np.testing.assert_allclose(ed.cer_from_ids(*_t(*case)).numpy(), want,
                               rtol=0, atol=1e-6)


def _char_rows(seed, B=6, L=40, space=1, A=30):
    """Rows with long words (their hash wraps around int32 many times),
    empty words (double, leading and trailing spaces) and a row of 0."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, A, (B, L)).astype(np.int32)
    lens = np.array([L, L, L - 7, 12, 0, 9], np.int32)[:B]
    ids[1, [0, 5, 6, L - 1]] = space  # leading, double and trailing spaces
    ids[2, L // 2] = space
    ids[3, :] = space  # all spaces: 13 empty words
    ids[5, [3, 7]] = space
    for b in range(B):
        ids[b, lens[b]:] = 0
    return ids, lens


def test_word_hashes_match_jax_with_int32_wraparound():
    ids, lens = _char_rows(5)
    want_h, want_c = map(np.asarray,
                         jed.word_hash_sequences(*_j(ids, lens), 1))
    got_h, got_c = ed.word_hash_sequences(*_t(ids, lens), 1)
    assert got_h.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    # a 40-char word overflows: h * 1_000_003 has wrapped
    assert want_h[0, 0] != 0 and np.any(want_h < 0)
    assert list(got_c.numpy()) == [1, 5, 2, 13, 1, 3]  # split(" ") counts


def test_word_hashes_of_a_short_word_are_the_plain_polynomial():
    got, count = ed.word_hash_sequences(torch.tensor([[3, 4, 1, 5]]),
                                        torch.tensor([4]), 1)
    assert count.tolist() == [2]
    assert got.tolist()[0][:2] == [4 * 1_000_003 + 5, 6]


def test_wer_matches_jax_and_the_host_split():
    ref, rl = _char_rows(6, L=24, A=5)
    hyp, hl = _char_rows(7, L=30, A=5)
    d_want, rw_want = map(np.asarray,
                          jed.word_edit_distance(*_j(ref, rl, hyp, hl), 1))
    d, rw = ed.word_edit_distance(*_t(ref, rl, hyp, hl), 1)
    np.testing.assert_array_equal(d.numpy(), d_want)
    np.testing.assert_array_equal(rw.numpy(), rw_want)
    want = np.asarray(jed.wer_from_ids(*_j(ref, rl, hyp, hl), 1))
    got = ed.wer_from_ids(*_t(ref, rl, hyp, hl), 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def words(row, n):
        chars = "".join(" " if c == 1 else chr(96 + c) for c in row[:n])
        return chars.split(" ")

    for b in range(len(rl)):
        dw, nw = metrics.edit_dist(words(ref[b], rl[b]), words(hyp[b], hl[b]))
        assert (dw, nw) == (int(d[b]), int(rw[b]))


@pytest.mark.parametrize("kind", ["neg_cer", "neg_wer"])
def test_sequence_reward_matches_jax(kind):
    ref, rl = _char_rows(8, L=20, A=6)
    hyp, hl = _char_rows(9, L=26, A=6)
    want = np.asarray(jreward.sequence_reward(*_j(ref, rl, hyp, hl), kind, 1))
    got = reward.sequence_reward(*_t(ref, rl, hyp, hl), kind, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_neg_wer_needs_the_space_id():
    case = _t(*_pairs(10))
    with pytest.raises(ValueError, match="space id"):
        reward.sequence_reward(*case, "neg_wer", -1)


def test_stepwise_reward_matches_jax():
    case = _pairs(11, Lr=6, Lh=13)
    want = np.asarray(jreward.stepwise_reward(*_j(*case)))
    got = reward.stepwise_reward(*_t(*case))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the rewards of a row sum to ED(ref, "") - ED(ref, hyp)
    d = ed.edit_distance(*_t(*case)).numpy()
    np.testing.assert_allclose(got.numpy().sum(1), case[1] - d, atol=1e-6)
