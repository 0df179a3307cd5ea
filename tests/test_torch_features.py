"""Port's feature frontend (pg_asr_tpu_torch/ops/features.py) vs the JAX
extract_features, on the same seeded ragged waves.

Tolerance: atol 1e-4, plus rtol 1e-5. Both sides compute the conv-DFT
STFT, the mel matmul and the log in float32 (JAX at Precision.HIGHEST), so
they differ only in summation order. Log-mel values are O(10) and meet the
absolute bound alone; MFCC+deltas are dB values up to O(300), where one
float32 ulp is 3e-5 and a 128-term DCT sum differs by ~1e-6 relative, hence
the relative term.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import FeatureConfig
from pg_asr_tpu.ops.features import extract_features as jax_extract
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.ops import features as tfeat


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several worker
    processes), restored afterwards: importing this module changes no
    process-wide state."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waves(dtype, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([4000, 1234, 2801], np.int32)
    wave = np.zeros((3, 4000), np.float32)
    for i, n in enumerate(lens):
        wave[i, :n] = 0.3 * rng.standard_normal(n)
    if dtype == "int16":
        wave = np.clip(np.rint(wave * 32768.0), -32768, 32767).astype(np.int16)
    return wave, lens


@pytest.mark.parametrize("kind", ["logmel", "mfcc"])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_features_match_jax(kind, dtype):
    cfg = FeatureConfig(kind=kind)
    wave, lens = _waves(dtype)
    ref_f, ref_m, ref_l = jax_extract(jnp.asarray(wave), jnp.asarray(lens), cfg)
    port_cfg = Config.from_json(JConfig(features=cfg).to_json()).features
    got_f, got_m, got_l = tfeat.extract_features(
        torch.from_numpy(wave), torch.from_numpy(lens), port_cfg)
    assert got_f.shape == ref_f.shape == (3, 4000 // cfg.hop_length + 1,
                                         cfg.feature_dim)
    assert got_f.dtype == torch.float32
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=1e-5,
                               atol=1e-4)


def test_numpy_constants_match_jax_package():
    """The copied DSP constructors equal the JAX package's originals."""
    from pg_asr_tpu.ops import features as jfeat

    for args in [(80, 400, 16000), (128, 512, 8000, 20.0, 3000.0, "slaney",
                                    "slaney")]:
        np.testing.assert_array_equal(tfeat.mel_filterbank(*args),
                                      jfeat.mel_filterbank(*args))
    np.testing.assert_array_equal(tfeat.dct_matrix(40, 128),
                                  jfeat.dct_matrix(40, 128))
    np.testing.assert_array_equal(tfeat.dft_conv_kernel(400, 320),
                                  jfeat.dft_conv_kernel(400, 320))
    np.testing.assert_array_equal(tfeat.delta_kernel(2), jfeat.delta_kernel(2))
