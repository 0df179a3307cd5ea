"""The port's augmentation (pg_asr_tpu_torch/ops/augment.py) and its sites
in ``train.compute_loss``, against pg_asr_tpu/ops/augment.py.

JAX's draws cannot be reproduced by a torch.Generator, so the applies
(``_spec_apply``, ``_wave_apply``) take the JAX package's draws from the
same key and must equal its functions (float32, max abs 1e-6: sums of the
same values in other orders, and powf / 10**x of another library); the
port's draws are held to their statistics.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pg_asr_tpu.config import Config as JConfig
from pg_asr_tpu.config import ModelConfig as JModelConfig
from pg_asr_tpu.config import SpecAugmentConfig as JAug
from pg_asr_tpu.ops import augment as jax_augment
from pg_asr_tpu_torch import train
from pg_asr_tpu_torch.config import Config, SpecAugmentConfig
from pg_asr_tpu_torch.models import acoustic_forward
from pg_asr_tpu_torch.ops import augment
from pg_asr_tpu_torch.ops.features import extract_features

INT32_MAX = int(jnp.iinfo(jnp.int32).max)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _feats(seed=0, B=4, T=37, F=20):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((B, T, F)) * 3 + 1).astype(np.float32)
    lens = np.array([T, 20, 5, 0][:B])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return feats * mask[:, :, None], mask, lens


def jax_spec_draws(key, cfg, valid, F, B):
    """pg_asr_tpu/ops/augment.spec_augment's draws, as (M, B) starts and
    widths for the time and the frequency masks."""
    keys = jax.random.split(key, 2 * (cfg.time_masks + cfg.freq_masks))
    out, ki = [], 0
    for n, width, span in ((cfg.time_masks, cfg.time_width, valid),
                           (cfg.freq_masks, cfg.freq_width, F)):
        lo_w = [], []
        for _ in range(n):
            w = jax.random.randint(keys[ki], (B,), 0, width + 1)
            lo = jax.random.randint(keys[ki + 1], (B,), 0, INT32_MAX)
            lo_w[0].append(lo % jnp.maximum(span - w + 1, 1))
            lo_w[1].append(w)
            ki += 2
        out += [_t(jnp.stack(x)) if x else
                torch.zeros((0, B), dtype=torch.int32) for x in lo_w]
    return out


@pytest.mark.parametrize("masks", [(2, 8, 2, 5), (3, 40, 0, 15),
                                   (0, 40, 2, 30)])
def test_spec_apply_on_jax_draws_equals_jax(masks):
    feats, mask, lens = _feats()
    tm, tw, fm, fw = masks
    cfg = JAug(enabled=True, time_masks=tm, time_width=tw, freq_masks=fm,
               freq_width=fw)
    key = jax.random.PRNGKey(sum(masks))
    want = np.asarray(jax_augment.spec_augment(jnp.asarray(feats),
                                               jnp.asarray(mask), key, cfg))
    draws = jax_spec_draws(key, cfg, jnp.asarray(lens, jnp.int32), 20, 4)
    got = augment._spec_apply(_t(feats), _t(mask), *draws).numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert (want != feats).any()  # something was masked


@pytest.mark.parametrize("opts", [
    dict(speed_min=0.9, speed_max=1.1, noise_std=0.1, gain_db=3.0),
    dict(speed_min=0.9, speed_max=1.1), dict(speed_min=1.2, speed_max=1.2),
    dict(noise_std=0.3), dict(gain_db=6.0)])
def test_wave_apply_on_jax_draws_equals_jax(opts):
    rng = np.random.default_rng(1)
    B, N = 4, 8000
    ns = np.array([8000, 5000, 1234, 0], np.int32)
    wave = np.where(np.arange(N)[None] < ns[:, None],
                    rng.integers(-20000, 20000, (B, N)), 0).astype(np.int16)
    cfg = JAug(enabled=True, **opts)
    key = jax.random.PRNGKey(7)
    want_w, want_ns = jax_augment.wave_augment(jnp.asarray(wave),
                                               jnp.asarray(ns), key, cfg)
    k_f, k_n, k_g = jax.random.split(key, 3)
    speed = cfg.speed_max > cfg.speed_min or cfg.speed_min != 1.0
    f = (_t(jax.random.uniform(k_f, (B, 1), jnp.float32, cfg.speed_min,
                               cfg.speed_max)) if speed else None)
    noise = (_t(jax.random.normal(k_n, (B, N), jnp.float32))
             if cfg.noise_std > 0 else None)
    g = (_t(jax.random.uniform(k_g, (B, 1), jnp.float32, -cfg.gain_db,
                               cfg.gain_db)) if cfg.gain_db > 0 else None)
    got_w, got_ns = augment._wave_apply(_t(wave), _t(ns), f, noise, g,
                                        cfg.noise_std)
    assert got_w.dtype == torch.float32 and got_ns.dtype == torch.int32
    assert np.array_equal(got_ns.numpy(), np.asarray(want_ns))
    assert np.abs(got_w.numpy() - np.asarray(want_w)).max() <= 1e-6


def test_spec_draws_statistics():
    """Widths in [0, width]; time masks inside each row's valid frames
    (start lo % max(valid - w + 1, 1)), bands inside the channels; masked
    cells hold the row's valid mean; padding stays zero; the draws differ
    by seed and repeat with it."""
    B, T, F = 64, 50, 24
    lens = np.random.default_rng(2).integers(0, T + 1, B)
    lens[:3] = [T, 3, 0]
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32))
    valid = mask.sum(1).to(torch.int32)
    g = torch.Generator().manual_seed(5)
    t_lo, t_w = augment._mask_draws(g, 4, 10, valid, B, "cpu")
    f_lo, f_w = augment._mask_draws(g, 3, 8, torch.full((B,), F), B, "cpu")
    assert t_w.min() >= 0 and t_w.max() <= 10 and f_w.max() <= 8
    assert len(set(t_w.flatten().tolist())) == 11  # every width drawn
    assert (t_lo >= 0).all() and (f_lo >= 0).all()
    fits = t_w <= valid
    assert ((t_lo + t_w)[fits] <= valid.expand_as(t_w)[fits]).all()
    assert (t_lo[~fits] == 0).all()
    assert (f_lo + f_w <= F).all()

    feats = torch.randn(B, T, F) * mask[:, :, None]
    out = augment._spec_apply(feats, mask, t_lo, t_w, f_lo, f_w)
    fill = feats.sum((1, 2)) / torch.clamp(valid * F, min=1)
    changed = (out != feats) & (mask[:, :, None] > 0)
    rows = changed.nonzero()[:, 0]
    assert len(rows) > 0
    torch.testing.assert_close(out[changed], fill[rows])
    assert (out[mask == 0] == 0).all()

    cfg = SpecAugmentConfig(enabled=True)
    a = augment.spec_augment(feats, mask, torch.Generator().manual_seed(1),
                             cfg)
    b = augment.spec_augment(feats, mask, torch.Generator().manual_seed(1),
                             cfg)
    c = augment.spec_augment(feats, mask, torch.Generator().manual_seed(2),
                             cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_wave_draws_statistics():
    B, N = 256, 4000
    ns = torch.full((B,), N, dtype=torch.int32)
    ns[:2] = torch.tensor([1, 0])
    wave = torch.randint(-3000, 3000, (B, N), dtype=torch.int16)
    cfg = SpecAugmentConfig(enabled=True, speed_min=0.8, speed_max=1.25)
    g = torch.Generator().manual_seed(3)
    out, got_ns = augment.wave_augment(wave, ns, g, cfg)
    f = torch.rand((B, 1), generator=torch.Generator().manual_seed(3)) \
        * (1.25 - 0.8) + 0.8
    assert (f >= 0.8).all() and (f <= 1.25).all()
    want = torch.clamp(torch.floor((ns[:, None].float() - 1) / f).int()[:, 0]
                       + 1, 0, N)
    assert torch.equal(got_ns, want)
    stretched = f[2:, 0] < 1  # past the buffer's end: clipped to N
    assert got_ns[1] == 0 and (got_ns[2:][stretched] == N).all()
    assert (out[torch.arange(N)[None] >= got_ns[:, None]] == 0).all()
    # gain: U[-g, g] dB on the whole row
    cfg = SpecAugmentConfig(enabled=True, gain_db=6.0)
    w = torch.full((B, N), 1000, dtype=torch.int16)
    out, _ = augment.wave_augment(w, torch.full((B,), N), g, cfg)
    db = 20 * torch.log10(out[:, 0] / (1000 / 32768))
    assert db.abs().max() <= 6.0 + 1e-4 and db.std() > 2.0


def _tiny_cfg(family="ctc", **aug) -> Config:
    jcfg = JConfig(model=JModelConfig(
        family=family, vocab_size=7, input_proj_dim=16, hidden_size=8,
        num_layers=1, dropout=0.2, use_pallas_lstm=False))
    cfg = Config.from_json(jcfg.to_json())
    if family == "transducer":
        cfg = cfg.replace(transducer=dataclasses.replace(
            cfg.transducer, encoder="bilstm", pred_embed_dim=8,
            pred_hidden=8, joint_dim=8))
    return cfg.replace(augment=SpecAugmentConfig(enabled=True, **aug))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ns = np.array([6400, 4000, 2500], np.int32)
    wave = np.where(np.arange(6400)[None] < ns[:, None],
                    rng.standard_normal((3, 6400)) * 3000, 0).astype(np.int16)
    labels = rng.integers(1, 7, (3, 5)).astype(np.int32)
    return [torch.from_numpy(a) for a in
            (wave, ns, labels, np.array([5, 3, 2], np.int32))]


@pytest.mark.parametrize("family", ["ctc", "transducer"])
def test_compute_loss_augments_at_the_jax_sites(family):
    """Waveform options then features then SpecAugment, drawn from the
    step's generator before the model's dropout, only with train=True and a
    generator: compute_loss equals that sequence written out, repeats with
    the seed, and without augmentation equals the loss of no augment."""
    cfg = _tiny_cfg(family, speed_min=0.9, speed_max=1.1, noise_std=0.1,
                    gain_db=3.0)
    params = train.init_model_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    wave, ns, labels, label_lens = batch = _batch()

    def loss(c, gen, train_=True):
        return train.compute_loss(params, *batch, c, train=train_,
                                  generator=gen, use_kernel=False).item()

    got = loss(cfg, torch.Generator().manual_seed(9))
    assert got == loss(cfg, torch.Generator().manual_seed(9))
    assert got != loss(cfg, torch.Generator().manual_seed(10))
    plain = cfg.replace(augment=SpecAugmentConfig())
    assert got != loss(plain, torch.Generator().manual_seed(9))
    assert (loss(cfg, torch.Generator().manual_seed(9), train_=False)
            == loss(plain, torch.Generator().manual_seed(9), train_=False))

    if family == "ctc":
        gen = torch.Generator().manual_seed(9)
        w, n = augment.wave_augment(wave, ns, gen, cfg.augment)
        feats, mask, fl = extract_features(w, n, cfg.features)
        feats = augment.spec_augment(feats, mask, gen, cfg.augment)
        lp, _, ol = acoustic_forward(params, feats, mask, fl, cfg,
                                     use_kernel=False, train=True,
                                     generator=gen)
        num, den = train.ctc_loss_terms(lp, ol, labels, label_lens)
        assert got == (num / torch.clamp(den, min=1.0)).item()

    # wave options alone: the JAX CLI's config (no feature masks)
    wave_only = cfg.replace(augment=dataclasses.replace(
        cfg.augment, time_masks=0, freq_masks=0))
    assert np.isfinite(loss(wave_only, torch.Generator().manual_seed(9)))
