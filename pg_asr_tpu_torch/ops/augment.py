"""Train-time augmentation on the device (counterpart of
pg_asr_tpu/ops/augment.py): SpecAugment's time and frequency masks, and
speed perturbation, additive noise and gain on the waveform.

Each is a draw from an explicit ``torch.Generator`` (on the tensors'
device) and an apply that takes the draws as tensors, so a test can feed
the JAX package's draws to the port's apply. Static shapes and no host
synchronisation: masks come from ``arange`` comparisons, the speed change
is a ``torch.gather`` at ``arange(N) * f``. Plain PyTorch: the JAX package
computes these in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import torch

from ..config import SpecAugmentConfig

_INT32_MAX = 2 ** 31 - 1


def _randint(generator, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator, device=device,
                         dtype=torch.int32)


def _mask_draws(generator, n: int, width: int, span: torch.Tensor, B: int,
                device):
    """n masks per row: widths ~ U{0..width}, starts in [0, span - w]
    (``lo % max(span - w + 1, 1)`` of a draw up to int32 max, as JAX)."""
    if n == 0:
        empty = torch.zeros((0, B), dtype=torch.int32, device=device)
        return empty, empty
    w, lo = [], []
    for _ in range(n):
        w.append(_randint(generator, width + 1, (B,), device))
        lo.append(_randint(generator, _INT32_MAX, (B,), device))
    w, lo = torch.stack(w), torch.stack(lo)
    return lo % torch.clamp(span - w + 1, min=1), w


def spec_augment(feats: torch.Tensor, frame_mask: torch.Tensor,
                 generator: torch.Generator, cfg: SpecAugmentConfig
                 ) -> torch.Tensor:
    """SpecAugment of feats (B, T, F) with frame_mask (B, T) {0, 1}:
    per utterance `time_masks` spans of width U{0..time_width} inside the
    valid frames and `freq_masks` bands of width U{0..freq_width}, filled
    with the utterance's valid-frame mean; padding stays zero."""
    if cfg.time_masks + cfg.freq_masks == 0:
        return feats  # waveform-only augmentation
    B, _, F = feats.shape
    dev = feats.device
    valid = frame_mask.to(torch.int32).sum(1)
    full = torch.full((B,), F, dtype=torch.int32, device=dev)
    t_lo, t_w = _mask_draws(generator, cfg.time_masks, cfg.time_width,
                            valid, B, dev)
    f_lo, f_w = _mask_draws(generator, cfg.freq_masks, cfg.freq_width,
                            full, B, dev)
    return _spec_apply(feats, frame_mask, t_lo, t_w, f_lo, f_w)


def _band(lo: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: inside any of the spans [lo_j, lo_j + w_j) of each row
    (lo, w: (M, B))."""
    i = torch.arange(n, device=lo.device)[None, None, :]
    inside = (i >= lo[:, :, None]) & (i < (lo + w)[:, :, None])
    return inside.any(0)


def _spec_apply(feats, frame_mask, t_lo, t_w, f_lo, f_w) -> torch.Tensor:
    """The masks of (M, B) starts and widths applied to feats (B, T, F)."""
    B, T, F = feats.shape
    m = frame_mask.to(feats.dtype)[:, :, None]
    count = torch.clamp(m.sum((1, 2), keepdim=True) * F, min=1.0)
    fill = (feats * m).sum((1, 2), keepdim=True) / count
    dropped = _band(t_lo, t_w, T)[:, :, None] | _band(f_lo, f_w, F)[:, None, :]
    return torch.where(dropped, fill, feats) * m


def wave_augmented(cfg: SpecAugmentConfig) -> bool:
    """Whether a waveform option is set (the JAX package's ``wave_aug``)."""
    return (cfg.speed_min != 1.0 or cfg.speed_max != 1.0
            or cfg.noise_std > 0.0 or cfg.gain_db > 0.0)


def _uniform(generator, shape, lo: float, hi: float, device):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def wave_augment(wave: torch.Tensor, num_samples: torch.Tensor,
                 generator: torch.Generator, cfg: SpecAugmentConfig):
    """Speed perturbation (f ~ U[speed_min, speed_max], linear
    interpolation at i * f in the same (B, N) buffer, num_samples ->
    floor((ns - 1) / f) + 1), noise (std noise_std x each utterance's
    valid RMS) and gain (U[-gain_db, gain_db] dB), each per utterance and
    only when set. Returns (wave float32 (B, N), num_samples int32); int16
    PCM is scaled by 1/32768 first."""
    B, N = wave.shape
    dev = wave.device
    f = noise = g = None
    if cfg.speed_max > cfg.speed_min or cfg.speed_min != 1.0:
        f = _uniform(generator, (B, 1), cfg.speed_min, cfg.speed_max, dev)
    if cfg.noise_std > 0.0:
        noise = torch.randn((B, N), generator=generator, device=dev)
    if cfg.gain_db > 0.0:
        g = _uniform(generator, (B, 1), -cfg.gain_db, cfg.gain_db, dev)
    return _wave_apply(wave, num_samples, f, noise, g, cfg.noise_std)


def _wave_apply(wave, ns, f, noise, g, noise_std: float):
    """The transforms of the draws f (B, 1), noise (B, N), g (B, 1), each
    None when off, with the JAX package's operations in its order."""
    if not wave.is_floating_point():
        wave = wave.to(torch.float32) * (1.0 / 32768.0)
    wave = wave.to(torch.float32)
    B, N = wave.shape
    ns = ns.to(torch.int32)
    if f is not None:
        pos = torch.arange(N, dtype=torch.float32, device=wave.device)[None] * f
        lo = torch.clamp(torch.floor(pos).to(torch.int32), 0, N - 1)
        hi = torch.clamp(lo + 1, max=N - 1)
        frac = pos - lo.to(torch.float32)
        w_lo = torch.gather(wave, 1, lo.long())
        w_hi = torch.gather(wave, 1, hi.long())
        wave = w_lo * (1.0 - frac) + w_hi * frac
        ns = torch.floor((ns[:, None].to(torch.float32) - 1.0) / f)
        ns = torch.clamp(ns.to(torch.int32)[:, 0] + 1, 0, N)
    valid = (torch.arange(N, device=wave.device)[None] < ns[:, None]).to(
        torch.float32)
    if noise is not None:
        rms = torch.sqrt((wave * wave * valid).sum(1, keepdim=True)
                         / torch.clamp(valid.sum(1, keepdim=True), min=1.0))
        wave = wave + noise_std * rms * noise * valid
    if g is not None:
        wave = wave * torch.pow(10.0, g / 20.0)
    return wave * valid, ns
