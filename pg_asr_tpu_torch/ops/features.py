"""Batched audio feature frontend on the device (counterpart of
pg_asr_tpu/ops/features.py).

Waveform (int16 PCM or float) -> reflect pad -> STFT as ONE strided conv1d
against windowed DFT bases -> power -> mel filterbank matmul -> log (logmel
mode), or dB -> DCT-II -> delta + delta-delta (mfcc mode, 120 dims).

The numpy constructors below are copies of the JAX package's (its module
imports jax, which the port must not).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FeatureConfig


def hz_to_mel(f, scale: str = "htk"):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def mel_to_hz(m, scale: str = "htk"):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   scale: str = "htk", norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank, shape (n_fft//2 + 1, n_mels)."""
    fmax = fmax or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(fmin, scale), hz_to_mel(fmax, scale), n_mels + 2)
    f_pts = mel_to_hz(m_pts, scale)
    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, shape (n_mels, n_mfcc)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :]) * np.sqrt(2.0 / n_mels)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


def delta_kernel(n: int = 2) -> np.ndarray:
    """Regression delta coefficients over window 2n+1 (ComputeDeltas parity:
    win_length=5 <-> n=2)."""
    k = np.arange(-n, n + 1, dtype=np.float32)
    return k / np.sum(k * k)


def dft_conv_kernel(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT bases as a 1-D conv kernel, shape (2K, 1, n_fft)
    with K = n_fft//2 + 1: rows 0..K-1 are cos bases, K..2K-1 sin bases,
    each pre-multiplied by the (padded) Hann window."""
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    K = n_fft // 2 + 1
    k = np.arange(K, dtype=np.float64)[:, None]
    n = np.arange(n_fft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    cos_b = np.cos(ang) * window[None, :]
    sin_b = -np.sin(ang) * window[None, :]
    return np.concatenate([cos_b, sin_b], axis=0).astype(np.float32)[:, None, :]


def _constants(cfg: FeatureConfig, device: torch.device):
    """(DFT conv kernel, mel filterbank, DCT matrix or None) on `device`,
    cached; under torch.export made anew and not cached (the trace's
    tensors are its own: they become the exported program's constants)."""
    if torch.compiler.is_exporting():
        return _make_constants(cfg, device)
    return _cached_constants(cfg, device)


def _make_constants(cfg: FeatureConfig, device: torch.device):
    n_mels = 128 if cfg.kind == "mfcc" else cfg.n_mels
    kern = torch.from_numpy(dft_conv_kernel(cfg.n_fft, cfg.win_length))
    fb = torch.from_numpy(mel_filterbank(n_mels, cfg.n_fft, cfg.sample_rate,
                                         cfg.fmin, cfg.fmax, cfg.mel_scale))
    dct = (torch.from_numpy(dct_matrix(cfg.n_mfcc, n_mels))
           if cfg.kind == "mfcc" else None)
    return (kern.to(device), fb.to(device),
            None if dct is None else dct.to(device))


_cached_constants = functools.lru_cache(maxsize=16)(_make_constants)


@contextlib.contextmanager
def full_f32_conv():
    """cuDNN runs a float32 conv in TF32 by default; the JAX frontend runs
    this conv at Precision.HIGHEST, so turn TF32 off around it."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def _deltas(x: torch.Tensor, n: int = 2) -> torch.Tensor:
    """Delta features along time with edge replication. x: (B, T, C)."""
    k = delta_kernel(n)
    T = x.shape[1]
    xp = torch.cat([x[:, :1].expand(-1, n, -1), x,
                    x[:, -1:].expand(-1, n, -1)], dim=1)
    out = torch.zeros_like(x)
    for j in range(2 * n + 1):
        out = out + float(k[j]) * xp[:, j:j + T]
    return out


def extract_features(wave: torch.Tensor, num_samples: torch.Tensor,
                     cfg: FeatureConfig):
    """Batched waveforms -> (features (B,T,C), frame_mask (B,T), frame_lens (B,)).

    `wave` is a zero-padded (B, N) tensor, int16 PCM (converted on the
    device with x/32768) or float in [-1, 1]; `num_samples` holds the true
    sample counts. Everything runs on wave's device.
    """
    if not wave.dtype.is_floating_point:
        wave = wave.to(torch.float32) * (1.0 / 32768.0)
    wave = wave.to(torch.float32)
    num_samples = num_samples.to(device=wave.device, dtype=torch.int64)
    kern, fb, dct = _constants(cfg, wave.device)

    pad = cfg.n_fft // 2
    x = F.pad(wave[:, None, :], (pad, pad), mode="reflect")  # (B, 1, N + 2p)
    with full_f32_conv():
        spec = F.conv1d(x, kern, stride=cfg.hop_length)  # (B, 2K, F)
    K = cfg.n_fft // 2 + 1
    power = (spec[:, :K] ** 2 + spec[:, K:] ** 2).transpose(1, 2)  # (B, F, K)
    mel = power @ fb

    if cfg.kind == "mfcc":
        db = 10.0 * torch.log10(torch.clamp(mel, min=cfg.log_floor))
        feats = db @ dct
        if cfg.add_deltas:
            d1 = _deltas(feats, cfg.delta_window)
            d2 = _deltas(d1, cfg.delta_window)
            feats = torch.cat([feats, d1, d2], dim=-1)  # (B, F, 120)
    else:
        feats = torch.log(torch.clamp(mel, min=cfg.log_floor))

    F_ = feats.shape[1]
    frame_lens = torch.clamp(num_samples // cfg.hop_length + 1, max=F_)
    mask = (torch.arange(F_, device=wave.device)[None, :]
            < frame_lens[:, None]).to(feats.dtype)
    feats = feats * mask[:, :, None]
    return feats, mask, frame_lens.to(torch.int32)
