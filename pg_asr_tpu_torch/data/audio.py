"""Host-side WAV IO and synthetic audio (counterpart of
pg_asr_tpu/data/audio.py). numpy only; WAV is the one container ported
(the JAX package's optional soundfile branch for FLAC/OGG is not).
``load_audio`` prefers the native decoder (``native_io``)."""

from __future__ import annotations

import os
import wave as _wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file to mono float32 in [-1, 1]. Returns (samples, rate)."""
    with _wave.open(path, "rb") as w:
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        sr = w.getframerate()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1,1] samples as PCM16 WAV."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with _wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def load_audio(path: str, decoder: str = "auto") -> tuple[np.ndarray, int]:
    """(float32 samples, rate) of a WAV file, by the native C++ decoder
    (``native_io``) unless `decoder` is "python" or it cannot be built, as
    the JAX package's ``default_loader``; both give the same samples."""
    if os.path.splitext(path)[1].lower() == ".wav":
        if decoder != "python":
            from . import native_io

            if native_io.native_available():
                return native_io.read_wav(path)
            if decoder == "native":
                raise RuntimeError("the native WAV decoder could not be "
                                   f"built ({native_io.SOURCE})")
        return read_wav(path)
    raise NotImplementedError(
        f"cannot decode {path!r}: only WAV is ported to pg_asr_tpu_torch "
        "(see ROADMAP.md)")


def synth_utterance(rng: np.random.Generator, duration_s: float,
                    sample_rate: int = 16000) -> np.ndarray:
    """Deterministic synthetic speech-like waveform: a few gliding tones over
    pink-ish noise (the same draws as the JAX package's, so one seed gives
    one corpus in both packages)."""
    n = int(duration_s * sample_rate)
    t = np.arange(n, dtype=np.float32) / sample_rate
    x = np.zeros(n, dtype=np.float32)
    for _ in range(3):
        f0 = rng.uniform(80.0, 350.0)
        glide = rng.uniform(-30.0, 30.0)
        x += rng.uniform(0.1, 0.3) * np.sin(
            2 * np.pi * (f0 * t + 0.5 * glide * t * t)
        ).astype(np.float32)
    noise = rng.standard_normal(n).astype(np.float32)
    pink = np.cumsum(noise) / np.sqrt(np.arange(1, n + 1, dtype=np.float32))
    x += 0.05 * (pink - pink.mean()).astype(np.float32)
    peak = np.max(np.abs(x)) or 1.0
    return (0.7 * x / peak).astype(np.float32)
