"""ctypes bindings of the native C++ WAV decoder (counterpart of
pg_asr_tpu/data/native_io.py).

The source is the repository's ``native/pgasr_io.cpp``. The port builds it
with the host C++ compiler at first use into its own
``pg_asr_tpu_torch/_build/`` (git-ignored), keyed on a hash of the source
and the flags, and never loads the JAX package's ``native/libpgasr_io.so``.
Host code: the decoder fills numpy buffers that the trainer then copies to
the device. Nothing is built at import time.

  * ``native_available()`` -> whether the library built and loaded;
  * ``wav_info(path)`` -> (sample_rate, n_samples), a header-only read;
  * ``read_wav(path)`` -> (float32 samples, sample_rate);
  * ``resample(x, n_out)`` -> linear resample (np.interp semantics);
  * ``load_batch(paths, stride, ...)`` / ``load_batch_i16(...)`` -> one
    threaded call decoding a zero-padded (N, stride) float32 / int16 batch.

Where no compiler is present ``native_available()`` is False and the loader
decodes in Python (``data/audio.read_wav``); ``BatchIterator.decoded``
counts the batches each decoder built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "pgasr_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fo:
        h.update(fo.read())
    return os.path.join(BUILD_DIR, f"libpgasr_io_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile into a temporary file and rename it into place, so that a
    concurrent process never loads a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        SOURCE, "-lpthread"],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError):
            return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.pgasr_read_wav.restype = ctypes.c_long
        lib.pgasr_read_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            c_int_p]
        lib.pgasr_wav_info.restype = ctypes.c_int
        lib.pgasr_wav_info.argtypes = [
            ctypes.c_char_p, c_int_p, ctypes.POINTER(ctypes.c_long)]
        lib.pgasr_resample_linear.restype = None
        lib.pgasr_resample_linear.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        for fn, elem in ((lib.pgasr_load_batch_rs, ctypes.c_float),
                         (lib.pgasr_load_batch_i16, ctypes.c_int16)):
            # (paths, n, out, stride, lens, rates, max_samples, threads,
            #  target_rate)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                           ctypes.POINTER(elem), ctypes.c_long, c_int_p,
                           c_int_p, ctypes.c_long, ctypes.c_int,
                           ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("native WAV decoder unavailable (no C++ compiler "
                           f"could build {SOURCE})")
    return lib


def wav_info(path: str) -> tuple[int, int]:
    """(sample_rate, n_samples) from the header, without decoding."""
    lib = _lib_or_raise()
    sr, n = ctypes.c_int(0), ctypes.c_long(0)
    rc = lib.pgasr_wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"pgasr_wav_info({path!r}) failed with {rc}")
    return sr.value, n.value


def read_wav(path: str, max_samples: int = 0) -> tuple[np.ndarray, int]:
    """Mono float32 samples in [-1, 1] and the sample rate."""
    lib = _lib_or_raise()
    if max_samples <= 0:
        max_samples = max(wav_info(path)[1], 1)
    out = np.zeros(max_samples, np.float32)
    sr = ctypes.c_int(0)
    n = lib.pgasr_read_wav(path.encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           max_samples, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"pgasr_read_wav({path!r}) failed with {n}")
    return out[:n], sr.value


def resample(x: np.ndarray, n_out: int) -> np.ndarray:
    """Linear resample to n_out samples (np.interp semantics)."""
    lib = _lib_or_raise()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(n_out, np.float32)
    lib.pgasr_resample_linear(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out)
    return out


def _batch(fn, elem, dtype, paths, stride, n_threads, target_rate,
           max_samples):
    n = len(paths)
    out = np.zeros((n, stride), dtype)
    lens = np.zeros(n, np.int32)
    srs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    threads = n_threads or min(8, os.cpu_count() or 1)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    rc = fn(arr, n, out.ctypes.data_as(ctypes.POINTER(elem)), stride,
            lens.ctypes.data_as(c_int_p), srs.ctypes.data_as(c_int_p),
            max_samples or stride, threads, target_rate)
    if rc < 0:
        bad = [paths[i] for i in range(n) if lens[i] == 0]
        raise IOError(f"native batch load: {-rc} file(s) failed, e.g. "
                      f"{bad[:3]}")
    return out, lens, srs


def load_batch(paths: list[str], stride: int, max_samples: int = 0,
               n_threads: int | None = None, target_rate: int = 0):
    """Decode `paths` into a zero-padded (N, stride) float32 buffer in C++
    worker threads, resampling rate-mismatched files to target_rate (> 0).
    Returns (batch, lens (N,), sample_rates (N,))."""
    lib = _lib_or_raise()
    return _batch(lib.pgasr_load_batch_rs, ctypes.c_float, np.float32, paths,
                  stride, n_threads, target_rate, max_samples)


def load_batch_i16(paths: list[str], stride: int,
                   n_threads: int | None = None, target_rate: int = 0):
    """As ``load_batch`` into int16 PCM: a mono 16-bit file at the target
    rate is one fread a row; other formats decode in float and quantise
    (round half to even, as ``np.rint``). Returns (batch, lens, rates)."""
    lib = _lib_or_raise()
    return _batch(lib.pgasr_load_batch_i16, ctypes.c_int16, np.int16, paths,
                  stride, n_threads, target_rate, 0)
