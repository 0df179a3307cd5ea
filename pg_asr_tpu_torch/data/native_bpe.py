"""ctypes bindings of the native BPE segmenter (counterpart of
pg_asr_tpu/data/native_bpe.py).

The source is the repository's ``native/pgasr_bpe.cpp``: the Python
tokenizer's semantics (code-point split, the merges replayed in order,
unknown tokens as their known characters) with a thread per core and a
word cache. The port builds it at first use as it builds the WAV decoder
(``native_io.build_library``: g++ into the git-ignored
``pg_asr_tpu_torch/_build/``, keyed on a hash of the source and the flags)
and never loads the JAX package's ``native/libpgasr_bpe.so``. Nothing is
built at import time. Where no compiler is present ``native_available()``
is False and ``BpeAlphabet.encode_batch`` segments in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .native_io import build_library

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "pgasr_bpe.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_library(SOURCE))
        except (OSError, subprocess.SubprocessError):
            return None
        cpp = ctypes.POINTER(ctypes.c_char_p)
        lib.pgasr_bpe_create.restype = ctypes.c_void_p
        lib.pgasr_bpe_create.argtypes = [cpp, ctypes.c_int, cpp, cpp,
                                         ctypes.c_int]
        lib.pgasr_bpe_free.restype = None
        lib.pgasr_bpe_free.argtypes = [ctypes.c_void_p]
        lib.pgasr_bpe_encode_batch.restype = ctypes.c_int
        lib.pgasr_bpe_encode_batch.argtypes = [
            ctypes.c_void_p, cpp, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeBpe:
    """One compiled BPE model (built from a BpeAlphabet's tables)."""

    def __init__(self, symbols, merges):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native BPE segmenter could not be built "
                               f"from {SOURCE}")
        self._lib = lib
        toks = [s.encode() for s in symbols]
        arr = (ctypes.c_char_p * len(toks))(*toks)
        left = (ctypes.c_char_p * max(len(merges), 1))(
            *[a.encode() for a, _ in merges] or [b""])
        right = (ctypes.c_char_p * max(len(merges), 1))(
            *[b.encode() for _, b in merges] or [b""])
        # the library copies the strings: the arrays may go after create
        self._h = lib.pgasr_bpe_create(arr, len(toks), left, right,
                                       len(merges))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.pgasr_bpe_free(h)

    def encode_batch(self, texts,
                     n_threads: int | None = None) -> list[list[int]]:
        n = len(texts)
        if n == 0:
            return []
        # words split here by Python's unicode-aware str.split(): the C++
        # side splits on ASCII whitespace only
        norm = [" ".join(t.split()) for t in texts]
        sents = (ctypes.c_char_p * n)(*[t.encode() for t in norm])
        # an exact upper bound on ids a sentence: one per code point plus
        # a marker per word, so nothing is truncated
        max_len = max(max((2 * len(t) + 2 for t in norm), default=2), 8)
        out = np.zeros((n, max_len), np.int32)
        lens = np.zeros((n,), np.int32)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 8)
        rc = self._lib.pgasr_bpe_encode_batch(
            self._h, sents, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
        if rc != 0:
            raise RuntimeError(f"pgasr_bpe_encode_batch failed ({rc})")
        return [out[i, : lens[i]].tolist() for i in range(n)]
