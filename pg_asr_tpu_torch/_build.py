"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The
library is keyed on a hash of the sources and the compiler flags and lands in
``pg_asr_tpu_torch/_build/`` (listed in ``.gitignore``); a second process
finds it there and skips the build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME): "
                           "the CUDA kernels are built from source at first "
                           "use")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fo:
            h.update(fo.read())
    return os.path.join(BUILD_DIR, f"libpgasr_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        cu = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in cu]
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, src],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True), src)
                 for src, o in zip(cu, objs)]
        failed = []
        for proc, src in procs:  # wait for every compiler before raising
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib
