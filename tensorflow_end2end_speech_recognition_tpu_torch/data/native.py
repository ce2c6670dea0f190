"""ctypes bindings for the port's C++ host runtime (``csrc/asr_native.cpp``).

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/data/native.py``.
The library is built with the host compiler (``g++ -O3 -std=c++17 -shared
-fPIC -pthread``, not nvcc) into the package's ``_build/`` at first use,
named by a hash of the source and the flags; the JAX package's checked-in
``native/libasr_native.so`` is never loaded. It exposes:

- :func:`batch_assemble`: multithreaded pad and gather of utterance buffers
  into one contiguous batch;
- :func:`levenshtein_batch`: batched token edit distance with S/I/D counts.

Every entry point keeps the reference's numpy / Python fallback (the same
bits), taken when no compiler is found or the library fails the ABI check;
:func:`have_native` reports which path runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..utils.edit_distance import levenshtein_batch as _levenshtein_batch_py

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "asr_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1


def library_path() -> Path:
    """``_build/libasr_native_<hash>.so``, the hash over the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libasr_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless it is built already; raise with the
    compiler's output on a failure. Links under a temporary name, then
    renames: a concurrent process never loads a half-written library."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++ or c++ on PATH, or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / lib.name
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{cxx} failed (exit {out.returncode}):\n{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, load, declare the entry points and check the ABI;
    raise on any failure (``have_native`` turns that into False)."""
    lib = ctypes.CDLL(str(build()))
    lib.batch_assemble.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.batch_assemble.restype = None
    lib.levenshtein_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.levenshtein_batch.restype = None
    lib.asr_native_abi_version.restype = ctypes.c_int32
    version = lib.asr_native_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"asr_native ABI version {version}, expected {ABI_VERSION}")
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    try:
        return load_library()
    except Exception:  # no compiler, a failed build or a wrong ABI: the numpy paths
        return None


def have_native() -> bool:
    """Whether the C++ runtime runs (else the numpy / Python fallbacks)."""
    return _lib() is not None


def batch_assemble(utts: list[np.ndarray], t_pad: int,
                   n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad and stack float32 waveforms [N] or feature matrices [T, D] ->
    ([B, t_pad(, D)], int32 lengths); the pad region is zero."""
    b = len(utts)
    dim = 1 if utts[0].ndim == 1 else utts[0].shape[-1]
    lens = np.asarray([u.shape[0] for u in utts], np.int32)
    if lens.size and int(lens.max()) > t_pad:
        # the C++ side copies lens[i] rows into a t_pad row: a bad t_pad must
        # be an error here, not a write past the row
        raise ValueError(f"utterance length {int(lens.max())} exceeds t_pad {t_pad}")
    lib = _lib()
    if lib is not None:
        utts = [np.ascontiguousarray(u, np.float32) for u in utts]
        out = np.empty((b, t_pad, dim), np.float32)
        ptrs = (ctypes.c_void_p * b)(*[u.ctypes.data_as(ctypes.c_void_p).value for u in utts])
        lib.batch_assemble(ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
                           lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                           b, dim, t_pad, out.ctypes.data_as(ctypes.c_void_p), n_threads)
    else:
        out = np.zeros((b, t_pad, dim), np.float32)
        for i, u in enumerate(utts):
            out[i, : u.shape[0]] = u.reshape(u.shape[0], dim)
    if utts[0].ndim == 1:
        out = out.reshape(b, t_pad)
    return out, lens


def levenshtein_batch(refs, hyps, n_threads: int = 0) -> np.ndarray:
    """Per pair ``[distance, subs, ins, dels]``, int32 ``[N, 4]``; the
    backtrace breaks ties as ``utils/edit_distance`` does."""
    lib = _lib()
    if lib is None:
        return _levenshtein_batch_py(refs, hyps)
    n = len(refs)
    max_len = max([1] + [len(x) for x in refs] + [len(x) for x in hyps])
    r = np.full((n, max_len), -1, np.int32)
    h = np.full((n, max_len), -1, np.int32)
    rl = np.asarray([len(x) for x in refs], np.int32)
    hl = np.asarray([len(x) for x in hyps], np.int32)
    for i in range(n):
        r[i, : rl[i]] = refs[i]
        h[i, : hl[i]] = hyps[i]
    out = np.zeros((n, 4), np.int32)
    if n:
        lib.levenshtein_batch(r.ctypes.data_as(ctypes.c_void_p),
                              rl.ctypes.data_as(ctypes.c_void_p),
                              h.ctypes.data_as(ctypes.c_void_p),
                              hl.ctypes.data_as(ctypes.c_void_p),
                              n, max_len, out.ctypes.data_as(ctypes.c_void_p), n_threads)
    return out
