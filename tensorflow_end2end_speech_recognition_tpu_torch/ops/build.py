"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface and include no PyTorch header. Each
source compiles to an object file in its own nvcc process, all started
together, and one more call links them, so a build takes seconds. The
library goes to ``_build/`` inside the package (listed in ``.gitignore``),
named by a hash of the sources, their headers and the flags, and is built at first use:
nothing is compiled when a module is imported, so the CPU-only test runs
never need nvcc.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(csrc: Path = CSRC) -> Path:
    """``_build/libasr_kernels_<hash>.so``, the hash over the flags and every
    source and header (``*.cu``, ``*.cuh``, ``*.h``) in ``csrc``: editing a
    header that the sources include names a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh", ".h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libasr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once, wait for all, return their outputs; raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile ``csrc/*.cu`` (with the headers they include) into one shared
    library unless it is built already.

    One nvcc process per source, all running together, then one link.
    Returns the library path. The compiler's report (``-Xptxas -v``: registers
    and shared memory per kernel) is kept beside it as ``<lib>.log``. A failed
    build raises with nvcc's output.
    """
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(_sources(), objs)])
        # link under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        tmp = Path(work) / lib.name
        logs += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, lib)
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Each C entry point's argument types, in order: ctypes passes a wrong count
# without complaint, so tests/test_torch_lstm_bwd_plan.py holds this table
# against the sources' extern "C" definitions.
SIGNATURES = {
    "lstm_bidi_fwd": [_P] * 11 + [_I] * 8 + [_F, _P],
    "lstm_bidi_bwd": [_P] * 15 + [_I] * 9 + [_F, _P],
    "lstm_layer_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
    "lstm_layer_fwd_carry": [_P] * 11 + [_I] * 8 + [_F, _P],
    "lstm_layer_bwd": [_P] * 9 + [_I] * 9 + [_F, _P],
    "lstm_bidi_bwd_max_clusters": [_I] * 6,
    "lstm_layer_bwd_max_clusters": [_I] * 6,
    "lstm_bidi_fwd_trace": [_I, _P],
    "lstm_layer_fwd_trace": [_I, _P],
    "lstm_bidi_bwd_trace": [_I, _P],
    "lstm_layer_bwd_trace": [_I, _P],
    "ctc_loss_fwd_bwd": [_P] * 12 + [_I] * 15 + [_P],
    "ctc_loss_fwd_only": [_P] * 8 + [_I] * 12 + [_P],
    "location_attend": [_P] * 12 + [_I] * 7 + [_F, _P],
}
# the bf16 instantiations (the LSTM kernels' streams, #7's encoder rows, the
# carried walk's products) take the float32 entries' arguments
SIGNATURES.update({f"{name}_bf16": SIGNATURES[name] for name in (
    "lstm_bidi_fwd", "lstm_bidi_bwd", "lstm_layer_fwd", "lstm_layer_bwd", "location_attend",
    "lstm_layer_fwd_carry")})


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.asr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.asr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.asr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
