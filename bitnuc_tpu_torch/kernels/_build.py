"""Build and load the hand-written CUDA kernels.

Each of ``bitnuc_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``, all
started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
keyed by a hash of the sources and flags, into
``bitnuc_tpu_torch/_build/`` (listed in ``.gitignore``); later calls in the
same checkout reuse the library. Nothing here runs at import time, so the
package imports on machines with no CUDA toolkit.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_U32 = ctypes.c_uint32
# name -> argtypes of each C entry point (all return int: a cudaError_t)
_SIGNATURES = {
    "bn_pack": (_P, _P, _I64, _I64, _I64, _P, _P, _P),
    "bn_hist_keys_scratch": (_I64, _INT, _P),
    "bn_hist_keys": (_P, _I64, _INT, _P, _P, _P),
    "bn_hist_words": (_P, _P, _I64, _I64, _INT, _INT, _P, _P),
    "bn_hdist_scan": (_P, _P, _I64, _I64, _I64, _INT, _P, _P),
    "bn_unpack": (_P, _P, _I64, _I64, _I64, _P, _P),
    "bn_merge_tile": (_P,),
    "bn_merge_scratch": (_I64, _I64, _P),
    "bn_merge": (_P, _P, _P, _INT, _INT, _I64, _I64, _P, _P),
    "bn_fit_banded": (_P, _P, _P, _P, _I64) + (_INT,) * 6 + (_P, _I64, _P, _P, _P, _P),
    "bn_sw_score": (_P, _P, _P, _P, _I64) + (_INT,) * 6 + (_P, _I64, _P, _P, _P, _P),
    "bn_tc_scan": (_P, _P, _I64, _I64, _I64, _INT, _INT, _I64, _I64, _P, _P),
    "bn_tc_search": (_P, _P, _I64, _I64, _I64, _INT, _INT, _INT, _I64, _I64, _P, _P),
    "bn_tc_blocks_per_sm": (_INT, _INT, _INT, _P),
    "bn_orf_scan": (_P, _P, _I64, _INT, _INT, _P, _P, _P, _P),
    "bn_chain_scratch": (_I64, _I64, _P),
    "bn_chain": (_P, _P, _P, _I64, _I64, _INT, _INT, _U32, _INT, _INT, _INT) + (_P,) * 7,
    "bn_traceback": (_P,) * 5 + (_I64,) + (_INT,) * 9 + (_P, _I64, _I64) + (_P,) * 4,
    "bn_traceback_warp": (_P,) * 5 + (_I64,) + (_INT,) * 5 + (_P,) * 4,
    "bn_fit_span": (_P,) * 5 + (_I64,) + (_INT,) * 8 + (_P, _I64, _I64) + (_P,) * 4,
}
_ERROR_STRING = "bn_error_string"  # const char* (int code)

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into one .so (skipped when the hashed library
    already exists) and return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libbitnuc_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):  # one nvcc per source, in parallel
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{log}")
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, _ERROR_STRING)
        err.argtypes = (_INT,)
        err.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().bn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
