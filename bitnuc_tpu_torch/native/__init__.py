"""The host library: C++ passes on the CPU, loaded with ctypes.

The counterpart of ``bitnuc_tpu/native``, with its functions, parameters
and outputs: the single-sequence codec of the host API tier (``encode``,
``decode``, ``as_2bit``, ``from_2bit``, ``hdist``, ``hdist_scalar``,
``split_packed``, ``count_kmers``), FASTQ framing (``fastq_to_batch``,
``fastq_to_batch_sq``), the record emitter of ``filters.filter_fastq``
(``filter_emit``), the QC fold (``qc_fold``), the assembler's graph passes
(``merge_join``, ``list_rank``, ``graph_edges``, ``argsort_u64``), a host
k-mer spectrum (``spectrum``, on the port's int32 word views) and a
threaded host pack (``encode_batch``). Errors are the port's.

``bitnuc_host.cpp`` beside this file is built at first use, never at
import, with the host compiler (``$CXX``, else ``c++`` or ``g++`` on the
PATH) and ``-O3 -march=native -std=c++17 -shared -fPIC -pthread``, into
``bitnuc_tpu_torch/_build/libbitnuc_host_<hash>.so``. The hash covers the
source, the compiler and its version, the flags and the host's CPU flags
(``config.host_cpu_tag``), so a host with other CPU features or another
compiler builds its own library. One process at a time compiles (a file lock), to a name of
its own renamed into place when whole, so no process loads a partial
file.

``available()`` is False when no compiler exists or the build fails;
callers then take the numpy twins (``io.fastq_to_batch``,
``filters._emit_records``, the numpy forms of ``api`` and ``assemble``),
and ``build()`` raises with the compiler's message. The calls release the
GIL (ctypes), so framing on ``io._prefetched``'s producer thread overlaps
the consumer.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import oracle
from ..config import host_cpu_tag
from ..errors import IndexOutOfBounds, InvalidBase, InvalidLength, SequenceTooLong

SOURCE = Path(__file__).resolve().with_name("bitnuc_host.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error = ""  # why the library did not load
_lock = threading.Lock()

# status codes shared with bitnuc_host.cpp
_OK = 0
_ERR_INVALID_BASE = 1

# Buffers pass as addresses (``ndarray.ctypes.data``): a typed pointer made
# by ``data_as`` costs more than a short call's work. The callers keep each
# array alive through the call.
_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_INT = ctypes.c_int
# name -> (restype, argtypes) of each C entry point
_SIGNATURES = {
    "bn_encode": (_INT, (_P, _SZ, _P, _P)),
    "bn_decode": (_INT, (_P, _SZ, _SZ, _P)),
    "bn_hdist": (_INT, (_P, _P, _SZ, _SZ, _P)),
    "bn_split": (_INT, (_P, _SZ, _SZ, _SZ, _P, _P)),
    "bn_encode_batch": (_INT, (_P, _SZ, _SZ, _P, _SZ)),
    "bn_encode_batch_mt": (_INT, (_P, _SZ, _SZ, _P, _SZ, _INT)),
    "bn_count_kmers": (_INT, (_P, _SZ, _SZ, _SZ, _P)),
    "bn_fastq_scan": (_INT, (_P, _SZ, _P, _P)),
    "bn_fastq_fill": (_INT, (_P, _SZ, _P, _P, _SZ, _SZ)),
    "bn_fastq_fill_sq": (_INT, (_P, _SZ, _P, _P, _P, _P, _P, _SZ, _SZ)),
    "bn_filter_emit": (ctypes.c_int64, (_P, _P, _P, _SZ, _SZ) + (_P,) * 6),
    "bn_merge_join": (_INT, (_P, _SZ, _P, _SZ, _P, _P)),
    "bn_list_rank": (_INT, (_P, _SZ, _P, _P, _INT)),
    "bn_graph_edges": (_INT, (_P, _SZ, _INT) + (_P,) * 8),
    "bn_argsort_u64": (_INT, (_P, _SZ, _P)),
    "bn_qc_fold": (_INT, (_P, _P, _P, _SZ, _SZ, _INT, _P, _P, _P, _P, _INT)),
    "bn_spectrum": (_INT, (_P, _SZ, _SZ, _P, _INT, _INT, _P, _P, _P, _P, _INT)),
}


def _compiler() -> str:
    """``$CXX``, else ``c++`` or ``g++`` on the PATH; RuntimeError when
    none is found."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler: set $CXX or put c++ or g++ on the PATH")


@functools.lru_cache(maxsize=None)
def _compiler_version(cxx: str) -> str:
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return proc.stdout


def library_path(cxx: Optional[str] = None) -> Path:
    """Where the library built by ``cxx`` (default: ``_compiler()``) on
    this host lives."""
    cxx = cxx or _compiler()
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (cxx, _compiler_version(cxx), *CXX_FLAGS, host_cpu_tag()):
        h.update(b"\0" + part.encode())
    return BUILD_DIR / f"libbitnuc_host_{h.hexdigest()[:16]}.so"


def _compile(quiet: bool = True) -> Path:
    """Build the library unless this host's already exists; its path."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.{threading.get_ident()}.so")
    # one process compiles while the others wait for its file
    with open(BUILD_DIR / "libbitnuc_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if not quiet:
                print(proc.stdout + proc.stderr, end="")
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a reader without the lock sees all or nothing
        finally:
            tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot be
    built or loaded (the reason in ``_error``)."""
    global _lib, _tried, _error
    if _tried:  # set last, under the lock: _lib is final once it is seen
        return _lib
    with _lock:
        if not _tried:
            try:
                lib = ctypes.CDLL(str(_compile()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
            except (OSError, RuntimeError) as e:
                _lib, _error = None, str(e)
            _tried = True
        return _lib


def available() -> bool:
    """True when the library is built (here, at first use) and loaded."""
    return _load() is not None


def build(quiet: bool = True) -> bool:
    """Build the library now (a no-op when this host's exists) and load it;
    True. Raises RuntimeError with the compiler's message when it cannot
    be built."""
    global _tried
    _compile(quiet)
    with _lock:
        _tried = False
    if not available():
        raise RuntimeError(f"the host library did not load: {_error}")
    return True


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the host library is not available: {_error}")
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _threads(n_threads: int) -> int:
    return int(n_threads) if n_threads else (os.cpu_count() or 1)


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.ascontiguousarray(np.asarray(seq, dtype=np.uint8))


def _u64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64))


# -- the host API tier ----------------------------------------------------------


def encode(seq) -> np.ndarray:
    """ASCII -> ceil(n / 32) u64 words; InvalidBase on the first byte that
    is not one of ACGTacgt."""
    lib = _need()
    s = _as_u8(seq)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(-(-n // 32), dtype=np.uint64)
    bad = ctypes.c_uint8(0)
    rc = lib.bn_encode(_ptr(s), n, _ptr(out), ctypes.byref(bad))
    if rc == _ERR_INVALID_BASE:
        raise InvalidBase(bad.value)
    return out


def as_2bit(seq) -> int:
    s = _as_u8(seq)
    if len(s) > 32:
        raise SequenceTooLong(len(s))
    if len(s) == 0:
        return 0
    return int(encode(s)[0])


def decode(ebuf, n_bases: int) -> bytes:
    lib = _need()
    words = _u64(ebuf)
    if n_bases > 32 * len(words):
        raise InvalidLength(n_bases)
    out = np.zeros(n_bases, dtype=np.uint8)
    if lib.bn_decode(_ptr(words), len(words), n_bases, _ptr(out)) != _OK:
        raise InvalidLength(n_bases)
    return bytes(out)


def from_2bit(packed: int, n_bases: int) -> bytes:
    if n_bases > 32:
        raise InvalidLength(n_bases)
    return decode(np.array([packed], dtype=np.uint64), n_bases)


def hdist(ebuf1, ebuf2, n_bases: int) -> int:
    lib = _need()
    e1, e2 = _u64(ebuf1), _u64(ebuf2)
    expected = -(-n_bases // 32)
    if len(e1) < expected or len(e2) < expected:
        raise InvalidLength(n_bases)
    out = ctypes.c_uint64(0)
    rc = lib.bn_hdist(_ptr(e1), _ptr(e2), min(len(e1), len(e2)), n_bases,
                      ctypes.byref(out))
    if rc != _OK:
        raise InvalidLength(n_bases)
    return int(out.value)


def hdist_scalar(u: int, v: int, length: int) -> int:
    if length > 32:
        raise InvalidLength(length)
    return hdist(np.array([u], dtype=np.uint64), np.array([v], dtype=np.uint64), length)


def split_packed(ebuf, slen: int, idx: int) -> Tuple[np.ndarray, np.ndarray]:
    lib = _need()
    words = _u64(ebuf)
    if idx > slen:
        raise IndexOutOfBounds(idx, slen)
    if idx == 0:
        return np.zeros(0, dtype=np.uint64), words.copy()
    if idx == slen:
        return words.copy(), np.zeros(0, dtype=np.uint64)
    if len(words) == 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    lbuf = np.zeros(idx // 32 + 1, dtype=np.uint64)
    rbuf = np.zeros(-(-(slen - idx) // 32), dtype=np.uint64)
    rc = lib.bn_split(_ptr(words), len(words), slen, idx, _ptr(lbuf),
                      _ptr(rbuf))
    if rc != _OK:
        raise IndexOutOfBounds(idx, slen)
    return lbuf, rbuf


def count_kmers(seq, k: int) -> dict:
    """{packed k-mer: count}: a rolling window over the packed words for
    k <= 12 (dense bins), the oracle above."""
    if not 1 <= k <= 32:
        raise InvalidLength(k)
    if k > 12 or not available():
        return oracle.count_kmers(seq, k)
    words = encode(seq)
    counts = np.zeros(4**k, dtype=np.uint64)
    _need().bn_count_kmers(_ptr(words), len(words), len(_as_u8(seq)), k,
                           _ptr(counts))
    nz = np.nonzero(counts)[0]
    return {int(i): int(counts[i]) for i in nz}


# -- host staging ------------------------------------------------------------------


def encode_batch(ascii_rect: np.ndarray, out_words_per_read: int,
                 n_threads: int = 0) -> np.ndarray:
    """Rectangular uint8 [B, L] -> u64 words [B, out_words_per_read] on
    the host, without validation (a byte outside ACGTacgt gives some code).
    n_threads=0 uses every hardware thread; 1 one thread."""
    lib = _need()
    a = np.ascontiguousarray(ascii_rect, dtype=np.uint8)
    B, L = a.shape
    out = np.zeros((B, out_words_per_read), dtype=np.uint64)
    lib.bn_encode_batch_mt(_ptr(a), B, L, _ptr(out), out_words_per_read,
                           _threads(n_threads))
    return out


# -- FASTQ framing and the record emitter ---------------------------------------------


def _scan(buf: np.ndarray, max_len: int) -> Tuple[int, int]:
    """(records, L) of a FASTQ buffer: L is max_len, or the longest read
    (at least 1)."""
    n_reads, longest = ctypes.c_size_t(0), ctypes.c_size_t(0)
    _need().bn_fastq_scan(_ptr(buf), len(buf), ctypes.byref(n_reads),
                          ctypes.byref(longest))
    return n_reads.value, int(max_len) if max_len else max(int(longest.value), 1)


def fastq_to_batch(data: bytes, max_len: int = 0):
    """FASTQ bytes -> (ascii uint8 [B, L], lengths int32 [B]) in two
    passes; max_len=0 sizes L to the longest read, longer reads are
    truncated otherwise. The numpy twin is ``io.fastq_to_batch``."""
    buf = np.frombuffer(data, dtype=np.uint8)
    B, L = _scan(buf, max_len)
    ascii_arr = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    if B:
        _need().bn_fastq_fill(_ptr(buf), len(buf), _ptr(ascii_arr),
                              _ptr(lens), B, L)
    return ascii_arr, lens


def fastq_to_batch_sq(data: bytes, max_len: int = 0):
    """Full-record FASTQ parse: (ascii uint8 [B, L], quals uint8 [B, L],
    lengths int32 [B], name_off int64 [B], name_len int64 [B]), the header
    spans pointing into ``data`` past the '@'. The numpy twin is
    ``io.fastq_to_batch_sq``."""
    buf = np.frombuffer(data, dtype=np.uint8)
    B, L = _scan(buf, max_len)
    ascii_arr = np.zeros((B, L), dtype=np.uint8)
    quals = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    name_off = np.zeros(B, dtype=np.int64)
    name_len = np.zeros(B, dtype=np.int64)
    if B:
        _need().bn_fastq_fill_sq(_ptr(buf), len(buf), _ptr(ascii_arr),
                                 _ptr(quals), _ptr(lens),
                                 _ptr(name_off), _ptr(name_len), B, L)
    return ascii_arr, quals, lens, name_off, name_len


def filter_emit(raw, ascii_arr, quals, name_off, name_len, keep, start, end):
    """The kept records of a batch as one FASTQ bytes buffer: '@', the
    header's bytes of ``raw``, the bases and qualities of [start, end)
    clamped to the row, in batch order. None without the library; the
    numpy twin is ``filters._emit_records``."""
    lib = _load()
    if lib is None:
        return None
    raw_b = np.frombuffer(raw, dtype=np.uint8)
    a = np.ascontiguousarray(ascii_arr, dtype=np.uint8)
    q = np.ascontiguousarray(quals, dtype=np.uint8)
    B, L = a.shape
    kept = np.asarray(keep).astype(bool)
    keep8 = np.ascontiguousarray(kept, dtype=np.uint8)
    start = np.ascontiguousarray(start, dtype=np.int64)
    end = np.ascontiguousarray(np.minimum(end, L), dtype=np.int64)
    noff = np.ascontiguousarray(name_off, dtype=np.int64)
    nlen = np.ascontiguousarray(name_len, dtype=np.int64)
    if not len(kept) == len(start) == len(end) == len(noff) == len(nlen) == B == q.shape[0]:
        raise ValueError("filter_emit: every per-record array needs one entry a row")
    if q.shape != a.shape or (B and ((noff < 0) | (nlen < 0) | (noff + nlen > len(raw_b))).any()):
        raise ValueError("filter_emit: quality rows or a header span outside the records")
    spans = np.where(kept, np.maximum(end - np.maximum(start, 0), 0), 0)
    total = int(spans.sum() * 2 + np.where(kept, nlen, 0).sum()) + 6 * int(kept.sum())
    out = np.empty(total, dtype=np.uint8)
    n = lib.bn_filter_emit(_ptr(raw_b), _ptr(a), _ptr(q), B, L,
                           _ptr(noff), _ptr(nlen), _ptr(keep8),
                           _ptr(start), _ptr(end), _ptr(out))
    if n != total:
        raise RuntimeError(f"bn_filter_emit wrote {n} bytes, expected {total}")
    return out.tobytes()


def qc_fold(ascii_arr, quals, lens, qmax, base_by_cycle, qual_by_cycle, mean_q_hist,
            gc_hist, n_threads: int = 0) -> bool:
    """One-pass QC fold, accumulated in place into the caller's int64
    arrays (per-cycle base counts [L, 5], per-cycle quality histogram [L,
    qmax], mean-quality histogram [qmax], GC% histogram [101]); False
    without the library. Equal to the JAX package's numpy fold: the same
    symbol map, phred clipping and round-half-to-even."""
    lib = _load()
    if lib is None:
        return False
    a = np.ascontiguousarray(ascii_arr, dtype=np.uint8)
    q = np.ascontiguousarray(quals, dtype=np.uint8)
    R, L = a.shape
    ln = np.ascontiguousarray(lens, dtype=np.int32)
    shapes = ((L, 5), (L, int(qmax)), (int(qmax),), (101,))
    for acc, shape in zip((base_by_cycle, qual_by_cycle, mean_q_hist, gc_hist), shapes):
        if acc.dtype != np.int64 or not acc.flags.c_contiguous or acc.shape != shape:
            raise ValueError(f"qc_fold accumulates into C-contiguous int64 arrays of shapes "
                             f"{shapes}")
    if q.shape != a.shape or ln.shape != (R,):
        raise ValueError("qc_fold: quals must match the bases, lens hold one entry a row")
    lib.bn_qc_fold(_ptr(a), _ptr(q), _ptr(ln), R, L, int(qmax),
                   _ptr(base_by_cycle), _ptr(qual_by_cycle),
                   _ptr(mean_q_hist), _ptr(gc_hist), _threads(n_threads))
    return True


# -- the assembler's graph passes ---------------------------------------------------------


def merge_join(sorted_keys, sorted_q):
    """(present bool [m], lower-bound index int32 [m], clamped to n - 1) of
    sorted queries in a sorted unique key array, by one linear merge; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    keys, q = _u64(sorted_keys), _u64(sorted_q)
    ok = np.zeros(len(q), np.uint8)
    idx = np.zeros(len(q), np.int32)
    if len(keys) and len(q):
        lib.bn_merge_join(_ptr(keys), len(keys), _ptr(q), len(q),
                          _ptr(ok), _ptr(idx))
    return ok.astype(bool), idx


def list_rank(prev, n_threads: int = 0):
    """Pointer-doubling list ranking of a predecessor forest (prev[i] = -1
    at a chain start): (rank, jump), rank the distance to the chain's start
    and jump the start; a node on a pure cycle ranks >= n. Threaded; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(prev, dtype=np.int32)
    n = len(p)
    if n and (int(p.min()) < -1 or int(p.max()) >= n):
        raise ValueError("list_rank: prev holds -1 or an index below n")
    rank = np.zeros(n, np.int32)
    jump = np.zeros(n, np.int32)
    if n:
        lib.bn_list_rank(_ptr(p), n, _ptr(rank), _ptr(jump),
                         _threads(n_threads))
    return rank, jump


def graph_edges(sorted_keys, k: int):
    """The de Bruijn edge structure of a sorted unique key set in one pass:
    (succ_ok bool [4, n], succ_idx i32 [4, n], outdeg i32 [n], indeg i32
    [n], succ1 i32 [n], pred1 i32 [n], nxt i32 [n], prev i32 [n]), equal to
    ``assemble._Graph``'s numpy edge pass. None without the library or for
    2^31 keys or more."""
    lib = _load()
    keys = _u64(sorted_keys)
    n = len(keys)
    if lib is None or n >= (1 << 31):
        return None
    succ_ok = np.zeros((4, n), np.uint8)
    succ_idx = np.zeros((4, n), np.int32)
    rest = [np.zeros(n, np.int32) for _ in range(6)]  # outdeg indeg succ1 pred1 nxt prev
    if n:
        lib.bn_graph_edges(_ptr(keys), n, int(k), _ptr(succ_ok),
                           _ptr(succ_idx), *(_ptr(a) for a in rest))
    return (succ_ok.astype(bool), succ_idx, *rest)


def argsort_u64(keys):
    """Stable argsort of u64 keys (LSD radix) as int32, equal to
    ``np.argsort(keys, kind='stable')``; None without the library or for
    2^31 keys or more."""
    lib = _load()
    ks = _u64(keys)
    n = len(ks)
    if lib is None or n >= (1 << 31):
        return None
    order = np.zeros(n, np.int32)
    if n:
        lib.bn_argsort_u64(_ptr(ks), n, _ptr(order))
    return order


def _pad_valid(valid, B, L):
    """[B, Lv] base-validity mask -> [B, L] bool, padded True (positions
    past a read's length fail the length test anyway)."""
    v = np.asarray(valid, dtype=bool)
    if v.shape[1] < L:
        v = np.pad(v, ((0, 0), (0, L - v.shape[1])), constant_values=True)
    return v[:, :L]


def _word_view(words) -> np.ndarray:
    """uint32 [B, W] words: the port's int32 words viewed (no copy when
    contiguous), or any integer array cast."""
    w = np.ascontiguousarray(words)
    if w.dtype == np.int32:
        return w.view(np.uint32)
    return np.ascontiguousarray(w, dtype=np.uint32)


def spectrum(words, lens, k: int, canonical: bool = False, valid=None, n_threads: int = 0):
    """K-mer spectrum of a packed read batch on the host: (sorted distinct
    uint64 keys, int32 counts saturated at 2^31 - 1), the content of
    ``ops.kmer.count_kmers_runs`` compacted (canonical = min(kmer,
    revcomp); windows touching an invalid base dropped). ``words`` are the
    port's [B, W] int32 words (or uint32). Its numpy twin is
    ``assemble._np_spectrum``."""
    words = _word_view(words)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    lib = _need()
    B, W = words.shape
    if lens.shape != (B,):
        raise ValueError("spectrum: lens needs one entry a row")
    lens = np.minimum(lens, 16 * W).astype(np.int32)  # a read's bases lie in its row
    total = int(np.maximum(lens.astype(np.int64) - k + 1, 0).sum())
    if total == 0 or B == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    cap = min(total, 4**k)  # distinct keys
    out_keys = np.zeros(cap, np.uint64)
    out_counts = np.zeros(cap, np.int32)
    n_out = ctypes.c_int64(0)
    v_ptr = None  # NULL: every base valid
    if valid is not None:
        v_arr = np.ascontiguousarray(_pad_valid(valid, B, W * 16), dtype=np.uint8)
        if v_arr.shape[0] != B:
            raise ValueError("spectrum: valid needs one row a read")
        v_ptr = _ptr(v_arr)
    rc = lib.bn_spectrum(_ptr(words), B, W, _ptr(lens), int(k),
                         int(bool(canonical)), v_ptr, _ptr(out_keys),
                         _ptr(out_counts), ctypes.byref(n_out), _threads(n_threads))
    if rc != _OK:
        raise InvalidLength(k)
    m = int(n_out.value)
    return out_keys[:m].copy(), out_counts[:m].copy()
