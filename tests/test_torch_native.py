"""bitnuc_tpu_torch.native, the port's host library, against its numpy
twins and against the JAX package's native library, on numpy-seeded
inputs: every function (the codec at lengths 0 to 1,000 with the errors of
tests/test_native.py, count_kmers, the host pack, ragged and blank-line
FASTQ framing, the record emitter, the QC fold, the merge join, list
ranking on chains and cycles, the edge pass, the radix argsort, the
spectrum with validity masks and counts past its clamp), two
processes building the library at once, and the routed paths (io, api,
filter_fastq, qc_profile, assemble_reads with both engines, info) with the
port's library switched on and off against the JAX package with its
library loaded.

``jax_native()`` loads the JAX package's library for these tests and the
other test_torch_*.py files that compare against it."""

import collections
import ctypes
import fcntl
import gzip
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bitnuc_tpu as jbn
from bitnuc_tpu import assemble as jasm, filters as jfilters, io as jio, qc as jqc
from bitnuc_tpu.ops import codec as jcodec
import bitnuc_tpu_torch as tbn
from bitnuc_tpu_torch import api, assemble as asm, cli, errors, filters, io as tio, native, qc
from bitnuc_tpu_torch.ops import codec
from bitnuc_tpu_torch.utils import bitops
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
_JAX_LOCK = ROOT / "bitnuc_tpu_torch" / "_build" / "jax_native.lock"


def _has_compiler(*names) -> bool:
    return any(n and shutil.which(n) for n in names)


def jax_native():
    """The JAX package's native module with its library loaded.

    Under an exclusive lock shared by the test processes: its own
    ``native.build()`` (make), then ``_tried`` and ``_lib`` reset as
    tests/test_native.py does, and one retry when the load still fails,
    after a build without the lock (tests/test_native.py builds at
    collection in every process) left a partial file that make took as up
    to date. Skips only when no compiler exists."""
    from bitnuc_tpu import native as jn

    if jn.available():
        return jn
    if not (shutil.which("make") and _has_compiler(os.environ.get("CXX"), "g++")):
        pytest.skip("no C++ compiler to build the JAX package's native library")
    _JAX_LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(_JAX_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(2):
            if attempt:  # a partial file: rebuild it
                Path(jn._LIB_PATH).unlink(missing_ok=True)
            jn.build()
            jn._tried, jn._lib = False, None
            if jn.available():
                return jn
    pytest.fail("the JAX package's native library was built but does not load")


def port_native():
    """The port's host library, built and loaded; skips only when no
    compiler exists."""
    if not native.available():
        if not _has_compiler(os.environ.get("CXX"), "c++", "g++"):
            pytest.skip("no C++ compiler to build the host library")
        pytest.fail(f"the host library does not load: {native._error}")
    return native


@pytest.fixture
def jn():
    return jax_native()


@pytest.fixture
def tn():
    return port_native()


def _off(monkeypatch):
    """Switch the port's library off: every caller takes its numpy twin."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "_load", lambda: None)


ROUTED = ("encode", "decode", "as_2bit", "from_2bit", "hdist", "hdist_scalar",
          "split_packed", "count_kmers", "fastq_to_batch", "fastq_to_batch_sq",
          "filter_emit", "merge_join", "list_rank", "graph_edges", "argsort_u64",
          "spectrum")


@pytest.fixture(params=["library", "numpy"])
def route(request, monkeypatch):
    """The port with its library (each routed call counted) or with its
    numpy twins; the JAX package with its library loaded either way.
    Yields (route, Counter of the port library's calls)."""
    jax_native()
    calls = collections.Counter()
    if request.param == "numpy":
        _off(monkeypatch)
    else:
        port_native()
    for name in ROUTED:
        fn = getattr(native, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(native, name, spy)
    yield request.param, calls
    if request.param == "numpy":  # the callers chose the twins
        assert not calls


def _eq(got, want):
    """Equal values, arrays compared by value (the twins' int dtypes may
    be wider)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # compared by name: the two packages' classes differ
        return ("raised", type(e).__name__, str(e))


# -- the host API tier -------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 100, 1000])
def test_codec_matches_twin_and_jax(tn, jn, n):
    s = random_seq(np.random.default_rng(n), n)
    e = tn.encode(s)
    assert e.dtype == np.uint64
    _eq(e, jn.encode(s))
    _eq(e, api.encode.numpy(s))
    assert tn.decode(e, n) == jn.decode(e, n) == api.decode.numpy(e, n) == s.upper()
    for nb in (0, max(n - 1, 0), n + 1, 32 * len(e) + 1):
        _eq(_outcome(tn.decode, e, nb), _outcome(jn.decode, e, nb))
    _eq(tn.as_2bit(s[:32]), jn.as_2bit(s[:32]))
    if n:
        w = int(e[0])
        for nb in (1, min(n, 32), 33):
            _eq(_outcome(tn.from_2bit, w, nb), _outcome(jn.from_2bit, w, nb))
            _eq(_outcome(tn.from_2bit, w, nb), _outcome(api.from_2bit.numpy, w, nb))


def test_goldens_and_errors(tn, jn):
    assert tn.as_2bit(b"ACGT") == 0b11100100
    assert tn.as_2bit(b"ACTGACTGACTGACTG") == 0b10110100101101001011010010110100
    assert tn.from_2bit(71620941647064936, 28) == b"AGGCTTGAGGCCCATTCTCTGATCGTTT"
    assert tn.hdist(tn.encode(b"ACTGACTG"), tn.encode(b"TGCATGCA"), 8) == 8
    for fn, args, err in [
        (tn.encode, (b"ACGN",), errors.InvalidBase),
        (tn.encode, (b"A" * 40 + b"X",), errors.InvalidBase),  # in the SWAR fast path
        (tn.as_2bit, (b"A" * 33,), errors.SequenceTooLong),
        (tn.from_2bit, (0, 33), errors.InvalidLength),
        (tn.hdist, (np.zeros(1, np.uint64), np.zeros(1, np.uint64), 64), errors.InvalidLength),
        (tn.split_packed, (np.zeros(1, np.uint64), 5, 6), errors.IndexOutOfBounds),
        (tn.count_kmers, (b"ACGT", 33), errors.InvalidLength),
    ]:
        with pytest.raises(err):
            fn(*args)
        _eq(_outcome(fn, *args), _outcome(getattr(jn, fn.__name__), *args))
    with pytest.raises(errors.InvalidBase) as e:
        tn.encode(b"ACGTACGTAN")
    assert e.value.base == ord("N")
    e = tn.encode(b"ACGT" * 20)
    for name, args in [("decode", (e, -1)), ("from_2bit", (5, -1)), ("hdist", (e, e, -5)),
                       ("hdist_scalar", (1, 2, -1)), ("split_packed", (e, 80, -1))]:
        _eq(_outcome(getattr(tn, name), *args), _outcome(getattr(jn, name), *args))
        _eq(_outcome(getattr(tn, name), *args)[:2],
            _outcome(getattr(api, name).numpy, *args)[:2])


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 256])
def test_hdist_and_split_match_twin_and_jax(tn, jn, n):
    rng = np.random.default_rng(n)
    e1, e2 = tn.encode(random_seq(rng, n)), tn.encode(random_seq(rng, n))
    for nb in sorted({0, 1, n // 2, n}):
        assert tn.hdist(e1, e2, nb) == jn.hdist(e1, e2, nb) == api.hdist.numpy(e1, e2, nb)
    for length in (0, 1, min(n, 32)):
        assert (tn.hdist_scalar(int(e1[0]), int(e2[0]), length)
                == jn.hdist_scalar(int(e1[0]), int(e2[0]), length)
                == api.hdist_scalar.numpy(int(e1[0]), int(e2[0]), length))
    for idx in range(0, n + 1, 3):
        got = tn.split_packed(e1, n, idx)
        _eq(got, jn.split_packed(e1, n, idx))
        _eq(got, api.split_packed.numpy(e1, n, idx))


@pytest.mark.parametrize("k", [1, 2, 5, 12, 13, 32])
def test_count_kmers_matches_twin_and_jax(tn, jn, k):
    rng = np.random.default_rng(k)
    for n in (0, k - 1, k, 200):
        s = random_seq(rng, max(n, 0))
        got = tn.count_kmers(s, k)
        assert got == jn.count_kmers(s, k) == api._count_kmers_numpy(s, k)
    _eq(_outcome(tn.count_kmers, b"AN", k), _outcome(jn.count_kmers, b"AN", k))


@pytest.mark.parametrize("shape", [(0, 4), (1, 1), (5, 31), (7, 32), (33, 33), (64, 150)])
@pytest.mark.parametrize("n_threads", [1, 0])
def test_encode_batch_matches_k1_plain_and_jax(tn, jn, shape, n_threads):
    """The host pack of full rows against K1's plain version (whole rows,
    no invalid byte) and the JAX package's, at every word width it pads to."""
    B, L = shape
    a = np.frombuffer(b"ACGTacgt", np.uint8)[np.random.default_rng(B).integers(0, 8, (B, L))]
    w64 = -(-L // 32) + 1
    got = tn.encode_batch(a, w64, n_threads)
    _eq(got, jn.encode_batch(a, w64, n_threads))
    words, _ = codec.encode_reads(torch.from_numpy(a), torch.full((B,), L, dtype=torch.int32))
    want = bitops.words_u32_to_u64_np(bitops.words_to_u32_np(words))
    _eq(got[:, : want.shape[1]], want)
    assert not got[:, want.shape[1]:].any()


# -- FASTQ framing and the emitter ---------------------------------------------------


def _ragged(rng, n_records):
    """FASTQ bytes with blank lines at every position of a record, CR-only
    lines, a header with no name and records cut short after each line."""
    pieces = [b"@x", b"@", b"ACGT", b"", b"\r", b"+", b"II", b"ACGTACGTAA\r", b"@r1 d"]
    parts = [pieces[i] for i in rng.integers(0, len(pieces), n_records)]
    return b"\n".join(parts) + (b"\n" if rng.random() < 0.5 else b"")


def _records(rng, n, crlf=False, blank_every=0):
    nl = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        s = random_seq(rng, int(rng.integers(1, 90)))
        q = bytes(rng.integers(33, 75, len(s)).astype(np.uint8))
        out.append(b"@read_%d desc%s%s%s+%s%s%s" % (i, nl, s, nl, nl, q, nl))
        if blank_every and i % blank_every == 1:
            out.append(nl)
    return b"".join(out)


@pytest.mark.parametrize("max_len", [0, 1, 3, 40])
def test_fastq_framing_matches_twin_and_jax(tn, jn, max_len):
    rng = np.random.default_rng(max_len)
    datas = [b"", b"\n\n", _records(rng, 30), _records(rng, 30, crlf=True, blank_every=3),
             _records(rng, 5)[:-1]]  # the last record without its newline
    datas += [_ragged(rng, int(rng.integers(0, 14))) for _ in range(200)]
    for data in datas:
        for fn, twin in ((tn.fastq_to_batch, tio.fastq_to_batch),
                         (tn.fastq_to_batch_sq, tio.fastq_to_batch_sq)):
            got = fn(data, max_len)
            want = getattr(jn, fn.__name__)(data, max_len)
            assert [g.dtype for g in got] == [w.dtype for w in want]
            _eq(got, want)
            _eq(got, twin(data, max_len or None))


@pytest.mark.parametrize("seed", range(4))
def test_filter_emit_matches_twin_and_jax(tn, jn, seed):
    """Spans clamped to the row, empty and reversed spans, empty names,
    nothing kept."""
    rng = np.random.default_rng(seed)
    data = _records(rng, 40, crlf=seed % 2 == 1)
    a, q, lens, noff, nlen = tn.fastq_to_batch_sq(data)
    B, L = a.shape
    start = rng.integers(-5, L + 5, B)
    end = rng.integers(-5, L + 10, B)
    end[::5] = start[::5]
    nlen[::7] = 0
    for keep in (rng.random(B) < 0.6, np.zeros(B, bool), np.ones(B, bool)):
        got = tn.filter_emit(data, a, q, noff, nlen, keep, start, end)
        assert got == jn.filter_emit(data, a, q, noff, nlen, keep, start, end)
        assert got == filters._emit_records(data, a, q, noff, nlen, keep, start, end)


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_qc_fold_matches_device_fold_and_jax(tn, jn, n_threads):
    rng = np.random.default_rng(n_threads)
    R, L = 300, 90
    a = np.frombuffer(b"ACGTacgtNnRY", np.uint8)[rng.integers(0, 12, (R, L))]
    q = rng.integers(20, 110, (R, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, R)

    def fold(fn):
        acc = (np.zeros((L, 5), np.int64), np.zeros((L, qc._QMAX), np.int64),
               np.zeros(qc._QMAX, np.int64), np.zeros(101, np.int64))
        assert fn(a, q, lens, qc._QMAX, *acc, n_threads=n_threads)
        return acc

    got = fold(tn.qc_fold)
    _eq(got, fold(jn.qc_fold))
    _eq(got, tuple(t.numpy() for t in qc._fold_device(
        torch.from_numpy(a), torch.from_numpy(q), torch.from_numpy(lens))))
    with pytest.raises(ValueError, match="int64"):
        tn.qc_fold(a, q, lens, qc._QMAX, np.zeros((L, 5), np.int32), *got[1:])


# -- the assembler's graph passes ---------------------------------------------------


def _key_set(rng, n, k):
    keys = np.unique(rng.integers(0, 4**k, n, dtype=np.uint64) if k < 32
                     else rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2))
    return keys


@pytest.mark.parametrize("k", [1, 2, 5, 9, 21, 32])
def test_merge_join_and_edges_match_twin_and_jax(tn, jn, k, monkeypatch):
    rng = np.random.default_rng(k)
    for n in (0, 1, 4, 300, 3000):
        keys = _key_set(rng, n, k)
        q = np.sort(np.concatenate([keys[: len(keys) // 2],
                                    rng.integers(0, 4**min(k, 31), 50, dtype=np.uint64)]))
        got_j = tn.merge_join(keys, q)
        _eq(got_j, jn.merge_join(keys, q))
        got_e = tn.graph_edges(keys, k)
        _eq(got_e, jn.graph_edges(keys, k))
        with monkeypatch.context() as m:
            _off(m)
            if len(keys):
                _eq(got_j, asm._member(keys, q))
            _eq(got_e, asm._edges(keys, k))


def _forest(rng, n_chains, n_cycles):
    """A predecessor forest of chains (length 1 to 40) and pure cycles,
    its nodes shuffled: prev, and each node's chain length or -1 on a
    cycle."""
    groups, cyc = [], []
    for i in range(n_chains + n_cycles):
        m = int(rng.integers(1, 41))
        groups.append(m)
        cyc.append(i >= n_chains)
    n = sum(groups)
    perm = rng.permutation(n)
    prev = np.full(n, -1, np.int32)
    on_cycle = np.zeros(n, bool)
    pos = 0
    for m, c in zip(groups, cyc):
        nodes = perm[pos : pos + m]
        prev[nodes[1:]] = nodes[:-1]
        if c:
            prev[nodes[0]] = nodes[-1]
            on_cycle[nodes] = True
        pos += m
    return prev, on_cycle


@pytest.mark.parametrize("n_chains,n_cycles", [(0, 0), (1, 0), (40, 0), (0, 1), (30, 7),
                                               (0, 12)])
@pytest.mark.parametrize("n_threads", [1, 4, 0])
def test_list_rank_on_chains_and_cycles(tn, jn, n_chains, n_cycles, n_threads, monkeypatch):
    """Chain nodes: the exact distance to the chain's start, which is
    their jump; cycle nodes rank >= n in the library and its twin alike
    (the ranks themselves differ: the twin stops at a fixed round)."""
    rng = np.random.default_rng(n_chains * 100 + n_cycles)
    prev, on_cycle = _forest(rng, n_chains, n_cycles)
    if n_cycles == 1:
        prev = np.roll(np.arange(64, dtype=np.int32), 1)  # one cycle of 64, a power of two
        on_cycle = np.ones(64, bool)
    n = len(prev)
    rank, jump = tn.list_rank(prev, n_threads)
    _eq((rank, jump), jn.list_rank(prev, n_threads))
    with monkeypatch.context() as m:
        _off(m)
        t_rank, t_jump = asm._wyllie_rank(prev)
    chain = ~on_cycle
    _eq(rank[chain], t_rank[chain])
    _eq(jump[chain], t_jump[chain])
    assert (rank[on_cycle] >= n).all() and (t_rank[on_cycle] >= n).all()
    assert (rank[chain] < max(n, 1)).all()
    for i in np.flatnonzero(chain)[:50]:  # walk a few chains by hand
        d, j = 0, i
        while prev[j] >= 0:
            j, d = prev[j], d + 1
        assert (rank[i], jump[i]) == (d, j)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 10_000])
def test_argsort_u64_matches_numpy_and_jax(tn, jn, n):
    rng = np.random.default_rng(n)
    for keys in (rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
                 rng.integers(0, 5, n).astype(np.uint64),  # ties: stability
                 np.full(n, 2**63, np.uint64),  # constant digits skipped
                 rng.integers(0, 2**20, n).astype(np.uint64) << np.uint64(40)):
        got = tn.argsort_u64(keys)
        assert got.dtype == np.int32
        _eq(got, np.argsort(keys, kind="stable"))
        _eq(got, jn.argsort_u64(keys))


def _reads(rng, n, max_len, alphabet=b"ACGTN"):
    return [bytes(rng.choice(np.frombuffer(alphabet, np.uint8), int(m)))
            for m in rng.integers(0, max_len, n)]


@pytest.mark.parametrize("k", [1, 2, 5, 8, 12, 13, 21, 31, 32])
@pytest.mark.parametrize("canonical", [False, True])
def test_spectrum_matches_twin_and_jax(tn, jn, k, canonical):
    """Both of the library's paths (dense bins for k <= 12 when the windows
    outnumber them, else the radix sort), on int32 word views and uint32
    words, with a mask, a narrow mask and none."""
    rng = np.random.default_rng(k)
    reads = _reads(rng, 60, 120)
    reads[0] = b"T" * 64
    if k <= 2:
        reads += [b"A" * 100] * 3  # a key counted many times
    tr = tbn.PackedReads.from_ascii(reads, validate=False, device=CPU)
    jr = jbn.PackedReads.from_ascii(reads, validate=False)
    L = max(len(r) for r in reads)
    a = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        a[i, : len(r)] = np.frombuffer(r, np.uint8)
    bv = codec.validity_mask(torch.from_numpy(a), tr.lengths).numpy()
    words32 = tr.words.numpy()
    words_u, lens = tr.to_numpy()
    for valid in (None, bv, bv[:, :7]):
        got = tn.spectrum(words32, lens, k, canonical, valid)
        assert got[0].dtype == np.uint64 and got[1].dtype == np.int32
        _eq(got, tn.spectrum(words_u, lens, k, canonical, valid, n_threads=1))
        _eq(got, jn.spectrum(np.asarray(jr.words), np.asarray(jr.lengths), k,
                             canonical=canonical, valid=valid))
        _eq(got, asm._np_spectrum(words_u, lens, k, canonical, valid))


def _clamped_library(tmp_path, count_max: int):
    """The port's library built with its spectrum's clamp lowered to
    count_max (BN_SPECTRUM_COUNT_MAX), loaded with native's signatures."""
    out = tmp_path / "libbitnuc_host_clamp.so"
    proc = subprocess.run([native._compiler(), *native.CXX_FLAGS,
                           f"-DBN_SPECTRUM_COUNT_MAX={count_max}ull", "-o", str(out),
                           str(native.SOURCE)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in native._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def test_spectrum_counts_past_int32_saturate(tn, jn, tmp_path, monkeypatch):
    """A count past the clamp saturates instead of wrapping, in the run-length
    pass after the radix sort. The library clamps at BN_SPECTRUM_COUNT_MAX,
    2^31 - 1; reaching it takes 2^31 windows of one key, whose 16 GiB of
    keys and 16 GiB of sort buffer do not fit here, so a build with the
    clamp lowered to 40 counts keys just under, at and past it: poly-A of
    41 windows, poly-C of 40 and poly-G of 39 at k = 13 (poly-C and
    poly-G are one canonical key of 79), among random reads. Its counts
    equal the twin's and the JAX package's library's clamped at 40, and
    the default build's equal theirs unclamped."""
    source = native.SOURCE.read_text()
    assert "#define BN_SPECTRUM_COUNT_MAX 0x7FFFFFFFull" in source
    rng = np.random.default_rng(13)
    reads = [b"A" * 53, b"C" * 52, b"G" * 51]
    reads += [random_seq(rng, int(n)) for n in rng.integers(10, 90, 40)]
    tr = tbn.PackedReads.from_ascii(reads, validate=False, device=CPU)
    jr = jbn.PackedReads.from_ascii(reads, validate=False)
    words, lens = tr.words.numpy(), tr.lengths.numpy()
    cases = [(k, canonical) for k in (13, 21) for canonical in (False, True)]
    want = {c: asm._np_spectrum(words, lens, *c, None) for c in cases}
    for c in cases:
        _eq(tn.spectrum(words, lens, *c), want[c])
        _eq(jn.spectrum(np.asarray(jr.words), np.asarray(jr.lengths), *c), want[c])
    monkeypatch.setattr(native, "_lib", _clamped_library(tmp_path, 40))
    for k, canonical in cases:
        keys, counts = native.spectrum(words, lens, k, canonical)
        _eq((keys, counts), (want[k, canonical][0], np.minimum(want[k, canonical][1], 40)))
    counts = dict(zip(*native.spectrum(words, lens, 13, False)))
    poly = [int(api.as_2bit(b * 13)) for b in (b"A", b"C", b"G")]
    assert [counts[key] for key in poly] == [40, 40, 39]
    assert dict(zip(*native.spectrum(words, lens, 13, True)))[poly[1]] == 40


def test_inputs_checked_before_the_pointers(tn):
    """Arrays whose sizes or indices would send the C code outside a buffer
    raise; a length past a row's 16 W bases counts that row's windows, as
    the twin does."""
    with pytest.raises(ValueError, match="list_rank"):
        tn.list_rank(np.array([1, 5], np.int32))
    rect = np.zeros((1, 4), np.uint8)
    with pytest.raises(ValueError, match="header span"):
        tn.filter_emit(b"@a\n", rect, rect, [1], [9], [True], [0], [4])
    with pytest.raises(ValueError, match="one entry a row"):
        tn.filter_emit(b"@a\n", rect, rect, [1, 1], [1], [True], [0], [4])
    with pytest.raises(ValueError, match="one entry a row"):
        tn.spectrum(np.zeros((2, 1), np.int32), np.array([16], np.int32), 3)
    with pytest.raises(ValueError, match="one row a read"):
        tn.spectrum(np.zeros((2, 1), np.int32), np.array([16, 16], np.int32), 3,
                    valid=np.ones((1, 16), bool))
    with pytest.raises(ValueError, match="qc_fold"):
        tn.qc_fold(rect, rect, [4], qc._QMAX, np.zeros((3, 5), np.int64),
                   np.zeros((4, qc._QMAX), np.int64), np.zeros(qc._QMAX, np.int64),
                   np.zeros(101, np.int64))
    w = np.random.default_rng(1).integers(-(2**31), 2**31, (3, 2)).astype(np.int32)
    lens = np.array([40, 32, 7], np.int32)
    _eq(tn.spectrum(w, lens, 3), asm._np_spectrum(w.view(np.uint32), lens, 3, False, None))


# -- the build -----------------------------------------------------------------------


def test_two_processes_build_at_once_and_load_one_whole_file(tn, tmp_path):
    """Two fresh processes build into an empty directory at the same moment;
    one compiles, both load the same whole file, and no temporary file is
    left."""
    go = tmp_path / "go"
    code = (
        "import sys, time, numpy as np\n"
        "from pathlib import Path\n"
        "from bitnuc_tpu_torch import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "while not Path(sys.argv[2]).exists():\n"
        "    time.sleep(0.005)\n"
        "assert native.build()\n"
        "print(native.library_path(), int(native.encode(b'ACGT' * 9)[0]),\n"
        "      native.spectrum(np.zeros((1, 4), np.int32), np.array([64], np.int32), 3)[1][0])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build"), str(go)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = {o.strip() for o, _ in outs}
    path = tmp_path / "build" / Path(native.library_path()).name
    word = int.from_bytes(bytes([0b11100100]) * 8, "little")  # ACGT x 8
    assert lines == {f"{path} {word} 62"}
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [path.name, "libbitnuc_host.lock"])


def test_build_without_a_compiler_raises_and_is_unavailable(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    assert not native.available() and "no C++ compiler" in native._error
    assert native.filter_emit(b"", np.zeros((0, 1), np.uint8), np.zeros((0, 1), np.uint8),
                              [], [], [], [], []) is None
    assert native.merge_join(np.arange(3, dtype=np.uint64), np.arange(3, dtype=np.uint64)) is None
    assert native.count_kmers(b"ACGTT", 2) == api._count_kmers_numpy(b"ACGTT", 2)
    with pytest.raises(RuntimeError, match="not available"):
        native.encode(b"ACGT")
    with pytest.raises(RuntimeError, match="not available"):
        native.spectrum(np.full((1, 2), 7, np.int32), np.array([30], np.int32), 4)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.library_path()


# -- the routed paths ------------------------------------------------------------------


def _write(path, data):
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        Path(path).write_bytes(data)
    return path


def _reads_equal(got, want):
    w, n = got.to_numpy()
    np.testing.assert_array_equal(w, np.asarray(want.words))
    np.testing.assert_array_equal(n, np.asarray(want.lengths))


@pytest.mark.parametrize("suffix", [".fq", ".fq.gz"])
def test_io_routes_match_jax(route, tmp_path, suffix):
    mode, calls = route
    rng = np.random.default_rng(5)
    data = _records(rng, 57, crlf=True, blank_every=4)
    p = _write(tmp_path / f"r{suffix}", data)
    _reads_equal(tio.read_fastq_fast(p, validate=False, device=CPU),
                 jio.read_fastq_fast(p, validate=False))
    _reads_equal(tio.read_fastq_fast(data, max_len=30, validate=False, device=CPU),
                 jio.read_fastq_fast(data, max_len=30, validate=False))
    for bs, ml in ((8, None), (20, 40)):
        for g, w in zip(tio.iter_fastq_ascii_batches(p, bs, ml),
                        jio.iter_fastq_ascii_batches(p, bs, ml), strict=True):
            _eq(g, w)
        for g, w in zip(tio.iter_fastq_record_batches(p, bs, ml),
                        jio.iter_fastq_record_batches(p, bs, ml), strict=True):
            _eq(g, w)
        for staged in (None, False) if mode == "numpy" else (None, True, False):
            got = list(tio.iter_fastq_batches(p, bs, ml, validate=False, staged=staged,
                                              with_validity=True, with_offsets=True,
                                              prefetch=2, device=CPU))
            want = list(jio.iter_fastq_batches(p, bs, ml, validate=False, staged=True,
                                               with_validity=True, with_offsets=True))
            assert len(got) == len(want)
            for (gr, gv, go), (wr, wv, wo) in zip(got, want):
                _reads_equal(gr, wr)
                np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
                assert go == wo
    if mode == "library":
        assert calls["fastq_to_batch"] and calls["fastq_to_batch_sq"]


def test_api_routes_match_jax(route):
    mode, calls = route
    rng = np.random.default_rng(9)
    from bitnuc_tpu import api as japi

    for n in (0, 5, 32, 77):
        s = random_seq(rng, n)
        e = api.encode(s)
        _eq(e, japi.encode(s))
        assert api.decode(e, n) == japi.decode(e, n)
        assert api.as_2bit(s[:32]) == japi.as_2bit(s[:32])
        assert api.hdist(e, e[::-1].copy(), n) == japi.hdist(e, e[::-1].copy(), n)
        _eq(api.split_packed(e, n, n // 2), japi.split_packed(e, n, n // 2))
        for k in (3, 12, 13):
            assert api.count_kmers(s, k) == japi.count_kmers(s, k)
    for name, args in [("decode", (e, -1)), ("from_2bit", (5, -1)), ("hdist", (e, e, -5)),
                       ("split_packed", (e, 77, -1)), ("count_kmers", (b"AN", 3)),
                       ("encode", (b"ACGTN",))]:
        _eq(_outcome(getattr(api, name), *args)[:2], _outcome(getattr(japi, name), *args)[:2])
    if mode == "library":
        assert calls["encode"] and calls["count_kmers"] and calls["split_packed"]


def test_api_routes_take_keywords(route):
    """Each routed function of the host API takes its parameters by name,
    as the JAX package's do, on either route."""
    from bitnuc_tpu import api as japi

    mode, calls = route
    e = api.encode.numpy(b"ACGTTGCAAC" * 4)
    calls_by_name = [
        ("as_2bit", dict(seq=b"ACGT")), ("from_2bit", dict(packed=228, n_bases=4)),
        ("encode", dict(seq=b"ACGTTGCA")), ("decode", dict(ebuf=e, n_bases=40)),
        ("hdist", dict(ebuf1=e, ebuf2=e[::-1].copy(), n_bases=40)),
        ("hdist_scalar", dict(u=228, v=27, length=4)),
        ("split_packed", dict(ebuf=e, slen=40, idx=13)),
    ]
    for name, kw in calls_by_name:
        got = getattr(api, name)(**kw)
        _eq(got, getattr(api, name)(*kw.values()))
        _eq(got, getattr(japi, name)(**kw))
    if mode == "library":
        assert all(calls[name] >= 2 for name, _ in calls_by_name)


def test_filter_and_qc_route_match_jax(route, tmp_path):
    mode, calls = route
    rng = np.random.default_rng(11)
    data = _records(rng, 300, blank_every=17)
    src = _write(tmp_path / "in.fq.gz", data)
    kw = dict(min_len=20, trim_q=30, max_n=3, min_mean_q=25)
    for batch in (7, 65536):
        want = jfilters.filter_fastq(src, tmp_path / "want.fq", batch_reads=batch, **kw)
        got = filters.filter_fastq(src, tmp_path / "got.fq", batch_reads=batch, device=CPU,
                                   **kw)
        assert got == want and 0 < got["reads_out"] < got["reads_in"]
        assert (tmp_path / "got.fq").read_bytes() == (tmp_path / "want.fq").read_bytes()
        assert qc.qc_profile(src, batch_reads=batch, device=CPU) == jqc.qc_profile(
            src, batch_reads=batch)
    if mode == "library":
        assert calls["filter_emit"] and calls["fastq_to_batch_sq"]


def test_assemble_reads_routes_match_jax(route):
    mode, calls = route
    rng = np.random.default_rng(12)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 900)].tobytes()
    starts = rng.integers(0, len(genome) - 80, 150)
    reads = [genome[s : s + 80] for s in starts]
    reads[3] = reads[3][:40] + b"N" + reads[3][41:]
    reads.append(b"ACGTT" * 16)  # a cycle
    reads.append(b"ACGTT" * 16)
    tr = tbn.PackedReads.from_ascii(reads, validate=False, device=CPU)
    jr = jbn.PackedReads.from_ascii(reads, validate=False)
    L = max(len(r) for r in reads)
    a = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        a[i, : len(r)] = np.frombuffer(r, np.uint8)
    jbv = np.asarray(jcodec.validity_mask(a, np.asarray(jr.lengths)))
    for k, both, clean in ((21, True, False), (15, False, True), (21, True, True)):
        kw = dict(min_count=1, both_strands=both, clean=clean)
        want = jasm.assemble_reads(jr, k, base_valid=jbv, engine="host", **kw)
        assert want[0]
        for engine in ("device", "host"):
            got = asm.assemble_reads(tr, k, base_valid=jbv, engine=engine, **kw)
            assert got == want
    if mode == "library":
        assert calls["spectrum"] and calls["graph_edges"] and calls["list_rank"]
        assert calls["argsort_u64"]


def test_info_reports_native(route, capsys):
    from bitnuc_tpu import cli as jcli

    mode, _ = route
    assert cli.main(["--device", "cpu", "info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["native"] is (mode == "library")
    assert jcli.main(["info"]) == 0
    assert json.loads(capsys.readouterr().out)["native"] is True
