"""bitnuc_tpu_torch.filters against bitnuc_tpu.filters on the same
numpy-seeded reads and qualities.

* The fused core: every combination of _filter_core's flags (adapter or
  none, trim, mean quality, N count, complexity, entropy), keep, start and
  end against the JAX kernel's. keep is held exactly wherever the read's
  triplet entropy lies more than 1e-4 from min_entropy: the entropy is a
  float32 sum of log2 terms on both sides, and its last bit may differ
  between the two libraries. The port's float32 entropy itself is held
  within 1e-5 of the float64 numpy reference.
* The numpy reference: filter_reads(use_jax=False) and its four helpers
  against the JAX package's, exactly.
* L < 3 with an entropy filter, adapters planted at and past the read's
  end, lower-case bases.
* filter_fastq and filter_fastq_paired output files byte for byte, plain
  and .gz, and the paired reader's ValueErrors.
"""

import gzip
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu import filters as jfilters, native
from bitnuc_tpu_torch import filters

torch.set_num_threads(1)
CPU = torch.device("cpu")
ADAPTER = b"AGATCGGAAGAGC"
ENT_TOL = 1e-4  # |h - min_entropy| within which keep may differ
H_TOL = 1e-5  # float32 entropy against the float64 reference


def _records(rng, n, lo=1, hi=90):
    """Reads with planted adapters (some cut off by the read's end), N
    runs, poly-A, lower case, and qualities declining along the read."""
    seqs, quals = [], []
    for i in range(n):
        L = int(rng.integers(lo, hi))
        s = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), L).tobytes())
        kind = i % 7
        if kind == 1 and L > 3:  # adapter inside or running off the end
            p = int(rng.integers(0, L))
            a = ADAPTER[: L - p]
            if rng.random() < 0.5 and len(a) > 4:
                a = bytearray(a)
                a[int(rng.integers(0, len(a)))] = ord("T")
            s[p : p + len(a)] = a
        elif kind == 2:
            s[:] = b"A" * L
        elif kind == 3:
            for q in rng.integers(0, L, 1 + L // 10):
                s[q] = ord("N")
        elif kind == 4:
            s = bytearray(bytes(s).lower())
        elif kind == 5:
            s[:] = (b"ACG" * L)[:L]
        q = np.clip(rng.normal(38, 3, L) - np.arange(L) * rng.uniform(0, 0.4), 2, 41)
        q = (q + 33).astype(np.uint8)
        if i % 5 == 0:
            q[: int(rng.integers(0, 4))] = 35
        seqs.append(bytes(s))
        quals.append(q.tobytes())
    return seqs, quals


def _rect(seqs, quals):
    lens = np.array([len(s) for s in seqs], np.int64)
    L = max(int(lens.max()), 1)
    a = np.zeros((len(seqs), L), np.uint8)
    q = np.zeros((len(seqs), L), np.uint8)
    for i, (s, qq) in enumerate(zip(seqs, quals)):
        a[i, : len(s)] = np.frombuffer(s, np.uint8)
        q[i, : len(qq)] = np.frombuffer(qq, np.uint8)
    return a, q, lens


PARAMS = dict(min_len=20, min_mean_q=25.0, trim_q=22, max_n=2, err=0.1, minov=3,
              min_cplx=0.3, min_ent=3.0)
FLAGS = list(itertools.product([0, len(ADAPTER)], *[[False, True]] * 5))


def _core_args(a, q, lens, m, lib, p=PARAMS):
    """The core's arguments as the JAX package's _filter_call builds them,
    as jnp arrays (lib='jax') or CPU tensors."""
    ad = np.frombuffer(ADAPTER[:m], np.uint8)
    if lib == "jax":
        return (jnp.asarray(a), jnp.asarray(q), jnp.asarray(lens.astype(np.int32)),
                jnp.asarray(ad), jnp.int32(p["min_len"]), jnp.float32(p["min_mean_q"]),
                jnp.int32(p["trim_q"]), jnp.int32(p["max_n"]), jnp.float32(p["err"]),
                jnp.int32(p["minov"]), jnp.float32(p["min_cplx"]), jnp.float32(p["min_ent"]))
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return (torch.from_numpy(a), torch.from_numpy(q), torch.from_numpy(lens.astype(np.int32)),
            torch.from_numpy(ad.copy()), i32(p["min_len"]), f32(p["min_mean_q"]),
            i32(p["trim_q"]), i32(p["max_n"]), f32(p["err"]), i32(p["minov"]),
            f32(p["min_cplx"]), f32(p["min_ent"]))


def _hold_core(a, q, lens, flags, p=PARAMS):
    m, *rest = flags
    want = [np.asarray(x) for x in jfilters._filter_core(m, *rest)(*_core_args(a, q, lens, m,
                                                                               "jax", p))]
    got = filters._filter_core(m, *rest)(*_core_args(a, q, lens, m, "torch", p))
    assert got[0].dtype == torch.bool and got[1].dtype == got[2].dtype == torch.int32
    got = [g.numpy() for g in got]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    h = jfilters.triplet_entropy(a, want[1].astype(np.int64), want[2].astype(np.int64))
    sure = np.abs(h - p["min_ent"]) > ENT_TOL if rest[-1] else np.ones(len(h), bool)
    np.testing.assert_array_equal(got[0][sure], want[0][sure])
    return got


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, map(int, f))))
def test_filter_core_matches_jax_every_flag(flags):
    rng = np.random.default_rng(sum(int(x) << i for i, x in enumerate(flags)))
    a, q, lens = _rect(*_records(rng, 120))
    keep, _, _ = _hold_core(a, q, lens, flags)
    if any(flags[1:]) or flags[0]:
        assert 0 < keep.sum() < len(keep)


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("min_ent", [0.0, 6.0, 7.0])
def test_filter_core_short_rows_entropy_rule(L, min_ent):
    rng = np.random.default_rng(L)
    a, q, lens = _rect(*_records(rng, 20, 1, L + 1))
    p = dict(PARAMS, min_ent=min_ent, min_len=1)
    _hold_core(a, q, lens, (0, True, False, True, True, True), p)
    # the JAX kernel cannot take an adapter longer than L + 1 (its shifted
    # rows stop broadcasting); the port's core equals the numpy reference
    kw = dict(adapter=ADAPTER, trim_q=22, max_n=2, min_complexity=0.3, min_entropy=min_ent)
    ref = jfilters.filter_reads(a, q, lens, use_jax=False, **kw)
    for g, w in zip(filters.filter_reads(a, q, lens, device=CPU, **kw), ref):
        np.testing.assert_array_equal(g, w)


def test_entropy_f32_within_tolerance_of_reference():
    rng = np.random.default_rng(11)
    a, q, lens = _rect(*_records(rng, 300, 1, 150))
    start = rng.integers(0, 20, len(lens))
    end = np.maximum(start, lens - rng.integers(0, 20, len(lens)))
    at = torch.from_numpy(a)
    lower = at | 0x20
    acgt = (lower == 97) | (lower == 99) | (lower == 103) | (lower == 116)
    pos = torch.arange(a.shape[1], dtype=torch.int32)[None, :]
    h = filters._entropy_f32(at, acgt, torch.from_numpy(start.astype(np.int32)),
                             torch.from_numpy(end.astype(np.int32)), pos)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), jfilters.triplet_entropy(a, start, end), atol=H_TOL,
                               rtol=0)


@pytest.mark.parametrize("kw", [
    {},
    dict(min_len=30, min_mean_q=20, trim_q=20, max_n=1),
    dict(adapter=ADAPTER, min_len=10),
    dict(adapter=b"agatc", adapter_max_error=0.2, adapter_min_overlap=1, trim_q=30),
    dict(min_complexity=0.4, min_entropy=3.5, max_n=0),
    dict(adapter=ADAPTER, trim_q=20, min_len=30, min_mean_q=20, max_n=5,
         min_complexity=0.3, min_entropy=3.0),
])
def test_filter_reads_both_paths_match_jax(kw):
    rng = np.random.default_rng(len(kw))
    a, q, lens = _rect(*_records(rng, 200))
    ref = jfilters.filter_reads(a, q, lens, use_jax=False, **kw)
    got = filters.filter_reads(a, q, lens, use_jax=False, **kw)
    for g, w in zip(got, ref):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    fused_j = jfilters.filter_reads(a, q, lens, **kw)
    fused = filters.filter_reads(a, q, lens, device=CPU, **kw)
    for g, w in zip(fused[1:], fused_j[1:]):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    sure = np.ones(len(lens), bool)
    if "min_entropy" in kw:
        h = jfilters.triplet_entropy(a, fused_j[1], fused_j[2])
        sure = np.abs(h - kw["min_entropy"]) > ENT_TOL
    assert fused[0].dtype == bool
    np.testing.assert_array_equal(fused[0][sure], fused_j[0][sure])


def test_numpy_reference_helpers_match_jax():
    rng = np.random.default_rng(4)
    a, q, lens = _rect(*_records(rng, 150))
    for tq in (0, 20, 40):
        for g, w in zip(filters.trim_bounds(q, lens, tq), jfilters.trim_bounds(q, lens, tq)):
            np.testing.assert_array_equal(g, w)
    for ad, err, mo in ((ADAPTER, 0.1, 3), (b"ACG", 0.0, 1), (b"", 0.1, 3), (ADAPTER, 0.3, 8)):
        np.testing.assert_array_equal(filters.adapter_positions(a, lens, ad, err, mo),
                                      jfilters.adapter_positions(a, lens, ad, err, mo))
    start, end = jfilters.trim_bounds(q, lens, 25)
    np.testing.assert_array_equal(filters.complexity_fraction(a, start, end),
                                  jfilters.complexity_fraction(a, start, end))
    np.testing.assert_array_equal(filters.triplet_entropy(a, start, end),
                                  jfilters.triplet_entropy(a, start, end))
    np.testing.assert_array_equal(filters.triplet_entropy(a[:, :2], start, end),
                                  jfilters.triplet_entropy(a[:, :2], start, end))


def test_adapter_at_the_read_end_is_cut():
    """A prefix of min_overlap (3) bases at the end is cut, one of 2 is not."""
    reads = [b"ACGTTGCATGCA" + ADAPTER[:5], b"ACGTTGCATGCA" + ADAPTER, b"ACGTTGCATGCAAGA",
             b"ACGTTGCATGCAAG"]
    quals = [b"I" * len(s) for s in reads]
    a, q, lens = _rect(reads, quals)
    for use_jax in (False, None):
        keep, start, end = filters.filter_reads(a, q, lens, adapter=ADAPTER, use_jax=use_jax,
                                                device=CPU)
        assert end.tolist() == [12, 12, 12, 14]
    _hold_core(a, q, lens, (len(ADAPTER), False, False, False, False, False))


def _write_fastq(path, seqs, quals, names=None, crlf=False):
    nl = b"\r\n" if crlf else b"\n"
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for i, (s, q) in enumerate(zip(seqs, quals)):
            name = names[i] if names else b"r%d desc %d" % (i, i % 3)
            f.write(b"@" + name + nl + s + nl + b"+" + nl + q + nl)
            if i % 17 == 0:
                f.write(nl)  # a blank line between records


FILE_KW = [
    dict(min_len=20, trim_q=20),
    dict(adapter=ADAPTER, trim_q=20, min_len=30, min_mean_q=20, max_n=5, min_complexity=0.3,
         min_entropy=3.0),
    dict(max_n=0, min_entropy=2.0),
]


@pytest.mark.skipif(not native.available(), reason="the JAX package writes through its native "
                    "library here; without it its reader strips headers differently")
@pytest.mark.parametrize("kw", FILE_KW)
@pytest.mark.parametrize("suffix", [".fq", ".fq.gz"])
@pytest.mark.parametrize("batch", [7, 65536])
def test_filter_fastq_matches_jax_byte_for_byte(tmp_path, kw, suffix, batch):
    rng = np.random.default_rng(batch + len(kw))
    seqs, quals = _records(rng, 160, 1, 120)
    src = tmp_path / f"in{suffix}"
    _write_fastq(src, seqs, quals)
    want = jfilters.filter_fastq(src, tmp_path / "want.fq", batch_reads=batch, **kw)
    got = filters.filter_fastq(src, tmp_path / "got.fq", batch_reads=batch, device=CPU, **kw)
    assert got == want
    assert (tmp_path / "got.fq").read_bytes() == (tmp_path / "want.fq").read_bytes()
    assert 0 < got["reads_out"] < got["reads_in"]


def test_emit_records_matches_a_record_loop():
    """The vectorised emit against the JAX package's record loop: spans
    clamped to the row, empty spans, empty names."""
    rng = np.random.default_rng(8)
    raw = b"@r1\n@\n@name three\n"
    noff = np.array([1, 5, 8, 1])
    nlen = np.array([2, 0, 10, 2])
    a = rng.integers(65, 90, (4, 12)).astype(np.uint8)
    q = rng.integers(33, 70, (4, 12)).astype(np.uint8)
    keep = np.array([True, True, False, True])
    start = np.array([0, 3, 2, -4])
    end = np.array([12, 3, 9, 40])
    want = b""
    for i in np.nonzero(keep)[0]:
        s0, e0 = max(int(start[i]), 0), min(int(end[i]), 12)
        e0 = max(e0, s0)
        want += b"@%s\n%s\n+\n%s\n" % (raw[noff[i] : noff[i] + nlen[i]], a[i, s0:e0].tobytes(),
                                       q[i, s0:e0].tobytes())
    assert filters._emit_records(raw, a, q, noff, nlen, keep, start, end) == want
    assert filters._emit_records(raw, a, q, noff, nlen, np.zeros(4, bool), start, end) == b""


@pytest.mark.parametrize("kw", FILE_KW[:2])
@pytest.mark.parametrize("batch", [5, 65536])
def test_filter_fastq_paired_matches_jax_byte_for_byte(tmp_path, kw, batch):
    rng = np.random.default_rng(batch)
    s1, q1 = _records(rng, 90, 1, 120)
    s2, q2 = _records(rng, 90, 1, 120)
    _write_fastq(tmp_path / "a1.fq", s1, q1)
    _write_fastq(tmp_path / "a2.fq.gz", s2, q2, crlf=True)
    ins = (tmp_path / "a1.fq", tmp_path / "a2.fq.gz")
    want = jfilters.filter_fastq_paired(*ins, tmp_path / "w1", tmp_path / "w2",
                                        batch_reads=batch, **kw)
    got = filters.filter_fastq_paired(*ins, tmp_path / "g1", tmp_path / "g2",
                                      batch_reads=batch, device=CPU, **kw)
    assert got == want and 0 < got["pairs_out"] < got["pairs_in"]
    for x in ("1", "2"):
        assert (tmp_path / f"g{x}").read_bytes() == (tmp_path / f"w{x}").read_bytes()


@pytest.mark.parametrize("n1,n2,batch,match", [
    (10, 7, 4, "different record counts"),
    (10, 8, 4, "fewer records"),
    (8, 10, 4, "more records"),
    (6, 9, 100, "different record counts"),
])
def test_filter_fastq_paired_errors_match_jax(tmp_path, n1, n2, batch, match):
    rng = np.random.default_rng(n1 * n2)
    s, q = _records(rng, max(n1, n2), 30, 60)
    _write_fastq(tmp_path / "r1.fq", s[:n1], q[:n1])
    _write_fastq(tmp_path / "r2.fq", s[:n2], q[:n2])
    for mod, kw in ((jfilters, {}), (filters, dict(device=CPU))):
        with pytest.raises(ValueError, match=match):
            mod.filter_fastq_paired(tmp_path / "r1.fq", tmp_path / "r2.fq", tmp_path / "o1",
                                    tmp_path / "o2", batch_reads=batch, **kw)


def test_fused_filter_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, q, lens = _rect([b"ACGT"], [b"IIII"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        filters.filter_reads(a, q, lens)
    assert filters.filter_reads(a, q, lens, use_jax=False)[0].tolist() == [True]
