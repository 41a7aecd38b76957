"""bitnuc_tpu_torch's FASTQ readers against the JAX package's on the same
files: fastq_to_batch and fastq_to_batch_sq (numpy, the port's twins of
JAX's native scanner), read_fastq, read_fastq_fast,
split_records_fastq_full, iter_fastq_ascii_batches and
iter_fastq_record_batches, on files with CRLF, blank lines, an empty read, a
trailing record without its newline, max_len truncation, gzip and a bad
header."""

import gzip

import numpy as np
import pytest
import torch

from bitnuc_tpu import io as jio, native
from bitnuc_tpu_torch import io as tio
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="the JAX package's native library is not built")

EMPTY_READ = b"@r1\n\n+\n\n@r2\nACGT\n+\nIIII\n@r3\nGG\n+\nII\n"


@needs_native
def test_fastq_to_batch_empty_read_equals_native():
    """A record whose sequence is empty is a read of length 0; the records
    after it keep their framing."""
    got = tio.fastq_to_batch(EMPTY_READ)
    want = native.fastq_to_batch(EMPTY_READ, 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [0, 4, 2]
    assert [bytes(r[:n]) for r, n in zip(*got)] == [b"", b"ACGT", b"GG"]


def _records(rng, n, crlf=False, blank=False, empty_at=None, no_final_newline=False):
    nl = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        s = random_seq(rng, int(rng.integers(1, 90))) if i != empty_at else b""
        out.append(b"@read_%d extra%s%s%s+%s%s%s" % (i, nl, s, nl, nl, b"I" * len(s), nl))
        if blank and i % 3 == 1:
            out.append(nl)
    data = b"".join(out)
    return data[: -len(nl)] if no_final_newline else data


FILES = {
    "plain": dict(),
    "crlf": dict(crlf=True),
    "blank_lines": dict(blank=True),
    "crlf_blank": dict(crlf=True, blank=True),
    "no_final_newline": dict(no_final_newline=True),
    "empty_read": dict(empty_at=3),
}


# both packages' block framers refuse a blank sequence line
# (test_block_framers_refuse_bad_headers)
STREAMED = [n for n in FILES if n != "empty_read"]


@pytest.fixture(params=list(FILES))
def fastq_bytes(request, rng):
    return request.param, _records(rng, 23, **FILES[request.param])


def _write(tmp_path, data, gz=False):
    p = tmp_path / ("r.fq.gz" if gz else "r.fq")
    if gz:
        with gzip.open(p, "wb") as f:
            f.write(data)
    else:
        p.write_bytes(data)
    return p


def _same_reads(got, want):
    w, n = got.to_numpy()
    np.testing.assert_array_equal(w, np.asarray(want.words))
    np.testing.assert_array_equal(n, np.asarray(want.lengths))


@pytest.mark.parametrize("max_len", [None, 40])
def test_read_fastq_matches_jax(tmp_path, fastq_bytes, max_len):
    """read_fastq's strict 4-line records (its framing of blank lines is
    its own) on bytes, a path and a .gz path."""
    name, data = fastq_bytes
    for src in (data, _write(tmp_path, data), _write(tmp_path, data, gz=True)):
        try:
            want = jio.read_fastq(src, max_len=max_len, validate=False)
        except ValueError as e:
            with pytest.raises(ValueError, match="malformed FASTQ header"):
                tio.read_fastq(src, max_len=max_len, validate=False, device=CPU)
            assert "malformed" in str(e)
            continue
        got = tio.read_fastq(src, max_len=max_len, validate=False, device=CPU)
        assert got[0] == want[0]
        _same_reads(got[1], want[1])


@needs_native
@pytest.mark.parametrize("max_len", [None, 40])
def test_read_fastq_fast_matches_jax(tmp_path, fastq_bytes, max_len):
    name, data = fastq_bytes
    for src in (data, _write(tmp_path, data, gz=True)):
        _same_reads(tio.read_fastq_fast(src, max_len=max_len, device=CPU),
                    jio.read_fastq_fast(src, max_len=max_len))


@needs_native
def test_read_fastq_fast_empty_read_equals_native():
    got = tio.read_fastq_fast(EMPTY_READ, device=CPU)
    _same_reads(got, jio.read_fastq_fast(EMPTY_READ))
    assert [s.to_vec() for s in got] == [b"", b"ACGT", b"GG"]
    assert jio.read_fastq(EMPTY_READ)[1].to_ascii() == [b"", b"ACGT", b"GG"]


def test_split_records_fastq_full_matches_jax(fastq_bytes):
    _, data = fastq_bytes
    assert tio.split_records_fastq_full(data) == jio.split_records_fastq_full(data)
    assert tio.split_records_fastq_full(EMPTY_READ) == jio.split_records_fastq_full(EMPTY_READ)


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if not isinstance(a, np.ndarray):  # raw bytes, end offsets
                assert a == b
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@needs_native
@pytest.mark.parametrize("batch_size,max_len", [(1, None), (5, None), (7, 30), (100, None)])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("name", STREAMED)
def test_iter_fastq_ascii_batches_matches_jax(tmp_path, rng, name, batch_size, max_len, gz):
    p = _write(tmp_path, _records(rng, 23, **FILES[name]), gz)
    _batches_equal(tio.iter_fastq_ascii_batches(p, batch_size, max_len),
                   jio.iter_fastq_ascii_batches(p, batch_size, max_len))
    first = next(tio.iter_fastq_ascii_batches(p, batch_size, max_len))
    _batches_equal(tio.iter_fastq_ascii_batches(p, batch_size, max_len, start_offset=first[2]),
                   jio.iter_fastq_ascii_batches(p, batch_size, max_len, start_offset=first[2]))


@needs_native
@pytest.mark.parametrize("batch_size,max_len", [(1, None), (5, None), (7, 30), (100, None)])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("name", STREAMED)
def test_iter_fastq_record_batches_matches_jax(tmp_path, rng, name, batch_size, max_len, gz):
    """Qualities clamped to L like the sequence; name spans into the raw
    bytes past '@', without a trailing '\\r'."""
    p = _write(tmp_path, _records(rng, 23, **FILES[name]), gz)
    _batches_equal(tio.iter_fastq_record_batches(p, batch_size, max_len),
                   jio.iter_fastq_record_batches(p, batch_size, max_len))
    raw, _, quals, lens, off, nlen = next(tio.iter_fastq_record_batches(p, batch_size, max_len))
    assert raw[off[0] : off[0] + nlen[0]] == b"read_0 extra"
    assert (quals[0, : lens[0]] == ord("I")).all()


@pytest.mark.parametrize("fn", ["iter_fastq_ascii_batches", "iter_fastq_record_batches"])
def test_block_framers_refuse_bad_headers(tmp_path, fn):
    """A blank sequence line shifts the block framer's records, and a header
    without '@' is refused: ValueError in both packages."""
    for data in (EMPTY_READ, b"@a\nAC\n+\nII\nxb\nAC\n+\nII\n"):
        p = _write(tmp_path, data)
        with pytest.raises(ValueError, match="malformed FASTQ header"):
            list(getattr(tio, fn)(p, 2))
        with pytest.raises(ValueError, match="malformed FASTQ header"):
            list(getattr(jio, fn)(p, 2))


def test_read_fastq_bad_header_raises():
    bad = b"@a\nAC\n+\nII\nxb\nAC\n+\nII\n"
    with pytest.raises(ValueError, match="malformed FASTQ header at record 1"):
        tio.read_fastq(bad, device=CPU)
    with pytest.raises(ValueError, match="malformed FASTQ header at record 1"):
        jio.read_fastq(bad)


@needs_native
@pytest.mark.parametrize("max_len", [0, 1, 3])
def test_fastq_to_batch_sq_matches_native_on_ragged_framing(max_len):
    """Blank lines at every position of a record, CR-only lines, a header
    with no name, records cut short after each line."""
    rng = np.random.default_rng(max_len)
    pieces = [b"@x", b"@", b"ACGT", b"", b"\r", b"+", b"II", b"ACGTACGTAA\r"]
    for _ in range(300):
        parts = [pieces[i] for i in rng.integers(0, len(pieces), int(rng.integers(0, 14)))]
        data = b"\n".join(parts) + (b"\n" if rng.random() < 0.5 else b"")
        for got, want in ((tio.fastq_to_batch(data, max_len), native.fastq_to_batch(data, max_len)),
                          (tio.fastq_to_batch_sq(data, max_len),
                           native.fastq_to_batch_sq(data, max_len))):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_validate_raises_invalid_base():
    from bitnuc_tpu_torch.errors import InvalidBase

    data = b"@a\nACNT\n+\nIIII\n"
    with pytest.raises(InvalidBase):
        tio.read_fastq(data, device=CPU)
    with pytest.raises(InvalidBase):
        tio.read_fastq_fast(data, device=CPU)
    assert tio.read_fastq_fast(data, validate=False, device=CPU).lengths.tolist() == [4]
