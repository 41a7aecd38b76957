"""bitnuc_tpu_torch FASTA input and pipeline.count_fasta against bitnuc_tpu on
the same files: plain and .gz FASTA with several contigs, runs of N and
contigs shorter than k, at k = 8 (dense histogram) and k = 21 ({key:
count}), counted in small segments so the (k-1)-base overlaps matter.
Counts match exactly."""

import gzip

import numpy as np
import pytest
import torch

from bitnuc_tpu import io as jio, pipeline as jpipeline
from bitnuc_tpu.errors import InvalidBase as JInvalidBase
from bitnuc_tpu_torch import io as tio, pipeline
from bitnuc_tpu_torch.errors import InvalidBase

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _fasta_bytes(seed, with_n=True):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate((230, 97, 15, 310)):
        s = bytearray(rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), n))
        if with_n and n > 100:
            s[40:52] = b"N" * 12  # a run of N
            s[n - 3] = ord("N")
        lines = [bytes(s[j : j + 60]) for j in range(0, n, 60)]
        out.append(b">c%d desc > with a bracket\n" % i + b"\n".join(lines) + b"\n")
    return b"".join(out)


@pytest.fixture(params=["plain", "gz"])
def fasta(request, tmp_path):
    data = _fasta_bytes(3)
    if request.param == "gz":
        p = tmp_path / "g.fa.gz"
        p.write_bytes(gzip.compress(data, compresslevel=1))
    else:
        p = tmp_path / "g.fa"
        p.write_bytes(data)
    return p


@pytest.mark.parametrize("k,canonical", [(8, False), (8, True), (21, True)])
def test_count_fasta_skip_matches_jax(fasta, k, canonical):
    kw = dict(canonical=canonical, on_invalid="skip", seg_bases=50)
    want = jpipeline.count_fasta(fasta, k, **kw)
    got = pipeline.count_fasta(fasta, k, device=CPU, **kw)
    if k <= 12:
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and len(got) > 0
    # the segment width does not change the counts
    whole = pipeline.count_fasta(fasta, k, canonical=canonical, on_invalid="skip",
                                  device=CPU)
    if k <= 12:
        np.testing.assert_array_equal(whole, got)
    else:
        assert whole == got


def test_count_fasta_raise_and_bytes(tmp_path):
    clean = _fasta_bytes(4, with_n=False)
    for k in (5, 17):
        want = jpipeline.count_fasta(clean, k, seg_bases=64)
        got = pipeline.count_fasta(clean, k, seg_bases=64, sparse_capacity=64, device=CPU)
        if k <= 12:
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
    dirty = _fasta_bytes(4)
    with pytest.raises(JInvalidBase) as je:
        jpipeline.count_fasta(dirty, 21)
    with pytest.raises(InvalidBase) as te:
        pipeline.count_fasta(dirty, 21, device=CPU)
    assert te.value.base == je.value.base == ord("N")
    assert pipeline.count_fasta(b">x\nACG\n", 21, device=CPU) == {}
    assert not pipeline.count_fasta(b"", 4, device=CPU).any()
    with pytest.raises(ValueError):
        pipeline.count_fasta(clean, 21, seg_bases=8, device=CPU)


def test_read_fasta_matches_jax(fasta):
    names, reads = tio.read_fasta(fasta, validate=False, device=CPU)
    jnames, jreads = jio.read_fasta(str(fasta), validate=False)
    assert names == jnames
    got = reads.to_ascii()
    assert [s.upper() for s in got] == [s for s in jreads.to_ascii()]
    assert tio.sniff_format(fasta) == jio.sniff_format(fasta) == "fasta"
    data = _fasta_bytes(3)
    assert tio._split_records_fasta(data) == jio._split_records_fasta(data)
    assert tio._read_bytes(fasta) == data
