"""bitnuc_tpu_torch.pipeline.count_fastq against bitnuc_tpu.pipeline on the
same small FASTQ files, plain and .gz: equal histograms (k <= 12) and
dicts (k > 12, the sparse engine, with and without capacity doubling)
under on_invalid 'skip' and 'raise', crash/resume, and dense and sparse
checkpoints that move between the packages in both directions, and the
mesh paths of count_fastq and count_fasta on 3 and 8 CPU shards against
JAX's mesh of as many devices. Counts match exactly."""

import gzip

import jax
import numpy as np
import pytest
import torch

from bitnuc_tpu import io as jio, pipeline as jpipeline
from bitnuc_tpu.errors import InvalidBase as JInvalidBase
from bitnuc_tpu_torch import io as tio, pipeline
from bitnuc_tpu_torch.errors import InvalidBase, InvalidLength
from bitnuc_tpu_torch.parallel import mesh as pmesh
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def fastq_n(tmp_path, rng):
    seqs = []
    for n in rng.integers(20, 120, 45):
        s = bytearray(random_seq(rng, int(n)).upper())
        s[rng.integers(len(s))] = ord("N")
        seqs.append(bytes(s))
    p = tmp_path / "ns.fq"
    with open(p, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@n%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
        f.write(b"\n")  # a trailing blank line does not start a record
    return p


@pytest.fixture
def fastq_clean(tmp_path, rng):
    p = tmp_path / "clean.fq"
    with open(p, "wb") as f:
        for i, n in enumerate(rng.integers(10, 90, 30)):
            s = random_seq(rng, int(n)).upper()
            f.write(b"@c%d\r\n%s\r\n+\r\n%s\r\n" % (i, s, b"I" * len(s)))
    return p


def _on_cpu(mod):
    """The port's entry points take the CPU by name; the JAX package's
    run on its own default."""
    return {"device": CPU} if mod is pipeline else {}


class _Boom(RuntimeError):
    pass


def _crashing(real_iter, after):
    def wrapper(*args, **kwargs):
        for i, item in enumerate(real_iter(*args, **kwargs)):
            if i == after:
                raise _Boom()
            yield item

    return wrapper


@pytest.mark.parametrize("k,canonical", [(5, False), (6, True), (12, True)])
def test_count_fastq_skip_matches_jax(fastq_n, k, canonical):
    kw = dict(batch_size=8, canonical=canonical, on_invalid="skip")
    want = jpipeline.count_fastq(fastq_n, k, **kw)
    got = pipeline.count_fastq(fastq_n, k, device=CPU, **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_count_fastq_raise_matches_jax(fastq_clean, fastq_n):
    want = jpipeline.count_fastq(fastq_clean, 4, batch_size=7, max_len=64)
    got = pipeline.count_fastq(fastq_clean, 4, batch_size=7, max_len=64, device=CPU)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(JInvalidBase) as je:
        jpipeline.count_fastq(fastq_n, 4, batch_size=8)
    with pytest.raises(InvalidBase) as te:
        pipeline.count_fastq(fastq_n, 4, batch_size=8, device=CPU)
    assert te.value.base == je.value.base


def test_batch_offsets_match_jax(fastq_n):
    want = [item[-1] for item in jio.iter_fastq_batches(
        fastq_n, 8, validate=False, with_offsets=True)]
    got = [item[-1] for item in tio.iter_fastq_batches(
        fastq_n, 8, validate=False, with_offsets=True, device=CPU)]
    assert got == want
    resumed = list(tio.iter_fastq_batches(fastq_n, 8, validate=False, start_offset=got[1],
                                         device=CPU))
    first = list(tio.iter_fastq_batches(fastq_n, 8, validate=False, device=CPU))
    assert [r.to_ascii() for r in resumed] == [r.to_ascii() for r in first[2:]]


def test_crash_resume(fastq_n, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "t.npz")
    kw = dict(batch_size=8, on_invalid="skip", checkpoint=ckpt, checkpoint_every=1, device=CPU)
    monkeypatch.setattr(tio, "iter_fastq_batches", _crashing(tio.iter_fastq_batches, 3))
    with pytest.raises(_Boom):
        pipeline.count_fastq(fastq_n, 5, **kw)
    monkeypatch.undo()
    got = pipeline.count_fastq(fastq_n, 5, **kw)
    np.testing.assert_array_equal(got, pipeline.count_fastq(fastq_n, 5, batch_size=8, on_invalid="skip",
                                                       device=CPU))
    with pytest.raises(ValueError, match="batch_size"):
        pipeline.count_fastq(fastq_n, 5, **{**kw, "batch_size": 16})


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_moves_between_packages(fastq_n, tmp_path, monkeypatch, writer):
    """A checkpoint written by one package's crashed job resumes in the
    other and gives the uninterrupted job's histogram."""
    ckpt = str(tmp_path / f"{writer}.npz")
    kw = dict(batch_size=8, canonical=True, on_invalid="skip", checkpoint=ckpt,
              checkpoint_every=2)
    first, second = (jpipeline, pipeline) if writer == "jax" else (pipeline, jpipeline)
    io_mod = jio if writer == "jax" else tio
    monkeypatch.setattr(io_mod, "iter_fastq_batches",
                        _crashing(io_mod.iter_fastq_batches, 3))
    with pytest.raises(_Boom):
        first.count_fastq(fastq_n, 6, **kw, **_on_cpu(first))
    monkeypatch.undo()
    with np.load(ckpt) as z:
        assert int(z["n_batches"]) == 2
    resumed = second.count_fastq(fastq_n, 6, **kw, **_on_cpu(second))
    whole = jpipeline.count_fastq(fastq_n, 6, batch_size=8, canonical=True, on_invalid="skip")
    np.testing.assert_array_equal(resumed, whole)


def test_progress_hook(fastq_n):
    events = []
    pipeline.count_fastq(fastq_n, 5, batch_size=8, on_invalid="skip", device=CPU,
                         on_progress=events.append, progress_every=2)
    assert [e["batches"] for e in events] == [2, 4, 6]  # 45 reads, 6 batches
    assert all(e["bases_per_sec"] > 0 for e in events)


def test_large_k_not_ported_yet(fastq_n):
    """k > 12 now runs the sparse engine and returns JAX's dict; bad
    arguments still raise."""
    got = pipeline.count_fastq(fastq_n, 21, batch_size=8, on_invalid="skip", device=CPU)
    assert got == jpipeline.count_fastq(fastq_n, 21, batch_size=8, on_invalid="skip")
    with pytest.raises(ValueError):
        pipeline.count_fastq(fastq_n, 5, on_invalid="ignore", device=CPU)
    with pytest.raises(InvalidLength):
        pipeline.count_fastq(fastq_n, 33, device=CPU)


@pytest.fixture
def fastq_gz(tmp_path, fastq_n):
    p = tmp_path / "ns.fq.gz"
    p.write_bytes(gzip.compress(fastq_n.read_bytes(), compresslevel=1))
    return p


@pytest.mark.parametrize("k,canonical", [(13, False), (21, True), (32, True)])
@pytest.mark.parametrize("compressed", [False, True])
def test_count_fastq_sparse_matches_jax(fastq_n, fastq_gz, k, canonical, compressed):
    path = fastq_gz if compressed else fastq_n
    kw = dict(batch_size=8, canonical=canonical, on_invalid="skip")
    want = jpipeline.count_fastq(path, k, **kw)
    got = pipeline.count_fastq(path, k, device=CPU, **kw)
    assert isinstance(got, dict) and got == want
    # a tiny first capacity forces the accumulator to double, several times
    assert pipeline.count_fastq(path, k, sparse_capacity=64, device=CPU, **kw) == want


def test_gz_offsets_match_jax(fastq_gz):
    want = [item[-1] for item in jio.iter_fastq_batches(
        fastq_gz, 8, validate=False, with_offsets=True)]
    got = [item[-1] for item in tio.iter_fastq_batches(
        fastq_gz, 8, validate=False, with_offsets=True, device=CPU)]
    assert got == want


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sparse_checkpoint_moves_between_packages(fastq_n, tmp_path, monkeypatch, writer):
    """A k = 21 checkpoint (lo/hi uint32, counts int32) written by one
    package's crashed job resumes in the other and gives the whole job's
    counts."""
    ckpt = str(tmp_path / f"{writer}.npz")
    kw = dict(batch_size=8, canonical=True, on_invalid="skip", checkpoint=ckpt,
              checkpoint_every=2, sparse_capacity=256)
    first, second = (jpipeline, pipeline) if writer == "jax" else (pipeline, jpipeline)
    io_mod = jio if writer == "jax" else tio
    monkeypatch.setattr(io_mod, "iter_fastq_batches",
                        _crashing(io_mod.iter_fastq_batches, 3))
    with pytest.raises(_Boom):
        first.count_fastq(fastq_n, 21, **kw, **_on_cpu(first))
    monkeypatch.undo()
    with np.load(ckpt) as z:
        assert int(z["n_batches"]) == 2 and str(z["engine"]) == "sparse"
        assert z["lo"].dtype == np.uint32 and z["hi"].dtype == np.uint32
        assert z["counts"].dtype == np.int32
    resumed = second.count_fastq(fastq_n, 21, **kw, **_on_cpu(second))
    whole = jpipeline.count_fastq(fastq_n, 21, batch_size=8, canonical=True, on_invalid="skip")
    assert resumed == whole
    with pytest.raises(ValueError, match="refusing to mix"):
        pipeline.count_fastq(fastq_n, 12, device=CPU, **{**kw, "checkpoint": ckpt})


@pytest.mark.parametrize("kind", ["fastq", "fastq_gz", "fastq_crlf", "fasta", "fasta_gz"])
@pytest.mark.parametrize("batch_size", [7, 4096])
def test_stats_matches_jax(tmp_path, rng, kind, batch_size):
    """Counts, lengths, gc_pct, mean_len, N50 and L50 equal JAX's on
    ragged reads and contigs (lengths 0 and 1 among them)."""
    lens = [int(n) for n in rng.integers(2, 300, 40)] + [1, 0, 299, 299]
    seqs = [random_seq(rng, n) for n in lens]
    if kind.startswith("fasta"):
        data = b"".join(b">c%d desc\n%s\n" % (i, b"\n".join(s[j : j + 60] for j in range(0, len(s), 60)))
                        for i, s in enumerate(seqs))
        name = "g.fa"
    else:
        nl = b"\r\n" if kind == "fastq_crlf" else b"\n"
        data = b"".join(b"@r%d%s%s%s+%s%s%s" % (i, nl, s, nl, nl, b"I" * len(s), nl)
                        for i, s in enumerate(seqs) if s)
        name = "r.fq"
    p = tmp_path / (name + (".gz" if kind.endswith("gz") else ""))
    if kind.endswith("gz"):
        with gzip.open(p, "wb") as f:
            f.write(data)
    else:
        p.write_bytes(data)
    got = pipeline.stats(p, batch_size, True, device=CPU)
    assert got == jpipeline.stats(p, batch_size, True)
    assert got["bases"] == sum(len(s) for s in seqs)


def test_stats_validate(fastq_n):
    with pytest.raises(InvalidBase):
        pipeline.stats(fastq_n, device=CPU)
    with pytest.raises(JInvalidBase):
        jpipeline.stats(fastq_n)
    got = pipeline.stats(fastq_n, validate=False, device=CPU)
    assert got == jpipeline.stats(fastq_n, validate=False)
    assert got["n50"] > 0 and got["l50"] > 0


# -- the mesh paths: batches split over CPU shards ---------------------------------


def _mesh(n):
    return pmesh.make_mesh((n,), ("data",), devices=[CPU] * n)


def _jmesh(n):
    return jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])


def _same_counts(got, want):
    if isinstance(want, dict):
        assert got == want
    else:
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("k,canonical,on_invalid", [(6, False, "skip"), (12, True, "skip"),
                                                    (17, False, "skip"), (21, True, "skip"),
                                                    (5, False, "raise")])
def test_count_fastq_mesh_matches_jax(fastq_n, fastq_clean, n, k, canonical, on_invalid):
    """Dense k (one psum a batch) and sparse k (a run list a shard, one
    merge at the end, capacity doubling at 64 rows) against JAX's n-device
    mesh and the port's single-device run."""
    p = fastq_n if on_invalid == "skip" else fastq_clean
    kw = dict(batch_size=8, canonical=canonical, on_invalid=on_invalid, sparse_capacity=64)
    want = jpipeline.count_fastq(p, k, mesh=_jmesh(n), **kw)
    got = pipeline.count_fastq(p, k, mesh=_mesh(n), **kw)
    _same_counts(got, want)
    _same_counts(pipeline.count_fastq(p, k, device=CPU, **kw), want)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("k", [6, 21])
def test_count_fasta_mesh_matches_jax(tmp_path, rng, n, k):
    """Segment groups of the mesh's size (the last padded with empty rows),
    small segments so that one contig spans many, N windows skipped."""
    contigs = []
    for size in (700, 260, 31, 120):
        s = bytearray(random_seq(rng, size).upper())
        s[rng.integers(len(s))] = ord("N")
        contigs.append(bytes(s))
    p = tmp_path / "g_mesh.fa"
    p.write_bytes(b"".join(b">c%d\n%s\n" % (i, c) for i, c in enumerate(contigs)))
    kw = dict(on_invalid="skip", seg_bases=64, sparse_capacity=2048)
    want = jpipeline.count_fasta(p, k, mesh=_jmesh(n), **kw)
    _same_counts(pipeline.count_fasta(p, k, mesh=_mesh(n), **kw), want)
    _same_counts(pipeline.count_fasta(p, k, device=CPU, **kw), want)


def test_count_fastq_mesh_dense_crash_resume(fastq_n, tmp_path, monkeypatch):
    """A dense checkpoint written on 8 shards resumes on 3 and on none."""
    ckpt = str(tmp_path / "dense_mesh.npz")
    kw = dict(batch_size=8, on_invalid="skip", checkpoint=ckpt, checkpoint_every=1)
    monkeypatch.setattr(tio, "iter_fastq_batches", _crashing(tio.iter_fastq_batches, 3))
    with pytest.raises(_Boom):
        pipeline.count_fastq(fastq_n, 6, mesh=_mesh(8), **kw)
    monkeypatch.undo()
    whole = jpipeline.count_fastq(fastq_n, 6, batch_size=8, on_invalid="skip")
    saved = tmp_path / "dense_mesh_saved.npz"
    saved.write_bytes(open(ckpt, "rb").read())
    np.testing.assert_array_equal(pipeline.count_fastq(fastq_n, 6, mesh=_mesh(3), **kw), whole)
    np.testing.assert_array_equal(
        pipeline.count_fastq(fastq_n, 6, device=CPU, **{**kw, "checkpoint": str(saved)}), whole)
