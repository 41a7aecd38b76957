"""bitnuc_tpu_torch.pipeline.count_fastq against bitnuc_tpu.pipeline on the
same small FASTQ files: equal histograms under on_invalid 'skip' and
'raise', crash/resume, and checkpoints that move between the packages in
both directions. Counts match exactly."""

import numpy as np
import pytest
import torch

from bitnuc_tpu import io as jio, pipeline as jpipeline
from bitnuc_tpu.errors import InvalidBase as JInvalidBase
from bitnuc_tpu_torch import io as tio, pipeline
from bitnuc_tpu_torch.errors import InvalidBase
from conftest import random_seq

torch.set_num_threads(1)


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
    got = pipeline.count_fastq(fastq_n, k, **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_count_fastq_raise_matches_jax(fastq_clean, fastq_n):
    want = jpipeline.count_fastq(fastq_clean, 4, batch_size=7, max_len=64)
    got = pipeline.count_fastq(fastq_clean, 4, batch_size=7, max_len=64)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(JInvalidBase) as je:
        jpipeline.count_fastq(fastq_n, 4, batch_size=8)
    with pytest.raises(InvalidBase) as te:
        pipeline.count_fastq(fastq_n, 4, batch_size=8)
    assert te.value.base == je.value.base


def test_batch_offsets_match_jax(fastq_n):
    want = [item[-1] for item in jio.iter_fastq_batches(
        fastq_n, 8, validate=False, with_offsets=True)]
    got = [item[-1] for item in tio.iter_fastq_batches(
        fastq_n, 8, validate=False, with_offsets=True)]
    assert got == want
    resumed = list(tio.iter_fastq_batches(fastq_n, 8, validate=False, start_offset=got[1]))
    first = list(tio.iter_fastq_batches(fastq_n, 8, validate=False))
    assert [r.to_ascii() for r in resumed] == [r.to_ascii() for r in first[2:]]


def test_crash_resume(fastq_n, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "t.npz")
    kw = dict(batch_size=8, on_invalid="skip", checkpoint=ckpt, checkpoint_every=1)
    monkeypatch.setattr(tio, "iter_fastq_batches", _crashing(tio.iter_fastq_batches, 3))
    with pytest.raises(_Boom):
        pipeline.count_fastq(fastq_n, 5, **kw)
    monkeypatch.undo()
    got = pipeline.count_fastq(fastq_n, 5, **kw)
    np.testing.assert_array_equal(got, pipeline.count_fastq(fastq_n, 5, batch_size=8, on_invalid="skip"))
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
        first.count_fastq(fastq_n, 6, **kw)
    monkeypatch.undo()
    with np.load(ckpt) as z:
        assert int(z["n_batches"]) == 2
    resumed = second.count_fastq(fastq_n, 6, **kw)
    whole = jpipeline.count_fastq(fastq_n, 6, batch_size=8, canonical=True, on_invalid="skip")
    np.testing.assert_array_equal(resumed, whole)


def test_progress_hook(fastq_n):
    events = []
    pipeline.count_fastq(fastq_n, 5, batch_size=8, on_invalid="skip",
                         on_progress=events.append, progress_every=2)
    assert [e["batches"] for e in events] == [2, 4, 6]  # 45 reads, 6 batches
    assert all(e["bases_per_sec"] > 0 for e in events)


def test_large_k_not_ported_yet(fastq_n):
    with pytest.raises(NotImplementedError):
        pipeline.count_fastq(fastq_n, 21, batch_size=8, on_invalid="skip")
    with pytest.raises(ValueError):
        pipeline.count_fastq(fastq_n, 5, on_invalid="ignore")
