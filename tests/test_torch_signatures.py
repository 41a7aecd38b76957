"""bitnuc_tpu_torch's entry points take bitnuc_tpu's parameters in its
order: count_fastq, count_fasta, iter_fastq_batches, PackedDB.search,
PackedDB.search_batch and topk_batch_dispatch, called with JAX's keywords
and positions, give JAX's outputs. A mesh raises NotImplementedError,
staged=True raises RuntimeError, and prefetch runs a producer thread whose
batches, offsets and errors equal the unthreaded run's and which ends when
its consumer stops."""

import gzip
import inspect
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu import database as jdatabase, io as jio, mapper as jmapper, pipeline as jpipeline
from bitnuc_tpu.ops import analysis as janalysis, chain as jchain, hamming as jham
from bitnuc_tpu.ops import kmer as jkmer, merge_pairs as jmerge_pairs, pileup as jpileup
from bitnuc_tpu import filters as jfilters, qc as jqc
from bitnuc_tpu.ops import correct as jcorrect, dedupe as jdedupe, demux as jdemux
from bitnuc_tpu.ops import lookup as jlookup
from bitnuc_tpu_torch import database, filters, io as tio, mapper, pipeline, qc
from bitnuc_tpu_torch.ops import correct, dedupe, demux, lookup
from bitnuc_tpu_torch.errors import InvalidBase
from bitnuc_tpu_torch.ops import analysis, chain, hamming, kmer, merge_pairs, pileup
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")
PAIRS = {
    "count_fastq": (pipeline.count_fastq, jpipeline.count_fastq),
    "count_fasta": (pipeline.count_fasta, jpipeline.count_fasta),
    "iter_fastq_batches": (tio.iter_fastq_batches, jio.iter_fastq_batches),
    "search": (database.PackedDB.search, jdatabase.PackedDB.search),
    "search_batch": (database.PackedDB.search_batch, jdatabase.PackedDB.search_batch),
    "topk_batch_dispatch": (hamming.topk_batch_dispatch, jham.topk_batch_dispatch),
    "read_fastq": (tio.read_fastq, jio.read_fastq),
    "read_fastq_fast": (tio.read_fastq_fast, jio.read_fastq_fast),
    "iter_fastq_ascii_batches": (tio.iter_fastq_ascii_batches, jio.iter_fastq_ascii_batches),
    "iter_fastq_record_batches": (tio.iter_fastq_record_batches, jio.iter_fastq_record_batches),
    "stats": (pipeline.stats, jpipeline.stats),
    "merge_pairs": (merge_pairs.merge_pairs, jmerge_pairs.merge_pairs),
    "windowed_gc": (analysis.windowed_gc, janalysis.windowed_gc),
    "hdist_topk_batch": (hamming.hdist_topk_batch, jham.hdist_topk_batch),
    "chain_anchors": (chain.chain_anchors, jchain.chain_anchors),
    "map_reads_long": (mapper.map_reads_long, jmapper.map_reads_long),
    "map_pairs": (mapper.map_pairs, jmapper.map_pairs),
}
PAIRS.update({name: (getattr(pileup, name), getattr(jpileup, name)) for name in (
    "pileup_counts", "consensus_calls", "pileup_counts_ops", "_insertion_consensus",
    "call_variants")})
PAIRS.update({name: (getattr(kmer, name), getattr(jkmer, name)) for name in (
    "minimizers", "minimizer_sketch", "sketch_jaccard", "sketch_containment", "_sliding_min2",
    "minimizers64", "minimizer_sketch64", "sketch_jaccard64", "sketch_containment64")})
# the read-processing tier
for _mod, _jmod, _names in (
    (lookup, jlookup, ("lookup_counts", "kmer_hits_reads", "screen_reads", "solid_prefix_len",
                       "table_from_dense", "table_from_dict")),
    (dedupe, jdedupe, ("mark_duplicates", "dedupe_reads")),
    (correct, jcorrect, ("_candidate_keys", "correct_reads_once", "correct_reads")),
    (demux, jdemux, ("assign_barcodes",)),
    (filters, jfilters, ("trim_bounds", "adapter_positions", "complexity_fraction",
                         "triplet_entropy", "_filter_core", "filter_reads", "_batch_filter",
                         "_iter_record_batches", "filter_fastq", "filter_fastq_paired")),
    (qc, jqc, ("_percentile_from_hist", "_per_cycle_rows", "_status", "qc_profile")),
):
    PAIRS.update({name: (getattr(_mod, name), getattr(_jmod, name)) for name in _names})
# functions of tensors follow their inputs' device, the host-only parsers put
# nothing on one, and the mappers and the caller follow the index's: no
# `device` parameter
NO_DEVICE = ("search", "search_batch", "topk_batch_dispatch", "iter_fastq_ascii_batches",
             "iter_fastq_record_batches", "merge_pairs", "windowed_gc", "hdist_topk_batch",
             "chain_anchors", "map_reads_long", "map_pairs", "pileup_counts",
             "consensus_calls", "pileup_counts_ops", "_insertion_consensus", "call_variants",
             "minimizers", "minimizer_sketch", "sketch_jaccard", "sketch_containment",
             "_sliding_min2", "minimizers64", "minimizer_sketch64", "sketch_jaccard64",
             "sketch_containment64", "lookup_counts", "kmer_hits_reads", "screen_reads",
             "solid_prefix_len", "mark_duplicates", "dedupe_reads", "_candidate_keys",
             "correct_reads_once", "correct_reads", "assign_barcodes", "trim_bounds",
             "adapter_positions", "complexity_fraction", "triplet_entropy", "_filter_core",
             "_iter_record_batches", "_percentile_from_hist", "_per_cycle_rows", "_status")


@pytest.fixture
def fastq(tmp_path, rng):
    p = tmp_path / "r.fq"
    with open(p, "wb") as f:
        for i, n in enumerate(rng.integers(20, 90, 61)):
            s = bytearray(random_seq(rng, int(n)).upper())
            if i % 5 == 0:
                s[rng.integers(len(s))] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, bytes(s), b"I" * len(s)))
    return p


@pytest.mark.parametrize("name", list(PAIRS))
def test_parameters_follow_jax(name):
    """The port's parameters, up to its trailing ``device``, are JAX's in
    JAX's order with JAX's defaults."""
    port, ref = (inspect.signature(f).parameters for f in PAIRS[name])
    names = [n for n in port if n != "device"]
    assert names == list(ref)
    for n in names:
        want = ref[n].default
        if n != "n_bases":  # JAX requires it; the port does not read it
            assert port[n].default == want, n
    assert (list(port)[-1] == "device") != (name in NO_DEVICE)


def test_count_fastq_positional_order(fastq):
    """JAX's positions, prefetch (the eleventh) included."""
    args = (fastq, 5, 8, None, True, False, None, "data", None, 50, 2, 1 << 20, "skip")
    got = pipeline.count_fastq(*args, device=CPU)
    np.testing.assert_array_equal(got, jpipeline.count_fastq(*args))
    assert got.sum() > 0


@pytest.mark.parametrize("k", [8, 21])
def test_count_fasta_jax_keywords(tmp_path, k):
    p = tmp_path / "g.fa"
    rng = np.random.default_rng(k)
    p.write_bytes(b">a\n" + random_seq(rng, 300) + b"\n>b\n" + random_seq(rng, 90) + b"\n")
    want = jpipeline.count_fasta(p, k, mesh=None)
    got = pipeline.count_fasta(p, k, mesh=None, axis="data", device=CPU)
    if k <= 12:
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want
    got = pipeline.count_fasta(p, k, True, "skip", 64, 1 << 10, None, "data", device=CPU)
    want = jpipeline.count_fasta(p, k, True, "skip", 64, 1 << 10, None, "data")
    assert (np.array_equal(got, want) if k <= 12 else got == want)


def _db(seed, D=300, W=6, nb=90):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 2**32, (W, D), dtype=np.uint64).astype(np.uint32)
    qs = rng.integers(0, 2**32, (20, W), dtype=np.uint64).astype(np.uint32)
    return (database.PackedDB.from_numpy(db, nb, device=CPU),
            jdatabase.PackedDB(words_wm=jnp.asarray(db), n_bases=nb), qs)


def test_search_and_search_batch_jax_keywords():
    tdb, jdb, qs = _db(1)
    for got, want in ((tdb.search_batch(words_from_u32_np(qs), 10, mesh=None),
                       jdb.search_batch(jnp.asarray(qs), 10, mesh=None)),
                      (tdb.search_batch(words_from_u32_np(qs), 10, None, "data"),
                       jdb.search_batch(jnp.asarray(qs), 10, None, "data")),
                      (tdb.search(words_from_u32_np(qs[0]), 7, None, "data"),
                       jdb.search(jnp.asarray(qs[0]), 7, None, "data"))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_batch_dispatch_takes_n_bases():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 200, (5, 700)).astype(np.int32)
    want = jham.topk_batch_dispatch(jnp.asarray(d), 9, 200)
    for got in (hamming.topk_batch_dispatch(torch.from_numpy(d), 9, 200),
                hamming.topk_batch_dispatch(torch.from_numpy(d), 9)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("call", ["count_fastq", "count_fasta", "search", "search_batch"])
def test_a_mesh_raises(call, fastq):
    tdb, _, qs = _db(2)
    calls = {
        "count_fastq": lambda: pipeline.count_fastq(fastq, 5, mesh=object(), device=CPU),
        "count_fasta": lambda: pipeline.count_fasta(b">a\nACGTACGT\n", 4, mesh=object(),
                                                    device=CPU),
        "search": lambda: tdb.search(words_from_u32_np(qs[0]), 3, mesh=object()),
        "search_batch": lambda: tdb.search_batch(words_from_u32_np(qs), 3, mesh=object()),
    }
    with pytest.raises(NotImplementedError, match="distributed tier"):
        calls[call]()


def test_staged_true_raises(fastq):
    with pytest.raises(RuntimeError, match="staged=True"):
        next(tio.iter_fastq_batches(fastq, 8, staged=True, device=CPU))
    assert len(list(tio.iter_fastq_batches(fastq, 8, validate=False, staged=False,
                                           device=CPU))) == 8


def _batches(path, prefetch, **kw):
    return [(r.to_ascii(), v.numpy(), off) for r, v, off in tio.iter_fastq_batches(
        path, 8, validate=False, prefetch=prefetch, with_validity=True, with_offsets=True,
        device=CPU, **kw)]


@pytest.mark.parametrize("prefetch", [1, 2, 5])
@pytest.mark.parametrize("gz", [False, True])
def test_prefetch_yields_what_prefetch_0_yields(fastq, prefetch, gz):
    path = fastq
    if gz:
        path = fastq.with_suffix(".fq.gz")
        path.write_bytes(gzip.compress(fastq.read_bytes(), compresslevel=1))
    want = _batches(path, 0)
    got = _batches(path, prefetch)
    assert len(got) == len(want) == 8
    for (ga, gv, go), (wa, wv, wo) in zip(got, want):
        assert ga == wa and go == wo
        np.testing.assert_array_equal(gv, wv)
    # JAX's positional order: path, batch_size, max_len, validate, staged, prefetch
    offsets = [item[-1] for item in tio.iter_fastq_batches(
        path, 8, None, False, None, prefetch, False, True, 0, CPU)]
    assert offsets == [item[-1] for item in jio.iter_fastq_batches(
        path, 8, None, False, None, prefetch, False, True, 0)]


def _live_workers():
    return [t for t in threading.enumerate() if t.name == "fastq-prefetch" and t.is_alive()]


def test_prefetch_errors_reach_the_consumer(tmp_path, fastq):
    """A malformed record raised on the producer thread, and an invalid base
    found on the consumer's, both raise at the consumer, which then leaves
    no worker behind."""
    bad = tmp_path / "bad.fq"
    bad.write_bytes(fastq.read_bytes() + b"not a header\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="malformed FASTQ header"):
        for _ in tio.iter_fastq_batches(bad, 8, validate=False, prefetch=2, device=CPU):
            pass
    with pytest.raises(InvalidBase):
        list(tio.iter_fastq_batches(fastq, 8, validate=True, prefetch=2, device=CPU))
    assert not _live_workers()


def test_prefetched_source_errors_and_early_stop():
    """_prefetched keeps order, re-raises the source's error at the next
    pull, and on an early stop ends its worker and closes the source."""
    closed = []

    def source(fail_at=None):
        try:
            for i in range(50):
                if i == fail_at:
                    raise KeyError("boom")
                yield i
        finally:
            closed.append(True)

    assert list(tio._prefetched(source(), 3)) == list(range(50))
    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in tio._prefetched(source(fail_at=7), 2):
            got.append(x)
    assert got == list(range(7))
    it = tio._prefetched(source(), 2)
    assert next(it) == 0
    it.close()
    assert closed == [True, True, True] and not _live_workers()


def test_early_break_leaves_no_worker(fastq):
    for batch in tio.iter_fastq_batches(fastq, 8, validate=False, prefetch=2, device=CPU):
        break
    del batch
    assert not _live_workers()


class _Crash(Exception):
    pass


@pytest.mark.parametrize("k", [6, 21])
def test_crash_resume_with_prefetch(fastq, tmp_path, k):
    """A count_fastq crashed from on_progress at the default prefetch=2
    resumes from its checkpoint to the uninterrupted run's counts: the
    stored offset is that of the consumed batches, not of those framed
    ahead."""
    ckpt = str(tmp_path / "c.npz")
    kw = dict(batch_size=8, canonical=True, on_invalid="skip", device=CPU)

    def crash(ev):
        if ev["batches"] == 5:
            raise _Crash()

    with pytest.raises(_Crash):
        pipeline.count_fastq(fastq, k, checkpoint=ckpt, checkpoint_every=2, on_progress=crash,
                             progress_every=1, **kw)
    assert not _live_workers()
    with np.load(ckpt) as z:
        assert int(z["n_batches"]) == 4
    resumed = pipeline.count_fastq(fastq, k, checkpoint=ckpt, checkpoint_every=2, **kw)
    whole = pipeline.count_fastq(fastq, k, prefetch=0, **kw)
    want = jpipeline.count_fastq(fastq, k, batch_size=8, canonical=True, on_invalid="skip")
    if k <= 12:
        np.testing.assert_array_equal(resumed, whole)
        np.testing.assert_array_equal(whole, want)
    else:
        assert resumed == whole == want
