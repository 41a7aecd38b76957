"""bitnuc_tpu_torch's sort-based k-mer counting against bitnuc_tpu.ops.kmer
on the same packed batches: count_kmers_sorted, count_kmers_runs,
raw_window_keys, merge_sorted_runs, pack_runs_front and compact_runs at
k = 13..32, plain and canonical, with N-skip and all-T reads (whose key is
the all-ones sentinel at k = 32). Raw arrays match bit for bit through
uint32 views. The sharded accumulator (pipeline._ShardedSparseAcc): its
capacity doubling against the one-device accumulator, its rebuild from
host runs, and sparse checkpoints that move across mesh sizes and between
the packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu import pipeline as jpipeline
from bitnuc_tpu.ops import codec as jcodec, kmer as jkmer
from bitnuc_tpu_torch import io as tio, pipeline
from bitnuc_tpu_torch.ops import kmer
from bitnuc_tpu_torch.parallel import kmer as pkmer, mesh as pmesh
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)

KS = [13, 15, 16, 17, 21, 31, 32]


def _batch(seed, variant, B=6, L=70):
    """(uint32 words, lengths, base_valid or None) made with numpy and
    packed by the JAX encoder; rows 1 and 2 hold all-T stretches."""
    rng = np.random.default_rng(seed)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    a[1] = ord("T")
    a[2, :40] = ord("T")
    if variant == "all_t":
        a[:] = ord("T")
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[1:3] = L
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    valid = None
    if variant != "plain":
        valid = rng.random((B, L)) >= 0.05
    return np.asarray(w), lens, valid


def _u32(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.reshape(-1).view(np.uint32) if a.dtype.itemsize == 4 else a.reshape(-1)


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_u32(g), _u32(w), err_msg=f"output {i}")


def _both(w, lens, valid):
    jargs = (jnp.asarray(w), jnp.asarray(lens))
    targs = (words_from_u32_np(w), torch.from_numpy(lens))
    tvalid = None if valid is None else torch.from_numpy(valid)
    return jargs, targs, valid, tvalid


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("variant", ["plain", "canonical_nskip", "all_t"])
def test_sort_engines_match_jax(k, variant):
    w, lens, valid = _batch(k, variant)
    canonical = variant == "canonical_nskip"
    jargs, targs, jv, tv = _both(w, lens, valid)
    for jfn, tfn in (
        (jkmer.count_kmers_sorted, kmer.count_kmers_sorted),
        (jkmer.count_kmers_runs, kmer.count_kmers_runs),
        (jkmer.raw_window_keys, kmer.raw_window_keys),
    ):
        want = jfn(*jargs, k, canonical, jv)
        got = tfn(*targs, k, canonical, tv)
        _assert_same(got, want)
    # the dispatcher: 'auto' is the runs engine above k = 12
    _assert_same(
        kmer.count_kmers_reads(*targs, k, canonical=canonical, base_valid=tv),
        jkmer.count_kmers_runs(*jargs, k, canonical, jv),
    )
    assert kmer.count_kmers_sorted(*targs, k, canonical, tv)[2].dtype == torch.int32


@pytest.mark.parametrize("k", KS)
def test_merge_pack_compact_runs_match_jax(k):
    """Two batches' run lists, concatenated, merged, pushed to the front
    and compacted, by both packages from the same arrays."""
    parts = []
    for seed, variant in ((1, "canonical_nskip"), (2, "all_t")):
        w, lens, valid = _batch(seed + k, variant)
        parts.append(jkmer.count_kmers_runs(jnp.asarray(w), jnp.asarray(lens), k, True, valid))
    cat = [np.concatenate([np.asarray(p[i]) for p in parts]) for i in range(3)]
    tcat = [torch.from_numpy(c.view(np.int32).copy()) for c in cat]
    want = jkmer.merge_sorted_runs(*(jnp.asarray(c) for c in cat))
    got = kmer.merge_sorted_runs(*tcat)
    _assert_same(got, want)
    front_w = jkmer.pack_runs_front(*want[:3])
    front_g = kmer.pack_runs_front(*got[:3])
    _assert_same(front_g, front_w)
    _assert_same(kmer.compact_runs(*got[:3]), jkmer.compact_runs(*want[:3]))
    lo, hi, ct = kmer.compact_runs(*front_g)
    assert lo.dtype == np.uint32 and hi.dtype == np.uint32
    assert ct.size == int(got[3]) and (ct > 0).all()


def test_sentinel_key_at_k32_keeps_its_count():
    """At k = 32 the all-T key equals the sentinel of invalid windows: its
    count is the valid all-T windows only."""
    a = np.full((3, 40), ord("T"), np.uint8)
    lens = np.array([40, 35, 3], np.int32)  # 9 + 4 + 0 windows
    valid = np.ones((3, 40), bool)
    valid[0, 5] = False  # drops windows 0..5 of read 0: 3 valid remain
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    targs = (words_from_u32_np(np.asarray(w)), torch.from_numpy(lens))
    for fn in (kmer.count_kmers_sorted, kmer.count_kmers_runs):
        lo, hi, ct, n = fn(*targs, 32, False, torch.from_numpy(valid))
        glo, ghi, gct = kmer.compact_runs(lo, hi, ct)
        assert int(n) == 1 and list(gct) == [7]
        assert int(glo[0]) == int(ghi[0]) == 0xFFFFFFFF


# -- the sharded accumulator -------------------------------------------------------


def _fastq(tmp_path, seed, n=30):
    rng = np.random.default_rng(seed)
    p = tmp_path / f"s{seed}.fq"
    with open(p, "wb") as f:
        for i, L in enumerate(rng.integers(30, 90, n)):
            s = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), int(L)).tobytes())
            if i % 3 == 0:
                s[rng.integers(len(s))] = ord("N")
            if i == 4:
                s[:] = b"T" * len(s)  # the all-T key: the sentinel at k = 32
            f.write(b"@s%d\n%s\n+\n%s\n" % (i, bytes(s), b"I" * len(s)))
    return p


def _cpu_mesh(n):
    return pmesh.make_mesh((n,), ("data",), devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("k", [17, 32])
@pytest.mark.parametrize("n", [2, 8])
def test_sharded_acc_growth_equals_one_device(k, n):
    """Raw keys of five batches into _ShardedSparseAcc at 24 rows a shard
    (every flush doubles the capacity at least once) and into _SparseAcc:
    one dict; the per-shard capacity, not the global one, doubles."""
    mesh = _cpu_mesh(n)
    small = pipeline._ShardedSparseAcc(24, mesh)
    one = pipeline._SparseAcc(1 << 12, torch.device("cpu"))
    for seed in range(5):
        w, lens, valid = _batch(seed, "canonical_nskip", B=2 * n)
        _, targs, _, tvalid = _both(w, lens, valid)
        raw = kmer.raw_window_keys(*targs, k, True, tvalid)
        one.add(*raw)
        sh = pmesh.shard_reads(PackedReads(*targs), mesh)
        bvs = pmesh.Sharded(pmesh.split(tvalid, mesh, "data"), mesh, "data")
        small.add(*pkmer.raw_window_keys_sharded(sh.words, sh.lengths, k, mesh, "data", True,
                                                 bvs))
    got = small.to_dict()
    assert got == one.to_dict() and len(got) > 24
    assert small.cap > 24 and all(s.shape == (small.cap,) for s in small.state[0].shards)


def test_from_host_runs_pads_with_dead_rows():
    lo = np.array([1, 2, 3, 0xFFFFFFFF, 5], np.uint32)
    hi = np.array([0, 0, 7, 0xFFFFFFFF, 9], np.uint32)
    ct = np.array([4, 1, 2, 0, 3], np.int32)
    acc = pipeline._ShardedSparseAcc.from_host_runs(lo, hi, ct, _cpu_mesh(3))
    assert acc.cap == 2 and acc.n_dev == 3
    hlo, hhi, hct = acc.host_state()
    np.testing.assert_array_equal(hlo, np.append(lo, 0xFFFFFFFF))
    np.testing.assert_array_equal(hhi, np.append(hi, 0xFFFFFFFF))
    np.testing.assert_array_equal(hct, np.append(ct, 0))
    assert acc.to_dict() == {1: 4, 2: 1, (7 << 32) | 3: 2, (9 << 32) | 5: 3}


class _Boom(RuntimeError):
    pass


def _crash_after(monkeypatch, n_batches):
    real = tio.iter_fastq_batches

    def wrapper(*args, **kwargs):
        for i, item in enumerate(real(*args, **kwargs)):
            if i == n_batches:
                raise _Boom()
            yield item

    monkeypatch.setattr(tio, "iter_fastq_batches", wrapper)


@pytest.mark.parametrize("k", [21, 32])
@pytest.mark.parametrize("write_n,read_n", [(8, 3), (3, None), (None, 8), (2, 2)])
def test_sparse_crash_resume_across_mesh_sizes(tmp_path, monkeypatch, k, write_n, read_n):
    """A sparse checkpoint written at one mesh size (or none) resumes at
    another and gives the whole job's dict, JAX's."""
    p = _fastq(tmp_path, k)
    ckpt = str(tmp_path / "sp.npz")
    kw = dict(batch_size=6, on_invalid="skip", checkpoint=ckpt, checkpoint_every=1,
              sparse_capacity=32)

    def mesh_kw(n):
        return {"device": torch.device("cpu")} if n is None else {"mesh": _cpu_mesh(n)}

    _crash_after(monkeypatch, 3)
    with pytest.raises(_Boom):
        pipeline.count_fastq(p, k, **kw, **mesh_kw(write_n))
    monkeypatch.undo()
    with np.load(ckpt) as z:
        assert int(z["n_batches"]) == 3 and z["lo"].dtype == np.uint32
        assert z["counts"].dtype == np.int32
        if write_n:
            assert z["lo"].shape[0] % write_n == 0
    got = pipeline.count_fastq(p, k, **kw, **mesh_kw(read_n))
    assert got == jpipeline.count_fastq(p, k, batch_size=6, on_invalid="skip")


def test_sharded_checkpoint_moves_between_packages(tmp_path, monkeypatch):
    """JAX's 8-device checkpoint resumes on 3 CPU shards of the port, and
    the port's 8-shard checkpoint in JAX's 8-device job."""
    import jax

    from bitnuc_tpu import io as jio

    p = _fastq(tmp_path, 5)
    jmesh = jax.make_mesh((8,), ("data",), devices=jax.devices()[:8])
    whole = jpipeline.count_fastq(p, 21, batch_size=6, on_invalid="skip")
    for writer in ("jax", "torch"):
        ckpt = str(tmp_path / f"{writer}.npz")
        kw = dict(batch_size=6, on_invalid="skip", checkpoint=ckpt, checkpoint_every=1,
                  sparse_capacity=32)
        real = (jio if writer == "jax" else tio).iter_fastq_batches

        def wrapper(*args, **kwargs):
            for i, item in enumerate(real(*args, **kwargs)):
                if i == 2:
                    raise _Boom()
                yield item

        monkeypatch.setattr(jio if writer == "jax" else tio, "iter_fastq_batches", wrapper)
        with pytest.raises(_Boom):
            if writer == "jax":
                jpipeline.count_fastq(p, 21, mesh=jmesh, **kw)
            else:
                pipeline.count_fastq(p, 21, mesh=_cpu_mesh(8), **kw)
        monkeypatch.undo()
        if writer == "jax":
            assert pipeline.count_fastq(p, 21, mesh=_cpu_mesh(3), **kw) == whole
        else:
            assert jpipeline.count_fastq(p, 21, mesh=jmesh, **kw) == whole
