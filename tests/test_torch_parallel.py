"""bitnuc_tpu_torch.parallel against bitnuc_tpu.parallel on the JAX tests'
8-device CPU mesh: the mesh and its sharded reads, the collectives along
each axis of a 2-D mesh, every function of parallel/kmer.py and
parallel/search.py on meshes of 1, 2, 3 and 8 CPU shards (a repeated
torch device) against the JAX function on a mesh of as many JAX CPU
devices, and against the port's unsharded function. Batches and
databases that do not divide the mesh are padded as the JAX package pads
them; the sequence-sharded counts run at k = 1, 16, 17 and 31 with the
sequence's end just below, at and just past a shard edge. Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bitnuc_tpu import parallel as jpar
from bitnuc_tpu.ops import codec as jcodec
from bitnuc_tpu.parallel import kmer as jpkmer, search as jpsearch
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch import parallel
from bitnuc_tpu_torch.ops import hamming, kmer
from bitnuc_tpu_torch.parallel import kmer as pkmer, mesh as pmesh, search as psearch
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _meshes(n, axis="data"):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    return (pmesh.make_mesh((n,), (axis,), devices=[CPU] * n),
            jax.make_mesh((n,), (axis,), devices=jax.devices()[:n]))


def _batch(seed, B, L, invalid=0.0):
    """Host (uint32 words [B, W], int32 lengths [B], bool base_valid [B, L])."""
    rng = np.random.default_rng(seed)
    a = rng.choice(ACGT, size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    return np.array(w), lens, rng.random((B, L)) >= invalid


def _jshard(x, jm, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(jm, spec))


def _same(got, want):
    """Tensors (int32 views) or Shardeds against JAX arrays, exactly."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.full() if isinstance(g, pmesh.Sharded) else g
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- the mesh and sharded reads ------------------------------------------------


def test_make_mesh_shape_and_devices():
    m = pmesh.make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.shape["model"] == 4
    assert m.axis_names == ("data", "model") and m.size == 8
    assert m.devices.shape == (2, 4) and all(d == CPU for d in m.flat_devices)
    assert m.groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.axis_index("data") == [0, 0, 0, 0, 1, 1, 1, 1]
    one = pmesh.make_mesh(devices=[CPU] * 3)
    assert one.shape == {"data": 3}
    with pytest.raises(ValueError, match="needs 8 devices"):
        pmesh.make_mesh((8,), devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()


def test_shard_reads_pads_and_shards():
    m, jm = _meshes(8)
    reads = PackedReads.from_ascii([b"ACGT"] * 5, device=CPU)  # 5 -> padded to 8
    sharded = parallel.shard_reads(reads, m)
    assert sharded.batch_size == 8 and len(sharded) == 8
    assert int(np.asarray(sharded.lengths)[5]) == 0  # padding is an empty read
    assert len(sharded.word_shards) == 8 and all(s.shape == (1, 2) for s in sharded.word_shards)
    jsh = jpar.shard_reads(JPackedReads.from_ascii([b"ACGT"] * 5), jm)
    np.testing.assert_array_equal(np.asarray(sharded.words).view(np.uint32),
                                  np.asarray(jsh.words))
    np.testing.assert_array_equal(np.asarray(sharded.lengths), np.asarray(jsh.lengths))
    assert parallel.pad_batch(reads, 5) is reads
    assert parallel.pad_batch(reads, 3).batch_size == 6


def test_replicate_and_split():
    m = pmesh.make_mesh((4,), devices=[CPU] * 4)
    x = torch.arange(12).reshape(4, 3)
    copies = parallel.replicate(x, m)
    assert len(copies) == 4 and all(c is copies[0] and torch.equal(c, x) for c in copies)
    parts = pmesh.split(x, m, "data")
    assert [p.tolist() for p in parts] == [[r] for r in x.tolist()]
    assert torch.equal(pmesh.Sharded(parts, m, "data").full(), x)
    with pytest.raises(ValueError, match="must divide"):
        pmesh.split(torch.arange(6), m, "data")


@pytest.mark.parametrize("axis", ["data", "model"])
def test_collectives_along_each_axis(axis):
    m = pmesh.make_mesh((2, 3), ("data", "model"), devices=[CPU] * 6)
    shards = [torch.tensor([i, 10 * i], dtype=torch.int32) for i in range(6)]
    grid = np.arange(6).reshape(2, 3)
    ax = m.axis_names.index(axis)
    sums = np.moveaxis(grid, ax, -1)
    got = pmesh.psum(shards, m, axis)
    for g, group in zip(sums.reshape(-1, m.shape[axis]), m.groups(axis)):
        for i in group:
            assert got[i].dtype == torch.int32
            assert got[i].tolist() == [int(g.sum()), 10 * int(g.sum())]
    mx = pmesh.pmax(shards, m, axis)
    gat = pmesh.all_gather(shards, m, axis)
    for g, group in zip(sums.reshape(-1, m.shape[axis]), m.groups(axis)):
        for i in group:
            assert mx[i].tolist() == [int(g.max()), 10 * int(g.max())]
            assert gat[i].tolist() == [v for j in g for v in (int(j), 10 * int(j))]
    n = m.shape[axis]
    perm = [(i, (i - 1) % n) for i in range(n)]  # the halo's ring
    moved = pmesh.ppermute(shards, m, axis, perm)
    for group in m.groups(axis):
        for pos, i in enumerate(group):
            assert torch.equal(moved[i], shards[group[(pos + 1) % n]])
    part = pmesh.ppermute(shards, m, axis, [(0, 1)])
    for group in m.groups(axis):
        assert torch.equal(part[group[1]], shards[group[0]])
        assert not part[group[0]].any()


# -- k-mer counting ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("k,variant", [(1, "plain"), (6, "canonical"), (6, "base_valid"),
                                       (12, "plain")])
def test_count_kmers_sharded_matches_jax(n, k, variant):
    m, jm = _meshes(n)
    B = 2 * n + 1  # not a multiple of the mesh
    w, lens, bv = _batch(n * 100 + k, B, 70, invalid=0.05)
    canonical = variant == "canonical"
    bv = bv if variant == "base_valid" else None
    jreads = jpar.shard_reads(JPackedReads(words=jnp.asarray(w), lengths=jnp.asarray(lens)), jm)
    jbv = None
    if bv is not None:
        Bp = int(jreads.words.shape[0])
        jbv = _jshard(np.pad(bv, ((0, Bp - B), (0, 0))), jm, P("data", None))
    want = jpkmer.count_kmers_sharded(jreads.words, jreads.lengths, k, jm,
                                      canonical=canonical, base_valid=jbv)
    reads = PackedReads(words=words_from_u32_np(w), lengths=torch.from_numpy(lens))
    sh = parallel.shard_reads(reads, m)
    tbv = None if bv is None else pmesh.pad_rows(torch.from_numpy(bv), sh.batch_size)
    got = parallel.count_kmers_sharded(sh.words, sh.lengths, k, m, canonical=canonical,
                                       base_valid=tbv)
    _same([got], [want])
    local = kmer.count_kmers_dense(reads.words, reads.lengths, k, canonical,
                                   None if bv is None else torch.from_numpy(bv))
    assert torch.equal(got, local)


def test_count_kmers_sharded_modes():
    m, _ = _meshes(2)
    w, lens, _ = _batch(5, 6, 90)
    t = words_from_u32_np(w), torch.from_numpy(lens)
    want = kmer.count_kmers_dense(*t, 5)
    for mode in ("auto", "mxu", "pallas", "dense"):
        assert torch.equal(parallel.count_kmers_sharded(*t, 5, m, mode=mode), want)
    with pytest.raises(ValueError, match="mode"):
        parallel.count_kmers_sharded(*t, 5, m, mode="runs")


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("k,variant", [(13, "plain"), (21, "canonical"), (21, "base_valid"),
                                       (32, "plain")])
def test_count_kmers_sorted_sharded_matches_jax(n, k, variant):
    m, jm = _meshes(n)
    w, lens, bv = _batch(n * 7 + k, 2 * n, 60, invalid=0.05)
    if k == 32:  # poly-T reads: the all-ones key equals the sentinel
        w[0, :] = 0xFFFFFFFF
        lens[0] = 60
    canonical = variant == "canonical"
    bv = bv if variant == "base_valid" else None
    jw = _jshard(w, jm, P("data", None))
    jl = _jshard(lens, jm, P("data"))
    jbv = None if bv is None else _jshard(bv, jm, P("data", None))
    want = jpkmer.count_kmers_sorted_sharded(jw, jl, k, jm, canonical=canonical,
                                             base_valid=jbv)
    tw, tl = words_from_u32_np(w), torch.from_numpy(lens)
    tbv = None if bv is None else torch.from_numpy(bv)
    got = parallel.count_kmers_sorted_sharded(tw, tl, k, m, canonical=canonical,
                                              base_valid=tbv)
    _same(got, want)
    lo, hi, ct = kmer.compact_runs(*got[:3])
    l1, h1, c1 = kmer.compact_runs(*kmer.count_kmers_runs(tw, tl, k, canonical, tbv)[:3])
    for a, b in ((lo, l1), (hi, h1), (ct, c1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 3])
def test_sparse_state_merge_grow_gather_match_jax(n):
    """The streaming accumulator's steps: an empty state, two merges of raw
    window keys (the second past capacity), a growth and the final gather,
    array for array against JAX's."""
    m, jm = _meshes(n)
    k, cap = 21, 40
    w, lens, bv = _batch(11 * n, 4 * n, 50, invalid=0.03)
    jw, jl = _jshard(w, jm, P("data", None)), _jshard(lens, jm, P("data"))
    jbv = _jshard(bv, jm, P("data", None))
    tw, tl, tbv = words_from_u32_np(w), torch.from_numpy(lens), torch.from_numpy(bv)

    jraw = jpkmer.raw_window_keys_sharded(jw, jl, k, jm, "data", True, jbv)
    raw = pkmer.raw_window_keys_sharded(tw, tl, k, m, "data", True, tbv)
    assert all(isinstance(r, pmesh.Sharded) for r in raw)
    _same(raw, jraw)
    jstate = jpkmer.sparse_state_sharded(cap, jm)
    state = pkmer.sparse_state_sharded(cap, m)
    _same(state, jstate)
    *jst, jmax = jpkmer.merge_runs_sharded((jstate, jraw), cap, jm)
    *st, nmax = pkmer.merge_runs_sharded((state, raw), cap, m)
    _same(st, jst)
    assert int(nmax) == int(jmax) and nmax.shape == ()
    jg = jpkmer.grow_state_sharded(tuple(jst), 2 * cap, jm)
    g = pkmer.grow_state_sharded(tuple(st), 2 * cap, m)
    _same(g, jg)
    assert all(s.shape == (2 * cap,) for s in g[0].shards)
    *jst2, jmax2 = jpkmer.merge_runs_sharded((jg, jraw, jraw), 2 * cap, jm)
    *st2, nmax2 = pkmer.merge_runs_sharded((g, raw, raw), 2 * cap, m)
    _same(st2, jst2)
    assert int(nmax2) == int(jmax2)
    _same(pkmer.gather_runs_sharded(*st2, m), jpkmer.gather_runs_sharded(*jst2, jm))


def _long_seq(total, n, seed):
    """(host uint32 words [Wtot] with Wtot a multiple of n, its bases)."""
    rng = np.random.default_rng(seed)
    s = rng.choice(ACGT, size=total).tobytes()
    w = np.asarray(JPackedReads.from_ascii([s]).words)[0]
    W = -(-w.shape[0] // n) * n
    return np.pad(w, (0, W - w.shape[0])), s


# total lengths just below, at and just past a shard edge of 4 words (64 bases)
@pytest.mark.parametrize("total", [16 * 4 * 3 - 1, 16 * 4 * 3, 16 * 4 * 3 + 1])
@pytest.mark.parametrize("k", [1, 16, 17, 31])
def test_count_kmers_seqsharded_sorted_matches_jax(total, k):
    n = 4
    m, jm = _meshes(n, "seq")
    words, s = _long_seq(total, n, total + k)
    if words.shape[0] < 4 * n:  # every shard 4 words, the edge at 64 bases a shard
        words = np.pad(words, (0, 4 * n - words.shape[0]))
    jw = _jshard(words, jm, P("seq"))
    want = jpar.count_kmers_seqsharded_sorted(jw, jnp.int32(total), k, jm)
    got = parallel.count_kmers_seqsharded_sorted(words_from_u32_np(words), total, k, m)
    _same(got, want)
    reads = PackedReads.from_ascii([s], device=CPU)
    lo, hi, ct = kmer.compact_runs(*kmer.count_kmers_runs(reads.words, reads.lengths, k)[:3])
    glo, ghi, gct = kmer.compact_runs(*got[:3])
    np.testing.assert_array_equal(glo, lo)
    np.testing.assert_array_equal(ghi, hi)
    np.testing.assert_array_equal(gct, ct)
    assert int(gct.sum()) == total - k + 1


@pytest.mark.parametrize("total", [16 * 4 * 3 - 1, 16 * 4 * 3, 16 * 4 * 3 + 1, 16 * 128 - 5])
@pytest.mark.parametrize("k", [1, 11, 12])
def test_count_kmers_seqsharded_matches_jax(total, k):
    n = 4 if total < 1000 else 8
    m, jm = _meshes(n, "seq")
    words, s = _long_seq(total, n, total * 3 + k)
    words = np.pad(words, (0, max(0, 4 * n - words.shape[0])))
    want = jpar.count_kmers_seqsharded(_jshard(words, jm, P("seq")), jnp.int32(total), k, jm)
    got = parallel.count_kmers_seqsharded(words_from_u32_np(words), total, k, m)
    _same([got], [want])
    reads = PackedReads.from_ascii([s], device=CPU)
    assert torch.equal(got, kmer.count_kmers_dense(reads.words, reads.lengths, k))


def test_seqsharded_on_a_data_axis_and_one_shard():
    """The example's use: a 'data' mesh names its axis; one shard has no
    neighbour but itself."""
    words, s = _long_seq(1000, 1, 3)
    m1 = pmesh.make_mesh((1,), ("data",), devices=[CPU])
    h = parallel.count_kmers_seqsharded(words_from_u32_np(words), 1000, 6, m1, "data")
    assert int(h.sum()) == 1000 - 6 + 1


# -- search -----------------------------------------------------------------------


def _db(seed, D, W, L, Q, ties=False):
    """(host uint32 database [D, W], queries [Q, W]); ties=True draws from
    few distinct entries so that distances tie across shards."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 2**32, (D, W), dtype=np.uint32)
    if ties:
        db = db[rng.integers(0, 3, D)]
    qs = rng.integers(0, 2**32, (Q, W), dtype=np.uint32)
    qs[0] = db[D // 2]  # an exact hit off the first shard
    return db, qs


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("ties", [False, True])
def test_hdist_search_sharded_matches_jax(n, ties):
    m, jm = _meshes(n)
    db, qs = _db(n + 10 * ties, 8 * n, 4, 60, 1, ties)
    want = jpsearch.hdist_search_sharded(jnp.asarray(qs[0]), _jshard(db, jm, P("data", None)),
                                         60, 7, jm)
    got = parallel.hdist_search_sharded(words_from_u32_np(qs[0]), words_from_u32_np(db), 60, 7,
                                        m)
    _same(got, want)
    loc = hamming.hdist_topk(words_from_u32_np(qs[0]), words_from_u32_np(db), 60, 7)
    assert torch.equal(got[0], loc[0])
    if n == 1 or not ties:
        assert torch.equal(got[1], loc[1])


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("Q,topk", [(5, 4), (9, 10), (40, 33)])
def test_hdist_search_batch_sharded_matches_jax(n, Q, topk):
    m, jm = _meshes(n)
    D = 8 * n if topk < 33 else 48
    D = -(-D // n) * n
    db, qs = _db(Q * n, D, 3, 44, Q, ties=True)
    want = jpsearch.hdist_search_batch_sharded(jnp.asarray(qs), _jshard(db, jm, P("data", None)),
                                               44, topk, jm)
    got = parallel.hdist_search_batch_sharded(words_from_u32_np(qs), words_from_u32_np(db), 44,
                                              topk, m)
    _same(got, want)
    loc = hamming.hdist_topk_batch(words_from_u32_np(qs), words_from_u32_np(db), 44,
                                   min(topk, D))
    assert torch.equal(got[0], loc[0]) and torch.equal(got[1], loc[1])


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("Q", [1, 8, 20])  # 8 on: the fused search on unpadded slabs
def test_hdist_search_batch_db_sharded_matches_jax(n, Q):
    m, jm = _meshes(n)
    D_true = 7 * n + (n > 1)  # a padded last slab where n > 1
    db, qs = _db(Q + n, D_true, 5, 70, Q, ties=True)
    pad = (-D_true) % n
    wm = np.pad(db.T, ((0, 0), (0, pad)))
    for d_valid in (None, D_true):
        want = jpsearch.hdist_search_batch_db_sharded(
            jnp.asarray(qs), _jshard(wm, jm, P(None, "data")), 70, 6, jm, d_valid=d_valid)
        got = psearch.hdist_search_batch_db_sharded(
            words_from_u32_np(qs), words_from_u32_np(wm), 70, 6, m, d_valid=d_valid)
        _same(got, want)
    loc = hamming.hdist_topk_batch(words_from_u32_np(qs), words_from_u32_np(db), 70, 6)
    assert torch.equal(got[0], loc[0]) and torch.equal(got[1], loc[1])


def test_padding_never_displaces_a_real_entry():
    """Real entries all at the largest distance, padding columns zero: a
    padded slab on the fused route would rank its zero columns first."""
    m, _ = _meshes(3)
    W, L, Q = 2, 32, 16
    qs = np.zeros((Q, W), np.uint32)
    db = np.full((7, W), 0x55555555, np.uint32)  # every base differs from A
    wm = np.pad(db.T, ((0, 0), (0, 2)))
    dd, ii = psearch.hdist_search_batch_db_sharded(
        words_from_u32_np(qs), words_from_u32_np(wm), L, 7, m, d_valid=7)
    assert (dd == L).all() and sorted(ii[0].tolist()) == list(range(7))


@pytest.mark.parametrize("Q", [2, 16])
def test_padding_columns_fill_a_top_k_past_the_real_entries(Q):
    """topk past d_valid: the padding columns come back at n_bases + 1 in
    index order, as JAX's masked top-k returns them."""
    m, jm = _meshes(3)
    db, qs = _db(Q, 4, 3, 40, Q)
    wm = np.pad(db.T, ((0, 0), (0, 2)))
    want = jpsearch.hdist_search_batch_db_sharded(
        jnp.asarray(qs), _jshard(wm, jm, P(None, "data")), 40, 5, jm, d_valid=4)
    got = psearch.hdist_search_batch_db_sharded(
        words_from_u32_np(qs), words_from_u32_np(wm), 40, 5, m, d_valid=4)
    _same(got, want)
    assert (got[0][:, 4] == 41).all() and (got[1][:, 4] == 4).all()  # the first padding


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")), ((2, 4), ("q", "d")),
                                        ((1, 3), ("data", "model"))])
def test_hdist_search_grid_matches_jax(shape, axes):
    n = shape[0] * shape[1]
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    m = pmesh.make_mesh(shape, axes, devices=[CPU] * n)
    jm = jax.make_mesh(shape, axes, devices=jax.devices()[:n])
    Q, D, L = 16, 12 * shape[1], 96
    db, qs = _db(n, D, 6, L, Q, ties=True)
    wm = np.ascontiguousarray(db.T)
    want = jpsearch.hdist_search_grid(jnp.asarray(qs), jnp.asarray(wm), L, 5, jm, *axes)
    got = psearch.hdist_search_grid(words_from_u32_np(qs), words_from_u32_np(wm), L, 5, m,
                                    *axes)
    assert all(isinstance(g, pmesh.Sharded) for g in got)
    _same(got, want)
    D2 = D - shape[1] + 1
    pad = (-D2) % shape[1]
    wm2 = np.pad(wm[:, :D2], ((0, 0), (0, pad)))
    want2 = jpsearch.hdist_search_grid(jnp.asarray(qs), jnp.asarray(wm2), L, 5, jm, *axes,
                                       d_valid=D2)
    got2 = psearch.hdist_search_grid(words_from_u32_np(qs), words_from_u32_np(wm2), L, 5, m,
                                     *axes, d_valid=D2)
    _same(got2, want2)
    loc = hamming.hdist_topk_batch(words_from_u32_np(qs), words_from_u32_np(db[:D2]), L, 5)
    assert torch.equal(got2[0].full(), loc[0]) and torch.equal(got2[1].full(), loc[1])


@pytest.mark.parametrize("n", [1, 8])
def test_hdist_many_to_many_sharded_matches_jax(n):
    m, jm = _meshes(n)
    db, qs = _db(n, 2 * n, 2, 32, 4)
    want = jpar.hdist_many_to_many_sharded(jnp.asarray(qs), _jshard(db, jm, P("data", None)),
                                           32, jm)
    got = parallel.hdist_many_to_many_sharded(words_from_u32_np(qs), words_from_u32_np(db), 32,
                                              m)
    assert isinstance(got, pmesh.Sharded) and got.dim == 1 and got.shape == (4, 2 * n)
    _same([got], [want])


@pytest.mark.parametrize("n", [1, 3, 8])
def test_hdist_search_db_sharded_matches_jax(n):
    m, jm = _meshes(n)
    D_true = 9 * n - (n > 1)
    db, qs = _db(3 * n, D_true, 6, 96, 1, ties=True)
    wm = np.pad(db.T, ((0, 0), (0, (-D_true) % n)))
    for d_valid in (None, D_true):
        want = jpsearch.hdist_search_db_sharded(
            jnp.asarray(qs[0]), _jshard(wm, jm, P(None, "data")), 96, 4, jm, d_valid=d_valid)
        got = parallel.hdist_search_db_sharded(
            words_from_u32_np(qs[0]), words_from_u32_np(wm), 96, 4, m, d_valid=d_valid)
        _same(got, want)


def test_sharded_inputs_are_used_as_they_lie():
    """A Sharded of the same mesh and axis goes in without a copy."""
    m, _ = _meshes(2)
    w, lens, _ = _batch(9, 4, 40)
    sh = parallel.shard_reads(PackedReads(words=words_from_u32_np(w),
                                          lengths=torch.from_numpy(lens)), m)
    assert all(a is b for a, b in zip(pmesh.split(sh.words, m, "data"), sh.word_shards))
