"""bitnuc_tpu_torch's many-query search against bitnuc_tpu: the plain
version of K6 (the +-1 bit-plane product) against the TPU's bit-plane
kernel in interpret mode and against hdist_many_to_many, the kernel's
B-operand layout, PackedDB.distances_batch and search_batch on both sides of
tc_min_q, and PackedDB.from_fastq against the JAX package's. Distances,
indices and words are equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.database import PackedDB as JPackedDB
from bitnuc_tpu.errors import InvalidBase as JInvalidBase
from bitnuc_tpu.ops import hamming as jham
from bitnuc_tpu.ops.pallas import hamming as jph
from bitnuc_tpu_torch import database
from bitnuc_tpu_torch.database import PackedDB
from bitnuc_tpu_torch.errors import InvalidBase
from bitnuc_tpu_torch.ops import hamming
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("Q,W,D,nb", [(5, 4, 200, 64), (130, 9, 700, 137), (64, 32, 600, 512)])
def test_tc_plain_matches_mxu_interpret_and_xla(Q, W, D, nb):
    """The shapes of the JAX package's own bit-plane test."""
    rng = np.random.default_rng(Q + W + D)
    qs, db = _words(rng, Q, W), _words(rng, W, D)
    want = np.asarray(jham.hdist_many_to_many(jnp.asarray(qs), jnp.asarray(db.T.copy()), nb))
    np.testing.assert_array_equal(
        np.asarray(jph.hdist_scan_batch_mxu(jnp.asarray(qs), jnp.asarray(db), nb,
                                            interpret=True)), want)
    got = hamming.hdist_scan_tc_torch(words_from_u32_np(qs), words_from_u32_np(db), nb)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W,nb", [(1, 0), (1, 16), (2, 40), (3, 37), (33, 528), (2, -5)])
def test_tc_plain_clamps_n_bases_like_xla(W, nb):
    """n_bases past 16 W counts the words only, as hdist_many_to_many does;
    the TPU bit-plane kernel adds 3 (n_bases - 16 W) / 4 there instead (at
    W = 2, n_bases = 40: 6 more on every distance)."""
    rng = np.random.default_rng(W + 100)
    qs, db = _words(rng, 5, W), _words(rng, W, 100)
    want = np.asarray(jham.hdist_many_to_many(jnp.asarray(qs), jnp.asarray(db.T.copy()), nb))
    got = hamming.hdist_scan_tc_torch(words_from_u32_np(qs), words_from_u32_np(db), nb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), hamming.hdist_scan_torch(words_from_u32_np(qs), words_from_u32_np(db),
                                              nb).numpy())
    if nb > 16 * W:
        mxu = np.asarray(jph.hdist_scan_batch_mxu(jnp.asarray(qs), jnp.asarray(db), nb,
                                                  interpret=True))
        np.testing.assert_array_equal(mxu - want, 3 * (nb - 16 * W) // 4)


def test_tc_plain_chunks_the_database(monkeypatch):
    monkeypatch.setattr(hamming, "TC_CHUNK", 7)
    rng = np.random.default_rng(5)
    qs, db = words_from_u32_np(_words(rng, 3, 4)), words_from_u32_np(_words(rng, 4, 30))
    np.testing.assert_array_equal(hamming.hdist_scan_tc_torch(qs, db, 50).numpy(),
                                  hamming.hdist_scan_torch(qs, db, 50).numpy())


@pytest.mark.parametrize("Q,N", [(1, 8), (8, 8), (9, 32), (33, 64), (100, 128), (130, 256),
                                 (257, 256), (300, 256)])
@pytest.mark.parametrize("W", [1, 9, 32, 33])
def test_b_stages_follow_the_descriptor_layout(Q, N, W):
    """The query tile is the smallest template width N that covers Q (256
    and several tiles past it). Reading K6's B stages back through the
    shared-memory descriptor's map (K-major core matrices of 8 rows x 16
    bytes, no swizzle; B_LBO between the k halves, B_SBO between groups of 8
    rows) gives the query planes, zero rows past Q, one contiguous stage a
    (query tile, pair)."""
    rng = np.random.default_rng(Q + W)
    planes = hamming.query_planes(words_from_u32_np(_words(rng, Q, W)), 16 * W - 3)
    assert hamming._tile_n(Q) == N
    P = -(-W // 2)
    n_qt = -(-Q // N)
    stages = hamming._b_stages(planes, N)
    assert stages.is_contiguous() and stages.numel() == n_qt * P * 3 * N * 32
    flat = stages.reshape(n_qt, P, 3, N * 32).numpy()
    n, j = np.meshgrid(np.arange(N), np.arange(32), indexing="ij")
    at = (n // 8) * hamming.B_SBO + (j // 16) * hamming.B_LBO + (n % 8) * 16 + j % 16
    B = np.zeros((n_qt * N, 96 * P), np.int8)
    for qt in range(n_qt):
        for p in range(P):
            for g in range(3):
                B[qt * N : qt * N + N, 96 * p + 32 * g : 96 * p + 32 * g + 32] = flat[qt, p, g][at]
    np.testing.assert_array_equal(B[:Q], planes.numpy())
    assert not B[Q:].any()


@pytest.mark.parametrize("Q", [3, database.tc_min_q(32) - 1, database.tc_min_q(32),
                               database.tc_min_q(32) + 5])
def test_distances_and_search_batch_both_sides_of_tc_min_q(Q):
    """Both sides of the K5/K6 threshold of 32-word entries, n_bases
    inside the last word; 28 to 31 words reach K6 from 512 queries, fewer
    never."""
    assert database.tc_min_q(31) == 512 and database.tc_min_q(27) is None
    rng = np.random.default_rng(Q)
    D, nb = 500, 500
    W = 32
    db, qs = _words(rng, D, W), _words(rng, Q, W)
    jdb = JPackedDB(words_wm=jnp.asarray(db.T.copy()), n_bases=nb)
    tdb = PackedDB.from_numpy(db.T.copy(), nb, device=CPU)
    np.testing.assert_array_equal(tdb.distances_batch(words_from_u32_np(qs)).numpy(),
                                  np.asarray(jdb.distances_batch(jnp.asarray(qs))))
    want_d, want_i = jdb.search_batch(jnp.asarray(qs), 9)
    got_d, got_i = tdb.search_batch(words_from_u32_np(qs), 9)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("W,Q", [(28, 511), (28, 512), (31, 512)])
def test_distances_batch_both_sides_of_tc_min_q_below_32_words(W, Q):
    """28 to 31 words, K5 below 512 queries and K6 from it: equal to the
    JAX package."""
    rng = np.random.default_rng(W + Q)
    D, nb = 40, 16 * W - 5
    db, qs = _words(rng, D, W), _words(rng, Q, W)
    jdb = JPackedDB(words_wm=jnp.asarray(db.T.copy()), n_bases=nb)
    tdb = PackedDB.from_numpy(db.T.copy(), nb, device=CPU)
    np.testing.assert_array_equal(tdb.distances_batch(words_from_u32_np(qs)).numpy(),
                                  np.asarray(jdb.distances_batch(jnp.asarray(qs))))


def test_tc_min_q_by_width():
    """K6 from 256 queries on 32 words or more, from 512 on 28 to 31, never
    on fewer."""
    assert [database.tc_min_q(w) for w in (1, 10, 20, 24, 27, 28, 31, 32, 33, 64)] == \
        [None] * 5 + [512, 512, 256, 256, 256]


def _write_fastq(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


@pytest.mark.parametrize("n_bases,batch", [(50, 8192), (64, 7), (100, 3), (17, 1000)])
def test_from_fastq_matches_jax(tmp_path, n_bases, batch):
    """Entries truncated or zero-padded to n_bases, over several batches."""
    rng = np.random.default_rng(n_bases)
    acgt = np.frombuffer(b"ACGTacgt", np.uint8)
    seqs = [bytes(acgt[rng.integers(0, 8, int(m))]) for m in rng.integers(1, 120, 23)]
    path = tmp_path / "db.fq"
    _write_fastq(path, seqs)
    want = JPackedDB.from_fastq(str(path), n_bases, batch_size=batch)
    got = PackedDB.from_fastq(path, n_bases, batch_size=batch, device=CPU)
    assert got.n_bases == want.n_bases == n_bases
    np.testing.assert_array_equal(got.words_wm.numpy().view(np.uint32),
                                  np.asarray(want.words_wm))


@pytest.mark.parametrize("name,batch", [("db.fq", 7), ("db.fq.gz", 64)])
def test_from_fastq_full_width_equals_host_packing(tmp_path, name, batch):
    """Entries of exactly n_bases = 512 over several batches, as the
    on-card check builds them: equal to the host's LSB-first packing of the
    same bases (base j of a word at bits 2j, 2j + 1) and to JAX."""
    import gzip

    rng = np.random.default_rng(512)
    codes = rng.integers(0, 4, (150, 512))
    seqs = [bytes(r) for r in np.frombuffer(b"ACGT", np.uint8)[codes]]
    path = tmp_path / name
    _write_fastq(path, seqs)
    if name.endswith(".gz"):
        path.write_bytes(gzip.compress(path.read_bytes(), compresslevel=1))
    shifts = 2 * np.arange(16, dtype=np.uint64)
    host = (codes.astype(np.uint64).reshape(150, 32, 16) << shifts).sum(-1).astype(np.uint32)
    got = PackedDB.from_fastq(path, 512, batch_size=batch, device=CPU).words_wm.numpy()
    np.testing.assert_array_equal(got.view(np.uint32), host.T)
    np.testing.assert_array_equal(
        got.view(np.uint32), np.asarray(JPackedDB.from_fastq(str(path), 512, batch_size=batch).words_wm))


def test_from_fastq_empty_and_invalid(tmp_path):
    empty = tmp_path / "empty.fq"
    empty.write_bytes(b"")
    got = PackedDB.from_fastq(empty, 40, device=CPU)
    assert tuple(got.words_wm.shape) == tuple(JPackedDB.from_fastq(str(empty), 40).words_wm.shape)
    bad = tmp_path / "bad.fq"
    _write_fastq(bad, [b"ACGT", b"ACNGT"])
    with pytest.raises(JInvalidBase):
        JPackedDB.from_fastq(str(bad), 8)
    with pytest.raises(InvalidBase):
        PackedDB.from_fastq(bad, 8, device=CPU)
    assert len(PackedDB.from_fastq(bad, 8, validate=False, device=CPU)) == 2


# -- the mesh paths: the database split column-wise over CPU shards -----------------


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("Q,k,D", [(1, 5, 301), (7, 4, 301), (20, 10, 301), (20, 40, 13)])
def test_search_mesh_matches_jax(n, Q, k, D):
    """search (one query, K4 a slab) and search_batch (few queries: K5 and
    the top-k; SEARCH_TC_MIN_Q on: the fused search on unpadded slabs, the
    unfused route on the padded one; k past SEARCH_TOPK_MAX and past D)
    against JAX's n-device mesh path; D divides no mesh. Ties: the entries
    repeat."""
    import jax

    from bitnuc_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(Q + k + n)
    db = _words(rng, 6, 9)[:, rng.integers(0, 9, D)]
    qs = _words(rng, Q, 6)
    qs[0] = db[:, D // 2]
    tdb = PackedDB.from_numpy(db, 90, device=CPU)
    jdb = JPackedDB(words_wm=jnp.asarray(db), n_bases=90)
    jmesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
    mesh = pmesh.make_mesh((n,), ("data",), devices=[CPU] * n)
    for got, want in ((tdb.search_batch(words_from_u32_np(qs), k, mesh=mesh),
                       jdb.search_batch(jnp.asarray(qs), k, mesh=jmesh)),
                      (tdb.search(words_from_u32_np(qs[0]), k, mesh=mesh),
                       jdb.search(jnp.asarray(qs[0]), k, mesh=jmesh))):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == np.asarray(w).shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    m = min(k, D)
    for g, w in zip(tdb.search_batch(words_from_u32_np(qs), k, mesh=mesh),
                    tdb.search_batch(words_from_u32_np(qs), m)):
        assert torch.equal(g, w)
