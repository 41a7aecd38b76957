"""bitnuc_tpu_torch Hamming search against bitnuc_tpu: the plain version of
the K4/K5 scan against the Pallas scans in interpret mode and against
hdist_many_to_many, top-k ties and sentinel tails, and PackedDB .npz files
moving between the two packages. Distances and indices match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.database import PackedDB as JPackedDB
from bitnuc_tpu.ops import hamming as jham
from bitnuc_tpu.ops.pallas import hamming as jph
from bitnuc_tpu.utils import bitops as jbitops
from bitnuc_tpu_torch.database import PackedDB
from bitnuc_tpu_torch.ops import hamming
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)


@pytest.mark.parametrize("D,W,nb", [(100, 32, 512), (5000, 4, 50), (1, 2, 7)])
def test_scan_one_query_matches_pallas(rng, D, W, nb):
    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    q = rng.integers(0, 2**32, size=(W,), dtype=np.uint32)
    want = np.asarray(jph.hdist_scan_pallas(jnp.asarray(q), jnp.asarray(db.T), nb, interpret=True))
    got = hamming.hdist_scan_torch(words_from_u32_np(q[None]), words_from_u32_np(db.T), nb)
    np.testing.assert_array_equal(got.numpy()[0], want)
    want_d, want_i = jham.hdist_topk(jnp.asarray(q), jnp.asarray(db), nb, 5)
    got_d, got_i = hamming.hdist_topk(words_from_u32_np(q), words_from_u32_np(db), nb, 5)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("Q,D,nb", [(1, 16, 32), (5, 100, 77), (70, 513, 200)])
def test_scan_batch_matches_pallas_and_xla(rng, Q, D, nb):
    W = jbitops.n_words_for(nb)
    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(Q, W), dtype=np.uint32)
    want = np.asarray(jph.hdist_scan_batch_pallas(
        jnp.asarray(qs), jnp.asarray(db.T.copy()), nb, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jham.hdist_many_to_many(jnp.asarray(qs), jnp.asarray(db), nb)))
    got = hamming.hdist_scan_torch(words_from_u32_np(qs), words_from_u32_np(db.T), nb)
    np.testing.assert_array_equal(got.numpy(), want)
    got_rm = hamming.hdist_many_to_many(words_from_u32_np(qs), words_from_u32_np(db), nb)
    np.testing.assert_array_equal(got_rm.numpy(), want)


def test_topk_ties_and_tail(rng):
    vals = rng.integers(0, 4, size=37).astype(np.int32)  # many ties
    for k in (1, 10, 37, 50):
        want = jham.topk_smallest(jnp.asarray(vals), k)
        got = hamming.topk_smallest(torch.from_numpy(vals), k)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    mat = rng.integers(0, 5, size=(4, 1300)).astype(np.int32)
    for k in (3, 16):
        want = jham.topk_smallest_batch(jnp.asarray(mat), k)
        got = hamming.topk_smallest_batch(torch.from_numpy(mat), k)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    small = mat[:, :5]
    want = jham.topk_smallest_batch(jnp.asarray(small), 8)
    got = hamming.topk_batch_dispatch(torch.from_numpy(small), 8)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[0][0, -1] == 2**30 and got[1][0, -1] == -1


def test_hdist_words_per_pair(rng):
    a = rng.integers(0, 2**32, size=(9, 4), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(9, 4), dtype=np.uint32)
    nb = rng.integers(0, 70, size=9).astype(np.int32)
    want = np.asarray(jham.hdist_words(jnp.asarray(a), jnp.asarray(b), jnp.asarray(nb)))
    got = hamming.hdist_words(words_from_u32_np(a), words_from_u32_np(b), torch.from_numpy(nb))
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_db_npz_both_ways(rng, tmp_path):
    D, nb = 300, 90
    W = jbitops.n_words_for(nb)
    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(3, W), dtype=np.uint32)
    jdb = JPackedDB(words_wm=jnp.asarray(db.T.copy()), n_bases=nb)
    jdb.save(tmp_path / "j.npz")
    tdb = PackedDB.load(tmp_path / "j.npz")
    assert tdb.n_bases == nb and len(tdb) == D and tdb.n_words == W
    want_d, want_i = jdb.search(jnp.asarray(qs[0]), 7)
    got_d, got_i = tdb.search(words_from_u32_np(qs[0]), 7)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_bd, want_bi = jdb.search_batch(jnp.asarray(qs), 7)
    got_bd, got_bi = tdb.search_batch(words_from_u32_np(qs), 7)
    np.testing.assert_array_equal(got_bd.numpy(), np.asarray(want_bd))
    np.testing.assert_array_equal(got_bi.numpy(), np.asarray(want_bi))

    tdb.save(tmp_path / "t.npz")
    back = JPackedDB.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(np.asarray(back.words_wm), db.T)
    assert back.n_bases == nb
    u64 = jbitops.words_u32_to_u64_np(db)
    np.testing.assert_array_equal(
        PackedDB.from_u64(u64, nb).distances(words_from_u32_np(qs[1])).numpy(),
        np.asarray(jdb.distances(jnp.asarray(qs[1]))),
    )
