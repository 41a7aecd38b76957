"""bitnuc_tpu_torch's fused many-query search against bitnuc_tpu: the plain
version of the tc_search kernel (hdist_search_tc_torch) and
PackedDB.search_batch on the CPU against the JAX package's
PackedDB.search_batch and topk_smallest_batch(hdist_many_to_many), at
ragged shapes, k past D, k = 1 and k on both sides of SEARCH_TOPK_MAX,
n_bases 0, 137 (clamped at W = 1) and 16 W, a database of one repeated
entry, and the routing of search_batch. Distances and indices are equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.database import PackedDB as JPackedDB
from bitnuc_tpu.ops import hamming as jham
from bitnuc_tpu_torch import config, database
from bitnuc_tpu_torch.database import PackedDB
from bitnuc_tpu_torch.ops import hamming
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")
KMAX = hamming.SEARCH_TOPK_MAX


def _words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# a Latin square over Q, W and D: each value of one meets each value of another once
@pytest.mark.parametrize("Q,W,D", [(1, 1, 1), (1, 9, 7), (1, 33, 5000), (5, 1, 7),
                                   (5, 9, 5000), (5, 33, 1), (130, 1, 5000), (130, 9, 1),
                                   (130, 33, 7)])
@pytest.mark.parametrize("k", [1, 10, KMAX, KMAX + 1])
def test_fused_search_matches_jax(Q, W, D, k):
    rng = np.random.default_rng(Q * 1000 + W * 10 + D)
    qs, db = _words(rng, Q, W), _words(rng, W, D)
    tq, tdb = words_from_u32_np(qs), PackedDB.from_numpy(db, 0, device=CPU)
    for nb in (0, 137, 16 * W):
        jdb = JPackedDB(words_wm=jnp.asarray(db), n_bases=nb)
        want = jdb.search_batch(jnp.asarray(qs), k)
        _assert_equal(want, jham.topk_smallest_batch(
            jham.hdist_many_to_many(jnp.asarray(qs), jnp.asarray(db.T.copy()), nb), k))
        _assert_equal(hamming.hdist_search_tc_torch(tq, tdb.words_wm, nb, k), want)
        _assert_equal(PackedDB(tdb.words_wm, nb).search_batch(tq, k), want)


@pytest.mark.parametrize("D,k", [(130, 10), (700, KMAX)])
def test_ties_go_to_the_lowest_index(D, k, monkeypatch):
    """One repeated entry: every distance ties, so each list is entries
    0..k-1, across the plain version's chunks too."""
    monkeypatch.setattr(hamming, "TC_CHUNK", 64)
    rng = np.random.default_rng(D)
    db = np.repeat(_words(rng, 4, 1), D, axis=1)
    qs = _words(rng, 6, 4)
    want = JPackedDB(words_wm=jnp.asarray(db), n_bases=50).search_batch(jnp.asarray(qs), k)
    got = hamming.hdist_search_tc_torch(words_from_u32_np(qs), words_from_u32_np(db), 50, k)
    _assert_equal(got, want)
    np.testing.assert_array_equal(got[1].numpy(), np.tile(np.arange(k), (6, 1)))


def test_plain_search_chunks_the_database(monkeypatch):
    monkeypatch.setattr(hamming, "TC_CHUNK", 7)
    rng = np.random.default_rng(8)
    qs, db = words_from_u32_np(_words(rng, 3, 4)), words_from_u32_np(_words(rng, 4, 30))
    want = hamming.topk_smallest_batch(hamming.hdist_scan_torch(qs, db, 50), 5)
    _assert_equal(hamming.hdist_search_tc_torch(qs, db, 50, 5), want)


def _route(monkeypatch):
    """Record which route search_batch takes."""
    taken = []
    fused, two_step = hamming.hdist_search_tc, hamming.topk_batch_dispatch
    monkeypatch.setattr(hamming, "hdist_search_tc",
                        lambda *a: taken.append("fused") or fused(*a))
    monkeypatch.setattr(hamming, "topk_batch_dispatch",
                        lambda *a: taken.append("two-step") or two_step(*a))
    return taken


@pytest.mark.parametrize("Q,k,route", [
    (database.SEARCH_TC_MIN_Q, 10, "fused"),
    (database.SEARCH_TC_MIN_Q - 1, 10, "two-step"),
    (database.SEARCH_TC_MIN_Q + 3, KMAX, "fused"),
    (database.SEARCH_TC_MIN_Q + 3, KMAX + 1, "two-step"),
])
def test_search_batch_routes_by_q_and_k(Q, k, route, monkeypatch):
    """The fused route from SEARCH_TC_MIN_Q queries on for k <=
    SEARCH_TOPK_MAX, the matrix route otherwise; both equal JAX."""
    rng = np.random.default_rng(Q + k)
    db, qs = _words(rng, 6, 300), _words(rng, Q, 6)
    taken = _route(monkeypatch)
    got = PackedDB.from_numpy(db, 90, device=CPU).search_batch(words_from_u32_np(qs), k)
    assert taken == [route]
    _assert_equal(got, JPackedDB(words_wm=jnp.asarray(db), n_bases=90).search_batch(
        jnp.asarray(qs), k))


@pytest.mark.parametrize("n_qt,D,n_sm,bps", [(1, 4_194_304, 132, 1), (1, 5, 132, 1),
                                            (2, 300_000, 132, 1), (3, 128, 7, 2),
                                            (1, 4_194_304, 132, 2), (2, 1001, 132, 3)])
def test_search_grid_covers_the_database(n_qt, D, n_sm, bps):
    """K6's persistent schedule (tc_scan and tc_search): G blocks of
    `per_block` 128-entry tiles for each query tile cover every tile and
    leave no block empty, and the n_qt G blocks are at most one wave of
    bps blocks an SM, a full wave where the database has the tiles."""
    G, per_block = hamming._tile_grid(n_qt, D, n_sm, bps)
    n_mt = -(-D // 128)
    assert G * per_block >= n_mt > (G - 1) * per_block
    assert n_qt * G <= max(n_qt, bps * n_sm + n_qt - 1)
    if n_mt >= 4 * bps * n_sm:
        assert n_qt * G >= bps * n_sm * 0.97


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On a CPU tensor the dispatcher runs the plain version; the kernel's
    wrapper raises, also under backend('kernel'), and k is checked."""
    rng = np.random.default_rng(3)
    qs, db = words_from_u32_np(_words(rng, 2, 3)), words_from_u32_np(_words(rng, 3, 40))
    with pytest.raises(ValueError, match="CUDA"):
        hamming.hdist_search_tc_kernel(qs, db, 40, 5)
    with config.backend("kernel"), pytest.raises(ValueError, match="CUDA"):
        hamming.hdist_search_tc(qs, db, 40, 5)
    with pytest.raises(ValueError, match="k must be"):
        hamming.hdist_search_tc_kernel(qs, db, 40, KMAX + 1)
