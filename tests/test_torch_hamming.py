"""bitnuc_tpu_torch Hamming search against bitnuc_tpu: the plain version of
the K4/K5 scan against the Pallas scans in interpret mode and against
hdist_many_to_many, top-k ties and sentinel tails, and PackedDB .npz files
moving between the two packages. Distances and indices match exactly."""

import pathlib
import re

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
CPU = torch.device("cpu")


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


# n_bases of each widened case, from W: none, one base, one word, one base
# into the second word, one short of every word, every word
SCAN_NB = {"0": lambda W: 0, "1": lambda W: 1, "16": lambda W: 16, "17": lambda W: 17,
           "16W-1": lambda W: 16 * W - 1, "16W": lambda W: 16 * W}


@pytest.mark.parametrize("Q,D,W,nb", [
    pytest.param(1, 16, None, 32, id="1-16-32"),
    pytest.param(5, 100, None, 77, id="5-100-77"),
    pytest.param(70, 513, None, 200, id="70-513-200"),
] + [pytest.param(Q, 300, 5, nb, id=f"Q{Q}-W5-nb{nb}")
     for Q in (2, 8, 16, 17, 31, 33) for nb in SCAN_NB])
def test_scan_batch_matches_pallas_and_xla(rng, Q, D, W, nb):
    """Q across K5's query tiles (a partial tile of 32 past it); n_bases at
    0, 1, a word's end and past it, one short of all words and all of them,
    on an odd W."""
    if W is None:
        W = jbitops.n_words_for(nb)
    else:
        nb = SCAN_NB[nb](W)
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


# -- a model of K4/K5's query tiles (csrc/hamming.cu) ---------------------------

SCAN_TILES = (1, 2, 4, 8, 16, 32)


def _scan_tile(Q):
    """The kernel's query tile for Q queries: the smallest that covers Q,
    else 32 (and ceil(Q / 32) tiles)."""
    return next((t for t in SCAN_TILES if t >= Q), SCAN_TILES[-1])


def _source_layout(name):
    """hamming.cu's constexpr ``name`` (run_slot or run_query) as a Python
    function: its one-line body of shifts and a subtraction means the same
    in Python on non-negative ints."""
    src = (pathlib.Path(hamming.__file__).parents[1] / "csrc" / "hamming.cu").read_text()
    m = re.search(rf"constexpr int {name}\(int (\w+), int (\w+)\) \{{ return ([^;]+); \}}", src)
    assert m, name
    return eval(f"lambda {m[1]}, {m[2]}: {m[3]}")  # noqa: S307


RUN_SLOT, RUN_QUERY = _source_layout("run_slot"), _source_layout("run_query")


def _runs(TQ, nq):
    """The runs of hamming.cu's tiles, from its run_slot and run_query (the
    one layout that slot_query, bit_runs and store_bit_runs share): (N, OFF,
    j0) for a tile of TQ slots serving nq queries, slots OFF..OFF+N-1
    holding queries j0..j0+N-1."""
    if nq == TQ:
        return [(TQ, 0, 0)]
    return [(1 << b, RUN_SLOT(TQ, b), RUN_QUERY(b, nq))
            for b in reversed(range(TQ.bit_length() - 1)) if nq >> b & 1]


@pytest.mark.parametrize("TQ", SCAN_TILES)
def test_scan_tile_slots_hold_each_query_once(TQ):
    """Every nq <= TQ: the runs hold queries 0..nq-1 once each in distinct
    slots, so no more slots work than nq, and each of nq's bits b is the
    run of 2^b slots at TQ - 2^(b+1) whatever the other bits (its offset
    is fixed)."""
    for nq in range(1, TQ + 1):
        runs = _runs(TQ, nq)
        slots = [off + i for n, off, _ in runs for i in range(n)]
        held = [j0 + i for n, _, j0 in runs for i in range(n)]
        assert len(set(slots)) == len(slots) and max(slots) < TQ
        assert sorted(held) == list(range(nq))
        if nq < TQ:
            assert {n: off for n, off, _ in runs} == {
                1 << b: TQ - (2 << b) for b in range(TQ.bit_length() - 1) if nq >> b & 1}
    assert [_scan_tile(Q) for Q in (1, 2, 3, 5, 9, 16, 17, 32, 33, 127)] == \
        [1, 2, 4, 8, 16, 16, 32, 32, 32, 32]


EVEN = np.uint32(0x55555555)


def _popc(x):
    return np.bitwise_count(x).astype(np.int64)


def _merge_pair(w0, w1):
    """hamming.cu's merge_pair: words w and w + 1 into (a, b)."""
    return (w0 & EVEN) | (w1 & ~EVEN), ((w0 >> 1) & EVEN) | ((w1 << 1) & ~EVEN)


def _two_word_select(x0, x1, q0, q1):
    """One popcount's operand in the unmerged form: word w's mismatches in
    the even bits, word w + 1's in the odd bits, from the shifted words."""
    c0 = ((x0 >> 1) ^ (q0 >> 1)) | (x0 ^ q0)
    c1 = ((x1 << 1) ^ (q1 << 1)) | (x1 ^ q1)
    return (c0 & EVEN) | (c1 & ~EVEN)


def _base_mask(v):
    return np.uint32(0 if v <= 0 else 0xFFFFFFFF if v >= 16 else (1 << (2 * v)) - 1)


def _scan_model(qs, db_wm, nb):
    """A numpy model of csrc/hamming.cu, step by step: query tiles and their
    slots, only the last word masked (in the query and the database), the
    words merged in pairs and two pairs a quad, a lone last pair when the
    pairs are odd, one popcount a pair. At every pair it also checks the
    unmerged two-word select against the merged count."""
    Q, W = qs.shape
    D = db_wm.shape[1]
    weff = min(-(-nb // 16), W) if nb > 0 else 0
    last = weff - 1
    last_mask = _base_mask(nb - 16 * last)
    words = [db_wm[w] & (last_mask if w == last else np.uint32(0xFFFFFFFF)) for w in range(weff)]
    zero = np.zeros(D, np.uint32)
    qwords = [qs[:, w] & (last_mask if w == last else np.uint32(0xFFFFFFFF)) for w in range(weff)]
    qzero = np.zeros(Q, np.uint32)
    out = np.zeros((Q, D), np.int64)
    TQ = _scan_tile(Q)
    lp = (weff + 1) // 2 - 1
    pairs = list(range(lp + 1))  # full quads, then the tail's one or two pairs
    for q0 in range(0, Q, TQ):
        nq = min(TQ, Q - q0)
        slots = [j0 + i for n, _, j0 in _runs(TQ, nq) for i in range(n)]
        acc = np.zeros((len(slots), D), np.int64)
        for p in pairs:
            x0 = words[2 * p]
            x1 = words[2 * p + 1] if 2 * p + 1 < weff else zero
            a, b = _merge_pair(x0, x1)
            for k, j in enumerate(slots):
                y0 = qwords[2 * p][q0 + j]
                y1 = (qwords[2 * p + 1] if 2 * p + 1 < weff else qzero)[q0 + j]
                qa, qb = _merge_pair(y0, y1)
                count = _popc((a ^ qa) | (b ^ qb))
                np.testing.assert_array_equal(count, _popc(_two_word_select(x0, x1, y0, y1)))
                acc[k] += count
        for k, j in enumerate(slots):
            out[q0 + j] = acc[k]
    return out


def test_merged_pair_counts_both_words(rng):
    """popc((a ^ qa) | (b ^ qb)) of the merged pairs, and the two-word select
    it comes from, count word w's and word w + 1's differing bases."""
    x0, x1, q0, q1 = rng.integers(0, 2**32, size=(4, 100_000), dtype=np.uint32)
    q1[:1000] = x1[:1000]  # the second word equal
    x0[1000:2000] = q0[1000:2000]  # the first word equal

    def per_word(x, q):
        d = x ^ q
        return _popc((d | (d >> 1)) & EVEN)

    want = per_word(x0, q0) + per_word(x1, q1)
    (a, b), (qa, qb) = _merge_pair(x0, x1), _merge_pair(q0, q1)
    np.testing.assert_array_equal(_popc((a ^ qa) | (b ^ qb)), want)
    np.testing.assert_array_equal(_popc(_two_word_select(x0, x1, q0, q1)), want)
    a, b = _merge_pair(x0, np.zeros_like(x1))  # a lone word paired with zero
    qa, qb = _merge_pair(q0, np.zeros_like(q1))
    np.testing.assert_array_equal(_popc((a ^ qa) | (b ^ qb)), per_word(x0, q0))


@pytest.mark.parametrize("Q,W,nb", [
    (1, 1, 16), (2, 2, 17), (4, 4, 1), (3, 3, 47), (5, 5, 80), (8, 6, 95), (17, 7, 112),
    (31, 8, 128), (33, 5, 33), (33, 9, 0), (64, 10, 150), (16, 32, 511),
])
def test_scan_model_matches_plain_and_pallas(rng, Q, W, nb):
    """The kernel's model equals the plain version and the Pallas kernel in
    interpret mode: partial tiles and tiles past 32, odd and even weff
    (a lone last pair or two), the last word partial or whole, and weff
    below W."""
    D = 257
    db = rng.integers(0, 2**32, size=(W, D), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(Q, W), dtype=np.uint32)
    qs[0] = db[:, 5]  # a distance of 0
    got = _scan_model(qs, db, nb)
    want = np.asarray(jph.hdist_scan_batch_pallas(jnp.asarray(qs), jnp.asarray(db), nb,
                                                  interpret=True))
    np.testing.assert_array_equal(got, want)
    plain = hamming.hdist_scan_torch(words_from_u32_np(qs), words_from_u32_np(db), nb)
    np.testing.assert_array_equal(got, plain.numpy())


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
    tdb = PackedDB.load(tmp_path / "j.npz", device=CPU)
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
        PackedDB.from_u64(u64, nb, device=CPU).distances(words_from_u32_np(qs[1])).numpy(),
        np.asarray(jdb.distances(jnp.asarray(qs[1]))),
    )


@pytest.mark.parametrize("W,D", [(1, 7), (2, 300), (4, 1030)])
def test_hdist_one_to_many_matches_jax(rng, W, D):
    """Every n_bases from 0 to 16 W + 7, on random rows and on copies of
    the query with a few bases changed."""
    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    q = rng.integers(0, 2**32, size=(W,), dtype=np.uint32)
    db[: D // 2] = q ^ (rng.random((D // 2, W)) < 0.1).astype(np.uint32) * 3
    for nb in range(0, 16 * W + 8, 3 if W > 1 else 1):
        want = np.asarray(jham.hdist_one_to_many(jnp.asarray(q), jnp.asarray(db), nb))
        got = hamming.hdist_one_to_many(words_from_u32_np(q), words_from_u32_np(db), nb)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Q,D,W,nb,k", [
    (1, 50, 2, 32, 5), (3, 700, 4, 50, 10), (9, 513, 2, 20, 32), (20, 40, 1, 16, 64),
    (5, 3, 2, 30, 7), (4, 100, 2, 0, 3),
])
def test_hdist_topk_batch_matches_jax(rng, Q, D, W, nb, k):
    """Random rows, then ties: the database holds repeated rows, so equal
    distances must come back by lowest index; k past D gives JAX's tail."""
    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    db[D // 2 :] = db[: D - D // 2]  # every distance of the upper half ties one below
    qs = db[rng.integers(0, D, Q)] ^ (rng.random((Q, W)) < 0.2).astype(np.uint32)
    want_d, want_i = jham.hdist_topk_batch(jnp.asarray(qs), jnp.asarray(db), nb, k)
    got_d, got_i = hamming.hdist_topk_batch(words_from_u32_np(qs), words_from_u32_np(db), nb, k)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # the card's route (PackedDB.search_batch on the word-major database) on the CPU
    db_t = PackedDB(words_wm=words_from_u32_np(db.T), n_bases=nb)
    for d, i in (db_t.search_batch(words_from_u32_np(qs), k),
                 hamming.hdist_topk_batch_torch(words_from_u32_np(qs), words_from_u32_np(db),
                                                nb, k)):
        np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
