"""bitnuc_tpu_torch.ops.chain against bitnuc_tpu.ops.chain: chain_anchors on
the same numpy-seeded anchors, all five outputs equal, over a fuzz of B, A,
lookback (1, 4, 64 and past A), max_gap and gap_unit with duplicate
anchors, rows with no valid anchor, negative coordinates and rpos at or
above 2^30 with valid set; and the cases of tests/test_chain.py. Two models
of C1's arithmetic (``csrc/chain.cu``) in Python: its division of the drift
by gap_unit (``gap_divider``) against //, and its compaction of the live
anchors into unsigned keys against ``sort_anchors``."""

import numpy as np
import pytest
import torch

from bitnuc_tpu.ops import chain as jchain
from bitnuc_tpu_torch import config
from bitnuc_tpu_torch.ops import chain

torch.set_num_threads(1)


def _jax(r, q, v, max_gap, gap_unit, lookback):
    return [np.asarray(x) for x in jchain.chain_anchors(r, q, v, max_gap, gap_unit, lookback)]


def _port(r, q, v, max_gap, gap_unit, lookback):
    out = chain.chain_anchors(torch.from_numpy(r), torch.from_numpy(q), torch.from_numpy(v),
                              max_gap, gap_unit, lookback)
    assert all(x.dtype == torch.int32 for x in out)
    return [x.numpy() for x in out]


def _equal(r, q, v, max_gap=512, gap_unit=8, lookback=64):
    got = _port(r, q, v, max_gap, gap_unit, lookback)
    want = _jax(r, q, v, max_gap, gap_unit, lookback)
    for name, g, w in zip(("score", "start_r", "end_r", "start_q", "end_q"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def _rows(seed, B, A, dup=0.1, neg=False, big=False):
    """B rows of A anchors: a noisy diagonal, noise anchors, repeats of
    earlier anchors, some invalid, row 0 all invalid."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 90, (B, A))
    drift = rng.integers(-9, 10, (B, A))
    r = np.cumsum(step, 1) + rng.integers(0, 4000, (B, 1))
    q = np.cumsum(np.maximum(step + drift, 1), 1)
    noise = rng.random((B, A)) < 0.3
    r = np.where(noise, rng.integers(0, 9000, (B, A)), r)
    q = np.where(noise, rng.integers(0, 3000, (B, A)), q)
    if dup:
        src = rng.integers(0, A, (B, A))
        d = rng.random((B, A)) < dup
        r = np.where(d, np.take_along_axis(r, src, 1), r)
        q = np.where(d, np.take_along_axis(q, src, 1), q)
    if neg:
        q = q - rng.integers(0, 2000, (B, 1))
        r = r - rng.integers(0, 6000, (B, 1))
    v = rng.random((B, A)) < 0.85
    v[0] = False
    if big:  # valid anchors at or above 2^30 are dead
        hit = rng.random((B, A)) < 0.1
        r = np.where(hit, 2**30 + rng.integers(0, 3, (B, A)), r)
    perm = rng.permuted(np.tile(np.arange(A), (B, 1)), axis=1)  # any order within a row
    take = lambda x: np.take_along_axis(x, perm, 1)
    return take(r).astype(np.int32), take(q).astype(np.int32), take(v)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("lookback", [1, 4, 64, 200])
def test_chain_fuzz_matches_jax(seed, lookback):
    rng = np.random.default_rng(100 + seed)
    B, A = int(rng.integers(1, 9)), int(rng.integers(1, 120))
    max_gap = int(rng.choice([0, 50, 300, 2048]))
    gap_unit = int(rng.choice([1, 8, 16, 1000]))
    r, q, v = _rows(seed, B, A, neg=seed % 2 == 1, big=seed % 3 == 2)
    _equal(r, q, v, max_gap, gap_unit, lookback)


@pytest.mark.parametrize("case", ["duplicates", "all_invalid", "negative", "big_valid",
                                  "one_anchor"])
def test_chain_edges_match_jax(case):
    if case == "duplicates":  # the same anchor many times: the ties of every column
        r = np.repeat(np.array([[100, 150, 204, 260]], np.int32), 5, 1)
        q = np.repeat(np.array([[10, 60, 110, 166]], np.int32), 5, 1)
        v = np.ones_like(r, bool)
    elif case == "all_invalid":
        r, q, _ = _rows(1, 3, 40)
        v = np.zeros_like(r, bool)
    elif case == "negative":  # coordinates below -1: the -1 fill of the masked maxima
        r = np.array([[-900, -850, -800, -780, -700, -5000]], np.int32)
        q = np.array([[-300, -250, -200, -190, -100, -7]], np.int32)
        v = np.ones_like(r, bool)
    elif case == "big_valid":
        r = np.array([[2**30, 2**30 + 5, 100, 150, 2**31 - 1]], np.int32)
        q = np.array([[0, 1, 10, 60, 70]], np.int32)
        v = np.ones_like(r, bool)
    else:
        r, q, v = (np.array([[70]], np.int32), np.array([[7]], np.int32),
                   np.array([[True]]))
    for lookback in (1, 2, 64):
        for max_gap, gap_unit in ((512, 8), (0, 1), (2048, 16), (100, 1000)):
            _equal(r, q, v, max_gap, gap_unit, lookback)


def test_chain_no_anchors():
    """A = 0 (the JAX scan refuses an empty row): score 0, coordinates -1."""
    z = torch.zeros((2, 0), dtype=torch.int32)
    out = chain.chain_anchors(z, z, z.bool())
    assert [x.tolist() for x in out] == [[0, 0]] + [[-1, -1]] * 4


def _run(anchor_rows, A, max_gap=512, gap_unit=8, lookback=64):
    """tests/test_chain.py's helper, on the port."""
    B = len(anchor_rows)
    r = np.zeros((B, A), np.int32)
    q = np.zeros((B, A), np.int32)
    v = np.zeros((B, A), bool)
    for b, row in enumerate(anchor_rows):
        for i, (rp, qp) in enumerate(row):
            r[b, i], q[b, i], v[b, i] = rp, qp, True
    out = _equal(r, q, v, max_gap, gap_unit, lookback)
    return [tuple(int(x[b]) for x in out) for b in range(B)]


def test_chain_cases_of_the_jax_tests():
    row = [(100 + 20 * i, 10 + 20 * i) for i in range(5)]
    assert _run([row], 8) == [(5, 100, 180, 10, 90)]
    row = [(100, 10), (150, 60), (204, 110), (260, 166), (5000, 20)]
    got = _run([row], 8)[0]
    assert got[0] == 4 and (got[1], got[2]) == (100, 260)
    got = _run([[], [(70, 7)]], 4)
    assert got == [(0, -1, -1, -1, -1), (1, 70, 70, 7, 7)]
    row = [(i * 10, i * 10) for i in range(30)]
    assert _run([row], 30, lookback=4)[0][0] == 30
    row = [(0, 0)] + [(10 + i, 900 + i) for i in range(5)] + [(40, 4)]
    _run([row], 7, max_gap=100, gap_unit=8, lookback=4)


def test_chain_sort_orders_signed_pairs():
    r = torch.tensor([[5, -3, 5, 2**30, -3]], dtype=torch.int32)
    q = torch.tensor([[-(2**31), 7, 4, 0, -1]], dtype=torch.int32)
    v = torch.tensor([[True, True, True, True, False]])
    rs, qs = chain.sort_anchors(r, q, v)
    assert rs.tolist() == [[-3, 5, 5, 2**30, 2**30]]
    assert qs.tolist() == [[7, -(2**31), 4, 0, 2**30]]


def test_chain_backends_and_arguments():
    r, q, v = _rows(3, 4, 50)
    args = [torch.from_numpy(x) for x in (r, q, v)]
    want = chain.chain_anchors(*args)
    with config.backend("torch"):
        assert all(torch.equal(a, b) for a, b in zip(chain.chain_anchors(*args), want))
    with config.backend("kernel"), pytest.raises(ValueError, match="CUDA"):
        chain.chain_anchors(*args)
    with pytest.raises(ValueError, match="gap_unit"):
        chain.chain_anchors(*args, gap_unit=0)
    with pytest.raises(ValueError, match="lookback"):
        chain.chain_anchors(*args, lookback=0)


def _div_model(x, gap_unit: int):
    """``x // gap_unit`` for drifts in [0, 2^31) (Python ints or int64
    arrays), as C1 (``csrc/chain.cu::div_drift``) computes it from
    ``chain.gap_divider``. The high word of the 64-bit product 2x * magic
    is taken in two 16-bit halves of magic, so no intermediate passes
    2^49."""
    mode, magic, shift = chain.gap_divider(gap_unit)
    if mode == 0:
        return x >> shift
    if mode == 1:
        x2 = x << 1
        hi = (x2 * (magic >> 16) + ((x2 * (magic & 0xFFFF)) >> 16)) >> 16
        return hi >> shift
    return x // gap_unit


def _drifts(d):
    """Drifts in [0, 2^31): both ends of the range, a random sample, and
    the neighbours of multiples of d across it."""
    rng = np.random.default_rng(abs(d) % 1000)
    top = 2**31 - 1
    x = [np.arange(1 << 16), top - np.arange(1 << 16), rng.integers(0, top, 1 << 18)]
    m = abs(d)
    k = np.unique(np.concatenate([np.arange(1, 4096), rng.integers(1, top // m + 2, 1 << 14),
                                  top // m - np.arange(min(4096, top // m + 1))]))
    k = k[(k >= 1) & (k <= top // m)]
    for off in (-1, 0, 1):
        x.append(k * m + off)
    x = np.concatenate(x).astype(np.int64)
    return x[(x >= 0) & (x <= top)]


@pytest.mark.parametrize("d", [1, -1, 2, -2, 16, -16, 2**30, -(2**30), -(2**31), 3, -3, 1000,
                               -1000, 7, 2**31 - 1, -(2**31 - 1), 2**30 + 1])
def test_chain_gap_divider_matches_floor(d):
    """C1 divides the drift by gap_unit in one of three forms chosen once a
    launch: a shift for a positive power of two, a multiply-high by a
    32-bit reciprocal for another positive divisor, the exact floor for a
    negative one. Each equals // over drifts 0 to 2^31 - 1."""
    mode, magic, shift = chain.gap_divider(d)
    assert mode == (2 if d < 0 else 0 if d & (d - 1) == 0 else 1)
    assert 0 <= magic < 2**32 and 0 <= shift <= 31
    x = _drifts(d)
    got = _div_model(x, d)
    if mode == 1:  # the kernel's operands: 2x and magic as uint32, the high word of their product
        assert int(x.max()) << 1 < 2**32
        for v in x[:: max(1, len(x) // 2000)].tolist():
            assert _div_model(v, d) == ((2 * v * magic) >> 32) >> shift
    np.testing.assert_array_equal(got, x // d)
    for v in (0, 1, d - 1, d, d + 1, 2**31 - 2, 2**31 - 1):
        if 0 <= v < 2**31:
            assert _div_model(v, d) == v // d


def _kernel_keys(r, q, v):
    """C1's compaction of one row: the live anchors (valid and r < 2^30) as
    unsigned keys ((r + 2^31) << 32) | (q + 2^31), sorted, decoded."""
    live = v & (r < 2**30)
    key = ((r[live].astype(np.int64) + 2**31).astype(np.uint64) << np.uint64(32)) | (
        (q[live].astype(np.int64) + 2**31).astype(np.uint64))
    key = np.sort(key)
    return ((key >> np.uint64(32)).astype(np.int64) - 2**31,
            (key & np.uint64(0xFFFFFFFF)).astype(np.int64) - 2**31)


@pytest.mark.parametrize("seed", range(12))
def test_chain_compaction_matches_sort_anchors(seed):
    """The live anchors C1 keeps, in the order of its unsigned keys, are
    sort_anchors' row up to its first dead anchor: negative, big (valid at
    or above 2^30) and duplicate anchors, rows with none."""
    rng = np.random.default_rng(200 + seed)
    B, A = int(rng.integers(1, 7)), int(rng.integers(1, 150))
    r, q, v = _rows(seed, B, A, dup=0.3, neg=seed % 2 == 1, big=seed % 3 != 0)
    if seed % 4 == 3:  # coordinates at the ends of int32
        q[:, ::5] = -(2**31)
        q[:, 1::5] = 2**31 - 1
        r[:, 2::7] = -(2**31)
    rs, qs = (x.numpy() for x in chain.sort_anchors(*(torch.from_numpy(x) for x in (r, q, v))))
    for b in range(B):
        kr, kq = _kernel_keys(r[b], q[b], v[b])
        n = int((rs[b] < 2**30).sum())
        assert len(kr) == n
        np.testing.assert_array_equal(kr, rs[b, :n])
        np.testing.assert_array_equal(kq, qs[b, :n])
        assert (rs[b, n:] >= 2**30).all()
