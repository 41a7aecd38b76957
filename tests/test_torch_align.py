"""bitnuc_tpu_torch.ops.align against bitnuc_tpu.ops.align on random ragged
pairs with planted substitutions and indels, lengths 0 on either side, and
weights (1, 1) and (3, 2): the wavefront operands, the unbanded distances,
the banded span fit (the mapper's effective band, a narrow band widened by
_band_k8, and a band wider than the window), the tracebacks with their ops
and CIGARs, and Smith-Waterman. The plain versions of K8 and K9 are also
held against the JAX package's Pallas kernels in interpret mode. Every
output is an integer or a string: equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import align as jalign
from bitnuc_tpu.ops.pallas import wavefront as jwavefront
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch import config, kernels
from bitnuc_tpu_torch.kernels import _build
from bitnuc_tpu_torch.ops import align
from bitnuc_tpu_torch.utils import bitops
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)

WEIGHTS = [(1, 1), (3, 2)]


def _mutate(rng, s: bytearray, n: int) -> bytearray:
    acgt = b"ACGT"
    for _ in range(n):
        p = int(rng.integers(0, max(len(s), 1)))
        op = int(rng.integers(0, 3))
        if op == 0 and s:
            s[p] = acgt[int(rng.integers(0, 4))]
        elif op == 1 and s:
            del s[p]
        else:
            s.insert(p, acgt[int(rng.integers(0, 4))])
    return s


def _pair_seqs(seed, n=24, max_a=90, lead=40, tail=30):
    """a random; b = random lead + mutated a + random tail; the first rows
    have an empty side."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rand(m):
        return bytes(acgt[rng.integers(0, 4, m)])

    seqs_a, seqs_b = [], []
    for r in range(n):
        a = rand(int(rng.integers(1, max_a)))
        b = rand(int(rng.integers(0, lead))) + bytes(_mutate(rng, bytearray(a), int(
            rng.integers(0, 5)))) + rand(int(rng.integers(0, tail)))
        if r == 0:
            a = b""
        if r == 1:
            b = b""
        if r == 2:
            a = b = b""
        seqs_a.append(a)
        seqs_b.append(b)
    return seqs_a, seqs_b


def _packed(seqs, width):
    jr = JPackedReads.from_ascii(seqs, max_len=width)
    w, n = np.asarray(jr.words), np.asarray(jr.lengths)
    return jr, (words_from_u32_np(w), torch.from_numpy(n.copy()))


@pytest.fixture(scope="module")
def pairs():
    a, b = _pair_seqs(21)
    ja, ta = _packed(a, 96)
    jb, tb = _packed(b, 160)
    return ja, ta, jb, tb


def _eq(got, want, what=""):
    want = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.shape == want.shape, what
    np.testing.assert_array_equal(g, want, err_msg=what)


def _all_eq(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {i}")


def test_operands_match_jax(pairs):
    ja, (wa, la), jb, (wb, lb) = pairs
    ca, jca = align._codes(wa, la, 4), jalign._codes(ja.words, ja.lengths, np.int32(4))
    cb, jcb = align._codes(wb, lb, 5), jalign._codes(jb.words, jb.lengths, np.int32(5))
    _eq(ca, jca)
    _eq(cb, jcb)
    _eq(align._rev_padded(ca, 161), jalign._rev_padded(jca, 161))
    _eq(align._b_shifted(cb), jalign._b_shifted(jcb))
    _eq(align._shift1(ca, 2**30), jalign._shift1(jca, 2**30))


@pytest.mark.parametrize("mm,gap", WEIGHTS)
def test_unbanded_distances_match_jax(pairs, mm, gap):
    ja, (wa, la), jb, (wb, lb) = pairs
    _eq(align.global_distance(wa, la, wb, lb, mm, gap),
        jalign.global_distance(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap))
    late = np.arange(wa.shape[0]) % 3 == 0
    _all_eq(align.fit_distance(wa, la, wb, lb, mm, gap, tie_late=torch.from_numpy(late)),
            jalign.fit_distance(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap,
                                tie_late=jnp.asarray(late)))
    _all_eq(align.fit_distance_span(wa, la, wb, lb, mm, gap),
            jalign.fit_distance_span(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap))
    if (mm, gap) == (1, 1):
        _eq(align.edit_distance(wa, la, wb, lb),
            jalign.edit_distance(ja.words, ja.lengths, jb.words, jb.lengths))


def test_band_geometry_and_shift_match_jax():
    for lo, hi, N in ((-32, 124, 240), (-8, 52, 160), (0, 0, 10), (-300, 10, 50)):
        K, base = align._band_geometry(lo, hi, N)
        jK, jbase = jalign._band_geometry(lo, hi, N)
        assert K == jK
        assert [base(d) for d in range(-2, 500)] == [int(jbase(d)) for d in range(-2, 500)]
    x = np.arange(30, dtype=np.int32).reshape(3, 10)
    for delta in (0, 1, 2):
        for lag in (0, 1):
            _eq(align._band_shift(torch.from_numpy(x), delta, lag, 10, -7),
                jalign._band_shift(jnp.asarray(x), delta, lag, 10, -7))
    with pytest.raises(ValueError):
        align._band_geometry(3, 10, 50)


@pytest.mark.parametrize("mm,gap", WEIGHTS)
@pytest.mark.parametrize("band", [(-32, 124), (-8, 52), (-200, 200), (-33, 125), (0, 60),
                                  (-16, 300)])
def test_banded_fit_matches_jax(pairs, band, mm, gap):
    """The mapper's effective band (K = 80), (-8, 40) widened by _band_k8
    (K = 32), a band wider than the window (the unbanded fit runs), an odd
    off_lo, off_lo = 0 (no diagonal has base 0), and K = N = 160 (top = 1:
    the band slides on two diagonals only)."""
    ja, (wa, la), jb, (wb, lb) = pairs
    lo, hi = band
    want = jalign.fit_distance_span_banded(ja.words, ja.lengths, jb.words, jb.lengths,
                                           mm, gap, off_lo=lo, off_hi=hi)
    _all_eq(align.fit_distance_span_banded(wa, la, wb, lb, mm, gap, lo, hi), want)
    if align._band_geometry(lo, hi, 160)[0] < 161:
        _all_eq(align.fit_distance_span_banded_torch(wa, la, wb, lb, mm, gap, lo, hi), want)


def _tie_seqs(seed, n=24, max_a=90, max_b=160):
    """Low-entropy pairs with many tied paths: both sides repeat one period
    of 1 to 3 bases with random phases and lengths (some empty)."""
    rng = np.random.default_rng(seed)
    seqs_a, seqs_b = [], []
    for _ in range(n):
        unit = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.permutation(4)[: rng.integers(1, 4)]])
        rep = unit * (max_b // len(unit) + 2)
        pa, pb = rng.integers(0, len(unit), 2)
        seqs_a.append(rep[pa : pa + int(rng.integers(0, max_a + 1))])
        seqs_b.append(rep[pb : pb + int(rng.integers(0, max_b + 1))])
    return seqs_a, seqs_b


@pytest.mark.parametrize("mm,gap", WEIGHTS)
def test_banded_fit_ties_match_jax(mm, gap):
    """Tie-heavy rows at the mapper's effective band: the earliest end and
    smallest start among many equal costs."""
    a, b = _tie_seqs(51)
    ja, (wa, la) = _packed(a, 96)
    jb, (wb, lb) = _packed(b, 160)
    want = jalign.fit_distance_span_banded(ja.words, ja.lengths, jb.words, jb.lengths,
                                           mm, gap, off_lo=-32, off_hi=124)
    _all_eq(align.fit_distance_span_banded_torch(wa, la, wb, lb, mm, gap, -32, 124), want)


@pytest.mark.parametrize("mm,gap", WEIGHTS)
@pytest.mark.parametrize("requested", [(-16, 96), (-8, 40)])
def test_plain_k8_matches_pallas_interpret(mm, gap, requested):
    """K8's plain version against fit_distance_span_banded_pallas (the TPU
    kernel, interpret mode) at the band _band_k8 widens it to."""
    a, b = _pair_seqs(31, n=24, max_a=60, lead=30, tail=20)
    ja, (wa, la) = _packed(a, 64)
    jb, (wb, lb) = _packed(b, 128)
    lo, hi = requested
    _, hi_eff = jwavefront._band_k8(lo, hi)
    want = jwavefront.fit_distance_span_banded_pallas(
        ja.words, ja.lengths, jb.words, jb.lengths, mm, gap, off_lo=lo, off_hi=hi,
        interpret=True)
    _all_eq(align.fit_distance_span_banded_torch(wa, la, wb, lb, mm, gap, lo, hi_eff), want)


@pytest.mark.parametrize("params", [(2, -3, -5, -2), (1, -1, -2, -1)])
def test_sw_score_matches_jax_and_pallas(pairs, params):
    ja, (wa, la), jb, (wb, lb) = pairs
    want = jalign.sw_score(ja.words, ja.lengths, jb.words, jb.lengths, *params)
    _all_eq(align.sw_score(wa, la, wb, lb, *params), want)
    _all_eq(align.sw_score_torch(wa, la, wb, lb, *params), want)
    a, b = _pair_seqs(41, n=20, max_a=50, lead=20, tail=20)
    ja2, (wa2, la2) = _packed(a, 64)
    jb2, (wb2, lb2) = _packed(b, 96)
    _all_eq(align.sw_score_torch(wa2, la2, wb2, lb2, *params),
            jwavefront.sw_score_pallas(ja2.words, ja2.lengths, jb2.words, jb2.lengths,
                                       *params, interpret=True))


@pytest.mark.parametrize("mm,gap", [(-1, 1), (2**29, 3), (5, -2), (3, 2**29)])
def test_banded_fit_any_int32_costs_matches_jax(pairs, mm, gap):
    """Negative costs and costs whose sums pass 2^31 wrap in int32 on both
    sides; the boundary products d * gap wrap too (the last case)."""
    ja, (wa, la), jb, (wb, lb) = pairs
    want = jalign.fit_distance_span_banded(ja.words, ja.lengths, jb.words, jb.lengths,
                                           mm, gap, off_lo=-32, off_hi=124)
    _all_eq(align.fit_distance_span_banded_torch(wa, la, wb, lb, mm, gap, -32, 124), want)


@pytest.mark.parametrize("params", [(2**28, -3, -5, -2), (2, -3, -2**29, -2**29)])
def test_sw_score_any_int32_scores_matches_jax(pairs, params):
    ja, (wa, la), jb, (wb, lb) = pairs
    want = jalign.sw_score(ja.words, ja.lengths, jb.words, jb.lengths, *params)
    _all_eq(align.sw_score_torch(wa, la, wb, lb, *params), want)


def _sw_oracle(codes_a, lens_a, codes_b, lens_b, match, mismatch, gap_open, gap_extend):
    """Full-matrix Gotoh in numpy, row by row and column by column over the
    batch, int32 sums wrapping: (score, end_i, end_j) of the lexicographic
    best cell (largest h, smallest i + j, smallest j) among cells with h > 0
    and 1 <= i <= m, 1 <= j <= min(n, N), i + j <= M + N; (0, 0, 0) when
    there is none. Codes at and past min(length, width) are sentinels."""
    B, M = codes_a.shape
    N = codes_b.shape[1]
    big = np.int32(-(2**30))
    match, mismatch, go, ge = (np.int32(x) for x in (match, mismatch, gap_open, gap_extend))
    cols = np.arange(N)
    b = np.where(cols < np.minimum(lens_b, N)[:, None], codes_b, 5)
    h_prev = np.zeros((B, N + 1), np.int32)  # row 0
    f_prev = np.full((B, N + 1), big, np.int32)
    best = np.zeros(B, np.int32)
    bd = np.zeros(B, np.int64)
    bj = np.zeros(B, np.int64)
    for i in range(1, min(int(lens_a.max(initial=0)), M + N - 1) + 1):
        a = codes_a[:, i - 1] if i <= M else np.full(B, 4)
        a = np.where(i <= lens_a, a, 4)
        h = np.zeros((B, N + 1), np.int32)  # column 0: H = 0, no gap state
        f = np.full((B, N + 1), big, np.int32)
        e = np.full(B, big, np.int32)
        for j in range(1, N + 1):
            s = np.where(a == b[:, j - 1], match, mismatch)
            e = np.maximum(h[:, j - 1] + go, e + ge)
            f[:, j] = np.maximum(h_prev[:, j] + go, f_prev[:, j] + ge)
            h[:, j] = np.maximum(np.maximum(h_prev[:, j - 1] + s, 0), np.maximum(e, f[:, j]))
            hj = h[:, j]
            live = (i <= lens_a) & (j <= lens_b) & (i + j <= M + N) & (hj > 0)
            better = (hj > best) | ((hj == best) & ((i + j < bd) | ((i + j == bd) & (j < bj))))
            up = live & better
            best = np.where(up, hj, best)
            bd = np.where(up, i + j, bd)
            bj = np.where(up, j, bj)
        h_prev, f_prev = h, f
    return best, (bd - bj).astype(np.int32), bj.astype(np.int32)


def _codes_of(seqs, width):
    lut = np.zeros(256, np.int32)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    out = np.zeros((len(seqs), width), np.int32)
    for r, s in enumerate(seqs):
        s = np.frombuffer(s[:width], np.uint8)
        out[r, : len(s)] = lut[s]
    return out


def _tie_seqs(seed, n=24, max_a=32, max_b=64):
    """Low-entropy pairs where many cells share the best score: runs of
    one base, period-2 and period-3 repeats, a repeat inside a run."""
    rng = np.random.default_rng(seed)
    units = [b"A", b"C", b"AC", b"CA", b"ACG", b"GTT", b"AAC"]
    seqs_a, seqs_b = [], []
    for _ in range(n):
        ua, ub = (units[int(rng.integers(0, len(units)))] for _ in range(2))
        a = (ua * max_a)[: int(rng.integers(0, max_a + 1))]
        b = (ub * max_b)[: int(rng.integers(0, max_b + 1))]
        if rng.random() < 0.3:
            k = int(rng.integers(0, len(b) + 1))
            b = b[:k] + a[: int(rng.integers(0, len(a) + 1))] + b[k:]
        seqs_a.append(a)
        seqs_b.append(b[:max_b])
    return seqs_a, seqs_b


@pytest.mark.parametrize("params", [(2, -3, -5, -2), (1, -1, -2, -1), (2**28, -3, -5, -2),
                                    (2, -3, -2**29, -2**29), (3, 1, 2, 1)])
@pytest.mark.parametrize("kind", ["planted", "ties", "past"])
def test_sw_score_tie_rule_matches_full_matrix_oracle(kind, params):
    """The tie rule the row-pipelined K9 relies on: the diagonal-by-diagonal
    sweep (first strictly greater diagonal maximum, smallest j within it)
    equals the lexicographic best (largest h, smallest i + j, smallest j)
    of a row-by-row full matrix, in the port's plain version and in JAX.
    "past" gives lengths past both widths, where only cells with
    i + j <= M + N count; positive mismatch and gap scores (the last
    params) make cells past either length outscore those in range."""
    if kind == "ties":
        seqs_a, seqs_b = _tie_seqs(51)
    else:
        seqs_a, seqs_b = _pair_seqs(52, n=20, max_a=28, lead=16, tail=10)
    ja, (wa, la) = _packed(seqs_a, 32)
    jb, (wb, lb) = _packed(seqs_b, 64)
    M, N = 16 * wa.shape[1], 16 * wb.shape[1]
    if kind == "past":
        rng = np.random.default_rng(53)
        la = torch.from_numpy(rng.integers(M, M + N + 9, len(seqs_a)).astype(np.int32))
        lb = torch.from_numpy(rng.integers(N // 2, N + 9, len(seqs_b)).astype(np.int32))
    want = _sw_oracle(_codes_of(seqs_a, M), la.numpy(), _codes_of(seqs_b, N), lb.numpy(),
                      *params)
    _all_eq(align.sw_score_torch(wa, la, wb, lb, *params), want)
    _all_eq(jalign.sw_score(ja.words, jnp.asarray(la.numpy()), jb.words,
                            jnp.asarray(lb.numpy()), *params), want)


@pytest.mark.parametrize("lanes,Wa,Wb,wide", [
    (80, 10, 15, False),     # the mapper's K8 band
    (1024, 10, 63, False),   # the widest row the registers hold
    (1025, 10, 64, True),
    (80, 14000, 600, True),  # codes beyond shared memory
])
def test_wide_scratch_picks_the_kernel(lanes, Wa, Wb, wide):
    """Rows past 32 x 32 cells, or codes past shared memory, get the wide
    kernels' per-warp rings; every other launch the register kernels."""
    scratch, nwarps = align._wide_scratch(50, lanes, 7, Wa, Wb, torch.device("cpu"))
    if wide:
        assert nwarps == 50 and scratch.numel() == 50 * 7 * lanes
    else:
        assert (scratch, nwarps) == (None, 0)


@pytest.mark.parametrize("mm,gap", WEIGHTS)
@pytest.mark.parametrize("ends_free_b", [False, True])
def test_align_ops_and_cigars_match_jax(pairs, ends_free_b, mm, gap):
    ja, (wa, la), jb, (wb, lb) = pairs
    want = jalign.align_ops(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap,
                            ends_free_b=ends_free_b)
    got = align.align_ops(wa, la, wb, lb, mm, gap, ends_free_b=ends_free_b)
    _all_eq(got, want)
    ops = np.asarray(want[2])
    for eqx in (True, False):
        assert align.cigars(got[2], eqx) == jalign.cigars(ops, eqx)
        assert [align.cigar_string(r, eqx) for r in ops] == jalign.cigars(ops, eqx)


@pytest.mark.parametrize("band", [None, (-64, 64), (-10, 30)])
def test_align_ops_codes_match_jax(pairs, band):
    """Code inputs with garbage past each length (re-padded), full plane
    and banded, global and fitting."""
    _, (_, la), _, (_, lb) = pairs
    rng = np.random.default_rng(7)
    ca = rng.integers(0, 4, (la.shape[0], 96)).astype(np.int32)
    cb = rng.integers(0, 4, (la.shape[0], 130)).astype(np.int32)
    cb[:, 10:60] = ca[:, :50]
    lbn = np.minimum(lb.numpy(), 130)
    for efb in (False, True):
        if band is None:
            want = jalign.align_ops_codes(jnp.asarray(ca), jnp.asarray(la.numpy()),
                                          jnp.asarray(cb), jnp.asarray(lbn), 1, 1, efb)
            got = align.align_ops_codes(torch.from_numpy(ca), la, torch.from_numpy(cb),
                                        torch.from_numpy(lbn), 1, 1, efb)
        else:
            want = jalign.align_ops_codes_banded(jnp.asarray(ca), jnp.asarray(la.numpy()),
                                                 jnp.asarray(cb), jnp.asarray(lbn), 1, 1, efb,
                                                 *band)
            got = align.align_ops_codes_banded(torch.from_numpy(ca), la, torch.from_numpy(cb),
                                               torch.from_numpy(lbn), 1, 1, efb, *band)
        _all_eq(got, want)
        assert align.cigars(got[2]) == jalign.cigars(np.asarray(want[2]))


def test_cigars_edge_rows():
    ops = np.zeros((4, 7), np.uint8)
    ops[1, :3] = [1, 1, 2]
    ops[2] = [3, 3, 4, 1, 2, 2, 1]
    ops[3, :5] = [1, 0, 2, 2, 2]  # a stop ends the row
    want = [jalign.cigar_string(r) for r in ops]
    assert align.cigars(ops) == want == ["", "2=1X", "2I1D1=2X1=", "1="]
    assert align.cigars(ops, eqx=False) == [jalign.cigar_string(r, False) for r in ops]
    assert align.cigars(np.zeros((0, 5), np.uint8)) == []
    assert (align.OP_STOP, align.OP_EQ, align.OP_X, align.OP_INS, align.OP_DEL) == (
        jalign.OP_STOP, jalign.OP_EQ, jalign.OP_X, jalign.OP_INS, jalign.OP_DEL)


# -- C2: the traceback kernel's cell set, plane layout and walk ---------------


def _wrap32(x):
    """int64 values wrapped to int32, as int32 sums and products wrap."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


_POISON = 0xFF  # a plane byte C2 never writes: no mask has bits 4-7


def _c2_model(ca, la, cb, lb, mismatch=1, gap=1, ends_free_b=False, tie_late=None,
              band=None):
    """numpy model of C2 (csrc/traceback.cu), a pair at a time as a block
    runs it. Unbanded: only the cells of the rectangle [0, m] x [0, n],
    their masks at plane[i (N + 1) + j]; banded: every lane of diagonals
    1 .. m + n, at plane[(d - 1) K + lane] with the plain version's clamped
    walk index. Every other plane byte (and every ring lane the kernel does
    not write) is poisoned, and reading one fails. Returns (cost, end_j,
    ops [B, M + N] uint8, left [B] bool: the walk read a clamped lane)."""
    ca, cb = np.asarray(ca, np.int64), np.asarray(cb, np.int64)
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    B, M = ca.shape
    N = cb.shape[1]
    T = M + N
    big, gone = 2**30, 2**40  # gone: a ring lane the kernel never wrote
    mm, gp = int(mismatch), int(gap)
    late = np.zeros(B, bool) if tie_late is None else np.asarray(tie_late, bool)
    K = 0
    if band is not None:
        K, base = align._band_geometry(*band, N)
        if K >= N + 1:
            K, late = 0, np.zeros(B, bool)
    cost, endj = np.zeros(B, np.int32), np.zeros(B, np.int32)
    ops = np.zeros((B, T), np.uint8)
    left = np.zeros(B, bool)
    for r in range(B):
        m, n = int(la[r]), int(lb[r])
        assert 0 <= m <= M and 0 <= n <= N

        def code(row, x, length, pad):
            ok = (x >= 0) & (x < length)  # length <= len(row)
            return np.where(ok, row[np.where(ok, x, 0)] if length else pad, pad)

        c = (0 if m == 0 else big) if ends_free_b else (0 if m + n == 0 else big)
        e = 0 if ends_free_b else n
        if K:
            plane = np.full(T * K, _POISON, np.int64)
            t = np.arange(K)
            prev, prev2 = np.where(t == 0, 0, big), np.full(K, big)
            b1 = b2 = 0

            def at(x, k):
                return np.where((k >= 0) & (k < K), x[np.clip(k, 0, K - 1)], big)
        else:
            plane = np.full((M + 1) * (N + 1), _POISON, np.int64)
            prev, prev2 = np.full(N + 1, gone), np.full(N + 1, gone)
            prev[0] = 0
        for d in range(1, m + n + 1):
            if K:
                bd = base(d)
                d1, d2 = bd - b1, bd - b2
                j = bd + t
                up, lf, dg = at(prev, t + d1), at(prev, t + d1 - 1), at(prev2, t + d2 - 1)
            else:
                j = np.arange(max(0, d - m), min(n, d) + 1)
                jm1 = np.maximum(j - 1, 0)
                up, lf, dg = prev[j], prev[jm1], prev2[jm1]
            i = d - j
            eq = code(ca[r], i - 1, m, 4) == code(cb[r], j - 1, n, 5)
            c_diag = _wrap32(dg + np.where(eq, 0, mm))
            c_up, c_left = _wrap32(up + gp), _wrap32(lf + gp)
            D = np.minimum(np.minimum(c_diag, c_up), c_left)
            mask = ((D == c_diag) * 1 + (D == c_up) * 2 + (D == c_left) * 4 + eq * 8)
            if not K:  # interior cells read only cells the kernel wrote
                inner = (i > 0) & (j > 0)
                assert not (np.isin(gone, up[inner]) or np.isin(gone, lf[inner])
                            or np.isin(gone, dg[inner]))
            D = np.where(j == 0, _wrap32(d * gp), D)
            mask = np.where(j == 0, 2, mask)
            D = np.where(j == d, 0 if ends_free_b else _wrap32(d * gp), D)
            mask = np.where(j == d, 0 if ends_free_b else 4, mask)
            if K:
                D = np.where(j > d, big, D)
                plane[(d - 1) * K : d * K] = mask
                nxt = D
            else:
                plane[i * (N + 1) + j] = mask
                nxt = np.full(N + 1, gone)
                nxt[j] = D
            hit = (i == m) & (j <= n)
            if ends_free_b and hit.any():
                v = int(D[hit][0])
                if v < c or (late[r] and v == c and v < big):
                    c, e = min(c, v), int(j[hit][0])
            elif not ends_free_b and d == m + n and (j == n).any():
                c = min(c, int(D[j == n][0]))
            prev2, prev = prev, nxt
            if K:
                b2, b1 = b1, bd
        ii, jj, prev_op, steps = m, e, 0, []
        for _ in range(T):
            if not (ii > 0 if ends_free_b else (ii > 0 or jj > 0)):
                break
            if K:
                dd = ii + jj
                lane = min(max(jj - base(dd), 0), K - 1)
                left[r] |= lane != jj - base(dd)
                idx = min(max((dd - 1) * K + lane, 0), T * K - 1)
            else:
                idx = ii * (N + 1) + jj
            mask = int(plane[idx])
            assert mask != _POISON, (r, ii, jj)
            if prev_op == align.OP_INS and mask & 2:
                op = align.OP_INS
            elif prev_op == align.OP_DEL and mask & 4:
                op = align.OP_DEL
            elif mask & 1:
                op = align.OP_EQ if mask & 8 else align.OP_X
            else:
                op = align.OP_INS if mask & 2 else align.OP_DEL
            steps.append(op)
            ii -= op != align.OP_DEL
            jj -= op != align.OP_INS
            prev_op = op
        ops[r, : len(steps)] = steps[::-1]
        cost[r], endj[r] = _wrap32(c), e
    return cost, endj, ops, left


def _tb_codes(seed, B, M, N, kind):
    """B (read, window) code pairs [B, M], [B, N] int32 with garbage past
    each length (codes 0-7, re-padded by every form): "planted" (a in b
    with a few substitutions and indels), "drift" (a in b with 6-12 bases
    deleted from a's middle and 6-12 inserted: net indel drift past a
    narrow band), "polyA" (runs of one base on both sides), "repeat"
    (period-2 and period-3 repeats, phase-shifted). Lengths random in
    [0, M] and [0, N], with m = 0, n = 0 and both 0 in the first rows."""
    rng = np.random.default_rng(seed)
    ca = rng.integers(0, 8, (B, M))
    cb = rng.integers(0, 8, (B, N))
    la = rng.integers(0, M + 1, B)
    lb = rng.integers(0, N + 1, B)
    for r in range(B):
        m, n = int(la[r]), int(lb[r])
        if kind == "polyA":
            ca[r, :m] = rng.integers(0, 4) if r % 3 else 0
            cb[r, :n] = ca[r, 0] if r % 4 else rng.integers(0, 4)
            continue
        if kind == "repeat":
            p = int(rng.integers(2, 4))
            ca[r, :m] = np.arange(m) % p
            cb[r, :n] = (np.arange(n) + rng.integers(0, 3)) % p
            continue
        a = rng.integers(0, 4, m)
        ca[r, :m] = a
        s = list(a)
        if kind == "drift" and m > 30:
            k = int(rng.integers(6, 13))
            mid = m // 2
            s = s[: mid - k] + s[mid:] if r % 2 else s[:mid] + list(rng.integers(0, 4, k)) + s[mid:]
        else:
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, max(len(s), 1)))
                op = int(rng.integers(0, 3))
                if op == 0 and s:
                    s[p] = int(rng.integers(0, 4))
                elif op == 1 and s:
                    del s[p]
                else:
                    s.insert(p, int(rng.integers(0, 4)))
        lead = int(rng.integers(0, max(1, N - len(s)) + 1)) if kind == "planted" else 0
        body = rng.integers(0, 4, N)
        body[lead : lead + len(s)] = s[: max(0, N - lead)]
        cb[r] = np.where(np.arange(N) < n, body, cb[r])
    la[:3], lb[:3] = [0, M, 0], [N, 0, 0]
    return (ca.astype(np.int32), la.astype(np.int32), cb.astype(np.int32),
            lb.astype(np.int32))


def _jax_tb(ca, la, cb, lb, mm, gap, efb, late=None, band=None):
    args = (jnp.asarray(ca), jnp.asarray(la), jnp.asarray(cb), jnp.asarray(lb), mm, gap)
    if band is None:
        return jalign.align_ops_codes(*args, ends_free_b=efb,
                                      tie_late=None if late is None else jnp.asarray(late))
    return jalign.align_ops_codes_banded(*args, efb, *band)


def _torch_tb(ca, la, cb, lb, mm, gap, efb, late=None, band=None):
    args = tuple(torch.from_numpy(x) for x in (ca, la, cb, lb)) + (mm, gap)
    if band is None:
        return align.align_ops_codes_torch(*args, efb,
                                           None if late is None else torch.from_numpy(late))
    return align.align_ops_codes_banded_torch(*args, efb, *band)


def _tb_all_eq(inputs, mm, gap, efb, late=None, band=None):
    """The plain version and the model of C2 against JAX, bit for bit;
    returns the model's left-the-band flags."""
    want = _jax_tb(*inputs, mm, gap, efb, late, band)
    _all_eq(_torch_tb(*inputs, mm, gap, efb, late, band), want)
    *model, left = _c2_model(*inputs, mm, gap, efb, late, band)
    _all_eq(model, want)
    return left


@pytest.mark.parametrize("kind", ["planted", "polyA", "repeat"])
@pytest.mark.parametrize("mm,gap", WEIGHTS)
def test_c2_tie_late_fits_match_jax(kind, mm, gap):
    """ends_free_b with tie_late on every other row: the latest of equal fits
    ends the walk; tie-heavy rows give many equal fits."""
    inputs = _tb_codes(11, 16, 40, 70, kind)
    late = np.arange(16) % 2 == 1
    _tb_all_eq(inputs, mm, gap, True, late)
    _tb_all_eq(inputs, mm, gap, False)


@pytest.mark.parametrize("efb", [False, True])
@pytest.mark.parametrize("band", [(-4, 4), (-2, 6), (-9, 3)])
def test_c2_banded_walk_out_of_the_band_matches_jax(band, efb):
    """Planted indel drift past a narrow band: no optimal path stays in the
    band, so the walk reads clamped lanes, cells with i < 0 or past the
    lengths among them, exactly as the plain version reads them."""
    inputs = _tb_codes(12, 20, 60, 72, "drift")
    left = _tb_all_eq(inputs, 1, 1, efb, band=band)
    assert left.any()


@pytest.mark.parametrize("kind", ["planted", "polyA", "repeat"])
@pytest.mark.parametrize("band", [None, (-8, 8), (-30, 5), (-200, 200)])
def test_c2_tie_heavy_rows_match_jax(kind, band):
    """poly-A and short repeats, where most cells tie: the op-continuation
    policy decides every step (the last band is wider than the window: the
    unbanded form)."""
    inputs = _tb_codes(13, 18, 36, 50, kind)
    for efb in (False, True):
        _tb_all_eq(inputs, 1, 1, efb, band=band)
        _tb_all_eq(inputs, 3, 2, efb, band=band)


@pytest.mark.parametrize("band", [None, (-6, 6)])
@pytest.mark.parametrize("M,N", [(0, 9), (9, 0), (0, 0), (17, 33)])
def test_c2_empty_sides_match_jax(M, N, band):
    """Widths of 0 on either side, m = 0 and n = 0 rows, and an empty
    batch."""
    inputs = _tb_codes(14, 9, M, N, "planted")
    for efb in (False, True):
        if band is None or N > 0:
            _tb_all_eq(inputs, 1, 1, efb, band=band)
        _tb_all_eq(tuple(x[:0] for x in inputs), 1, 1, efb, band=band)


@pytest.mark.parametrize("mm,gap", [(-1, 1), (2**29, 3), (5, -2), (3, 2**29),
                                    (-2**31, 2**31 - 1), (2**31 - 1, -2**31)])
@pytest.mark.parametrize("band", [None, (-8, 8)])
def test_c2_any_int32_costs_match_jax(mm, gap, band):
    """Negative costs and sums past 2^31 wrap in int32 on every side; the
    boundary products d * gap wrap too."""
    inputs = _tb_codes(15, 14, 30, 44, "planted")
    late = np.arange(14) % 3 == 0
    for efb in (False, True):
        _tb_all_eq(inputs, mm, gap, efb, late if band is None else None, band)


def test_c2_model_on_the_mapping_pairs(pairs):
    """The model of C2 on test_align_ops_codes_match_jax's pairs (garbage
    past each length), both forms and modes, against JAX."""
    _, (_, la), _, (_, lb) = pairs
    rng = np.random.default_rng(7)
    ca = rng.integers(0, 4, (la.shape[0], 96)).astype(np.int32)
    cb = rng.integers(0, 4, (la.shape[0], 130)).astype(np.int32)
    cb[:, 10:60] = ca[:, :50]
    inputs = (ca, la.numpy(), cb, np.minimum(lb.numpy(), 130).astype(np.int32))
    for band in (None, (-64, 64), (-10, 30)):
        for efb in (False, True):
            _tb_all_eq(inputs, 1, 1, efb, band=band)


def test_c2_routes_cpu_tensors_to_the_plain_version():
    """A CPU tensor takes the plain version (no launch); backend('kernel')
    on one raises; the counter exists."""
    assert "traceback" in kernels.LAUNCHES
    ca, la, cb, lb = (torch.from_numpy(x) for x in _tb_codes(16, 6, 20, 30, "planted"))
    wa, wb = (bitops.pack_codes(torch.nn.functional.pad(c & 3, (0, -c.shape[1] % 16)))
              for c in (ca, cb))
    before = kernels.LAUNCHES["traceback"]
    _all_eq(align.align_ops_codes(ca, la, cb, lb, 1, 1, True),
            align.align_ops_codes_torch(ca, la, cb, lb, 1, 1, True))
    _all_eq(align.align_ops_codes_banded(ca, la, cb, lb, 1, 1, False, -6, 6),
            align.align_ops_codes_banded_torch(ca, la, cb, lb, 1, 1, False, -6, 6))
    align.align_ops(wa, la, wb, lb)
    assert kernels.LAUNCHES["traceback"] == before
    with config.backend("kernel"):
        for call in (lambda: align.align_ops_codes(ca, la, cb, lb),
                     lambda: align.align_ops_codes_banded(ca, la, cb, lb, 1, 1, False, -6, 6),
                     lambda: align.align_ops(wa, la, wb, lb)):
            with pytest.raises(ValueError, match="CUDA"):
                call()


@pytest.mark.parametrize("B,M,N,K,want", [
    (262_144, 160, 224, 0, (1, 1, 0, 262_144)),  # phase 7's chunk: all in shared memory
    (5, 320, 320, 0, (1, 0, 103_056, 5)),        # the plane past 96 KB
    (100, 2048, 2600, 1252, (1, 0, 5_819_296, 100)),  # a long read's band
    (3, 20_000, 20_000, 0, (0, 0, 400_280_032, 2)),   # the ring past shared memory
    (0, 10, 10, 0, (1, 1, 0, 1)),
])
def test_c2_layout(B, M, N, K, want):
    """Where C2 keeps a pair's ring and plane, and how many blocks stride
    over the pairs when they live in device scratch."""
    assert align._tb_layout(B, M, N, K) == want


def _c2_walk_tables():
    """The tie-policy tables of C2's warp-form walk (kTabNone, kTabIns,
    kTabDel), read from csrc/traceback.cu."""
    import re

    src = (_build.CSRC / "traceback.cu").read_text()
    return {name: int(v, 16) for name, v in
            re.findall(r"constexpr uint32_t (kTab\w+) = 0x([0-9a-fA-F]+)u;", src)}


def test_c2_walk_tables_are_the_tie_policy():
    """Each table's nibble (mask & 7), with the diag made X where bit 3 is
    clear, is the plain walk's op after an EQ/X, an INS and a DEL."""
    tabs = _c2_walk_tables()
    assert sorted(tabs) == ["kTabDel", "kTabIns", "kTabNone"]
    for prev, name in ((align.OP_EQ, "kTabNone"), (align.OP_X, "kTabNone"),
                       (align.OP_INS, "kTabIns"), (align.OP_DEL, "kTabDel")):
        for mask in range(16):
            if prev == align.OP_INS and mask & 2:
                want = align.OP_INS
            elif prev == align.OP_DEL and mask & 4:
                want = align.OP_DEL
            elif mask & 1:
                want = align.OP_EQ if mask & 8 else align.OP_X
            else:
                want = align.OP_INS if mask & 2 else align.OP_DEL
            op = (tabs[name] >> (4 * (mask & 7))) & 15
            assert op + (op == align.OP_EQ and not mask & 8) == want, (prev, mask)


def _c2_warp_model(ca, la, cb, lb, mismatch=1, gap=1, ends_free_b=False, tie_late=None,
                   C=None):
    """numpy model of C2's warp form (traceback_warp_kernel<C> in
    csrc/traceback.cu), a pair at a time as a warp runs it, the 32 lanes as
    vectors, at the pair's own C (the fewest cells a lane of _TB_WARP_CELLS
    that hold its n + 1 columns, at most the launch's C): lane L holds
    columns L C .. L C + C - 1 and works row s - L at
    step s from the shuffled edge D of lane L - 1 (its previous step's, and
    the one before as the diagonal), with a's code fetched a step ahead;
    lanes whose columns all lie past n only shuffle. The masks go four bits a
    cell into ceil(C / 8) words at plane[i][word][L]; a nibble no step wrote
    is poisoned, and the walk reading one fails. The ends come from the
    lanes' row-m folds and warp reductions; the walk writes ops end first
    into a buffer and the forward copy reverses it, OP_STOP-padded. Returns
    (cost, end_j, ops [B, M + N] uint8)."""
    ca, cb = np.asarray(ca, np.int64), np.asarray(cb, np.int64)
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    B, M = ca.shape
    N = cb.shape[1]
    T = M + N
    CMAX = C or align._tb_warp_cells(M, N)
    assert CMAX and 32 * CMAX >= N + 1
    big, imax = 2**30, 2**31 - 1
    mm, gp = int(mismatch), int(gap)
    late_all = np.zeros(B, bool) if tie_late is None else np.asarray(tie_late, bool)
    lanes = np.arange(32)
    tabs = _c2_walk_tables()
    cost, endj = np.zeros(B, np.int32), np.zeros(B, np.int32)
    ops = np.zeros((B, T), np.uint8)
    for r in range(B):
        m, n, late = int(la[r]), int(lb[r]), bool(late_all[r])
        assert 0 <= m <= M and 0 <= n <= N
        # the pair's cells a lane: the fewest that hold its n + 1 columns
        C = min(CMAX, next(c for c in align._TB_WARP_CELLS if 32 * c >= n + 1))
        W = (C + 7) // 8
        t0 = lanes * C
        cols = t0[:, None] + np.arange(C)[None, :]  # [32, C]
        live = t0 <= n
        plane = np.zeros((M + 1, W, 32), np.int64)
        written = np.zeros((M + 1, 32 * C), bool)
        hp = np.where((cols == 0) | ends_free_b, 0, _wrap32(cols * gp))
        ok_b = (cols >= 1) & (cols <= n)
        cbv = np.where(ok_b, cb[r][np.clip(cols - 1, 0, max(N - 1, 0))] if N else 5, 5)
        m0 = np.where((cols == 0) | ends_free_b, 0, 4)
        for c in range(C):  # row 0, every lane
            plane[0, c // 8] |= m0[:, c] << (4 * (c % 8))
        written[0] = True
        fmin, fj, dmn = np.full(32, imax), np.full(32, -1), np.zeros(32, np.int64)

        def take_row_m(sel):
            nonlocal fmin, fj, dmn
            for c in range(C):
                j, v = cols[:, c], hp[:, c]
                ok = sel & (j <= n)
                upd = ok & ((v < fmin) | (fj < 0))
                tie = ok & ~upd & late & (v == fmin)
                fmin = np.where(upd, v, fmin)
                fj = np.where(upd | tie, j, fj)
                dmn = np.where(sel & (j == n), v, dmn)

        if m == 0:
            take_row_m(live)
        steps = m + n // C if m > 0 else 0
        hlast, hdiag = hp[:, C - 1].copy(), np.zeros(32, np.int64)
        acode = np.full(32, 4)
        if m > 0:
            acode[0] = ca[r][0]
        for s in range(1, steps + 1):
            hl = np.concatenate([hlast[:1], hlast[:-1]])  # __shfl_up_sync by 1
            i = s - lanes
            act = live & (i >= 1) & (i <= m)
            h_left, h_diag = hl.copy(), hdiag.copy()
            wd = np.zeros((32, W), np.int64)
            for c in range(C):
                eq = acode == cbv[:, c]
                c_diag = _wrap32(h_diag + np.where(eq, 0, mm))
                c_up, c_left = _wrap32(hp[:, c] + gp), _wrap32(h_left + gp)
                D = np.minimum(np.minimum(c_diag, c_up), c_left)
                mask = (D == c_diag) * 1 + (D == c_up) * 2 + (D == c_left) * 4 + eq * 8
                if c == 0:  # lane 0's column 0: "up" only
                    D[0], mask[0] = _wrap32(int(i[0]) * gp), 2
                h_diag = hp[:, c].copy()
                hp[:, c] = np.where(act, D, hp[:, c])
                h_left = D
                wd[:, c // 8] |= mask << (4 * (c % 8))
            hlast = np.where(act, h_left, hlast)
            for L in np.flatnonzero(act):
                plane[i[L], :, L] = wd[L]
                written[i[L], t0[L] : t0[L] + C] = True
            take_row_m(act & (i == m))
            x = s - lanes
            acode = np.where(live & (x >= 0) & (x < m), ca[r][np.clip(x, 0, max(M - 1, 0))]
                             if M else 4, 4)
            hdiag = hl
        if ends_free_b:
            init = 0 if m == 0 else big
            mn = int(fmin.min())
            c_r = min(init, mn)
            if late:
                lj = int(np.where((fj >= 0) & (fmin == c_r), fj, -1).max())
                e = max(lj, 0) if c_r < big else 0
            else:
                first = int(np.where((fj >= 0) & (fmin == mn), fj, imax).min())
                e = first if mn < init else 0
        else:
            c_r = 0 if m + n == 0 else min(big, int(dmn[n // C]))
            e = n
        ii, jj, tab, buf = m, e, tabs["kTabNone"], []
        for _ in range(T):
            if not (ii > 0 if ends_free_b else (ii > 0 or jj > 0)):
                break
            L, c = divmod(jj, C)
            assert written[ii, jj], (r, ii, jj)
            mask = int(plane[ii, c // 8, L] >> (4 * (c % 8))) & 15
            op = (tab >> (4 * (mask & 7))) & 15  # the kernel's tie-policy tables
            op += op == align.OP_EQ and not mask & 8
            tab = tabs[{align.OP_INS: "kTabIns", align.OP_DEL: "kTabDel"}.get(op, "kTabNone")]
            buf.append(op)
            ii -= op != align.OP_DEL
            jj -= op != align.OP_INS
        nsteps = len(buf)
        for k in range(0, T, 16):  # the forward copy, 16 bytes a lane
            for kk in range(k, min(k + 16, T)):
                ops[r, kk] = buf[nsteps - 1 - kk] if kk < nsteps else align.OP_STOP
        cost[r], endj[r] = _wrap32(c_r), e
    return cost, endj, ops


def _tb_warp_eq(inputs, mm, gap, efb, late=None):
    """C2's form for these shapes (the warp form's model, else the block
    form's) against JAX, bit for bit; returns the warp form's C (0: the
    block form)."""
    M, N = inputs[0].shape[1], inputs[2].shape[1]
    C = align._tb_warp_cells(M, N)
    want = _jax_tb(*inputs, mm, gap, efb, late)
    if C:
        _all_eq(_c2_warp_model(*inputs, mm, gap, efb, late, C), want)
    else:
        _all_eq(_c2_model(*inputs, mm, gap, efb, late)[:3], want)
    return C


@pytest.mark.parametrize("C", [1, 2, 8, 32])
@pytest.mark.parametrize("edge", [0, 1])
def test_c2_warp_model_at_each_width(C, edge):
    """N + 1 = 32 C fills the lanes of the warp form at C; N + 1 = 32 C + 1
    takes the next C (past 32 x 32, the block form), both modes, tie_late
    on every other row, m = 0, n = 0 and full rows among them."""
    N = 32 * C - 1 + edge
    want_C = next((c for c in align._TB_WARP_CELLS if 32 * c >= N + 1), 0)
    M = 20 if C == 32 else 40
    inputs = _tb_codes(40 + C + edge, 6 if C == 32 else 10, M, N, "planted")
    assert align._tb_warp_cells(M, N) == (want_C if N + 1 <= 1024 else 0)
    late = np.arange(len(inputs[0])) % 2 == 1
    for efb in (False, True):
        got = _tb_warp_eq(inputs, 1, 1, efb, late if efb else None)
        assert got == (C if not edge else (want_C if N + 1 <= 1024 else 0))


@pytest.mark.parametrize("M,N", [(0, 9), (9, 0), (0, 0), (17, 33)])
def test_c2_warp_model_empty_sides(M, N):
    """Widths of 0 on either side and rows with m = 0 or n = 0, both
    modes; an empty batch."""
    inputs = _tb_codes(44, 9, M, N, "planted")
    for efb in (False, True):
        assert _tb_warp_eq(inputs, 1, 1, efb) > 0
        _all_eq(_c2_warp_model(*(x[:0] for x in inputs), 1, 1, efb),
                _jax_tb(*(x[:0] for x in inputs), 1, 1, efb))


@pytest.mark.parametrize("kind", ["planted", "polyA", "repeat"])
def test_c2_warp_model_tie_late(kind):
    """ends_free_b with tie_late on every other row, in tie-heavy rows: the
    lanes' folds and the warp reductions pick the plain version's end."""
    inputs = _tb_codes(45, 14, 36, 70, kind)
    late = np.arange(14) % 2 == 1
    _tb_warp_eq(inputs, 1, 1, True, late)
    _tb_warp_eq(inputs, 3, 2, True, late)
    _tb_warp_eq(inputs, 1, 1, False)


@pytest.mark.parametrize("mm,gap", [(-2**31, 2**31 - 1), (2**29, 3), (-1, 1), (5, -2)])
def test_c2_warp_model_any_int32_costs(mm, gap):
    """Sums past 2^31 wrap in every cell and boundary; row m's folds keep
    the plain version's 2^30 clamps."""
    inputs = _tb_codes(46, 12, 30, 44, "planted")
    late = np.arange(12) % 3 == 0
    for efb in (False, True):
        _tb_warp_eq(inputs, mm, gap, efb, late if efb else None)


def test_c2_warp_model_on_the_mapping_pairs(pairs):
    """The warp form's model on test_c2_model_on_the_mapping_pairs's pairs
    (garbage past each length), both modes, against JAX."""
    _, (_, la), _, (_, lb) = pairs
    rng = np.random.default_rng(7)
    ca = rng.integers(0, 4, (la.shape[0], 96)).astype(np.int32)
    cb = rng.integers(0, 4, (la.shape[0], 130)).astype(np.int32)
    cb[:, 10:60] = ca[:, :50]
    inputs = (ca, la.numpy(), cb, np.minimum(lb.numpy(), 130).astype(np.int32))
    for efb in (False, True):
        assert _tb_warp_eq(inputs, 1, 1, efb) == 5


@pytest.mark.parametrize("M,N,want", [
    (160, 224, 8),     # phase 7's chunk: 20,608 plane bytes a warp
    (150, 1023, 32),   # N + 1 = 1,024: the widest row
    (150, 1024, 0),    # 1,025: the block form
    (1_700, 200, 8),   # 1,701 x 128 + 1,904 bytes: within 227 KB
    (1_800, 200, 0),   # 1,801 x 128 + 2,000: past it
    (440, 1000, 32),   # 441 x 512 + 1,440 bytes at C = 32: within it
    (460, 1000, 0),    # 461 x 512 + 1,472: past it
    (0, 0, 1),
])
def test_c2_warp_dispatch(M, N, want):
    """Which unbanded launches take the warp form, and at which C."""
    assert align._tb_warp_cells(M, N) == want


_GONE = 2**40  # a ring lane C3 did not write on that diagonal (no int32 value)


def _c3_model(ca, la, cb, lb, mismatch=1, gap=1, form="span", tie_late=None):
    """numpy model of C3 (csrc/fitspan.cu), a pair at a time as a block
    runs it: diagonal d = 1 .. m + n computes only the lanes j in
    [max(0, d - m), min(n, d)] from a ring of the last three diagonals
    (slot d % 3) whose every other lane is poisoned, and reading one fails;
    the codes past each length are not there to read. The extraction is
    the plain version's, clamped (min(D, 2^30) and min(S, 2^30), unclamped
    on a window of one lane), and at every extraction the kernel's rule on
    the unclamped cell must decide the same. form "span" returns (cost,
    start_j, end_j), "fit" (cost, end_j) with tie_late rows, "global"
    (cost, n)."""
    ca, cb = np.asarray(ca, np.int64), np.asarray(cb, np.int64)
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    B, M = ca.shape
    N = cb.shape[1]
    big = 2**30
    mm, gp = int(mismatch), int(gap)
    late = np.zeros(B, bool) if tie_late is None else np.asarray(tie_late, bool)
    out = np.zeros((3, B), np.int64)
    for r in range(B):
        m, n = int(la[r]), int(lb[r])
        assert 0 <= m <= M and 0 <= n <= N
        a, b = ca[r, :m] & 3, cb[r, :n] & 3
        ring = np.full((2, 3, N + 1), _GONE)  # (cost, S) x slot x lane
        ring[:, 0, 0] = 0  # D[0, 0], S[0, 0]
        fit = (0 if m + n == 0 else big) if form == "global" else (0 if m == 0 else big)
        start, end = 0, (n if form == "global" else 0)
        for d in range(1, m + n + 1):
            j = np.arange(max(0, d - m), min(n, d) + 1)
            i = d - j
            (P, SP), (Q, SQ) = ring[:, (d + 2) % 3], ring[:, (d + 1) % 3]
            D, S = np.zeros(j.size, np.int64), np.zeros(j.size, np.int64)
            inner = (i > 0) & (j > 0)
            ii, jj = i[inner], j[inner]
            reads = (Q[jj - 1], P[jj], P[jj - 1], SQ[jj - 1], SP[jj], SP[jj - 1])
            assert not any(np.isin(_GONE, x) for x in reads), (r, d)
            c_diag = _wrap32(Q[jj - 1] + np.where(a[ii - 1] == b[jj - 1], 0, mm))
            c_up, c_left = _wrap32(P[jj] + gp), _wrap32(P[jj - 1] + gp)
            D[inner] = np.minimum(np.minimum(c_diag, c_up), c_left)
            S[inner] = np.minimum(np.minimum(np.where(c_diag == D[inner], SQ[jj - 1], big),
                                             np.where(c_up == D[inner], SP[jj], big)),
                                  np.where(c_left == D[inner], SP[jj - 1], big))
            D[j == 0], S[j == 0] = _wrap32(d * gp), 0
            D[i == 0] = _wrap32(d * gp) if form == "global" else 0
            S[i == 0] = j[i == 0]
            ring[:, d % 3] = _GONE
            ring[0, d % 3, j], ring[1, d % 3, j] = D, S
            hit = i == m
            if not hit.any():
                continue
            Dc, Sc, jc = int(D[hit][0]), int(S[hit][0]), int(j[hit][0])
            v, st = (min(Dc, big), min(Sc, big)) if N > 0 else (Dc, Sc)
            if form == "span":
                better = v < fit
                assert better == (Dc < fit)  # the kernel's rule
                if better:
                    fit, start, end = v, st, jc
            elif form == "fit":
                better = v < fit or (late[r] and v == fit and v < big)
                assert better == (Dc < fit or (late[r] and Dc == fit and Dc < big))
                fit, end = min(fit, v), (jc if better else end)
            elif jc == n:  # d == m + n
                fit = min(fit, v)
        if form == "span":
            start = min(start, end) if fit < big else 0
        out[:, r] = (fit, start, end)
    out = out.astype(np.int32)
    return (out[0], out[1], out[2]) if form == "span" else (out[0], out[2])


def _c3_inputs(seed, B, M, N, kind):
    """_tb_codes widened to whole words: (codes a, la, codes b, lb) numpy
    with garbage past each length, and the same as the JAX package's
    uint32 words and as the port's int32 words."""
    ca, la, cb, lb = _tb_codes(seed, B, M, N, kind)
    ca = np.pad(ca, ((0, 0), (0, -M % 16)))
    cb = np.pad(cb, ((0, 0), (0, -N % 16)))
    wa, wb = (bitops.pack_codes(torch.from_numpy(c & 3)) for c in (ca, cb))
    return (ca, la, cb, lb), (wa, torch.from_numpy(la), wb, torch.from_numpy(lb))


def _jax_c3(words, mm, gap, form, late=None):
    wa, la, wb, lb = (jnp.asarray(x.numpy().view(np.uint32) if x.ndim == 2 else x.numpy())
                      for x in words)
    if form == "span":
        return jalign.fit_distance_span(wa, la, wb, lb, mm, gap)
    if form == "fit":
        return jalign.fit_distance(wa, la, wb, lb, mm, gap,
                                   tie_late=None if late is None else jnp.asarray(late))
    return jalign.global_distance(wa, la, wb, lb, mm, gap), lb


def _c3_all_eq(seed, B, M, N, kind, costs):
    """The model of C3 in its three forms against JAX, bit for bit, at each
    (mismatch, gap) of ``costs``; tie_late on every other row of the fit."""
    codes, words = _c3_inputs(seed, B, M, N, kind)
    late = np.arange(B) % 2 == 1
    for mm, gap in costs:
        for form in ("span", "fit", "global"):
            _all_eq(_c3_model(*codes, mm, gap, form, late), _jax_c3(words, mm, gap, form, late))


@pytest.mark.parametrize("kind,M,N", [
    (kind, M, N) for kind in ("planted", "polyA", "repeat") for M, N in ((30, 60), (60, 30))
] + [("planted", 0, 40), ("planted", 40, 0), ("planted", 0, 0)])
def test_c3_model_matches_jax(kind, M, N):
    """The live-lane recurrence with its ring of three diagonals: seeded
    pairs, m > n, empty sides (m = 0 or n = 0 rows in every batch),
    tie-heavy rows (poly-A, period-2 and -3 repeats), at weights (1, 1) and
    (3, 2)."""
    _c3_all_eq(31, 12, M, N, kind, WEIGHTS)


_EXTREME = (-2**31, -7, 0, 2**30, 2**31 - 1)


@pytest.mark.parametrize("mm", _EXTREME)
def test_c3_model_any_int32_costs_match_jax(mm):
    """Costs in {-2^31, -7, 0, 2^30, 2^31 - 1} on both sides: every sum and
    the boundary products d * gap wrap in int32, the tie tests compare the
    wrapped values, and cells past 2^30 meet the clamped extraction."""
    _c3_all_eq(32, 10, 26, 41, "planted", [(mm, gap) for gap in _EXTREME])


def test_c3_model_on_the_seeded_pairs(pairs):
    """The model on the module's seeded pairs (JAX's words, zero past each
    length) against JAX in all three forms."""
    ja, (wa, la), jb, (wb, lb) = pairs
    ca, cb = bitops.unpack_words(wa).numpy(), bitops.unpack_words(wb).numpy()
    late = np.arange(wa.shape[0]) % 3 == 0
    for mm, gap in WEIGHTS:
        _all_eq(_c3_model(ca, la, cb, lb, mm, gap, "span"),
                jalign.fit_distance_span(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap))
        _all_eq(_c3_model(ca, la, cb, lb, mm, gap, "fit", late),
                jalign.fit_distance(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap,
                                    tie_late=jnp.asarray(late)))
        _eq(_c3_model(ca, la, cb, lb, mm, gap, "global")[0],
            jalign.global_distance(ja.words, ja.lengths, jb.words, jb.lengths, mm, gap))


def test_c3_plain_versions_past_the_widths_match_jax():
    """Lengths outside [0, 16 Wa] and [0, 16 Wb] (negative, and past the
    words): the plain versions give what JAX gives (C3 refuses them on the
    card; no caller passes them)."""
    rng = np.random.default_rng(33)
    wa = rng.integers(0, 2**32, (8, 2), dtype=np.uint64).astype(np.uint32)
    wb = rng.integers(0, 2**32, (8, 3), dtype=np.uint64).astype(np.uint32)
    la = np.array([40, -3, 32, 5, 33, 0, -1, 20], np.int32)
    lb = np.array([60, 10, 49, -2, 48, 70, 5, 100], np.int32)
    late = np.arange(8) % 2 == 0
    tw = [torch.from_numpy(x.view(np.int32).copy()) for x in (wa, wb)]
    t = (tw[0], torch.from_numpy(la), tw[1], torch.from_numpy(lb))
    j = tuple(jnp.asarray(x) for x in (wa, la, wb, lb))
    for mm, gap in ((1, 1), (3, 2), (-1, 1)):
        _all_eq(align.fit_distance_span_torch(*t, mm, gap), jalign.fit_distance_span(*j, mm, gap))
        _all_eq(align._distance_wavefront_torch(*t, mm, gap, True, torch.from_numpy(late)),
                jalign.fit_distance(*j, mm, gap, tie_late=jnp.asarray(late)))
        _eq(align._distance_wavefront_torch(*t, mm, gap)[0], jalign.global_distance(*j, mm, gap))


@pytest.mark.parametrize("B,M,N,planes,want", [
    (1024, 3008, 3840, 2, (1, 1, 0, 1024)),  # phase 10's extend batch: 92,192 B of ring
    (1024, 160, 224, 1, (1, 1, 0, 1024)),    # the distance forms at the mapping shape
    (4, 10_016, 12_640, 2, (0, 1, 303_392, 4)),  # 10-kb reads: the ring in scratch
    (5000, 10_016, 12_640, 2, (0, 1, 303_392, 3539)),  # capped by _FIT_SCRATCH_BYTES
    (9000, 4000, 8191, 2, (1, 1, 0, 9000)),          # the widest ring in shared memory
    (9000, 4000, 8192, 2, (0, 1, 196_640, 5460)),    # one lane past it
    (9000, 4000, 8192, 1, (1, 1, 0, 9000)),          # one plane fits
    (3, 150_000, 150_000, 1, (0, 0, 2_100_016, 3)),  # the codes past shared memory too
    (0, 10, 10, 2, (1, 1, 0, 1)),
])
def test_c3_layout(B, M, N, planes, want):
    """Where C3 keeps a pair's ring and codes, and how many blocks stride
    over the pairs when they live in device scratch."""
    assert align._fit_layout(B, M, N, planes) == want


def test_c3_routes_cpu_tensors_to_the_plain_version():
    """CPU words take the plain versions of both forms (no launch);
    backend('kernel') on them raises; the counter exists; the plain K8's
    wide band runs the plain span form."""
    assert "fit_span" in kernels.LAUNCHES
    _, (wa, la, wb, lb) = _c3_inputs(34, 6, 20, 30, "planted")
    before = kernels.LAUNCHES["fit_span"]
    want = align.fit_distance_span_torch(wa, la, wb, lb, 3, 2)
    _all_eq(align.fit_distance_span(wa, la, wb, lb, 3, 2), want)
    _all_eq(align.fit_distance_span_banded(wa, la, wb, lb, 3, 2, -200, 200), want)
    _all_eq(align.fit_distance_span_banded_torch(wa, la, wb, lb, 3, 2, -200, 200), want)
    late = torch.arange(6) % 2 == 0
    want_fit = align._distance_wavefront_torch(wa, la, wb, lb, 3, 2, True, late)
    _all_eq(align.fit_distance(wa, la, wb, lb, 3, 2, late), want_fit)
    _all_eq(align._distance_wavefront(wa, la, wb, lb, 3, 2, True, late), want_fit)
    _eq(align.global_distance(wa, la, wb, lb, 3, 2),
        align._distance_wavefront_torch(wa, la, wb, lb, 3, 2)[0])
    _eq(align.edit_distance(wa, la, wb, lb), align._distance_wavefront_torch(wa, la, wb, lb, 1, 1)[0])
    assert kernels.LAUNCHES["fit_span"] == before
    with config.backend("kernel"):
        for call in (lambda: align.fit_distance_span(wa, la, wb, lb),
                     lambda: align.fit_distance_span_banded(wa, la, wb, lb, 1, 1, -200, 200),
                     lambda: align.edit_distance(wa, la, wb, lb),
                     lambda: align.global_distance(wa, la, wb, lb),
                     lambda: align.fit_distance(wa, la, wb, lb, 1, 1, late)):
            with pytest.raises(ValueError, match="CUDA"):
                call()


def _c_params(name):
    """The parameters of csrc's C entry point ``name``, from its source."""
    import re

    for src in _build.CSRC.glob("*.cu"):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src.read_text())
        if m:
            return [p.strip() for p in m.group(1).split(",") if p.strip()]
    raise AssertionError(f"{name}: no C entry point in csrc")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_point_argtypes(name):
    """Each ctypes signature has one argtype a parameter of its C entry
    point, a pointer where the C side takes a pointer and a 64-bit integer
    where it takes int64_t (ctypes would pass a wrong count or width
    silently)."""
    import ctypes

    params = _c_params(name)
    argtypes = _build._SIGNATURES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        if "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("int64_t"):
            assert t is ctypes.c_int64, p
        else:
            assert t in (ctypes.c_int, ctypes.c_uint32), p
