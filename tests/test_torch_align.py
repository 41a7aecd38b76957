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
from bitnuc_tpu_torch.ops import align
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
