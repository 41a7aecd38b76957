"""Batched pairwise alignment: edit distance, global and fitting distance,
tracebacks with CIGARs, and affine-gap Smith-Waterman scores.

The counterpart of ``bitnuc_tpu/ops/align.py``. Every function is the
anti-diagonal wavefront of the JAX package: cells (i, j) with i + j = d do
not depend on each other, so the loop runs over d = 1..M+N and updates a
whole diagonal of lanes j per step. Reads are [B, W] packed words (int32
views) with [B] lengths; codes past a length become the sentinels 4 (for
``a``) and 5 (for ``b``), which never match anything. Costs and scores are
int32, with the sentinel ``_BIG = 2^30``. Costs and scores may be any
int32 values: every sum wraps modulo 2^32, as the JAX package's int32
arithmetic does, and so do the kernels' (``_i32`` wraps the boundary
products d * gap, which are Python ints here).

Four groups of functions have hand-written kernels, each beside its plain
version here and picked by the device of the inputs (see ``config``):

* ``fit_distance_span_banded`` — K8 ``fit_banded`` (``csrc/wavefront.cu``,
  the mapper's fit);
* ``sw_score`` — K9 ``sw_score`` (``csrc/wavefront.cu``);
* the tracebacks ``align_ops``, ``align_ops_codes`` and
  ``align_ops_codes_banded`` — C2 ``traceback`` (``csrc/traceback.cu``,
  the source of every CIGAR), which replaces no TPU kernel: the JAX package
  runs them as two ``lax.scan`` loops, the direction-recording wavefront
  and its walk;
* the unbanded wavefront, ``fit_distance_span`` (the fit of
  ``map_reads_long``'s extend, and of a band as wide as the window) and the
  distance forms behind ``edit_distance``, ``global_distance`` and
  ``fit_distance`` — C3 ``fit_span`` (``csrc/fitspan.cu``), which replaces
  no TPU kernel either: the JAX package runs each as one ``lax.scan``.

The plain loops stop at the batch's largest m + n: no cell past it can
reach an output (the fitting extraction needs j = d - m <= n, the global
answer and every traceback cell lie on d <= m + n, and Smith-Waterman only
scores cells with i <= m and j <= n), so the results are those of the
full M + N diagonals.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

_BIG = 2**30
_PAD_A = 4  # sentinel codes: pads never equal each other or ACGT
_PAD_B = 5

# The register kernels hold a row of up to 32 x 32 cells in a warp's
# registers and a pair's codes in shared memory; wider rows or longer codes
# take the wide kernels, whose last three diagonals live in a ring of
# device memory per warp (at most _WIDE_WARPS warps, _WIDE_SCRATCH_BYTES).
MAX_REGISTER_LANES = 1024
_MAX_SMEM_CODES = 227 * 1024
_WIDE_WARPS = 4096
_WIDE_SCRATCH_BYTES = 1 << 28


def _i32(x: int) -> int:
    """A Python int wrapped to int32, as an int32 product wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _codes(words: torch.Tensor, lengths: torch.Tensor, pad: int) -> torch.Tensor:
    """[B, W] packed words -> [B, 16W] int32 codes with ``pad`` past each
    length."""
    c = bitops.unpack_words(words)
    pos = torch.arange(c.shape[-1], dtype=torch.int32, device=c.device)
    return torch.where(pos < lengths.to(torch.int32)[..., None], c, pad)


def _rev_padded(codes_a: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """Reverse ``a`` and pad both ends so every diagonal slice is in bounds:
    lane j of diagonal d reads a[d-1-j] at column N+1+M-d+j."""
    pad = torch.full((codes_a.shape[0], n_lanes), _PAD_A, dtype=torch.int32,
                     device=codes_a.device)
    return torch.cat([pad, torch.flip(codes_a, (-1,)), pad], -1)


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    """x[j-1] with ``fill`` at j = 0."""
    head = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[..., :-1]], -1)


def _b_shifted(codes_b: torch.Tensor) -> torch.Tensor:
    """[B, N+1]: b[j-1] at lane j, the sentinel at j = 0."""
    head = torch.full((codes_b.shape[0], 1), _PAD_B, dtype=torch.int32, device=codes_b.device)
    return torch.cat([head, codes_b], -1)


def _last_diagonal(lens_a: torch.Tensor, lens_b: torch.Tensor, T: int) -> int:
    """min(T, max(m + n)) over the batch: the last diagonal any output
    depends on."""
    if lens_a.numel() == 0:
        return 0
    return max(0, min(T, int((lens_a.to(torch.int64) + lens_b.to(torch.int64)).max())))


# -- unbanded distances -----------------------------------------------------


def _distance_wavefront_torch(words_a, lens_a, words_b, lens_b, mismatch, gap,
                              ends_free_b: bool = False, tie_late=None):
    """Plain version of C3's distance form: _distance_wavefront over the
    full N + 1 lanes of each diagonal."""
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    dev = a.device
    pos = torch.arange(N + 1, dtype=torch.int32, device=dev)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = torch.where(pos == 0, 0, _BIG).to(torch.int32).expand(B, N + 1)
    prev2 = torch.full((B, N + 1), _BIG, dtype=torch.int32, device=dev)
    ans = torch.where((lens_a + lens_b) == 0, 0, _BIG).to(torch.int32)
    fit = torch.where(lens_a == 0, 0, _BIG).to(torch.int32)
    endj = torch.zeros(B, dtype=torch.int32, device=dev)
    late = (torch.zeros(B, dtype=torch.bool, device=dev) if tie_late is None
            else torch.as_tensor(tie_late, device=dev).to(torch.bool))
    for d in range(1, _last_diagonal(lens_a, lens_b, M + N) + 1):
        a_diag = arp[:, N + 1 + M - d : 2 * (N + 1) + M - d]
        sub = torch.where(a_diag == bsh, 0, mismatch).to(torch.int32)
        diag = torch.minimum(
            torch.minimum(prev + gap, _shift1(prev, _BIG) + gap),
            _shift1(prev2, _BIG) + sub,
        )
        diag = torch.where(pos == 0, _i32(d * gap), diag)
        diag = torch.where(pos == d, 0 if ends_free_b else _i32(d * gap), diag)
        if ends_free_b:
            jm = d - m
            at = (pos == jm) & (jm >= 0) & (pos <= n)
            v = torch.where(at, diag, _BIG).amin(-1)
            better = (v < fit) | (late & (v == fit) & (v < _BIG))
            fit = torch.minimum(fit, v)
            endj = torch.where(better, jm[:, 0], endj)
        else:
            at = (pos == n) & (d == (m + n))
            ans = torch.minimum(ans, torch.where(at, diag, _BIG).amin(-1))
        prev, prev2 = diag, prev
    if ends_free_b:
        return fit, endj
    return ans, lens_b


def edit_distance(words_a, lens_a, words_b, lens_b) -> torch.Tensor:
    """Levenshtein distance per pair (a[i] vs b[i]): [B] int32. Dispatches
    C3 on CUDA words, as do global_distance and fit_distance."""
    return _distance_wavefront(words_a, lens_a, words_b, lens_b, 1, 1)[0]


def global_distance(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1) -> torch.Tensor:
    """Weighted global alignment cost (Needleman-Wunsch in distance form)."""
    return _distance_wavefront(words_a, lens_a, words_b, lens_b, mismatch, gap)[0]


def fit_distance(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1, tie_late=None):
    """Fitting alignment: all of ``a`` against the best substring of ``b``.
    Returns (cost [B], end_j [B]); ties prefer the smallest end_j, or the
    largest on rows where tie_late [B] bool is True."""
    return _distance_wavefront(words_a, lens_a, words_b, lens_b, mismatch, gap,
                               ends_free_b=True, tie_late=tie_late)


def _span_step_min(c_diag, c_up, c_left, s_diag, s_up, s_left):
    """(D, S): the min cost and the smallest start over every candidate
    that attains it."""
    diag = torch.minimum(torch.minimum(c_diag, c_up), c_left)
    S = torch.minimum(
        torch.minimum(torch.where(c_diag == diag, s_diag, _BIG),
                      torch.where(c_up == diag, s_up, _BIG)),
        torch.where(c_left == diag, s_left, _BIG),
    )
    return diag, S


def fit_distance_span_torch(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1):
    """Plain version of C3's span form: fit_distance_span over the full
    N + 1 lanes of each diagonal."""
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    dev = a.device
    pos = torch.arange(N + 1, dtype=torch.int32, device=dev)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = torch.where(pos == 0, 0, _BIG).to(torch.int32).expand(B, N + 1)
    prev2 = torch.full((B, N + 1), _BIG, dtype=torch.int32, device=dev)
    s_prev = pos.expand(B, N + 1)  # S[0, j] = j
    s_prev2 = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    fit = torch.where(lens_a == 0, 0, _BIG).to(torch.int32)
    endj = torch.zeros(B, dtype=torch.int32, device=dev)
    startj = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(1, _last_diagonal(lens_a, lens_b, M + N) + 1):
        a_diag = arp[:, N + 1 + M - d : 2 * (N + 1) + M - d]
        sub = torch.where(a_diag == bsh, 0, mismatch).to(torch.int32)
        diag, S = _span_step_min(
            _shift1(prev2, _BIG) + sub, prev + gap, _shift1(prev, _BIG) + gap,
            _shift1(s_prev2, _BIG), s_prev, _shift1(s_prev, _BIG),
        )
        diag = torch.where(pos == 0, _i32(d * gap), diag)
        S = torch.where(pos == 0, 0, S)
        diag = torch.where(pos == d, 0, diag)  # free b-prefix: D[0, j] = 0
        S = torch.where(pos == d, pos, S)  # a path entering at (0, j): S = j
        jm = d - m
        at = (pos == jm) & (jm >= 0) & (pos <= n)
        v = torch.where(at, diag, _BIG).amin(-1)
        st = torch.where(at, S, _BIG).amin(-1)
        better = v < fit  # strict: the earliest (smallest) end wins ties
        fit = torch.minimum(fit, v)
        endj = torch.where(better, jm[:, 0], endj)
        startj = torch.where(better, st, startj)
        prev, prev2, s_prev, s_prev2 = diag, prev, S, s_prev
    startj = torch.where(fit < _BIG, torch.minimum(startj, endj), 0)
    return fit, startj, endj


# -- unbanded wavefront on the card: C3 ------------------------------------------
#
# C3 computes only the cells of each pair's rectangle [0, m] x [0, n]: no
# cell of it depends on a cell outside it, and every output is read off it
# (see csrc/fitspan.cu). It keeps a pair's ring of three diagonals (12
# bytes a lane a plane: the cost, and in the span form the start column)
# and its codes (a byte a base) in shared memory; past _FIT_RING_SMEM_BYTES
# the ring, and past _FIT_SMEM_BYTES the codes too, go to a slice of device
# scratch a block, for at most _FIT_MAX_BLOCKS blocks within
# _FIT_SCRATCH_BYTES.
_FIT_RING_SMEM_BYTES = 192 * 1024
_FIT_SMEM_BYTES = 227 * 1024 - 64
_FIT_SCRATCH_BYTES = 1 << 30
_FIT_MAX_BLOCKS = 8192


def _fit_layout(B: int, M: int, N: int, planes: int = 2) -> Tuple[int, int, int, int]:
    """(ring_smem, codes_smem, stride, nblocks) of a C3 launch over codes
    of widths M and N: planes 2 for the span form, 1 for the distance form.
    stride is the scratch bytes a block (0: all in shared memory, one block
    a pair); otherwise nblocks blocks stride over the B pairs."""
    ring = _round16(12 * planes * (N + 1))
    codes = _round16(M) + _round16(N)
    ring_smem = ring <= _FIT_RING_SMEM_BYTES
    codes_smem = codes + (ring if ring_smem else 0) <= _FIT_SMEM_BYTES
    stride = (0 if ring_smem else ring) + (0 if codes_smem else codes)
    if stride == 0:
        return 1, 1, 0, max(1, B)
    nblocks = max(1, min(B, _FIT_MAX_BLOCKS, _FIT_SCRATCH_BYTES // stride))
    return int(ring_smem), int(codes_smem), stride, nblocks


def _fit_span_launch(words_a, lens_a, words_b, lens_b, mismatch, gap, span: bool,
                     ends_free_b: bool, tie_late):
    """C3 on the card (``csrc/fitspan.cu``): contiguous int32 CUDA words
    [B, Wa] and [B, Wb] with int32 lengths [B] in [0, 16 Wa] and [0, 16 Wb]
    (others raise); costs are any int32 values. Returns (cost, start_j or
    None, end_j), [B] int32 each: the span form where ``span``, else the
    distance form (fitting where ``ends_free_b``, with tie_late rows)."""
    B, M, N = _check_pairs("fit_span", words_a, lens_a, words_b, lens_b)
    dev = words_a.device
    if B and bool(((lens_a < 0) | (lens_a > M) | (lens_b < 0) | (lens_b > N)).any()):
        raise ValueError(f"fit_span: lengths must lie in [0, {M}] and [0, {N}]")
    cost, endj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
    startj = torch.empty(B, dtype=torch.int32, device=dev) if span else None
    if B == 0:
        return cost, startj, endj
    late = None
    if tie_late is not None and ends_free_b and not span:
        late = torch.as_tensor(tie_late, device=dev).to(torch.bool).reshape(B).contiguous()
    ring_smem, codes_smem, stride, nblocks = _fit_layout(B, M, N, 2 if span else 1)
    scratch = torch.empty(nblocks * stride, dtype=torch.uint8, device=dev) if stride else None
    code = _build.library().bn_fit_span(
        words_a.data_ptr(), lens_a.data_ptr(), words_b.data_ptr(), lens_b.data_ptr(),
        None if late is None else late.data_ptr(), B, words_a.shape[1], words_b.shape[1],
        _i32(mismatch), _i32(gap), int(span), int(bool(ends_free_b)), ring_smem, codes_smem,
        None if scratch is None else scratch.data_ptr(), stride, nblocks, cost.data_ptr(),
        None if startj is None else startj.data_ptr(), endj.data_ptr(),
        kernels.stream_handle(dev),
    )
    _build.check(code, "fit_span")
    kernels.LAUNCHES["fit_span"] += 1
    return cost, startj, endj


def _kernel_words(words_a, lens_a, words_b, lens_b):
    return (words_a.contiguous(), lens_a.to(torch.int32).contiguous(),
            words_b.contiguous(), lens_b.to(torch.int32).contiguous())


def fit_distance_span_kernel(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1):
    """C3 on the card, span form: fit_distance_span on CUDA words (see
    ``_fit_span_launch``)."""
    return _fit_span_launch(words_a, lens_a, words_b, lens_b, mismatch, gap, True, True, None)


def _distance_wavefront_kernel(words_a, lens_a, words_b, lens_b, mismatch, gap,
                               ends_free_b: bool = False, tie_late=None):
    """C3 on the card, distance form: _distance_wavefront on CUDA words
    (see ``_fit_span_launch``)."""
    cost, _, endj = _fit_span_launch(words_a, lens_a, words_b, lens_b, mismatch, gap, False,
                                     ends_free_b, tie_late)
    return cost, endj


def _distance_wavefront(words_a, lens_a, words_b, lens_b, mismatch, gap,
                        ends_free_b: bool = False, tie_late=None):
    """Min-cost alignment DP: global (Needleman-Wunsch in distance form)
    when ends_free_b=False, fitting (all of ``a`` inside a substring of
    ``b``: D[0, j] = 0, answer min_j D[m, j]) when True.

    Returns (cost [B], end_j [B]): end_j is one past the best fit's end
    (lens_b for global). Equal-cost fits tie to the smallest end_j, or to
    the largest on rows where tie_late [B] bool is True. Dispatches C3 on
    CUDA words (see ``config``)."""
    if config.use_kernel(words_a):
        return _distance_wavefront_kernel(*_kernel_words(words_a, lens_a, words_b, lens_b),
                                          mismatch, gap, ends_free_b, tie_late)
    return _distance_wavefront_torch(words_a, lens_a, words_b, lens_b, mismatch, gap,
                                     ends_free_b, tie_late)


def fit_distance_span(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1):
    """Fitting alignment returning both span ends in one pass: (cost [B],
    start_j [B], end_j [B]). The path's row-0 entry column rides through
    the DP, so start and end come from one optimal path. Ties: the
    earliest diagonal (smallest end) wins strictly; the start is the
    smallest over every optimal path to that end. Dispatches C3 on CUDA
    words (see ``config``)."""
    if config.use_kernel(words_a):
        return fit_distance_span_kernel(*_kernel_words(words_a, lens_a, words_b, lens_b),
                                        mismatch, gap)
    return fit_distance_span_torch(words_a, lens_a, words_b, lens_b, mismatch, gap)


# -- banded fit: K8 -----------------------------------------------------------
#
# An alignment path visits cells whose offset o = j - i moves by one per
# gap. With o bounded to [off_lo, off_hi], the live cells of diagonal d are
# j in [ceil((d+off_lo)/2), floor((d+off_hi)/2)]: a band of
# K = (off_hi-off_lo+1)//2 + 2 lanes whose start base(d) slides by 0 or 1
# per diagonal. Exact whenever some optimal path keeps j - i in the band;
# otherwise the cost is an achievable upper bound.


def _band_geometry(off_lo: int, off_hi: int, N: int):
    """(K, base) for a band covering j - i in [off_lo, off_hi]; base(d) is
    the j of band lane 0 on diagonal d."""
    if not off_lo <= 0 <= off_hi:
        raise ValueError(f"the band must hold offset 0: got ({off_lo}, {off_hi})")
    K = (off_hi - off_lo + 1) // 2 + 2
    top = max(0, N + 1 - K)

    def base(d: int) -> int:
        return min(max((d + off_lo + 1) // 2, 0), top)

    return K, base


def _band_shift(x: torch.Tensor, delta: int, lag: int, K: int, fill) -> torch.Tensor:
    """Band-local lane alignment: out[t] = x[t + delta - lag], ``fill``
    outside. lag 0 reads the same j (up move), lag 1 reads j - 1."""
    B = x.shape[0]
    lead = torch.full((B, lag), fill, dtype=x.dtype, device=x.device)
    tail = torch.full((B, 3 - lag), fill, dtype=x.dtype, device=x.device)
    return torch.cat([lead, x, tail], -1)[:, delta : delta + K]


def fit_distance_span_banded_torch(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1,
                                   off_lo: int = -16, off_hi: int = 96):
    """Plain version of K8: fit_distance_span restricted to the diagonal
    band j - i in [off_lo, off_hi], over K band lanes per diagonal."""
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    K, base = _band_geometry(off_lo, off_hi, N)
    if K >= N + 1:
        return fit_distance_span_torch(words_a, lens_a, words_b, lens_b, mismatch, gap)
    dev = a.device
    t = torch.arange(K, dtype=torch.int32, device=dev)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = torch.where(t == 0, 0, _BIG).to(torch.int32).expand(B, K)
    prev2 = torch.full((B, K), _BIG, dtype=torch.int32, device=dev)
    s_prev = t.expand(B, K)
    s_prev2 = torch.zeros((B, K), dtype=torch.int32, device=dev)
    fit = torch.where(lens_a == 0, 0, _BIG).to(torch.int32)
    endj = torch.zeros(B, dtype=torch.int32, device=dev)
    startj = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(1, _last_diagonal(lens_a, lens_b, M + N) + 1):
        bd = base(d)
        d1, d2 = bd - base(d - 1), bd - base(d - 2)
        jj = bd + t
        a_diag = arp[:, N + 1 + M - d + bd : N + 1 + M - d + bd + K]
        sub = torch.where(a_diag == bsh[:, bd : bd + K], 0, mismatch).to(torch.int32)
        diag, S = _span_step_min(
            _band_shift(prev2, d2, 1, K, _BIG) + sub,
            _band_shift(prev, d1, 0, K, _BIG) + gap,
            _band_shift(prev, d1, 1, K, _BIG) + gap,
            _band_shift(s_prev2, d2, 1, K, _BIG),
            _band_shift(s_prev, d1, 0, K, _BIG),
            _band_shift(s_prev, d1, 1, K, _BIG),
        )
        diag = torch.where(jj == 0, _i32(d * gap), diag)
        S = torch.where(jj == 0, 0, S)
        diag = torch.where(jj == d, 0, diag)  # free b-prefix: D[0, j] = 0
        S = torch.where(jj == d, jj, S)
        diag = torch.where(jj > d, _BIG, diag)  # i < 0: no such cell
        jm = d - m
        at = (jj == jm) & (jm >= 0) & (jj <= n)
        v = torch.where(at, diag, _BIG).amin(-1)
        st = torch.where(at, S, _BIG).amin(-1)
        better = v < fit
        fit = torch.minimum(fit, v)
        endj = torch.where(better, jm[:, 0], endj)
        startj = torch.where(better, st, startj)
        prev, prev2, s_prev, s_prev2 = diag, prev, S, s_prev
    startj = torch.where(fit < _BIG, torch.minimum(startj, endj), 0)
    return fit, startj, endj


def _check_pairs(name, words_a, lens_a, words_b, lens_b) -> Tuple[int, int, int]:
    kernels.require(words_a, f"{name} words_a", torch.int32, 2)
    kernels.require(lens_a, f"{name} lens_a", torch.int32, 1)
    kernels.require(words_b, f"{name} words_b", torch.int32, 2)
    kernels.require(lens_b, f"{name} lens_b", torch.int32, 1)
    B = words_a.shape[0]
    if words_b.shape[0] != B or lens_a.shape[0] != B or lens_b.shape[0] != B:
        raise ValueError(f"{name}: words and lengths of a and b need one batch size")
    if len({t.device for t in (words_a, lens_a, words_b, lens_b)}) != 1:
        raise ValueError(f"{name}: every input must lie on one device")
    return B, 16 * words_a.shape[1], 16 * words_b.shape[1]


def _wide_scratch(B: int, lanes: int, planes: int, Wa: int, Wb: int, device):
    """(scratch, nwarps) of a wavefront launch: (None, 0) selects the
    register kernel; otherwise each of nwarps warps gets a ring of
    ``planes`` x ``lanes`` int32 cells and the warps stride over the B pairs."""
    if lanes <= MAX_REGISTER_LANES and 16 * (Wa + Wb) <= _MAX_SMEM_CODES:
        return None, 0
    nwarps = max(1, min(B, _WIDE_WARPS, _WIDE_SCRATCH_BYTES // (4 * planes * lanes)))
    return torch.empty(nwarps * planes * lanes, dtype=torch.int32, device=device), nwarps


def fit_distance_span_banded_kernel(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1,
                                    off_lo: int = -16, off_hi: int = 96):
    """K8 on the card (``csrc/wavefront.cu``): contiguous int32 CUDA words
    [B, Wa] and [B, Wb] with int32 lengths [B]. Needs K < N + 1 (the
    dispatcher sends wider bands to fit_distance_span); costs are any int32
    values, wrapping as the plain version's do. Bands of K > 1024 cells run
    the wide kernel (see ``_wide_scratch``)."""
    B, M, N = _check_pairs("fit_banded", words_a, lens_a, words_b, lens_b)
    K, _ = _band_geometry(off_lo, off_hi, N)
    mismatch, gap = int(mismatch), int(gap)
    if K >= N + 1:
        raise ValueError(f"fit_banded: needs K < N + 1 (K = {K}, N = {N})")
    dev = words_a.device
    cost, startj, endj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    scratch, nwarps = _wide_scratch(B, K, 6, words_a.shape[1], words_b.shape[1], dev)
    code = _build.library().bn_fit_banded(
        words_a.data_ptr(), lens_a.data_ptr(), words_b.data_ptr(), lens_b.data_ptr(),
        B, words_a.shape[1], words_b.shape[1], mismatch, gap, off_lo, K,
        None if scratch is None else scratch.data_ptr(), nwarps,
        cost.data_ptr(), startj.data_ptr(), endj.data_ptr(), kernels.stream_handle(dev),
    )
    _build.check(code, "fit_banded")
    kernels.LAUNCHES["fit_banded"] += 1
    return cost, startj, endj


def fit_distance_span_banded(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1,
                             off_lo: int = -16, off_hi: int = 96):
    """fit_distance_span restricted to the diagonal band j - i in
    [off_lo, off_hi] (see the band contract above): (cost [B], start_j [B],
    end_j [B]), single-path spans, earliest-end / smallest-start ties. A
    band as wide as the window (K >= N + 1) runs fit_distance_span.
    Dispatches K8 on CUDA words (see ``config``)."""
    K, _ = _band_geometry(off_lo, off_hi, 16 * words_b.shape[-1])
    if K >= 16 * words_b.shape[-1] + 1:
        return fit_distance_span(words_a, lens_a, words_b, lens_b, mismatch, gap)
    if config.use_kernel(words_a):
        return fit_distance_span_banded_kernel(*_kernel_words(words_a, lens_a, words_b, lens_b),
                                               mismatch, gap, off_lo, off_hi)
    return fit_distance_span_banded_torch(words_a, lens_a, words_b, lens_b, mismatch, gap,
                                          off_lo, off_hi)


# -- traceback: alignment operations and CIGARs --------------------------------

# op codes of a traceback row (0 ends a row's op list)
OP_STOP, OP_EQ, OP_X, OP_INS, OP_DEL = 0, 1, 2, 3, 4
_OP_CHARS = {OP_EQ: "=", OP_X: "X", OP_INS: "I", OP_DEL: "D"}


def _traceback(flat, lane_of, lens_a, end_j, ends_free_b: bool, T: int):
    """The op-continuation traceback over a recorded direction plane
    ``flat`` [B, T * width] (bit0 diag ties, bit1 up ties, bit2 left ties,
    bit3 diag is a match). lane_of(d, j) -> the plane column of cell j on
    diagonal d. Returns ops [B, T] uint8 in forward order, OP_STOP-padded.

    Tie policy: continue the current gap when it ties (gap runs coalesce),
    else diag > up > left."""
    B = flat.shape[0]
    dev = flat.device
    i, j = lens_a.to(torch.int64), end_j.to(torch.int64)
    prev_op = torch.zeros(B, dtype=torch.int64, device=dev)
    ops_rev = torch.zeros((B, T), dtype=torch.uint8, device=dev)
    for s in range(T):
        active = (i > 0) if ends_free_b else ((i > 0) | (j > 0))
        if s % 32 == 0 and not bool(active.any()):
            break  # every row is done: the rest of each row stays OP_STOP
        d = i + j
        idx = torch.clamp(lane_of(d, j), 0, flat.shape[1] - 1)
        mask = torch.gather(flat, 1, idx[:, None])[:, 0].to(torch.int64)
        diag_op = torch.where((mask & 8) != 0, OP_EQ, OP_X)
        op = torch.where(
            (prev_op == OP_INS) & ((mask & 2) != 0), OP_INS,
            torch.where(
                (prev_op == OP_DEL) & ((mask & 4) != 0), OP_DEL,
                torch.where((mask & 1) != 0, diag_op,
                            torch.where((mask & 2) != 0, OP_INS, OP_DEL)),
            ),
        )
        op = torch.where(active, op, OP_STOP)
        i = i - ((op == OP_EQ) | (op == OP_X) | (op == OP_INS)).to(torch.int64)
        j = j - ((op == OP_EQ) | (op == OP_X) | (op == OP_DEL)).to(torch.int64)
        prev_op = op
        ops_rev[:, s] = op.to(torch.uint8)
    nsteps = (ops_rev != OP_STOP).sum(1)
    tidx = nsteps[:, None] - 1 - torch.arange(T, device=dev)[None, :]
    fwd = torch.gather(ops_rev, 1, torch.clamp(tidx, 0, T - 1))
    return torch.where(tidx >= 0, fwd, OP_STOP).to(torch.uint8)


def _wavefront_tb_codes(a, lens_a, b, lens_b, mismatch, gap, ends_free_b: bool, tie_late):
    """The distance wavefront that also records, per cell, every tying
    predecessor (bit0 diag, bit1 up, bit2 left, bit3 diag is a match), then
    traces back. ``a``/``b`` are padded int32 codes. Returns (cost [B],
    end_j [B], ops [B, M+N] uint8 in forward order, OP_STOP-padded)."""
    B, M = a.shape
    N = b.shape[-1]
    T = M + N
    dev = a.device
    pos = torch.arange(N + 1, dtype=torch.int32, device=dev)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = torch.where(pos == 0, 0, _BIG).to(torch.int32).expand(B, N + 1)
    prev2 = torch.full((B, N + 1), _BIG, dtype=torch.int32, device=dev)
    ans = torch.where((lens_a + lens_b) == 0, 0, _BIG).to(torch.int32)
    fit = torch.where(lens_a == 0, 0, _BIG).to(torch.int32)
    endj = torch.zeros(B, dtype=torch.int32, device=dev)
    late = (torch.zeros(B, dtype=torch.bool, device=dev) if tie_late is None
            else torch.as_tensor(tie_late, device=dev).to(torch.bool))
    dirs = torch.zeros((B, T, N + 1), dtype=torch.uint8, device=dev)
    for d in range(1, _last_diagonal(lens_a, lens_b, T) + 1):
        a_diag = arp[:, N + 1 + M - d : 2 * (N + 1) + M - d]
        is_eq = a_diag == bsh
        cand_diag = _shift1(prev2, _BIG) + torch.where(is_eq, 0, mismatch).to(torch.int32)
        cand_up = prev + gap
        cand_left = _shift1(prev, _BIG) + gap
        diag = torch.minimum(torch.minimum(cand_diag, cand_up), cand_left)
        dirv = ((diag == cand_diag).to(torch.int32) + 2 * (diag == cand_up)
                + 4 * (diag == cand_left) + 8 * is_eq)
        diag = torch.where(pos == 0, _i32(d * gap), diag)
        dirv = torch.where(pos == 0, 2, dirv)
        diag = torch.where(pos == d, 0 if ends_free_b else _i32(d * gap), diag)
        dirv = torch.where(pos == d, 0 if ends_free_b else 4, dirv)
        if ends_free_b:
            jm = d - m
            at = (pos == jm) & (jm >= 0) & (pos <= n)
            v = torch.where(at, diag, _BIG).amin(-1)
            better = (v < fit) | (late & (v == fit) & (v < _BIG))
            fit = torch.minimum(fit, v)
            endj = torch.where(better, jm[:, 0], endj)
        else:
            at = (pos == n) & (d == (m + n))
            ans = torch.minimum(ans, torch.where(at, diag, _BIG).amin(-1))
        dirs[:, d - 1] = dirv.to(torch.uint8)
        prev, prev2 = diag, prev
    cost, end_j = (fit, endj) if ends_free_b else (ans, lens_b)
    ops = _traceback(dirs.view(B, T * (N + 1)), lambda d, j: (d - 1) * (N + 1) + j,
                     lens_a, end_j, ends_free_b, T)
    return cost, end_j, ops


def _wavefront_tb_codes_banded(a, lens_a, b, lens_b, mismatch, gap, ends_free_b: bool,
                               off_lo: int, off_hi: int):
    """_wavefront_tb_codes restricted to the band j - i in [off_lo, off_hi]:
    the direction plane shrinks from (M+N)(N+1) to (M+N)K bytes per pair,
    and the traceback addresses band lanes j - base(d)."""
    B, M = a.shape
    N = b.shape[-1]
    T = M + N
    K, base = _band_geometry(off_lo, off_hi, N)
    if K >= N + 1:
        return _wavefront_tb_codes(a, lens_a, b, lens_b, mismatch, gap, ends_free_b, None)
    dev = a.device
    t = torch.arange(K, dtype=torch.int32, device=dev)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = torch.where(t == 0, 0, _BIG).to(torch.int32).expand(B, K)
    prev2 = torch.full((B, K), _BIG, dtype=torch.int32, device=dev)
    ans = torch.where((lens_a + lens_b) == 0, 0, _BIG).to(torch.int32)
    fit = torch.where(lens_a == 0, 0, _BIG).to(torch.int32)
    endj = torch.zeros(B, dtype=torch.int32, device=dev)
    dirs = torch.zeros((B, T, K), dtype=torch.uint8, device=dev)
    for d in range(1, _last_diagonal(lens_a, lens_b, T) + 1):
        bd = base(d)
        d1, d2 = bd - base(d - 1), bd - base(d - 2)
        jj = bd + t
        a_diag = arp[:, N + 1 + M - d + bd : N + 1 + M - d + bd + K]
        is_eq = a_diag == bsh[:, bd : bd + K]
        cand_diag = _band_shift(prev2, d2, 1, K, _BIG) + torch.where(is_eq, 0, mismatch).to(torch.int32)
        cand_up = _band_shift(prev, d1, 0, K, _BIG) + gap
        cand_left = _band_shift(prev, d1, 1, K, _BIG) + gap
        diag = torch.minimum(torch.minimum(cand_diag, cand_up), cand_left)
        dirv = ((diag == cand_diag).to(torch.int32) + 2 * (diag == cand_up)
                + 4 * (diag == cand_left) + 8 * is_eq)
        diag = torch.where(jj == 0, _i32(d * gap), diag)
        dirv = torch.where(jj == 0, 2, dirv)
        diag = torch.where(jj == d, 0 if ends_free_b else _i32(d * gap), diag)
        dirv = torch.where(jj == d, 0 if ends_free_b else 4, dirv)
        diag = torch.where(jj > d, _BIG, diag)  # i < 0: no such cell
        if ends_free_b:
            jm = d - m
            at = (jj == jm) & (jm >= 0) & (jj <= n)
            v = torch.where(at, diag, _BIG).amin(-1)
            better = v < fit
            fit = torch.minimum(fit, v)
            endj = torch.where(better, jm[:, 0], endj)
        else:
            at = (jj == n) & (d == (m + n))
            ans = torch.minimum(ans, torch.where(at, diag, _BIG).amin(-1))
        dirs[:, d - 1] = dirv.to(torch.uint8)
        prev, prev2 = diag, prev
    cost, end_j = (fit, endj) if ends_free_b else (ans, lens_b)
    # base(d) per row: the traceback's diagonals differ between rows
    top = max(0, N + 1 - K)

    def lane_of(d, j):
        bd = torch.clamp(torch.div(d + off_lo + 1, 2, rounding_mode="floor"), 0, top)
        return (d - 1) * K + torch.clamp(j - bd, 0, K - 1)

    ops = _traceback(dirs.view(B, T * K), lane_of, lens_a, end_j, ends_free_b, T)
    return cost, end_j, ops


def _pad_codes(codes_a, lens_a, codes_b, lens_b):
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    pa = torch.arange(codes_a.shape[-1], dtype=torch.int32, device=codes_a.device)
    pb = torch.arange(codes_b.shape[-1], dtype=torch.int32, device=codes_b.device)
    a = torch.where(pa < lens_a[:, None], codes_a.to(torch.int32), _PAD_A)
    b = torch.where(pb < lens_b[:, None], codes_b.to(torch.int32), _PAD_B)
    return a, lens_a, b, lens_b


def align_ops_codes_torch(codes_a, lens_a, codes_b, lens_b, mismatch=1, gap=1,
                          ends_free_b: bool = False, tie_late=None):
    """Plain version of C2, unbanded: align_ops_codes over the full N + 1
    lanes of each diagonal and the recorded [T, N + 1] plane."""
    a, lens_a, b, lens_b = _pad_codes(codes_a, lens_a, codes_b, lens_b)
    return _wavefront_tb_codes(a, lens_a, b, lens_b, int(mismatch), int(gap),
                               ends_free_b, tie_late)


def align_ops_codes_banded_torch(codes_a, lens_a, codes_b, lens_b, mismatch=1, gap=1,
                                 ends_free_b: bool = False, off_lo: int = -64,
                                 off_hi: int = 64):
    """Plain version of C2, banded: align_ops_codes_banded over K band lanes
    and the recorded [T, K] plane."""
    a, lens_a, b, lens_b = _pad_codes(codes_a, lens_a, codes_b, lens_b)
    return _wavefront_tb_codes_banded(a, lens_a, b, lens_b, int(mismatch), int(gap),
                                      ends_free_b, off_lo, off_hi)


# C2's block form keeps a pair's last three diagonals (a ring of 12 bytes
# a lane) and its direction plane ((M + 1)(N + 1) bytes unbanded, (M + N) K
# banded) in shared memory where both fit in _TB_SMEM_BYTES; past that the
# plane, and past _TB_RING_SMEM_BYTES the ring too, go to a slice of device
# scratch a block, for at most _TB_MAX_BLOCKS blocks within
# _TB_SCRATCH_BYTES.
_TB_SMEM_BYTES = 96 * 1024
_TB_RING_SMEM_BYTES = 192 * 1024
_TB_SCRATCH_BYTES = 1 << 30
_TB_MAX_BLOCKS = 8192


def _tb_layout(B: int, M: int, N: int, K: int) -> Tuple[int, int, int, int]:
    """(ring_smem, plane_smem, stride, nblocks) of a C2 launch: K = 0 for
    the unbanded form, else the band's lanes. stride is the scratch bytes a
    block (0: all in shared memory, one block a pair); otherwise nblocks
    blocks stride over the B pairs."""
    ring = _round16(12 * (K if K else N + 1))
    plane = (M + N) * K if K else (M + 1) * (N + 1)
    ring_smem = ring <= _TB_RING_SMEM_BYTES
    plane_smem = ring_smem and ring + plane <= _TB_SMEM_BYTES
    stride = (0 if ring_smem else ring) + (0 if plane_smem else _round16(plane))
    if stride == 0:
        return 1, 1, 0, max(1, B)
    nblocks = max(1, min(B, _TB_MAX_BLOCKS, _TB_SCRATCH_BYTES // stride))
    return int(ring_smem), int(plane_smem), stride, nblocks


# C2's warp form (traceback_warp_kernel<C>: a warp a pair, rows pipelined
# down the warp, C columns a lane, masks four bits a cell) takes the
# unbanded launches whose rows fit _TB_WARP_LANES lanes and whose warp's
# plane ((M + 1) x 128 ceil(C / 8) bytes) and ops buffer (M + N bytes,
# rounded up to 16) fit in _TB_WARP_SMEM_BYTES; the block form takes the
# rest.
_TB_WARP_LANES = 1024
_TB_WARP_SMEM_BYTES = 227 * 1024
_TB_WARP_CELLS = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)


def _tb_warp_cells(M: int, N: int) -> int:
    """The cells a lane C of C2's warp form for an unbanded launch of
    [B, M] x [B, N] codes, or 0 where the block form runs it."""
    if N + 1 > min(_TB_WARP_LANES, 32 * _TB_WARP_CELLS[-1]):
        return 0
    C = next(c for c in _TB_WARP_CELLS if 32 * c >= N + 1)
    need = (M + 1) * 128 * ((C + 7) // 8) + _round16(M + N)
    return C if need <= _TB_WARP_SMEM_BYTES else 0


def _traceback_kernel(codes_a, lens_a, codes_b, lens_b, mismatch, gap, ends_free_b: bool,
                      tie_late, off_lo: int = 0, K: int = 0):
    """C2 on the card (``csrc/traceback.cu``): contiguous int32 CUDA codes
    [B, M] and [B, N] (anything past each length) with int32 lengths [B] in
    [0, M] and [0, N]; K = 0 unbanded (the warp form where _tb_warp_cells
    allows it, else the block form), else 2 <= K < N + 1 band lanes from
    off_lo (the block form). Returns (cost [B], end_j [B], ops [B, M + N]
    uint8)."""
    kernels.require(codes_a, "traceback codes_a", torch.int32, 2)
    kernels.require(lens_a, "traceback lens_a", torch.int32, 1)
    kernels.require(codes_b, "traceback codes_b", torch.int32, 2)
    kernels.require(lens_b, "traceback lens_b", torch.int32, 1)
    B, M = codes_a.shape
    N = codes_b.shape[1]
    if codes_b.shape[0] != B or lens_a.shape[0] != B or lens_b.shape[0] != B:
        raise ValueError("traceback: codes and lengths of a and b need one batch size")
    if len({t.device for t in (codes_a, lens_a, codes_b, lens_b)}) != 1:
        raise ValueError("traceback: every input must lie on one device")
    dev = codes_a.device
    if B and bool(((lens_a < 0) | (lens_a > M) | (lens_b < 0) | (lens_b > N)).any()):
        raise ValueError(f"traceback: lengths must lie in [0, {M}] and [0, {N}]")
    cost, endj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
    ops = torch.empty((B, M + N), dtype=torch.uint8, device=dev)
    if B == 0:
        return cost, endj, ops
    late = None
    if tie_late is not None:
        late = torch.as_tensor(tie_late, device=dev).to(torch.bool).reshape(B).contiguous()
    lib = _build.library()
    if K == 0 and _tb_warp_cells(M, N):
        code = lib.bn_traceback_warp(
            codes_a.data_ptr(), lens_a.data_ptr(), codes_b.data_ptr(), lens_b.data_ptr(),
            None if late is None else late.data_ptr(), B, M, N, _i32(mismatch), _i32(gap),
            int(bool(ends_free_b)), cost.data_ptr(), endj.data_ptr(), ops.data_ptr(),
            kernels.stream_handle(dev),
        )
    else:
        ring_smem, plane_smem, stride, nblocks = _tb_layout(B, M, N, K)
        scratch = (torch.empty(nblocks * stride, dtype=torch.uint8, device=dev)
                   if stride else None)
        code = lib.bn_traceback(
            codes_a.data_ptr(), lens_a.data_ptr(), codes_b.data_ptr(), lens_b.data_ptr(),
            None if late is None else late.data_ptr(), B, M, N, _i32(mismatch), _i32(gap),
            int(bool(ends_free_b)), off_lo, K, ring_smem, plane_smem,
            None if scratch is None else scratch.data_ptr(), stride, nblocks,
            cost.data_ptr(), endj.data_ptr(), ops.data_ptr(), kernels.stream_handle(dev),
        )
    _build.check(code, "traceback")
    kernels.LAUNCHES["traceback"] += 1
    return cost, endj, ops


def _kernel_operands(codes_a, lens_a, codes_b, lens_b):
    return (codes_a.to(torch.int32).contiguous(), lens_a.to(torch.int32).contiguous(),
            codes_b.to(torch.int32).contiguous(), lens_b.to(torch.int32).contiguous())


def align_ops_codes_kernel(codes_a, lens_a, codes_b, lens_b, mismatch=1, gap=1,
                           ends_free_b: bool = False, tie_late=None):
    """C2 on the card, unbanded: align_ops_codes on CUDA codes."""
    return _traceback_kernel(*_kernel_operands(codes_a, lens_a, codes_b, lens_b),
                             mismatch, gap, ends_free_b, tie_late)


def align_ops_codes_banded_kernel(codes_a, lens_a, codes_b, lens_b, mismatch=1, gap=1,
                                  ends_free_b: bool = False, off_lo: int = -64,
                                  off_hi: int = 64):
    """C2 on the card, banded: align_ops_codes_banded on CUDA codes (a band
    as wide as the window, K >= N + 1, runs the unbanded form)."""
    K, _ = _band_geometry(off_lo, off_hi, codes_b.shape[-1])
    operands = _kernel_operands(codes_a, lens_a, codes_b, lens_b)
    if K >= codes_b.shape[-1] + 1:
        return _traceback_kernel(*operands, mismatch, gap, ends_free_b, None)
    return _traceback_kernel(*operands, mismatch, gap, ends_free_b, None, off_lo, K)


def align_ops_codes_banded(codes_a, lens_a, codes_b, lens_b, mismatch=1, gap=1,
                           ends_free_b: bool = False, off_lo: int = -64, off_hi: int = 64):
    """align_ops_codes restricted to the diagonal band j - i in
    [off_lo, off_hi]: the same (cost, end_j, ops) whenever some optimal
    path stays in the band. Dispatches C2 on CUDA codes (see ``config``)."""
    if config.use_kernel(codes_a):
        return align_ops_codes_banded_kernel(codes_a, lens_a, codes_b, lens_b, mismatch, gap,
                                             ends_free_b, off_lo, off_hi)
    return align_ops_codes_banded_torch(codes_a, lens_a, codes_b, lens_b, mismatch, gap,
                                        ends_free_b, off_lo, off_hi)


def align_ops(words_a, lens_a, words_b, lens_b, mismatch=1, gap=1,
              ends_free_b: bool = False, tie_late=None):
    """Min-cost alignment with per-base operations (the CIGAR source):
    global when ends_free_b=False, fitting otherwise. Returns (cost [B],
    end_j [B], ops [B, M+N] uint8) in forward order (OP_EQ/OP_X/OP_INS/
    OP_DEL, OP_STOP-padded). Compress with ``cigars``. Dispatches C2 on CUDA
    words (see ``config``)."""
    if config.use_kernel(words_a):
        return align_ops_codes_kernel(bitops.unpack_words(words_a), lens_a,
                                      bitops.unpack_words(words_b), lens_b, mismatch, gap,
                                      ends_free_b, tie_late)
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    return _wavefront_tb_codes(a, lens_a, b, lens_b, int(mismatch), int(gap),
                               ends_free_b, tie_late)


def align_ops_codes(codes_a, lens_a, codes_b, lens_b, mismatch=1, gap=1,
                    ends_free_b: bool = False, tie_late=None):
    """align_ops over int32 code arrays [B, M] and [B, N]; codes past each
    length are re-padded with the sentinels, so they may hold anything.
    Dispatches C2 on CUDA codes (see ``config``)."""
    if config.use_kernel(codes_a):
        return align_ops_codes_kernel(codes_a, lens_a, codes_b, lens_b, mismatch, gap,
                                      ends_free_b, tie_late)
    return align_ops_codes_torch(codes_a, lens_a, codes_b, lens_b, mismatch, gap,
                                 ends_free_b, tie_late)


def cigar_string(ops_row, eqx: bool = True) -> str:
    """Gap-compressed CIGAR of one ops row (host). eqx=True writes =/X;
    False merges them into M."""
    out = []
    prev_c, run = None, 0
    for op in np.asarray(ops_row):
        if op == OP_STOP:
            break
        c = _OP_CHARS[int(op)]
        if not eqx and c in "=X":
            c = "M"
        if c == prev_c:
            run += 1
        else:
            if prev_c is not None:
                out.append(f"{run}{prev_c}")
            prev_c, run = c, 1
    if prev_c is not None:
        out.append(f"{run}{prev_c}")
    return "".join(out)


def cigars(ops, eqx: bool = True) -> List[str]:
    """cigar_string of every row of a [B, T] ops batch, by one vectorised
    run-length pass in numpy (the same strings as cigar_string)."""
    ops = np.asarray(ops.cpu() if isinstance(ops, torch.Tensor) else ops)
    B, T = ops.shape
    if B == 0:
        return []
    cls = ops.astype(np.int8)
    if not eqx:
        cls = np.where(cls == OP_X, OP_EQ, cls)
    live = np.minimum.accumulate(cls != OP_STOP, axis=1)  # up to the first stop
    prev = np.concatenate([np.full((B, 1), -1, np.int8), cls[:, :-1]], 1)
    nxt = np.concatenate([cls[:, 1:], np.full((B, 1), -1, np.int8)], 1)
    nxt_live = np.concatenate([live[:, 1:], np.zeros((B, 1), bool)], 1)
    starts = np.flatnonzero(live & (cls != prev))
    ends = np.flatnonzero(live & ((cls != nxt) | ~nxt_live))
    rows = starts // T
    chars = np.array(["", "=", "X", "I", "D"] if eqx else ["", "M", "M", "I", "D"])
    runs = np.char.add((ends - starts + 1).astype(str), chars[cls.reshape(-1)[starts]])
    # one token per run and one newline per row, in row order
    per_row = np.bincount(rows, minlength=B)
    tokens = np.empty(starts.size + B, dtype=object)
    nl_at = np.cumsum(per_row) + np.arange(B)
    run_at = np.arange(starts.size) + rows
    tokens[run_at] = runs
    tokens[nl_at] = "\n"
    return "".join(tokens.tolist()).split("\n")[:B]


# -- Smith-Waterman: K9 ---------------------------------------------------------


def sw_score_torch(words_a, lens_a, words_b, lens_b, match=2, mismatch=-3,
                   gap_open=-5, gap_extend=-2):
    """Plain version of K9: affine-gap Smith-Waterman (Gotoh) over the full
    N + 1 lanes of each diagonal."""
    lens_a, lens_b = lens_a.to(torch.int32), lens_b.to(torch.int32)
    match, mismatch, gap_open, gap_extend = map(int, (match, mismatch, gap_open, gap_extend))
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    dev = a.device
    pos = torch.arange(N + 1, dtype=torch.int32, device=dev)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    h_prev = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)  # H[0, j] = 0
    h_prev2 = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    e_prev = torch.full((B, N + 1), -_BIG, dtype=torch.int32, device=dev)
    f_prev = torch.full((B, N + 1), -_BIG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    end_i = torch.zeros(B, dtype=torch.int32, device=dev)
    end_j = torch.zeros(B, dtype=torch.int32, device=dev)
    for d in range(1, _last_diagonal(lens_a, lens_b, M + N) + 1):
        a_diag = arp[:, N + 1 + M - d : 2 * (N + 1) + M - d]
        s = torch.where(a_diag == bsh, match, mismatch).to(torch.int32)
        e = torch.maximum(_shift1(h_prev, -_BIG) + gap_open,
                          _shift1(e_prev, -_BIG) + gap_extend)
        f = torch.maximum(h_prev + gap_open, f_prev + gap_extend)
        h = torch.maximum(torch.clamp(_shift1(h_prev2, -_BIG) + s, min=0),
                          torch.maximum(e, f))
        edge = (pos == 0) | (pos == d)  # boundary row and column: H = 0
        h = torch.where(edge, 0, h)
        e = torch.where(edge, -_BIG, e)
        f = torch.where(edge, -_BIG, f)
        i = d - pos
        in_range = (pos >= 1) & (pos <= n) & (i >= 1) & (i <= m)
        hm = torch.where(in_range, h, -1)
        row_best = hm.amax(-1)
        row_j = torch.where(hm == row_best[:, None], pos, N + 1).amin(-1)
        upd = row_best > best  # strict: the earlier diagonal wins ties
        best = torch.maximum(best, row_best)
        end_j = torch.where(upd, row_j, end_j)
        end_i = torch.where(upd, d - row_j, end_i)
        h_prev, h_prev2, e_prev, f_prev = h, h_prev, e, f
    return best, end_i, end_j


def sw_score_kernel(words_a, lens_a, words_b, lens_b, match=2, mismatch=-3,
                    gap_open=-5, gap_extend=-2):
    """K9 on the card (``csrc/wavefront.cu``): contiguous int32 CUDA words
    [B, Wa] and [B, Wb] with int32 lengths [B] and any int32 scores. Rows
    of N + 1 > 1024 lanes run the wide kernel (see ``_wide_scratch``)."""
    B, M, N = _check_pairs("sw_score", words_a, lens_a, words_b, lens_b)
    params = [int(x) for x in (match, mismatch, gap_open, gap_extend)]
    dev = words_a.device
    score, end_i, end_j = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    scratch, nwarps = _wide_scratch(B, N + 1, 7, words_a.shape[1], words_b.shape[1], dev)
    code = _build.library().bn_sw_score(
        words_a.data_ptr(), lens_a.data_ptr(), words_b.data_ptr(), lens_b.data_ptr(),
        B, words_a.shape[1], words_b.shape[1], *params,
        None if scratch is None else scratch.data_ptr(), nwarps,
        score.data_ptr(), end_i.data_ptr(), end_j.data_ptr(), kernels.stream_handle(dev),
    )
    _build.check(code, "sw_score")
    kernels.LAUNCHES["sw_score"] += 1
    return score, end_i, end_j


def sw_score(words_a, lens_a, words_b, lens_b, match=2, mismatch=-3,
             gap_open=-5, gap_extend=-2):
    """Affine-gap Smith-Waterman (Gotoh) local alignment score per pair.

    Returns (score [B], end_i [B], end_j [B]): the best local score and the
    1-based ends of that alignment in a and b; an empty alignment scores 0
    with ends (0, 0). Ties: the smallest i + j, then the smallest j.
    gap_open is the cost of a gap's first base, gap_extend of each further
    base. Dispatches K9 on CUDA words (see ``config``)."""
    if config.use_kernel(words_a):
        return sw_score_kernel(*_kernel_words(words_a, lens_a, words_b, lens_b),
                               match, mismatch, gap_open, gap_extend)
    return sw_score_torch(words_a, lens_a, words_b, lens_b, match, mismatch,
                          gap_open, gap_extend)
