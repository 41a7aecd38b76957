"""K-mer extraction and counting on packed reads.

The counterpart of the dense and sort-based parts of
``bitnuc_tpu/ops/kmer.py``. Window p of a read has the key
sum_j code[p+j] << 2j (as_2bit of the window), split into lo = bits [0, 32)
and hi = bits [32, 64) as int32 bit-views.

Counting for k <= MAX_DENSE_K goes to a dense [4^k] int32 histogram through
one of two hand-written kernels (``csrc/histogram.cu``):

* K3b ``hist_words`` makes the window keys in the kernel from the packed
  words, canonical or not; it serves every count with no ``base_valid``;
* K3a ``hist_keys`` counts window keys made here in PyTorch (N-skip
  masks); invalid windows carry the sentinel 4^k.

Each has its plain PyTorch version beside it, used for CPU tensors (see
``config``).

Any k <= 32 also counts by sorting (``count_kmers_sorted``, and
``count_kmers_runs``, the run-start layout the streaming accumulator and
the set algebra use). The JAX package's ``lax.sort`` becomes a stable
``torch.sort`` over int64 keys that order the int32 views as unsigned
(``bitops.u64_sort_key``): the all-ones sentinel of invalid windows must
sort last, not first as int32 -1. Rows that tie on every sort key are
identical or are summed, so the results equal the JAX package's bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

MAX_DENSE_K = 12  # 4^12 = 16.7M int32 bins = 64 MiB
SENT = bitops.ALL_ONES  # 0xFFFFFFFF: the key word of invalid and dead rows


def _shift_tail(x: torch.Tensor, m: int, fill) -> torch.Tensor:
    """out[..., p] = x[..., p+m], ``fill`` past the end. m is static."""
    if m == 0:
        return x
    out = torch.full_like(x, fill)
    if m < x.shape[-1]:  # else the whole row shifted out (w >= L)
        out[..., : x.shape[-1] - m] = x[..., m:]
    return out


def _shift_positions(x: torch.Tensor, m: int) -> torch.Tensor:
    """out[..., p] = x[..., p+m], zero-filled at the tail."""
    return _shift_tail(x, m, 0)


def _keys_u32(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Window keys for k <= 16 bases: [..., L] int32 where position p holds
    the packed value of bases [p, p+k). Positions past L-k are garbage —
    callers mask. O(L log k) work by position doubling."""
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    pows = {1: codes.to(torch.int32)}
    m = 1
    while 2 * m <= k:
        cur = pows[m]
        pows[2 * m] = cur | (_shift_positions(cur, m) << (2 * m))
        m *= 2
    acc = None
    acc_len = 0
    m = 1
    while m <= k:
        if k & m:
            part = pows[m]
            if acc is None:
                acc, acc_len = part, m
            else:
                acc = acc | (_shift_positions(part, acc_len) << (2 * acc_len))
                acc_len += m
        m *= 2
    return acc


def kmer_keys(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All window keys of width k over a [..., L] 2-bit code array.

    Returns (lo, hi), two [..., L] int32 arrays; window p's packed u64 value
    is hi[p] << 32 | lo[p]. For k <= 16, hi is all zeros. Positions past
    L-k are garbage."""
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if k <= 16:
        lo = _keys_u32(codes, k)
        return lo, torch.zeros_like(lo)
    lo = _keys_u32(codes, 16)
    hi = _shift_positions(_keys_u32(codes, k - 16), 16)
    return lo, hi


def window_valid_mask(L: int, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """[..., L] bool: window position p valid iff p + k <= length."""
    pos = torch.arange(L, dtype=torch.int32, device=lengths.device)
    return pos <= (lengths.to(torch.int32)[..., None] - k)


def sliding_all(valid: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., p] = all(valid[..., p:p+k]) by O(L log k) doubling ANDs;
    tail positions are False."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    pows = {1: valid}
    m = 1
    while 2 * m <= k:
        pows[2 * m] = pows[m] & _shift_positions(pows[m], m)
        m *= 2
    acc = pows[m]
    return acc & _shift_positions(acc, k - m) if k > m else acc


def _window_keys(words, lengths, k: int, canonical: bool, base_valid=None):
    """(lo, hi, valid) window keys over a packed batch; canonical=True maps
    each key to min(key, revcomp(key)); base_valid [..., L] bool keeps only
    windows of all-valid bases."""
    codes = bitops.unpack_words(words)
    L = codes.shape[-1]
    lo, hi = kmer_keys(codes, k)
    if canonical:
        from . import revcomp

        lo, hi = revcomp.canonical_keys(lo, hi, k)
    valid = window_valid_mask(L, lengths, k)
    if base_valid is not None:
        bv = torch.as_tensor(base_valid, device=words.device).to(torch.bool)
        if bv.shape[-1] < L:  # pad to the word-aligned code length
            bv = torch.nn.functional.pad(bv, (0, L - bv.shape[-1]))
        valid = valid & sliding_all(bv, k)
    return lo, hi, valid


def _check_dense_k(k: int) -> None:
    if not 1 <= k <= MAX_DENSE_K:
        raise ValueError(f"dense histogram needs 1 <= k <= {MAX_DENSE_K}, got {k}")


# -- K3a: histogram of keys ----------------------------------------------------


def histogram_from_keys_torch(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of K3a: [N] int32 keys -> [4^k] int32 counts; keys
    outside [0, 4^k) (the sentinel 4^k among them) are not counted."""
    _check_dense_k(k)
    nb = 4**k
    keys = keys.reshape(-1).to(torch.int64)
    keys = torch.where((keys >= 0) & (keys < nb), keys, nb)
    return torch.bincount(keys, minlength=nb + 1)[:nb].to(torch.int32)


def histogram_from_keys_kernel(keys: torch.Tensor, k: int) -> torch.Tensor:
    """K3a on the card (``csrc/histogram.cu``), with the scratch its slice
    passes need at k >= 8 (bytes as the library reports them)."""
    _check_dense_k(k)
    kernels.require(keys, "hist_keys keys", torch.int32, 1)
    hist = torch.zeros(4**k, dtype=torch.int32, device=keys.device)
    lib = _build.library()
    nbytes = ctypes.c_int64()
    _build.check(lib.bn_hist_keys_scratch(keys.numel(), k, ctypes.byref(nbytes)),
                 "hist_keys scratch")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=keys.device)
    code = lib.bn_hist_keys(
        keys.data_ptr(), keys.numel(), k, hist.data_ptr(), scratch.data_ptr(),
        kernels.stream_handle(keys.device),
    )
    _build.check(code, "hist_keys")
    kernels.LAUNCHES["hist_keys"] += 1
    return hist


def histogram_from_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Backend-dispatching K3a."""
    if config.use_kernel(keys):
        return histogram_from_keys_kernel(keys.reshape(-1).to(torch.int32).contiguous(), k)
    return histogram_from_keys_torch(keys, k)


# -- K3b: histogram straight from packed words ----------------------------------


def histogram_from_words_torch(
    words: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = False
) -> torch.Tensor:
    """Plain version of K3b: the dense histogram of a packed batch, [B, W]
    words + [B] lengths -> [4^k] int32; canonical=True counts
    min(key, revcomp(key))."""
    _check_dense_k(k)
    lo, _, valid = _window_keys(words, lengths, k, canonical)
    return histogram_from_keys_torch(torch.where(valid, lo, 4**k), k)


def histogram_from_words_kernel(
    words: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = False
) -> torch.Tensor:
    """K3b on the card (``csrc/histogram.cu``)."""
    _check_dense_k(k)
    kernels.require(words, "hist_words words", torch.int32, 2)
    kernels.require(lengths, "hist_words lengths", torch.int32, 1)
    B, W = words.shape
    if lengths.shape[0] != B or lengths.device != words.device:
        raise ValueError("hist_words: lengths must be [B] on the device of the words")
    hist = torch.zeros(4**k, dtype=torch.int32, device=words.device)
    code = _build.library().bn_hist_words(
        words.data_ptr(), lengths.data_ptr(), B, W, k, int(canonical), hist.data_ptr(),
        kernels.stream_handle(words.device),
    )
    _build.check(code, "hist_words")
    kernels.LAUNCHES["hist_words"] += 1
    return hist


def histogram_from_words(
    words: torch.Tensor, lengths: torch.Tensor, k: int, canonical: bool = False
) -> torch.Tensor:
    """Backend-dispatching K3b over [..., W] words."""
    if config.use_kernel(words):
        W = words.shape[-1]
        return histogram_from_words_kernel(
            words.reshape(-1, W).contiguous(),
            lengths.to(torch.int32).reshape(-1).contiguous(),
            k,
            canonical,
        )
    return histogram_from_words_torch(words, lengths, k, canonical)


# -- counting -------------------------------------------------------------------


def count_kmers_dense(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> torch.Tensor:
    """Dense k-mer histogram over a batch: [..., W] words -> [4^k] int32;
    bin i counts the windows whose packed value is i. k <= MAX_DENSE_K.
    Without base_valid the keys are made in K3b, canonical or not; with it
    they are made here and counted by K3a."""
    _check_dense_k(k)
    if base_valid is None:
        return histogram_from_words(words, lengths, k, canonical)
    lo, _, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return histogram_from_keys(torch.where(valid, lo, 4**k), k)


# -- sort-based counting, any k <= 32 ------------------------------------------


def _run_starts(*cols: torch.Tensor) -> torch.Tensor:
    """[N] bool over sorted rows: True at row 0 and wherever any column
    differs from the row before."""
    first = torch.zeros(cols[0].shape[0], dtype=torch.bool, device=cols[0].device)
    first[:1] = True
    for c in cols:
        first[1:] |= c[1:] != c[:-1]
    return first


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """out[i] = min(x[i:])."""
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def _sort_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit-views sorted in uint32 order."""
    return bitops.flip_sign(torch.sort(bitops.flip_sign(x)).values)


def _sort_pairs(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) pairs sorted in unsigned (hi, lo) order, without payloads."""
    v = torch.sort(bitops.u64_sort_key(hi, lo)).values
    return bitops.flip_sign((v >> 32).to(torch.int32)), v.to(torch.int32)


def _add_at(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
    """x[i] += v in place for a 0-d index tensor, with no host sync."""
    x.index_add_(0, i.reshape(1).to(torch.int64), v.reshape(1).to(x.dtype))


def segment_count(hi_s: torch.Tensor, lo_s: torch.Tensor, w_s: torch.Tensor):
    """Aggregate sorted (hi, lo) key pairs into unique keys + summed weights.

    Returns (u_lo, u_hi, counts, n_unique) in the count_kmers_sorted layout;
    the trailing segment leaves n_unique when its weight is 0 (the
    all-invalid sentinel run: a real key's segment always weighs > 0)."""
    N = lo_s.shape[0]
    first = _run_starts(lo_s, hi_s)
    seg = torch.cumsum(first, 0) - 1
    counts = torch.zeros(N, dtype=torch.int32, device=lo_s.device)
    counts.index_add_(0, seg, w_s.to(torch.int32))
    # every row of a segment holds its key, so colliding writes agree
    u_lo = torch.zeros_like(lo_s).scatter_(0, seg, lo_s)
    u_hi = torch.zeros_like(hi_s).scatter_(0, seg, hi_s)
    last = seg[-1]
    n_unique = (last + 1 - (counts[last] == 0).to(torch.int64)).to(torch.int32)
    return u_lo, u_hi, counts, n_unique


def sorted_count_from_keys(
    lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor, k: int
):
    """Sort-count raw window keys: the body of count_kmers_sorted."""
    n_invalid = (~valid).sum(dtype=torch.int32)
    if k <= 15:
        # one word with headroom (4^15 - 1 < 2^32 - 1): invalid slots take
        # the sentinel, sort last, and their count is subtracted
        keys_s = _sort_u32(torch.where(valid, lo, SENT).reshape(-1))
        N = keys_s.shape[0]
        seg = torch.cumsum(_run_starts(keys_s), 0) - 1
        counts = torch.zeros(N, dtype=torch.int32, device=keys_s.device)
        counts.index_add_(0, seg, torch.ones_like(keys_s))
        u_lo = torch.zeros_like(keys_s).scatter_(0, seg, keys_s)
        last = seg[-1]
        has_sent = keys_s[-1] == SENT
        _add_at(counts, last, torch.where(has_sent, -n_invalid, 0))
        _add_at(u_lo, last, torch.where(has_sent, -u_lo[last], 0))
        n_unique = (last + 1 - has_sent.to(torch.int64)).to(torch.int32)
        return u_lo, torch.zeros_like(u_lo), counts, n_unique
    # k >= 16: pair sort; the weights tell the genuine all-T key from the
    # sentinel (equal at k = 32)
    lo = torch.where(valid, lo, SENT).reshape(-1)
    hi = torch.where(valid, hi, SENT).reshape(-1)
    perm = torch.sort(bitops.u64_sort_key(hi, lo)).indices
    return segment_count(hi[perm], lo[perm], valid.reshape(-1)[perm])


def count_kmers_sorted(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = False,
    base_valid=None,
):
    """Sort-based k-mer counting for any k <= 32.

    Returns (keys_lo [N], keys_hi [N], counts [N] int32, n_unique 0-d
    int32), N = window slots: rows [0, n_unique) are the distinct k-mers
    ascending by unsigned (hi, lo) with their counts; the tail is zero."""
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return sorted_count_from_keys(lo, hi, valid, k)


def _run_start_counts(first: torch.Tensor) -> torch.Tensor:
    """Run lengths at run starts (0 elsewhere) for a boundary mask over a
    sorted array: the next boundary comes from one reverse cummin."""
    N = first.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=first.device)
    nb = _rev_cummin(torch.where(first, idx, N))
    nb_excl = torch.cat([nb[1:], nb.new_full((1,), N)])
    return torch.where(first, nb_excl - idx, 0)


def runs_from_keys(lo: torch.Tensor, hi: torch.Tensor, valid: torch.Tensor, k: int):
    """Sort-count raw window keys into the run-start layout.

    Returns (lo_s [N], hi_s [N], counts [N], n_unique): keys ascending by
    unsigned (hi, lo); counts[i] is the key's multiplicity at the first row
    of its run and 0 elsewhere; sentinel (invalid) rows sort last with
    count 0. At k = 32 the all-T key equals the sentinel, so the invalid
    count is subtracted from the final run instead of carried as weights."""
    n_invalid = (~valid).sum(dtype=torch.int32)
    if k <= 15:
        lo_s = _sort_u32(torch.where(valid, lo, SENT).reshape(-1))
        hi_s = torch.zeros_like(lo_s)
        first = _run_starts(lo_s)
        is_sent = lo_s[-1] == SENT
    else:
        hi_s, lo_s = _sort_pairs(
            torch.where(valid, hi, SENT).reshape(-1),
            torch.where(valid, lo, SENT).reshape(-1),
        )
        first = _run_starts(lo_s, hi_s)
        is_sent = (lo_s[-1] == SENT) & (hi_s[-1] == SENT)
    counts = _run_start_counts(first)
    idx = torch.arange(counts.shape[0], dtype=torch.int32, device=counts.device)
    last_start = torch.where(first, idx, -1).max()
    _add_at(counts, last_start, torch.where(is_sent, -n_invalid, 0))
    return lo_s, hi_s, counts, (counts > 0).sum(dtype=torch.int32)


def raw_window_keys(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = False,
    base_valid=None,
):
    """Unsorted flat window keys (lo [N], hi [N], weight [N] int32) of a
    packed batch: weight 1 for valid windows, 0 for invalid and padding
    slots, whose key words are garbage. The streaming accumulator's input:
    merge_sorted_runs pushes weight-0 rows to the sentinel."""
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return lo.reshape(-1), hi.reshape(-1), valid.to(torch.int32).reshape(-1)


def count_kmers_runs(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = False,
    base_valid=None,
):
    """Sort-based counting, any k <= 32, in the run-start layout (see
    runs_from_keys); the same key -> count content as count_kmers_sorted."""
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return runs_from_keys(lo, hi, valid, k)


def weighted_runs_from_sorted(hi_s: torch.Tensor, lo_s: torch.Tensor, w_s: torch.Tensor):
    """Aggregate sorted (hi, lo) keys with int32 weights into run-start
    totals, scatter- and gather-free.

    With S the exclusive prefix sum of the weights, the run starting at i
    totals S[next boundary] - S[i]; a reverse cummin of S over boundary
    rows finds S[next boundary] because S never decreases. Returns
    (lo_s, hi_s, totals, n_unique); zero-weight runs total 0."""
    first = _run_starts(lo_s, hi_s)
    w_s = w_s.to(torch.int32)
    incl = torch.cumsum(w_s, 0, dtype=torch.int32)
    S = incl - w_s
    big = 2**31 - 1
    m = _rev_cummin(torch.where(first, S, big))
    m_excl = torch.cat([m[1:], m.new_full((1,), big)])
    totals = torch.where(first, torch.minimum(m_excl, incl[-1]) - S, 0)
    return lo_s, hi_s, totals, (totals > 0).sum(dtype=torch.int32)


def merge_sorted_runs(lo: torch.Tensor, hi: torch.Tensor, counts: torch.Tensor):
    """Merge concatenated run-start lists into one run-start list: dead
    (count 0) rows go to the all-ones sentinel, then sort and aggregate."""
    counts = counts.to(torch.int32)
    dead = counts == 0
    lo = torch.where(dead, SENT, lo)
    hi = torch.where(dead, SENT, hi)
    perm = torch.sort(bitops.u64_sort_key(hi, lo), stable=True).indices
    return weighted_runs_from_sorted(hi[perm], lo[perm], counts[perm])


def pack_runs_front(lo: torch.Tensor, hi: torch.Tensor, counts: torch.Tensor):
    """Live runs (count > 0) to the front ascending by (hi, lo), dead rows
    behind them. Deadness is the primary key, so a live all-ones key (the
    k = 32 all-T k-mer) stays inside the live prefix."""
    counts = counts.to(torch.int32)
    perm = bitops.lex_argsort(
        [(counts == 0).to(torch.int32), bitops.u64_sort_key(hi, lo)]
    )
    return lo[perm], hi[perm], counts[perm]


def compact_live(lo: torch.Tensor, hi: torch.Tensor, counts: torch.Tensor, n_rows: int):
    """The first ``n_rows`` rows of: live rows (count > 0) ascending by
    unsigned (hi, lo), then dead rows under the all-ones sentinel key. The
    negated counts break the sentinel tie, so a live all-ones key (the
    k = 32 all-T k-mer) stays ahead of every dead row."""
    dead = counts <= 0
    hi_c = torch.where(dead, SENT, hi)
    lo_c = torch.where(dead, SENT, lo)
    perm = bitops.lex_argsort([bitops.u64_sort_key(hi_c, lo_c), -counts])[:n_rows]
    return lo_c[perm], hi_c[perm], counts[perm]


def compact_runs(lo: torch.Tensor, hi: torch.Tensor, counts: torch.Tensor):
    """Host helper: run-start layout -> numpy (keys_lo uint32, keys_hi
    uint32, counts int32) of just the distinct k-mers, ascending."""
    counts = counts.detach().cpu().numpy()
    m = counts > 0
    return bitops.words_to_u32_np(lo)[m], bitops.words_to_u32_np(hi)[m], counts[m]


def count_kmers_reads(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    mode: str = "auto",
    canonical: bool = False,
    base_valid=None,
):
    """Count k-mers over a batch of packed reads.

    mode 'dense' returns the [4^k] int32 histogram (count_kmers_dense,
    k <= MAX_DENSE_K); 'sorted' the compacted (lo, hi, counts, n_unique)
    of count_kmers_sorted; 'runs' the same content in the run-start layout
    (count_kmers_runs). 'auto' and 'auto_layout' are dense for
    k <= MAX_DENSE_K and runs above (the JAX package hands k = 9..12 to the
    runs engine under 'auto_layout' on a TPU only). canonical=True counts
    min(kmer, revcomp(kmer)); base_valid [B, L] bool drops every window
    holding an invalid base."""
    if mode in ("auto", "auto_layout"):
        mode = "runs" if k > MAX_DENSE_K else "dense"
    if mode == "dense":
        return count_kmers_dense(words, lengths, k, canonical, base_valid)
    if mode == "sorted":
        return count_kmers_sorted(words, lengths, k, canonical, base_valid)
    if mode == "runs":
        return count_kmers_runs(words, lengths, k, canonical, base_valid)
    raise ValueError(f"unknown mode {mode!r}")


# -- minimizers (the mapper's seeds) -----------------------------------------
#
# Keys are int32 views; the sentinel 0xFFFFFFFF reads as -1, so every key
# comparison below is made on flip_sign'ed words, where signed order is the
# uint32 order and the sentinel is the largest key (at k = 16 the all-T key
# equals it, as in the JAX package).


_POS_FILL = 2**30  # position fill past the end of a row, as in the JAX package


def _argmin_doubling(cols, w: int, fills):
    """Sliding lexicographic min of the tuple ``cols`` (signed order, the
    last column a position) over each w-window, by log-step doubling."""

    def combine(a, b):
        take2 = torch.zeros_like(a[0], dtype=torch.bool)
        tie = torch.ones_like(take2)
        for x, y in zip(a, b):
            take2 = take2 | (tie & (y < x))
            tie = tie & (y == x)
        return tuple(torch.where(take2, y, x) for x, y in zip(a, b))

    def shifted(c, m):
        return tuple(_shift_tail(x, m, f) for x, f in zip(c, fills))

    pows = {1: tuple(cols)}
    m = 1
    while 2 * m <= w:
        pows[2 * m] = combine(pows[m], shifted(pows[m], m))
        m *= 2
    return combine(pows[m], shifted(pows[m], w - m))


def _positions(shape, device) -> torch.Tensor:
    L = shape[-1]
    return torch.arange(L, dtype=torch.int32, device=device).expand(shape).contiguous()


def _sliding_argmin(keys: torch.Tensor, w: int, fill) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min value, GLOBAL position of the leftmost min) over each w-window
    of int32-view keys compared as unsigned; ``fill`` past the row end."""
    if w < 1:
        raise ValueError(f"w must be >= 1, got {w}")
    f = bitops.flip_sign
    v, p = _argmin_doubling(
        (f(keys), _positions(keys.shape, keys.device)), w,
        (fill ^ bitops.SIGN_BIT, _POS_FILL),
    )
    return f(v), p


def _sliding_argmin2(hi: torch.Tensor, lo: torch.Tensor, w: int, fill):
    """(min hi, min lo, GLOBAL position of the leftmost min) per w-window
    under unsigned lexicographic (hi, lo, pos) order."""
    if w < 1:
        raise ValueError(f"w must be >= 1, got {w}")
    f = bitops.flip_sign
    ff = fill ^ bitops.SIGN_BIT
    h, l, p = _argmin_doubling(
        (f(hi), f(lo), _positions(hi.shape, hi.device)), w, (ff, ff, _POS_FILL)
    )
    return f(h), f(l), p


def minimizer_positions(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    w: int,
    canonical: bool = False,
    base_valid=None,
):
    """(w,k)-minimizers with positions, k <= 16: (vals [..., L], positions
    [..., L] int32, valid [..., L] bool). Window p covers the k-mers at
    p..p+w-1 and is valid iff p + k + w - 1 <= length and some k-mer in
    it is valid; vals is the sentinel and positions -1 elsewhere.
    base_valid masks k-mers touching an invalid base out of selection."""
    if not 1 <= k <= 16:
        raise ValueError(f"minimizer keys are one word (1 <= k <= 16), got {k}")
    lo, _, valid_k = _window_keys(words, lengths, k, canonical, base_valid)
    keys = torch.where(valid_k, lo, SENT)
    vals, pos = _sliding_argmin(keys, w, SENT)
    L = keys.shape[-1]
    p_idx = torch.arange(L, dtype=torch.int32, device=keys.device)
    valid = p_idx <= (lengths.to(torch.int32)[..., None] - (k + w - 1))
    valid = valid & (vals != SENT)
    return torch.where(valid, vals, SENT), torch.where(valid, pos, -1), valid


def minimizer_positions64(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    w: int,
    canonical: bool = False,
    base_valid=None,
):
    """minimizer_positions with (lo, hi) pair keys, k <= 31 (the all-T
    32-mer equals the sentinel pair): (lo, hi, positions, valid)."""
    if not 1 <= k <= 31:
        raise ValueError(f"minimizer keys must leave sentinel headroom (1 <= k <= 31), got {k}")
    lo, hi, valid_k = _window_keys(words, lengths, k, canonical, base_valid)
    lo = torch.where(valid_k, lo, SENT)
    hi = torch.where(valid_k, hi, SENT)
    hi_m, lo_m, pos = _sliding_argmin2(hi, lo, w, SENT)
    L = lo.shape[-1]
    p_idx = torch.arange(L, dtype=torch.int32, device=lo.device)
    valid = p_idx <= (lengths.to(torch.int32)[..., None] - (k + w - 1))
    valid = valid & ((hi_m != SENT) | (lo_m != SENT))
    return (
        torch.where(valid, lo_m, SENT),
        torch.where(valid, hi_m, SENT),
        torch.where(valid, pos, -1),
        valid,
    )


# -- minimizers and sketches -------------------------------------------------------


def _sliding_min(keys: torch.Tensor, w: int, fill) -> torch.Tensor:
    """out[..., p] = unsigned min(keys[..., p : p + w]), ``fill`` past the
    row end (the doubling scheme of _argmin_doubling, value only)."""
    assert w >= 1
    f = bitops.flip_sign
    (v,) = _argmin_doubling((f(keys),), w, (fill ^ bitops.SIGN_BIT,))
    return f(v)


def _sliding_min2(hi: torch.Tensor, lo: torch.Tensor, w: int, fill):
    """Unsigned lexicographic (hi, lo) sliding minimum over each w-window:
    (min hi, min lo)."""
    assert w >= 1
    f = bitops.flip_sign
    ff = fill ^ bitops.SIGN_BIT
    h, l = _argmin_doubling((f(hi), f(lo)), w, (ff, ff))
    return f(h), f(l)


def minimizers(words: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
               canonical: bool = False):
    """(w,k)-minimizers, k <= 16: (vals [..., L] int32 views, valid [..., L]
    bool). Position p holds the unsigned min of the k-mers at p..p+w-1,
    valid iff p + k + w - 1 <= length; the sentinel elsewhere."""
    assert 1 <= k <= 16, "minimizer keys are u32 (k <= 16)"
    lo, _, valid_k = _window_keys(words, lengths, k, canonical)
    vals = _sliding_min(torch.where(valid_k, lo, SENT), w, SENT)
    valid = window_valid_mask(lo.shape[-1], lengths, k + w - 1)  # the window's last k-mer fits
    return torch.where(valid, vals, SENT), valid


def minimizer_sketch(words: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                     canonical: bool = False):
    """The distinct (w,k)-minimizer values of a batch, ascending: (vals [N]
    int32 views, n_unique 0-d int32); entries past n_unique are the
    all-ones sentinel. k <= 15: at k = 16 the all-T key equals it."""
    assert 1 <= k <= 15, "sketch keys must leave sentinel headroom (k <= 15)"
    vals, _ = minimizers(words, lengths, k, w, canonical)
    s = _sort_u32(vals.reshape(-1))  # invalid slots are already the sentinel
    live = _run_starts(s) & (s != SENT)
    # duplicates become the sentinel; one more sort puts the distinct values first
    return _sort_u32(torch.where(live, s, SENT)), live.sum(dtype=torch.int32)


def _overlap(first: torch.Tensor, live: torch.Tensor):
    """(intersection, union) of two merged sorted-distinct sketches: a value
    in both forms a run of exactly 2."""
    counts = _run_start_counts(first)
    inter = (live & (counts == 2)).sum(dtype=torch.int32)
    return inter, live.sum(dtype=torch.int32)


def _sketch_overlap(a_vals: torch.Tensor, b_vals: torch.Tensor):
    """(intersection, union) sizes of two minimizer_sketch outputs."""
    merged = _sort_u32(torch.cat([a_vals, b_vals]))
    first = _run_starts(merged)
    return _overlap(first, first & (merged != SENT))


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """float32 num / den, 0.0 where den is 0."""
    q = num.to(torch.float32) / torch.clamp(den, min=1).to(torch.float32)
    return torch.where(den > 0, q, torch.zeros_like(q))


def sketch_jaccard(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """Jaccard similarity |A n B| / |A u B| of two minimizer_sketch outputs
    (float32; 0.0 when both are empty)."""
    inter, union = _sketch_overlap(a_vals, b_vals)
    return _ratio(inter, union)


def sketch_containment(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """Containment |A n B| / |A| of sketch A within sketch B (float32; 0.0
    for an empty A)."""
    inter, _ = _sketch_overlap(a_vals, b_vals)
    return _ratio(inter, (a_vals != SENT).sum(dtype=torch.int32))


def minimizers64(words: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                 canonical: bool = False):
    """(w,k)-minimizers with (lo, hi) pair keys, k <= 31, unsigned
    lexicographic (hi, lo) minima: (lo [..., L], hi [..., L], valid [...,
    L]); invalid slots hold the sentinel in both words."""
    assert 1 <= k <= 31, "minimizer keys must leave sentinel headroom"
    lo, hi, valid_k = _window_keys(words, lengths, k, canonical)
    hi_m, lo_m = _sliding_min2(torch.where(valid_k, hi, SENT), torch.where(valid_k, lo, SENT),
                               w, SENT)
    valid = window_valid_mask(lo.shape[-1], lengths, k + w - 1)
    valid = valid & ((hi_m != SENT) | (lo_m != SENT))
    return torch.where(valid, lo_m, SENT), torch.where(valid, hi_m, SENT), valid


def minimizer_sketch64(words: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                       canonical: bool = False):
    """minimizer_sketch with pair keys, k <= 31: (lo [N], hi [N], n_unique),
    the distinct keys ascending by unsigned (hi, lo), then the sentinel
    pair."""
    assert 1 <= k <= 31, "sketch keys must leave sentinel headroom (k <= 31)"
    lo_m, hi_m, _ = minimizers64(words, lengths, k, w, canonical)
    hi_s, lo_s = _sort_pairs(hi_m.reshape(-1), lo_m.reshape(-1))
    live = _run_starts(hi_s, lo_s) & ((hi_s != SENT) | (lo_s != SENT))
    hi_c, lo_c = _sort_pairs(torch.where(live, hi_s, SENT), torch.where(live, lo_s, SENT))
    return lo_c, hi_c, live.sum(dtype=torch.int32)


def _sketch_overlap64(a_lo, a_hi, b_lo, b_hi):
    """(intersection, union) of two minimizer_sketch64 outputs."""
    hi, lo = _sort_pairs(torch.cat([a_hi, b_hi]), torch.cat([a_lo, b_lo]))
    first = _run_starts(hi, lo)
    return _overlap(first, first & ((hi != SENT) | (lo != SENT)))


def sketch_jaccard64(a_lo, a_hi, b_lo, b_hi) -> torch.Tensor:
    """Jaccard similarity of two minimizer_sketch64 outputs (float32)."""
    inter, union = _sketch_overlap64(a_lo, a_hi, b_lo, b_hi)
    return _ratio(inter, union)


def sketch_containment64(a_lo, a_hi, b_lo, b_hi) -> torch.Tensor:
    """Containment |A n B| / |A| of 64-bit sketch A within B (float32)."""
    inter, _ = _sketch_overlap64(a_lo, a_hi, b_lo, b_hi)
    return _ratio(inter, ((a_hi != SENT) | (a_lo != SENT)).sum(dtype=torch.int32))


def minimizer_sketch_mask(positions: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """True where a valid window's minimizer position differs from the
    previous window's: one selected window per minimizer occurrence."""
    prev = torch.cat(
        [torch.full_like(positions[..., :1], -2), positions[..., :-1]], dim=-1
    )
    return valid & (positions != prev)


def top_kmers(hist: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts, packed k-mer values) of the n most frequent k-mers,
    descending, ties by lowest key; past the histogram's size the tail is
    (count=-2^30, key=-1)."""
    from .hamming import topk_smallest

    neg, keys = topk_smallest(-hist.to(torch.int32), n)
    return -neg, keys


def spectrum(counts: torch.Tensor, max_mult: int = 255) -> torch.Tensor:
    """K-mer abundance spectrum: out[m] = number of distinct k-mers seen
    exactly m times (1 <= m < max_mult); out[max_mult] pools every k-mer at
    or above max_mult; out[0] is 0. Zero entries are ignored, so any
    counting layout works."""
    if not 1 <= max_mult <= 4096:
        raise ValueError(f"max_mult must be in [1, 4096], got {max_mult}")
    c = torch.clamp(counts.reshape(-1).to(torch.int64), max=max_mult)
    c = torch.where(c > 0, c, 0)
    out = torch.bincount(c, minlength=max_mult + 1).to(torch.int32)
    out[0] = 0
    return out
