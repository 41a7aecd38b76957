"""K-mer extraction and dense counting on packed reads.

The counterpart of the dense part of ``bitnuc_tpu/ops/kmer.py``. Window p of
a read has the key sum_j code[p+j] << 2j (as_2bit of the window), split
into lo = bits [0, 32) and hi = bits [32, 64) as int32 bit-views.

Counting for k <= MAX_DENSE_K goes to a dense [4^k] int32 histogram through
one of two hand-written kernels (``csrc/histogram.cu``):

* K3b ``hist_words`` makes the window keys in the kernel from the packed
  words; it serves non-canonical counts with no ``base_valid``;
* K3a ``hist_keys`` counts window keys made here in PyTorch (canonical
  keys, N-skip masks); invalid windows carry the sentinel 4^k.

Each has its plain PyTorch version beside it, used for CPU tensors (see
``config``). The sort-based engines for k > 12 (``sorted``, ``runs``) are a
later port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

MAX_DENSE_K = 12  # 4^12 = 16.7M int32 bins = 64 MiB

_LATER = (
    "the sort-based k-mer engines (modes 'sorted' and 'runs', and 'auto' "
    "for k > 12) are not ported yet; they are the next step of the port"
)


def _shift_positions(x: torch.Tensor, m: int) -> torch.Tensor:
    """out[..., p] = x[..., p+m], zero-filled at the tail. m is static."""
    if m == 0:
        return x
    return torch.nn.functional.pad(x[..., m:], (0, m))


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
    """K3a on the card (``csrc/histogram.cu``)."""
    _check_dense_k(k)
    kernels.require(keys, "hist_keys keys", torch.int32, 1)
    hist = torch.zeros(4**k, dtype=torch.int32, device=keys.device)
    code = _build.library().bn_hist_keys(
        keys.data_ptr(), keys.numel(), k, hist.data_ptr(),
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
    words: torch.Tensor, lengths: torch.Tensor, k: int
) -> torch.Tensor:
    """Plain version of K3b: the non-canonical dense histogram of a packed
    batch, [B, W] words + [B] lengths -> [4^k] int32."""
    _check_dense_k(k)
    lo, _, valid = _window_keys(words, lengths, k, False)
    return histogram_from_keys_torch(torch.where(valid, lo, 4**k), k)


def histogram_from_words_kernel(
    words: torch.Tensor, lengths: torch.Tensor, k: int
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
        words.data_ptr(), lengths.data_ptr(), B, W, k, hist.data_ptr(),
        kernels.stream_handle(words.device),
    )
    _build.check(code, "hist_words")
    kernels.LAUNCHES["hist_words"] += 1
    return hist


def histogram_from_words(
    words: torch.Tensor, lengths: torch.Tensor, k: int
) -> torch.Tensor:
    """Backend-dispatching K3b over [..., W] words."""
    if config.use_kernel(words):
        W = words.shape[-1]
        return histogram_from_words_kernel(
            words.reshape(-1, W).contiguous(),
            lengths.to(torch.int32).reshape(-1).contiguous(),
            k,
        )
    return histogram_from_words_torch(words, lengths, k)


# -- counting -------------------------------------------------------------------


def count_kmers_dense(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> torch.Tensor:
    """Dense k-mer histogram over a batch: [..., W] words -> [4^k] int32;
    bin i counts the windows whose packed value is i. k <= MAX_DENSE_K."""
    _check_dense_k(k)
    if not canonical and base_valid is None:
        return histogram_from_words(words, lengths, k)
    lo, _, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return histogram_from_keys(torch.where(valid, lo, 4**k), k)


def count_kmers_reads(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    mode: str = "auto",
    canonical: bool = False,
    base_valid=None,
):
    """Count k-mers over a batch of packed reads.

    mode 'auto' or 'dense' with k <= MAX_DENSE_K returns the dense [4^k]
    int32 histogram (count_kmers_dense); canonical=True counts
    min(kmer, revcomp(kmer)); base_valid [B, L] bool drops every window
    holding an invalid base. The sort-based modes ('sorted', 'runs', and
    'auto' for k > 12) raise NotImplementedError for now."""
    if mode in ("sorted", "runs") or (mode == "auto" and k > MAX_DENSE_K):
        raise NotImplementedError(_LATER)
    if mode not in ("auto", "dense"):
        raise ValueError(f"unknown mode {mode!r}")
    return count_kmers_dense(words, lengths, k, canonical, base_valid)


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
