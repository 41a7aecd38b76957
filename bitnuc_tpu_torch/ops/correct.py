"""Spectrum-based read error correction (Lighter/BFC-style).

The counterpart of ``bitnuc_tpu/ops/correct.py``, step for step. One
round, for every read at once:

1. Look up every window's table count and mark the weak windows (valid
   and count < min_count).
2. Choose the candidate site p*: a single error at p poisons exactly the
   valid windows [p - k + 1, p], so if a valid window follows the last
   weak window wl the error is at wl; else if one precedes the first weak
   window wf it is at wf + k - 1; else at the first peak of the width-k
   sliding weak coverage.
3. Make the window keys of the three substituted variants
   ((orig + 1..3) & 3 at p*).
4. Accept a variant iff every valid window covering p* becomes solid;
   among accepting variants take the highest minimum covering count, the
   first variant on ties. A read with no acceptance is left as it was.

A round fixes at most one base a read; ``correct_reads`` iterates rounds
against one prepared table (``lookup._prepare``), and stops early when a
round corrects nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import bitops
from . import lookup
from .kmer import kmer_keys, sliding_all, window_valid_mask
from .revcomp import canonical_keys

_BIG = 2**31 - 1


def _candidate_keys(codes_c: torch.Tensor, k: int, canonical: bool):
    lo, hi = kmer_keys(codes_c, k)
    if canonical:
        lo, hi = canonical_keys(lo, hi, k)
    return lo, hi


def _correct_once(table, words, lengths, k: int, min_count, canonical: bool, base_valid):
    """One round against a prepared table (see correct_reads_once)."""
    dev = words.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    min_count = torch.as_tensor(min_count, device=dev).to(torch.int32)
    codes = bitops.unpack_words(words)
    L = codes.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=dev)

    valid = window_valid_mask(L, lengths, k)
    if base_valid is not None:
        bv = torch.as_tensor(base_valid, device=dev).to(torch.bool)
        if bv.shape[-1] < L:
            bv = F.pad(bv, (0, L - bv.shape[-1]))
        valid = valid & sliding_all(bv, k)

    lo, hi = _candidate_keys(codes, k, canonical)
    counts = lookup._lookup_prepared(
        table, lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)
    ).reshape(valid.shape)
    weak = valid & (counts < min_count)

    # per-base weak coverage: cov[i] = sum of weak[w] for w in [i-k+1, i]
    c = torch.cumsum(weak.to(torch.int32), -1, dtype=torch.int32)
    keep = max(L - k, 0)  # k > L: no window fits (valid is all-False too)
    cov = c - F.pad(c[..., :keep], (L - keep, 0))
    has_weak = weak.any(-1)
    peak = cov.amax(-1)
    p_peak = torch.where(cov == peak[..., None], pos, L).amin(-1)  # first argmax
    # boundary localization (window-index space; indices are window starts)
    wl = torch.where(weak, pos, -1).amax(-1)
    wf = torch.where(weak, pos, L).amin(-1)
    lv = torch.where(valid, pos, -1).amax(-1)
    fv = torch.where(valid, pos, L).amin(-1)
    p_star = torch.where(wl < lv, wl, torch.where(wf > fv, wf + (k - 1), p_peak))

    at = pos == p_star[..., None]  # [B, L] one-hot at the candidate site
    orig = torch.where(at, codes, 0).sum(-1, dtype=torch.int32)  # [B]
    variants = torch.arange(1, 4, dtype=torch.int32, device=dev)[:, None]
    cand = (orig[None, :] + variants) & 3  # [3, B]
    codes_c = torch.where(at[None], cand[..., None], codes[None])  # [3, B, L]

    lo_c, hi_c = _candidate_keys(codes_c, k, canonical)
    covering = valid & (pos >= (p_star - (k - 1))[..., None]) & (pos <= p_star[..., None])
    cov3 = torch.broadcast_to(covering, codes_c.shape)
    counts_c = lookup._lookup_prepared(
        table, lo_c.reshape(-1), hi_c.reshape(-1), cov3.reshape(-1)
    ).reshape(codes_c.shape)

    all_solid = ~(cov3 & (counts_c < min_count)).any(-1)  # [3, B]
    min_cov = torch.where(cov3, counts_c, _BIG).amin(-1)
    score = torch.where(all_solid, min_cov, -1)
    best_score = score.amax(0)
    # the first best variant, as a masked minimum over the variant index
    idx3 = variants - 1
    best = torch.where(score == best_score, idx3, 3).amin(0)
    best_cand = torch.where(idx3 == best, cand, 0).sum(0, dtype=torch.int32)
    applied = has_weak & (best_score > 0)

    new_codes = torch.where(applied[..., None] & at, best_cand[..., None], codes)
    return bitops.pack_codes(new_codes), applied


def correct_reads_once(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    t_lo,
    t_hi,
    t_ct,
    min_count=2,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One correction round: at most one base substitution per read.

    words/lengths: packed batch [B, W]/[B]. t_lo/t_hi/t_ct: a counted-list
    k-mer table (any layout ops.lookup accepts). base_valid: optional
    [B, L] bool; invalid (e.g. N) bases never take part: windows covering
    them are neither weak nor required to become solid, and the site
    itself is never chosen. min_count (>= 1) may be a tensor.

    Returns (new_words [B, W] int32, applied [B] bool)."""
    table = lookup._prepare(t_lo, t_hi, t_ct, words.device)
    return _correct_once(table, words, lengths, k, min_count, canonical, base_valid)


def correct_reads(
    words,
    lengths,
    k: int,
    t_lo,
    t_hi,
    t_ct,
    min_count=2,
    rounds: int = 4,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterated correction: up to ``rounds`` single-base fixes per read,
    stopping early when a round corrects nothing. Returns (new_words
    [B, W] int32, n_corrected [B] int32)."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    table = lookup._prepare(t_lo, t_hi, t_ct, words.device)
    n = torch.zeros(torch.as_tensor(lengths).shape, dtype=torch.int32, device=words.device)
    for _ in range(rounds):
        words, applied = _correct_once(table, words, lengths, k, min_count, canonical,
                                       base_valid)
        n = n + applied.to(torch.int32)
        if not bool(applied.any()):
            break
    return words, n
