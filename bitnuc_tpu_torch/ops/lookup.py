"""K-mer table lookup: per-window counts of query k-mers in a counted list.

The counterpart of ``bitnuc_tpu/ops/lookup.py``: read screening
(containment of a read's k-mers in a reference table), spectrum trimming
and the lookups of ``ops.correct``, over the counted-list layout the
counting engines emit (``count_kmers_sorted``, ``count_kmers_runs``,
``merge_sorted_runs``, or a host table through ``table_from_dense`` /
``table_from_dict``).

The JAX package sorts the table together with the queries and sorts the
answers back, because the TPU serializes gathers. Here the table is
prepared once (``_prepare``): each row keyed by one int64 whose signed
order is the unsigned (hi, lo) order (``bitops.u64_sort_key``), sorted,
and every row handed its key's summed count. Queries are answered by
``torch.searchsorted`` and an equality check, so the queries are never
sorted and duplicate queries all read the same row.

Semantics kept from the JAX package: table rows with a count <= 0 weigh
nothing, a key in several positive rows answers with the sum of their
counts, an invalid query answers 0, and answers are int32 (a table's
total count stays below 2^31, as for the counting engines).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import config
from ..utils import bitops
from .kmer import _run_starts, _window_keys


class _Table(NamedTuple):
    """A counted list ready for lookups: sorted int64 keys [N] and, on
    every row, the summed count of its key [N] int32."""

    keys: torch.Tensor
    totals: torch.Tensor


def _prepare(t_lo, t_hi, t_ct, device=None) -> _Table:
    """Sort a counted list by key and sum the counts of equal keys; rows
    with a count <= 0 add nothing (their key may still appear, at 0)."""
    t_lo = torch.as_tensor(t_lo, device=device)
    dev = t_lo.device
    t_hi = torch.as_tensor(t_hi, device=dev)
    t_ct = torch.as_tensor(t_ct, device=dev).to(torch.int32)
    key = bitops.u64_sort_key(t_hi.to(torch.int32), t_lo.to(torch.int32)).reshape(-1)
    if key.numel() == 0:
        return _Table(key, torch.zeros(0, dtype=torch.int32, device=dev))
    w = torch.where(t_ct > 0, t_ct, 0).reshape(-1).to(torch.int64)
    keys_s, perm = torch.sort(key)
    seg = torch.cumsum(_run_starts(keys_s), 0) - 1
    sums = torch.zeros(keys_s.shape[0], dtype=torch.int64, device=dev)
    sums.index_add_(0, seg, w[perm])
    return _Table(keys_s, sums[seg].to(torch.int32))


def _lookup_prepared(table: _Table, q_lo, q_hi, q_valid) -> torch.Tensor:
    """Per-query counts against a prepared table (see ``lookup_counts``)."""
    q_lo = torch.as_tensor(q_lo)
    dev = q_lo.device
    q_hi = torch.as_tensor(q_hi, device=dev)
    q_valid = torch.as_tensor(q_valid, device=dev).to(torch.bool)
    qkey = bitops.u64_sort_key(q_hi.to(torch.int32), q_lo.to(torch.int32))
    N = table.keys.shape[0]
    if N == 0:
        return torch.zeros(qkey.shape, dtype=torch.int32, device=dev)
    idx = torch.clamp(torch.searchsorted(table.keys, qkey), max=N - 1)
    hit = q_valid & (table.keys[idx] == qkey)
    return torch.where(hit, table.totals[idx], 0)


def lookup_counts(q_lo, q_hi, q_valid, t_lo, t_hi, t_ct) -> torch.Tensor:
    """Per-query table counts: out[i] = table count of query key i (0 when
    absent or q_valid[i] is False).

    q_lo/q_hi: [Nq] int32 bit-views of the packed query keys (lo = bits
    [0, 32), hi = bits [32, 64)); q_valid: [Nq] bool. t_lo/t_hi/t_ct: a
    counted list; rows with t_ct > 0 are the table's keys, and a key in
    several positive rows answers with the sum of their counts. Returns
    [Nq] int32 on the queries' device."""
    q_lo = torch.as_tensor(q_lo)
    return _lookup_prepared(_prepare(t_lo, t_hi, t_ct, q_lo.device), q_lo, q_hi, q_valid)


def kmer_hits_reads(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    t_lo,
    t_hi,
    t_ct,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Table count of every k-mer window of a packed read batch.

    Returns (counts [B, L] int32, valid [B, L] bool): counts[b, p] is the
    table count of read b's window starting at base p (0 at invalid and
    out-of-range windows). Window keys and validity are the counting
    engines' own (``kmer._window_keys``)."""
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    ans = lookup_counts(lo.reshape(-1), hi.reshape(-1), valid.reshape(-1), t_lo, t_hi, t_ct)
    return ans.reshape(lo.shape), valid


def screen_reads(
    words: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    t_lo,
    t_hi,
    t_ct,
    min_count: int = 1,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-read containment in a counted k-mer table: (n_windows [B] int32,
    n_solid [B] int32), the valid windows and how many of them have a
    table count >= min_count."""
    counts, valid = kmer_hits_reads(
        words, lengths, k, t_lo, t_hi, t_ct, canonical=canonical, base_valid=base_valid
    )
    n_windows = valid.sum(-1, dtype=torch.int32)
    n_solid = (valid & (counts >= min_count)).sum(-1, dtype=torch.int32)
    return n_windows, n_solid


def solid_prefix_len(
    counts: torch.Tensor,
    valid: torch.Tensor,
    lengths: torch.Tensor,
    k: int,
    min_count: int = 1,
) -> torch.Tensor:
    """Spectrum-trimming lengths: the longest prefix of each read whose
    k-mer windows are all solid (table count >= min_count).

    counts/valid: [B, L] from kmer_hits_reads. Returns [B] int32: the full
    length when no window is weak (a read shorter than k included), 0 when
    the first weak window is window 0, else first_weak + k - 1, at most the
    length."""
    lengths = torch.as_tensor(lengths, device=counts.device).to(torch.int32)
    weak = valid & (counts < min_count)
    L = counts.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=counts.device)
    first_weak = torch.where(weak, pos, L).amin(-1)
    any_weak = weak.any(-1)
    trimmed = torch.where(first_weak > 0, first_weak + (k - 1), 0)
    return torch.where(any_weak, torch.minimum(trimmed, lengths), lengths)


def _to_device(keys: np.ndarray, ct: np.ndarray, device):
    dev = config.resolve_device(device)
    lo = bitops.words_from_u32_np((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = bitops.words_from_u32_np((keys >> np.uint64(32)).astype(np.uint32))
    ct = torch.from_numpy(np.minimum(ct, 2**31 - 1).astype(np.int32))
    return lo.to(dev), hi.to(dev), ct.to(dev)


def table_from_dense(hist, device=None):
    """Host adapter: a dense 4^k histogram (numpy or a tensor) -> the
    counted list (lo, hi, ct) of its nonzero bins, on ``device``."""
    h = hist.detach().cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    keys = np.nonzero(h)[0].astype(np.uint64)
    return _to_device(keys, h[keys.astype(np.int64)], device)


def table_from_dict(counts: dict, device=None):
    """Host adapter: {packed_key: count} (the large-k pipeline's layout) ->
    the counted list (lo, hi, ct), on ``device``."""
    keys = np.fromiter(counts.keys(), np.uint64, len(counts))
    vals = np.fromiter(counts.values(), np.int64, len(counts))
    return _to_device(keys, vals, device)
