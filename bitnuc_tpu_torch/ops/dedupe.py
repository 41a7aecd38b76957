"""Exact-duplicate read detection over packed batches.

The counterpart of ``bitnuc_tpu/ops/dedupe.py``. A stable lexicographic
sort over (length, word columns) puts identical reads in adjacent runs;
run starts and lengths come from ``kmer._run_starts`` and
``kmer._run_start_counts``, and a scatter through the permutation returns
them to read order (the JAX package sorts back instead, because the TPU
serializes scatters). Word pairs are sorted as one int64 key each, which
halves the sorts; the order of the groups does not matter, only that
equal rows meet and keep their batch order, so the kept read of a group
is its first occurrence.

Equality is on the raw words plus the length, as in the JAX package:
words past a read's length are compared too, so their zero padding is
the caller's contract (every encoder of both packages pads with 0).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import bitops
from .kmer import _run_start_counts, _run_starts


def _row_keys(words: torch.Tensor, lengths: torch.Tensor):
    """The sort keys of each row: its length, then one int64 a word pair
    (a lone last word on its own)."""
    keys = [lengths.to(torch.int64)]
    W = words.shape[1]
    for j in range(0, W - 1, 2):
        keys.append((words[:, j + 1].to(torch.int64) << 32) | bitops.u32_sort_key(words[:, j]))
    if W % 2:
        keys.append(words[:, W - 1].to(torch.int64))
    return keys


def mark_duplicates(words: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep [R] bool, counts [R] int32) in the original read order.

    keep[i] is True iff read i is the first occurrence of its sequence;
    counts[i] is the multiplicity of that sequence at the kept read and 0
    at its duplicates. counts sums to R; keep sums to the number of
    distinct sequences."""
    R = words.shape[0]
    dev = words.device
    if R == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    keys = _row_keys(words, torch.as_tensor(lengths, device=dev))
    perm = bitops.lex_argsort(keys)
    first = _run_starts(*(k[perm] for k in keys))
    keep = torch.empty(R, dtype=torch.bool, device=dev)
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    keep[perm] = first
    counts[perm] = _run_start_counts(first)
    return keep, counts


def dedupe_reads(reads) -> Tuple[torch.Tensor, torch.Tensor]:
    """mark_duplicates over a PackedReads batch -> (keep, counts)."""
    return mark_duplicates(reads.words, reads.lengths)
