"""K-mer count-set algebra: intersect / subtract / union over two counted
k-mer lists (the ``kmc_tools simple`` family).

The counterpart of ``bitnuc_tpu/ops/setops.py``. Inputs are counted lists
(lo [N], hi [N], ct [N]) of int32 bit-views where every row with ct > 0
holds a distinct packed k-mer key, ascending by unsigned (hi, lo): what
count_kmers_sorted, count_kmers_runs and merge_sorted_runs produce (their
zero rows are ignored).

Each row is tagged with its source (A live 0, B live 1, dead 2), an
all-dead suffix goes to the all-ones sentinel key, and the two lists are
MERGED on (hi, lo, src) — K7 ``merge`` on CUDA tensors, its plain version
on CPU tensors (``ops/merge.py``). Every key then sits in 1-2 adjacent rows
with A first, so the combination is a neighbour compare; a sort on
(sentinel-keyed hi, lo, -count) compacts the live results ascending. The
genuine k = 32 all-T key equals the sentinel and stays right: dead rows sort
behind live rows of the same key (src 2), and the compaction orders by
negated count.

Count semantics (KMC's):
  intersect_min: keys in both, count = min(a, b)
  subtract:      A counts minus B counts, clamped at 0 (key dropped at 0)
  union_sum:     all keys, counts added (== merge_sorted_runs content)
  union_max:     all keys, count = max(a, b)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import bitops
from . import merge
from .kmer import SENT, compact_live

MODES = ("intersect_min", "subtract", "union_sum", "union_max")


def _check_sorted(lo, hi, ct, name: str) -> None:
    """Raise unless the list is sorted by (hi, lo) through its last live
    row (an all-dead suffix may hold any keys: it goes to the sentinel)."""
    key = (bitops.words_to_u32_np(hi).astype(np.uint64) << np.uint64(32)) | (
        bitops.words_to_u32_np(lo).astype(np.uint64)
    )
    live = np.flatnonzero(ct.detach().cpu().numpy() > 0)
    end = int(live[-1]) + 1 if live.size else 0
    if end > 1 and not bool(np.all(key[1:end] >= key[: end - 1])):
        raise ValueError(
            f"combine_counts input {name} is not sorted by (hi, lo) through "
            "its live rows; the merge needs sorted inputs"
        )


def _side(hi, lo, ct, live_src: int):
    """(hi, lo, src, ct) of one input: an all-dead suffix (the rows past the
    last live one) takes the sentinel key; interior dead rows (run-start
    layout) keep their keys and ride behind their key's live rows on src 2.
    The JAX package finds the suffix with a reverse cummin; one max over the
    live rows' indices gives the same rows at a fraction of the cost on the
    card."""
    dead = ct <= 0
    idx = torch.arange(ct.shape[0], device=ct.device)
    sfx = idx > torch.where(dead, -1, idx).max() if ct.shape[0] else dead
    return (
        torch.where(sfx, SENT, hi),
        torch.where(sfx, SENT, lo),
        torch.where(dead, 2, torch.full_like(ct, live_src)),
        torch.where(dead, 0, ct),
    )


def combine_counts(
    a_lo: torch.Tensor,
    a_hi: torch.Tensor,
    a_ct: torch.Tensor,
    b_lo: torch.Tensor,
    b_hi: torch.Tensor,
    b_ct: torch.Tensor,
    mode: str = "intersect_min",
    compact: bool = True,
    validate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine two counted SORTED k-mer lists -> (lo, hi, ct, n_unique).

    Each input's live rows must ascend by unsigned (hi, lo); the merge
    relies on it, and an unsorted input gives wrong counts. validate=True
    checks both inputs on the host first and raises ValueError.

    The output has len(A) + len(B) rows. compact=True: rows
    [0, n_unique) are the distinct result keys ascending with positive
    counts, the rest all-ones keys with count 0. compact=False skips the
    compaction sort: keys still ascend, with zero-count rows among the live
    ones (the run-start convention), a legal input to further calls and to
    ops.kmer.compact_runs. n_unique is a 0-d int32 tensor."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if validate:
        for lo, hi, ct, name in ((a_lo, a_hi, a_ct, "A"), (b_lo, b_hi, b_ct, "B")):
            _check_sorted(lo, hi, ct, name)
    a_ct = a_ct.to(torch.int32)
    b_ct = b_ct.to(torch.int32)
    n_ab = a_ct.shape[0] + b_ct.shape[0]
    a_side = _side(a_hi.to(torch.int32), a_lo.to(torch.int32), a_ct, 0)
    b_side = _side(b_hi.to(torch.int32), b_lo.to(torch.int32), b_ct, 1)
    # both inputs are sorted, so the (hi, lo, src) order is a merge; the
    # padding rows carry src -1 (all ones, after every real row) and match
    # no branch below
    hi_s, lo_s, src_s, ct_s = merge.merge_sorted(a_side, b_side, n_keys=3, pad_val=(0,))

    # a live A row whose successor is a live B row with the same key holds
    # that key's (a, b) count pair; the last row wraps to the first, and
    # can never pair (a pair needs src 0 -> 1 on one key)
    def nxt(x):
        return torch.roll(x, -1)

    same_key = (hi_s == nxt(hi_s)) & (lo_s == nxt(lo_s))
    pair = same_key & (src_s == 0) & (nxt(src_s) == 1)
    consumed = torch.cat([pair.new_zeros(1), pair[:-1]])
    b_ct_here = torch.where(pair, nxt(ct_s), 0)

    if mode == "intersect_min":
        out = torch.where(pair, torch.minimum(ct_s, b_ct_here), 0)
        out = torch.where(src_s == 0, out, 0)
    elif mode == "subtract":
        out = torch.where(src_s == 0, torch.clamp(ct_s - b_ct_here, min=0), 0)
    else:
        both = ct_s + b_ct_here if mode == "union_sum" else torch.maximum(ct_s, b_ct_here)
        out = torch.where(src_s == 0, both, ct_s)
        out = torch.where((src_s == 1) & consumed, 0, out)
        out = torch.where(src_s == 2, 0, out)

    out_dead = out <= 0
    n_unique = (~out_dead).sum(dtype=torch.int32)
    if not compact:
        # merged order already ascends, with dead rows among the live ones
        return lo_s[:n_ab], hi_s[:n_ab], torch.where(out_dead, 0, out)[:n_ab], n_unique
    return (*compact_live(lo_s, hi_s, out, n_ab), n_unique)


def combine_dicts(a: dict, b: dict, mode: str = "intersect_min") -> dict:
    """Host-dict twin of combine_counts, over the {packed_kmer: count}
    tables that pipeline.count_fastq returns for large k."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "intersect_min":
        return {k: min(a[k], b[k]) for k in a.keys() & b.keys()}
    if mode == "subtract":
        out = {k: v - b.get(k, 0) for k, v in a.items()}
        return {k: v for k, v in out.items() if v > 0}
    out = dict(a)
    if mode == "union_sum":
        for k, v in b.items():
            out[k] = out.get(k, 0) + v
    else:
        for k, v in b.items():
            out[k] = max(out.get(k, 0), v)
    return out
