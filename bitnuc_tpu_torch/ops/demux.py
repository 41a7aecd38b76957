"""Barcode demultiplexing on packed reads.

The counterpart of ``bitnuc_tpu/ops/demux.py``. Each read's first bc_len
bases (``split.slice_reads``) are compared with every barcode by Hamming
distance (``hamming.hdist_words``, [B, 1] x [1, N]). A read is assigned
to its nearest barcode only when the best distance is within max_dist and
unique: a tie between two barcodes leaves the read unassigned.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import bitops
from . import hamming, split

_BIG = 2**30


def assign_barcodes(
    words: torch.Tensor,
    lengths: torch.Tensor,
    bc_words: torch.Tensor,
    bc_len: int,
    max_dist=1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(barcode_index [B] int32, -1 when unassigned; distance [B] int32).

    words/lengths: packed reads; bc_words: [N, Wb] packed barcodes of
    bc_len bases each (int32 bit-views). A read's first bc_len bases are
    compared. Reads shorter than bc_len are unassigned with distance
    bc_len. max_dist may be a tensor."""
    dev = words.device
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    Wb = bitops.n_words_for(bc_len)
    head, _ = split.slice_reads(words, lengths, 0, bc_len)
    head = head[:, :Wb]
    bc = torch.as_tensor(bc_words, device=dev).to(torch.int32)[:, :Wb]
    d = hamming.hdist_words(head[:, None, :], bc[None, :, :], bc_len)  # [B, N]
    best = d.amin(1)
    at_best = d == best[:, None]
    n_best = at_best.sum(1, dtype=torch.int32)
    ids = torch.arange(d.shape[1], dtype=torch.int32, device=dev)
    idx = torch.where(at_best, ids, _BIG).amin(1)
    too_short = lengths < bc_len
    max_dist = torch.as_tensor(max_dist, device=dev).to(torch.int32)
    ok = (best <= max_dist) & (n_best == 1) & ~too_short
    return torch.where(ok, idx, -1), torch.where(too_short, bc_len, best)
