"""Sequence analytics computed directly on packed words.

The counterpart of ``bitnuc_tpu/ops/analysis.py`` (``windowed_gc`` is a
later port). With A=00 C=01 G=10 T=11, per word:

  lo = word & 0x5555...   (low bit of each 2-bit group)
  hi = (word >> 1) & 0x5555...
  T = popcount(lo & hi); C = popcount(lo) - T; G = popcount(hi) - T
  A = length - C - G - T
"""

from __future__ import annotations

import torch

from ..utils import bitops


def base_counts_reads(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Counts of A,C,G,T per read: [..., W] words -> [..., 4] int32."""
    W = words.shape[-1]
    lengths = lengths.to(torch.int32)
    valid = bitops.word_valid_mask(W, lengths)
    lo = words & bitops.LOWER_BITS_32 & valid
    hi = (words >> 1) & bitops.LOWER_BITS_32 & valid

    t = bitops.popcount32(lo & hi).sum(-1, dtype=torch.int32)
    c = bitops.popcount32(lo).sum(-1, dtype=torch.int32) - t
    g = bitops.popcount32(hi).sum(-1, dtype=torch.int32) - t
    a = lengths - c - g - t
    return torch.stack([a, c, g, t], dim=-1)


def gc_content_reads(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """GC percentage (0-100) per read as float32, 0.0 for empty reads.

    Computed in float32 in the JAX package's order of operations,
    (C + G) / max(len, 1) * 100, so the two agree bit for bit."""
    counts = base_counts_reads(words, lengths)
    lengths = lengths.to(torch.int32)
    gc = (counts[..., 1] + counts[..., 2]).to(torch.float32)
    denom = torch.clamp(lengths, min=1).to(torch.float32)
    pct = gc / denom * 100.0
    return torch.where(lengths > 0, pct, torch.zeros_like(pct))
