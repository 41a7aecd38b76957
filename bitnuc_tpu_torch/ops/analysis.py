"""Sequence analytics computed directly on packed words.

The counterpart of ``bitnuc_tpu/ops/analysis.py``. With A=00 C=01 G=10
T=11, per word:

  lo = word & 0x5555...   (low bit of each 2-bit group)
  hi = (word >> 1) & 0x5555...
  T = popcount(lo & hi); C = popcount(lo) - T; G = popcount(hi) - T
  A = length - C - G - T
"""

from __future__ import annotations

from typing import Tuple

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


def windowed_gc(
    words: torch.Tensor,
    lengths: torch.Tensor,
    window: int,
    step: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window GC percentage over packed reads or contigs, the genome
    browser's GC track: (gc_pct float32 [..., NW], valid bool [..., NW]),
    NW = (16 W - window) // step + 1. ``valid`` marks windows inside their
    sequence (start + window <= length), and the others read 0. step = 0
    means step = window.

    The GC bit of a code is lo ^ hi (C=01, G=10); its prefix sum gives each
    window's count as a difference. The percentage is float32 in the JAX
    package's order, count * float32(100 / window), so the two agree bit
    for bit."""
    step = step or window
    W = words.shape[-1]
    L = 16 * W
    if not (1 <= window <= L and step >= 1):
        raise ValueError(f"windowed_gc: need 1 <= window <= {L} and step >= 1, "
                         f"got window {window}, step {step}")
    lengths = lengths.to(torch.int32)
    codes = bitops.unpack_words(words)
    gc = (codes & 1) ^ (codes >> 1)
    pos = torch.arange(L, dtype=torch.int32, device=words.device)
    gc = torch.where(pos < lengths[..., None], gc, 0)
    c = torch.nn.functional.pad(torch.cumsum(gc, -1, dtype=torch.int32), (1, 0))
    nw = (L - window) // step + 1
    end = (nw - 1) * step + 1
    sums = c[..., window : window + end : step] - c[..., 0:end:step]
    starts = torch.arange(nw, dtype=torch.int32, device=words.device) * step
    valid = (starts + window) <= lengths[..., None]
    scale = torch.tensor(100.0 / window, dtype=torch.float32, device=words.device)
    pct = torch.where(valid, sums.to(torch.float32) * scale, 0.0)
    return pct, valid
