"""Packed-domain split, slice and random access, batched.

The counterpart of ``bitnuc_tpu/ops/split.py``. A funnel shift over the
words relocates any packed substream to bit origin in O(W) gathers and
shifts, with per-read offsets. Words are int32 bit-views, so the shift
toward the origin is ``bitops.srl``, not ``>>`` (arithmetic on int32).
Like the JAX package, split uses the correct funnel, not the reference
crate's carry from the wrong side for multi-word unaligned splits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import bitops


def _per_read(x, lengths: torch.Tensor) -> torch.Tensor:
    """A scalar or per-read int as an int32 tensor of ``lengths``' shape."""
    t = torch.as_tensor(x, dtype=torch.int32, device=lengths.device)
    return torch.broadcast_to(t, lengths.shape)


def _floor16(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n // 16, n % 16) with Python's floor semantics, as jnp's."""
    return torch.div(n, 16, rounding_mode="floor"), torch.remainder(n, 16)


def shift_reads_down(words: torch.Tensor, n_bases) -> torch.Tensor:
    """Shift each read's packed stream toward the origin by n_bases bases.

    words: [..., W] int32 words; n_bases: a scalar or [...] ints (>= 0).
    Base i of the result is base i + n_bases of the input; vacated high
    positions are zero."""
    W = words.shape[-1]
    n = torch.broadcast_to(
        torch.as_tensor(n_bases, dtype=torch.int32, device=words.device), words.shape[:-1]
    )
    q, r = _floor16(n)
    s = (2 * r)[..., None]  # bits
    idx = torch.arange(W, dtype=torch.int32, device=words.device)
    i0 = idx + q[..., None]

    def gather(i):
        g = torch.gather(words, -1, torch.clamp(i, 0, max(W - 1, 0)).to(torch.int64))
        return torch.where(i < W, g, 0)

    src0, src1 = gather(i0), gather(i0 + 1)
    # s == 0 would shift by 32: select src0 there instead
    hi = src1 << torch.where(s == 0, 0, 32 - s)
    funnel = bitops.srl(src0, s) | hi
    return torch.where(s == 0, src0, funnel)


def split_reads(words: torch.Tensor, lengths: torch.Tensor, idx):
    """Split each packed read at base ``idx`` (a scalar or per read).

    Returns (left, right) words of the input's shape: left keeps bases
    [0, idx) in place, zero past idx; right holds bases [idx, length)
    moved to the origin."""
    W = words.shape[-1]
    lengths = lengths.to(torch.int32)
    idx = _per_read(idx, lengths)
    left = words & bitops.word_valid_mask(W, idx)
    right = shift_reads_down(words, idx) & bitops.word_valid_mask(
        W, torch.clamp(lengths - idx, min=0)
    )
    return left, right


def slice_reads(words: torch.Tensor, lengths: torch.Tensor, start, size):
    """Bases [start, start + size) of each read as packed words at the
    origin; start and size are scalars or per read. Returns (words [..., W],
    out_lengths [...]) with out_lengths = clip(min(size, length - start), 0)."""
    W = words.shape[-1]
    lengths = lengths.to(torch.int32)
    start, size = _per_read(start, lengths), _per_read(size, lengths)
    out_len = torch.clamp(torch.minimum(size, lengths - start), min=0)
    shifted = shift_reads_down(words, start)
    return shifted & bitops.word_valid_mask(W, out_len), out_len


def get_reads(words: torch.Tensor, lengths: torch.Tensor, index) -> torch.Tensor:
    """ASCII byte of base ``index`` of each read; 0 where index >= length.
    The JAX package's host wrappers raise for an index out of range."""
    lengths = lengths.to(torch.int32)
    index = _per_read(index, lengths)
    q, r = _floor16(index)
    w = torch.gather(words, -1, torch.clamp(q, 0, words.shape[-1] - 1).to(torch.int64)[..., None])
    code = (w[..., 0] >> (2 * r)) & 3  # masked below bit 31: exact
    return torch.where(index < lengths, bitops.code_to_ascii(code), 0).to(torch.uint8)
