"""Reverse complement in the packed 2-bit domain.

The counterpart of ``bitnuc_tpu/ops/revcomp.py``. Complement is bitwise NOT
of each 2-bit group; reversal is a 2-bit-group order reversal by the swap
tree; read-level reverse complement adds a length-dependent cross-word
funnel shift. Words are int32 bit-views, so every right shift below is
either masked below bit 31 or made logical with ``bitops.srl``.
"""

from __future__ import annotations

import torch

from ..utils import bitops


def revcomp_word(w: torch.Tensor) -> torch.Tensor:
    """Reverse-complement all 16 bases of each word (base 0 <-> 15)."""
    x = ~w
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0x0000FFFF) << 16) | bitops.srl(x, 16)


def reverse_complement_reads(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse-complement each read: [..., W] words + lengths -> [..., W],
    zero past each length."""
    W = words.shape[-1]
    lengths = lengths.to(torch.int32)

    # word-reverse + per-word revcomp puts base n-1 at position 16W - n
    rc = revcomp_word(torch.flip(words, dims=(-1,)))

    # shift the packed stream down by 16W - n bases
    shift_bases = (16 * W - lengths)[..., None]
    word_shift = torch.div(shift_bases, 16, rounding_mode="floor")
    bit_shift = 2 * (shift_bases - 16 * word_shift)

    idx = torch.arange(W, dtype=torch.int32, device=words.device)
    src = (idx + word_shift).to(torch.int64)
    shape = torch.broadcast_shapes(src.shape, words.shape)
    src = src.expand(shape)

    def take(s):
        # word s of rc as the JAX package gathers it (lengths past 16W give
        # s < 0): 0 from W on, s + W for -W <= s < 0 (a wrapped index),
        # all ones below -W (the gather's fill value)
        got = torch.gather(rc, -1, torch.clamp(torch.where(s < 0, s + W, s), 0, W - 1))
        return torch.where(s >= W, 0, torch.where(s < -W, -1, got))

    cur, nxt = take(src), take(src + 1)
    lo = bitops.srl(cur, bit_shift)
    hi = torch.where(bit_shift == 0, 0, nxt << (32 - bit_shift))
    return (lo | hi) & bitops.word_valid_mask(W, lengths)


def revcomp_key(lo: torch.Tensor, hi: torch.Tensor, k: int):
    """Reverse-complement packed k-mer keys (hi<<32 | lo layout, k <= 32)."""
    if k <= 16:
        s = 32 - 2 * k
        out_lo = bitops.srl(revcomp_word(lo), s)
        return out_lo, torch.zeros_like(out_lo)
    rlo = revcomp_word(lo)  # bases 0..15 reversed into slots 15..0
    rhi = revcomp_word(hi)  # bases 16..31 reversed
    # 64-bit reverse = swap halves: r64 = rlo << 32 | rhi, then >> (64-2k)
    shift = 64 - 2 * k
    if shift == 0:
        return rhi, rlo
    out_lo = bitops.srl(rhi, shift) | (rlo << (32 - shift))
    out_hi = bitops.srl(rlo, shift)
    return out_lo, out_hi


def canonical_keys(lo: torch.Tensor, hi: torch.Tensor, k: int):
    """min(key, revcomp(key)) per window, compared as unsigned 64-bit keys
    (int32 views order correctly only after a sign-bit flip)."""
    rlo, rhi = revcomp_key(lo, hi, k)
    f = bitops.flip_sign
    take_rc = (f(rhi) < f(hi)) | ((rhi == hi) & (f(rlo) < f(lo)))
    return torch.where(take_rc, rlo, lo), torch.where(take_rc, rhi, hi)
