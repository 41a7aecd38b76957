"""Low-level bit utilities on int32 bit-views of packed words.

The counterpart of ``bitnuc_tpu/utils/bitops.py``. The packed layout is the
JAX package's: 2-bit codes A=00 C=01 G=10 T=11, LSB-first, 16 bases per
32-bit word, word pairs (2j, 2j+1) equal to the reference's little-endian
u64 word j.

PyTorch refuses ``>>``, ``<<``, ``min``, ``>`` and ``cummin`` on
``torch.uint32`` and has no popcount, so device words are **int32
bit-views** of the JAX package's uint32 words. Consequences kept in this
module:

* ``<<`` and ``+``/``-`` wrap in two's complement, which is the uint32 bit
  pattern;
* ``>>`` is arithmetic; ``srl`` masks it to a logical shift. Where the
  result is masked below bit 31 anyway (``(x >> s) & 3``,
  ``& 0x55555555``) the arithmetic shift is already exact;
* ``popcount32`` is SWAR;
* unsigned compares flip the sign bit (``flip_sign``).

The host helpers convert between these views and the uint32/uint64 numpy
arrays the JAX package uses.
"""

from __future__ import annotations

import numpy as np
import torch

BASES_PER_WORD = 16  # per 32-bit word

LOWER_BITS_32 = 0x55555555  # fits int32 as a positive literal
ALL_ONES = -1  # 0xFFFFFFFF as int32
SIGN_BIT = -(1 << 31)  # 0x80000000 as int32

ASCII_A, ASCII_C, ASCII_G, ASCII_T = 65, 67, 71, 84


def n_words_for(n_bases: int) -> int:
    """32-bit word count for n bases, padded to whole u64 pairs."""
    return 2 * (-(-int(n_bases) // 32))


def srl(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int32 bit-views by ``s`` (int in [0, 31], or
    an int tensor broadcastable to ``x`` with values in [0, 31])."""
    if isinstance(s, int):
        if s == 0:
            return x
        return (x >> s) & ((1 << (32 - s)) - 1)
    wide = (x.to(torch.int64) & 0xFFFFFFFF) >> s.to(torch.int64)
    return wide.to(torch.int32)


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """Map uint32 order onto int32 order: ``a <u b`` iff
    ``flip_sign(a) < flip_sign(b)``."""
    return x ^ SIGN_BIT


def ascii_to_code(ascii_u8: torch.Tensor) -> torch.Tensor:
    """Branch-free ASCII -> 2-bit code, ((b>>1) ^ (b>>2)) & 3, as int32.
    Garbage for bytes outside ACGTacgt; pair with ascii_is_valid."""
    b = ascii_u8.to(torch.int32)
    return ((b >> 1) ^ (b >> 2)) & 3


def ascii_is_valid(ascii_u8: torch.Tensor) -> torch.Tensor:
    """True where the byte is one of ACGTacgt."""
    lower = ascii_u8 | 0x20
    return (
        (lower == ord("a"))
        | (lower == ord("c"))
        | (lower == ord("g"))
        | (lower == ord("t"))
    )


def code_to_ascii(codes: torch.Tensor) -> torch.Tensor:
    """2-bit code -> uppercase ASCII (uint8)."""
    lut = torch.tensor(
        [ASCII_A, ASCII_C, ASCII_G, ASCII_T], dtype=torch.uint8, device=codes.device
    )
    return lut[codes.to(torch.int64)]


def _shifts(device, ndim: int) -> torch.Tensor:
    s = 2 * torch.arange(BASES_PER_WORD, dtype=torch.int32, device=device)
    return s.reshape((1,) * (ndim - 1) + (BASES_PER_WORD,))


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack 2-bit codes [..., L] (L a multiple of 16) into [..., L//16]
    int32 words, LSB-first. The 16 shifted codes occupy disjoint bits, so
    their wrapping int32 sum is their OR."""
    *lead, L = codes.shape
    if L % BASES_PER_WORD:
        raise ValueError(f"code length {L} is not a multiple of 16")
    c = codes.to(torch.int32).reshape(*lead, L // BASES_PER_WORD, BASES_PER_WORD)
    return (c << _shifts(c.device, c.ndim)).sum(-1, dtype=torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_codes: [..., W] words -> [..., 16W] int32 codes."""
    *lead, W = words.shape
    w = words.reshape(*lead, W, 1)
    codes = (w >> _shifts(w.device, w.ndim)) & 3
    return codes.reshape(*lead, W * BASES_PER_WORD)


def word_valid_mask(W: int, lengths: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 masks: word j keeps its low 2*clamp(len-16j, 0, 16)
    bits (the zero-padded last-word contract)."""
    j = torch.arange(W, dtype=torch.int32, device=lengths.device)
    v = torch.clamp(lengths.to(torch.int32)[..., None] - 16 * j, 0, 16)
    full = v == 16
    part = (torch.ones_like(v) << (2 * torch.where(full, 0, v))) - 1
    return torch.where(full, ALL_ONES, part)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of int32 bit-views (SWAR), as int32."""
    x = x - (srl(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (srl(x, 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F  # every byte <= 8: now non-negative
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def basewise_diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Collapse a 2-bit XOR diff to one bit per base (low bit of each
    pair). The mask clears bit 31, so the arithmetic shift is exact."""
    d = x ^ y
    return (d | (d >> 1)) & LOWER_BITS_32


def words_from_u32_np(words_u32: np.ndarray) -> torch.Tensor:
    """Host uint32 words (the JAX package's device layout) -> a new int32
    CPU tensor holding the same bits."""
    a = np.ascontiguousarray(np.asarray(words_u32, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy())


def words_to_u32_np(words: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor (any device) -> host uint32 numpy array."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def words_u32_to_u64_np(words_u32: np.ndarray) -> np.ndarray:
    """Host view of uint32 words as reference u64 words."""
    a = np.ascontiguousarray(np.asarray(words_u32, dtype=np.uint32))
    if a.shape[-1] % 2:
        raise ValueError("word count must pair into u64s")
    return a.view(np.uint64)


def words_u64_to_u32_np(words_u64: np.ndarray) -> np.ndarray:
    """Host inverse: reference u64 words -> uint32 words."""
    return np.ascontiguousarray(np.asarray(words_u64, dtype=np.uint64)).view(
        np.uint32
    )
