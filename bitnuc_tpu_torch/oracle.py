"""Pure-Python/numpy scalar oracle for the 2-bit nucleotide codec.

A copy of ``bitnuc_tpu/oracle.py``: importing any ``bitnuc_tpu`` module
imports jax, so the port carries its own. It implements the semantics of
the reference crate (bitnuc v0.2.11) simply and without optimisation, and
raises this package's ``errors``. Contract (reference file:line):
  - code map A/a=00, C/c=01, G/g=10, T/t=11  (src/utils/packing/naive.rs:10-15)
  - LSB-first: base i occupies bits [2i, 2i+1]  (src/utils/packing/naive.rs:17)
  - 32 bases per u64 word; last word zero-padded high (src/utils/packing/naive.rs:27-42)
  - as_2bit rejects len > 32 with SequenceTooLong (src/utils/packing/naive.rs:5-7)
  - from_2bit rejects n > 32 with InvalidLength (src/utils/unpacking/naive.rs:8-10)
  - hdist counts differing *bases* (2-bit groups), not bits
    (src/utils/functions/hamming/scalar.rs:40-47)
  - split_packed word-count semantics incl. trailing zero word when idx%32==0
    (src/utils/functions/split.rs:63-99)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .errors import (
    IndexOutOfBounds,
    InvalidBase,
    InvalidLength,
    InvalidRange,
    SequenceTooLong,
)

U64 = np.uint64
MASK64 = (1 << 64) - 1
LOWER_BITS = 0x5555555555555555
UPPER_BITS = 0xAAAAAAAAAAAAAAAA

_CODE = {}
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b | 0x20] = _i  # lowercase

_BASE = b"ACGT"


def _as_bytes(seq) -> bytes:
    if isinstance(seq, str):
        return seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return bytes(seq)
    return bytes(np.asarray(seq, dtype=np.uint8).tobytes())


def as_2bit(seq) -> int:
    """Pack <=32 bases into one u64, LSB-first (src/utils/packing/mod.rs:81)."""
    s = _as_bytes(seq)
    if len(s) > 32:
        raise SequenceTooLong(len(s))
    packed = 0
    for i, b in enumerate(s):
        code = _CODE.get(b)
        if code is None:
            raise InvalidBase(b)
        packed |= code << (2 * i)
    return packed


def from_2bit(packed: int, n_bases: int) -> bytes:
    """Unpack n_bases (<=32) from one u64 (src/utils/unpacking/mod.rs:119)."""
    if n_bases > 32:
        raise InvalidLength(n_bases)
    packed = int(packed) & MASK64
    return bytes(_BASE[(packed >> (2 * i)) & 0b11] for i in range(n_bases))


def encode(seq) -> np.ndarray:
    """Encode arbitrary-length sequence to u64 words (src/utils/mod.rs:22).

    Returns ceil(len/32) words; empty input returns an empty array (the
    reference's encode panics on empty input; PackedSequence::new skips encode
    for empty sequences, src/sequence.rs:42-44 — we normalize to empty output).
    """
    s = _as_bytes(seq)
    if not s:
        return np.zeros(0, dtype=U64)
    words = [as_2bit(s[i : i + 32]) for i in range(0, len(s), 32)]
    return np.array(words, dtype=U64)


def decode(ebuf, n_bases: int) -> bytes:
    """Decode n_bases from u64 words (src/utils/mod.rs:60)."""
    words = np.asarray(ebuf, dtype=U64)
    out = bytearray()
    remaining = n_bases
    for w in words:
        if remaining <= 0:
            break
        take = min(32, remaining)
        out += from_2bit(int(w), take)
        remaining -= take
    if remaining > 0:
        raise InvalidLength(n_bases)
    return bytes(out)


def hdist_scalar(u: int, v: int, length: int) -> int:
    """Per-base Hamming distance on one word pair (hamming/scalar.rs:11-48)."""
    if length > 32:
        raise InvalidLength(length)
    if length == 0:
        return 0
    valid_bits = 2 * length
    mask = MASK64 if valid_bits == 64 else (1 << valid_bits) - 1
    diff = (int(u) ^ int(v)) & mask
    lower = diff & LOWER_BITS
    upper = (diff & UPPER_BITS) >> 1
    return bin(lower | upper).count("1")


def hdist(ebuf1, ebuf2, n_bases: int) -> int:
    """Per-base Hamming distance over word arrays (hamming/multi.rs:122-160)."""
    e1 = np.asarray(ebuf1, dtype=U64)
    e2 = np.asarray(ebuf2, dtype=U64)
    expected = -(-n_bases // 32)
    if len(e1) < expected or len(e2) < expected:
        raise InvalidLength(n_bases)
    full = n_bases // 32
    total = sum(hdist_scalar(int(e1[i]), int(e2[i]), 32) for i in range(full))
    rem = n_bases % 32
    if rem > 0:
        total += hdist_scalar(int(e1[full]), int(e2[full]), rem)
    return total


def split_packed(ebuf, slen: int, idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split a packed stream at base idx (src/utils/functions/split.rs:14-102).

    Left keeps the reference's exact word layout: whole words plus a (possibly
    zero) masked partial word (split.rs:67-77). Right is the packed stream
    shifted down by idx bases.

    Divergence note: the reference's right-shift loop (split.rs:83-94)
    propagates the carry from the *previous* word instead of pulling the low
    bits of the *next* word, which corrupts any split whose right part spans
    more than one word at a non-word-aligned index — a case its own tests never
    exercise (split.rs:104-226 only cover single-right-word or aligned splits).
    We implement the correct funnel shift, which satisfies the contract the
    reference's tests actually assert: decode(right, slen-idx) == seq[idx:].
    """
    words = [int(w) for w in np.asarray(ebuf, dtype=U64)]
    if idx > slen:
        raise IndexOutOfBounds(idx, slen)
    if idx == 0:
        return np.zeros(0, dtype=U64), np.array(words, dtype=U64)
    if idx == slen:
        return np.array(words, dtype=U64), np.zeros(0, dtype=U64)
    if not words:
        return np.zeros(0, dtype=U64), np.zeros(0, dtype=U64)

    right_chunks = -(-(slen - idx) // 32)
    chunk_idx = idx // 32
    bit_idx = (idx % 32) * 2

    lbuf = list(words[:chunk_idx])
    split_mask = 0 if bit_idx == 0 else (1 << bit_idx) - 1
    lbuf.append(words[chunk_idx] & split_mask)

    rbuf = []
    src = words[chunk_idx:] + [0]
    for j in range(right_chunks):
        lo = src[j] >> bit_idx
        hi = 0 if bit_idx == 0 else (src[j + 1] << (64 - bit_idx)) & MASK64
        rbuf.append(lo | hi)
    return np.array(lbuf, dtype=U64), np.array(rbuf, dtype=U64)


def get(ebuf, length: int, index: int) -> int:
    """Single-base access (src/sequence.rs:116-135). Returns the ASCII byte."""
    if index < 0 or index >= length:
        raise IndexOutOfBounds(index, length)
    words = np.asarray(ebuf, dtype=U64)
    bits = (int(words[index // 32]) >> ((index % 32) * 2)) & 0b11
    return _BASE[bits]


def slice_(ebuf, length: int, start: int, end: int) -> bytes:
    """Subsequence [start, end) (src/sequence.rs:198-212)."""
    if start < 0 or start > end or end > length:
        raise InvalidRange(start, end, length)
    return bytes(get(ebuf, length, i) for i in range(start, end))


def base_counts(ebuf, length: int) -> Tuple[int, int, int, int]:
    """Counts of A,C,G,T (src/utils/analysis.rs:23-39)."""
    counts = [0, 0, 0, 0]
    words = np.asarray(ebuf, dtype=U64)
    for i in range(length):
        counts[(int(words[i // 32]) >> ((i % 32) * 2)) & 0b11] += 1
    return tuple(counts)


def gc_content(ebuf, length: int) -> float:
    """GC percentage 0-100 (src/utils/analysis.rs:8-16); empty -> 0.0."""
    if length == 0:
        return 0.0
    _, c, g, _ = base_counts(ebuf, length)
    return (c + g) / length * 100.0


def count_kmers(seq, k: int) -> dict:
    """K-mer counting exactly as the reference README documents it
    (README.md:164-180): slide a k-wide window over the ASCII sequence, pack
    each window with as_2bit, count occurrences of each packed value.
    """
    s = _as_bytes(seq)
    counts: dict = {}
    for i in range(len(s) - k + 1):
        key = as_2bit(s[i : i + k])
        counts[key] = counts.get(key, 0) + 1
    return counts


def u64_to_u32(words) -> np.ndarray:
    """View u64 words as the device's little-endian u32 lane pairs."""
    return np.asarray(words, dtype=U64).view(np.uint32)


def u32_to_u64(lanes) -> np.ndarray:
    """Inverse of u64_to_u32."""
    lanes = np.ascontiguousarray(np.asarray(lanes, dtype=np.uint32))
    return lanes.view(U64)


def edit_distance(a, b) -> int:
    """Levenshtein distance between two byte strings (full DP)."""
    a, b = _as_bytes(a), _as_bytes(b)
    prev = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (a[i - 1] != b[j - 1]),
            )
        prev = cur
    return prev[len(b)]


def global_distance(a, b, mismatch: int = 1, gap: int = 1) -> int:
    """Weighted global alignment cost (NW distance form)."""
    a, b = _as_bytes(a), _as_bytes(b)
    prev = [j * gap for j in range(len(b) + 1)]
    for i in range(1, len(a) + 1):
        cur = [i * gap] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(
                prev[j] + gap,
                cur[j - 1] + gap,
                prev[j - 1] + (0 if a[i - 1] == b[j - 1] else mismatch),
            )
        prev = cur
    return prev[len(b)]


def fit_distance(a, b, mismatch: int = 1, gap: int = 1) -> Tuple[int, int]:
    """Fitting alignment: all of `a` vs the best substring of `b`.
    Returns (cost, end_j) with end_j one past the substring end; ties
    prefer the smallest end_j (matches ops.align.fit_distance)."""
    a, b = _as_bytes(a), _as_bytes(b)
    prev = [0] * (len(b) + 1)  # D[0, j] = 0: free start in b
    for i in range(1, len(a) + 1):
        cur = [i * gap] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(
                prev[j] + gap,
                cur[j - 1] + gap,
                prev[j - 1] + (0 if a[i - 1] == b[j - 1] else mismatch),
            )
        prev = cur
    best = min(prev)
    return best, prev.index(best)


def sw_score(
    a,
    b,
    match: int = 2,
    mismatch: int = -3,
    gap_open: int = -5,
    gap_extend: int = -2,
) -> Tuple[int, int, int]:
    """Affine-gap Smith-Waterman (Gotoh) score with the tie-break contract
    of ops.align.sw_score: (score, end_i, end_j), ties -> smallest i+j,
    then smallest j. Empty alignment -> (0, 0, 0)."""
    a, b = _as_bytes(a), _as_bytes(b)
    NEG = -(1 << 30)
    m, n = len(a), len(b)
    h = [[0] * (n + 1) for _ in range(m + 1)]
    e = [[NEG] * (n + 1) for _ in range(m + 1)]
    f = [[NEG] * (n + 1) for _ in range(m + 1)]
    best, bi, bj = 0, 0, 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            e[i][j] = max(h[i][j - 1] + gap_open, e[i][j - 1] + gap_extend)
            f[i][j] = max(h[i - 1][j] + gap_open, f[i - 1][j] + gap_extend)
            s = match if a[i - 1] == b[j - 1] else mismatch
            h[i][j] = max(0, h[i - 1][j - 1] + s, e[i][j], f[i][j])
            if h[i][j] > best or (
                h[i][j] == best and (i + j, j) < (bi + bj, bj)
            ):
                best, bi, bj = h[i][j], i, j
    return best, bi, bj
