"""Host-level functional API: the reference crate's root functions
(src/lib.rs:214-220: as_2bit, from_2bit, from_2bit_alloc, encode,
encode_alloc, decode, hdist, hdist_scalar, split_packed) and the README's
count_kmers.

The counterpart of ``bitnuc_tpu/api.py``. These are single-sequence host
operations on reference-layout u64 words; a device call per sequence would
cost more than the work. The JAX package runs them on its native C++
library when that is built and on its oracle otherwise; this package has no
native library, so they run on numpy forms equal to ``oracle`` (a whole
sequence at a time, no per-base Python). Where the native library and the
oracle differ, these follow ``bitnuc_tpu.api`` with the library built: a
negative length or index raises (ValueError in decode and from_2bit,
InvalidLength in hdist and hdist_scalar, IndexOutOfBounds in
split_packed), a packed word outside u64 raises OverflowError, and
count_kmers validates a sequence shorter than k. Batched device
equivalents live in ``ops`` and work on ``PackedReads``.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from .errors import IndexOutOfBounds, InvalidBase, InvalidLength, SequenceTooLong

Seq = Union[bytes, bytearray, str, np.ndarray]

# code of each byte, 4 where it is not one of ACGTacgt
_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _CODE[_b | 0x20] = _i
_BASE = np.frombuffer(b"ACGT", np.uint8)
_SHIFTS = 2 * np.arange(32, dtype=np.uint64)
_LOW = np.uint64(0x5555555555555555)
_NATIVE_DENSE_MAX_K = 12  # the JAX package's native count_kmers takes k <= 12


def _as_u8(seq: Seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), np.uint8)
    return np.ascontiguousarray(np.asarray(seq, dtype=np.uint8)).reshape(-1)


def _codes(s: np.ndarray) -> np.ndarray:
    """2-bit codes of the bytes; InvalidBase on the first invalid byte."""
    c = _CODE[s]
    bad = np.flatnonzero(c == 4)
    if bad.size:
        raise InvalidBase(int(s[bad[0]]))
    return c


def _pack(codes: np.ndarray) -> np.ndarray:
    """Codes [n] -> ceil(n / 32) u64 words, the last zero-padded high."""
    n = codes.size
    c = np.zeros(-(-n // 32) * 32, np.uint64)
    c[:n] = codes
    return np.bitwise_or.reduce(c.reshape(-1, 32) << _SHIFTS, axis=1)


def _unpack(words: np.ndarray, n_bases: int) -> bytes:
    if n_bases < 0:
        raise ValueError(f"negative n_bases {n_bases}")
    codes = (words[:, None] >> _SHIFTS) & np.uint64(3)
    return _BASE[codes.reshape(-1)[:n_bases]].tobytes()


def _u64_words(ebuf) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(ebuf, dtype=np.uint64)).reshape(-1)


def as_2bit(seq: Seq) -> int:
    """Pack up to 32 bases into one u64 (src/utils/packing/mod.rs:81).

    >>> bin(as_2bit(b"ACGT"))
    '0b11100100'
    """
    s = _as_u8(seq)
    if s.size > 32:
        raise SequenceTooLong(s.size)
    return int(_pack(_codes(s))[0]) if s.size else 0


def from_2bit(packed: int, n_bases: int) -> bytes:
    """Unpack n_bases (<= 32) from one u64 (src/utils/unpacking/mod.rs:119).
    Returns fresh bytes where the reference appends to a caller's buffer
    (docs/PARITY.md, recorded divergence 2).

    >>> from_2bit(71620941647064936, 28)  # reference golden word
    b'AGGCTTGAGGCCCATTCTCTGATCGTTT'
    """
    if n_bases > 32:
        raise InvalidLength(n_bases)
    return _unpack(np.array([packed], dtype=np.uint64), n_bases)


def from_2bit_alloc(packed: int, n_bases: int) -> bytes:
    """Allocating alias of from_2bit (src/utils/unpacking/mod.rs:178)."""
    return from_2bit(packed, n_bases)


def encode(seq: Seq) -> np.ndarray:
    """Encode a sequence of any length to ceil(n / 32) u64 words
    (src/utils/mod.rs:22); empty input gives no words.

    >>> int(encode(b"ACGT")[0])
    228
    """
    s = _as_u8(seq)
    if not s.size:
        return np.zeros(0, np.uint64)
    return _pack(_codes(s))


def encode_alloc(seq: Seq) -> np.ndarray:
    """Alias of encode: Python always allocates (src/utils/mod.rs:38)."""
    return encode(seq)


def decode(ebuf, n_bases: int) -> bytes:
    """Decode n_bases from u64 words (src/utils/mod.rs:60); InvalidLength
    when the words hold fewer.

    >>> decode(encode(b"ACGTACGTAC"), 10)
    b'ACGTACGTAC'
    """
    words = _u64_words(ebuf)
    if n_bases > 32 * words.size:
        raise InvalidLength(n_bases)
    return _unpack(words[: -(-n_bases // 32)], n_bases)


def _popcount64(x: np.ndarray) -> int:
    return int(np.unpackbits(x.view(np.uint8)).sum())


def hdist(ebuf1, ebuf2, n_bases: int) -> int:
    """Per-base Hamming distance over packed word arrays
    (src/utils/functions/hamming/multi.rs:122). A total of 0 is not
    recomputed (docs/PARITY.md, recorded divergence 3).

    >>> hdist(encode(b"ACTGACTG"), encode(b"TGCATGCA"), 8)  # golden table row
    8
    """
    e1, e2 = _u64_words(ebuf1), _u64_words(ebuf2)
    nw = -(-n_bases // 32)
    if e1.size < nw or e2.size < nw or n_bases < 0:
        raise InvalidLength(n_bases)
    if not n_bases:
        return 0
    d = e1[:nw] ^ e2[:nw]
    rem = n_bases % 32
    if rem:
        d[-1] &= np.uint64((1 << (2 * rem)) - 1)
    return _popcount64((d | (d >> np.uint64(1))) & _LOW)


def hdist_scalar(u: int, v: int, length: int) -> int:
    """Single-word per-base Hamming distance (hamming/scalar.rs:11)."""
    if length > 32:
        raise InvalidLength(length)
    return hdist(np.array([u], np.uint64), np.array([v], np.uint64), length)


def split_packed(ebuf, slen: int, idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split a packed stream at base idx (src/utils/functions/split.rs:14):
    left keeps the reference's word layout, whole words plus a masked
    partial word (a zero word when idx % 32 == 0); right is the stream
    shifted down by idx bases, by a correct funnel shift (docs/PARITY.md,
    recorded divergence 1).

    >>> l, r = split_packed(encode(b"ACGTAC"), 6, 4)
    >>> (decode(l, 4), decode(r, 2))
    (b'ACGT', b'AC')
    """
    words = _u64_words(ebuf)
    if idx > slen or idx < 0:
        raise IndexOutOfBounds(idx, slen)
    if idx == 0:
        return np.zeros(0, np.uint64), words.copy()
    if idx == slen:
        return words.copy(), np.zeros(0, np.uint64)
    if not words.size:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    chunk, bit = idx // 32, (idx % 32) * 2
    left = words[: chunk + 1].copy()
    left[chunk] &= np.uint64((1 << bit) - 1)
    n_right = -(-(slen - idx) // 32)
    src = np.concatenate([words[chunk:], np.zeros(1, np.uint64)])
    right = src[:n_right] >> np.uint64(bit)
    if bit:
        right |= src[1 : n_right + 1] << np.uint64(64 - bit)
    return left, right


def count_kmers(seq: Seq, k: int) -> dict:
    """K-mer counts as the reference README documents them
    (README.md:164-180): {packed k-mer: count}, each window packed as by
    as_2bit. The windows' keys are made for the whole sequence at once.

    Every byte is validated, as the JAX package's native library does
    through k = 12: a sequence shorter than k with an invalid byte raises
    InvalidBase there, where its oracle (and its k > 12 path) returns {}.

    >>> count_kmers(b"AAAA", 2)
    {0: 3}
    """
    if not 1 <= k <= 32:
        raise InvalidLength(k)
    s = _as_u8(seq)
    if s.size < k:
        if k <= _NATIVE_DENSE_MAX_K:
            _codes(s)
        return {}
    c = _codes(s).astype(np.uint64)
    n = s.size - k + 1
    keys = np.zeros(n, np.uint64)
    for j in range(k):
        keys |= c[j : j + n] << np.uint64(2 * j)
    uniq, cnt = np.unique(keys, return_counts=True)
    return dict(zip(uniq.tolist(), cnt.tolist()))


__all__ = [
    "as_2bit", "from_2bit", "from_2bit_alloc", "encode", "encode_alloc", "decode",
    "hdist", "hdist_scalar", "split_packed", "count_kmers",
]
