"""PackedReads: a batch of 2-bit packed reads on one device.

The counterpart of ``bitnuc_tpu/sequence.py::PackedReads``: ``words`` is an
int32 [batch, W] bit-view of the JAX package's uint32 words (W even; word
pairs view as the reference's u64 words) and ``lengths`` an int32 [batch]
tensor of base counts. ``PackedSequence`` is the host single-sequence
type of reference-layout u64 words (``bitnuc_tpu/sequence.py``'s), and
``stack_sequences`` lifts a list of them into one batch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from . import api, config
from .errors import IndexOutOfBounds, InvalidBase, InvalidRange
from .utils import bitops


@dataclasses.dataclass(frozen=True)
class PackedReads:
    """A batch of packed reads: words int32 [batch, W], lengths int32 [batch]."""

    words: torch.Tensor
    lengths: torch.Tensor

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_ascii(
        cls,
        seqs: Union[Sequence[bytes], np.ndarray],
        lengths: np.ndarray = None,
        max_len: int = None,
        validate: bool = True,
        device=None,
    ) -> "PackedReads":
        """Pack host ASCII on ``device`` (default: the card, see
        ``config.resolve_device``). ``seqs`` is a list of bytes-like reads or
        a rectangular uint8 array [batch, L] with ``lengths``; an array is
        copied before upload.

        Raises InvalidBase on the first invalid byte when validate=True."""
        device = config.resolve_device(device)
        ascii_arr, lens = _rectangularize(seqs, lengths, max_len)
        ascii_t = torch.from_numpy(ascii_arr).to(device)
        lens_t = torch.from_numpy(lens).to(device)
        from .ops import codec

        words, first_bad = codec.encode_reads(ascii_t, lens_t)
        if validate:
            fb = first_bad.cpu().numpy()
            bad = np.nonzero(fb >= 0)[0]
            if bad.size:
                r = int(bad[0])
                raise InvalidBase(int(ascii_arr[r, int(fb[r])]))
        return cls(words=words, lengths=lens_t)

    @classmethod
    def from_numpy(cls, words_u32: np.ndarray, lengths: np.ndarray, device=None) -> "PackedReads":
        """From host uint32 words [batch, W] (the JAX package's layout), on
        ``device`` (default: the card)."""
        device = config.resolve_device(device)
        words = bitops.words_from_u32_np(words_u32).to(device)
        lens = torch.from_numpy(np.asarray(lengths, dtype=np.int32).copy()).to(device)
        return cls(words=words, lengths=lens)

    @classmethod
    def from_u64(cls, words_u64: np.ndarray, lengths: np.ndarray, device=None) -> "PackedReads":
        """From host reference-layout u64 words [batch, n_u64]."""
        return cls.from_numpy(bitops.words_u64_to_u32_np(words_u64), lengths, device)

    # -- host views -----------------------------------------------------------

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """(uint32 words [batch, W], int32 lengths [batch]) on the host."""
        return bitops.words_to_u32_np(self.words), self.lengths.cpu().numpy()

    def to_u64(self) -> np.ndarray:
        """Host u64 words [batch, W//2], bit-exact reference layout."""
        return bitops.words_u32_to_u64_np(bitops.words_to_u32_np(self.words))

    def to_ascii(self) -> List[bytes]:
        """Decode all reads to host bytes."""
        from .ops import codec

        out = codec.decode_reads(self.words, self.lengths).cpu().numpy()
        lens = self.lengths.cpu().numpy()
        return [bytes(out[i, : lens[i]]) for i in range(out.shape[0])]

    # -- shape ----------------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self.words.shape[-2]

    @property
    def n_words(self) -> int:
        return self.words.shape[-1]

    @property
    def max_bases(self) -> int:
        return self.n_words * bitops.BASES_PER_WORD

    def __len__(self) -> int:
        return self.batch_size

    def __getitem__(self, i: int) -> "PackedSequence":
        """Read i as a host PackedSequence: one row copied to the host, no
        decode. A length past 16 W keeps the row's words and pads them with
        zeros, as the JAX package does."""
        if not -self.batch_size <= i < self.batch_size:
            raise IndexError(i)
        row = bitops.words_u32_to_u64_np(bitops.words_to_u32_np(self.words[i]))
        n = int(self.lengths[i])
        return PackedSequence.from_packed(row[: (n + 31) // 32], n)

    def __iter__(self) -> Iterator["PackedSequence"]:
        for i in range(self.batch_size):
            yield self[i]


def _rectangularize(seqs, lengths=None, max_len=None) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize host input into (uint8[batch, L], int32[batch]); an
    ndarray input is copied, so the caller may reuse its buffer at once."""
    if isinstance(seqs, np.ndarray) and seqs.ndim == 2:
        arr = np.array(seqs, dtype=np.uint8)
        if max_len is not None and arr.shape[1] > int(max_len):
            arr = arr[:, : int(max_len)]
        if lengths is None:
            lens = np.full(arr.shape[0], arr.shape[1], dtype=np.int32)
        else:
            lens = np.asarray(lengths, dtype=np.int32)
        return np.ascontiguousarray(arr), np.minimum(lens, arr.shape[1]).astype(np.int32)
    seq_bytes = [bytes(s) if not isinstance(s, (bytes, bytearray)) else s for s in seqs]
    lens = np.array([len(s) for s in seq_bytes], dtype=np.int32)
    L = int(max_len) if max_len is not None else (int(lens.max()) if len(lens) else 0)
    L = max(L, 1)
    arr = np.zeros((len(seq_bytes), L), dtype=np.uint8)
    for i, s in enumerate(seq_bytes):
        n = min(len(s), L)  # max_len truncates
        arr[i, :n] = np.frombuffer(s[:n], dtype=np.uint8)
    return arr, np.minimum(lens, L).astype(np.int32)


class PackedSequence:
    """Host single-sequence type mirroring the reference PackedSequence
    (src/sequence.rs): reference-layout u64 words and a length; hashable
    and comparable, so it works as a dict or set key
    (src/sequence.rs:329-338). The counterpart of
    ``bitnuc_tpu.sequence.PackedSequence``; its operations run on the host
    (``api``), and ``to_reads``/``stack_sequences`` lift sequences to a
    device batch.

    >>> s = PackedSequence(b"ACGTACGT")
    >>> (len(s), s.is_empty(), chr(s.get(2)))
    (8, False, 'G')
    >>> s.slice(1, 5)
    b'CGTA'
    >>> (s.gc_content(), s.base_counts())
    (50.0, (2, 2, 2, 2))
    """

    __slots__ = ("_data", "_length")

    def __init__(self, seq: Union[bytes, str, "PackedSequence"] = b""):
        if isinstance(seq, PackedSequence):
            self._data = seq._data
            self._length = seq._length
            return
        s = seq.encode("ascii") if isinstance(seq, str) else bytes(seq)
        self._data = api.encode(s)
        self._length = len(s)

    @classmethod
    def from_packed(cls, words_u64, length: int) -> "PackedSequence":
        """From u64 words, normalised to exactly ceil(length / 32) words (cut
        or zero-padded) so that equality and hash see one form."""
        obj = cls.__new__(cls)
        data = np.asarray(words_u64, dtype=np.uint64).reshape(-1)
        nw = -(-int(length) // 32)
        if len(data) >= nw:
            data = data[:nw].copy()
        else:
            data = np.concatenate([data, np.zeros(nw - len(data), np.uint64)])
        obj._data = data
        obj._length = int(length)
        return obj

    @property
    def data(self) -> np.ndarray:
        """Packed u64 words (reference layout)."""
        return self._data

    def __len__(self) -> int:
        return self._length

    def len(self) -> int:  # reference-name alias (src/sequence.rs:67)
        return self._length

    def is_empty(self) -> bool:
        return self._length == 0

    def get(self, index: int) -> int:
        """ASCII byte at index (src/sequence.rs:116-135)."""
        if index < 0 or index >= self._length:
            raise IndexOutOfBounds(index, self._length)
        return api.decode(self._data[index // 32 :], index % 32 + 1)[-1]

    def slice(self, start: int, end: int) -> bytes:
        """Subsequence [start, end) (src/sequence.rs:198-212), decoding only
        the words it covers."""
        if start < 0 or start > end or end > self._length:
            raise InvalidRange(start, end, self._length)
        lo = start // 32
        return api.decode(self._data[lo:], end - 32 * lo)[start - 32 * lo :]

    def to_vec(self) -> bytes:
        """Full decode (src/sequence.rs:260-262)."""
        return api.decode(self._data, max(self._length, 0))

    def base_counts(self) -> Tuple[int, int, int, int]:
        """(A, C, G, T) counts (src/utils/analysis.rs:23-39)."""
        codes = (self._data[:, None] >> (2 * np.arange(32, dtype=np.uint64))) & np.uint64(3)
        c = np.bincount(codes.reshape(-1)[: max(self._length, 0)].astype(np.int64), minlength=4)
        return tuple(int(x) for x in c)

    def gc_content(self) -> float:
        """GC percent 0-100 in float64 (src/utils/analysis.rs:8-16); 0.0 when
        empty."""
        if self._length == 0:
            return 0.0
        _, c, g, _ = self.base_counts()
        return (c + g) / self._length * 100.0

    def split(self, idx: int) -> Tuple["PackedSequence", "PackedSequence"]:
        """Split into (left, right) at base idx (api.split_packed)."""
        left, right = api.split_packed(self._data, self._length, idx)
        return (PackedSequence.from_packed(left, idx),
                PackedSequence.from_packed(right, self._length - idx))

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._length)
            if step != 1:
                raise InvalidRange(start, stop, self._length)
            return self.slice(start, stop)
        if key < 0:
            key += self._length
        return self.get(key)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PackedSequence)
            and self._length == other._length
            and np.array_equal(self._data, other._data)
        )

    def __hash__(self) -> int:
        return hash((self._length, self._data.tobytes()))

    def __repr__(self) -> str:
        shown = self.to_vec() if self._length <= 40 else self.to_vec()[:37] + b"..."
        return f"PackedSequence({shown.decode('ascii')!r}, len={self._length})"

    def to_reads(self, device=None) -> PackedReads:
        """A batch of one on ``device`` (default: the card)."""
        return PackedReads.from_u64(self._data[None, :], np.array([self._length]), device)


def stack_sequences(seqs: Iterable[PackedSequence], device=None) -> PackedReads:
    """Stack host PackedSequences into one zero-padded batch on ``device``
    (default: the card)."""
    seq_list = list(seqs)
    lens = np.array([len(s) for s in seq_list], dtype=np.int32)
    n_u64 = max(max((len(s.data) for s in seq_list), default=0), 1)
    words = np.zeros((len(seq_list), n_u64), dtype=np.uint64)
    for i, s in enumerate(seq_list):
        words[i, : len(s.data)] = s.data
    return PackedReads.from_u64(words, lens, device)
