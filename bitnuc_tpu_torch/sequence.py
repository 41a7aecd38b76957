"""PackedReads: a batch of 2-bit packed reads on one device.

The counterpart of ``bitnuc_tpu/sequence.py::PackedReads``: ``words`` is an
int32 [batch, W] bit-view of the JAX package's uint32 words (W even; word
pairs view as the reference's u64 words) and ``lengths`` an int32 [batch]
tensor of base counts. ``PackedSequence``, the host single-sequence type,
is a later port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from . import config
from .errors import InvalidBase
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

    def __getitem__(self, i: int) -> bytes:
        """Read i decoded to host ASCII bytes (``PackedSequence``, which the
        JAX package returns here, is a later port)."""
        if not -self.batch_size <= i < self.batch_size:
            raise IndexError(i)
        from .ops import codec

        row = codec.decode_reads(self.words[i], self.lengths[i])
        return bytes(row.cpu().numpy()[: int(self.lengths[i])])


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
