"""Persistence and FASTQ ingestion.

The counterpart of the parts of ``bitnuc_tpu/io.py`` that the counting path
needs. ``save_packed``/``load_packed`` use the JAX package's .npz keys
(``words`` as uint32, ``lengths``), so either package reads the other's
files. ``iter_fastq_batches`` frames records on the host with numpy, with
the JAX package's byte-offset semantics (an offset is the byte just past a
batch's last record, and ``start_offset`` resumes there), uploads each
batch's ASCII and packs it on the device with the K1 kernel.

Gzip input, FASTA, prefetch threads and the native scanner are later ports.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .errors import InvalidBase
from .ops import codec
from .sequence import PackedReads

PathLike = Union[str, os.PathLike]

_STREAM_BLOCK = 4 << 20  # bytes read per file chunk


# -- checkpoint / resume ------------------------------------------------------


def save_packed(path: PathLike, reads: PackedReads) -> None:
    """Persist a PackedReads batch as .npz (uint32 words + int32 lengths)."""
    words, lengths = reads.to_numpy()
    np.savez_compressed(path, words=words, lengths=lengths)


def load_packed(path: PathLike, device=None) -> PackedReads:
    """Load a PackedReads batch saved by either package's save_packed."""
    with np.load(path) as z:
        return PackedReads.from_numpy(z["words"], z["lengths"], device)


# -- FASTQ framing ------------------------------------------------------------


def _line_spans(arr: np.ndarray):
    """(starts, lengths) of the non-blank lines of ``arr``; a trailing '\\r'
    is not part of a line, and a last line without '\\n' counts."""
    if not arr.size:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    nl = np.flatnonzero(arr == 10)
    if nl.size == 0 or nl[-1] != arr.size - 1:
        nl = np.append(nl, arr.size)
    starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    lens = nl - starts
    cr = (lens > 0) & (arr[np.minimum(nl - 1, arr.size - 1)] == 13)
    lens = lens - cr
    keep = lens > 0
    return starts[keep], lens[keep]


def _iter_fastq_record_blocks(path: PathLike, batch_size: int, start_offset: int = 0):
    """Yield (record_bytes, end_byte_offset) chunks of exactly ``batch_size``
    FASTQ records (the trailing partial group comes last). Blank lines do
    not advance the framing; headers are checked."""
    carry = b""
    abs_base = start_offset  # file offset of data[0]
    with open(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        while True:
            # when batch_size records exceed one block, grow the read so the
            # carry + block concatenation cannot go quadratic
            block = f.read(max(_STREAM_BLOCK, 2 * len(carry)) if carry else _STREAM_BLOCK)
            if not block:
                break
            data = carry + block
            arr = np.frombuffer(data, np.uint8)
            nl = np.flatnonzero(arr == 10)
            if nl.size:
                starts = np.concatenate([[0], nl[:-1] + 1])
                line_len = nl - starts
                blank = (line_len == 0) | ((line_len == 1) & (arr[starts] == 13))
                nb = np.flatnonzero(~blank)
            else:
                nb = np.zeros(0, np.int64)
            n_rec = nb.size // 4
            if n_rec:
                hdr = arr[starts[nb[0 : 4 * n_rec : 4]]]
                if not np.all(hdr == ord("@")):
                    r = int(np.argmax(hdr != ord("@")))
                    off = starts[nb[4 * r]]
                    raise ValueError(f"malformed FASTQ header: {data[off:off + 40]!r}")
            emitted = 0
            for b in range(n_rec // batch_size):
                end = int(nl[nb[4 * (b + 1) * batch_size - 1]]) + 1
                yield data[emitted:end], abs_base + end
                emitted = end
            carry = data[emitted:]
            abs_base += emitted  # carry[0] now sits at abs_base
    if carry.strip():
        yield carry, abs_base + len(carry)


def fastq_to_batch(data: bytes, max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """FASTQ bytes -> (ascii uint8 [B, L], lengths int32 [B]), vectorized.

    The sequence is the second non-blank line of each record (a trailing
    record cut short after its sequence still counts). L is max_len, or the
    longest read (at least 1); longer reads are truncated."""
    arr = np.frombuffer(data, np.uint8)
    starts, lens = _line_spans(arr)
    seq_starts, seq_lens = starts[1::4], lens[1::4]
    B = seq_starts.size
    L = int(max_len) if max_len else max(int(seq_lens.max()) if B else 0, 1)
    seq_lens = np.minimum(seq_lens, L).astype(np.int32)
    if not B:
        return np.zeros((0, L), np.uint8), seq_lens
    cols = np.arange(L, dtype=np.int64)
    idx = np.minimum(seq_starts[:, None] + cols[None, :], arr.size - 1)
    ascii_arr = np.where(cols[None, :] < seq_lens[:, None], arr[idx], 0).astype(np.uint8)
    return ascii_arr, seq_lens


def iter_fastq_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
    validate: bool = True,
    with_validity: bool = False,
    with_offsets: bool = False,
    start_offset: int = 0,
    device=None,
) -> Iterator:
    """Stream a FASTQ file as PackedReads batches packed on ``device``.

    Yields ``reads``, or a tuple that appends the per-base validity
    (``with_validity``: bool [B, L] on the device, for
    ``count_kmers_reads(base_valid=...)``) and then the byte offset just past
    the batch's last record (``with_offsets``); feeding that offset back as
    ``start_offset`` resumes framing at the same record boundary.
    validate=True raises InvalidBase on the first invalid in-range base."""
    for data, end in _iter_fastq_record_blocks(path, batch_size, start_offset):
        ascii_arr, lens = fastq_to_batch(data, max_len)
        if not len(lens):
            continue
        ascii_t = torch.from_numpy(ascii_arr).to(device)
        lens_t = torch.from_numpy(lens).to(device)
        words, first_bad = codec.encode_reads(ascii_t, lens_t)
        if validate:
            fb = first_bad.cpu().numpy()
            bad = np.flatnonzero(fb >= 0)
            if bad.size:
                r = int(bad[0])
                raise InvalidBase(int(ascii_arr[r, fb[r]]))
        item = (PackedReads(words=words, lengths=lens_t),)
        if with_validity:
            item += (codec.validity_mask(ascii_t, lens_t),)
        if with_offsets:
            item += (end,)
        yield item[0] if len(item) == 1 else item
