"""Persistence, FASTA and FASTQ ingestion.

The counterpart of ``bitnuc_tpu/io.py``. ``save_packed``/``load_packed`` use the JAX package's .npz keys
(``words`` as uint32, ``lengths``), so either package reads the other's
files. ``iter_fastq_batches`` frames records on the host, with
the JAX package's byte-offset semantics (an offset is the byte just past a
batch's last record, and ``start_offset`` resumes there), uploads each
batch's ASCII and packs it on the device with the K1 kernel. A ``.gz`` path
is read through gzip; its offsets count bytes of the decompressed stream,
as in the JAX package. ``read_fasta`` and ``_split_records_fasta`` parse
FASTA (path, ``.gz`` path, bytes or file object).

``prefetch > 0`` runs the host side of ``iter_fastq_batches`` (reading,
gzip, framing, the numpy rectangle) on a producer thread that keeps up to
``prefetch`` batches ready (``_prefetched``, the JAX package's contract).
The upload and K1 stay on the consumer's thread, so every device call runs
on that thread's current stream.

Whole FASTQ buffers are framed by the host library's scanner
(``native.fastq_to_batch``, ``native.fastq_to_batch_sq``) behind
``read_fastq_fast``, ``iter_fastq_ascii_batches``,
``iter_fastq_record_batches`` and ``iter_fastq_batches`` (``staged=None``
or True), as in the JAX package; ``fastq_to_batch`` and
``fastq_to_batch_sq`` here are its numpy twins, taken without the library
and by ``staged=False``. Packing stays on the device (K1) either way.
``read_fastq`` keeps the JAX package's strict 4-line reader, and
``split_records_fastq_full`` its blank-line-tolerant record parser.
"""

from __future__ import annotations

import contextlib
import gzip
import io as _stdio
import os
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from . import config, native
from .errors import InvalidBase
from .ops import codec
from .sequence import PackedReads

PathLike = Union[str, os.PathLike]

_STREAM_BLOCK = 4 << 20  # bytes read per file chunk

# True for the bytes ACGTacgt: host-side validity, as in the JAX package
_VALID_BASE = np.zeros(256, dtype=bool)
_VALID_BASE[np.frombuffer(b"ACGTacgt", np.uint8)] = True


# -- checkpoint / resume ------------------------------------------------------


def save_packed(path: PathLike, reads: PackedReads) -> None:
    """Persist a PackedReads batch as .npz (uint32 words + int32 lengths)."""
    words, lengths = reads.to_numpy()
    np.savez_compressed(path, words=words, lengths=lengths)


def load_packed(path: PathLike, device=None) -> PackedReads:
    """Load a PackedReads batch saved by either package's save_packed, on
    ``device`` (default: the card)."""
    with np.load(path) as z:
        return PackedReads.from_numpy(z["words"], z["lengths"], device)


# -- FASTA --------------------------------------------------------------------


def _open(path: PathLike):
    """Binary reader of a file, through gzip for a ``.gz`` path."""
    return gzip.open(path, "rb") if os.fspath(path).endswith(".gz") else open(path, "rb")


def _read_bytes(path_or_data) -> bytes:
    """All bytes of a path (``.gz`` decompressed), a file object, or bytes."""
    if isinstance(path_or_data, (bytes, bytearray)):
        return bytes(path_or_data)
    if isinstance(path_or_data, _stdio.IOBase):
        return path_or_data.read()
    with _open(path_or_data) as f:
        return f.read()


def sniff_format(path: PathLike) -> str:
    """'fasta' | 'fastq' from the extension, else from the first byte
    ('>' FASTA, '@' FASTQ); .gz-transparent. Raises ValueError when neither
    identifies the file."""
    p = os.fspath(path)
    low = p.lower()
    for ext, fmt in (
        (".fa", "fasta"), (".fasta", "fasta"), (".fna", "fasta"),
        (".fq", "fastq"), (".fastq", "fastq"),
    ):
        if low.endswith(ext) or low.endswith(ext + ".gz"):
            return fmt
    with _open(p) as f:
        first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"{p}: cannot sniff format (first byte {first!r})")


def _split_records_fasta(data: bytes) -> Tuple[List[bytes], List[bytes]]:
    """(names, sequences) from FASTA bytes; sequences may span lines. A
    record starts with '>' at the start of a line only ('>' is legal inside
    a header)."""
    names: List[bytes] = []
    seqs: List[bytes] = []
    body = data[1:] if data.startswith(b">") else data
    for chunk in body.split(b"\n>") if data else []:
        if not chunk.strip():
            continue
        nl = chunk.find(b"\n")
        if nl < 0:
            names.append(chunk.strip())
            seqs.append(b"")
            continue
        names.append(chunk[:nl].strip())
        seqs.append(chunk[nl + 1 :].replace(b"\n", b"").replace(b"\r", b""))
    return names, seqs


def read_fasta(
    path_or_data, max_len: Optional[int] = None, validate: bool = True, device=None
) -> Tuple[List[bytes], PackedReads]:
    """Parse FASTA (path, .gz path, bytes, or file object) -> (names,
    reads packed on ``device``, default the card)."""
    names, seqs = _split_records_fasta(_read_bytes(path_or_data))
    return names, PackedReads.from_ascii(
        seqs, max_len=max_len, validate=validate, device=device
    )


# -- FASTQ records --------------------------------------------------------------


def split_records_fastq_full(data: bytes) -> Tuple[List[bytes], List[bytes], List[bytes]]:
    """(headers with '@', sequences, quality lines) from FASTQ bytes,
    stripped, skipping blank lines where a header is expected: the
    record parser of the commands that re-emit records verbatim."""
    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[bytes] = []
    f = _stdio.BytesIO(data)
    while True:
        h = f.readline()
        if not h:
            break
        if not h.strip():
            continue
        names.append(h.strip())
        seqs.append(f.readline().strip())
        f.readline()
        quals.append(f.readline().strip())
    return names, seqs, quals


def _split_records_fastq(data: bytes) -> Tuple[List[bytes], List[bytes]]:
    """(names without '@', sequences) from FASTQ bytes of strict 4-line
    records; ValueError on a header that does not start with '@'."""
    lines = data.split(b"\n")
    names: List[bytes] = []
    seqs: List[bytes] = []
    for i in range(len(lines) // 4):
        h = lines[4 * i]
        if not h.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header at record {i}: {h[:40]!r}")
        names.append(h[1:].strip())
        seqs.append(lines[4 * i + 1].strip())
    return names, seqs


def read_fastq(
    path_or_data, max_len: Optional[int] = None, validate: bool = True, device=None
) -> Tuple[List[bytes], PackedReads]:
    """Parse FASTQ (path, .gz path, bytes or file object) of strict 4-line
    records -> (names, reads packed on ``device``, default the card)."""
    names, seqs = _split_records_fastq(_read_bytes(path_or_data))
    return names, PackedReads.from_ascii(
        seqs, max_len=max_len, validate=validate, device=device
    )


def read_fastq_fast(
    path_or_data, max_len: Optional[int] = None, validate: bool = True, device=None
) -> PackedReads:
    """Name-free FASTQ ingestion: the whole buffer framed by the host
    library's scanner, or by its twin ``fastq_to_batch`` without the
    library (rules that differ from ``read_fastq``'s on blank lines),
    packed on ``device`` (default: the card)."""
    ascii_arr, lens = _to_batch(native.available())(_read_bytes(path_or_data), max_len)
    return PackedReads.from_ascii(ascii_arr, lengths=lens, validate=validate, device=device)


# -- FASTQ framing ------------------------------------------------------------


def _fastq_lines(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of the lines that frame FASTQ records, as the JAX
    package's native scanner frames them (``bn_fastq_fill``): a trailing
    '\\r' is not part of a line, a last line without '\\n' counts, and a
    blank line is skipped only where a header is expected; elsewhere it is a
    line of length 0 (an empty sequence or quality)."""
    if not arr.size:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    nl = np.flatnonzero(arr == 10)
    if nl.size == 0 or nl[-1] != arr.size - 1:
        nl = np.append(nl, arr.size)
    starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    lens = nl - starts
    lens = lens - ((lens > 0) & (arr[np.maximum(nl - 1, 0)] == 13))
    blank = np.flatnonzero(lens == 0)
    if not blank.size:
        return starts, lens
    # a blank line is dropped where the lines kept before it fill whole
    # records; only blank lines need the walk
    keep = np.ones(starts.size, bool)
    dropped = 0
    for i in blank.tolist():
        if (i - dropped) % 4 == 0:
            keep[i] = False
            dropped += 1
    return starts[keep], lens[keep]


def _rectangle(arr: np.ndarray, starts: np.ndarray, lens: np.ndarray, B: int, L: int):
    """uint8 [B, L] holding arr[starts[r] : starts[r] + min(lens[r], L)] in
    row r for the given rows (fewer than B leave zero rows), and the
    clamped lengths."""
    lens = np.minimum(lens, L).astype(np.int32)
    out = np.zeros((B, L), np.uint8)
    n = starts.size
    if n and arr.size:
        cols = np.arange(L, dtype=np.int64)
        idx = np.minimum(starts[:, None] + cols[None, :], arr.size - 1)
        out[:n] = np.where(cols[None, :] < lens[:, None], arr[idx], 0)
    return out, lens


def _framed(data: bytes, max_len: Optional[int]):
    """The bytes, their framed lines (``_fastq_lines``) and the sequence
    rectangle: L is max_len, or the longest read (at least 1)."""
    arr = np.frombuffer(data, np.uint8)
    starts, lens = _fastq_lines(arr)
    seq_starts, seq_lens = starts[1::4], lens[1::4]
    B = seq_starts.size
    L = int(max_len) if max_len else max(int(seq_lens.max()) if B else 0, 1)
    return (arr, starts, lens) + _rectangle(arr, seq_starts, seq_lens, B, L)


def _to_batch(use_native: bool):
    """The sequence framer: the host library's, or its numpy twin."""
    if use_native:
        return lambda data, max_len: native.fastq_to_batch(data, max_len or 0)
    return fastq_to_batch


def _to_batch_sq(use_native: bool):
    """The full-record framer: the host library's, or its numpy twin."""
    if use_native:
        return lambda data, max_len: native.fastq_to_batch_sq(data, max_len or 0)
    return fastq_to_batch_sq


def fastq_to_batch(data: bytes, max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """FASTQ bytes -> (ascii uint8 [B, L], lengths int32 [B]), vectorized;
    equal to the JAX package's ``native.fastq_to_batch``.

    The sequence is the second line of each record (``_fastq_lines``); a
    trailing record cut short after its sequence still counts. L is
    max_len, or the longest read (at least 1); longer reads are
    truncated."""
    return _framed(data, max_len)[3:]


def fastq_to_batch_sq(data: bytes, max_len: Optional[int] = None):
    """Full-record FASTQ parse, the numpy twin of the JAX package's
    ``native.fastq_to_batch_sq``: (ascii uint8 [B, L], quals uint8 [B, L],
    lengths int32 [B], name_off int64 [B], name_len int64 [B]).

    Records are framed as in ``fastq_to_batch``. Qualities are clamped to
    L like the sequence, and a record cut short before its quality line
    has a zero quality row. ``name_off`` points past the '@' into
    ``data``; ``name_len`` excludes a trailing '\\r'."""
    arr, starts, lens, ascii_arr, seq_lens = _framed(data, max_len)
    B, L = ascii_arr.shape
    quals, _ = _rectangle(arr, starts[3::4], lens[3::4], B, L)
    hdr_starts, hdr_lens = starts[0::4][:B], lens[0::4][:B]
    return (ascii_arr, quals, seq_lens, hdr_starts + 1,
            np.maximum(hdr_lens - 1, 0).astype(np.int64))


def _iter_fastq_record_blocks(path: PathLike, batch_size: int, start_offset: int = 0):
    """Yield (record_bytes, end_byte_offset) chunks of exactly ``batch_size``
    FASTQ records (the trailing partial group comes last). Blank lines do
    not advance the framing; headers are checked. Offsets of a ``.gz`` file
    count decompressed bytes (a seek there decompresses the prefix)."""
    carry = b""
    abs_base = start_offset  # stream offset of data[0]
    with _open(path) as f:
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


def _ascii_batches(path, batch_size, max_len, start_offset, use_native: bool):
    frame = _to_batch(use_native)
    for data, end in _iter_fastq_record_blocks(path, batch_size, start_offset):
        ascii_arr, lens = frame(data, max_len)
        if len(lens):
            yield ascii_arr, lens, end


def iter_fastq_ascii_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
    start_offset: int = 0,
):
    """Host-only streaming parse: (ascii uint8 [B, L], lengths int32 [B],
    end byte offset) per batch of ``batch_size`` records, framed as
    ``iter_fastq_batches`` frames them (its host side; the host library's
    scanner, else its numpy twin); no device work."""
    return _ascii_batches(path, batch_size, max_len, start_offset, native.available())


def iter_fastq_record_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
):
    """Full-record streaming parse for the preprocessing tier: (raw bytes,
    ascii uint8 [B, L], quals uint8 [B, L], lens int32 [B], name_off int64
    [B], name_len int64 [B]) per batch (the host library's
    ``fastq_to_batch_sq``, else its numpy twin); the header spans index into
    the raw bytes, past the '@'."""
    frame = _to_batch_sq(native.available())
    for data, _ in _iter_fastq_record_blocks(path, batch_size):
        ascii_arr, quals, lens, name_off, name_len = frame(data, max_len)
        if len(lens):
            yield data, ascii_arr, quals, lens, name_off, name_len


def _prefetched(gen: Iterator, depth: int) -> Iterator:
    """Drain ``gen`` on a daemon thread into a queue of ``depth`` items.
    Keeps the order; an exception raised in ``gen`` re-raises at the
    consumer's next pull. A consumer that stops early (break, exception,
    GeneratorExit) stops the worker, which closes ``gen`` (and its file),
    and waits for it to end."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for item in gen:
                    if not put(item):
                        return
                put(done)
            except BaseException as e:  # handed to the consumer
                put(e)
        finally:
            gen.close()

    t = threading.Thread(target=worker, name="fastq-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def iter_fastq_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
    validate: bool = True,
    staged: Optional[bool] = None,
    prefetch: int = 0,
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
    validate=True raises InvalidBase on the first invalid in-range base.
    ``staged`` selects the framing: the host library's scanner (True; None
    where the library loads) or its numpy twin (False; None without the
    library). True without the library raises RuntimeError, as in the JAX
    package. Either way the batch is uploaded as ASCII and packed by K1.
    ``prefetch > 0`` frames up to that many batches ahead on a producer
    thread; the upload and K1 run on the caller's thread.
    ``device`` defaults to the card (``config.resolve_device``)."""
    use_native = native.available() if staged is None else bool(staged)
    if use_native and not native.available():
        raise RuntimeError(
            "staged=True but the host library is not available "
            f"({native._error}); use staged=None or False for the numpy framing"
        )
    device = config.resolve_device(device)
    source = _ascii_batches(path, batch_size, max_len, start_offset, use_native)
    if prefetch > 0:
        source = _prefetched(source, prefetch)
    with contextlib.closing(source):  # an early stop ends the worker and the file
        for ascii_arr, lens, end in source:
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
