"""Streaming, restartable k-mer counting of FASTQ and FASTA files.

The counterpart of ``bitnuc_tpu/pipeline.py``'s ``count_fastq``,
``count_fasta`` and ``stats`` on one device. Each batch is packed on the
device (K1).

Accumulators:

* k <= 12 (``_DenseAcc``): the batch is counted into an int32 device
  histogram (K3a/K3b), folded into an int64 host histogram before any bin
  could pass 2^31, so totals are exact at any job size.
* k > 12 (``_SparseAcc``): the batch's raw window keys
  (``ops.kmer.raw_window_keys``, no per-batch sort) wait on the device until
  they fill the accumulator's capacity; one merge (``merge_sorted_runs`` and
  a compaction sort) then folds them into the sorted run list. Capacity
  doubles when the distinct keys pass 95% of it. The prefix sums are int32,
  so a job holds at most 2^31 - 2 windows and refuses more.

Checkpoints keep the JAX package's format: ``CKPT_VERSION`` 2, the same
parameters and file fingerprint, and ``engine`` "dense" (the int64
``hist``) or "sparse" (``lo`` and ``hi`` as uint32, ``counts`` as int32). A
checkpoint that either package wrote resumes in the other. Resume seeks to
the stored byte offset, so no consumed record is parsed again.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from . import config, io as bnio
from .errors import InvalidLength
from .ops import kmer as kmer_ops
from .sequence import PackedReads
from .utils import bitops

CKPT_VERSION = 2
_FOLD_WINDOWS = 1 << 30  # fold the device int32 partial into int64 before this
_SPARSE_MAX_WINDOWS = (1 << 31) - 2
_SENT = kmer_ops.SENT


def _file_fingerprint(path) -> dict:
    """Cheap identity for resume safety: size + sha1 of the first 1 MiB."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    return {"file_size": size, "file_sha1_head": hashlib.sha1(head).hexdigest()}


class _DenseAcc:
    """int32 device partial folded into an int64 host histogram before any
    bin can saturate."""

    def __init__(self, k, device, host_hist=None):
        self.k = k
        self.device = device
        self.host = host_hist if host_hist is not None else np.zeros(4**k, np.int64)
        self.partial = torch.zeros(4**k, dtype=torch.int32, device=device)
        self.windows = 0

    def add(self, hist_delta, n_windows):
        if self.windows + n_windows >= _FOLD_WINDOWS:
            self.fold()  # BEFORE the add: no bin may cross int32 mid-batch
        self.partial += hist_delta
        self.windows += n_windows

    def fold(self):
        if self.windows:
            self.host = self.host + self.partial.cpu().numpy().astype(np.int64)
            self.partial.zero_()
            self.windows = 0

    def result(self):
        self.fold()
        return self.host


def _merge_runs_device(acc, pending, cap):
    """Merge the accumulator's run list with pending raw or run lists ->
    (run-start list of ``cap`` rows, n_unique).

    Two sorts: aggregation needs sorted order, and compaction
    (``compact_live``) needs the deadness known only after it."""
    parts = [acc, *pending]
    lo = torch.cat([p[0] for p in parts])
    hi = torch.cat([p[1] for p in parts])
    ct = torch.cat([p[2].to(torch.int32) for p in parts])
    lo_u, hi_u, tot, n_unique = kmer_ops.merge_sorted_runs(lo, hi, ct)
    return kmer_ops.compact_live(lo_u, hi_u, tot, cap), n_unique


class _SparseAcc:
    """Device-resident run-list accumulator (lo, hi, counts of ``cap``
    rows) with deferred merging and capacity doubling. Pending entries are
    raw window keys (weight 0 on invalid slots) or sorted run lists (a
    resumed checkpoint's state): the merge sorts whatever it is fed."""

    def __init__(self, cap, device, state=None):
        self.cap = int(cap)
        self.state = state or (
            torch.full((self.cap,), _SENT, dtype=torch.int32, device=device),
            torch.full((self.cap,), _SENT, dtype=torch.int32, device=device),
            torch.zeros(self.cap, dtype=torch.int32, device=device),
        )
        self.pending = []
        self.pending_rows = 0

    def add(self, lo, hi, ct):
        self.pending.append((lo, hi, ct))
        self.pending_rows += int(lo.shape[0])
        if self.pending_rows >= self.cap:
            self.flush()

    def flush(self):
        if not self.pending:
            return
        while True:
            merged, n_unique = _merge_runs_device(self.state, self.pending, self.cap)
            if int(n_unique) <= int(0.95 * self.cap):
                self.state = merged
                self.pending = []
                self.pending_rows = 0
                return
            self.cap *= 2  # rare: merge again at twice the capacity
            self.state = tuple(
                torch.cat([a, a.new_full((self.cap - a.shape[0],), fill)])
                for a, fill in zip(self.state, (_SENT, _SENT, 0))
            )

    def to_dict(self) -> dict:
        """{packed k-mer (hi << 32 | lo): count} of the whole job."""
        self.flush()
        lo, hi, counts = kmer_ops.compact_runs(*self.state)
        keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        return dict(zip(keys.tolist(), counts.tolist()))


def _load_checkpoint(checkpoint: str, params: dict):
    """(n_batches, offset, total_windows, state) of a checkpoint written
    with ``params``: state is the int64 hist of the dense engine or the
    (lo uint32, hi uint32, counts int32) run list of the sparse one. Any
    mismatch raises instead of mixing counts."""
    with np.load(checkpoint, allow_pickle=False) as z:
        if int(z["version"]) != CKPT_VERSION:
            raise ValueError(
                f"checkpoint {checkpoint!r} has version {int(z['version'])}, "
                f"expected {CKPT_VERSION}"
            )
        for key, want in params.items():
            if key not in z.files:
                raise ValueError(
                    f"checkpoint {checkpoint!r} was written without {key!r} "
                    f"(older layout), current run has {want!r} — refusing to mix"
                )
            got = z[key][()] if z[key].shape == () else z[key]
            got = got.item() if hasattr(got, "item") else got
            if isinstance(want, str):
                got = str(got)
            if got != want:
                raise ValueError(
                    f"checkpoint {checkpoint!r} was written with {key}="
                    f"{got!r}, current run has {want!r} — refusing to mix"
                )
        if params["engine"] == "dense":
            state = z["hist"].astype(np.int64)
        else:
            state = (
                z["lo"].astype(np.uint32),
                z["hi"].astype(np.uint32),
                z["counts"].astype(np.int32),
            )
        return int(z["n_batches"]), int(z["offset"]), int(z["total_windows"]), state


def _check_on_invalid(on_invalid: str) -> bool:
    """True for "skip"; raises on anything but "raise" and "skip"."""
    if on_invalid not in ("raise", "skip"):
        raise ValueError(f"on_invalid must be 'raise' or 'skip', got {on_invalid!r}")
    return on_invalid == "skip"


def _sparse_add(acc, total_windows, words, lengths, k, canonical, base_valid):
    if total_windows > _SPARSE_MAX_WINDOWS:
        raise OverflowError(
            f"sparse counts are int32-bounded at {_SPARSE_MAX_WINDOWS} windows "
            "per job; split the input across jobs and merge the run lists"
        )
    acc.add(*kmer_ops.raw_window_keys(words, lengths, k, canonical, base_valid))


def count_fastq(
    path,
    k: int,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    canonical: bool = False,
    validate: bool = True,
    mesh=None,
    axis: str = "data",
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 50,
    prefetch: int = 2,
    sparse_capacity: int = 1 << 20,
    on_invalid: str = "raise",
    on_progress=None,
    progress_every: int = 50,
    device=None,
):
    """Stream a FASTQ file (plain or ``.gz``) into k-mer counts on
    ``device`` (default: the card, see ``config.resolve_device``),
    optionally crash-resumable.

    Returns a dense int64 [4^k] numpy histogram for k <= 12, else a dict
    {packed_kmer: count} (packed_kmer = hi << 32 | lo, the reference's u64).
    checkpoint: path of an .npz written every ``checkpoint_every`` batches
    (atomic rename). An existing checkpoint resumes at its stored byte
    offset after its fingerprint (file identity, k, batch_size, max_len,
    canonical, on_invalid, engine) is checked; a mismatch raises.
    mesh, axis: the JAX package's sharded job; a mesh raises
    NotImplementedError here.
    prefetch: batches framed ahead on a producer thread
    (``io.iter_fastq_batches``); 0 frames on the caller's thread.
    sparse_capacity: the first row capacity of the k > 12 accumulator (it
    doubles on demand).
    on_invalid: "raise" (InvalidBase) or "skip" — drop every window holding
    an N/ambiguous base.
    on_progress: optional callable given {"batches", "reads", "bases",
    "bases_per_sec"} every ``progress_every`` batches."""
    if not 1 <= k <= 32:
        raise InvalidLength(k)
    config.require_no_mesh(mesh, "count_fastq")
    skip = _check_on_invalid(on_invalid)
    device = config.resolve_device(device)
    dense = k <= kmer_ops.MAX_DENSE_K

    params = {
        "k": k,
        "batch_size": batch_size,
        "max_len": -1 if max_len is None else int(max_len),
        "canonical": int(canonical),
        "on_invalid": on_invalid,
        "engine": "dense" if dense else "sparse",
        **_file_fingerprint(path),
    }

    start_batches = 0
    start_offset = 0
    total_windows = 0
    state = None
    if checkpoint and os.path.exists(checkpoint):
        start_batches, start_offset, total_windows, state = _load_checkpoint(
            checkpoint, params
        )
    if dense:
        acc = _DenseAcc(k, device, state)
    elif state is not None:
        acc = _SparseAcc(
            state[0].shape[0], device,
            state=tuple(bitops.words_from_u32_np(a).to(device) for a in state),
        )
    else:
        acc = _SparseAcc(sparse_capacity, device)

    def save(n_batches, offset):
        payload = {
            "version": CKPT_VERSION,
            "n_batches": n_batches,
            "offset": offset,
            "total_windows": total_windows,
            **params,
        }
        if dense:
            acc.fold()
            payload["hist"] = acc.host
        else:
            acc.flush()  # the stored offset covers every pending batch
            lo, hi, counts = (bitops.words_to_u32_np(a) for a in acc.state)
            payload.update(lo=lo, hi=hi, counts=counts.view(np.int32))
        tmp = f"{checkpoint}.tmp.{os.getpid()}.npz"
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, checkpoint)

    n_batches = start_batches
    n_reads = 0
    n_bases = 0
    last_offset = start_offset
    t0 = time.perf_counter()
    batches = bnio.iter_fastq_batches(
        path,
        batch_size,
        max_len=max_len,
        validate=validate and not skip,
        prefetch=prefetch,
        with_validity=skip,
        with_offsets=True,
        start_offset=start_offset,
        device=device,
    )
    # a raise in the loop (on_progress, a checkpoint, a bad base) ends the
    # producer thread and closes the file before it propagates; a stored
    # offset is that of a batch consumed here, not of one framed ahead
    with contextlib.closing(batches):
        for item in batches:
            if skip:
                batch, base_valid, offset = item
            else:
                (batch, offset), base_valid = item, None
            batch_bases = int(batch.lengths.sum())
            total_windows += batch_bases  # an upper bound of the batch's windows
            if dense:
                acc.add(
                    kmer_ops.count_kmers_reads(
                        batch.words, batch.lengths, k, canonical=canonical,
                        base_valid=base_valid,
                    ),
                    batch_bases,
                )
            else:
                _sparse_add(acc, total_windows, batch.words, batch.lengths, k,
                            canonical, base_valid)
            n_batches += 1
            n_reads += len(batch)
            n_bases += batch_bases
            if checkpoint and (n_batches - start_batches) % checkpoint_every == 0:
                save(n_batches, offset)
            if on_progress and (n_batches - start_batches) % progress_every == 0:
                dt = max(time.perf_counter() - t0, 1e-9)
                on_progress(
                    {
                        "batches": n_batches,
                        "reads": n_reads,
                        "bases": n_bases,
                        "bases_per_sec": n_bases / dt,
                    }
                )
            last_offset = offset

    if checkpoint:
        save(n_batches, last_offset)
    return acc.result() if dense else acc.to_dict()


def count_fasta(
    path,
    k: int,
    canonical: bool = False,
    on_invalid: str = "raise",
    seg_bases: int = 1 << 24,
    sparse_capacity: int = 1 << 20,
    mesh=None,
    axis: str = "data",
    device=None,
):
    """Count k-mers over every contig of a FASTA file (path, .gz path, or
    bytes) on ``device`` (default: the card, see ``config.resolve_device``).

    Each contig is counted in segments of ``seg_bases`` with a (k-1)-base
    overlap: a segment counts exactly the windows that START in its span,
    so the segments sum to the whole contig's count. Windows never span
    contigs. Every segment has the same width, so every batch has one
    shape.

    Returns what count_fastq returns: an int64 [4^k] histogram for k <= 12,
    else {packed_kmer: count}. on_invalid="skip" drops windows touching an
    N/ambiguous base (assemblies are full of Ns); "raise" raises
    InvalidBase. A ``mesh`` raises NotImplementedError (the JAX package's
    sharded job)."""
    if not 1 <= k <= 32:
        raise InvalidLength(k)
    config.require_no_mesh(mesh, "count_fasta")
    skip = _check_on_invalid(on_invalid)
    device = config.resolve_device(device)
    seg = int(seg_bases)
    if seg < 16:
        raise ValueError(f"seg_bases must be >= 16, got {seg}")
    dense = k <= kmer_ops.MAX_DENSE_K
    acc = _DenseAcc(k, device) if dense else _SparseAcc(sparse_capacity, device)
    _, seqs = bnio._split_records_fasta(bnio._read_bytes(path))
    longest = max((len(c) for c in seqs), default=0)
    seg = min(seg, longest)
    width = seg + k - 1
    total_windows = 0
    for contig in seqs if longest >= k else []:
        arr = np.frombuffer(contig, np.uint8)
        for s in range(0, len(arr), seg):
            # bases [s, s + seg + k - 1): the length argument restricts the
            # window starts to [s, s + seg)
            chunk = arr[s : s + seg + k - 1]
            L = len(chunk)
            if L < k:
                continue  # shorter than a window: nothing to count
            # a fresh buffer per segment: torch.from_numpy aliases its array
            buf = np.zeros((1, width), np.uint8)
            buf[0, :L] = chunk
            lengths = np.array([L], np.int32)
            reads = PackedReads.from_ascii(buf, lengths=lengths, validate=not skip,
                                           device=device)
            bv = None
            if skip:
                bv = bnio._VALID_BASE[buf] & (np.arange(width) < L)[None, :]
                bv = torch.from_numpy(bv).to(device)
            total_windows += L
            if dense:
                acc.add(
                    kmer_ops.count_kmers_reads(
                        reads.words, reads.lengths, k, canonical=canonical, base_valid=bv
                    ),
                    L,
                )
            else:
                _sparse_add(acc, total_windows, reads.words, reads.lengths, k,
                            canonical, bv)
    return acc.result() if dense else acc.to_dict()


def stats(path, batch_size: int = 4096, validate: bool = True, device=None) -> dict:
    """Streaming composition statistics of a FASTA or FASTQ file: {"reads",
    "bases", "a", "c", "g", "t", "gc_pct", "min_len", "max_len",
    "mean_len", "n50", "l50"}, the sums of ``ops.analysis.base_counts_reads``
    over the file. FASTQ streams in ``batch_size`` batches through
    ``io.iter_fastq_batches``; FASTA is read whole (``io.read_fasta``), one
    row a contig. validate=True raises InvalidBase on N and other bytes
    outside ACGTacgt. ``device`` defaults to the card."""
    from .ops import analysis

    device = config.resolve_device(device)
    n_reads = n_bases = max_len = 0
    counts = np.zeros(4, np.int64)
    min_len = None
    len_hist: dict = {}  # length -> reads; N50 comes from this at the end

    def fold(reads):
        nonlocal n_reads, n_bases, min_len, max_len
        lens = reads.lengths.cpu().numpy()
        if lens.size == 0:
            return
        bc = analysis.base_counts_reads(reads.words, reads.lengths).cpu().numpy()
        counts[:] += bc.astype(np.int64).sum(axis=0)
        n_reads += lens.size
        n_bases += int(lens.sum())
        min_len = int(lens.min()) if min_len is None else min(min_len, int(lens.min()))
        max_len = max(max_len, int(lens.max()))
        for u, c in zip(*np.unique(lens, return_counts=True)):
            len_hist[int(u)] = len_hist.get(int(u), 0) + int(c)

    if bnio.sniff_format(path) == "fasta":
        fold(bnio.read_fasta(path, validate=validate, device=device)[1])
    else:
        for batch in bnio.iter_fastq_batches(path, batch_size, validate=validate, device=device):
            fold(batch)

    # N50: the shortest length of the fewest longest reads that cover at
    # least half the bases; L50: how many reads that takes
    n50 = l50 = 0
    if n_bases:
        half = (n_bases + 1) // 2
        acc = 0
        for length in sorted(len_hist, reverse=True):
            cnt = len_hist[length]
            if acc + length * cnt >= half:
                n50 = length
                l50 += -((acc - half) // length)  # ceil((half - acc) / length)
                break
            acc += length * cnt
            l50 += cnt

    gc = int(counts[1] + counts[2])
    return {
        "reads": n_reads,
        "bases": n_bases,
        "a": int(counts[0]),
        "c": int(counts[1]),
        "g": int(counts[2]),
        "t": int(counts[3]),
        "gc_pct": round(gc / n_bases * 100.0, 4) if n_bases else 0.0,
        "min_len": min_len or 0,
        "max_len": max_len,
        "mean_len": round(n_bases / n_reads, 2) if n_reads else 0.0,
        "n50": n50,
        "l50": l50,
    }
