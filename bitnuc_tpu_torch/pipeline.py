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

With a mesh (``parallel.mesh.Mesh``), each batch is split over the mesh
axis: dense counts merge with one psum a batch
(``parallel.kmer.count_kmers_sharded``); above k = 12 every device keeps its
own run list (``_ShardedSparseAcc``), fed with no communication, and the
lists merge once at the end (``parallel.kmer.gather_runs_sharded``).

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


def _runs_dict(lo, hi, counts) -> dict:
    """{packed k-mer (hi << 32 | lo): count} of a run-start list."""
    lo, hi, counts = kmer_ops.compact_runs(lo, hi, counts)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return dict(zip(keys.tolist(), counts.tolist()))


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
        return _runs_dict(*self.state)


class _ShardedSparseAcc:
    """The distributed twin of _SparseAcc: every device owns a ``cap``-row
    run list fed by its own batch shards. Adds and merges are per device
    with no communication (``parallel.kmer.merge_runs_sharded``); the one
    all_gather and merge happen at the end (``gather_runs_sharded``)."""

    def __init__(self, cap, mesh, axis: str = "data", state=None):
        from .parallel import kmer as pkmer

        self._pk = pkmer
        self.cap = int(cap)
        self.mesh, self.axis = mesh, axis
        self.n_dev = mesh.shape[axis]
        self.state = state if state is not None else pkmer.sparse_state_sharded(
            self.cap, mesh, axis)
        self.pending = []
        self.pending_rows = 0  # rows a device

    @classmethod
    def from_host_runs(cls, lo, hi, counts, mesh, axis: str = "data"):
        """Rebuild from host run-list arrays (uint32, uint32, int32; a
        checkpoint's). Rows are independent (key, count) pairs, so any even
        split over the devices serves: pad to a device multiple with dead
        sentinel rows and split."""
        from .parallel import mesh as pmesh

        n_dev = mesh.shape[axis]
        n = lo.shape[0]
        pad = (-n) % n_dev
        if pad:
            lo = np.concatenate([lo, np.full(pad, 0xFFFFFFFF, np.uint32)])
            hi = np.concatenate([hi, np.full(pad, 0xFFFFFFFF, np.uint32)])
            counts = np.concatenate([counts, np.zeros(pad, np.int32)])
        state = tuple(
            pmesh.Sharded(pmesh.split(bitops.words_from_u32_np(a), mesh, axis), mesh, axis)
            for a in (lo, hi, counts.view(np.uint32))
        )
        return cls((n + pad) // n_dev, mesh, axis, state=state)

    def add(self, lo, hi, ct):
        self.pending.append((lo, hi, ct))
        self.pending_rows += int(lo.shape[0]) // self.n_dev
        if self.pending_rows >= self.cap:
            self.flush()

    def flush(self):
        if not self.pending:
            return
        while True:
            lo, hi, ct, n_max = self._pk.merge_runs_sharded(
                (self.state, *self.pending), self.cap, self.mesh, self.axis)
            if int(n_max) <= int(0.95 * self.cap):
                self.state = (lo, hi, ct)
                self.pending = []
                self.pending_rows = 0
                return
            self.cap *= 2  # rare: merge again at twice the capacity
            self.state = self._pk.grow_state_sharded(self.state, self.cap, self.mesh, self.axis)

    def host_state(self):
        """(lo uint32, hi uint32, counts int32) of every device's rows, in
        mesh order: a checkpoint's run list."""
        lo, hi, counts = (bitops.words_to_u32_np(a.full()) for a in self.state)
        return lo, hi, counts.view(np.int32)

    def to_dict(self) -> dict:
        """{packed k-mer (hi << 32 | lo): count} of the whole job."""
        self.flush()
        return _runs_dict(*self._pk.gather_runs_sharded(*self.state, self.mesh, self.axis)[:3])


def _shard_batch_with_valid(reads, base_valid, mesh, axis):
    """shard_reads, and base_valid padded and split the same way (None
    stays None)."""
    from .parallel import mesh as pmesh

    sharded = pmesh.shard_reads(reads, mesh, axis)
    bvs = None
    if base_valid is not None:
        bv = pmesh.pad_rows(base_valid, sharded.batch_size)
        bvs = pmesh.Sharded(pmesh.split(bv, mesh, axis), mesh, axis)
    return sharded, bvs


def _mesh_device(mesh, device):
    """The device batches load on: ``device`` if named, else the mesh's
    first device."""
    if device is None and mesh is not None:
        return mesh.flat_devices[0]
    return config.resolve_device(device)


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


def _count_batch(acc, dense, total_windows, reads, base_valid, n_windows, k, canonical,
                 mesh=None, axis="data"):
    """Count one batch into ``acc``: dense into the histogram, else its raw
    window keys into the run-list accumulator; with a mesh, split over
    ``axis`` first."""
    if not dense and total_windows > _SPARSE_MAX_WINDOWS:
        raise OverflowError(
            f"sparse counts are int32-bounded at {_SPARSE_MAX_WINDOWS} windows "
            "per job; split the input across jobs and merge the run lists"
        )
    if mesh is None:
        if dense:
            acc.add(kmer_ops.count_kmers_reads(reads.words, reads.lengths, k,
                                               canonical=canonical, base_valid=base_valid),
                    n_windows)
        else:
            acc.add(*kmer_ops.raw_window_keys(reads.words, reads.lengths, k, canonical,
                                              base_valid))
        return
    from .parallel import kmer as pkmer

    sharded, bvs = _shard_batch_with_valid(reads, base_valid, mesh, axis)
    if dense:
        acc.add(pkmer.count_kmers_sharded(sharded.words, sharded.lengths, k, mesh, axis,
                                          canonical=canonical, base_valid=bvs), n_windows)
    else:
        acc.add(*pkmer.raw_window_keys_sharded(sharded.words, sharded.lengths, k, mesh, axis,
                                               canonical, bvs))


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
    mesh: a ``parallel.mesh.Mesh`` — batches split over ``axis``; dense k
    merges with one psum a batch, larger k keeps a run list a device
    merged once at the end (``_ShardedSparseAcc``). Batches load on
    ``device``, by default the mesh's first device. A checkpoint written
    at one mesh size (or none) resumes at any other.
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
    skip = _check_on_invalid(on_invalid)
    device = _mesh_device(mesh, device)
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
        acc = _DenseAcc(k, device if mesh is None else mesh.flat_devices[0], state)
    elif mesh is not None:
        # rows are independent (key, count) pairs: a checkpoint written at
        # any mesh size (or none) resumes at any other
        acc = (_ShardedSparseAcc(sparse_capacity, mesh, axis) if state is None
               else _ShardedSparseAcc.from_host_runs(*state, mesh, axis))
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
            if mesh is not None:
                lo, hi, counts = acc.host_state()
            else:
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
            _count_batch(acc, dense, total_windows, batch, base_valid, batch_bases, k,
                         canonical, mesh, axis)
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
    InvalidBase. mesh: segments go in groups of the axis size (the last
    padded with empty rows), each group split over ``axis`` and counted
    sharded (dense: one psum a group; larger k: a run list a device, one
    merge at the end); segments are independent, so grouping is exact."""
    if not 1 <= k <= 32:
        raise InvalidLength(k)
    skip = _check_on_invalid(on_invalid)
    device = _mesh_device(mesh, device)
    seg = int(seg_bases)
    if seg < 16:
        raise ValueError(f"seg_bases must be >= 16, got {seg}")
    dense = k <= kmer_ops.MAX_DENSE_K
    group = 1 if mesh is None else int(mesh.shape[axis])
    if dense:
        acc = _DenseAcc(k, device if mesh is None else mesh.flat_devices[0])
    elif mesh is None:
        acc = _SparseAcc(sparse_capacity, device)
    else:
        acc = _ShardedSparseAcc(sparse_capacity, mesh, axis)
    _, seqs = bnio._split_records_fasta(bnio._read_bytes(path))
    longest = max((len(c) for c in seqs), default=0)
    seg = min(seg, longest)
    width = seg + k - 1
    total_windows = 0
    bufs, lens = [], []

    def dispatch():
        nonlocal total_windows
        if not bufs:
            return
        while len(bufs) < group:  # empty rows keep the group's shape
            bufs.append(np.zeros(width, np.uint8))
            lens.append(0)
        # fresh buffers every group: torch.from_numpy aliases its array
        block = np.stack(bufs)
        lengths = np.asarray(lens, np.int32)
        reads = PackedReads.from_ascii(block, lengths=lengths, validate=not skip,
                                       device=device)
        bv = None
        if skip:
            bv = bnio._VALID_BASE[block] & (np.arange(width)[None, :] < lengths[:, None])
            bv = torch.from_numpy(bv).to(device)
        n_win = int(lengths.sum())
        total_windows += n_win
        _count_batch(acc, dense, total_windows, reads, bv, n_win, k, canonical, mesh, axis)
        bufs.clear()
        lens.clear()

    for contig in seqs if longest >= k else []:
        arr = np.frombuffer(contig, np.uint8)
        for s in range(0, len(arr), seg):
            # bases [s, s + seg + k - 1): the length argument restricts the
            # window starts to [s, s + seg)
            chunk = arr[s : s + seg + k - 1]
            L = len(chunk)
            if L < k:
                continue  # shorter than a window: nothing to count
            buf = np.zeros(width, np.uint8)
            buf[:L] = chunk
            bufs.append(buf)
            lens.append(L)
            if len(bufs) == group:
                dispatch()
    dispatch()
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
