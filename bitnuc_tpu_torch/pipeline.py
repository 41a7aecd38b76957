"""Streaming, restartable dense k-mer counting of FASTQ files.

The counterpart of ``bitnuc_tpu/pipeline.py::count_fastq`` for the dense
engine (k <= 12) on one device. Each batch is packed on the device (K1) and
counted into an int32 histogram there (K3a/K3b); ``_DenseAcc`` folds that
partial into an int64 host histogram before any bin could pass 2^31, so
totals are exact at any job size.

Checkpoints keep the JAX package's format: ``CKPT_VERSION`` 2, the same
parameters and file fingerprint, and the int64 ``hist``. A checkpoint that
either package wrote resumes in the other. Resume seeks to the stored byte
offset, so no consumed record is parsed again.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from . import io as bnio
from .errors import InvalidLength
from .ops import kmer as kmer_ops

CKPT_VERSION = 2
_FOLD_WINDOWS = 1 << 30  # fold the device int32 partial into int64 before this


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


def _load_checkpoint(checkpoint: str, params: dict):
    """(n_batches, offset, total_windows, hist) of a checkpoint written
    with ``params``; any mismatch raises instead of mixing counts."""
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
        return (
            int(z["n_batches"]),
            int(z["offset"]),
            int(z["total_windows"]),
            z["hist"].astype(np.int64),
        )


def count_fastq(
    path,
    k: int,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    canonical: bool = False,
    validate: bool = True,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 50,
    on_invalid: str = "raise",
    on_progress=None,
    progress_every: int = 50,
    device=None,
) -> np.ndarray:
    """Stream a FASTQ file into a dense int64 [4^k] k-mer histogram on
    ``device`` (default: CPU), optionally crash-resumable.

    checkpoint: path of an .npz written every ``checkpoint_every`` batches
    (atomic rename). An existing checkpoint resumes at its stored byte
    offset after its fingerprint (file identity, k, batch_size, max_len,
    canonical, on_invalid, engine) is checked; a mismatch raises.
    on_invalid: "raise" (InvalidBase) or "skip" — drop every window holding
    an N/ambiguous base.
    on_progress: optional callable given {"batches", "reads", "bases",
    "bases_per_sec"} every ``progress_every`` batches.
    The sparse engine for k > 12 is a later port."""
    if not 1 <= k <= 32:
        raise InvalidLength(k)
    if k > kmer_ops.MAX_DENSE_K:
        raise NotImplementedError(kmer_ops._LATER)
    if on_invalid not in ("raise", "skip"):
        raise ValueError(f"on_invalid must be 'raise' or 'skip', got {on_invalid!r}")
    skip = on_invalid == "skip"

    params = {
        "k": k,
        "batch_size": batch_size,
        "max_len": -1 if max_len is None else int(max_len),
        "canonical": int(canonical),
        "on_invalid": on_invalid,
        "engine": "dense",
        **_file_fingerprint(path),
    }

    start_batches = 0
    start_offset = 0
    total_windows = 0
    host_hist = None
    if checkpoint and os.path.exists(checkpoint):
        start_batches, start_offset, total_windows, host_hist = _load_checkpoint(
            checkpoint, params
        )
    acc = _DenseAcc(k, device, host_hist)

    def save(n_batches, offset):
        acc.fold()
        tmp = f"{checkpoint}.tmp.{os.getpid()}.npz"
        np.savez_compressed(
            tmp,
            version=CKPT_VERSION,
            n_batches=n_batches,
            offset=offset,
            total_windows=total_windows,
            hist=acc.host,
            **params,
        )
        os.replace(tmp, checkpoint)

    n_batches = start_batches
    n_reads = 0
    n_bases = 0
    last_offset = start_offset
    t0 = time.perf_counter()
    for item in bnio.iter_fastq_batches(
        path,
        batch_size,
        max_len=max_len,
        validate=validate and not skip,
        with_validity=skip,
        with_offsets=True,
        start_offset=start_offset,
        device=device,
    ):
        if skip:
            batch, base_valid, offset = item
        else:
            (batch, offset), base_valid = item, None
        batch_bases = int(batch.lengths.sum())
        total_windows += batch_bases  # an upper bound of the batch's windows
        acc.add(
            kmer_ops.count_kmers_reads(
                batch.words, batch.lengths, k, canonical=canonical, base_valid=base_valid
            ),
            batch_bases,
        )
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
    acc.fold()
    return acc.host
