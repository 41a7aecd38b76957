"""Quality-aware read trimming and filtering (the fastp/Trimmomatic-style
preprocessing pass).

The counterpart of ``bitnuc_tpu/filters.py``, with two implementations of
the same rules:

* the numpy reference (``adapter_positions``, ``trim_bounds``,
  ``complexity_fraction``, ``triplet_entropy`` and ``filter_reads(...,
  use_jax=False)``), a copy of the JAX package's, in float64 and int64;
* the fused core (``_filter_core``), one PyTorch function on tensors that
  ``filter_reads`` runs by default on the device it is given (the card
  unless ``device`` names another). It computes as the JAX package's
  fused kernel does, in float32: the adapter budget floor(overlap * err),
  the mean-quality test, the complexity fraction and the triplet entropy.
  The entropy's log2 and its sum may differ from the JAX kernel's in the
  last bit, so a read whose entropy lies within that of ``min_entropy``
  can fall the other way.

Rules (phred+33 qualities):
  1. 3' adapter removal: cut at the leftmost position where the adapter
     (or its prefix at the read's end) matches within max_error_rate
     (cutadapt-style).
  2. Leading and trailing trim: drop bases from each end with quality
     < trim_q (Trimmomatic LEADING/TRAILING).
  3. Filter: keep reads whose trimmed span has length >= min_len, mean
     quality >= min_mean_q, at most max_n non-ACGT bases, a complexity
     fraction >= min_complexity and a triplet entropy >= min_entropy.

``filter_fastq`` frames records with ``io.iter_fastq_record_batches`` and
writes the kept records with the host library's emitter
(``native.filter_emit``), as the JAX package does; without the library, with
its vectorised numpy twin (``_emit_records``), byte for byte the same.
``filter_fastq_paired`` reads both mates with the JAX package's per-record
reader (``_iter_record_batches``), as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import config

_ACGT = np.zeros(256, bool)
for _b in b"ACGTacgt":
    _ACGT[_b] = True


# -- numpy reference -----------------------------------------------------------


def trim_bounds(
    quals: np.ndarray, lengths: np.ndarray, trim_q: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-read [start, end) spans after leading/trailing trim at quality
    < trim_q. quals: uint8 [R, L] phred+33 ASCII; start == end when every
    base is below threshold."""
    R, L = quals.shape
    lengths = np.asarray(lengths, np.int64)
    pos = np.arange(L, dtype=np.int64)[None, :]
    in_read = pos < lengths[:, None]
    good = in_read & (quals >= (33 + int(trim_q)))
    any_good = good.any(axis=1)
    start = np.where(any_good, good.argmax(axis=1), lengths)
    last = L - 1 - good[:, ::-1].argmax(axis=1)
    end = np.where(any_good, last + 1, lengths)
    return start.astype(np.int64), end.astype(np.int64)


def adapter_positions(
    ascii_arr: np.ndarray,
    lengths: np.ndarray,
    adapter: bytes,
    max_error_rate: float = 0.1,
    min_overlap: int = 3,
) -> np.ndarray:
    """Per-read 3' adapter start positions (== read length when absent):
    the leftmost p where the adapter, or its prefix at the read's end,
    overlaps at least min_overlap bases with at most
    int(overlap * max_error_rate) mismatches."""
    R, L = ascii_arr.shape
    lengths = np.asarray(lengths, np.int64)
    a = np.frombuffer(bytes(adapter).upper(), np.uint8)
    m = len(a)
    if m == 0:
        return lengths.copy()
    pos = np.arange(L, dtype=np.int64)[None, :]
    mism = np.zeros((R, L), np.int32)
    upper = ascii_arr & 0xDF  # case-fold: 'a'..'t' -> 'A'..'T'
    for j in range(m):
        cmp = np.zeros((R, L), bool)
        if j < L:
            cmp[:, : L - j] = upper[:, j:] != a[j]
        in_read = (pos + j) < lengths[:, None]
        mism += (cmp & in_read).astype(np.int32)
    overlap = np.minimum(m, lengths[:, None] - pos)
    ok = (overlap >= max(int(min_overlap), 1)) & (
        mism <= (overlap * max_error_rate).astype(np.int64)
    )
    any_ok = ok.any(axis=1)
    first = np.where(any_ok, ok.argmax(axis=1), lengths)
    return first.astype(np.int64)


def complexity_fraction(
    ascii_arr: np.ndarray, start: np.ndarray, end: np.ndarray
) -> np.ndarray:
    """fastp's low-complexity measure: the fraction of positions in
    [start, end) whose base differs from the next one. Reads with fewer
    than 2 spanned bases score 1.0."""
    R, L = ascii_arr.shape
    pos = np.arange(L - 1, dtype=np.int64)[None, :]
    in_pair = (pos >= start[:, None]) & (pos + 1 < end[:, None])
    diff = ascii_arr[:, :-1] != ascii_arr[:, 1:]
    n_pairs = in_pair.sum(axis=1)
    frac = (in_pair & diff).sum(axis=1) / np.maximum(n_pairs, 1)
    return np.where(n_pairs > 0, frac, 1.0)


def triplet_entropy(
    ascii_arr: np.ndarray, start: np.ndarray, end: np.ndarray
) -> np.ndarray:
    """Shannon entropy (bits, 0..6) of the trinucleotides in [start, end);
    windows touching non-ACGT bases are skipped, and reads with no valid
    triplet score 6.0."""
    R, L = ascii_arr.shape
    code = np.full(256, -1, np.int8)
    for i, b in enumerate(b"ACGT"):
        code[b] = i
        code[b + 32] = i
    c = code[ascii_arr].astype(np.int64)
    if L < 3:
        return np.full(R, 6.0)
    k0, k1, k2 = c[:, :-2], c[:, 1:-1], c[:, 2:]
    key = k0 * 16 + k1 * 4 + k2
    pos = np.arange(L - 2, dtype=np.int64)[None, :]
    ok = (
        (pos >= start[:, None])
        & (pos + 3 <= end[:, None])
        & (k0 >= 0)
        & (k1 >= 0)
        & (k2 >= 0)
    )
    rows = np.broadcast_to(np.arange(R, dtype=np.int64)[:, None], key.shape)
    flat = (rows * 64 + key)[ok]
    counts = np.bincount(flat, minlength=R * 64).reshape(R, 64).astype(np.float64)
    n = counts.sum(axis=1)
    p = counts / np.maximum(n, 1)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -(p * np.log2(np.where(p > 0, p, 1))).sum(axis=1)
    return np.where(n > 0, h, 6.0)


# -- the fused core ---------------------------------------------------------------


def _entropy_f32(ascii_arr, is_acgt, start, end, pos):
    """Per-read triplet entropy in float32 over [start, end) (L >= 3): the
    [R, 64] trinucleotide counts by one integer bincount, then the JAX
    kernel's float32 formula."""
    R, L = ascii_arr.shape
    c = (((ascii_arr >> 1) ^ (ascii_arr >> 2)) & 3).to(torch.int64)
    key = c[:, :-2] * 16 + c[:, 1:-1] * 4 + c[:, 2:]
    p2 = pos[:, : L - 2]
    okw = ((p2 >= start[:, None]) & (p2 + 3 <= end[:, None])
           & is_acgt[:, :-2] & is_acgt[:, 1:-1] & is_acgt[:, 2:])
    rows = torch.arange(R, dtype=torch.int64, device=key.device)[:, None] * 64
    flat = torch.where(okw, rows + key, R * 64).reshape(-1)
    counts = torch.bincount(flat, minlength=R * 64 + 1)[: R * 64].reshape(R, 64)
    counts = counts.to(torch.float32)
    n = counts.sum(1)
    p = counts / torch.clamp(n, min=1)[:, None]
    h = -(p * torch.log2(torch.where(p > 0, p, 1))).sum(1)
    return torch.where(n > 0, h, 6.0)


def _filter_core(m: int, has_trim: bool, has_meanq: bool, has_maxn: bool,
                 has_cplx: bool, has_ent: bool):
    """The fused filter for an adapter length and a set of enabled
    filters: a function (ascii, quals, lengths, adapter, params...) ->
    (keep [R] bool, start [R] int32, end [R] int32) on the tensors'
    device. Integer thresholds are int32 tensors and real ones float32
    tensors, as the JAX kernel takes them. An adapter longer than L + 1
    bases is compared as the numpy reference compares it (the JAX kernel's
    shifted rows stop broadcasting there and it raises)."""

    def core(ascii_arr, quals, lengths, adapter_a, min_len, min_mean_q,
             trim_q, max_n, a_err, a_minov, min_cplx, min_ent):
        R, L = ascii_arr.shape
        dev = ascii_arr.device
        lengths = lengths.to(torch.int32)
        pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]

        if m:
            upper = ascii_arr & 0xDF
            mism = torch.zeros((R, L), dtype=torch.int32, device=dev)
            for j in range(m):
                ne = torch.ones((R, L), dtype=torch.bool, device=dev)
                if j < L:
                    ne[:, : L - j] = upper[:, j:] != adapter_a[j]
                in_read = (pos + j) < lengths[:, None]
                mism += ne & in_read
            overlap = torch.clamp(lengths[:, None] - pos, max=m)
            budget = torch.floor(overlap.to(torch.float32) * a_err).to(torch.int32)
            ok = (overlap >= torch.clamp(a_minov, min=1)) & (mism <= budget)
            first = torch.where(ok, pos, L).amin(1)  # leftmost qualifying position
            lengths = torch.minimum(lengths, first)

        if has_trim:
            in_read = pos < lengths[:, None]
            good = in_read & (quals.to(torch.int32) >= 33 + trim_q)
            start = torch.where(good, pos, L).amin(1)
            last = torch.where(good, pos, -1).amax(1)
            any_good = last >= 0
            start = torch.where(any_good, start, lengths)
            end = torch.where(any_good, last + 1, lengths)
        else:
            start = torch.zeros(R, dtype=torch.int32, device=dev)
            end = lengths

        span = end - start
        in_span = (pos >= start[:, None]) & (pos < end[:, None])
        keep = span >= torch.clamp(min_len, min=1)
        if has_meanq:
            qsum = torch.where(in_span, quals.to(torch.int32) - 33, 0).sum(1)
            keep &= qsum.to(torch.float32) >= min_mean_q * torch.clamp(span, min=1).to(
                torch.float32)
        lower = ascii_arr | 0x20
        is_acgt = ((lower == ord("a")) | (lower == ord("c"))
                   | (lower == ord("g")) | (lower == ord("t")))
        if has_maxn:
            n_bad = (in_span & ~is_acgt).sum(1)
            keep &= n_bad <= max_n
        if has_cplx:
            in_pair = in_span[:, :-1] & (pos[:, 1:] < end[:, None])
            diff = ascii_arr[:, :-1] != ascii_arr[:, 1:]
            n_pairs = in_pair.sum(1)
            frac = (in_pair & diff).sum(1).to(torch.float32) / torch.clamp(n_pairs, min=1)
            frac = torch.where(n_pairs > 0, frac, 1.0)
            keep &= frac >= min_cplx
        if has_ent and L >= 3:
            keep &= _entropy_f32(ascii_arr, is_acgt, start, end, pos) >= min_ent
        elif has_ent:
            keep &= torch.tensor(6.0, dtype=torch.float32, device=dev) >= min_ent
        return keep, start, end

    return core


def _filter_reads_fused(ascii_arr, quals, lengths, min_len, min_mean_q, trim_q,
                        max_n, adapter, adapter_max_error, adapter_min_overlap,
                        min_complexity, min_entropy, device):
    """filter_reads' default path: the fused core on ``device``."""
    dev = config.resolve_device(device)
    a = np.frombuffer(bytes(adapter or b"").upper(), np.uint8)
    fn = _filter_core(
        len(a), trim_q > 0, min_mean_q > 0, max_n is not None,
        min_complexity is not None, min_entropy is not None,
    )

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    keep, start, end = fn(
        torch.as_tensor(ascii_arr).to(dev),
        torch.as_tensor(quals).to(dev),
        torch.as_tensor(np.asarray(lengths, np.int32)).to(dev),
        torch.from_numpy(a.copy()).to(dev),
        i32(min_len),
        f32(min_mean_q),
        i32(trim_q),
        i32(-1 if max_n is None else max_n),
        f32(adapter_max_error),
        i32(adapter_min_overlap),
        f32(min_complexity or 0.0),
        f32(min_entropy or 0.0),
    )
    return (
        keep.cpu().numpy(),
        start.cpu().numpy().astype(np.int64),
        end.cpu().numpy().astype(np.int64),
    )


def filter_reads(
    ascii_arr: np.ndarray,
    quals: np.ndarray,
    lengths: np.ndarray,
    min_len: int = 1,
    min_mean_q: float = 0.0,
    trim_q: int = 0,
    max_n: Optional[int] = None,
    adapter: Optional[bytes] = None,
    adapter_max_error: float = 0.1,
    adapter_min_overlap: int = 3,
    min_complexity: Optional[float] = None,
    min_entropy: Optional[float] = None,
    use_jax: Optional[bool] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keep [R] bool, start [R] int64, end [R] int64) for a rectangular
    read batch (uint8 [R, L] bases and phred+33 qualities, [R] lengths).

    ``use_jax`` keeps the JAX package's parameter: None or True runs the
    fused tensor core (``_filter_core``) on ``device``; False runs the
    numpy reference. Both remove a 3' adapter first (the adapter and
    everything after it goes), then trim by quality, then filter by
    length, mean quality, N count, complexity and entropy on the trimmed
    span."""
    if use_jax is None or use_jax:
        return _filter_reads_fused(
            ascii_arr, quals, lengths, min_len, min_mean_q, trim_q, max_n,
            adapter, adapter_max_error, adapter_min_overlap, min_complexity,
            min_entropy, device,
        )
    R, L = ascii_arr.shape
    lengths = np.asarray(lengths, np.int64)
    if adapter:
        lengths = adapter_positions(
            ascii_arr, lengths, adapter, adapter_max_error, adapter_min_overlap
        )
    if trim_q > 0:
        start, end = trim_bounds(quals, lengths, trim_q)
    else:
        start = np.zeros(R, np.int64)
        end = lengths.copy()
    span = end - start
    pos = np.arange(L, dtype=np.int64)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    keep = span >= max(int(min_len), 1)
    if min_mean_q > 0:
        qsum = np.where(in_span, quals.astype(np.int64) - 33, 0).sum(axis=1)
        keep &= qsum >= min_mean_q * np.maximum(span, 1)
    if max_n is not None:
        n_bad = (in_span & ~_ACGT[ascii_arr]).sum(axis=1)
        keep &= n_bad <= int(max_n)
    if min_complexity is not None:
        keep &= complexity_fraction(ascii_arr, start, end) >= float(min_complexity)
    if min_entropy is not None:
        keep &= triplet_entropy(ascii_arr, start, end) >= float(min_entropy)
    return keep, start, end


# -- FASTQ streams ----------------------------------------------------------------


def _iter_record_batches(path, batch_reads):
    """(names, seqs, quals) list-batches from a FASTQ path (.gz ok): the
    JAX package's per-record reader (blank lines between records are
    skipped; names, sequences and qualities are stripped)."""
    from .io import _open

    names, seqs, quals = [], [], []
    with _open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            if not h.strip():
                continue
            s = f.readline().strip()
            f.readline()
            q = f.readline().strip()
            names.append(h[1:].strip())
            seqs.append(s)
            quals.append(q)
            if len(names) >= batch_reads:
                yield names, seqs, quals
                names, seqs, quals = [], [], []
    if names:
        yield names, seqs, quals


def _batch_filter(seqs, quals, min_len, min_mean_q, trim_q, max_n, adapter,
                  min_complexity=None, min_entropy=None, device=None):
    """(keep, start, end) for one list-batch."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    L = max(int(lens.max()), 1) if len(seqs) else 1
    a = np.zeros((len(seqs), L), np.uint8)
    q = np.zeros((len(seqs), L), np.uint8)
    for i, (s, qq) in enumerate(zip(seqs, quals)):
        a[i, : len(s)] = np.frombuffer(s, np.uint8)
        q[i, : len(qq)] = np.frombuffer(qq, np.uint8)
    return filter_reads(
        a, q, lens, min_len, min_mean_q, trim_q, max_n, adapter=adapter,
        min_complexity=min_complexity, min_entropy=min_entropy, device=device,
    )


def _emit_records(raw, ascii_arr, quals, name_off, name_len, keep, start, end) -> bytes:
    """The kept records of a batch as FASTQ bytes: '@', the header's bytes
    of ``raw``, the bases and qualities of [start, end) (clamped to the
    row), in batch order. One masked compress of a [kept, width] byte
    matrix: the numpy twin of ``native.filter_emit``."""
    rows = np.flatnonzero(keep)
    if rows.size == 0:
        return b""
    L = ascii_arr.shape[1]
    s = np.maximum(np.asarray(start, np.int64)[rows], 0)
    e = np.maximum(np.minimum(np.asarray(end, np.int64)[rows], L), s)
    span = e - s
    no = np.asarray(name_off, np.int64)[rows]
    nl = np.asarray(name_len, np.int64)[rows]
    raw_b = np.frombuffer(raw, np.uint8)
    jn = np.arange(int(nl.max()))[None, :]
    names = raw_b[np.minimum(no[:, None] + jn, max(raw_b.size - 1, 0))]
    js = np.arange(int(span.max()))[None, :]
    col = np.minimum(s[:, None] + js, L - 1)
    seq = np.take_along_axis(ascii_arr[rows], col, 1)
    qual = np.take_along_axis(quals[rows], col, 1)
    n = rows.size

    def const(b):
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

    ones = np.ones((n, 1), bool)
    in_span = js < span[:, None]
    mat = np.concatenate([const(b"@"), names, const(b"\n"), seq, const(b"\n+\n"), qual,
                          const(b"\n")], 1)
    mask = np.concatenate([ones, jn < nl[:, None], ones, in_span,
                           np.ones((n, 3), bool), in_span, ones], 1)
    return mat[mask].tobytes()


def filter_fastq(
    in_path,
    out_path,
    min_len: int = 1,
    min_mean_q: float = 0.0,
    trim_q: int = 0,
    max_n: Optional[int] = None,
    adapter: Optional[bytes] = None,
    batch_reads: int = 65536,
    min_complexity: Optional[float] = None,
    min_entropy: Optional[float] = None,
    device=None,
) -> dict:
    """Stream FASTQ -> trimmed and filtered FASTQ; returns summary counts
    (reads_in, reads_out, bases_in, bases_out).

    Records stream in ``batch_reads`` batches (bounded memory at any file
    size); kept reads are written with their trimmed sequence and quality
    line under their header. The filter runs on ``device``; the framing and
    the emit on the host library (``native.filter_emit``) where it loads,
    else on their numpy twins (``_emit_records``)."""
    from . import io as bnio, native

    emit = native.filter_emit if native.available() else _emit_records

    n_in = n_out = bases_in = bases_out = 0
    with open(out_path, "wb") as out:
        for raw, a, q, lens, noff, nlen in bnio.iter_fastq_record_batches(in_path, batch_reads):
            keep, start, end = filter_reads(
                a, q, lens.astype(np.int64), min_len, min_mean_q, trim_q, max_n,
                adapter=adapter, min_complexity=min_complexity, min_entropy=min_entropy,
                device=device,
            )
            n_in += len(lens)
            bases_in += int(lens.sum())
            n_out += int(keep.sum())
            bases_out += int(np.where(keep, end - start, 0).sum())
            out.write(emit(raw, a, q, noff, nlen, keep, start, end))
    return {
        "reads_in": n_in,
        "reads_out": n_out,
        "bases_in": bases_in,
        "bases_out": bases_out,
    }


def filter_fastq_paired(
    in1,
    in2,
    out1,
    out2,
    min_len: int = 1,
    min_mean_q: float = 0.0,
    trim_q: int = 0,
    max_n: Optional[int] = None,
    adapter: Optional[bytes] = None,
    batch_reads: int = 65536,
    min_complexity: Optional[float] = None,
    min_entropy: Optional[float] = None,
    device=None,
) -> dict:
    """Paired-end twin of filter_fastq: R1 and R2 stream in lockstep and a
    pair survives only if both mates pass (trimming is per mate), so the
    two outputs stay index-aligned. Raises ValueError if the inputs have
    different record counts."""
    n_in = n_out = 0
    it2 = _iter_record_batches(in2, batch_reads)
    with open(out1, "wb") as o1, open(out2, "wb") as o2:
        for (names1, seqs1, quals1) in _iter_record_batches(in1, batch_reads):
            try:
                names2, seqs2, quals2 = next(it2)
            except StopIteration:
                raise ValueError("R2 has fewer records than R1")
            if len(names2) != len(names1):
                raise ValueError("paired inputs have different record counts")
            k1, s1, e1 = _batch_filter(
                seqs1, quals1, min_len, min_mean_q, trim_q, max_n, adapter,
                min_complexity, min_entropy, device,
            )
            k2, s2, e2 = _batch_filter(
                seqs2, quals2, min_len, min_mean_q, trim_q, max_n, adapter,
                min_complexity, min_entropy, device,
            )
            keep = k1 & k2
            n_in += len(seqs1)
            for i in np.nonzero(keep)[0]:
                a0, a1 = int(s1[i]), int(e1[i])
                b0, b1 = int(s2[i]), int(e2[i])
                o1.write(b"@%s\n%s\n+\n%s\n" % (names1[i], seqs1[i][a0:a1], quals1[i][a0:a1]))
                o2.write(b"@%s\n%s\n+\n%s\n" % (names2[i], seqs2[i][b0:b1], quals2[i][b0:b1]))
                n_out += 1
    for _ in it2:
        raise ValueError("R2 has more records than R1")
    return {"pairs_in": n_in, "pairs_out": n_out}
