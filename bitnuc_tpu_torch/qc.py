"""FastQC-style per-cycle quality-control profile for FASTQ files.

The counterpart of ``bitnuc_tpu/qc.py``. Each batch of records
(``io.iter_fastq_record_batches``) is folded on a device by integer
``torch.bincount`` over fused keys: (cycle, base symbol) for the base
counts, (cycle, phred) for the quality histograms, and each read's
rounded mean phred and GC percent. The two per-read roundings follow the
JAX package's default fold (numpy or its native library): float64
division and round-half-to-even. The host keeps int64 accumulators.

Report dict:
  reads, bases, min_len/max_len/mean_len
  per_cycle: for each cycle c (0-based) the base counts {a,c,g,t,n} and the
    exact quality mean / p10 / p25 / median / p75 / p90 (phred, from the
    integer per-cycle histogram).
  mean_quality_hist: [q] -> reads whose rounded mean phred is q
  gc_hist: [pct 0..100] -> reads whose rounded GC%% is pct
  status: FastQC-style pass/warn/fail for per_base_quality (warn when any
    cycle has p25 < 10 or median < 25, fail at p25 < 5 or median < 20) and
    per_base_content (warn when |A-T| or |G-C| exceeds 10%% of called bases
    at any cycle, fail at 20%%).
"""

from __future__ import annotations

import numpy as np
import torch

from . import config

_QMAX = 64  # phred values clipped to 0..63 (covers phred+33 up to 'j'+)

# symbol codes per ASCII byte: A=0 C=1 G=2 T=3, everything else (incl N)=4
_SYM = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _SYM[_b] = _i
    _SYM[_b | 0x20] = _i  # lower case


def _fold_device(ascii_arr: torch.Tensor, quals: torch.Tensor, lens: torch.Tensor):
    """One batch's (base_by_cycle [L, 5], qual_by_cycle [L, _QMAX],
    mean_q_hist [_QMAX], gc_hist [101]) as int64 tensors on the batch's
    device."""
    R, L = ascii_arr.shape
    dev = ascii_arr.device
    lens = lens.to(torch.int64)
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    in_read = pos < lens[:, None]
    sym = torch.from_numpy(_SYM).to(dev)[ascii_arr.to(torch.int64)].to(torch.int64)
    key = torch.where(in_read, pos * 5 + sym, L * 5)
    base = torch.bincount(key.reshape(-1), minlength=L * 5 + 1)[: L * 5].reshape(L, 5)

    phred = torch.clamp(quals.to(torch.int64), 33, 33 + _QMAX - 1) - 33
    qkey = torch.where(in_read, pos * _QMAX + phred, L * _QMAX)
    qual = torch.bincount(qkey.reshape(-1), minlength=L * _QMAX + 1)[: L * _QMAX]

    span = torch.clamp(lens, min=1).to(torch.float64)
    qsum = torch.where(in_read, phred, 0).sum(1)
    mean_q = torch.clamp(torch.round(qsum.to(torch.float64) / span).to(torch.int64),
                         0, _QMAX - 1)
    mq_hist = torch.bincount(mean_q, minlength=_QMAX)
    gc = (in_read & ((sym == 1) | (sym == 2))).sum(1)
    gc_pct = torch.round(100.0 * gc.to(torch.float64) / span).to(torch.int64)
    gc_hist = torch.bincount(torch.clamp(gc_pct, 0, 100), minlength=101)
    return base, qual.reshape(L, _QMAX), mq_hist, gc_hist


class _Acc:
    """Growable-width per-cycle accumulators; ``fold`` runs on the device
    the accumulator was made for."""

    def __init__(self, device=None):
        self.device = config.resolve_device(device)
        self.width = 0
        self.base_by_cycle = np.zeros((0, 5), np.int64)
        self.qual_by_cycle = np.zeros((0, _QMAX), np.int64)
        self.mean_q_hist = np.zeros(_QMAX, np.int64)
        self.gc_hist = np.zeros(101, np.int64)
        self.reads = 0
        self.bases = 0
        self.min_len = None
        self.max_len = 0

    def _grow(self, width: int):
        if width <= self.width:
            return
        b = np.zeros((width, 5), np.int64)
        q = np.zeros((width, _QMAX), np.int64)
        b[: self.width] = self.base_by_cycle
        q[: self.width] = self.qual_by_cycle
        self.base_by_cycle, self.qual_by_cycle = b, q
        self.width = width

    def fold(self, ascii_arr: np.ndarray, quals: np.ndarray, lens: np.ndarray):
        R, L = ascii_arr.shape
        if R == 0:
            return
        self._grow(L)
        lens = np.asarray(lens, np.int64)
        dev = self.device
        b, q, mh, gh = _fold_device(torch.as_tensor(ascii_arr).to(dev),
                                    torch.as_tensor(quals).to(dev),
                                    torch.from_numpy(lens).to(dev))
        self.base_by_cycle[:L] += b.cpu().numpy()
        self.qual_by_cycle[:L] += q.cpu().numpy()
        self.mean_q_hist += mh.cpu().numpy()
        self.gc_hist += gh.cpu().numpy()
        self.reads += R
        self.bases += int(lens.sum())
        lo = int(lens.min())
        self.min_len = lo if self.min_len is None else min(self.min_len, lo)
        self.max_len = max(self.max_len, int(lens.max()))


def _percentile_from_hist(hist: np.ndarray, frac: float) -> int:
    """Exact lower-interpolation percentile of the integer values a
    histogram tallies (value v counted hist[v] times)."""
    total = int(hist.sum())
    if total == 0:
        return 0
    rank = max(int(np.ceil(frac * total)), 1)
    return int(np.searchsorted(np.cumsum(hist), rank))


def _per_cycle_rows(acc: _Acc):
    rows = []
    for c in range(acc.width):
        bc = acc.base_by_cycle[c]
        qh = acc.qual_by_cycle[c]
        n = int(qh.sum())
        if n == 0:
            continue
        vals = np.arange(_QMAX, dtype=np.int64)
        rows.append(
            {
                "cycle": c,
                "a": int(bc[0]),
                "c": int(bc[1]),
                "g": int(bc[2]),
                "t": int(bc[3]),
                "n": int(bc[4]),
                "q_mean": round(float((qh * vals).sum()) / n, 3),
                "q_p10": _percentile_from_hist(qh, 0.10),
                "q_p25": _percentile_from_hist(qh, 0.25),
                "q_median": _percentile_from_hist(qh, 0.50),
                "q_p75": _percentile_from_hist(qh, 0.75),
                "q_p90": _percentile_from_hist(qh, 0.90),
            }
        )
    return rows


def _status(per_cycle) -> dict:
    quality = "pass"
    content = "pass"
    for row in per_cycle:
        if row["q_p25"] < 5 or row["q_median"] < 20:
            quality = "fail"
        elif quality == "pass" and (row["q_p25"] < 10 or row["q_median"] < 25):
            quality = "warn"
        called = row["a"] + row["c"] + row["g"] + row["t"]
        if called:
            at = abs(row["a"] - row["t"]) / called
            gcd = abs(row["g"] - row["c"]) / called
            worst = max(at, gcd)
            if worst > 0.20:
                content = "fail"
            elif content == "pass" and worst > 0.10:
                content = "warn"
    return {"per_base_quality": quality, "per_base_content": content}


def qc_profile(path, batch_reads: int = 65536, device=None) -> dict:
    """Stream a FASTQ file into a FastQC-style QC report dict (see the
    module docstring). Bounded memory at any file size: records fold in
    ``batch_reads`` batches on ``device``."""
    from . import io as bnio

    acc = _Acc(device)
    for _, a, q, lens, _, _ in bnio.iter_fastq_record_batches(path, batch_reads):
        acc.fold(a, q, lens.astype(np.int64))

    per_cycle = _per_cycle_rows(acc)
    qh = acc.mean_q_hist
    gh = acc.gc_hist
    return {
        "reads": acc.reads,
        "bases": acc.bases,
        "min_len": acc.min_len or 0,
        "max_len": acc.max_len,
        "mean_len": round(acc.bases / acc.reads, 2) if acc.reads else 0.0,
        "per_cycle": per_cycle,
        "mean_quality_hist": {int(i): int(qh[i]) for i in np.nonzero(qh)[0]},
        "gc_hist": {int(i): int(gh[i]) for i in np.nonzero(gh)[0]},
        "status": _status(per_cycle),
    }
