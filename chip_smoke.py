#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bitnuc_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py [--out results.json] [--seed 0]

Phases, each of which must pass:

1. Device: the card's name and power limit, and the kernel build (all of
   bitnuc_tpu_torch/csrc/*.cu with nvcc, timed).
2. Every kernel against its plain PyTorch version on the card, bit for bit:
   K1 pack, K2 unpack, K3a hist_keys, K3b hist_words, K4/K5 hdist_scan and
   K7 merge at the main paths' shapes and at edge shapes, each timed with
   CUDA events (median of several runs, L2 flushed before each) beside its
   plain version.
3. The golden vectors of the reference crate.
4. The flagship step (bitnuc_tpu_torch.entry) on 262,144 reads x 150 bp
   against a 4,194,304-entry database, under the default backend (kernels)
   and under backend("torch") (plain versions), output for output.
5. Streaming canonical k = 12 counting of a generated FASTQ (1,000,000
   reads x 150 bp, 0.5% N, N-skip) with pipeline.count_fastq: equal to the
   plain run, a run interrupted after its first checkpoint and resumed
   equals an uninterrupted one, and a 10,000-read subset equals a host
   dict oracle.
6. The large-k path: a 5,000,000-bp random genome (10 runs of 100 N) as
   80-column FASTA and 1,000,000 reads x 150 bp drawn from both strands
   (0.1% substitutions, 0.05% N) as FASTQ, both gzip level 1. Canonical
   k = 21 counts of the reads (pipeline.count_fastq) and the genome
   (pipeline.count_fasta), the two tables combined on the card in all four
   modes of ops.setops.combine_counts (K7), and the reads' error k-mers
   (reads minus genome) decoded with codec.unpack_kmers (K2). Checked
   against combine_dicts, the plain backend, a resumed run, host oracles
   on a read subset and a contig slice, the spectrum's coverage peak, and
   a host decode of the keys.

The launch counters are set to 0 just before each main path (phases 4 and
5 under the default backend, and phase 6) and read just after it; every
kernel of that path must have launched there. The last lines printed are a
JSON object of per-kernel
results, the card's name and power limit from nvidia-smi, and the final
JSON status line. The script exits non-zero, and prints no status line,
when there is no CUDA device, when the package cannot be imported, or when
any phase fails. Nothing here imports jax or bitnuc_tpu.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

READS = 262_144
READ_LEN = 150
DB_ENTRIES = 4_194_304
DB_BASES = 512
FASTQ_READS = 1_000_000
FASTQ_BATCH = 65_536
STREAM_K = 12
ORACLE_READS = 10_000
GENOME_BP = 5_000_000
N_RUNS, N_RUN_LEN = 10, 100
LARGE_K = 21
SUB_RATE, N_RATE = 0.001, 0.0005
CONTIG_ORACLE_BP = 200_000
MERGE_ROWS = 8_388_608  # per list: the set-algebra shape of K7

FAILURES = []


def check(name: str, ok: bool, detail: str = "") -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {name}" + (f" ({detail})" if detail else ""), flush=True)
    if not ok:
        FAILURES.append(name)
    return ok


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


class Timer:
    """Median milliseconds of a callable on the card, CUDA events around
    each run, a 256 MiB write before each run to flush the 50 MB L2."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 5) -> float:
        torch = self.torch
        fn()  # warm-up
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_abs_diff(a, b) -> int:
    """Largest |a - b| over tensors or tuples of tensors (int64 exact)."""
    if isinstance(a, (tuple, list)):
        return max(max_abs_diff(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        return 2**62
    if a.numel() == 0:
        return 0
    return int((a.to(b.device).long() - b.long()).abs().max())


def _open_out(path: str):
    return gzip.open(path, "wb", compresslevel=1) if path.endswith(".gz") else open(path, "wb")


def write_fastq(path: str, seqs: np.ndarray) -> None:
    """Fixed-width records: @r%09d, the sequence, '+', all-'I' qualities;
    gzip level 1 for a .gz path."""
    n, L = seqs.shape
    ids = np.arange(n, dtype=np.int64)
    digits = (ids[:, None] // (10 ** np.arange(8, -1, -1))[None, :]) % 10
    hdr = np.concatenate(
        [np.full((n, 1), ord("@")), np.full((n, 1), ord("r")), digits + ord("0"),
         np.full((n, 1), 10)], axis=1,
    ).astype(np.uint8)
    tail = np.frombuffer(b"\n+\n", np.uint8)
    rec = np.concatenate(
        [hdr, seqs, np.broadcast_to(tail, (n, 3)), np.full((n, L), ord("I"), np.uint8),
         np.full((n, 1), 10, np.uint8)], axis=1,
    )
    with _open_out(path) as f:
        f.write(np.ascontiguousarray(rec).tobytes())


def write_fasta(path: str, name: bytes, seq: np.ndarray, width: int = 80) -> None:
    """One record, ``width`` bases per line; gzip level 1 for a .gz path."""
    body = b"\n".join(seq[i : i + width].tobytes() for i in range(0, len(seq), width))
    with _open_out(path) as f:
        f.write(b">" + name + b"\n" + body + b"\n")


def make_genome(rng) -> np.ndarray:
    """GENOME_BP random ACGT bases with N_RUNS runs of N_RUN_LEN N (ASCII)."""
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, GENOME_BP)]
    for s in rng.integers(0, GENOME_BP - N_RUN_LEN, N_RUNS):
        g[s : s + N_RUN_LEN] = ord("N")
    return g


def sample_reads(rng, genome: np.ndarray, n: int, L: int) -> np.ndarray:
    """n reads of L bases from uniform positions on both strands, with
    SUB_RATE substitutions and N_RATE Ns (ASCII [n, L])."""
    comp = np.arange(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    starts = rng.integers(0, len(genome) - L + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, L)[starts]
    rev = rng.random(n) < 0.5
    reads[rev] = comp[reads[rev, ::-1]]
    flat = reads.reshape(-1)
    pos = rng.integers(0, flat.size, rng.binomial(flat.size, SUB_RATE))
    code = np.zeros(256, np.int64)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pos = pos[flat[pos] != ord("N")]
    flat[pos] = acgt[(code[flat[pos]] + rng.integers(1, 4, pos.size)) % 4]
    flat[rng.integers(0, flat.size, rng.binomial(flat.size, N_RATE))] = ord("N")
    return reads


def table_to_lists(table: dict, torch, device):
    """{key: count} -> (lo, hi, counts) int32 tensors on ``device``,
    ascending by key: the counted-list layout of ops.setops."""
    keys = np.fromiter(table.keys(), np.uint64, len(table))
    counts = np.fromiter(table.values(), np.int64, len(table))
    order = np.argsort(keys)
    keys, counts = keys[order], counts[order]
    cols = ((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
            (keys >> np.uint64(32)).astype(np.uint32).view(np.int32),
            counts.astype(np.int32))
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in cols)


def lists_to_table(kmer, lo, hi, counts) -> dict:
    lo, hi, counts = kmer.compact_runs(lo, hi, counts)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return dict(zip(keys.tolist(), counts.tolist()))


def decode_keys_host(keys: np.ndarray, k: int) -> np.ndarray:
    """[n] uint64 packed k-mers -> [n, k] ASCII (from_2bit on the host)."""
    shifts = (2 * np.arange(k)).astype(np.uint64)
    codes = (keys[:, None] >> shifts[None, :]) & np.uint64(3)
    return np.frombuffer(b"ACGT", np.uint8)[codes.astype(np.int64)]


def oracle_counts(seqs: np.ndarray, k: int) -> dict:
    """Host dict oracle: canonical k-mer counts over windows of ACGT only."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    digit = bytes.maketrans(b"ACGT", b"0123")
    out = {}
    for row in seqs:
        s = bytes(row)
        for p in range(len(s) - k + 1):
            w = s[p : p + k]
            if w.strip(b"ACGT"):
                continue
            fwd = int(w.translate(digit)[::-1], 4)
            rc = int(w.translate(comp)[::-1].translate(digit)[::-1], 4)
            key = min(fwd, rc)
            out[key] = out.get(key, 0) + 1
    return out


LARGE_K_LAUNCHES = {}


def large_k_phase(args, torch, dev, timer, tmp, results) -> None:
    """Phase 6: k = 21 counts of reads and genome, set algebra (K7), decode
    of the reads' error k-mers (K2), and the checks of all of it."""
    from bitnuc_tpu_torch import config, io as bnio, kernels, pipeline
    from bitnuc_tpu_torch.ops import codec, kmer, merge, setops

    k = LARGE_K
    ph = results["phases"]
    rng = np.random.default_rng(args.seed + 1)
    t = time.perf_counter()
    genome = make_genome(rng)
    reads = sample_reads(rng, genome, FASTQ_READS, READ_LEN)
    fa, fa_slice = os.path.join(tmp, "genome.fa.gz"), os.path.join(tmp, "slice.fa")
    fq, fq_small = os.path.join(tmp, "reads.fq.gz"), os.path.join(tmp, "subset21.fq")
    write_fasta(fa, b"chr1 random", genome)
    write_fasta(fa_slice, b"chr1:1-200000", genome[:CONTIG_ORACLE_BP])
    write_fastq(fq, reads)
    write_fastq(fq_small, reads[:ORACLE_READS])
    ph["large_k_write_s"] = time.perf_counter() - t
    print(f"phase 6: large-k path (k = {k}); inputs written in {ph['large_k_write_s']:.1f} s "
          f"({os.path.getsize(fq) / 1e6:.1f} MB FASTQ.gz, {os.path.getsize(fa) / 1e6:.1f} MB "
          "FASTA.gz)", flush=True)
    count_kw = dict(batch_size=FASTQ_BATCH, canonical=True, on_invalid="skip", device=dev)

    # -- the path, with the counters set to 0 just before it ---------------
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    reads_t = pipeline.count_fastq(fq, k, **count_kw)
    ph["large_k_count_reads_s"] = time.perf_counter() - t
    t = time.perf_counter()
    genome_t = pipeline.count_fasta(fa, k, canonical=True, on_invalid="skip", device=dev)
    ph["large_k_count_genome_s"] = time.perf_counter() - t
    a = table_to_lists(reads_t, torch, dev)
    b = table_to_lists(genome_t, torch, dev)
    combined = {}
    for mode in setops.MODES:
        for compact in (True, False):
            combined[mode, compact] = setops.combine_counts(*a, *b, mode=mode, compact=compact)
    sub_lo, sub_hi, _, sub_n = combined["subtract", True]
    n_err = int(sub_n)
    err_words = torch.stack([sub_lo[:n_err], sub_hi[:n_err]], 1).contiguous()
    err_ascii = codec.unpack_kmers(
        err_words, torch.full((n_err,), k, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    LARGE_K_LAUNCHES.update(kernels.LAUNCHES)
    print(f"  launches {LARGE_K_LAUNCHES}", flush=True)
    for name in ("pack", "merge", "unpack"):
        check(f"{name} launched on the large-k path", LARGE_K_LAUNCHES[name] > 0,
              f"{LARGE_K_LAUNCHES[name]} launches")
    bases = FASTQ_READS * READ_LEN
    ph["large_k_count_bases_per_s"] = bases / ph["large_k_count_reads_s"]
    ph["large_k_distinct"] = {"reads": len(reads_t), "genome": len(genome_t),
                              "reads_minus_genome": n_err}
    print(f"  count_fastq k={k}: {ph['large_k_count_reads_s']:.2f} s, "
          f"{ph['large_k_count_bases_per_s'] / 1e6:.1f} Mbases/s; count_fasta "
          f"{ph['large_k_count_genome_s']:.2f} s; distinct k-mers {ph['large_k_distinct']}",
          flush=True)

    # -- checks ---------------------------------------------------------------
    for (mode, compact), out in combined.items():
        with config.backend("torch"):
            plain = setops.combine_counts(*a, *b, mode=mode, compact=compact)
        check(f"combine {mode} compact={int(compact)} == plain backend",
              all(torch.equal(x, y) for x, y in zip(out, plain)))
    for mode in setops.MODES:
        want = setops.combine_dicts(reads_t, genome_t, mode)
        got = lists_to_table(kmer, *combined[mode, True][:3])
        loose = lists_to_table(kmer, *combined[mode, False][:3])
        check(f"combine {mode} == combine_dicts", got == want and loose == want
              and int(combined[mode, True][3]) == len(want), f"{len(want)} k-mers")
    host = decode_keys_host(
        (sub_hi[:n_err].cpu().numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
        | sub_lo[:n_err].cpu().numpy().view(np.uint32).astype(np.uint64), k)
    dec = err_ascii.cpu().numpy()
    check("decoded error k-mers == host from_2bit",
          np.array_equal(dec[:, :k], host) and not dec[:, k:].any(), f"{n_err} k-mers")
    del host, dec, err_ascii, err_words

    spec = kmer.spectrum(torch.from_numpy(np.fromiter(reads_t.values(), np.int64, len(reads_t))))
    peak = int(torch.argmax(spec[3:255])) + 3  # past the error tail at 1-2
    ph["large_k_spectrum_peak"] = peak
    check("reads' k-mer spectrum peaks at 15..40 (30x coverage)", 15 <= peak <= 40,
          f"peak at {peak}")

    modes_ms = {}
    for mode in setops.MODES:
        ms = timer(lambda: setops.combine_counts(*a, *b, mode=mode), 3)
        with config.backend("torch"):
            pms = timer(lambda: setops.combine_counts(*a, *b, mode=mode), 3)
        loose_ms = timer(lambda: setops.combine_counts(*a, *b, mode=mode, compact=False), 3)
        modes_ms[mode] = {"ms": ms, "plain_ms": pms, "compact0_ms": loose_ms}
        print(f"    combine {mode}: {ms:.3f} ms (plain {pms:.3f} ms; compact=False "
              f"{loose_ms:.3f} ms) for {a[0].numel()} + {b[0].numel()} rows", flush=True)
    ph["large_k_setop_ms"] = modes_ms
    # where a combination's time goes, one stage at a time
    sa, sb = setops._side(a[1], a[0], a[2], 0), setops._side(b[1], b[0], b[2], 1)
    hi_s, lo_s, _, ct_s = merge.merge_sorted(sa, sb, 3, (0,))
    stages = {
        "dead-suffix sides": lambda: (
            setops._side(a[1], a[0], a[2], 0), setops._side(b[1], b[0], b[2], 1)),
        "merge (K7)": lambda: merge.merge_sorted(sa, sb, 3, (0,)),
        "compaction (2 stable sorts + gathers)": lambda: kmer.compact_live(
            lo_s, hi_s, ct_s, hi_s.numel()),
    }
    ph["large_k_setop_stages_ms"] = {}
    for label, fn in stages.items():
        ms = timer(fn, 3)
        ph["large_k_setop_stages_ms"][label] = ms
        print(f"    combine stage {label}: {ms:.3f} ms ({hi_s.numel()} merged rows)", flush=True)
    del combined, a, b, sa, sb, hi_s, lo_s, ct_s

    t = time.perf_counter()
    for _ in bnio.iter_fastq_batches(fq, FASTQ_BATCH, validate=False, with_validity=True,
                                     with_offsets=True, device=dev):
        pass
    torch.cuda.synchronize()
    ph["large_k_ingest_only_s"] = time.perf_counter() - t
    # count_fastq's loop replayed, to split the rest into the window keys
    # plus accumulator sorts and the final download into a dict
    acc = pipeline._SparseAcc(1 << 20, dev)
    t = time.perf_counter()
    for batch, bv, _ in bnio.iter_fastq_batches(fq, FASTQ_BATCH, validate=False,
                                                with_validity=True, with_offsets=True,
                                                device=dev):
        acc.add(*kmer.raw_window_keys(batch.words, batch.lengths, k, True, bv))
    acc.flush()
    torch.cuda.synchronize()
    ph["large_k_stream_s"] = time.perf_counter() - t
    t = time.perf_counter()
    replay = acc.to_dict()
    ph["large_k_to_dict_s"] = time.perf_counter() - t
    print(f"  gzip + framing + upload + K1 alone: {ph['large_k_ingest_only_s']:.2f} s; with "
          f"window keys and accumulator merges: {ph['large_k_stream_s']:.2f} s (final capacity "
          f"{acc.cap}); run list to dict: {ph['large_k_to_dict_s']:.2f} s; the count: "
          f"{ph['large_k_count_reads_s']:.2f} s", flush=True)
    check("replayed count loop == count_fastq", replay == reads_t)
    del acc, replay

    with config.backend("torch"):
        t = time.perf_counter()
        plain_t = pipeline.count_fastq(fq, k, **count_kw)
        ph["large_k_count_plain_s"] = time.perf_counter() - t
    check("count_fastq k=21 == plain backend", plain_t == reads_t)
    del plain_t

    ckpt = os.path.join(tmp, "count21.ckpt.npz")

    class Interrupt(Exception):
        pass

    def crash(ev):
        if ev["batches"] == 6:
            raise Interrupt()

    try:
        pipeline.count_fastq(fq, k, checkpoint=ckpt, checkpoint_every=4, on_progress=crash,
                             progress_every=1, **count_kw)
        check("interrupted k=21 run raised", False)
    except Interrupt:
        pass
    resumed = pipeline.count_fastq(fq, k, checkpoint=ckpt, checkpoint_every=4, **count_kw)
    check("resumed k=21 run == uninterrupted run", resumed == reads_t)
    del resumed

    want = oracle_counts(reads[:ORACLE_READS], k)
    got = pipeline.count_fastq(fq_small, k, **count_kw)
    check(f"{ORACLE_READS}-read subset at k={k} == host dict oracle", got == want,
          f"{len(want)} distinct k-mers")
    want = oracle_counts(genome[None, :CONTIG_ORACLE_BP], k)
    got = pipeline.count_fasta(fa_slice, k, canonical=True, on_invalid="skip", device=dev)
    check(f"count_fasta of the first {CONTIG_ORACLE_BP} bp == host dict oracle", got == want,
          f"{len(want)} distinct k-mers")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results here as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing ran", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import bitnuc_tpu_torch as bnt
        from bitnuc_tpu_torch import config, entry, kernels, pipeline
        from bitnuc_tpu_torch.kernels import _build
        from bitnuc_tpu_torch.ops import codec, hamming, kmer, merge, setops
        from bitnuc_tpu_torch.utils import bitops
    except ImportError as e:
        print(f"chip_smoke: cannot import bitnuc_tpu_torch ({e}); run from a checkout",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    results = {"kernels": {}, "phases": {}}
    t_all = time.perf_counter()

    # -- 1. device and build ------------------------------------------------
    print("phase 1: device", flush=True)
    smi = nvidia_smi_line()
    print(f"  device {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    t = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t
    print(f"  built {os.path.relpath(lib_path)} in {build_s:.1f} s", flush=True)
    results["phases"]["build_s"] = build_s

    timer = Timer(torch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    errs = {name: 0 for name in kernels.LAUNCHES}
    timings = {name: [] for name in errs}

    def compare(name, label, got, want):
        d = max_abs_diff(got, want)
        errs[name] = max(errs[name], d)
        return check(f"{name} {label} == plain", d == 0, f"max |diff| {d}")

    def timed(name, label, kern, plain, reps=5, plain_reps=3, main=False):
        """Time a kernel and its plain version; ``main`` marks the shape
        that the summary line reports for the kernel."""
        ms, pms = timer(kern, reps), timer(plain, plain_reps)
        timings[name].append({"shape": label, "ms": ms, "plain_ms": pms, "main": main})
        print(f"    {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)

    # -- 2. kernels against their plain versions ----------------------------
    print("phase 2: kernels against plain versions", flush=True)
    acgt = torch.tensor(list(b"ACGTacgt"), dtype=torch.uint8, device=dev)

    def reads(B, L, invalid=0.01):
        a = acgt[torch.randint(0, 8, (B, L), device=dev, generator=gen)]
        bad = torch.rand((B, L), device=dev, generator=gen) < invalid
        a = torch.where(bad, torch.tensor(ord("N"), dtype=torch.uint8, device=dev), a)
        lens = torch.randint(1, L + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
        return a.contiguous(), lens

    ascii_b, lens_b = reads(READS, READ_LEN)
    for B, L in [(READS, READ_LEN), (1, 1), (5, 33), (3, 1000)]:
        a, ln = (ascii_b, lens_b) if B == READS else reads(B, L, 0.05)
        compare("pack", f"[{B},{L}]", codec.encode_reads_kernel(a, ln),
                codec.encode_reads_torch(a, ln))
    timed("pack", f"[{READS},{READ_LEN}]",
          lambda: codec.encode_reads_kernel(ascii_b, lens_b),
          lambda: codec.encode_reads_torch(ascii_b, lens_b), main=True)

    words_b, _ = codec.encode_reads_kernel(ascii_b, lens_b)
    valid_b = codec.validity_mask(ascii_b, lens_b)
    n_windows = int(torch.clamp(lens_b.long() - 7, min=0).sum())
    for k in (1, 7, 8, 12):
        for canonical in (False, True):
            for nskip in (False, True):
                lo, _, v = kmer._window_keys(words_b, lens_b, k, canonical,
                                             valid_b if nskip else None)
                keys = torch.where(v, lo, 4**k).reshape(-1).contiguous()
                label = f"k={k} canonical={int(canonical)} nskip={int(nskip)} N={keys.numel()}"
                compare("hist_keys", label, kmer.histogram_from_keys_kernel(keys, k),
                        kmer.histogram_from_keys_torch(keys, k))
                if canonical and nskip:
                    timed("hist_keys", label,
                          lambda: kmer.histogram_from_keys_kernel(keys, k),
                          lambda: kmer.histogram_from_keys_torch(keys, k),
                          main=k == STREAM_K)
                del lo, v, keys
    print(f"    ({n_windows} windows of k = 8 in the batch)", flush=True)

    long_ascii, _ = reads(64, 16_384, 0.0)
    long_lens = torch.full((64,), 16_384, dtype=torch.int32, device=dev)
    long_words, _ = codec.encode_reads_kernel(long_ascii, long_lens)
    for k in (1, 4, 8):
        for label, w, ln in (
            (f"k={k} [{READS},{words_b.shape[1]}]", words_b, lens_b),
            (f"k={k} [64,{long_words.shape[1]}]", long_words, long_lens),
        ):
            compare("hist_words", label, kmer.histogram_from_words_kernel(w, ln, k),
                    kmer.histogram_from_words_torch(w, ln, k))
            timed("hist_words", label,
                  lambda: kmer.histogram_from_words_kernel(w, ln, k),
                  lambda: kmer.histogram_from_words_torch(w, ln, k),
                  main=k == entry.K and w is words_b)

    # K2: the flagship batch, long reads, and edge shapes (lengths past
    # max_len, max_len past the capacity 16 * W, zero and negative lengths)
    for label, w, ln, ml in (
        (f"[{READS},{READ_LEN}]", words_b, lens_b, READ_LEN),
        (f"[64,{long_words.shape[1] * 16}]", long_words, long_lens, None),
    ):
        compare("unpack", label, codec.decode_reads_kernel(w, ln, ml),
                codec.decode_reads_torch(w, ln, ml))
        timed("unpack", label, lambda: codec.decode_reads_kernel(w, ln, ml),
              lambda: codec.decode_reads_torch(w, ln, ml), main=w is words_b)
    for B, W, ml in ((1, 2, 1), (5, 4, 33), (4, 2, None), (3, 2, 48), (6, 10, 150), (7, 4, 0)):
        w = torch.randint(-(2**31), 2**31 - 1, (B, W), device=dev, generator=gen,
                          dtype=torch.int32)
        ln = torch.randint(-2, 16 * W + 20, (B,), device=dev, generator=gen, dtype=torch.int32)
        if ml is None:
            ln.zero_()
        compare("unpack", f"[{B},{ml}] W={W}", codec.decode_reads_kernel(w, ln, ml),
                codec.decode_reads_torch(w, ln, ml))
    compare("unpack", "1-D row", codec.decode_reads(words_b[3], lens_b[3], READ_LEN),
            codec.decode_reads_torch(words_b[3], lens_b[3], READ_LEN))

    W_db = DB_BASES // 16
    db = torch.randint(-(2**31), 2**31 - 1, (W_db, DB_ENTRIES), device=dev,
                       generator=gen, dtype=torch.int32)
    q64 = torch.randint(-(2**31), 2**31 - 1, (64, W_db), device=dev,
                        generator=gen, dtype=torch.int32)
    db_small = db[:, :1000].contiguous()
    for nb in (512, 150, 7):
        for Q in (1, 64):
            q = q64[:Q].contiguous()
            label = f"Q={Q} D={DB_ENTRIES} n_bases={nb}"
            compare("hdist_scan", label, hamming.hdist_scan_kernel(q, db, nb),
                    hamming.hdist_scan_torch(q, db, nb))
            if nb in (512, 150):
                timed("hdist_scan", label,
                      lambda: hamming.hdist_scan_kernel(q, db, nb),
                      lambda: hamming.hdist_scan_torch(q, db, nb),
                      main=Q == 1 and nb == DB_BASES)
        for Q, d in ((3, db), (64, db_small), (3, db_small)):
            q = q64[:Q].contiguous()
            compare("hdist_scan", f"Q={Q} D={d.shape[1]} n_bases={nb}",
                    hamming.hdist_scan_kernel(q, d, nb), hamming.hdist_scan_torch(q, d, nb))
    del db, q64, db_small, long_ascii, long_words

    # K7: sorted lists with 1..3 key words and 0..2 payloads; small, empty,
    # heavily duplicated (around the sign bit and the all-ones word) and
    # the set-algebra shape
    pool = torch.tensor([0, 1, 2, 2**31 - 1, -(2**31), -1], dtype=torch.int32, device=dev)

    def sorted_cols(n, n_keys, n_pay, dups, src=None):
        if src is not None:  # combine_counts' rows: k = 21 (hi, lo), source
            ks = [torch.randint(0, 1 << 10, (n,), device=dev, generator=gen, dtype=torch.int32),
                  torch.randint(-(2**31), 2**31 - 1, (n,), device=dev, generator=gen,
                                dtype=torch.int32),
                  torch.full((n,), src, dtype=torch.int32, device=dev)]
        elif dups:
            ks = [pool[torch.randint(0, 6, (n,), device=dev, generator=gen)]
                  for _ in range(n_keys)]
        else:
            ks = [torch.randint(-(2**31), 2**31 - 1, (n,), device=dev, generator=gen,
                                dtype=torch.int32) for _ in range(n_keys)]
        sort_keys = ([bitops.u64_sort_key(ks[0], ks[1])] + [bitops.u32_sort_key(x) for x in ks[2:]]
                     if n_keys >= 2 else [bitops.u32_sort_key(ks[0])])
        perm = bitops.lex_argsort(sort_keys)
        cols = [x[perm] for x in ks]
        cols += [torch.randint(1, 50, (n,), device=dev, generator=gen, dtype=torch.int32)
                 for _ in range(n_pay)]
        return cols

    for n_keys in (1, 2, 3):
        for n_pay in (0, 1, 2):
            for na, nb, dups in ((300, 200, False), (0, 5000, False), (5000, 0, True),
                                 (100_000, 70_000, True)):
                a = sorted_cols(na, n_keys, n_pay, dups)
                b = sorted_cols(nb, n_keys, n_pay, dups)
                pad = tuple(range(n_pay)) or None
                compare("merge", f"n_keys={n_keys} payloads={n_pay} {na}+{nb} dups={int(dups)}",
                        merge.merge_sorted_kernel(a, b, n_keys, pad),
                        merge.merge_sorted_torch(a, b, n_keys, pad))
    a = sorted_cols(MERGE_ROWS, 3, 1, False, src=0)
    b = sorted_cols(MERGE_ROWS, 3, 1, False, src=1)
    label = f"n_keys=3 payloads=1 {MERGE_ROWS}+{MERGE_ROWS}"
    compare("merge", label, merge.merge_sorted_kernel(a, b, 3, (0,)),
            merge.merge_sorted_torch(a, b, 3, (0,)))
    timed("merge", label, lambda: merge.merge_sorted_kernel(a, b, 3, (0,)),
          lambda: merge.merge_sorted_torch(a, b, 3, (0,)), main=True)
    del a, b
    torch.cuda.synchronize()

    # -- 3. goldens ----------------------------------------------------------
    print("phase 3: goldens", flush=True)
    g = bnt.PackedReads.from_ascii([b"ACGT"], device=dev)
    check("ACGT encodes to 0b11100100", int(g.to_u64()[0, 0]) == 0b11100100)
    r = bnt.PackedReads.from_u64(np.array([[71620941647064936]], np.uint64), [28], device=dev)
    check("from_2bit(71620941647064936, 28)",
          r.to_ascii() == [b"AGGCTTGAGGCCCATTCTCTGATCGTTT"])
    qd = bnt.PackedReads.from_ascii([b"ACTGACTG", b"TGCATGCA"], device=dev)
    gdb = bnt.PackedDB.from_reads(bnt.PackedReads(qd.words[1:], qd.lengths[1:]), 8)
    check("hdist(ACTGACTG, TGCATGCA) == 8", int(gdb.distances(qd.words[0])[0]) == 8)

    # -- 4 + 5. the main path --------------------------------------------------
    fwd, (ascii_e, lens_e, db_e) = entry.entry(
        device=dev, batch=READS, read_len=READ_LEN, db_size=DB_ENTRIES, seed=args.seed
    )
    tmp = tempfile.mkdtemp(prefix="bitnuc_smoke_")
    try:
        rng = np.random.default_rng(args.seed)
        seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (FASTQ_READS, READ_LEN))
        seqs[rng.integers(0, 200, seqs.shape, dtype=np.uint8) == 0] = ord("N")
        fq = os.path.join(tmp, "reads.fq")
        fq_small = os.path.join(tmp, "subset.fq")
        t = time.perf_counter()
        write_fastq(fq, seqs)
        write_fastq(fq_small, seqs[:ORACLE_READS])
        results["phases"]["fastq_write_s"] = time.perf_counter() - t
        count_kw = dict(batch_size=FASTQ_BATCH, canonical=True, on_invalid="skip", device=dev)

        print("phase 4+5: main path (flagship step, streaming count) under auto", flush=True)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_k = fwd(ascii_e, lens_e, db_e)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        t = time.perf_counter()
        hist_k = pipeline.count_fastq(fq, STREAM_K, **count_kw)
        count_s = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        print(f"  flagship step {step_s * 1e3:.1f} ms (first call), streaming count "
              f"{count_s:.2f} s, launches {launches}", flush=True)
        for name in ("pack", "hist_keys", "hist_words", "hdist_scan"):
            check(f"{name} launched on the main path", launches[name] > 0,
                  f"{launches[name]} launches")
        results["phases"].update(step_kernel_s=step_s, count_kernel_s=count_s, launches=launches)

        print("phase 4: flagship step against backend('torch')", flush=True)
        with config.backend("torch"):
            out_p = fwd(ascii_e, lens_e, db_e)
        for backend in ("auto", "torch"):  # warm step times, kernels then plain
            with config.backend(backend):
                ms = timer(lambda: fwd(ascii_e, lens_e, db_e), 3)
            results["phases"][f"step_{backend}_warm_ms"] = ms
            print(f"  flagship step under {backend!r}, warm: {ms:.3f} ms", flush=True)
        for key in out_k:
            check(f"step output {key}", torch.equal(out_k[key], out_p[key]),
                  f"shape {tuple(out_k[key].shape)}")
        gc = out_k["gc_content"]
        check("gc_content finite in [0, 100]",
              bool(torch.isfinite(gc).all() and (gc >= 0).all() and (gc <= 100).all()))
        want_windows = READS * (READ_LEN - entry.K + 1)
        check("k = 8 histogram counts every window",
              int(out_k["kmer_hist"].long().sum()) == want_windows
              and int(out_k["kmer_hist_canonical"].long().sum()) == want_windows)
        top = out_k["top_dists"]
        check("top-16 ascending", bool((top[1:] >= top[:-1]).all()))
        words_e = out_k["words"]
        stages = {  # where the warm step's time goes, one stage at a time
            "encode (K1)": lambda: codec.encode_reads(ascii_e, lens_e),
            "count k=8 (K3b)": lambda: kmer.count_kmers_reads(words_e, lens_e, entry.K),
            "count k=8 canonical (keys + K3a)": lambda: kmer.count_kmers_reads(
                words_e, lens_e, entry.K, canonical=True),
            "gc_content": lambda: bnt.gc_content_reads(words_e, lens_e),
            "reverse complement": lambda: bnt.reverse_complement_reads(words_e, lens_e),
            "search top-16 (K4 + top-k)": lambda: db_e.search(words_e[0], entry.TOPK),
        }
        results["phases"]["step_stages_ms"] = {}
        for label, fn in stages.items():
            ms = timer(fn, 3)
            results["phases"]["step_stages_ms"][label] = ms
            print(f"    stage {label}: {ms:.3f} ms", flush=True)
        del out_k, out_p, ascii_e, lens_e, db_e, words_e

        print("phase 5: streaming count", flush=True)
        t = time.perf_counter()
        for _ in bnt.io.iter_fastq_batches(fq, FASTQ_BATCH, validate=False, with_validity=True,
                                           with_offsets=True, device=dev):
            pass
        torch.cuda.synchronize()
        results["phases"]["ingest_only_s"] = time.perf_counter() - t
        print(f"  framing + upload + K1 alone: {results['phases']['ingest_only_s']:.2f} s "
              f"of the count's {count_s:.2f} s", flush=True)
        with config.backend("torch"):
            t = time.perf_counter()
            hist_p = pipeline.count_fastq(fq, STREAM_K, **count_kw)
            results["phases"]["count_plain_s"] = time.perf_counter() - t
        check("count_fastq == plain run", np.array_equal(hist_k, hist_p),
              f"{int(hist_k.sum())} windows")
        ckpt = os.path.join(tmp, "count.ckpt.npz")

        class Interrupt(Exception):
            pass

        def crash_after_first_checkpoint(ev):
            if ev["batches"] == 6:
                raise Interrupt()

        try:
            pipeline.count_fastq(fq, STREAM_K, checkpoint=ckpt, checkpoint_every=4,
                                 on_progress=crash_after_first_checkpoint,
                                 progress_every=1, **count_kw)
            check("interrupted run raised", False)
        except Interrupt:
            pass
        hist_r = pipeline.count_fastq(fq, STREAM_K, checkpoint=ckpt, checkpoint_every=4,
                                      **count_kw)
        check("resumed run == uninterrupted run", np.array_equal(hist_r, hist_k))
        t = time.perf_counter()
        want = oracle_counts(seqs[:ORACLE_READS], STREAM_K)
        hist_s = pipeline.count_fastq(fq_small, STREAM_K, **count_kw)
        nz = np.flatnonzero(hist_s)
        got = dict(zip(nz.tolist(), hist_s[nz].tolist()))
        check(f"{ORACLE_READS}-read subset == host dict oracle", got == want,
              f"{len(want)} distinct k-mers, {time.perf_counter() - t:.1f} s")
        del seqs, hist_k, hist_p, hist_r, hist_s, got, want

        large_k_phase(args, torch, dev, timer, tmp, results)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches.update({name: LARGE_K_LAUNCHES[name] for name in ("unpack", "merge")})

    # -- report ------------------------------------------------------------
    # kernel -> (source, TPU kernel's def, its pallas_call)
    sources = {
        "pack": ("bitnuc_tpu_torch/csrc/pack.cu", "bitnuc_tpu/ops/pallas/pack.py:77",
                 "bitnuc_tpu/ops/pallas/pack.py:103"),
        "hist_keys": ("bitnuc_tpu_torch/csrc/histogram.cu",
                      "bitnuc_tpu/ops/pallas/histogram.py:236",
                      "bitnuc_tpu/ops/pallas/histogram.py:272"),
        "hist_words": ("bitnuc_tpu_torch/csrc/histogram.cu",
                       "bitnuc_tpu/ops/pallas/histogram.py:130",
                       "bitnuc_tpu/ops/pallas/histogram.py:217"),
        "hdist_scan": ("bitnuc_tpu_torch/csrc/hamming.cu",
                       "bitnuc_tpu/ops/pallas/hamming.py:46",
                       "bitnuc_tpu/ops/pallas/hamming.py:72"),
        "unpack": ("bitnuc_tpu_torch/csrc/unpack.cu", "bitnuc_tpu/ops/pallas/unpack.py:61",
                   "bitnuc_tpu/ops/pallas/unpack.py:83"),
        "merge": ("bitnuc_tpu_torch/csrc/merge.cu", "bitnuc_tpu/ops/pallas/merge.py:141",
                  "bitnuc_tpu/ops/pallas/merge.py:121"),
    }
    lines = []
    for name, (src, replaces, call) in sources.items():
        head = next(t for t in timings[name] if t["main"])
        item = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "pallas_call": call, "launches": launches[name], "max_abs_err": errs[name],
                "ms": head["ms"], "plain_ms": head["plain_ms"], "shape": head["shape"]}
        if name == "hdist_scan":
            item["also_replaces"] = "bitnuc_tpu/ops/pallas/hamming.py:115"
        lines.append(item)
    results["kernels"] = lines
    results["timings"] = timings
    results["device"] = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    results["phases"]["total_s"] = time.perf_counter() - t_all
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"total {results['phases']['total_s']:.1f} s", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase that raised: report and fail
        traceback.print_exc()
        sys.exit(1)
