#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (bitnuc_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py [--out results.json] [--seed 0]
    python3 chip_smoke.py --k6-against DIR [--out results.json]
    python3 chip_smoke.py --orf-against DIR [--out results.json]
    python3 chip_smoke.py --pack-against DIR [--out results.json]
    python3 chip_smoke.py --hist-against DIR [--out results.json]
    python3 chip_smoke.py --unpack-against DIR [--out results.json]
    python3 chip_smoke.py --chain-against DIR [--out results.json]

The last six forms run no phase: they time K6 (tc_scan and tc_search),
K10 (orf_scan) and longest_orf, K1 (pack), K3b's counts and the flagship
step, K2 (unpack), or chain_anchors (C1), of this checkout beside those of
another checkout in DIR (for example a git archive of an earlier commit,
unpacked), in turns DIR, this, this, DIR, on one card (see k6_against,
orf_against, pack_against, hist_against, unpack_against and
chain_against).

Phases, each of which must pass:

1. Device: the card's name and power limit, and the kernel build (all of
   bitnuc_tpu_torch/csrc/*.cu with nvcc, timed); the registers, shared
   memory and spills of pack.cu (K1), unpack.cu (K2), histogram.cu (K3a,
   K3b), tcscan.cu (K6), merge.cu (K7), wavefront.cu (K8, K9), orf.cu
   (K10) and chain.cu (C1).
2. Every kernel against its plain PyTorch version on the card, bit for bit:
   K1 pack (at the flagship's batch, a count batch, reads of 300, 1,000
   and 4,000 bp, 64 rows of 16,384 bp, phase 6's genome as one row and a
   base pointer off 16-byte alignment, with lengths -2, 0 and past L, and
   the device operations of one call), K2 unpack (at reads of 150 bp, the
   large-k decode's k-mers, reads of 300 and 4,000 bp, 64 rows of 16,384
   bp and words off 16-byte alignment, with lengths -2, 0 and past L, and
   at edge shapes), K3a hist_keys, K3b
   hist_words (plain and canonical at k = 1, 4, 7, 8, 9 and 12, at edge
   lengths and on poly-A; timed at the flagship step's two k = 8 launches,
   the main rows), K4 hdist_scan and K5
   hdist_scan_batch (one kernel), K6 tc_scan, K7 merge and K10 orf_scan at
   the main paths' shapes and at edge shapes (K3a also on poly-A keys and
   at k = 11; K7 also lopsided and all ties; K10 at phase 8's batch on
   both strands, and on one strand at the table's row, phase 8's contigs,
   rows of 100,000 bp and reads of 300, 1,000 and 4,000 bp), each timed
   with CUDA events (median of several runs, L2 flushed before each) beside
   its plain version. K6 also against K5 on the full database at Q = 1 to
   512, at 512-base and 150-base entries (the sweep behind
   database.tc_min_q), and beside torch._int_mm. tc_search, K6's search
   form with a per-block top-k, against its plain version, against tc_scan
   + top-k on the full database at k = 1, 10 and SEARCH_TOPK_MAX, at edge
   shapes and on a database of one repeated entry, beside torch._int_mm +
   the top-k, and both search_batch routes swept at Q = 1 to 512 (the
   sweep behind database.SEARCH_TC_MIN_Q).
3. The golden vectors of the reference crate, through PackedReads and
   PackedDB and through the host API tier (as_2bit, from_2bit,
   encode/decode, hdist, PackedSequence).
4. The flagship step (bitnuc_tpu_torch.entry) on 262,144 reads x 150 bp
   against a 4,194,304-entry database, under the default backend (kernels)
   and under backend("torch") (plain versions), output for output.
5. Streaming canonical k = 12 counting of a generated FASTQ (1,000,000
   reads x 150 bp, 0.5% N, N-skip) with pipeline.count_fastq: equal to the
   plain run, a run interrupted after its first checkpoint and resumed
   equals an uninterrupted one, and a 10,000-read subset equals a host
   dict oracle. Timed at prefetch 2 (the default: framing on a producer
   thread) and 0, with equal histograms.
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
7. Short-read mapping of phase 6's genome and reads at the CLI defaults
   (k = 15, w = 10, max_occ = 8): MinimizerIndex.build_multi of the FASTA's
   contigs, map_reads in batches of 262,144 (K8 fit_banded),
   traceback_cigars, and a local rescoring of the first batch with
   ops.align.sw_score (K9). K8 and K9 against their plain versions at the
   first batch's shapes and at edge shapes (for K9 also tie-heavy rows and
   one cell a lane); one batch against the plain
   backend; checks against the reads' true starts and strands, Hamming
   distances and planted exact reads, on the CIGARs, and against a host
   full-DP fit of 256 reads.
8. Many-query search and ORF calling: PackedDB.search_batch of 256 queries
   (tc_search) and of 8, distances_batch (K6 tc_scan at 256, K5 at 8) with
   topk_batch_dispatch, against phase 2's database, PackedDB.from_fastq of a
   100,000-read FASTQ, ops.orf.longest_orf (K10) over phase 6's reads in
   batches of 262,144 and over its genome cut into 50 contigs of 100,000
   bp, and the --translate steps on the first batch. Checked against the
   plain backend, a host Hamming oracle, host-packed words, a host
   six-frame ORF oracle and a host codon table.
9. The public surface and pair merging: 262,144 read pairs of 150 bp (1%
   substitutions) from fragments of 160-400 bp as R1/R2 FASTQ, merged
   along bitnuc-tpu merge's path (io.read_fastq with K1, merge_pairs at
   min_overlap 10 and max_mismatch_frac 0.1, codec.decode_reads with K2),
   its stages timed; checked 'packed' against 'codes', against the plain
   backend, a 4,096-pair subset against a CPU run, and the pairs with a
   clean true overlap of 20 bp or more against their true fragments.
   read_fastq_fast, iter_fastq_ascii_batches and iter_fastq_record_batches
   against read_fastq, pipeline.stats against host counts (and its
   InvalidBase on phase 5's FASTQ), hdist_topk_batch of phase 8's queries
   against search_batch (timed beside it), and windowed_gc of phase 8's
   contigs against a numpy float32 model.
10. Long reads, pairs, calls and sketches, on phase 6's genome and phase
   7's index. map --long: 8,192 reads of 1,000-10,000 bp from both strands
   (1% substitutions, 0.5% one-base insertions and 0.5% deletions) as FASTQ,
   read with read_fastq_fast (K1) and mapped with map_reads_long (C1 chain)
   at the CLI's settings; checked against the true spans, the 256 shortest
   reads against the plain backend, 64 reads against a CPU run, and with
   extend=True on 1,024 reads of 1,000-3,000 bp, 16 fits against a host
   full-DP oracle. C1 (chain_anchors from unsorted anchors) against its
   plain version at the sub-batch's anchors, a chunk's (timed, with the
   largest and median live anchors a row and the time a step of the
   longest row) and edge shapes, rows past a warp's and a block's shared
   memory among them; the chunk's seeding, its row sort alone (the
   earlier route's) and the unbanded extension fit timed. map --paired: map_pairs of 262,144 pairs
   (fragments of 200-800 bp, 1% RF, 1% split) against map_reads of the
   stacked batch and the pairing rule, and against the truth. call: a donor
   of the genome's first 1,000,000 bp with 1,000 SNPs and 100 indels,
   200,000 reads of 150 bp mapped and called in both modes; the grid against
   np.add.at, the calls against the planted variants, the path against the
   plain backend. sketch: minimizer_sketch (k = 15) and minimizer_sketch64
   (k = 21) of the genome FASTA and of 262,144 reads, against a host set
   model.
11. The read-processing tier, on phase 6's genome, reads and k = 21
   tables: filter_fastq (adapter, quality trim, length, mean quality, N,
   complexity and entropy filters), filter_fastq_paired and qc_profile of a
   262,144-read FASTQ with declining qualities, planted adapters, poly-A and
   N-rich reads; mark_duplicates of 262,144 reads with 25% copies,
   screen_reads of them and 16,384 random reads against the genome's
   table, correct_reads against the reads' own table (4 rounds, decoded
   with K2) and assign_barcodes of 96 barcodes of 8 bp; each stage timed
   warm; checked against the numpy filter reference, a host QC fold,
   np.unique, a host k-mer oracle, the reads' true genome slices, a host
   argmin, CPU runs of subsets and the plain backend.

The launch counters are set to 0 just before each main path (phases 4 and
5 under the default backend, phases 6, 7, 8, 9 and 11, and each path of
phase 10) and read just after it; every
kernel of that path must have launched there, and the flagship step alone
must make two K3b launches (its plain and canonical k = 8 counts) and no K3a
launch. The last lines printed are a
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
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

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
MAP_K, MAP_W, MAP_OCC, MAP_MIN_SEEDS = 15, 10, 8, 2  # bitnuc-tpu map's defaults
SW_WINDOW = 224  # K9's rescoring window: the read plus 37 bp on each side
ORACLE_PAIRS = 256

# The least time the card could take (bound_ms): the larger of the bytes a
# kernel must move (inputs read once, outputs written once) over the HBM
# rate and its operations over the rate of their unit. NVIDIA H100 SXM at its
# 1.98 GHz boost clock: 3.35 TB/s; 132 SMs x 64 int32 results per clock
# (add, compare, min, select, shift, logic) and 16 population counts per
# clock (NVIDIA's CUDA documentation, arithmetic instruction throughput for
# compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
POPC_PER_S = 132 * 16 * 1.98e9
# int32 operations of the recurrence of one DP cell, boundaries and the
# per-diagonal extraction left out: K8 the code compare and substitution
# select, 3 candidate sums and 2 mins for D, 3 tie compares, 3 selects and
# 2 mins for the span origin S; K9 the code compare and score select, 2
# sums and a max each for E and F, a sum and 3 maxima for H. The cells are
# those the inputs need: K8 the band's cells inside each read's matrix, K9
# the m x n cells of each pair. K7 as a linear merge: per output row 3 key
# compares, 2 operations to combine them into one order and the pointer step.
FIT_OPS_PER_CELL = 15
SW_OPS_PER_CELL = 12
MERGE_OPS_PER_ROW = 6
# K6 runs on the int8 tensor cores: 1,979 dense TOP/s on an H100 SXM
# (NVIDIA's H100 data sheet, int8 without sparsity). K10 counted as the
# function needs it, a SWAR pass over each packed word a read covers (16
# bases): one-hot masks of A, G and T from the two bit planes (8), the next
# bases' masks by funnel shifts from the following word (5), the stop mask
# T & (A1 & (A2 | G2) | G1 & A2) and the start mask A & T1 & G2 (7), and
# per frame its start and stop bits, the first start and last stop, the
# candidate length and its compare with the carried best (3 x 8), and the
# three frames' next-stop carry (3): 47, taken as 48 per word. Both strands
# (six frames) decode each word once: the one-hot masks and shifts (13) are
# shared, a C mask (2) serves the reverse strand's motifs read forward (CAT
# for its starts; TTA, CTA, TCA for its stops), and each strand has its own
# codon masks, frames and carries (2 x 34): 83 per word. How a design makes
# the reverse strand (here, by building its words) is its own cost.
INT8_TC_OPS_PER_S = 1.979e15
# K1 counted as the function needs it in SWAR form, over a four-byte lane
# of ASCII: the codes ((x >> 1) ^ (x >> 2)) & 3 (two shifts and a
# three-input logic op, 3), their fold into the word's byte (a multiply and
# a shift-merge, 2), the lane's selector (a shift-or, 2) and the two byte
# permutes that give the expected bytes (2), the compare of the lower-cased
# bytes (a three-input logic op, 1), the nonzero-byte test (and, add,
# or-and, 3) and the lane's bits into the word's mask (1): 14 a lane; with a
# word's in-length mask, first bad base and store, 4 a base.
PACK_OPS_PER_BASE = 4
# K3b counted a window at a time: the window key by a funnel shift of the
# word and its neighbour (1) and the k-base mask (1), its validity (1), the
# bin's address and the add (2), and the word's load and window count spread
# over its 16 windows (1): 6. The canonical key, in its cheapest form: the
# reverse complement of the word and of its neighbour once a word (__brev,
# and the pair swap as two shifts and a three-input logic op: 4 each, the
# complement left to the window's mask), 8 over 16 windows; then a window's
# by a funnel shift of the two (1), the complement and mask in one logic op
# (1), and the min (1): 3.5 more, 9.5.
HIST_OPS_PER_WINDOW = 6
HIST_PRIVATE_K = 7  # K3b's largest k on private tables, timed beside k = 8
HIST_CANONICAL_OPS_PER_WINDOW = HIST_OPS_PER_WINDOW + 3 + 8 / 16
ORF_OPS_PER_WORD = 48
ORF_TWO_STRAND_OPS_PER_WORD = 8 + 5 + 2 + 2 * (7 + 3 * 8 + 3)
TC_SWEEP_Q = (1, 8, 16, 32, 64, 128, 256, 512)
SEARCH_SWEEP_Q = (1, 8, 32, 64, 128, 256, 512)  # search_batch's two routes
SEARCH_QUERIES = 256  # phase 8's query file, and K6's reported shape
TC_SLICE = 262_144  # database entries K6's plain version is compared on
# The k-mers phase 6 decodes (reads minus genome at k = 21, seed 0), K2's
# (k) row; phase 6 prints its own count beside it
UNPACK_K_ROWS = 7_663_238

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


def band_cells(torch, lens_a, lens_b, off_lo: int, off_hi: int, M: int, N: int) -> int:
    """Cells of the fit's band that lie inside each read's matrix (0 <= i <=
    m, 0 <= j <= n), summed over the batch: on diagonal d the band holds j in
    [base(d), base(d) + K) (ops.align._band_geometry), the matrix j in
    [max(0, d - m), min(n, d)]."""
    from bitnuc_tpu_torch.ops import align

    K, base = align._band_geometry(off_lo, off_hi, N)
    m = torch.clamp(lens_a.long(), max=M)
    n = torch.clamp(lens_b.long(), max=N)
    total = torch.zeros((), dtype=torch.int64, device=m.device)
    for d in range(1, int((m + n).max()) + 1 if m.numel() else 1):
        lo = torch.clamp(d - m, min=base(d))
        hi = torch.clamp(n, max=min(d, base(d) + K - 1))
        total += torch.clamp(hi - lo + 1, min=0).sum()
    return int(total)


class Timer:
    """Median milliseconds of a callable on the card, CUDA events around
    each run, a 256 MiB write before each run to flush the 50 MB L2."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 5, warmup: bool = True) -> float:
        """``warmup=False`` where the caller has just run fn once."""
        torch = self.torch
        if warmup:
            fn()
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


def device_events(torch, fn) -> list:
    """torch.profiler's CUDA activity of one warm call of fn, by name: the
    entries that took device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_time_total]


def device_ms_by_kernel(torch, fn) -> dict:
    """{kernel: device ms} of one warm call of fn (``device_events``);
    names shortened to the function's."""
    out = {}
    for e in device_events(torch, fn):
        name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = re.split(r"[<( ]", name)[0].split("::")[-1]
        out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
    return out


def print_passes(torch, results, name, label, fn) -> None:
    """Print and record the device ms of each kernel of one warm call of fn
    (``device_ms_by_kernel``) under phases[name + "_passes_ms"][label]."""
    passes = device_ms_by_kernel(torch, fn)
    results["phases"].setdefault(f"{name}_passes_ms", {})[label] = passes
    print("      device ms a kernel (one warm call, torch.profiler): "
          + (", ".join(f"{n} {ms:.4f}" for n, ms in passes.items()) or "not measured"),
          flush=True)


def max_abs_diff(a, b) -> int:
    """Largest |a - b| over tensors, or tuples or dicts of them (int64 exact)."""
    if isinstance(a, dict):
        return max_abs_diff(list(a.values()), [b[k] for k in a]) if a.keys() == b.keys() \
            else 2**62
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


def sample_reads(rng, genome: np.ndarray, n: int, L: int):
    """n reads of L bases from uniform positions on both strands, with
    SUB_RATE substitutions and N_RATE Ns: (ASCII [n, L], each read's true
    forward start [n], and True where it was drawn from the reverse
    strand [n])."""
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
    return reads, starts, rev


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
LARGE_K_TABLES = {}  # phase 6's k = 21 tables as counted lists on the card


def large_k_phase(args, torch, dev, timer, tmp, results):
    """Phase 6: k = 21 counts of reads and genome, set algebra (K7), decode
    of the reads' error k-mers (K2), and the checks of all of it. Returns
    (FASTA path, genome, reads, true starts, reverse flags) for phase 7."""
    from bitnuc_tpu_torch import config, io as bnio, kernels, pipeline
    from bitnuc_tpu_torch.ops import codec, kmer, merge, setops

    k = LARGE_K
    ph = results["phases"]
    rng = np.random.default_rng(args.seed + 1)
    t = time.perf_counter()
    genome = make_genome(rng)
    reads, true_starts, true_rev = sample_reads(rng, genome, FASTQ_READS, READ_LEN)
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
    print(f"  unpack_kmers decoded {n_err} k-mers (K2's (k) row in phase 2 and "
          f"--unpack-against: {UNPACK_K_ROWS})", flush=True)
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
        if label == "merge (K7)":
            print_passes(torch, results, "large_k_merge", label, fn)
    LARGE_K_TABLES.update(reads=a, genome=b)  # phase 11 screens and corrects against them
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
    return fa, genome, reads, true_starts, true_rev


MAP_LAUNCHES = {}


def random_pairs(torch, gen, dev, B, Wa, Wb, ties=False):
    """B (read, window) pairs of packed words [B, Wa], [B, Wb] with int32
    lengths: a's prefix planted in b with substitutions, or with ties=True
    low-entropy rows (runs of one base, period-2 and period-3 repeats) where
    many cells share the best score; random lengths with empty and full
    sides in the first rows."""
    from bitnuc_tpu_torch.utils import bitops

    M, N = 16 * Wa, 16 * Wb
    if ties:
        period = torch.randint(1, 4, (B, 1), device=dev, generator=gen, dtype=torch.int32)
        phase = torch.randint(0, 3, (B, 1), device=dev, generator=gen, dtype=torch.int32)
        a = torch.arange(M, device=dev, dtype=torch.int32)[None, :] % period
        b = (torch.arange(N, device=dev, dtype=torch.int32)[None, :] + phase) % period
    else:
        a = torch.randint(0, 4, (B, M), device=dev, generator=gen, dtype=torch.int32)
        b = torch.randint(0, 4, (B, N), device=dev, generator=gen, dtype=torch.int32)
        n = min(M, N)
        off = (N - n) // 2
        b[:, off : off + n] = a[:, :n]
        if N:
            hits = torch.rand((B, N), device=dev, generator=gen) < 0.02
            b = torch.where(hits, (b + 1) % 4, b)
    la = torch.randint(0, M + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
    lb = torch.randint(0, N + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
    la[:3] = torch.tensor([0, M, M], dtype=torch.int32)
    lb[:3] = torch.tensor([N, 0, N], dtype=torch.int32)
    return bitops.pack_codes(a), la, bitops.pack_codes(b), lb


def ascii_codes(x: np.ndarray) -> np.ndarray:
    """The packer's arithmetic ASCII -> 2-bit map (N packs as A)."""
    x = x.astype(np.int32)
    return ((x >> 1) ^ (x >> 2)) & 3


def fit_oracle(a: np.ndarray, b: np.ndarray, mismatch: int = 1, gap: int = 1):
    """Host full-DP fitting alignment of codes a into b: (cost, start, end)
    with the earliest end and, among optimal paths to it, the smallest
    start. Rows go one at a time; the left moves of a row are one
    lexicographic running min over (cost - j * gap, start)."""
    m, n = len(a), len(b)
    j = np.arange(n + 1, dtype=np.int64)
    D = np.zeros(n + 1, np.int64)  # row 0: free b-prefix, the path enters at j
    S = j.copy()
    shift = 1 << 21  # start < 2^21: (value, start) pairs order as one int64
    for i in range(1, m + 1):
        sub = np.where(b == a[i - 1], 0, mismatch)
        diag = D[:-1] + sub
        up = D[1:] + gap
        X = np.minimum(diag, up)
        SX = np.minimum(np.where(diag == X, S[:-1], 1 << 40), np.where(up == X, S[1:], 1 << 40))
        X = np.concatenate([[i * gap], X])
        SX = np.concatenate([[0], SX])
        run = np.minimum.accumulate((X - j * gap) * shift + SX)
        D = (run // shift) + j * gap
        S = run % shift
    end = int(np.argmin(D))
    cost = int(D[end])
    return cost, min(int(S[end]), end), end


def mapping_phase(args, torch, dev, timer, results, fa, genome, reads, true_starts, true_rev,
                  compare, timed):
    """Phase 7: short-read mapping of phase 6's genome and reads at the CLI
    defaults, K8 and K9 against their plain versions, and the checks."""
    from bitnuc_tpu_torch import config, io as bnio, kernels, mapper
    from bitnuc_tpu_torch.ops import align
    from bitnuc_tpu_torch.sequence import PackedReads

    ph = results["phases"]
    print(f"phase 7: short-read mapping (k = {MAP_K}, w = {MAP_W}, max_occ = {MAP_OCC}, "
          f"{len(reads)} reads x {reads.shape[1]} bp)", flush=True)
    _, contigs = bnio._split_records_fasta(bnio._read_bytes(fa))
    n_reads = reads.shape[0]
    lens_np = np.full(n_reads, reads.shape[1], np.int32)

    # -- the path, with the counters set to 0 just before it ---------------
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = mapper.MinimizerIndex.build_multi(contigs, k=MAP_K, w=MAP_W, max_occ=MAP_OCC,
                                              device=dev)
    torch.cuda.synchronize()
    ph["map_index_build_s"] = time.perf_counter() - t0
    packed = PackedReads.from_ascii(reads, lengths=lens_np, validate=False, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = mapper.map_reads(index, packed, min_seeds=MAP_MIN_SEEDS)
    torch.cuda.synchronize()
    ph["map_reads_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    tb = mapper.traceback_cigars(index, packed, res)
    torch.cuda.synchronize()
    ph["map_traceback_cigars_s"] = time.perf_counter() - t2
    # local rescoring of the first batch: each read in forward orientation
    # against a SW_WINDOW-bp window around its mapped start (K9)
    nb = min(mapper.MAP_BATCH, n_reads)
    fwd_ascii = reads[:nb].copy()
    minus = res["strand"][:nb] == b"-"
    comp = np.arange(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    fwd_ascii[minus] = comp[fwd_ascii[minus, ::-1]]
    w0 = np.clip(res["ref_start"][:nb].astype(np.int64) - (SW_WINDOW - reads.shape[1]) // 2,
                 0, len(genome) - SW_WINDOW)
    win_ascii = np.lib.stride_tricks.sliding_window_view(genome, SW_WINDOW)[w0]
    t3 = time.perf_counter()
    sw_a = PackedReads.from_ascii(fwd_ascii, lengths=lens_np[:nb], validate=False, device=dev)
    sw_b = PackedReads.from_ascii(win_ascii, validate=False, device=dev)
    sw = align.sw_score(sw_a.words, sw_a.lengths, sw_b.words, sw_b.lengths)
    torch.cuda.synchronize()
    ph["map_sw_rescore_s"] = time.perf_counter() - t3
    MAP_LAUNCHES.update(kernels.LAUNCHES)
    print(f"  launches {MAP_LAUNCHES}", flush=True)
    for name in ("pack", "fit_banded", "sw_score"):
        check(f"{name} launched on the mapping path", MAP_LAUNCHES[name] > 0,
              f"{MAP_LAUNCHES[name]} launches")
    ph["map_index_keys"] = len(index)
    e2e = ph["map_reads_s"] + ph["map_traceback_cigars_s"]
    ph["map_reads_per_s"] = n_reads / ph["map_reads_s"]
    ph["map_e2e_reads_per_s"] = n_reads / e2e
    print(f"  index build {ph['map_index_build_s']:.2f} s ({len(index)} keys); map_reads "
          f"{ph['map_reads_s']:.2f} s ({ph['map_reads_per_s']:.0f} reads/s); traceback + "
          f"CIGARs {ph['map_traceback_cigars_s']:.2f} s; map + CIGARs "
          f"{ph['map_e2e_reads_per_s']:.0f} reads/s end to end; SW rescoring of {nb} pairs "
          f"{ph['map_sw_rescore_s']:.2f} s", flush=True)

    # -- where a batch's time goes -----------------------------------------
    words_b, lens_b = packed.words[:nb], packed.lengths[:nb]
    ph["map_seed_join_vote_ms"] = timer(
        lambda: mapper._seed_vote(words_b, lens_b, index, mapper.BIN_BITS, mapper.PAD), 2)
    _, _, q_words, ws, win, wlen, off_lo, off_hi = mapper._fit_operands(
        words_b, lens_b, index, mapper.BIN_BITS, mapper.PAD)
    t = time.perf_counter()
    strings = align.cigars(tb["ops"])
    ph["map_cigar_strings_s"] = time.perf_counter() - t
    print(f"  per batch of {nb}: seeding + join + vote {ph['map_seed_join_vote_ms']:.1f} ms; "
          f"CIGAR strings of all reads {ph['map_cigar_strings_s']:.2f} s", flush=True)
    check("CIGAR strings are stable", [c if m else None for c, m in zip(strings, res["mapped"])]
          == tb["cigar"])
    del strings

    # -- K8 and K9 against their plain versions -------------------------------
    M, N = 16 * q_words.shape[1], 16 * win.shape[1]
    K, _ = align._band_geometry(off_lo, off_hi, N)
    label = f"[{nb}] M={M} N={N} K={K}"
    fit_args = (q_words.contiguous(), lens_b, win.contiguous(), wlen, 1, 1, off_lo, off_hi)
    got = align.fit_distance_span_banded_kernel(*fit_args)
    compare("fit_banded", label, got, align.fit_distance_span_banded_torch(*fit_args))
    cells = band_cells(torch, lens_b, wlen, off_lo, off_hi, M, N)
    timed("fit_banded", label, lambda: align.fit_distance_span_banded_kernel(*fit_args),
          lambda: align.fit_distance_span_banded_torch(*fit_args), reps=5, plain_reps=2,
          main=True, nbytes=4 * nb * (q_words.shape[1] + win.shape[1]) + 8 * nb + 12 * nb,
          ops_ms=cells * FIT_OPS_PER_CELL / INT32_OPS_PER_S * 1e3)
    ph["fit_banded_cells"] = cells
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 7)
    for B, Wa, Wb, band, costs, ties in (
            (40, 4, 8, (0, 0), (1, 1), False), (33, 2, 40, (-300, 700), (3, 2), False),
            (17, 0, 4, (-4, 4), (1, 1), False), (300, 10, 15, (-8, 52), (3, 2), False),
            (5, 10, 15, (off_lo, off_hi), (1, 1), False),
            (300, 10, 15, (-33, 125), (1, 1), False),  # odd off_lo: the runs' parities flip
            (300, 10, 15, (off_lo, off_hi), (1, 1), True),  # tie-heavy
            (9, 8, 100, (-1100, 1100), (1, 1), False)):  # K 1102: wide
        pa = random_pairs(torch, gen, dev, B, Wa, Wb, ties)
        compare("fit_banded", f"[{B}] Wa={Wa} Wb={Wb} band={band} costs={costs} ties={ties}",
                align.fit_distance_span_banded_kernel(*pa, *costs, *band),
                align.fit_distance_span_banded_torch(*pa, *costs, *band))

    sw_args = (sw_a.words, sw_a.lengths, sw_b.words, sw_b.lengths, 2, -3, -5, -2)
    Ma, Nb = 16 * sw_a.words.shape[1], 16 * sw_b.words.shape[1]
    label = f"[{nb}] M={Ma} N={Nb}"
    compare("sw_score", label, align.sw_score_kernel(*sw_args), align.sw_score_torch(*sw_args))
    cells = int((torch.clamp(sw_a.lengths.long(), max=Ma)
                 * torch.clamp(sw_b.lengths.long(), max=Nb)).sum())
    ph["sw_score_cells"] = cells
    timed("sw_score", label, lambda: align.sw_score_kernel(*sw_args),
          lambda: align.sw_score_torch(*sw_args), reps=5, plain_reps=2, main=True,
          nbytes=4 * nb * (sw_a.words.shape[1] + sw_b.words.shape[1]) + 8 * nb + 12 * nb,
          ops_ms=cells * SW_OPS_PER_CELL / INT32_OPS_PER_S * 1e3)
    for B, Wa, Wb, ties in ((20, 6, 0, False), (20, 0, 6, False), (7, 2, 62, False),
                            (50, 4, 4, False), (6, 3, 80, False),  # 1281 lanes: wide
                            (40, 2, 1, False),  # N + 1 = 17 lanes, one cell a lane
                            (300, 10, 14, True), (40, 2, 1, True)):  # tie-heavy
        pa = random_pairs(torch, gen, dev, B, Wa, Wb, ties)
        for params in ((2, -3, -5, -2), (1, -1, -2, -1)):
            compare("sw_score", f"[{B}] Wa={Wa} Wb={Wb} ties={ties} params={params}",
                    align.sw_score_kernel(*pa, *params), align.sw_score_torch(*pa, *params))

    # -- one batch under the plain backend ------------------------------------
    first = PackedReads(words=words_b, lengths=lens_b)
    res_k = {f: v[:nb] for f, v in res.items()}
    with config.backend("torch"):
        res_p = mapper.map_reads(index, first)
        tb_p = mapper.traceback_cigars(index, first, res_p)
    check("one batch under backend('torch') == default backend, every field",
          all(np.array_equal(res_k[f], res_p[f]) for f in res_k))
    check("... and every CIGAR", tb_p["cigar"] == tb["cigar"][:nb]
          and np.array_equal(tb_p["tb_cost"], tb["tb_cost"][:nb]))
    del res_p, tb_p

    # -- checks against the truth -------------------------------------------
    L = reads.shape[1]
    span = np.lib.stride_tricks.sliding_window_view(genome, L)[true_starts]
    clean_span = (span != ord("N")).all(1)
    strand_ok = (res["strand"] == b"-") == true_rev
    placed = res["mapped"] & strand_ok & (res["ref_start"] == true_starts)
    frac = placed[clean_span].mean()
    ph["map_placed_fraction"] = float(frac)
    check("reads with an N-free true span: >= 99% mapped on the true strand at the true start",
          frac >= 0.99, f"{frac * 100:.3f}% of {int(clean_span.sum())}")
    # Hamming distance of the read, in its mapped orientation, to its window
    codes = ascii_codes(reads)
    oriented = np.where(true_rev[:, None], 3 - codes[:, ::-1], codes)
    ham = (oriented != ascii_codes(span)).sum(1)
    sel = clean_span & placed
    cost = res["cost"]
    check("cost <= Hamming distance to the true window", bool((cost[sel] <= ham[sel]).all()),
          f"{int(sel.sum())} reads")
    eq = (cost[sel] == ham[sel]).mean()
    ph["map_cost_equals_hamming_fraction"] = float(eq)
    check("cost == Hamming distance for >= 99% of them", eq >= 0.99, f"{eq * 100:.3f}%")
    exact = (reads[:nb] == np.where(true_rev[:nb, None], comp[span[:nb, ::-1]], span[:nb])).all(1)
    sw_s = sw[0].cpu().numpy()
    check("planted reads with no substitution or N score 300 in sw_score",
          bool((sw_s[exact & placed[:nb]] == 2 * L).all()), f"{int((exact & placed[:nb]).sum())}"
          " reads")

    # -- checks on the CIGARs ----------------------------------------------
    mapped = res["mapped"]
    check("tb_cost == cost for every mapped read",
          bool((tb["tb_cost"][mapped] == cost[mapped]).all()), f"{int(mapped.sum())} reads")
    ops = tb["ops"][mapped]
    q_use = np.isin(ops, (align.OP_EQ, align.OP_X, align.OP_INS)).sum(1)
    r_use = np.isin(ops, (align.OP_EQ, align.OP_X, align.OP_DEL)).sum(1)
    check("query-consuming ops (=, X, I) sum to the read length",
          bool((q_use == lens_np[mapped]).all()))
    check("reference-consuming ops (=, X, D) sum to ref_end - ref_start",
          bool((r_use == (res["ref_end"] - res["ref_start"])[mapped]).all()))

    # -- a host oracle: full-DP fits of ORACLE_PAIRS reads into their windows -
    rows = np.flatnonzero(clean_span[:nb] & placed[:nb])[:ORACLE_PAIRS]
    qa = align._codes(q_words[rows], lens_b[rows], 4).cpu().numpy()
    wb_ = align._codes(win[rows], wlen[rows], 5).cpu().numpy()
    wl, ws_h = wlen[rows].cpu().numpy(), ws[rows].cpu().numpy().astype(np.int64)
    got_f = [(int(cost[r]), int(res["ref_start"][r]), int(res["ref_end"][r])) for r in rows]
    want_f = []
    for i, r in enumerate(rows):
        c, s0, e0 = fit_oracle(qa[i, : lens_np[r]], wb_[i, : wl[i]])
        want_f.append((c, int(ws_h[i] * 16 + s0), int(ws_h[i] * 16 + e0)))
    check(f"{len(rows)} fits == host full-DP oracle (cost, start, end)", got_f == want_f)
    return index


SEARCH_TOPK = 10
LITERAL_QUERIES = 8  # bitnuc-tpu search with a few sequences on the command line
QUERY_SUB_RATE = 0.05
FASTQ_DB_READS = 100_000
ORF_BATCH = 262_144
N_CONTIGS, CONTIG_BP = 50, 100_000
ORF_ORACLE_READS = 2_000
SEARCH_ORF_LAUNCHES = {}
_STOP_CODONS = (b"TAA", b"TAG", b"TGA")
_RC_TABLE = bytes.maketrans(b"ACGT", b"TGCA")
# the standard genetic code as a 64-letter string in TCAG order
_TCAG, _AA64 = "TCAG", "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def packed_bases(ascii_rows: np.ndarray) -> np.ndarray:
    """ASCII as the packer reads it: every byte outside ACGT (N) packs as A."""
    return np.frombuffer(b"ACGT", np.uint8)[ascii_codes(ascii_rows)]


def orf_oracle(seq: bytes):
    """(length, start, end, is_rc, stopped) of the longest ORF over six
    frames by a naive scan, with ops.orf's rules."""
    def one_strand(s):
        best = (0, 0, False)
        for p in range(len(s) - 2):
            if s[p : p + 3] != b"ATG":
                continue
            q = p
            while q + 3 <= len(s) and s[q : q + 3] not in _STOP_CODONS:
                q += 3
            stopped = q + 3 <= len(s)
            if q - p > best[0]:
                best = (q - p, p, stopped)
        return best

    lf, sf, stf = one_strand(seq)
    lr, sr, str_ = one_strand(seq[::-1].translate(_RC_TABLE))
    if lr > lf:
        return lr, len(seq) - sr - lr, len(seq) - sr, True, str_
    return lf, sf, sf + lf, False, stf


def translate_host(seq: bytes) -> bytes:
    return "".join(_AA64[_TCAG.index(chr(seq[p])) * 16 + _TCAG.index(chr(seq[p + 1])) * 4
                         + _TCAG.index(chr(seq[p + 2]))]
                   for p in range(0, len(seq) - 2, 3)).encode()


def hamming_host(db_host: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Distances [D] of one query's 512 bases to every entry of a host
    uint32 word-major database."""
    dist = np.zeros(db_host.shape[1], np.int64)
    for w in range(db_host.shape[0]):
        x = db_host[w] ^ q[w]
        x = (x | (x >> np.uint32(1))) & np.uint32(0x55555555)
        x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
        x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
        x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
        dist += (x * np.uint32(0x01010101)) >> np.uint32(24)
    return dist


def search_orf_path(torch, dev, tmp, db_wm, queries, reads, contigs, times):
    """Phase 8's path through the entry points a user calls; returns its
    outputs on the host and adds host-clock seconds to ``times``."""
    from bitnuc_tpu_torch.database import PackedDB
    from bitnuc_tpu_torch.ops import hamming, orf, revcomp, split
    from bitnuc_tpu_torch.sequence import PackedReads
    from bitnuc_tpu_torch.utils import bitops

    def clock(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[key] = times.get(key, 0.0) + time.perf_counter() - t
        return r

    out = {}
    db = PackedDB(words_wm=db_wm, n_bases=DB_BASES)
    d, i = clock("search_batch_s", lambda: db.search_batch(queries, SEARCH_TOPK))
    out["search_d"], out["search_i"] = d.cpu().numpy(), i.cpu().numpy()
    d, i = clock("search_literal_s", lambda: db.search_batch(queries[:LITERAL_QUERIES],
                                                             SEARCH_TOPK))
    out["literal_d"], out["literal_i"] = d.cpu().numpy(), i.cpu().numpy()
    # the public all-pairs call and its top-k: K6 (tc_scan) at 256 queries,
    # K5 at 8
    d, i = clock("distances_topk_s", lambda: hamming.topk_batch_dispatch(
        db.distances_batch(queries), SEARCH_TOPK, DB_BASES))
    out["two_step_d"], out["two_step_i"] = d.cpu().numpy(), i.cpu().numpy()
    out["literal_dists"] = clock("distances_literal_s", lambda: db.distances_batch(
        queries[:LITERAL_QUERIES])).cpu().numpy()
    fq_db = clock("from_fastq_s", lambda: PackedDB.from_fastq(
        os.path.join(tmp, "db.fq"), DB_BASES, device=dev))
    out["fastq_db_words"] = bitops.words_to_u32_np(fq_db.words_wm)
    del fq_db

    def orf_rows(key, rows):
        pr = PackedReads.from_ascii(rows, validate=False, device=dev)
        res = clock(key, lambda: orf.longest_orf(pr.words, pr.lengths))
        return pr, res

    fields = ("orf_len", "orf_start", "orf_end", "orf_rc", "orf_stopped")
    parts = []
    for b0 in range(0, len(reads), ORF_BATCH):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pr, res = orf_rows("longest_orf_reads_device_s", reads[b0 : b0 + ORF_BATCH])
        parts.append([x.cpu().numpy() for x in res])
        times["longest_orf_reads_s"] = times.get("longest_orf_reads_s", 0.0) + (
            time.perf_counter() - t)
        if b0 == 0:  # --translate: each ORF sliced from its own strand
            def translate(pr=pr, res=res):
                ln, s, e, isrc, _ = res
                rc = revcomp.reverse_complement_reads(pr.words, pr.lengths)
                w = torch.where(isrc[:, None], rc, pr.words)
                start = torch.where(isrc, pr.lengths - e, s)
                ow, olen = split.slice_reads(w, pr.lengths, start, ln)
                return orf.translate_reads(ow, olen)
            aa, n_aa = clock("translate_s", translate)
            out["aa"], out["n_aa"] = aa.cpu().numpy(), n_aa.cpu().numpy()
    for f, k in enumerate(fields):
        out[k] = np.concatenate([p[f] for p in parts])
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, res = orf_rows("longest_orf_contigs_device_s", contigs)
    for f, k in enumerate(fields):
        out["contig_" + k] = res[f].cpu().numpy()
    times["longest_orf_contigs_s"] = time.perf_counter() - t
    return out


def search_orf_phase(args, torch, dev, timer, results, tmp, db_wm, genome, reads):
    """Phase 8: many-query search (K6, and K5 for a few queries), a database
    built from FASTQ, and ORF calling on reads and contigs (K10), with the
    checks. Returns its queries and contigs for phase 9."""
    from bitnuc_tpu_torch import config, kernels
    from bitnuc_tpu_torch.database import PackedDB, SEARCH_TC_MIN_Q, tc_min_q
    from bitnuc_tpu_torch.ops import hamming, orf
    from bitnuc_tpu_torch.sequence import PackedReads
    from bitnuc_tpu_torch.utils import bitops

    ph = results["phases"]
    rng = np.random.default_rng(args.seed + 8)
    D = db_wm.shape[1]
    print(f"phase 8: many-query search ({SEARCH_QUERIES} queries, top {SEARCH_TOPK}, against "
          f"{D} x {DB_BASES} bases; tc_min_q = {tc_min_q(db_wm.shape[0])}, "
          f"SEARCH_TC_MIN_Q = {SEARCH_TC_MIN_Q}), "
          "from_fastq, ORFs", flush=True)
    # queries: database entries with QUERY_SUB_RATE of their bases changed
    src = rng.integers(0, D, SEARCH_QUERIES)
    q_host = bitops.words_to_u32_np(db_wm[:, torch.from_numpy(src).to(dev)].t())
    sub = (rng.random((SEARCH_QUERIES, DB_BASES)) < QUERY_SUB_RATE) * rng.integers(
        1, 4, (SEARCH_QUERIES, DB_BASES))
    shifts = (2 * np.arange(16, dtype=np.uint64))
    flips = (sub.reshape(SEARCH_QUERIES, -1, 16).astype(np.uint64) << shifts).sum(-1)
    q_host = q_host ^ flips.astype(np.uint32)
    queries = bitops.words_from_u32_np(q_host).to(dev)
    fq_seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (FASTQ_DB_READS, DB_BASES))]
    write_fastq(os.path.join(tmp, "db.fq"), fq_seqs)
    contigs = genome[: N_CONTIGS * CONTIG_BP].reshape(N_CONTIGS, CONTIG_BP)

    # -- the path, with the counters set to 0 just before it ---------------
    times = {}
    kernels.reset_launches()
    out = search_orf_path(torch, dev, tmp, db_wm, queries, reads, contigs, times)
    SEARCH_ORF_LAUNCHES.update(kernels.LAUNCHES)
    print(f"  launches {SEARCH_ORF_LAUNCHES}", flush=True)
    n_batches = -(-len(reads) // ORF_BATCH)
    for name in ("pack", "tc_search", "tc_scan", "hdist_scan_batch", "orf_scan"):
        check(f"{name} launched on the search and ORF path", SEARCH_ORF_LAUNCHES[name] > 0,
              f"{SEARCH_ORF_LAUNCHES[name]} launches")
    check("longest_orf launched K10 once a batch", SEARCH_ORF_LAUNCHES["orf_scan"]
          == n_batches + 1, f"{n_batches} read batches and one contig batch")
    ph.update({f"search_orf_{k}": v for k, v in times.items()})
    ph["search_batch_ms"] = timer(lambda: PackedDB(db_wm, DB_BASES).search_batch(
        queries, SEARCH_TOPK), 3)
    ph["search_queries_per_s"] = SEARCH_QUERIES / ph["search_batch_ms"] * 1e3
    ph["search_two_step_ms"] = timer(lambda: hamming.topk_batch_dispatch(
        PackedDB(db_wm, DB_BASES).distances_batch(queries), SEARCH_TOPK, DB_BASES), 3)
    check(f"fused search_batch of {SEARCH_QUERIES} at least 5x faster than distances_batch + "
          "topk_batch_dispatch", ph["search_two_step_ms"] >= 5 * ph["search_batch_ms"],
          f"{ph['search_batch_ms']:.3f} against {ph['search_two_step_ms']:.3f} ms")
    # where the time of a search and of an ORF batch goes: the fused route's
    # two stages, then the two-step route's as the yardstick
    cand = hamming.tc_search_candidates(queries, db_wm, DB_BASES, SEARCH_TOPK)
    dists = PackedDB(db_wm, DB_BASES).distances_batch(queries)
    first = PackedReads.from_ascii(reads[:ORF_BATCH], validate=False, device=dev)
    stages = {
        "search: fused K6 top-k (tc_search)": lambda: hamming.tc_search_candidates(
            queries, db_wm, DB_BASES, SEARCH_TOPK),
        "search: candidate merge (stage two)": lambda: hamming._merge_candidates(
            cand, SEARCH_TOPK, D),
        "search: distances_batch (K6)": lambda: PackedDB(db_wm, DB_BASES).distances_batch(
            queries),
        "search: top-k of [256, D]": lambda: hamming.topk_batch_dispatch(dists, SEARCH_TOPK,
                                                                         DB_BASES),
        "ORF batch: longest_orf": lambda: orf.longest_orf(first.words, first.lengths),
        "ORF batch: both strands (K10)": lambda: orf._best_orf_two_strands(first.words,
                                                                          first.lengths),
    }
    ph["search_orf_stages_ms"] = {}
    for label, fn in stages.items():
        ph["search_orf_stages_ms"][label] = timer(fn, 3)
        print(f"    stage {label}: {ph['search_orf_stages_ms'][label]:.3f} ms", flush=True)
    del dists, first, cand
    ph["longest_orf_reads_per_s"] = len(reads) / times["longest_orf_reads_s"]
    ph["longest_orf_read_bases_per_s"] = reads.size / times["longest_orf_reads_s"]
    ph["longest_orf_contig_bases_per_s"] = contigs.size / times["longest_orf_contigs_s"]
    print(f"  search_batch of {SEARCH_QUERIES}: {ph['search_batch_ms']:.3f} ms warm "
          f"({ph['search_queries_per_s']:.0f} queries/s; two-step route "
          f"{ph['search_two_step_ms']:.3f} ms; first call "
          f"{times['search_batch_s']:.3f} s), {LITERAL_QUERIES} queries "
          f"{times['search_literal_s']:.3f} s; from_fastq of {FASTQ_DB_READS} x {DB_BASES} "
          f"{times['from_fastq_s']:.2f} s; longest_orf of {len(reads)} reads "
          f"{times['longest_orf_reads_s']:.2f} s with upload and pack "
          f"({ph['longest_orf_reads_per_s']:.0f} reads/s, "
          f"{ph['longest_orf_read_bases_per_s'] / 1e6:.1f} Mbases/s; longest_orf alone "
          f"{times['longest_orf_reads_device_s']:.3f} s), of {N_CONTIGS} x {CONTIG_BP} bp "
          f"contigs {times['longest_orf_contigs_s']:.3f} s "
          f"({ph['longest_orf_contig_bases_per_s'] / 1e6:.1f} Mbases/s); --translate of the "
          f"first batch {times['translate_s']:.3f} s", flush=True)

    # -- checks ---------------------------------------------------------------
    with config.backend("torch"):
        plain = search_orf_path(torch, dev, tmp, db_wm, queries, reads, contigs, {})
    check("phase 8 under backend('torch') == default backend, every output",
          all(np.array_equal(out[k], plain[k]) for k in out), f"{len(out)} outputs")
    del plain
    check("every query's nearest entry is the entry it was made from",
          bool((out["search_i"][:, 0] == src).all()))
    check(f"the first {LITERAL_QUERIES} queries: search_batch of {LITERAL_QUERIES} == of "
          f"{SEARCH_QUERIES}",
          np.array_equal(out["literal_d"], out["search_d"][:LITERAL_QUERIES])
          and np.array_equal(out["literal_i"], out["search_i"][:LITERAL_QUERIES]))
    check("fused search_batch == distances_batch + topk_batch_dispatch",
          np.array_equal(out["two_step_d"], out["search_d"])
          and np.array_equal(out["two_step_i"], out["search_i"]))
    db_host = bitops.words_to_u32_np(db_wm)
    t = time.perf_counter()
    ok = True
    for r in range(LITERAL_QUERIES):
        dist = hamming_host(db_host, q_host[r])
        top = np.argsort(dist, kind="stable")[:SEARCH_TOPK]
        ok &= np.array_equal(out["search_i"][r], top) and np.array_equal(
            out["search_d"][r], dist[top]) and np.array_equal(out["literal_dists"][r], dist)
    check(f"{LITERAL_QUERIES} queries' top {SEARCH_TOPK} and distances_batch rows over all {D} "
          "entries == host numpy Hamming oracle", bool(ok), f"{time.perf_counter() - t:.1f} s")
    del db_host
    codes = ascii_codes(fq_seqs).astype(np.uint64).reshape(FASTQ_DB_READS, -1, 16)
    host_words = (codes << shifts).sum(-1).astype(np.uint32)
    want = bitops.words_to_u32_np(PackedDB.from_numpy(host_words.T.copy(), DB_BASES,
                                                      device=dev).words_wm)
    got = out["fastq_db_words"]
    detail = f"shape {got.shape} against {want.shape}"
    if got.shape == want.shape and not np.array_equal(got, want):
        bad_w, bad_e = np.nonzero(got != want)
        detail += (f"; {len(np.unique(bad_e))} entries differ, first word {bad_w[0]} of entry "
                   f"{bad_e[0]}: {got[bad_w[0], bad_e[0]]:#010x} against "
                   f"{want[bad_w[0], bad_e[0]]:#010x}")
    check("from_fastq == from_numpy of the host-packed words", np.array_equal(got, want), detail)
    del want, got, host_words, codes
    t = time.perf_counter()
    host_reads = packed_bases(reads[:ORF_ORACLE_READS])
    got = list(zip(*(out[k][:ORF_ORACLE_READS] for k in (
        "orf_len", "orf_start", "orf_end", "orf_rc", "orf_stopped"))))
    want = [orf_oracle(bytes(r)) for r in host_reads]
    check(f"longest_orf of {ORF_ORACLE_READS} reads == host six-frame oracle",
          [tuple(int(x) for x in g) for g in got] == [tuple(int(x) for x in w) for w in want])
    prot_ok = True
    for i, (ln, s, e, isrc, _) in enumerate(want):
        seq = bytes(host_reads[i])
        span = seq[::-1].translate(_RC_TABLE)[len(seq) - e : len(seq) - s] if isrc else seq[s:e]
        prot_ok &= out["aa"][i, : out["n_aa"][i]].tobytes() == translate_host(span)
        prot_ok &= int(out["n_aa"][i]) == ln // 3
    check(f"translated ORFs of {ORF_ORACLE_READS} reads == host codon table", bool(prot_ok))
    contig = packed_bases(contigs[:1])[0]
    got = tuple(int(out["contig_" + k][0]) for k in (
        "orf_len", "orf_start", "orf_end", "orf_rc", "orf_stopped"))
    want = tuple(int(x) for x in orf_oracle(bytes(contig)))
    check(f"longest_orf of a {CONTIG_BP}-bp contig == host six-frame oracle", got == want,
          f"{got}; oracles {time.perf_counter() - t:.1f} s")
    return queries, contigs


# -- phase 9: the public surface and pair merging ---------------------------------

MERGE_PAIRS = 262_144
MERGE_READ_LEN = 150
FRAG_MIN, FRAG_MAX = 160, 400  # overlaps from 140 bp down to none
MERGE_SUB_RATE = 0.01
MERGE_MIN_OVERLAP, MERGE_MAX_MISMATCH = 10, 0.1  # bitnuc-tpu merge's defaults
MERGE_SUBSET = 4_096  # pairs also merged on the CPU
MERGE_BATCH = 65_536  # records a batch of the streaming readers
TRUE_OVERLAP_MIN = 20  # pairs checked against their true fragments
GC_WINDOW, GC_STEPS = 1_000, (0, 100)
MERGE_LAUNCHES = {}
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def make_pairs(rng):
    """MERGE_PAIRS read pairs of MERGE_READ_LEN bp from random fragments of
    FRAG_MIN..FRAG_MAX bp, with MERGE_SUB_RATE substitutions in each read
    and no N; R2 is the reverse complement of the fragment's tail, as
    sequenced. Returns (R1 ASCII, R2 ASCII, fragments ASCII [n, FRAG_MAX],
    fragment lengths, and the substitution masks of R1 and of R2 read
    forward along the fragment)."""
    n, L = MERGE_PAIRS, MERGE_READ_LEN
    acgt = np.frombuffer(b"ACGT", np.uint8)
    frags = acgt[rng.integers(0, 4, (n, FRAG_MAX), dtype=np.uint8)]
    flen = rng.integers(FRAG_MIN, FRAG_MAX + 1, n).astype(np.int64)
    cols = np.arange(L)
    r1 = frags[:, :L].copy()
    r2f = np.take_along_axis(frags, flen[:, None] - L + cols[None, :], axis=1)
    subs = []
    for r in (r1, r2f):
        sub = rng.random((n, L)) < MERGE_SUB_RATE
        codes = ascii_codes(r)
        r[sub] = acgt[(codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4]
        subs.append(sub)
    frags[np.arange(FRAG_MAX)[None, :] >= flen[:, None]] = 0
    return r1, _COMP[r2f[:, ::-1]], frags, flen, subs[0], subs[1]


def merge_path(torch, dev, r1_path, r2_path, scan="packed"):
    """The bitnuc-tpu merge command's device path: read_fastq of both files
    (validate=False; K1), merge_pairs at the CLI defaults, decode_reads of
    the merged words (K2). Host outputs."""
    from bitnuc_tpu_torch import io
    from bitnuc_tpu_torch.ops import codec, merge_pairs

    _, p1 = io.read_fastq(r1_path, validate=False, device=dev)
    _, p2 = io.read_fastq(r2_path, validate=False, device=dev)
    w, ln, m, ov, mm = merge_pairs.merge_pairs(p1.words, p1.lengths, p2.words, p2.lengths,
                                               MERGE_MIN_OVERLAP, MERGE_MAX_MISMATCH, scan)
    ascii_m = codec.decode_reads(w, ln)
    out = {"words": w, "lens": ln, "merged": m, "overlap": ov, "mismatches": mm,
           "ascii": ascii_m}
    return {k: v.cpu().numpy() for k, v in out.items()}


def public_phase(args, torch, dev, timer, results, tmp, db_wm, queries, contigs, fq5):
    """Phase 9: the merge path (K1, merge_pairs, K2) on 262,144 pairs, the
    FASTQ readers and stats on R1, hdist_topk_batch beside search_batch on
    phase 8's database, windowed_gc of phase 8's contigs, with the
    checks."""
    import bitnuc_tpu_torch as bnt
    from bitnuc_tpu_torch import config, io, kernels, pipeline
    from bitnuc_tpu_torch.database import PackedDB
    from bitnuc_tpu_torch.ops import codec, hamming, merge_pairs, revcomp
    from bitnuc_tpu_torch.sequence import PackedReads, _rectangularize

    ph = results["phases"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 9)
    print(f"phase 9: public surface and pair merging ({MERGE_PAIRS} pairs of "
          f"{MERGE_READ_LEN} bp, fragments {FRAG_MIN}-{FRAG_MAX} bp)", flush=True)
    r1, r2, frags, flen, sub1, sub2 = make_pairs(rng)
    paths = {k: os.path.join(tmp, f"{k}.fq") for k in ("r1", "r2", "r1s", "r2s")}
    write_fastq(paths["r1"], r1)
    write_fastq(paths["r2"], r2)
    write_fastq(paths["r1s"], r1[:MERGE_SUBSET])
    write_fastq(paths["r2s"], r2[:MERGE_SUBSET])
    ph["merge_write_s"] = time.perf_counter() - t0

    # -- the path, with the counters set to 0 just before it ---------------
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = merge_path(torch, dev, paths["r1"], paths["r2"])
    ph["merge_path_s"] = time.perf_counter() - t
    db_rm = db_wm.t().contiguous()  # the row-major database a caller holds
    torch.cuda.synchronize()
    t = time.perf_counter()
    topk_d, topk_i = hamming.hdist_topk_batch(queries, db_rm, DB_BASES, SEARCH_TOPK)
    torch.cuda.synchronize()
    ph["hdist_topk_batch_first_s"] = time.perf_counter() - t
    MERGE_LAUNCHES.update(kernels.LAUNCHES)
    ph["merge_launches"] = dict(MERGE_LAUNCHES)
    print(f"  launches {MERGE_LAUNCHES}", flush=True)
    for name in ("pack", "unpack", "tc_search"):
        check(f"{name} launched on the merge and search path", MERGE_LAUNCHES[name] > 0,
              f"{MERGE_LAUNCHES[name]} launches")

    # -- where the merge path's time goes -----------------------------------
    t = time.perf_counter()
    _, seqs = io._split_records_fastq(io._read_bytes(paths["r1"]))
    ascii_h, lens_h = _rectangularize(seqs)
    ph["merge_framing_one_file_s"] = time.perf_counter() - t
    a_t, l_t = torch.from_numpy(ascii_h).to(dev), torch.from_numpy(lens_h).to(dev)
    _, p1 = io.read_fastq(paths["r1"], validate=False, device=dev)
    _, p2 = io.read_fastq(paths["r2"], validate=False, device=dev)
    rc2 = revcomp.reverse_complement_reads(p2.words, p2.lengths)
    mmf = torch.tensor(MERGE_MAX_MISMATCH, dtype=torch.float32, device=dev)
    full = merge_pairs.merge_pairs(p1.words, p1.lengths, p2.words, p2.lengths,
                                   MERGE_MIN_OVERLAP, MERGE_MAX_MISMATCH)
    stages = {
        "encode one file (K1)": lambda: codec.encode_reads(a_t, l_t),
        "reverse complement of R2": lambda: revcomp.reverse_complement_reads(p2.words,
                                                                              p2.lengths),
        "offset scan (packed)": lambda: merge_pairs._packed_offset_scan(
            p1.words, p1.lengths, rc2, p2.lengths, MERGE_MIN_OVERLAP, mmf),
        "merge_pairs (packed)": lambda: merge_pairs.merge_pairs(
            p1.words, p1.lengths, p2.words, p2.lengths, MERGE_MIN_OVERLAP, MERGE_MAX_MISMATCH),
        "merge_pairs (codes)": lambda: merge_pairs.merge_pairs(
            p1.words, p1.lengths, p2.words, p2.lengths, MERGE_MIN_OVERLAP, MERGE_MAX_MISMATCH,
            "codes"),
        "decode (K2)": lambda: codec.decode_reads(full[0], full[1]),
    }
    ph["merge_stages_ms"] = {}
    for label, fn in stages.items():
        ph["merge_stages_ms"][label] = timer(fn, 3)
    st = ph["merge_stages_ms"]
    st["fragment build (merge_pairs - reverse complement - scan)"] = (
        st["merge_pairs (packed)"] - st["reverse complement of R2"]
        - st["offset scan (packed)"])
    for label, ms in st.items():
        print(f"    stage {label}: {ms:.3f} ms ({MERGE_PAIRS / ms * 1e3:.0f} pairs/s)",
              flush=True)
    ph["merge_pairs_per_s"] = MERGE_PAIRS / ph["merge_path_s"]
    print(f"  merge path (two files framed, K1, merge_pairs, K2, download): "
          f"{ph['merge_path_s']:.3f} s ({ph['merge_pairs_per_s']:.0f} pairs/s; framing one "
          f"file {ph['merge_framing_one_file_s']:.3f} s); {int(out['merged'].sum())} merged",
          flush=True)
    del a_t, l_t, rc2, full

    # -- checks on the merge path --------------------------------------------
    codes_out = merge_path(torch, dev, paths["r1"], paths["r2"], scan="codes")
    check("merge_pairs 'packed' == 'codes' on the card, every output",
          all(np.array_equal(out[k], codes_out[k]) for k in out))
    del codes_out
    with config.backend("torch"):
        plain = merge_path(torch, dev, paths["r1"], paths["r2"])
    check("merge path under backend('torch') == default backend, every output",
          all(np.array_equal(out[k], plain[k]) for k in out))
    del plain
    cpu = merge_path(torch, torch.device("cpu"), paths["r1s"], paths["r2s"])
    check(f"{MERGE_SUBSET}-pair subset on the CPU == the card's first {MERGE_SUBSET} rows",
          all(np.array_equal(cpu[k], out[k][:MERGE_SUBSET]) for k in out))
    true_ov = 2 * MERGE_READ_LEN - flen
    cols = np.arange(out["ascii"].shape[1])[None, :]
    # the overlap is fragment bases [flen - 150, 150): R1's columns from
    # flen - 150 on, and R2's (read forward) before 300 - flen
    read_cols = cols[:, :MERGE_READ_LEN]
    clean_ov = ~(sub1 & (read_cols >= (flen - MERGE_READ_LEN)[:, None])).any(1) & ~(
        sub2 & (read_cols < true_ov[:, None])).any(1)
    sel = (true_ov >= TRUE_OVERLAP_MIN) & clean_ov
    ok_len = out["merged"][sel].all() and np.array_equal(out["lens"][sel], flen[sel]) and (
        np.array_equal(out["overlap"][sel], true_ov[sel])) and not out["mismatches"][sel].any()
    check(f"{int(sel.sum())} pairs with a true overlap >= {TRUE_OVERLAP_MIN} bp free of "
          "substitutions merge at their true length and overlap, 0 mismatches", bool(ok_len))
    # their fragments: R1, then R2's bases past R1 read forward
    r2f = _COMP[r2[:, ::-1]]
    src = np.clip(cols - (flen - MERGE_READ_LEN)[:, None], 0, MERGE_READ_LEN - 1)
    obs = np.where(cols < MERGE_READ_LEN, np.pad(r1, ((0, 0), (0, cols.shape[1] - 150))),
                   np.take_along_axis(r2f, src, axis=1))
    inside = cols < flen[:, None]
    ok_obs = np.array_equal(np.where(inside, out["ascii"], 0)[sel], np.where(inside, obs, 0)[sel])
    clean = sel & ~sub1.any(1) & ~sub2.any(1)
    width = min(cols.shape[1], FRAG_MAX)
    ok_true = np.array_equal(np.where(inside, out["ascii"], 0)[clean][:, :width],
                             frags[clean][:, :width])
    check("those pairs decode to R1 and R2's bases past it, and the "
          f"{int(clean.sum())} without any substitution to their true fragments",
          bool(ok_obs and ok_true))
    del r2f, src, obs, inside

    # -- the FASTQ readers and stats on R1 ------------------------------------
    t = time.perf_counter()
    want_w, want_l = PackedReads.from_ascii(r1, device=dev).to_numpy()
    _, rf = io.read_fastq(paths["r1"], device=dev)
    fast = io.read_fastq_fast(paths["r1"], device=dev)
    asc = list(io.iter_fastq_ascii_batches(paths["r1"], MERGE_BATCH))
    rec = list(io.iter_fastq_record_batches(paths["r1"], MERGE_BATCH))
    ph["readers_s"] = time.perf_counter() - t
    rf_w, rf_l = rf.to_numpy()
    check("read_fastq == host-packed R1", np.array_equal(rf_w, want_w)
          and np.array_equal(rf_l, want_l))
    fw, fl = fast.to_numpy()
    check("read_fastq_fast == read_fastq, words and lengths", np.array_equal(fw, rf_w)
          and np.array_equal(fl, rf_l))
    aw, al = PackedReads.from_ascii(np.concatenate([a for a, _, _ in asc]),
                                    np.concatenate([n for _, n, _ in asc]), device=dev).to_numpy()
    check("iter_fastq_ascii_batches == read_fastq, words and lengths",
          np.array_equal(aw, rf_w) and np.array_equal(al, rf_l)
          and asc[-1][2] == os.path.getsize(paths["r1"]))
    qw, ql = PackedReads.from_ascii(np.concatenate([b[1] for b in rec]),
                                    np.concatenate([b[3] for b in rec]), device=dev).to_numpy()
    names_ok = all(raw[o : o + n] == b"r%09d" % (MERGE_BATCH * i + j)
                   for i, (raw, *_, off, nl) in enumerate(rec)
                   for j, (o, n) in enumerate(zip(off[:3].tolist(), nl[:3].tolist())))
    check("iter_fastq_record_batches == read_fastq, qualities all 'I', names past '@'",
          np.array_equal(qw, rf_w) and np.array_equal(ql, rf_l) and names_ok
          and all((b[2] == ord("I")).all() for b in rec))
    del asc, rec, rf, fast
    t = time.perf_counter()
    got = pipeline.stats(paths["r1"], device=dev)
    ph["stats_s"] = time.perf_counter() - t
    counts = np.bincount(ascii_codes(r1).reshape(-1), minlength=4)
    n_bases = r1.size
    want = {"reads": MERGE_PAIRS, "bases": n_bases, "a": int(counts[0]), "c": int(counts[1]),
            "g": int(counts[2]), "t": int(counts[3]),
            "gc_pct": round(int(counts[1] + counts[2]) / n_bases * 100.0, 4),
            "min_len": MERGE_READ_LEN, "max_len": MERGE_READ_LEN,
            "mean_len": float(MERGE_READ_LEN), "n50": MERGE_READ_LEN,
            "l50": -(-((n_bases + 1) // 2) // MERGE_READ_LEN)}
    check("stats(R1) == host numpy counts", got == want, f"{got}")
    try:
        pipeline.stats(fq5, device=dev)
        check("stats(validate=True) of phase 5's FASTQ raises InvalidBase", False)
    except bnt.InvalidBase:
        check("stats(validate=True) of phase 5's FASTQ raises InvalidBase", True)

    # -- hdist_topk_batch beside search_batch ----------------------------------
    db = PackedDB(db_wm, DB_BASES)
    sd, si = db.search_batch(queries, SEARCH_TOPK)
    check(f"hdist_topk_batch of {len(queries)} queries, top {SEARCH_TOPK} == "
          "PackedDB.search_batch", torch.equal(topk_d, sd) and torch.equal(topk_i, si))
    ph["hdist_topk_batch_ms"] = timer(lambda: hamming.hdist_topk_batch(
        queries, db_rm, DB_BASES, SEARCH_TOPK), 3)
    ph["hdist_topk_batch_wm_view_ms"] = timer(lambda: hamming.hdist_topk_batch(
        queries, db_wm.t(), DB_BASES, SEARCH_TOPK), 3)
    ph["search_batch_beside_topk_ms"] = timer(lambda: db.search_batch(queries, SEARCH_TOPK), 3)
    print(f"  hdist_topk_batch of {len(queries)} queries against {db_wm.shape[1]} x {DB_BASES} "
          f"bases: {ph['hdist_topk_batch_ms']:.3f} ms from a row-major database (its "
          f"transpose included), {ph['hdist_topk_batch_wm_view_ms']:.3f} ms from a transposed "
          f"view; search_batch {ph['search_batch_beside_topk_ms']:.3f} ms", flush=True)
    del db_rm, topk_d, topk_i, sd, si

    # -- windowed GC of phase 8's contigs against a numpy float32 model ------------
    pr = PackedReads.from_ascii(contigs, validate=False, device=dev)
    gc_codes = ascii_codes(contigs)
    csum = np.concatenate([np.zeros((len(contigs), 1), np.int64),
                           np.cumsum((gc_codes == 1) | (gc_codes == 2), axis=1)], axis=1)
    ok = True
    for step in GC_STEPS:
        pct, valid = bnt.windowed_gc(pr.words, pr.lengths, GC_WINDOW, step)
        stride = step or GC_WINDOW
        starts = np.arange(0, 16 * pr.n_words - GC_WINDOW + 1, stride)
        sums = csum[:, starts + GC_WINDOW] - csum[:, starts]
        model = sums.astype(np.float32) * np.float32(100.0 / GC_WINDOW)
        ok &= np.array_equal(pct.cpu().numpy(), model) and bool(valid.all())
        ph[f"windowed_gc_step{step}_ms"] = timer(
            lambda step=step: bnt.windowed_gc(pr.words, pr.lengths, GC_WINDOW, step), 3)
    check(f"windowed_gc of {len(contigs)} x {contigs.shape[1]} bp at window {GC_WINDOW}, steps "
          f"{GC_STEPS} == numpy float32 model, bit for bit", bool(ok))
    del pr

    # -- the host API tier on a read ------------------------------------------------
    s = r1[0].tobytes()
    ps = bnt.PackedSequence(s)
    check("PackedSequence of a read == its words and bases",
          ps.to_vec() == s and np.array_equal(ps.data, bnt.encode(s))
          and bnt.decode(bnt.encode(s), len(s)) == s
          and PackedReads.from_ascii([s], device=dev)[0] == ps)
    ph["phase9_s"] = time.perf_counter() - t0
    print(f"  phase 9 in {ph['phase9_s']:.1f} s (inputs written in {ph['merge_write_s']:.1f} s, "
          f"readers {ph['readers_s']:.2f} s, stats {ph['stats_s']:.2f} s)", flush=True)


# -- phase 10: long reads, pairs, calls and sketches --------------------------------

LONG_READS = 8_192
LONG_MIN, LONG_MAX = 1_000, 10_000
LONG_SUB, LONG_INS, LONG_DEL = 0.01, 0.005, 0.005
LONG_MIN_CHAIN = MAP_MIN_SEEDS  # bitnuc-tpu map --long passes --min-seeds as min_chain
LONG_TOL = 100  # bp between a chain's ends and the true span's
LONG_SUBBATCH = 256  # the shortest reads, also run under the plain backend
LONG_CPU_READS = 64  # reads of 1,000-2,000 bp also mapped on the CPU
LONG_EXTEND_READS = 1_024  # reads of 1,000-3,000 bp mapped with extend=True
LONG_ORACLE = 16  # of them, fits held to fit_oracle
PAIRS = 262_144
PAIR_LEN = 150
PAIR_FRAG_MIN, PAIR_FRAG_MAX = 200, 800
PAIR_SUB = 0.001
CALL_BP = 1_000_000
CALL_SNPS = 1_000
CALL_INDELS = 100
CALL_READS = 200_000
CALL_LEN = 150
CALL_SUB = 0.001
CALL_NEAR = 150  # SNP checks skip sites this close to a planted indel
SKETCH_READS = 262_144
SKETCH_W = 10
SKETCH_K, SKETCH_K64 = 15, 21
# C1 counted as the function needs it, a slot a step: the two differences
# (2), the five tests of a predecessor (5), the drift and its penalty (2),
# the candidate and its select (2) and the running max (2): 13. The four
# tie-breaking maxima of a step that extends its chain, and the sort of the
# live anchors, are left out, so the bound stays below the work. A step i
# of a row compares min(i, LB) filled slots, over the row's live anchors.
# Its bytes: every valid flag, and the two coordinates of each valid anchor
# (nothing else decides the result), read once; 20 bytes a row written.
CHAIN_OPS_PER_SLOT = 13
LONG_LAUNCHES = {}


def comp_table() -> np.ndarray:
    comp = np.arange(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)
    return comp


def make_long_reads(rng, genome: np.ndarray, n: int):
    """n reads of LONG_MIN-LONG_MAX bp (uniform) from both strands with
    LONG_SUB substitutions and LONG_INS / LONG_DEL one-base insertions and
    deletions: (list of ASCII reads, true forward starts, true span lengths,
    reverse flags)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = comp_table()
    spans = rng.integers(LONG_MIN, LONG_MAX + 1, n)
    starts = rng.integers(0, len(genome) - spans)
    rev = rng.random(n) < 0.5
    reads = []
    for s, m, r in zip(starts.tolist(), spans.tolist(), rev.tolist()):
        src = genome[s : s + m].copy()
        u = rng.random(m)
        sub = u < LONG_SUB
        src[sub] = acgt[(np.searchsorted(acgt, src[sub]) + rng.integers(1, 4, int(sub.sum()))) % 4]
        dele = (u >= LONG_SUB) & (u < LONG_SUB + LONG_DEL)
        ins = (u >= LONG_SUB + LONG_DEL) & (u < LONG_SUB + LONG_DEL + LONG_INS)
        rep = np.where(dele, 0, np.where(ins, 2, 1))
        out = np.repeat(src, rep)
        out[np.cumsum(rep)[ins] - 1] = acgt[rng.integers(0, 4, int(ins.sum()))]
        reads.append((comp[out[::-1]] if r else out).tobytes())
    return reads, starts, spans, rev


def write_fastq_records(path: str, seqs) -> None:
    """Variable-length records @l<i>, the sequence, '+', all-'I' qualities."""
    with open(path, "wb") as f:
        f.write(b"".join(b"@l%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)) for i, s in enumerate(seqs)))


def long_anchors(torch, mapper, index, words, lengths):
    """The anchors that map_reads_long chains for a batch, as it hands them
    to chain_anchors: (rpos, qpos, valid) [2B, A], both strands, unsorted."""
    from bitnuc_tpu_torch.ops import revcomp

    lengths = lengths.to(torch.int32)
    rc = revcomp.reverse_complement_reads(words, lengths)
    cand, qp, hit = mapper._seed_anchors(torch.cat([words, rc]), torch.cat([lengths, lengths]),
                                         index.keys, index.keys_hi, index.pos, index.k, index.w)
    M = cand.shape[1] * cand.shape[2]
    rpos = torch.where(hit, cand, -1).reshape(-1, M)
    qpos = qp[:, :, None].expand(cand.shape).reshape(-1, M)
    return rpos, qpos, rpos >= 0


def chain_work(torch, rpos, valid, lookback: int):
    """(live anchors of each row [B], slot comparisons, bytes) of C1: step i
    of a row compares min(i, LB) filled slots over its live anchors (valid
    and r < 2^30); it reads every valid flag and the two coordinates of each
    valid anchor, and writes 5 ints a row."""
    from bitnuc_tpu_torch.ops import chain

    LB = min(lookback, rpos.shape[1])
    n = (valid & (rpos < chain._BIG)).sum(1).to(torch.int64)
    head = torch.clamp(n, max=LB)
    slots = head * (head - 1) // 2 + torch.clamp(n - LB, min=0) * LB
    nbytes = valid.numel() + 8 * int(valid.sum()) + 20 * rpos.shape[0]
    return n, int(slots.sum()), nbytes


def chain_bound_ms(nbytes: int, slots: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, slots * CHAIN_OPS_PER_SLOT / INT32_OPS_PER_S) * 1e3


def plant_variants(rng, ref: np.ndarray):
    """CALL_SNPS SNPs and CALL_INDELS indels of 1-8 bp (half deletions, half
    insertions) in ref, clear of N runs and 30 bp apart, each indel with a
    unique placement (no equal-cost shift: a deletion of ref[p:p+n] needs
    ref[p] != ref[p+n] and ref[p-1] != ref[p+n-1]; an insertion S before p
    needs S[0] != ref[p] and S[-1] != ref[p-1]). Returns (donor, snps {pos:
    alt code}, dels {pos: len}, ins {pos: bytes})."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n = len(ref)
    sites = set()
    snps, dels, ins = {}, {}, {}
    bad = ~np.isin(ref, acgt)
    near_n = np.convolve(bad, np.ones(41), "same") > 0  # within 20 bp of an N

    def free(p):
        return 40 <= p < n - 40 and not near_n[p] and all(abs(p - q) >= 30 for q in sites)

    while len(dels) + len(ins) < CALL_INDELS:
        p = int(rng.integers(40, n - 40))
        if not free(p):
            continue
        L = int(rng.integers(1, 9))
        if len(dels) < CALL_INDELS // 2:
            if ref[p] == ref[p + L] or ref[p - 1] == ref[p + L - 1]:
                continue
            dels[p] = L
        else:
            s = acgt[rng.integers(0, 4, L)]
            if s[0] == ref[p] or s[-1] == ref[p - 1]:
                continue
            ins[p] = s.tobytes()
        sites.add(p)
    while len(snps) < CALL_SNPS:
        p = int(rng.integers(40, n - 40))
        if not free(p):
            continue
        code = int(np.searchsorted(acgt, ref[p]))
        snps[p] = (code + int(rng.integers(1, 4))) % 4
        sites.add(p)
    pieces, last = [], 0
    for p in sorted(sites):
        pieces.append(ref[last:p].tobytes())
        if p in snps:
            pieces.append(acgt[snps[p] : snps[p] + 1].tobytes())
            last = p + 1
        elif p in dels:
            last = p + dels[p]
        else:
            pieces.append(ins[p])
            last = p
    pieces.append(ref[last:].tobytes())
    return np.frombuffer(b"".join(pieces), np.uint8), snps, dels, ins


def donor_reads(rng, donor: np.ndarray, n: int, L: int, sub: float) -> np.ndarray:
    """n reads of L bp from uniform donor positions on both strands with
    ``sub`` substitutions: ASCII [n, L]."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, len(donor) - L + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(donor, L)[starts].copy()
    rev = rng.random(n) < 0.5
    reads[rev] = comp_table()[reads[rev, ::-1]]
    hits = (rng.random(reads.shape) < sub) & np.isin(reads, acgt)
    codes = np.searchsorted(acgt, reads[hits])
    reads[hits] = acgt[(codes + rng.integers(1, 4, codes.size)) % 4]
    return reads


def host_minimizer_set(codes_rows, k: int, w: int) -> np.ndarray:
    """The distinct (w,k)-minimizer keys (uint64, ascending) of equal-length
    code rows [n, L] by numpy: every window of w consecutive k-mer keys
    that ends inside a row, its minimum."""
    n, L = codes_rows.shape
    nk = L - k + 1
    keys = np.zeros((n, nk), np.uint64)
    for j in range(k):
        keys |= codes_rows[:, j : j + nk].astype(np.uint64) << np.uint64(2 * j)
    mins = np.lib.stride_tricks.sliding_window_view(keys, w, axis=1).min(-1)
    return np.unique(mins)


def long_calls_phase(args, torch, dev, timer, results, fa, genome, reads_g, index, compare,
                     timed):
    """Phase 10: long reads (map_reads_long, C1 chain), read pairs
    (map_pairs), variant calls (call_variants, both modes) and sketches,
    with the checks."""
    import bitnuc_tpu_torch as bnt
    from bitnuc_tpu_torch import config, io as bnio, kernels, mapper
    from bitnuc_tpu_torch.ops import align, chain, kmer, pileup
    from bitnuc_tpu_torch.sequence import PackedReads
    from bitnuc_tpu_torch.utils import bitops

    ph = results["phases"]
    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 10)
    k = index.k
    print(f"phase 10: long reads, pairs, calls and sketches (index k = {k}, w = {index.w}, "
          f"max_occ = {index.max_occ})", flush=True)

    # -- long reads: the path, with the counters set to 0 just before it -----
    t = time.perf_counter()
    long_reads, l_start, l_span, l_rev = make_long_reads(rng, genome, LONG_READS)
    lq_path = os.path.join(os.path.dirname(fa), "long.fq")
    write_fastq_records(lq_path, long_reads)
    ph["long_write_s"] = time.perf_counter() - t
    long_kw = dict(min_chain=LONG_MIN_CHAIN, max_gap=2048, gap_unit=16, lookback=64)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed = bnio.read_fastq_fast(lq_path, validate=False, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = mapper.map_reads_long(index, packed, **long_kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    LONG_LAUNCHES.update(kernels.LAUNCHES)
    for name in ("pack", "chain"):
        check(f"{name} launched on the long-read path", LONG_LAUNCHES[name] > 0,
              f"{LONG_LAUNCHES[name]} launches")
    lens = packed.lengths.cpu().numpy()
    bases = int(lens.sum())
    W = packed.words.shape[1]
    chunk = mapper._long_chunk(W, index, False, 32)
    ph.update(long_read_s=t1 - t0, long_map_s=t2 - t1, long_reads_per_s=LONG_READS / (t2 - t1),
              long_bases_per_s=bases / (t2 - t1), long_chunk=chunk)
    print(f"  {LONG_READS} reads, {bases} bases, W = {W}; read_fastq_fast {t1 - t0:.2f} s; "
          f"map_reads_long {t2 - t1:.2f} s ({ph['long_reads_per_s']:.0f} reads/s, "
          f"{ph['long_bases_per_s']:.0f} bases/s) in chunks of {chunk}; launches "
          f"{LONG_LAUNCHES}", flush=True)
    check("read_fastq_fast gives every long read", lens.tolist() == [len(r) for r in long_reads])
    span = [genome[s : s + m] for s, m in zip(l_start.tolist(), l_span.tolist())]
    clean = np.array([(x != ord("N")).all() for x in span])
    ok = (res["mapped"] & ((res["strand"] == b"-") == l_rev)
          & (np.abs(res["ref_start"] - l_start) <= LONG_TOL)
          & (np.abs(res["ref_end"] + k - (l_start + l_span)) <= LONG_TOL))
    frac = ok[clean].mean()
    ph["long_placed_fraction"] = float(frac)
    check(f"reads clear of N runs: >= 99% mapped on the true strand, both ends within "
          f"{LONG_TOL} bp", frac >= 0.99, f"{frac * 100:.3f}% of {int(clean.sum())}")

    # -- the shortest reads under the plain backend; a CPU run -----------------
    order = np.argsort(lens, kind="stable")
    sub = torch.from_numpy(np.sort(order[:LONG_SUBBATCH])).to(dev)
    sub_reads = PackedReads(words=packed.words[sub], lengths=packed.lengths[sub])
    t = time.perf_counter()
    with config.backend("torch"):
        res_p = mapper.map_reads_long(index, sub_reads, **long_kw)
    ph["long_plain_subbatch_s"] = time.perf_counter() - t
    rows = sub.cpu().numpy()
    check(f"the {LONG_SUBBATCH} shortest reads under backend('torch') == default backend, "
          "every field", all(np.array_equal(res_p[f], res[f][rows]) for f in res))
    mid = np.flatnonzero((lens >= 1000) & (lens <= 2000))[:LONG_CPU_READS]
    Wm = bitops.n_words_for(int(lens[mid].max()))
    mid_t = torch.from_numpy(mid).to(dev)
    mid_reads = PackedReads(words=packed.words[mid_t, :Wm].contiguous(),
                            lengths=packed.lengths[mid_t])
    cpu_index = mapper.MinimizerIndex(
        index.keys, index.pos, index.nocc, index.ref_words, index.ref_len, index.k, index.w,
        index.max_occ, index.contig_starts, keys_hi=index.keys_hi, device="cpu")
    got = mapper.map_reads_long(index, mid_reads, **long_kw)
    want = mapper.map_reads_long(cpu_index, PackedReads(words=mid_reads.words.cpu(),
                                                        lengths=mid_reads.lengths.cpu()),
                                 **long_kw)
    check(f"{len(mid)} reads of 1,000-2,000 bp on the card == a CPU run, every field",
          all(np.array_equal(got[f], want[f]) for f in want))

    # -- extend=True on reads of 1,000-3,000 bp --------------------------------
    ext = np.flatnonzero((lens >= 1000) & (lens <= 3000))[:LONG_EXTEND_READS]
    We = bitops.n_words_for(int(lens[ext].max()))
    ext_t = torch.from_numpy(ext).to(dev)
    ext_reads = PackedReads(words=packed.words[ext_t, :We].contiguous(),
                            lengths=packed.lengths[ext_t])
    ext_bases = int(lens[ext].sum())
    torch.cuda.synchronize()
    t = time.perf_counter()
    chained = mapper.map_reads_long(index, ext_reads, **long_kw)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t
    t = time.perf_counter()
    extended = mapper.map_reads_long(index, ext_reads, extend=True, **long_kw)
    torch.cuda.synchronize()
    t_ext = time.perf_counter() - t
    ph.update(long_ext_reads=len(ext), long_ext_chain_reads_per_s=len(ext) / t_chain,
              long_ext_chain_bases_per_s=ext_bases / t_chain,
              long_ext_reads_per_s=len(ext) / t_ext, long_ext_bases_per_s=ext_bases / t_ext)
    print(f"  {len(ext)} reads of 1,000-3,000 bp (W = {We}): without extend {t_chain:.3f} s "
          f"({len(ext) / t_chain:.0f} reads/s, {ext_bases / t_chain:.0f} bases/s); with extend "
          f"{t_ext:.3f} s ({len(ext) / t_ext:.0f} reads/s, {ext_bases / t_ext:.0f} bases/s)",
          flush=True)
    check("extend=True keeps the chains (score, strand, query span)",
          all(np.array_equal(extended[f], chained[f])
              for f in ("mapped", "strand", "q_start", "q_end", "chain_score")))
    # the oracle: each read in its chosen orientation into _map_long_core's window
    Lb = We * 16
    Wwin = (Lb + Lb // 4 + 64) // 16 + 1
    pick = np.flatnonzero(chained["mapped"])[:LONG_ORACLE]
    ref_codes = ascii_codes(genome)
    got_f, want_f = [], []
    for i in pick.tolist():
        a = ascii_codes(np.frombuffer(long_reads[ext[i]], np.uint8))  # N packs as A
        if extended["strand"][i] == b"-":
            a = 3 - a[::-1]
        ws = max(int(chained["ref_start"][i]) - 32, 0) // 16
        wlen = min(max(index.ref_len - ws * 16, 0), Wwin * 16)
        c, s0, e0 = fit_oracle(a, ref_codes[ws * 16 : ws * 16 + wlen])
        want_f.append((c, ws * 16 + s0, ws * 16 + e0))
        got_f.append(tuple(int(extended[f][i]) for f in ("cost", "ref_start", "ref_end")))
    bad = [(i, g, w_) for i, g, w_ in zip(pick.tolist(), got_f, want_f) if g != w_]
    check(f"{len(pick)} extended fits == host full-DP oracle (cost, start, end)",
          len(pick) == LONG_ORACLE and not bad, f"differing (row, got, want): {bad[:4]}")

    # -- C1 against its plain version; the stages of a chunk --------------------
    chain_kw = (2048, 16, 64)
    anchors = long_anchors(torch, mapper, index, sub_reads.words, sub_reads.lengths)
    label = (f"[{anchors[0].shape[0]}, {anchors[0].shape[1]}] the {LONG_SUBBATCH} shortest "
             "reads' anchors")
    compare("chain", label, chain.chain_anchors(*anchors, *chain_kw),
            chain.chain_anchors_torch(*anchors, *chain_kw))
    del anchors
    w_c, l_c = packed.words[:chunk], packed.lengths[:chunk]
    l32 = l_c.to(torch.int32)
    both_c = torch.cat([w_c, bnt.reverse_complement_reads(w_c, l32)])
    l2 = torch.cat([l32, l32])
    ph["long_seed_join_ms"] = timer(lambda: mapper._seed_anchors(
        both_c, l2, index.keys, index.keys_hi, index.pos, index.k, index.w), 2)
    del both_c
    anchors = long_anchors(torch, mapper, index, w_c, l_c)
    B_c, A = anchors[0].shape
    ph["long_sort_ms"] = timer(lambda: chain.sort_anchors(*anchors), 2)  # the earlier route's
    r_big = torch.where(anchors[2], anchors[0], chain._BIG).to(torch.int64)
    key_c = r_big * (1 << 32) + (torch.where(anchors[2], anchors[1], chain._BIG).to(torch.int64)
                                 + (1 << 31))
    del r_big
    live_rows, slots, nbytes = chain_work(torch, anchors[0], anchors[2], 64)
    live = int(live_rows.sum())
    n_max, n_med = int(live_rows.max()), int(live_rows.median())
    label = f"[{B_c}, {A}] a chunk of {chunk} reads, {live} live anchors"
    compare("chain", label, chain.chain_anchors(*anchors, *chain_kw),
            chain.chain_anchors_torch(*anchors, *chain_kw))
    row = timed("chain", label, lambda: chain.chain_anchors(*anchors, *chain_kw),
                lambda: chain.chain_anchors_torch(*anchors, *chain_kw), reps=5, plain_reps=1,
                main=True, nbytes=nbytes,
                ops_ms=chain_bound_ms(0, slots), library=lambda: torch.sort(key_c, dim=-1))
    del key_c
    full_ms = 9 * B_c * A / HBM_BYTES_PER_S * 1e3
    ph.update(long_anchors_a_row=A, long_live_anchors=live, long_chain_slots=slots,
              long_live_max=n_max, long_live_median=n_med, long_chain_bytes=nbytes,
              long_chain_step_ns=row["ms"] / max(n_max, 1) * 1e6, long_full_read_ms=full_ms)
    print(f"    chain: live anchors a row, largest {n_max}, median {n_med}; "
          f"{ph['long_chain_step_ns']:.1f} ns a step of the longest row; {nbytes} bytes "
          f"needed ({9 * B_c * A} to read every input whole: {full_ms:.4f} ms)", flush=True)
    del anchors
    # the unbanded extension fit of the extend batch (plain PyTorch: no kernel)
    use_rc = torch.from_numpy(chained["strand"] == b"-").to(dev)
    l_e = ext_reads.lengths.to(torch.int32)
    q_words = torch.where(use_rc[:, None], bnt.reverse_complement_reads(ext_reads.words, l_e),
                          ext_reads.words)
    ws_t = torch.div(torch.clamp(torch.from_numpy(chained["ref_start"]).to(dev) - 32, min=0),
                     16, rounding_mode="floor")
    win, wlen = mapper._windows(ws_t, index.ref_words, index.ref_len, Wwin)
    ph["long_unbanded_fit_ms"] = timer(
        lambda: align.fit_distance_span(q_words, l_e, win, wlen, 1, 1), 1)
    del q_words, win, wlen
    print(f"  a chunk of {chunk} reads: A = {A} anchors a row, {live} live in all; seeding + "
          f"join {ph['long_seed_join_ms']:.1f} ms, the row sort alone (the earlier route's) "
          f"{ph['long_sort_ms']:.1f} ms, C1 above; the unbanded fit of the {len(ext)}-read extend batch (M = {Lb}, N = "
          f"{Wwin * 16}) {ph['long_unbanded_fit_ms']:.1f} ms", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 10)
    cases = ((40, 33, 0, "random"), (33, 150, 0, "random"), (9, 200, -7000, "negative"),
             (17, 64, 0, "duplicates"), (12, 90, 0, "no valid"), (5, 1, 0, "random"),
             (3, chain.ROW_CAP + 600, 0, "past a warp's shared memory"),
             (2, chain.SMEM_KEYS + 600, 0, "past a block's shared memory"))
    for B, Ae, lo_r, case in cases:
        r0 = torch.randint(lo_r, lo_r + 9000, (B, Ae), device=dev, dtype=torch.int32,
                           generator=gen)
        q0 = torch.sort(torch.randint(lo_r // 3, lo_r // 3 + 3000, (B, Ae), device=dev,
                                      dtype=torch.int32, generator=gen), dim=1).values
        r0 = torch.sort(r0, dim=1).values
        if case == "duplicates":
            r0, q0 = r0[:, : Ae // 4].repeat(1, 4), q0[:, : Ae // 4].repeat(1, 4)
        v0 = torch.rand((B, Ae), device=dev, generator=gen) < (0.0 if case == "no valid"
                                                                 else 0.85)
        if case.startswith("past"):  # every anchor of row 0 live
            v0[0] = True
        perm = torch.randperm(Ae, device=dev, generator=gen)  # any order within a row
        rows = (r0[:, perm].contiguous(), q0[:, perm].contiguous(), v0[:, perm].contiguous())
        if Ae > chain.SMEM_KEYS:
            runs = ((64, 2048, 16),)
        elif case.startswith("past"):
            runs = ((64, 2048, 16), (300, 300, 1000))
        else:
            runs = tuple((lb, mg, gu) for lb in (1, 64, chain.REG_LOOKBACK, Ae + 5)
                         for mg, gu in ((2048, 16), (0, 1), (300, 1000), (100, -3)))
        for lookback, mg, gu in runs:
            got = chain.chain_anchors(*rows, mg, gu, lookback)
            if Ae > chain.SMEM_KEYS:  # the plain loop of 30,000 steps runs faster on the host
                want = chain.chain_anchors_torch(*(x.cpu() for x in rows), mg, gu, lookback)
                got = tuple(x.cpu() for x in got)
            else:
                want = chain.chain_anchors_torch(*rows, mg, gu, lookback)
            compare("chain", f"[{B}, {Ae}] {case}, lookback {lookback}, max_gap {mg}, "
                    f"gap_unit {gu}", got, want)
    del packed, sub_reads, mid_reads, ext_reads

    # -- read pairs: map --paired -----------------------------------------------
    t = time.perf_counter()
    flen = rng.integers(PAIR_FRAG_MIN, PAIR_FRAG_MAX + 1, PAIRS)
    fs = rng.integers(0, len(genome) - flen)
    win = np.lib.stride_tricks.sliding_window_view(genome, PAIR_LEN)
    left, right = win[fs].copy(), win[fs + flen - PAIR_LEN].copy()
    comp = comp_table()
    kind = rng.random(PAIRS)
    rf = kind < 0.01
    split = (kind >= 0.01) & (kind < 0.02)
    flip = rng.random(PAIRS) < 0.5  # the fragment from the reverse strand: R1 is its right end
    r1 = np.where(flip[:, None], comp[right[:, ::-1]], left)
    r2 = np.where(flip[:, None], left, comp[right[:, ::-1]])
    # RF: the '+' mate rightmost
    r1[rf] = comp[left[rf, ::-1]]
    r2[rf] = right[rf]
    far = (fs[split] + rng.integers(20_000, len(genome) - 20_000, int(split.sum()))) \
        % (len(genome) - PAIR_LEN)
    r2[split] = win[far]
    for r in (r1, r2):
        hits = (rng.random(r.shape) < PAIR_SUB) & (r != ord("N"))
        r[hits] = np.frombuffer(b"ACGT", np.uint8)[
            (np.searchsorted(np.frombuffer(b"ACGT", np.uint8), r[hits])
             + rng.integers(1, 4, int(hits.sum()))) % 4]
    ph["pairs_make_s"] = time.perf_counter() - t
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    p1 = PackedReads.from_ascii(r1, validate=False, device=dev)
    p2 = PackedReads.from_ascii(r2, validate=False, device=dev)
    pr = mapper.map_pairs(index, p1, p2)
    torch.cuda.synchronize()
    ph["pairs_s"] = time.perf_counter() - t
    ph["pairs_per_s"] = PAIRS / ph["pairs_s"]
    pair_launches = dict(kernels.LAUNCHES)
    for name in ("pack", "fit_banded"):
        check(f"{name} launched on the paired path", pair_launches[name] > 0,
              f"{pair_launches[name]} launches")
    print(f"  {PAIRS} pairs, fragments {PAIR_FRAG_MIN}-{PAIR_FRAG_MAX} bp: map_pairs (with K1) "
          f"{ph['pairs_s']:.2f} s ({ph['pairs_per_s']:.0f} pairs/s); launches {pair_launches}",
          flush=True)
    stacked = PackedReads(words=torch.cat([p1.words, p2.words]),
                          lengths=torch.cat([p1.lengths, p2.lengths]))
    both = mapper.map_reads(index, stacked)
    m1 = {f: v[:PAIRS] for f, v in both.items()}
    m2 = {f: v[PAIRS:] for f, v in both.items()}
    plus1 = m1["strand"] == b"+"
    ls = np.where(plus1, m1["ref_start"], m2["ref_start"])
    re_ = np.where(plus1, m2["ref_end"], m1["ref_end"])
    ins_h = re_ - ls
    prop_h = (m1["mapped"] & m2["mapped"] & (m1["strand"] != m2["strand"])
              & (ls <= np.where(plus1, m2["ref_start"], m1["ref_start"]))
              & (ins_h >= 0) & (ins_h <= 1000))
    check("map_pairs == map_reads of the stacked batch + the pairing rule on the host",
          all(np.array_equal(pr["r1"][f], m1[f]) and np.array_equal(pr["r2"][f], m2[f])
              for f in m1)
          and np.array_equal(pr["proper"], prop_h)
          and np.array_equal(pr["insert"], np.where(prop_h, ins_h, -1).astype(np.int32)))
    true1 = np.where(flip, fs + flen - PAIR_LEN, fs)
    true2 = np.where(flip, fs, fs + flen - PAIR_LEN)
    conc = ~rf & ~split
    at_true = (m1["mapped"] & m2["mapped"] & (m1["ref_start"] == true1)
               & (m2["ref_start"] == true2) & ((m1["strand"] == b"-") == flip)
               & ((m2["strand"] == b"-") == ~flip))
    sel = conc & at_true
    good = pr["proper"][sel] & (pr["insert"][sel] == flen[sel])
    ph["pairs_proper_fraction"] = float(good.mean())
    check("concordant pairs with both mates at their true starts: >= 99% proper, insert == "
          "fragment length", good.mean() >= 0.99, f"{good.mean() * 100:.3f}% of {int(sel.sum())}")
    check("no RF or split pair is proper", not pr["proper"][rf | split].any(),
          f"{int(rf.sum())} RF, {int(split.sum())} split")
    del p1, p2, stacked, both, r1, r2, left, right

    # -- variant calls: call and call --cigar -------------------------------------
    t = time.perf_counter()
    ref = genome[:CALL_BP]
    donor, snps, dels, ins = plant_variants(rng, ref)
    creads = donor_reads(rng, donor, CALL_READS, CALL_LEN, CALL_SUB)
    ph["calls_make_s"] = time.perf_counter() - t
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    cp = PackedReads.from_ascii(creads, validate=False, device=dev)
    cres = mapper.map_reads(index, cp)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t
    t = time.perf_counter()
    calls = pileup.call_variants(index, cp, cres)
    torch.cuda.synchronize()
    t_gapless = time.perf_counter() - t
    t = time.perf_counter()
    calls_c = pileup.call_variants(index, cp, cres, max_cost=20, cigar=True)
    torch.cuda.synchronize()
    t_cigar = time.perf_counter() - t
    call_launches = dict(kernels.LAUNCHES)
    for name in ("pack", "fit_banded"):
        check(f"{name} launched on the calling path", call_launches[name] > 0,
              f"{call_launches[name]} launches")
    keep = cres["mapped"] & (cres["cost"] <= 8)
    rs_t = torch.from_numpy(cres["ref_start"]).to(dev)
    rc_t = torch.from_numpy(cres["strand"] == b"-").to(dev)
    keep_t = torch.from_numpy(keep).to(dev)
    ph["calls_pileup_ms"] = timer(lambda: pileup.pileup_counts(
        cp.words, cp.lengths, rs_t, rc_t, keep_t, index.ref_len), 3)
    counts_t = torch.from_numpy(calls["counts"]).to(dev)
    ph["calls_consensus_ms"] = timer(lambda: pileup.consensus_calls(
        counts_t, index.ref_words, 2, 0.5), 3)
    ph.update(calls_map_s=t_map, calls_gapless_ms=t_gapless * 1e3, calls_cigar_ms=t_cigar * 1e3)
    print(f"  {CALL_READS} reads of {CALL_LEN} bp from a donor of {len(donor)} bp ({len(snps)} "
          f"SNPs, {len(dels)} deletions, {len(ins)} insertions): map_reads {t_map:.2f} s; "
          f"call_variants {t_gapless * 1e3:.1f} ms gapless, {t_cigar * 1e3:.1f} ms with "
          f"--cigar (its traceback included); pileup_counts {ph['calls_pileup_ms']:.2f} ms, "
          f"consensus_calls {ph['calls_consensus_ms']:.2f} ms; launches {call_launches}",
          flush=True)
    # the gapless grid against np.add.at of the same map result
    codes = ascii_codes(creads)
    minus = cres["strand"] == b"-"
    codes[minus] = 3 - codes[minus, ::-1]
    gpos = cres["ref_start"][:, None].astype(np.int64) + np.arange(CALL_LEN)
    ok = keep[:, None] & (gpos >= 0) & (gpos < index.ref_len)
    host = np.zeros((index.ref_len, 4), np.int32)
    np.add.at(host, (gpos[ok], codes[ok]), 1)
    check("counts == np.add.at of the same map result", np.array_equal(calls["counts"], host))
    indel_pos = np.array(sorted(list(dels) + list(ins)), np.int64)

    def near_indel(p):
        i = np.searchsorted(indel_pos, p)
        return any(abs(int(indel_pos[j]) - p) <= CALL_NEAR for j in (i - 1, i)
                   if 0 <= j < len(indel_pos))

    for mode, c in (("gapless", calls), ("--cigar", calls_c)):
        called = dict(zip(c["variant_pos"].tolist(), c["variant_alt"].tolist()))
        want = [p for p in snps if c["depth"][p] >= 10 and not near_indel(p)]
        hit = sum(called.get(p) == snps[p] for p in want)
        false = [p for p in called if p not in snps and not near_indel(p)]
        ph[f"calls_snp_recall_{mode.strip('-')}"] = hit / max(len(want), 1)
        check(f"{mode}: >= 99% of planted SNPs at depth >= 10, clear of indels, called with "
              "their alt", hit >= 0.99 * len(want), f"{hit} of {len(want)}")
        check(f"{mode}: false SNP calls clear of indels < 1% of the SNPs planted",
              len(false) < 0.01 * len(snps), f"{len(false)} calls")
    got_d = dict(zip(calls_c["del_pos"].tolist(), calls_c["del_len"].tolist()))
    got_i = dict(zip(calls_c["ins_pos"].tolist(), calls_c["ins_seq"]))
    want_d = [p for p in dels if calls_c["depth"][p] + calls_c["dels"][p] >= 10]
    missed = [(p, dels[p], got_d.get(p)) for p in want_d if got_d.get(p) != dels[p]]
    ph["calls_del_recall"] = 1 - len(missed) / max(len(want_d), 1)
    check("--cigar: >= 95% of planted deletions at depth >= 10 called at their position with "
          "their length", len(missed) <= 0.05 * len(want_d),
          f"{len(want_d) - len(missed)} of {len(want_d)}; missed (pos, planted, called): "
          f"{missed[:6]}")
    # insertions: the caller's rule (the JAX package's) tests ins >= min_frac * (depth + ins),
    # and a read carrying the insertion also counts in depth at the anchor, so at min_frac 0.5
    # an insertion is called only where every covering read carries it. The truth check reads
    # the evidence at each planted anchor: carried by at least half the covering reads, with
    # the planted sequence as the majority of the inserted ones.
    tb_ops = mapper.traceback_cigars(index, cp, cres)["ops"]
    keep20 = cres["mapped"] & (cres["cost"] <= 20)
    want_i = [p for p in ins if calls_c["depth"][p] >= 10]
    seqs = pileup._insertion_consensus(cp, cres, tb_ops, keep20, want_i)
    missed = [(p, ins[p], int(calls_c["ins"][p]), int(calls_c["depth"][p]), seqs.get(p))
              for p in want_i
              if not (calls_c["ins"][p] >= 0.5 * calls_c["depth"][p] and seqs.get(p) == ins[p])]
    check("--cigar: >= 95% of planted insertions at depth >= 10 carried at their anchor by at "
          "least half the covering reads, with the planted sequence",
          len(missed) <= 0.05 * len(want_i),
          f"{len(want_i) - len(missed)} of {len(want_i)}; missed (pos, planted, ins, depth, "
          f"majority): {missed[:4]}")
    called = [p for p in want_i if got_i.get(p) == ins[p]]
    ph["calls_ins_called_fraction"] = len(called) / max(len(want_i), 1)
    check("--cigar: every insertion called at a planted anchor has the planted sequence",
          all(got_i[p] == ins[p] for p in got_i if p in ins),
          f"{len(called)} of {len(want_i)} planted insertions called by the caller's rule")
    with config.backend("torch"):
        cres_p = mapper.map_reads(index, cp)
        calls_p = pileup.call_variants(index, cp, cres_p)
        calls_cp = pileup.call_variants(index, cp, cres_p, max_cost=20, cigar=True)

    def same(a, b):
        return a.keys() == b.keys() and all(
            a[f] == b[f] if isinstance(a[f], list) else np.array_equal(a[f], b[f]) for f in a)

    check("the calling path under backend('torch') == default backend (map, both modes)",
          same(cres, cres_p) and same(calls, calls_p) and same(calls_c, calls_cp))
    del cp, calls, calls_c, calls_p, calls_cp, counts_t, rs_t, rc_t, keep_t

    # -- sketches: bitnuc-tpu sketch of the genome and of reads ------------------
    kernels.reset_launches()
    _, fa_genome = bnio.read_fasta(fa, validate=False, device=dev)
    sk_reads = PackedReads.from_ascii(reads_g[:SKETCH_READS], validate=False, device=dev)
    sk = {}
    for name, pr_ in (("genome", fa_genome), ("reads", sk_reads)):
        sk[name] = kmer.minimizer_sketch(pr_.words, pr_.lengths, SKETCH_K, SKETCH_W)
        sk[name + "64"] = kmer.minimizer_sketch64(pr_.words, pr_.lengths, SKETCH_K64, SKETCH_W)
        ph[f"sketch_{name}_ms"] = timer(lambda: kmer.minimizer_sketch(
            pr_.words, pr_.lengths, SKETCH_K, SKETCH_W), 2)
        ph[f"sketch64_{name}_ms"] = timer(lambda: kmer.minimizer_sketch64(
            pr_.words, pr_.lengths, SKETCH_K64, SKETCH_W), 2)
    ratios = {
        "jaccard": float(kmer.sketch_jaccard(sk["reads"][0], sk["genome"][0])),
        "containment": float(kmer.sketch_containment(sk["reads"][0], sk["genome"][0])),
        "jaccard64": float(kmer.sketch_jaccard64(*sk["reads64"][:2], *sk["genome64"][:2])),
        "containment64": float(kmer.sketch_containment64(*sk["reads64"][:2],
                                                        *sk["genome64"][:2])),
    }
    model = {}
    for name, rows_ in (("genome", genome[None, :]), ("reads", reads_g[:SKETCH_READS])):
        c = ascii_codes(rows_)
        model[name] = host_minimizer_set(c, SKETCH_K, SKETCH_W)
        model[name + "64"] = host_minimizer_set(c, SKETCH_K64, SKETCH_W)
    for name in ("genome", "reads"):
        vals, n_u = sk[name]
        got_v = bitops.words_to_u32_np(vals[: int(n_u)]).astype(np.uint64)
        lo, hi, n64 = sk[name + "64"]
        got64 = (bitops.words_to_u32_np(hi[: int(n64)]).astype(np.uint64) << np.uint64(32)) \
            | bitops.words_to_u32_np(lo[: int(n64)]).astype(np.uint64)
        check(f"the {name} sketches (k = {SKETCH_K}, {SKETCH_K64}) == the host set model",
              np.array_equal(got_v, model[name]) and np.array_equal(got64, model[name + "64"]),
              f"{len(got_v)} and {len(got64)} distinct minimizers")
    want_r = {}
    for sfx in ("", "64"):
        a, b = model["reads" + sfx], model["genome" + sfx]
        inter = np.intersect1d(a, b).size
        want_r["jaccard" + sfx] = float(np.float32(inter) / np.float32(np.union1d(a, b).size))
        want_r["containment" + sfx] = float(np.float32(inter) / np.float32(a.size))
    check("Jaccard and containment of reads in genome == the host set model", ratios == want_r,
          f"{ratios}")
    ph["sketch_ratios"] = ratios
    print(f"  sketches: genome {ph['sketch_genome_ms']:.1f} ms (k = {SKETCH_K}), "
          f"{ph['sketch64_genome_ms']:.1f} ms (k = {SKETCH_K64}); {SKETCH_READS} reads "
          f"{ph['sketch_reads_ms']:.1f} / {ph['sketch64_reads_ms']:.1f} ms; {ratios}", flush=True)
    ph["phase10_s"] = time.perf_counter() - t_phase
    print(f"  phase 10 in {ph['phase10_s']:.1f} s (long reads written in "
          f"{ph['long_write_s']:.1f} s)", flush=True)



# -- phase 11: the read-processing tier ---------------------------------------------

TIER_READS = 262_144  # reads of each stage
TIER_RANDOM = 16_384  # random reads screened beside phase 6's
TIER_SUBSET = 4_096  # reads held to a host oracle or a CPU run
TIER_BATCH = 65_536  # records a batch of filter_fastq and qc_profile
ADAPTER = b"AGATCGGAAGAGC"  # the TruSeq adapter's prefix
ADAPTER_SHARE, POLY_A_SHARE, MANY_N_SHARE, MANY_N = 0.05, 0.01, 0.01, 8
FILTER_KW = dict(trim_q=20, min_len=30, min_mean_q=20, max_n=5, adapter=ADAPTER,
                 min_complexity=0.3, min_entropy=3.0)
ENTROPY_TOL = 1e-4  # |h - min_entropy| within which the fused filter may differ
ADAPTER_CHECK_MIN = 30  # planted adapters at this offset or later must be cut
DUP_SHARE = 0.25
CORRECT_MIN_COUNT, CORRECT_ROUNDS = 2, 4
CORRECT_RECOVERED_MIN = 0.97
SCREEN_RANDOM_SOLID_MAX, SCREEN_RANDOM_SHARE = 1, 0.999
N_BARCODES, BC_LEN, BC_MIN_DIST, BC_SUB, BC_MAX_DIST = 96, 8, 3, 0.01, 1
TIER_LAUNCHES = {}


def write_fastq_quals(path: str, seqs: np.ndarray, quals: np.ndarray, prefix=b"q") -> None:
    """Fixed-width records @<prefix>%09d, the sequence, '+', the qualities."""
    n, L = seqs.shape
    ids = np.arange(n, dtype=np.int64)
    digits = (ids[:, None] // (10 ** np.arange(8, -1, -1))[None, :]) % 10
    head = np.frombuffer(b"@" + prefix, np.uint8)
    hdr = np.concatenate([np.broadcast_to(head, (n, head.size)), digits + ord("0"),
                          np.full((n, 1), 10)], axis=1).astype(np.uint8)
    tail = np.frombuffer(b"\n+\n", np.uint8)
    rec = np.concatenate([hdr, seqs, np.broadcast_to(tail, (n, 3)), quals,
                          np.full((n, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(rec).tobytes())


def tier_fastq(rng, genome: np.ndarray):
    """TIER_READS reads of READ_LEN bp from the genome with qualities that
    decline along the read with noise; the adapter's prefix planted at a
    random offset in [0, READ_LEN - 3) of ADAPTER_SHARE of the reads (the
    rest of the adapter runs off the read's end), POLY_A_SHARE poly-A
    reads and MANY_N_SHARE reads with MANY_N Ns. Returns (ASCII, phred+33
    qualities, adapter offset or -1 a read)."""
    n, L = TIER_READS, READ_LEN
    seqs, _, _ = sample_reads(rng, genome, n, L)
    pos = np.arange(L)[None, :]
    q = 40 - 0.12 * pos + rng.normal(0, 5, (n, L))
    quals = (np.clip(np.rint(q), 2, 41) + 33).astype(np.uint8)
    kind = rng.random(n)
    offset = np.full(n, -1, np.int64)
    ad = kind < ADAPTER_SHARE
    offset[ad] = rng.integers(0, L - 3, int(ad.sum()))
    adapter = np.frombuffer(ADAPTER, np.uint8)
    for i in np.flatnonzero(ad):
        p = int(offset[i])
        seqs[i, p : p + len(adapter)] = adapter[: L - p]
    seqs[(kind >= ADAPTER_SHARE) & (kind < ADAPTER_SHARE + POLY_A_SHARE)] = ord("A")
    many = (kind >= ADAPTER_SHARE + POLY_A_SHARE) & (
        kind < ADAPTER_SHARE + POLY_A_SHARE + MANY_N_SHARE)
    for i in np.flatnonzero(many):
        seqs[i, rng.choice(L, MANY_N, replace=False)] = ord("N")
    return seqs, quals, offset


def qc_host_fold(ascii_arr: np.ndarray, quals: np.ndarray, lens: np.ndarray):
    """Host numpy QC fold (the JAX package's numpy path): (base_by_cycle
    [L, 5], qual_by_cycle [L, 64], mean_q_hist [64], gc_hist [101])."""
    R, L = ascii_arr.shape
    sym_lut = np.full(256, 4, np.int64)
    for i, b in enumerate(b"ACGT"):
        sym_lut[b] = sym_lut[b | 0x20] = i
    pos = np.arange(L, dtype=np.int64)[None, :]
    in_read = pos < lens[:, None]
    sym = sym_lut[ascii_arr]
    base = np.bincount(np.where(in_read, pos * 5 + sym, L * 5).ravel(),
                       minlength=L * 5 + 1)[: L * 5].reshape(L, 5)
    phred = np.clip(quals, 33, 96).astype(np.int64) - 33
    qual = np.bincount(np.where(in_read, pos * 64 + phred, L * 64).ravel(),
                       minlength=L * 64 + 1)[: L * 64].reshape(L, 64)
    span = np.maximum(lens, 1)
    mean_q = np.clip(np.rint(np.where(in_read, phred, 0).sum(1) / span).astype(np.int64), 0, 63)
    gc = (in_read & ((sym == 1) | (sym == 2))).sum(1)
    gc_pct = np.clip(np.rint(100.0 * gc / span).astype(np.int64), 0, 100)
    return base, qual, np.bincount(mean_q, minlength=64), np.bincount(gc_pct, minlength=101)


def pick_barcodes(rng) -> np.ndarray:
    """N_BARCODES codes [n, BC_LEN] whose pairwise Hamming distance is at
    least BC_MIN_DIST, by rejection from the generator."""
    out = []
    while len(out) < N_BARCODES:
        c = rng.integers(0, 4, BC_LEN)
        if all((c != o).sum() >= BC_MIN_DIST for o in out):
            out.append(c)
    return np.stack(out)


def host_canonical_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """[n, L - k + 1] uint64 canonical keys of every window of 2-bit codes
    [n, L] (as_2bit: base j at bits 2j)."""
    win = np.lib.stride_tricks.sliding_window_view(codes.astype(np.uint64), k, axis=1)
    sh = (2 * np.arange(k)).astype(np.uint64)
    fwd = (win << sh).sum(-1, dtype=np.uint64)
    rc = ((np.uint64(3) - win[..., ::-1]) << sh).sum(-1, dtype=np.uint64)
    return np.minimum(fwd, rc)


def read_tier_phase(args, torch, dev, timer, results, tmp, genome, reads, true_starts,
                    true_rev):
    """Phase 11: the read-processing tier. filter_fastq, filter_fastq_paired
    and qc_profile of a 262,144-read FASTQ; mark_duplicates, screen_reads,
    correct_reads (decoded with K2) and assign_barcodes on 262,144 of
    phase 6's reads (packed with K1) against phase 6's k = 21 tables; under
    the default backend and backend('torch'), with host oracles and CPU
    runs."""
    from bitnuc_tpu_torch import config, filters, io, kernels, qc
    from bitnuc_tpu_torch.ops import codec, correct, dedupe, demux, kmer, lookup
    from bitnuc_tpu_torch.sequence import PackedReads
    from bitnuc_tpu_torch.utils import bitops

    ph = results["phases"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 11)
    k = LARGE_K
    n = TIER_READS
    print(f"phase 11: read-processing tier ({n} reads of {READ_LEN} bp; phase 6's k = {k} "
          "tables)", flush=True)
    # -- inputs ----------------------------------------------------------------
    fq_seqs, fq_quals, ad_off = tier_fastq(rng, genome)
    fq2_seqs, fq2_quals, _ = tier_fastq(rng, genome)
    paths = {name: os.path.join(tmp, f"tier_{name}.fq") for name in ("r1", "r2")}
    write_fastq_quals(paths["r1"], fq_seqs, fq_quals)
    write_fastq_quals(paths["r2"], fq2_seqs, fq2_quals)
    base = reads[:n]
    dup_src = rng.integers(0, n, n)
    dup = rng.random(n) < DUP_SHARE
    dup_rows = np.where(dup[:, None], base[dup_src], base)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    random_rows = acgt[rng.integers(0, 4, (TIER_RANDOM, READ_LEN))]
    screen_rows = np.concatenate([base, random_rows])
    bcs = pick_barcodes(rng)
    bc_of = rng.integers(0, N_BARCODES, n)
    heads = bcs[bc_of].copy()
    sub = rng.random(heads.shape) < BC_SUB
    heads[sub] = (heads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    demux_rows = np.concatenate([acgt[heads], base], 1)
    t_reads = LARGE_K_TABLES["reads"]
    t_genome = LARGE_K_TABLES["genome"]
    ph["tier_write_s"] = time.perf_counter() - t0
    out_paths = {b: {name: os.path.join(tmp, f"tier_{b}_{name}.fq") for name in ("f", "p1", "p2")}
                 for b in ("auto", "torch")}

    def up(rows):
        return torch.from_numpy(np.ascontiguousarray(rows)).to(dev)

    def pack(rows):  # K1 on the card
        return PackedReads.from_ascii(rows, validate=False, device=dev)

    def stage_fns(label):
        """The path's stages; each returns what the checks read."""
        o = out_paths[label]

        def filt():
            return filters.filter_fastq(paths["r1"], o["f"], batch_reads=TIER_BATCH, device=dev,
                                        **FILTER_KW)

        def paired():
            return filters.filter_fastq_paired(paths["r1"], paths["r2"], o["p1"], o["p2"],
                                               batch_reads=TIER_BATCH, device=dev, **FILTER_KW)

        def qcp():
            return qc.qc_profile(paths["r1"], TIER_BATCH, device=dev)

        def dedup():
            r = pack(dup_rows)
            return dedupe.dedupe_reads(r)

        def screen():
            r = pack(screen_rows)
            bv = codec.validity_mask(up(screen_rows), r.lengths)
            return lookup.screen_reads(r.words, r.lengths, k, *t_genome, 1, True, bv)

        def corr():
            r = pack(base)
            bv = codec.validity_mask(up(base), r.lengths)
            w, nc = correct.correct_reads(r.words, r.lengths, k, *t_reads, CORRECT_MIN_COUNT,
                                          CORRECT_ROUNDS, True, bv)
            return w, nc, codec.decode_reads(w, r.lengths, READ_LEN)  # K2

        def dmx():
            r = pack(demux_rows)
            b = pack(acgt[bcs])
            return demux.assign_barcodes(r.words, r.lengths, b.words, BC_LEN, BC_MAX_DIST)

        return {"filter_fastq": filt, "filter_fastq_paired": paired, "qc_profile": qcp,
                "mark_duplicates (K1 + dedupe)": dedup, "screen_reads (K1 + lookup)": screen,
                "correct_reads (K1 + 4 rounds + K2)": corr,
                "assign_barcodes (K1 + demux)": dmx}

    def run(label):
        out = {}
        for name, fn in stage_fns(label).items():
            got = fn()
            out[name] = tuple(x.cpu().numpy() for x in got) if isinstance(got, tuple) else got
        for name in ("f", "p1", "p2"):
            with open(out_paths[label][name], "rb") as f:
                out[f"file {name}"] = f.read()
        return out

    # -- the path, with the counters set to 0 just before it ----------------
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = run("auto")
    torch.cuda.synchronize()
    ph["tier_path_s"] = time.perf_counter() - t
    TIER_LAUNCHES.update(kernels.LAUNCHES)
    ph["tier_launches"] = dict(TIER_LAUNCHES)
    print(f"  launches {TIER_LAUNCHES}", flush=True)
    for name in ("pack", "unpack"):
        check(f"{name} launched on the read-processing path", TIER_LAUNCHES[name] > 0,
              f"{TIER_LAUNCHES[name]} launches")

    # -- each stage on a warm second call (the path's was the first) ------------
    ph["tier_stages_ms"] = {}
    for name, fn in stage_fns("auto").items():
        ms = timer(fn, 1, warmup=False)
        ph["tier_stages_ms"][name] = ms
        print(f"    stage {name}: {ms:.1f} ms ({n / ms * 1e3:.0f} reads/s)", flush=True)
    r = pack(base)
    bv = codec.validity_mask(up(base), r.lengths)
    table = lookup._prepare(*t_reads)
    w1, _ = correct._correct_once(table, r.words, r.lengths, k, CORRECT_MIN_COUNT, True, bv)
    lo, hi, valid = kmer._window_keys(r.words, r.lengths, k, True, bv)
    inner = {
        "correct: table prep (sort + sums)": lambda: lookup._prepare(*t_reads),
        "correct: one round": lambda: correct._correct_once(
            table, r.words, r.lengths, k, CORRECT_MIN_COUNT, True, bv),
        "correct: one round's window lookups alone": lambda: lookup._lookup_prepared(
            table, lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)),
        "correct: a round's candidate keys (3 x [B, L], canonical)": lambda: (
            correct._candidate_keys(codes3, k, True)),
        "correct: a round's candidate lookups (3 x the window slots)": lambda: (
            lookup._lookup_prepared(table, lo3, hi3, valid3)),
        "correct_reads alone (packed input, 4 rounds)": lambda: correct.correct_reads(
            r.words, r.lengths, k, *t_reads, CORRECT_MIN_COUNT, CORRECT_ROUNDS, True, bv),
        "screen: table prep": lambda: lookup._prepare(*t_genome),
        "screen_reads alone (packed input)": lambda: lookup.screen_reads(
            rs.words, rs.lengths, k, *t_genome, 1, True, bv_s),
        "mark_duplicates alone (packed input)": lambda: dedupe.mark_duplicates(rd.words,
                                                                              rd.lengths),
        "assign_barcodes alone (packed input)": lambda: demux.assign_barcodes(
            rb.words, rb.lengths, bcw, BC_LEN, BC_MAX_DIST),
        "upload + pack (K1)": lambda: pack(base),
        "decode (K2)": lambda: codec.decode_reads(w1, r.lengths, READ_LEN),
        "filter and qc: framing (iter_fastq_record_batches)": lambda: list(
            io.iter_fastq_record_batches(paths["r1"], TIER_BATCH)),
        "filter: fused filter_reads of the batches (upload, core, download)": lambda: [
            filters.filter_reads(a, q, ln, device=dev, **FILTER_KW) for _, a, q, ln, _, _ in
            framed],
        "filter: emit of the batches": lambda: [
            filters._emit_records(raw, a, q, no, nl, *kse) for (raw, a, q, _, no, nl), kse in
            zip(framed, filtered)],
        "qc: fold of the batches (upload, bincounts, download)": lambda: [
            qc._Acc(dev).fold(a, q, ln) for _, a, q, ln, _, _ in framed],
    }
    codes3 = bitops.unpack_words(r.words)[None].expand(3, -1, -1).contiguous()
    lo3, hi3, valid3 = (x.reshape(-1).repeat(3) for x in (lo, hi, valid))
    rs, rd, rb = pack(screen_rows), pack(dup_rows), pack(demux_rows)
    bv_s = codec.validity_mask(up(screen_rows), rs.lengths)
    bcw = pack(acgt[bcs]).words
    framed = list(io.iter_fastq_record_batches(paths["r1"], TIER_BATCH))
    filtered = [filters.filter_reads(a, q, ln, device=dev, **FILTER_KW)
                for _, a, q, ln, _, _ in framed]
    for name, fn in inner.items():
        host = name.startswith(("filter", "qc"))  # seconds on the host, each run once before
        ms = timer(fn, 1, warmup=False) if host else timer(fn, 3)
        ph["tier_stages_ms"][name] = ms
        print(f"    {name}: {ms:.3f} ms", flush=True)
    print(f"    table rows: reads {t_reads[0].numel()}, genome {t_genome[0].numel()}; window "
          f"slots a lookup {lo.numel()} (x 3 candidates a round)", flush=True)
    del r, bv, table, w1, lo, hi, valid, codes3, lo3, hi3, valid3, rs, rd, rb, bv_s, framed

    # -- the same path under backend('torch') ------------------------------------
    with config.backend("torch"):
        plain = run("torch")
    bad = [name for name in out if not same_outputs(out[name], plain[name])]
    check("read-processing path under backend('torch') == default backend, every output",
          not bad, f"differ: {bad}")
    del plain

    # -- filter: fused core against the numpy reference -------------------------
    f_out = out["filter_fastq"]
    keeps, starts, ends, rows_sure = [], [], [], []
    expect = []
    t = time.perf_counter()
    for raw, a, q, lens, noff, nlen in io.iter_fastq_record_batches(paths["r1"], TIER_BATCH):
        kf, sf, ef = filters.filter_reads(a, q, lens, device=dev, **FILTER_KW)
        kr, sr, er = filters.filter_reads(a, q, lens, use_jax=False, **FILTER_KW)
        h = filters.triplet_entropy(a, sr, er)
        sure = np.abs(h - FILTER_KW["min_entropy"]) > ENTROPY_TOL
        ok = np.array_equal(sf, sr) and np.array_equal(ef, er) and np.array_equal(kf[sure],
                                                                                 kr[sure])
        keeps.append(kf), starts.append(sf), ends.append(ef), rows_sure.append(ok)
        expect.append(filters._emit_records(raw, a, q, noff, nlen, np.where(sure, kr, kf), sr,
                                            er))
    ph["tier_filter_reference_s"] = time.perf_counter() - t
    keep, start, end = (np.concatenate(x) for x in (keeps, starts, ends))
    check("filter_reads' fused core on the card == the numpy reference (start, end; keep "
          f"where |entropy - {FILTER_KW['min_entropy']}| > {ENTROPY_TOL})", all(rows_sure))
    check("filter_fastq's file == the records the numpy reference keeps, byte for byte",
          out["file f"] == b"".join(expect)
          and f_out == {"reads_in": n, "reads_out": int(keep.sum()),
                        "bases_in": n * READ_LEN,
                        "bases_out": int(np.where(keep, end - start, 0).sum())}, f"{f_out}")
    planted = ad_off >= ADAPTER_CHECK_MIN
    check(f"every adapter planted at an offset >= {ADAPTER_CHECK_MIN} is cut at or before it",
          bool((end[planted] <= ad_off[planted]).all()), f"{int(planted.sum())} reads")
    print(f"  filter_fastq kept {f_out['reads_out']} of {n} reads, {f_out['bases_out']} of "
          f"{f_out['bases_in']} bases", flush=True)
    keep2 = np.concatenate([filters.filter_reads(a, q, lens, device=dev, **FILTER_KW)[0]
                            for _, a, q, lens, _, _ in io.iter_fastq_record_batches(
                                paths["r2"], TIER_BATCH)])
    both = keep & keep2
    p_out = out["filter_fastq_paired"]
    want1 = b"".join(filters._emit_records(raw, a, q, noff, nlen,
                                           both[i * TIER_BATCH : (i + 1) * TIER_BATCH],
                                           start[i * TIER_BATCH : (i + 1) * TIER_BATCH],
                                           end[i * TIER_BATCH : (i + 1) * TIER_BATCH])
                     for i, (raw, a, q, _, noff, nlen) in enumerate(
                         io.iter_fastq_record_batches(paths["r1"], TIER_BATCH)))
    check("filter_fastq_paired keeps exactly the pairs whose mates both pass, R1 as trimmed",
          p_out == {"pairs_in": n, "pairs_out": int(both.sum())} and out["file p1"] == want1,
          f"{p_out}")

    # -- qc against a host numpy fold ------------------------------------------------
    rep = out["qc_profile"]
    acc = qc._Acc(dev)
    acc.width = READ_LEN
    acc.base_by_cycle, acc.qual_by_cycle, acc.mean_q_hist, acc.gc_hist = qc_host_fold(
        fq_seqs, fq_quals, np.full(n, READ_LEN, np.int64))
    cyc = qc._per_cycle_rows(acc)
    want = {"reads": n, "bases": n * READ_LEN, "min_len": READ_LEN, "max_len": READ_LEN,
            "mean_len": float(READ_LEN), "per_cycle": cyc,
            "mean_quality_hist": {int(i): int(acc.mean_q_hist[i])
                                  for i in np.nonzero(acc.mean_q_hist)[0]},
            "gc_hist": {int(i): int(acc.gc_hist[i]) for i in np.nonzero(acc.gc_hist)[0]},
            "status": qc._status(cyc)}
    check("qc_profile == the report of a host numpy fold, key for key", rep == want,
          f"status {rep['status']}")

    # -- dedupe against np.unique over the 2-bit codes ---------------------------------
    keep_d, counts_d = out["mark_duplicates (K1 + dedupe)"]
    codes = ascii_codes(dup_rows)
    _, first, cnt = np.unique(codes, axis=0, return_index=True, return_counts=True)
    want_keep = np.zeros(n, bool)
    want_keep[first] = True
    want_counts = np.zeros(n, np.int64)
    want_counts[first] = cnt
    check("mark_duplicates == np.unique(axis=0) over the 2-bit codes; counts sum to R",
          np.array_equal(keep_d, want_keep) and np.array_equal(counts_d, want_counts)
          and int(counts_d.sum()) == n, f"{int(keep_d.sum())} distinct of {n}")

    # -- screen -----------------------------------------------------------------------
    n_win, n_solid = out["screen_reads (K1 + lookup)"]
    truth = true_slices(genome, true_starts[:n], true_rev[:n])
    has_n = (base == ord("N")).any(1)
    clean = ~has_n & (base == truth).all(1)
    rand_solid = n_solid[n:]
    share = float((rand_solid <= SCREEN_RANDOM_SOLID_MAX).mean())
    check("screen: reads with no substitution and no N are fully solid against the genome",
          bool((n_solid[:n][clean] == n_win[:n][clean]).all()
               and (n_win[:n][clean] == READ_LEN - k + 1).all()), f"{int(clean.sum())} reads")
    check(f"screen: >= {SCREEN_RANDOM_SHARE:.1%} of {TIER_RANDOM} random reads have n_solid <= "
          f"{SCREEN_RANDOM_SOLID_MAX}", share >= SCREEN_RANDOM_SHARE, f"{share:.5f}")
    sub_idx = np.concatenate([np.arange(TIER_SUBSET // 2), n + np.arange(TIER_SUBSET // 2)])
    sub_rows = screen_rows[sub_idx]
    g_keys = np.sort((t_genome[1].cpu().numpy().view(np.uint32).astype(np.uint64)
                      << np.uint64(32)) | t_genome[0].cpu().numpy().view(np.uint32)
                     .astype(np.uint64))
    wk = host_canonical_keys(ascii_codes(sub_rows), k)
    wv = ~np.lib.stride_tricks.sliding_window_view(sub_rows == ord("N"), k, axis=1).any(-1)
    idx = np.minimum(np.searchsorted(g_keys, wk), len(g_keys) - 1)
    hit = wv & (g_keys[idx] == wk)
    check(f"screen: {TIER_SUBSET} reads == host oracle (windows, solid windows)",
          np.array_equal(n_win[sub_idx], wv.sum(1)) and np.array_equal(n_solid[sub_idx],
                                                                       hit.sum(1)))
    sr = pack(sub_rows)
    counts, valid = lookup.kmer_hits_reads(sr.words, sr.lengths, k, *t_genome, True,
                                           codec.validity_mask(up(sub_rows), sr.lengths))
    spl = lookup.solid_prefix_len(counts, valid, sr.lengths, k, 1).cpu().numpy()
    weak = wv & ~hit
    fw = np.where(weak.any(1), weak.argmax(1), -1)
    want_spl = np.where(fw < 0, READ_LEN, np.where(fw > 0, np.minimum(fw + k - 1, READ_LEN), 0))
    check(f"solid_prefix_len of the {TIER_SUBSET} reads == host rule", np.array_equal(spl,
                                                                                    want_spl))
    del counts, valid, sr

    # -- correct ----------------------------------------------------------------------
    w_c, n_c, dec = out["correct_reads (K1 + 4 rounds + K2)"]
    dec = dec[:, :READ_LEN]
    n_diff = (base != truth).sum(1)
    one = ~has_n & (n_diff == 1)
    back = (dec == truth).all(1)
    rec = float(back[one].mean())
    ph["tier_correct"] = {"one_error_no_n": int(one.sum()), "recovered": int(back[one].sum()),
                          "corrected_reads": int((n_c > 0).sum()),
                          "corrections": int(n_c.sum())}
    print(f"  correct: {int(one.sum())} reads carry exactly one substitution and no N; "
          f"{int(back[one].sum())} ({rec:.4%}) come back equal to their genome slice; "
          f"{int((n_c > 0).sum())} reads changed, {int(n_c.sum())} bases", flush=True)
    check(f"correct: >= {CORRECT_RECOVERED_MIN:.0%} of one-error reads recovered",
          rec >= CORRECT_RECOVERED_MIN, f"{rec:.4f}")
    changed = (dec != base).any(1)
    check("correct: no read without a planted error and N changes",
          not bool((changed & clean).any()) and not bool((n_c[clean] > 0).any()),
          f"{int((changed & clean).sum())} changed")
    cpu = torch.device("cpu")
    sr = PackedReads.from_ascii(base[:TIER_SUBSET], validate=False, device=cpu)
    w_cpu, n_cpu = correct.correct_reads(
        sr.words, sr.lengths, k, *(x.cpu() for x in t_reads), CORRECT_MIN_COUNT,
        CORRECT_ROUNDS, True, codec.validity_mask(torch.from_numpy(base[:TIER_SUBSET]),
                                                  sr.lengths))
    check(f"correct: {TIER_SUBSET}-read subset on the CPU == the card's first rows",
          np.array_equal(w_cpu.numpy(), w_c[:TIER_SUBSET])
          and np.array_equal(n_cpu.numpy(), n_c[:TIER_SUBSET]))
    del sr, w_cpu, n_cpu

    # -- demux against a host argmin ------------------------------------------------------
    idx_d, dist_d = out["assign_barcodes (K1 + demux)"]
    d = (heads[:, None, :] != bcs[None, :, :]).sum(-1)
    best = d.min(1)
    n_best = (d == best[:, None]).sum(1)
    want_idx = np.where((best <= BC_MAX_DIST) & (n_best == 1), d.argmin(1), -1)
    check(f"assign_barcodes of {n} reads to {N_BARCODES} barcodes == host argmin (ties "
          "unassigned)", np.array_equal(idx_d, want_idx) and np.array_equal(dist_d, best),
          f"{int((idx_d >= 0).sum())} assigned, {int((idx_d == bc_of).sum())} to their own")
    ph["phase11_s"] = time.perf_counter() - t0
    print(f"  phase 11 in {ph['phase11_s']:.1f} s (inputs {ph['tier_write_s']:.1f} s, the path "
          f"{ph['tier_path_s']:.1f} s)", flush=True)


def true_slices(genome: np.ndarray, starts: np.ndarray, rev: np.ndarray) -> np.ndarray:
    """Each read's genome slice, reverse-complemented where it was drawn
    from the reverse strand."""
    t = np.lib.stride_tricks.sliding_window_view(genome, READ_LEN)[starts].copy()
    t[rev] = comp_table()[t[rev, ::-1]]
    return t


def same_outputs(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_outputs(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def int_mm_planes(torch, db):
    """The +-1 planes [D, 48W] int8 of a word-major database [W, D]: the
    operand of torch._int_mm, K6's library call, made in slices, untimed."""
    from bitnuc_tpu_torch.ops import hamming
    from bitnuc_tpu_torch.utils import bitops

    planes = torch.empty((db.shape[1], 48 * db.shape[0]), dtype=torch.int8, device=db.device)
    for d0 in range(0, db.shape[1], TC_SLICE):
        planes[d0 : d0 + TC_SLICE] = hamming._planes(
            bitops.unpack_words(db[:, d0 : d0 + TC_SLICE].t()))
    return planes


def load_other_tree(path: str):
    """The ``bitnuc_tpu_torch`` of the checkout in ``path``, imported as the
    package ``bnt_other``; it builds its own kernels at first use."""
    import importlib.util

    pkg = os.path.join(os.path.abspath(path), "bitnuc_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "bnt_other", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    sys.modules["bnt_other"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules["bnt_other"])
    return sys.modules["bnt_other"]


def finish_against(args, torch, res) -> int:
    """The end of an ``--*-against`` run: the card's name and power limit,
    then ``res`` as one JSON line (and in ``--out``); 1 if a check failed."""
    smi = nvidia_smi_line()
    res.update(ok=not FAILURES, device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(smi)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


def tree_modules(path: str, *names: str) -> list:
    """For each module ``name`` of the port, {"other": the checkout in
    ``path``'s (``load_other_tree``), "this": this checkout's}."""
    import importlib

    load_other_tree(path)
    return [{"other": importlib.import_module(f"bnt_other.{n}"),
             "this": importlib.import_module(f"bitnuc_tpu_torch.{n}")} for n in names]


def against(args, torch, rows, extra=None) -> int:
    """The body of an ``--*-against`` mode. ``rows`` is [(label, fns, want,
    bound_ms)]: ``fns`` maps "other" and "this" to each tree's call of the
    row, ``want`` makes the plain result both must equal (None: the two are
    held to each other), ``bound_ms`` is the row's bound or None. Each row's
    results are checked, then each tree's device operations and device ms
    by kernel of one call are read (torch.profiler, before any timing);
    then every row is timed in turns DIR, this, this, DIR. Prints a line a
    check and a timing, the card's name and power limit, and last one JSON
    object; returns 1 if a check failed."""
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1
    timer = Timer(torch)
    res = {"times_ms": {}, "checks": {}, "bound_ms": {}, "device_ops": {}, "passes_ms": {},
           **(extra or {})}
    for label, fns, want, bound in rows:
        got = {name: fn() for name, fn in fns.items()}
        if want is None:
            res["checks"][label] = check(f"{label}: this == other",
                                         max_abs_diff(got["this"], got["other"]) == 0)
        else:
            ref = want()
            for name in fns:
                res["checks"][f"{name} {label}"] = check(
                    f"{label} of {name} == plain", max_abs_diff(got[name], ref) == 0)
            del ref
        del got
        for name, fn in fns.items():
            key = f"{label} {name}"
            res["device_ops"][key] = ops = device_ops(torch, fn)
            res["passes_ms"][key] = passes = device_ms_by_kernel(torch, fn)
            print(f"  {key}: {ops} device operation(s) a call; device ms "
                  + (", ".join(f"{k} {v:.4f}" for k, v in passes.items()) or "not measured"),
                  flush=True)
        if bound is not None:
            res["bound_ms"][label] = bound
    for label, fns, _, bound in rows:
        for name in ("other", "this", "this", "other"):
            ms = timer(fns[name])
            res["times_ms"].setdefault(f"{label} {name}", []).append(ms)
            print(f"  {label} {name}: {ms:.4f} ms"
                  + (f" (bound {bound:.4f})" if bound is not None else ""), flush=True)
    return finish_against(args, torch, res)


def k6_against(args, torch, dev) -> int:
    """K6 of this checkout beside another's (``--k6-against DIR``): tc_scan,
    and tc_search at k = SEARCH_TOPK, at Q = SEARCH_QUERIES and 8 against
    DB_ENTRIES random entries of DB_BASES bases, each timed in turns DIR,
    this, this, DIR; torch._int_mm of the same planes at Q = SEARCH_QUERIES
    as the yardstick. Both trees' outputs are checked against this
    checkout's K5 and its top-k. Prints a line a timing, the card's name and
    power limit, and last one JSON object; returns 1 if a check failed."""
    import importlib

    from bitnuc_tpu_torch.ops import hamming

    load_other_tree(args.k6_against)
    trees = {"other": importlib.import_module("bnt_other.ops.hamming"), "this": hamming}
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1
    timer = Timer(torch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    W = DB_BASES // 16
    db = torch.randint(-(2**31), 2**31 - 1, (W, DB_ENTRIES), device=dev, generator=gen,
                       dtype=torch.int32)
    q_max = torch.randint(-(2**31), 2**31 - 1, (SEARCH_QUERIES, W), device=dev, generator=gen,
                          dtype=torch.int32)
    res = {"times_ms": {}, "checks": {}}
    for Q in (SEARCH_QUERIES, 8):
        q = q_max[:Q].contiguous()
        want = hamming.hdist_scan_kernel(q, db, DB_BASES)
        want_top = hamming.topk_batch_dispatch(want, SEARCH_TOPK)
        for name, h in trees.items():
            got = h.hdist_search_tc_kernel(q, db, DB_BASES, SEARCH_TOPK)
            res["checks"][f"{name} Q={Q}"] = check(
                f"K6 of {name} at Q={Q} == K5 and its top-k",
                torch.equal(h.hdist_scan_tc_kernel(q, db, DB_BASES), want)
                and all(torch.equal(x, y) for x, y in zip(got, want_top)))
        del want
        for kern in ("tc_scan", "tc_search"):
            for name in ("other", "this", "this", "other"):
                h = trees[name]
                fn = ((lambda: h.hdist_scan_tc_kernel(q, db, DB_BASES)) if kern == "tc_scan"
                      else (lambda: h.hdist_search_tc_kernel(q, db, DB_BASES, SEARCH_TOPK)))
                ms = timer(fn)
                res["times_ms"].setdefault(f"{kern} Q={Q} {name}", []).append(ms)
                print(f"  {kern} Q={Q} {name}: {ms:.4f} ms", flush=True)
    lib_q, lib_planes = hamming.query_planes(q_max, DB_BASES), int_mm_planes(torch, db)
    ms = timer(lambda: torch._int_mm(lib_q, lib_planes.t()))
    res["times_ms"][f"torch._int_mm Q={SEARCH_QUERIES}"] = [ms]
    print(f"  torch._int_mm Q={SEARCH_QUERIES}: {ms:.4f} ms", flush=True)
    return finish_against(args, torch, res)


def orf_shapes(torch, dev, seed: int) -> dict:
    """{label: (words, lengths)} of K10's timed shapes, made from ``seed``:
    (r) the kernel table's row, 262,144 random reads of 0..150 bp; (b)
    phase 8's read batch, 262,144 x 150 bp, scanned on both strands as
    longest_orf scans it; (c) phase 8's contigs, phase 6's genome (the same
    seed) cut into N_CONTIGS x CONTIG_BP; (l) 64 rows of 99,000..100,000 bp;
    mid-length reads, one strand: (s) 262,144 x 300 bp (W = 19) and (k)
    65,536 x 1,000 bp (W = 63), a thread a row, and (g) 16,384 x 4,000 bp
    (W = 250), a block a row."""
    from bitnuc_tpu_torch.ops import codec
    from bitnuc_tpu_torch.sequence import PackedReads

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)

    def rows(B, L, lens):
        a = acgt[torch.randint(0, 4, (B, L), device=dev, generator=gen)]
        return codec.encode_reads(a, lens)[0], lens

    def lens(B, lo, hi):
        return torch.randint(lo, hi + 1, (B,), device=dev, generator=gen, dtype=torch.int32)

    genome = make_genome(np.random.default_rng(seed + 1))
    contigs = PackedReads.from_ascii(genome[: N_CONTIGS * CONTIG_BP].reshape(
        N_CONTIGS, CONTIG_BP), validate=False, device=dev)
    long_lens = lens(64, 99_000, 100_000)
    long_lens[:2] = 100_000
    return {
        f"(r) [{READS},{READ_LEN}]": rows(READS, READ_LEN, lens(READS, 0, READ_LEN)),
        f"(b) [{ORF_BATCH},{READ_LEN}] full length": rows(
            ORF_BATCH, READ_LEN, lens(ORF_BATCH, READ_LEN, READ_LEN)),
        f"(c) [{N_CONTIGS},{CONTIG_BP}]": (contigs.words, contigs.lengths),
        "(l) [64,100000]": rows(64, 100_000, long_lens),
        **{f"({key}) [{B},{L}]": rows(B, L, lens(B, L, L))
           for key, B, L in (("s", READS, 300), ("k", 65_536, 1_000), ("g", 16_384, 4_000))},
    }


def orf_both(label: str) -> bool:
    """Whether an orf_shapes row is scanned on both strands."""
    return label.startswith("(b)")


def orf_bound(torch, words, lengths, strands: int):
    """(bytes, least ms of the operations) of K10 on ``strands`` strands:
    the words and lengths read once, (length, start, stopped) written once
    a strand; ORF_OPS_PER_WORD (ORF_TWO_STRAND_OPS_PER_WORD) a word the
    reads cover."""
    covered = int(torch.div(torch.clamp(lengths.long(), 0, 16 * words.shape[1]) + 15, 16,
                            rounding_mode="floor").sum())
    ops = ORF_OPS_PER_WORD if strands == 1 else ORF_TWO_STRAND_OPS_PER_WORD
    B = words.shape[0]
    return 4 * words.numel() + 4 * B + 9 * strands * B, ops * covered / INT32_OPS_PER_S * 1e3


def orf_against(args, torch, dev) -> int:
    """K10 of this checkout beside another's (``--orf-against DIR``): at each
    of ``orf_shapes``' rows one strand, or both as longest_orf scans them,
    and longest_orf of (b)'s batch, each timed in turns DIR, this, this,
    DIR, then the device time of each kernel of one longest_orf call of
    each tree (DIR's ops.orf needs best_orf_two_strands_kernel). Both
    trees' outputs are checked against this checkout's plain versions. Prints a line a timing, the card's name and power
    limit, and last one JSON object; returns 1 if a check failed."""
    import importlib

    from bitnuc_tpu_torch.ops import orf

    load_other_tree(args.orf_against)
    trees = {"other": importlib.import_module("bnt_other.ops.orf"), "this": orf}
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1
    timer = Timer(torch)
    res = {"times_ms": {}, "checks": {}, "bound_ms": {}}
    for label, (w, n) in orf_shapes(torch, dev, args.seed).items():
        both = orf_both(label)
        want = (orf.best_orf_two_strands_torch if both else orf.best_orf_one_strand_torch)(w, n)
        fns = {name: o.best_orf_two_strands_kernel if both else o.best_orf_one_strand_kernel
               for name, o in trees.items()}
        for name, fn in fns.items():
            res["checks"][f"{name} {label}"] = check(
                f"K10 of {name} at {label} == plain", max_abs_diff(fn(w, n), want) == 0)
        nbytes, ops_ms = orf_bound(torch, w, n, 2 if both else 1)
        res["bound_ms"][label] = max(nbytes / HBM_BYTES_PER_S * 1e3, ops_ms)
        rows = {label + (", both strands" if both else ", one strand"): fns}
        if both:
            rows["(b) longest_orf"] = {name: o.longest_orf for name, o in trees.items()}
            got = {name: fn(w, n) for name, fn in rows["(b) longest_orf"].items()}
            res["checks"]["longest_orf"] = check(
                "longest_orf of other == of this", max_abs_diff(got["other"], got["this"]) == 0)
        for row, row_fns in rows.items():
            for name in ("other", "this", "this", "other"):
                ms = timer(lambda: row_fns[name](w, n))
                res["times_ms"].setdefault(f"{row} {name}", []).append(ms)
                print(f"  {row} {name}: {ms:.4f} ms", flush=True)
        if both:  # where longest_orf's time goes: device ms a kernel
            for name, o in trees.items():
                passes = device_ms_by_kernel(torch, lambda: o.longest_orf(w, n))
                res.setdefault("longest_orf_passes_ms", {})[name] = passes
                print(f"  (b) longest_orf {name}, device ms a kernel (torch.profiler): "
                      + (", ".join(f"{k} {v:.4f}" for k, v in passes.items())
                         or "not measured"), flush=True)
    return finish_against(args, torch, res)


def pack_shapes(torch, dev, seed: int) -> dict:
    """{label: (ascii, lengths)} of K1's timed shapes, made from ``seed``:
    (b) phase 2's batch, READS reads of 1..READ_LEN bp in ACGTacgt with 1%
    N, the main row; (f) the same at full length, as the flagship step
    encodes its batch; (a) a batch of the streaming count, FASTQ_BATCH x
    READ_LEN bp of ACGT with N at 1/200 (phase 5's 16 launches); longer
    reads as long-read and amplicon users send them, (s) 262,144 x 300 bp,
    (k) 65,536 x 1,000 bp, (h) 16,384 x 4,000 bp; (l) 64 rows of 16,384 bp;
    (g) phase 6's genome (the same seed) as one row, as count_fasta encodes
    a segment; (u) (b) from its fourth row on, a base pointer 3 x READ_LEN
    bytes in, off 16-byte alignment. Rows 3 to 5 of (b) (so 0 to 2 of (u))
    and 0 to 2 of (l) have lengths -2, 0 and L + 7, and (g) L + 7, so the
    comparisons cover the clamp on both of the kernel's paths."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    acgt = torch.tensor(list(b"ACGTacgt"), dtype=torch.uint8, device=dev)

    def rows(B, L, cases, n_rate, shortest):
        a = acgt[torch.randint(0, cases, (B, L), device=dev, generator=gen)]
        a[torch.rand((B, L), device=dev, generator=gen) < n_rate] = ord("N")
        lens = torch.randint(shortest, L + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
        return a, lens

    def clamped(a_lens, first):
        a, lens = a_lens
        L = a.shape[1]
        lens[first:first + 3] = torch.tensor([-2, 0, L + 7], dtype=torch.int32, device=dev)
        return a, lens

    b = clamped(rows(READS, READ_LEN, 8, 0.01, 1), 3)
    genome = torch.from_numpy(make_genome(np.random.default_rng(seed + 1))).to(dev)
    return {
        f"(b) [{READS},{READ_LEN}]": b,
        f"(f) [{READS},{READ_LEN}] full length": rows(READS, READ_LEN, 8, 0.01, READ_LEN),
        f"(a) [{FASTQ_BATCH},{READ_LEN}]": rows(FASTQ_BATCH, READ_LEN, 4, 1 / 200, READ_LEN),
        "(s) [262144,300]": rows(262_144, 300, 4, 1 / 200, 300),
        "(k) [65536,1000]": rows(65_536, 1_000, 4, 1 / 200, 1_000),
        "(h) [16384,4000]": rows(16_384, 4_000, 4, 1 / 200, 4_000),
        "(l) [64,16384]": clamped(rows(64, 16_384, 4, 1 / 200, 16_384), 0),
        f"(g) [1,{GENOME_BP}]": (genome[None],
                                 torch.full((1,), GENOME_BP + 7, dtype=torch.int32, device=dev)),
        f"(u) [{READS - 3},{READ_LEN}] at byte {3 * READ_LEN}": (b[0][3:], b[1][3:]),
    }


def pack_bound(ascii_u8, n_words: int) -> tuple:
    """(bytes, least ms of the operations) of K1: the ASCII and the lengths
    read once, the words and first_bad written once; PACK_OPS_PER_BASE int32
    operations a base of the row."""
    B, L = ascii_u8.shape
    return (B * L + 4 * B * (n_words + 2),
            PACK_OPS_PER_BASE * B * L / INT32_OPS_PER_S * 1e3)


def device_ops(torch, fn) -> int:
    """Device operations (kernels, fills, copies) of one warm call of fn
    (``device_events``); 0 where the profiler sees none."""
    return sum(e.count for e in device_events(torch, fn))


def pack_against(args, torch, dev) -> int:
    """K1 of this checkout beside another's (``--pack-against DIR``), by
    ``against``: encode_reads_kernel at each of ``pack_shapes``' rows, held
    to this checkout's plain version, with K1's bound."""
    from bitnuc_tpu_torch.ops import codec

    (trees,) = tree_modules(args.pack_against, "ops.codec")
    rows = []
    for label, (a, n) in pack_shapes(torch, dev, args.seed).items():
        nbytes, ops_ms = pack_bound(a, codec._n_words(a.shape[1], None))
        rows.append((label, {name: (lambda c=c, a=a, n=n: c.encode_reads_kernel(a, n))
                             for name, c in trees.items()},
                     lambda a=a, n=n: codec.encode_reads_torch(a, n),
                     max(nbytes / HBM_BYTES_PER_S * 1e3, ops_ms)))
    return against(args, torch, rows)


def hist_rows(torch, dev, seed: int) -> list:
    """[(label, words, lengths, canonical, main)] of K3b's timed rows at k =
    8, made from ``seed``: (b) the flagship step's plain count and (c) its
    canonical count, on its batch (READS x READ_LEN bp of ACGT, made as
    entry.example_batch makes it), the main rows; (r) and (s) reads of 1 to
    READ_LEN bp, plain and canonical; (p) and (q) poly-A, every window one
    key, plain and canonical."""
    from bitnuc_tpu_torch import entry
    from bitnuc_tpu_torch.ops import codec

    ascii_np, lens_np, _ = entry.example_batch(READS, READ_LEN, 1, seed)
    lens = torch.from_numpy(lens_np).to(dev)
    words, _ = codec.encode_reads(torch.from_numpy(ascii_np).to(dev), lens)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 30)
    ragged = torch.randint(1, READ_LEN + 1, (READS,), device=dev, generator=gen,
                           dtype=torch.int32)
    poly_a = torch.zeros_like(words)
    shape = f"[{READS},{words.shape[1]}]"
    return [
        (f"(b) flagship {shape}", words, lens, False, True),
        (f"(c) flagship canonical {shape}", words, lens, True, True),
        (f"(r) reads of 1..{READ_LEN} bp {shape}", words, ragged, False, False),
        (f"(s) reads of 1..{READ_LEN} bp canonical {shape}", words, ragged, True, False),
        (f"(p) poly-A {shape}", poly_a, lens, False, False),
        (f"(q) poly-A canonical {shape}", poly_a, lens, True, False),
    ]


def hist_bound(words, lengths, k: int, canonical: bool) -> tuple:
    """(bytes, least ms of the operations) of K3b: the words and lengths read
    once, the [4^k] table written once; HIST_OPS_PER_WINDOW (or
    HIST_CANONICAL_OPS_PER_WINDOW) int32 operations a counted window."""
    W = words.shape[-1]
    windows = int((lengths.long().clamp(max=16 * W) - k + 1).clamp(min=0).sum())
    per = HIST_CANONICAL_OPS_PER_WINDOW if canonical else HIST_OPS_PER_WINDOW
    return (4 * words.numel() + 4 * lengths.numel() + 4 * 4**k,
            per * windows / INT32_OPS_PER_S * 1e3)


def hist_against(args, torch, dev) -> int:
    """K3b and the flagship step of this checkout beside another's
    (``--hist-against DIR``), by ``against``: count_kmers_dense at each of
    ``hist_rows``' rows at k = 8 and at HIST_PRIVATE_K (K3b, or the other
    tree's route for canonical counts), held to this checkout's plain
    version, with K3b's bound; then the warm flagship step (each tree's entry.forward on its
    own inputs made from the same seed), the two trees' outputs held to
    each other."""
    from bitnuc_tpu_torch import entry
    from bitnuc_tpu_torch.ops import kmer

    kmers, entries = tree_modules(args.hist_against, "ops.kmer", "entry")
    rows = []
    for k in (entry.K, HIST_PRIVATE_K):
        for label, w, n, canonical, _ in hist_rows(torch, dev, args.seed):
            nbytes, ops_ms = hist_bound(w, n, k, canonical)
            rows.append(((f"k={k} " if k != entry.K else "") + label,
                         {name: (lambda m=m, w=w, n=n, c=canonical, k=k:
                                 m.count_kmers_dense(w, n, k, c))
                          for name, m in kmers.items()},
                         lambda w=w, n=n, c=canonical, k=k:
                             kmer.histogram_from_words_torch(w, n, k, c),
                         max(nbytes / HBM_BYTES_PER_S * 1e3, ops_ms)))
    steps = {}
    for name, e in entries.items():
        fwd, inputs = e.entry(device=dev, batch=READS, read_len=READ_LEN, db_size=DB_ENTRIES,
                              seed=args.seed)
        steps[name] = (lambda fwd=fwd, inputs=inputs: fwd(*inputs))
    rows.append(("flagship step", steps, None, None))
    return against(args, torch, rows)


def unpack_shapes(torch, dev, seed: int) -> dict:
    """{label: (words, lengths, max_len)} of K2's timed shapes, random words
    made from ``seed``: (b) READS x READ_LEN bp with lengths 1..READ_LEN,
    the main row; (k) phase 6's decode, UNPACK_K_ROWS k-mers of 2-word
    rows at max_len 32 and length 21; full-length reads as long-read and
    amplicon users send them, (s) 262,144 x 300 bp and (h) 16,384 x 4,000
    bp; (l) 64 rows of 16,384 bp (segments); (u) (b) from its fourth row
    on, its words 3 x W x 4 bytes in, off 16-byte alignment. Rows 3 to 5
    of (b) (so 0 to 2 of (u)) have lengths -2, 0 and L + 7."""
    from bitnuc_tpu_torch.utils import bitops

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)

    def rows(B, L, shortest, W=None):
        W = bitops.n_words_for(L) if W is None else W
        words = torch.randint(-(2**31), 2**31 - 1, (B, W), device=dev, generator=gen,
                              dtype=torch.int32)
        lens = torch.randint(shortest, L + 1, (B,), device=dev, generator=gen, dtype=torch.int32)
        return words, lens, L

    b = rows(READS, READ_LEN, 1)
    b[1][3:6] = torch.tensor([-2, 0, READ_LEN + 7], dtype=torch.int32, device=dev)
    W = b[0].shape[1]
    return {
        f"(b) [{READS},{READ_LEN}]": b,
        f"(k) [{UNPACK_K_ROWS},32] W=2, lengths 21": rows(UNPACK_K_ROWS, LARGE_K, LARGE_K, 2)[:2]
        + (32,),
        "(s) [262144,300]": rows(262_144, 300, 300),
        "(h) [16384,4000]": rows(16_384, 4_000, 4_000),
        "(l) [64,16384]": rows(64, 16_384, 16_384),
        f"(u) [{READS - 3},{READ_LEN}] at byte {3 * W * 4}": (b[0][3:], b[1][3:], READ_LEN),
    }


def unpack_bound(words, max_len: int) -> int:
    """Bytes K2 must move: the words and lengths read once, the [B, max_len]
    letters written once."""
    B, W = words.shape
    return 4 * B * W + 4 * B + B * max_len


def unpack_against(args, torch, dev) -> int:
    """K2 of this checkout beside another's (``--unpack-against DIR``), by
    ``against``: decode_reads_kernel at each of ``unpack_shapes``' rows,
    held to this checkout's plain version, with K2's bound."""
    from bitnuc_tpu_torch.ops import codec

    (trees,) = tree_modules(args.unpack_against, "ops.codec")
    rows = []
    for label, (w, n, ml) in unpack_shapes(torch, dev, args.seed).items():
        rows.append((label, {name: (lambda c=c, w=w, n=n, ml=ml: c.decode_reads_kernel(w, n, ml))
                             for name, c in trees.items()},
                     lambda w=w, n=n, ml=ml: codec.decode_reads_torch(w, n, ml),
                     unpack_bound(w, ml) / HBM_BYTES_PER_S * 1e3))
    return against(args, torch, rows)


def chain_breakdown(torch, anchors, kw) -> dict:
    """ms of C1 at a chunk's anchors beside variants that take parts of its
    work away: max_gap 0 (no slot ever qualifies: one maximum a step, not
    five), every valid anchor dead (r = 2^30: the reads and the compaction
    alone), the rows in order of their live counts, longest first; and the
    chunk's longest row alone, 132 times (one an SM) and 1,848 times (a
    warp of every row slot of the card)."""
    from bitnuc_tpu_torch.ops import chain

    timer = Timer(torch)
    rpos, qpos, valid = anchors
    n = (valid & (rpos < chain._BIG)).sum(1)
    order = torch.argsort(n, descending=True)
    by_count = tuple(x[order].contiguous() for x in anchors)
    dead = torch.where(valid, chain._BIG, rpos)
    i = int(order[0])
    out = {"chunk": timer(lambda: chain.chain_anchors(*anchors, *kw)),
           "max_gap 0": timer(lambda: chain.chain_anchors(*anchors, 0, *kw[1:])),
           "every anchor dead": timer(lambda: chain.chain_anchors(dead, qpos, valid, *kw)),
           "rows longest first": timer(lambda: chain.chain_anchors(*by_count, *kw))}
    del by_count, dead
    for copies in (1, 132, 1848):
        rows = tuple(x[i : i + 1].expand(copies, -1).contiguous() for x in anchors)
        out[f"longest row ({int(n[i])} live) x {copies}"] = timer(
            lambda: chain.chain_anchors(*rows, *kw))
        del rows
    for label, ms in out.items():
        print(f"  C1 breakdown, {label}: {ms:.4f} ms", flush=True)
    return out


def chain_against(args, torch, dev) -> int:
    """chain_anchors of this checkout beside another's (``--chain-against
    DIR``; in a checkout whose C1 scans sorted rows, that checkout's
    sort_anchors and chain_sorted_kernel), by ``against``: at the anchors of
    phase 10's first map_reads_long chunk (its long reads on phase 6's
    genome, phase 7's index), held to this checkout's plain version, with
    this checkout's bound; and the chunk's live anchors a row."""
    from bitnuc_tpu_torch import mapper
    from bitnuc_tpu_torch.ops import chain
    from bitnuc_tpu_torch.sequence import PackedReads

    (trees,) = tree_modules(args.chain_against, "ops.chain")
    genome = make_genome(np.random.default_rng(args.seed + 1))
    index = mapper.MinimizerIndex.build_multi([genome.tobytes()], k=MAP_K, w=MAP_W,
                                              max_occ=MAP_OCC, device=dev)
    long_reads = make_long_reads(np.random.default_rng(args.seed + 10), genome, LONG_READS)[0]
    packed = PackedReads.from_ascii(long_reads, validate=False, device=dev)
    chunk = mapper._long_chunk(packed.words.shape[1], index, False, 32)
    anchors = long_anchors(torch, mapper, index, packed.words[:chunk], packed.lengths[:chunk])
    del packed, index
    kw = (2048, 16, 64)
    live_rows, slots, nbytes = chain_work(torch, anchors[0], anchors[2], 64)
    n_max = int(live_rows.max())
    print(f"  [{anchors[0].shape[0]}, {anchors[0].shape[1]}] anchors of a chunk of {chunk} reads: "
          f"{int(live_rows.sum())} live, largest {n_max} and median {int(live_rows.median())} "
          f"a row", flush=True)

    def other():
        o = trees["other"]
        if hasattr(o, "chain_sorted_kernel"):
            r, q = o.sort_anchors(*anchors)
            return o.chain_sorted_kernel(r.contiguous(), q.contiguous(), *kw)
        return o.chain_anchors(*anchors, *kw)

    breakdown = chain_breakdown(torch, anchors, kw)
    label = f"[{anchors[0].shape[0]}, {anchors[0].shape[1]}] a chunk of {chunk} long reads"
    want = lambda: chain.chain_anchors_torch(*anchors, *kw)  # noqa: E731
    bound = chain_bound_ms(nbytes, slots)
    rows = [(label, {"other": other, "this": lambda: trees["this"].chain_anchors(*anchors, *kw)},
             want, bound)]
    return against(args, torch, rows, {"breakdown_ms": breakdown})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full results here as JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k6-against", metavar="DIR",
                    help="only time K6 beside another checkout's (see k6_against)")
    ap.add_argument("--orf-against", metavar="DIR",
                    help="only time K10 beside another checkout's (see orf_against)")
    ap.add_argument("--pack-against", metavar="DIR",
                    help="only time K1 beside another checkout's (see pack_against)")
    ap.add_argument("--hist-against", metavar="DIR",
                    help="only time K3b and the flagship step beside another checkout's "
                         "(see hist_against)")
    ap.add_argument("--unpack-against", metavar="DIR",
                    help="only time K2 beside another checkout's (see unpack_against)")
    ap.add_argument("--chain-against", metavar="DIR",
                    help="only time chain_anchors (C1) beside another checkout's "
                         "(see chain_against)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing ran", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import bitnuc_tpu_torch as bnt
        from bitnuc_tpu_torch import config, entry, kernels, pipeline
        from bitnuc_tpu_torch.database import PackedDB, SEARCH_TC_MIN_Q, tc_min_q
        from bitnuc_tpu_torch.kernels import _build, build_time
        from bitnuc_tpu_torch.ops import codec, hamming, kmer, merge, orf, setops
        from bitnuc_tpu_torch.utils import bitops
    except ImportError as e:
        print(f"chip_smoke: cannot import bitnuc_tpu_torch ({e}); run from a checkout",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        print("chip_smoke: jax was imported", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    if args.k6_against:
        return k6_against(args, torch, dev)
    if args.orf_against:
        return orf_against(args, torch, dev)
    if args.pack_against:
        return pack_against(args, torch, dev)
    if args.hist_against:
        return hist_against(args, torch, dev)
    if args.unpack_against:
        return unpack_against(args, torch, dev)
    if args.chain_against:
        return chain_against(args, torch, dev)
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
    # K1's, K2's, K3a's, K6's, K7's, K8/K9's, K10's and C1's registers, shared
    # memory and spills: nvcc -Xptxas -v of pack.cu, unpack.cu, histogram.cu,
    # tcscan.cu, merge.cu, wavefront.cu, orf.cu and chain.cu
    with tempfile.TemporaryDirectory() as d:
        ptxas = build_time.ptxas_report(
            Path(d), ("pack.cu", "unpack.cu", "histogram.cu", "tcscan.cu", "merge.cu",
                      "wavefront.cu", "orf.cu", "chain.cu"))
    for src, lines in sorted(ptxas.items()):
        for line in lines:
            print(f"  ptxas {src}: {line}", flush=True)
        results["phases"][f"ptxas_{Path(src).stem}"] = lines
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

    def timed(name, label, kern, plain, reps=5, plain_reps=3, main=False, nbytes=0,
              ops_ms=0.0, library=None):
        """Time a kernel and its plain version. The bound comes from the
        bytes it must move (``nbytes``) and its operations' least time
        (``ops_ms``). ``main`` marks the shape that the summary line reports
        for the kernel; there ``library`` is the one PyTorch call that
        computes the same function, where there is one (timed, never used
        by the port)."""
        ms, pms = timer(kern, reps), timer(plain, plain_reps)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": label, "ms": ms, "plain_ms": pms, "main": main,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        extra = f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})" if row["bound_ms"] else ""
        if main:
            row["library_ms"] = timer(library, reps) if library else None
            if library:
                extra += f", library call {row['library_ms']:.4f} ms"
        timings[name].append(row)
        print(f"    {name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} ms{extra}", flush=True)
        return row

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
    for B, L in [(1, 1), (5, 33), (3, 1000)]:
        a, ln = reads(B, L, 0.05)
        compare("pack", f"[{B},{L}]", codec.encode_reads_kernel(a, ln),
                codec.encode_reads_torch(a, ln))
    # K1 at its launches' shapes, (b) the main row; the launches of one call
    # (the wrapper's count) and its device operations (torch.profiler)
    for label, (a, ln) in pack_shapes(torch, dev, args.seed).items():
        compare("pack", label, codec.encode_reads_kernel(a, ln), codec.encode_reads_torch(a, ln))
        before = kernels.LAUNCHES["pack"]
        ops = device_ops(torch, lambda: codec.encode_reads_kernel(a, ln))
        print(f"    pack {label}: {(kernels.LAUNCHES['pack'] - before) // 2} launch(es) "
              f"a call, {ops} device operation(s)", flush=True)
        nbytes, ops_ms = pack_bound(a, bitops.n_words_for(a.shape[1]))
        timed("pack", label, lambda: codec.encode_reads_kernel(a, ln),
              lambda: codec.encode_reads_torch(a, ln), main=label.startswith("(b)"),
              nbytes=nbytes, ops_ms=ops_ms)
    del a, ln

    def time_hist_keys(label, keys, k, main=False):
        timed("hist_keys", label,
              lambda: kmer.histogram_from_keys_kernel(keys, k),
              lambda: kmer.histogram_from_keys_torch(keys, k),
              main=main, nbytes=4 * keys.numel() + 4 * 4**k,
              ops_ms=2 * keys.numel() / INT32_OPS_PER_S * 1e3,
              library=lambda: torch.bincount(keys, minlength=4**k + 1))

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
                    if k == STREAM_K:
                        keys_c = keys
                    else:
                        time_hist_keys(label, keys, k)
                del lo, v, keys
    print(f"    ({n_windows} windows of k = 8 in the batch)", flush=True)

    # K3a at the main paths' shapes: (a) a batch of the streaming count
    # (FASTQ_BATCH x READ_LEN uppercase ACGT, N at 1/200, k = 12 canonical
    # N-skip), the main row; (b) an edge row, the flagship step's canonical
    # k = 8 keys (READS x READ_LEN, no N; the step counts them in K3b); (c) the batch above at k = 12; (d) (c)'s keys
    # masked to k = 11 (16 MiB of bins against 64 MiB), sentinels kept; (e)
    # poly-A: (a)'s and (b)'s valid keys all 0
    def full_reads(B, n_rate):
        a = acgt[torch.randint(0, 4, (B, READ_LEN), device=dev, generator=gen)]
        a[torch.rand((B, READ_LEN), device=dev, generator=gen) < n_rate] = ord("N")
        ln = torch.full((B,), READ_LEN, dtype=torch.int32, device=dev)
        w, _ = codec.encode_reads_kernel(a, ln)
        return w, ln, codec.validity_mask(a, ln)

    w, ln, ok = full_reads(FASTQ_BATCH, 1 / 200)
    lo, _, v = kmer._window_keys(w, ln, STREAM_K, True, ok)
    keys_a = torch.where(v, lo, 4**STREAM_K).reshape(-1).contiguous()
    w, ln, _ = full_reads(READS, 0.0)
    lo, _, v = kmer._window_keys(w, ln, entry.K, True)
    keys_b = torch.where(v, lo, 4**entry.K).reshape(-1).contiguous()
    del w, ln, ok, lo, v
    keys_d = torch.where(keys_c < 4**STREAM_K, keys_c & (4**11 - 1), 4**11)
    for label, keys, k in (
        ("(a) count batch", keys_a, STREAM_K),
        ("(b) edge: flagship canonical keys", keys_b, entry.K),
        ("(c) reads of 1..150 bp", keys_c, STREAM_K),
        ("(d) (c) at k = 11", keys_d, 11),
        ("(e) poly-A count batch", keys_a.clamp(max=4**STREAM_K) & 4**STREAM_K, STREAM_K),
        ("(e) poly-A flagship", keys_b.clamp(max=4**entry.K) & 4**entry.K, entry.K),
    ):
        label = (f"{label} k={k} N={keys.numel()} "
                 f"valid={int(((keys >= 0) & (keys < 4**k)).sum())}")
        compare("hist_keys", label, kmer.histogram_from_keys_kernel(keys, k),
                kmer.histogram_from_keys_torch(keys, k))
        time_hist_keys(label, keys, k, main=keys is keys_a)
        if keys is keys_a or keys is keys_b:
            print_passes(torch, results, "hist_keys", label,
                         lambda: kmer.histogram_from_keys_kernel(keys, k))
    del keys_a, keys_b, keys_c, keys_d, keys

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

    def time_merge(label, a, b, main=False, library=None, passes=False):
        na, nb = int(a[0].numel()), int(b[0].numel())
        label = f"{label} n_keys=3 payloads=1 {na}+{nb}"
        compare("merge", label, merge.merge_sorted_kernel(a, b, 3, (0,)),
                merge.merge_sorted_torch(a, b, 3, (0,)))
        timed("merge", label, lambda: merge.merge_sorted_kernel(a, b, 3, (0,)),
              lambda: merge.merge_sorted_torch(a, b, 3, (0,)), main=main,
              nbytes=(na + nb) * 4 * 4 + merge.next_pow2(na + nb) * 4 * 4,
              ops_ms=MERGE_OPS_PER_ROW * (na + nb) / INT32_OPS_PER_S * 1e3,
              library=library)
        if passes:
            print_passes(torch, results, "merge", label,
                         lambda: merge.merge_sorted_kernel(a, b, 3, (0,)))
        return label

    # K7 at combine_counts' shapes (hi, lo, source; count): (m) two lists of
    # MERGE_ROWS, the main row; (s) phase 6's set operation, 7,700,000 +
    # 5,000,000 rows and 4,077,216 of padding; (l) a lopsided merge, whole
    # tiles from one list; (t) all ties, every key word equal and the
    # payload the global row index, so the output's payload is 0, 1, 2, ...
    for label, na, nb in (("(s) set operation", 7_700_000, 5_000_000),
                          ("(l) lopsided", MERGE_ROWS, 65_536)):
        time_merge(label, sorted_cols(na, 3, 1, False, src=0),
                   sorted_cols(nb, 3, 1, False, src=1), passes=na + nb == 12_700_000)
    tie_key = (123, -(2**31), 1)
    a = [torch.full((MERGE_ROWS,), x, dtype=torch.int32, device=dev) for x in tie_key]
    b = [torch.full((MERGE_ROWS,), x, dtype=torch.int32, device=dev) for x in tie_key]
    a.append(torch.arange(MERGE_ROWS, dtype=torch.int32, device=dev))
    b.append(torch.arange(MERGE_ROWS, 2 * MERGE_ROWS, dtype=torch.int32, device=dev))
    time_merge("(t) all ties", a, b)
    order = merge.merge_sorted_kernel(a, b, 3, (0,))[3]
    check("merge (t): all ties keep the stable order (payload == row index)",
          torch.equal(order, torch.arange(2 * MERGE_ROWS, dtype=torch.int32, device=dev)))
    del order
    a = sorted_cols(MERGE_ROWS, 3, 1, False, src=0)
    b = sorted_cols(MERGE_ROWS, 3, 1, False, src=1)
    # the library call: a stable torch.sort of the concatenated keys and a
    # gather of every column. The lists' third key word is their source (0
    # for a, 1 for b), so the stable sort of the (hi, lo) word pair, made
    # here untimed as one int64 key, orders the rows as the three words do.
    key_cat = torch.cat([bitops.u64_sort_key(a[0], a[1]), bitops.u64_sort_key(b[0], b[1])])
    cols_cat = [torch.cat([x, y]) for x, y in zip(a, b)]

    def merge_library():
        perm = torch.sort(key_cat, stable=True).indices
        return tuple(c[perm] for c in cols_cat)

    label = time_merge("(m) main", a, b, main=True, library=merge_library, passes=True)
    compare("merge", f"{label}: torch.sort(stable) of the concatenation + gather",
            merge_library(), merge.merge_sorted_kernel(a, b, 3, (0,)))
    del a, b, key_cat, cols_cat

    long_ascii, _ = reads(64, 16_384, 0.0)
    long_lens = torch.full((64,), 16_384, dtype=torch.int32, device=dev)
    long_words, _ = codec.encode_reads_kernel(long_ascii, long_lens)
    # K3b at both flags: k = 1 to 12 on phase 2's reads and on 64 rows of
    # 16,384 bp; random words with lengths -2, 0, k - 1, 16 W and 16 W + 7 and
    # rows of ACGT repeats, poly-A and poly-T; then hist_rows, (b) and (c)
    # the flagship's two launches, the main rows
    edge_words = torch.randint(-(2**31), 2**31 - 1, (11, 3), device=dev, generator=gen,
                               dtype=torch.int32)
    edge_words[-3:] = torch.tensor([[0xE4E4E4E4 - 2**32], [0], [-1]], dtype=torch.int32)

    def time_hist_words(label, w, ln, k, canonical, main=False):
        nbytes, ops_ms = hist_bound(w, ln, k, canonical)
        timed("hist_words", label,
              lambda: kmer.histogram_from_words_kernel(w, ln, k, canonical),
              lambda: kmer.histogram_from_words_torch(w, ln, k, canonical),
              main=main, nbytes=nbytes, ops_ms=ops_ms)

    for k in (1, 4, 7, 8, 9, 12):
        edge_lens = torch.tensor([-2, 0, k - 1, 48, 55, 17, 30, 45, 55, 48, 47],
                                 dtype=torch.int32, device=dev)
        for canonical in (False, True):
            for label, w, ln in (
                (f"k={k} canonical={int(canonical)} [{READS},{words_b.shape[1]}]",
                 words_b, lens_b),
                (f"k={k} canonical={int(canonical)} [64,{long_words.shape[1]}]",
                 long_words, long_lens),
                (f"k={k} canonical={int(canonical)} edge lengths [11,3]",
                 edge_words, edge_lens),
            ):
                compare("hist_words", label,
                        kmer.histogram_from_words_kernel(w, ln, k, canonical),
                        kmer.histogram_from_words_torch(w, ln, k, canonical))
                if w is not edge_words:
                    time_hist_words(label, w, ln, k, canonical)
    for label, w, ln, canonical, main in hist_rows(torch, dev, args.seed):
        label = f"{label} k={entry.K}"
        compare("hist_words", label, kmer.histogram_from_words_kernel(w, ln, entry.K, canonical),
                kmer.histogram_from_words_torch(w, ln, entry.K, canonical))
        time_hist_words(label, w, ln, entry.K, canonical, main)
    del w, ln, edge_words, edge_lens

    # K2 at its launches' shapes (unpack_shapes; (b) the main row), the
    # launches of one call (the wrapper's count) and its device operations;
    # then edge shapes (lengths past max_len, max_len past the capacity 16 *
    # W, zero and negative lengths)
    for label, (w, ln, ml) in unpack_shapes(torch, dev, args.seed).items():
        compare("unpack", label, codec.decode_reads_kernel(w, ln, ml),
                codec.decode_reads_torch(w, ln, ml))
        before = kernels.LAUNCHES["unpack"]
        ops = device_ops(torch, lambda: codec.decode_reads_kernel(w, ln, ml))
        print(f"    unpack {label}: {(kernels.LAUNCHES['unpack'] - before) // 2} launch(es) "
              f"a call, {ops} device operation(s)", flush=True)
        timed("unpack", label, lambda: codec.decode_reads_kernel(w, ln, ml),
              lambda: codec.decode_reads_torch(w, ln, ml), main=label.startswith("(b)"),
              nbytes=unpack_bound(w, ml))
    del w, ln
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
    q_max = torch.randint(-(2**31), 2**31 - 1, (max(TC_SWEEP_Q), W_db), device=dev,
                          generator=gen, dtype=torch.int32)
    db_small = db[:, :1000].contiguous()

    def scan_bounds(Q, nb):
        """K4/K5's bytes, and the busier of its two units: a popcount and
        four int32 operations per (query, word, entry)."""
        n_w = -(-nb // 16)  # words a distance reads per entry
        return dict(nbytes=4 * n_w * DB_ENTRIES + 4 * Q * n_w + 4 * Q * DB_ENTRIES,
                    ops_ms=max(Q * DB_ENTRIES * n_w / POPC_PER_S,
                               4 * Q * DB_ENTRIES * n_w / INT32_OPS_PER_S) * 1e3)

    # K4 (Q = 1) and K5 (Q > 1): one kernel, counted and reported apart
    for nb in (512, 150, 7):
        for Q in (1, 64):
            name = "hdist_scan" if Q == 1 else "hdist_scan_batch"
            q = q_max[:Q].contiguous()
            label = f"Q={Q} D={DB_ENTRIES} n_bases={nb}"
            compare(name, label, hamming.hdist_scan_kernel(q, db, nb),
                    hamming.hdist_scan_torch(q, db, nb))
            if nb in (512, 150):
                timed(name, label, lambda: hamming.hdist_scan_kernel(q, db, nb),
                      lambda: hamming.hdist_scan_torch(q, db, nb),
                      main=nb == DB_BASES, **scan_bounds(Q, nb))
        for Q, d in ((3, db), (64, db_small), (3, db_small)):
            q = q_max[:Q].contiguous()
            compare("hdist_scan_batch", f"Q={Q} D={d.shape[1]} n_bases={nb}",
                    hamming.hdist_scan_kernel(q, d, nb), hamming.hdist_scan_torch(q, d, nb))

    # K6 against K5 on the full database at each swept Q, at 512-base
    # entries and at 150-base ones (W = 10, a read set): this feeds
    # database.tc_min_q. Then K6 against its plain version on a slice, and
    # at edge shapes; timed beside torch._int_mm of the same planes at
    # phase 8's Q
    sweep = {}
    for nb in (DB_BASES, READ_LEN):
        d = db[: bitops.n_words_for(nb)].contiguous() if nb < DB_BASES else db
        sweep[nb] = {}
        for Q in TC_SWEEP_Q:
            q = q_max[:Q, : d.shape[0]].contiguous()
            compare("tc_scan", f"Q={Q} D={DB_ENTRIES} n_bases={nb} against K5",
                    hamming.hdist_scan_tc_kernel(q, d, nb), hamming.hdist_scan_kernel(q, d, nb))
            k5 = timer(lambda: hamming.hdist_scan_kernel(q, d, nb))
            k6 = timer(lambda: hamming.hdist_scan_tc_kernel(q, d, nb))
            sweep[nb][Q] = {"k5_ms": k5, "k6_ms": k6}
            print(f"    sweep Q={Q} D={DB_ENTRIES} n_bases={nb}: K5 {k5:.4f} ms, K6 {k6:.4f} ms",
                  flush=True)
        faster = [Q for Q in TC_SWEEP_Q if sweep[nb][Q]["k6_ms"] < sweep[nb][Q]["k5_ms"]]
        print(f"    n_bases={nb}: K6 faster at Q = {faster} (tc_min_q = "
              f"{tc_min_q(d.shape[0])})", flush=True)
        del d
    results["phases"]["tc_sweep_ms"] = sweep
    check("K6 beats K5 at Q = 512", sweep[DB_BASES][512]["k6_ms"] < sweep[DB_BASES][512]["k5_ms"],
          f"{sweep[DB_BASES][512]['k6_ms']:.3f} against {sweep[DB_BASES][512]['k5_ms']:.3f} ms")
    q = q_max[:SEARCH_QUERIES].contiguous()
    d_slice = db[:, :TC_SLICE].contiguous()
    compare("tc_scan", f"Q={SEARCH_QUERIES} D={TC_SLICE}", hamming.hdist_scan_tc_kernel(q, d_slice, 512),
            hamming.hdist_scan_tc_torch(q, d_slice, 512))
    del d_slice
    for Q in (1, 9, 130, 257):  # each query-tile width and the walk past 256
        for W in (1, 9, 33, 64):
            dw = torch.randint(-(2**31), 2**31 - 1, (W, 5000), device=dev, generator=gen,
                               dtype=torch.int32)
            qw = torch.randint(-(2**31), 2**31 - 1, (Q, W), device=dev, generator=gen,
                               dtype=torch.int32)
            for nb in (0, 137, 16 * W):
                got = hamming.hdist_scan_tc_kernel(qw, dw, nb)
                compare("tc_scan", f"Q={Q} W={W} D=5000 n_bases={nb}", got,
                        hamming.hdist_scan_tc_torch(qw, dw, nb))
                compare("tc_scan", f"Q={Q} W={W} D=5000 n_bases={nb} against K5", got,
                        hamming.hdist_scan_kernel(qw, dw, nb))
    lib_planes = int_mm_planes(torch, db)
    lib_q = hamming.query_planes(q, 512)
    compare("tc_scan", f"torch._int_mm core Q={SEARCH_QUERIES} (affine step applied)",
            torch.div(3 * 512 - torch._int_mm(lib_q, lib_planes.t()), 4, rounding_mode="floor"),
            hamming.hdist_scan_tc_kernel(q, db, 512))
    timed("tc_scan", f"Q={SEARCH_QUERIES} D={DB_ENTRIES} n_bases=512",
          lambda: hamming.hdist_scan_tc_kernel(q, db, 512),
          lambda: hamming.hdist_scan_tc_torch(q, db, 512), reps=5, plain_reps=1, main=True,
          nbytes=4 * W_db * DB_ENTRIES + SEARCH_QUERIES * 48 * W_db + 4 * SEARCH_QUERIES * DB_ENTRIES,
          ops_ms=2 * SEARCH_QUERIES * DB_ENTRIES * 48 * W_db / INT8_TC_OPS_PER_S * 1e3,
          library=lambda: torch._int_mm(lib_q, lib_planes.t()))

    # tc_search: K6's main loop with a per-block top-k. Against its plain
    # version on the slice, against tc_scan + topk_batch_dispatch on the
    # whole database, at edge shapes, on a database of one repeated entry
    # (every distance ties), and timed beside the library composition:
    # torch._int_mm of the same planes, the affine step, the top-k
    kmax = hamming.SEARCH_TOPK_MAX
    d_slice = db[:, :TC_SLICE].contiguous()
    compare("tc_search", f"Q={SEARCH_QUERIES} D={TC_SLICE} k={SEARCH_TOPK}",
            hamming.hdist_search_tc_kernel(q, d_slice, 512, SEARCH_TOPK),
            hamming.hdist_search_tc_torch(q, d_slice, 512, SEARCH_TOPK))
    del d_slice
    for k in (1, SEARCH_TOPK, kmax):
        compare("tc_search", f"Q={SEARCH_QUERIES} D={DB_ENTRIES} k={k} against tc_scan + top-k",
                hamming.hdist_search_tc_kernel(q, db, 512, k),
                hamming.topk_batch_dispatch(hamming.hdist_scan_tc_kernel(q, db, 512), k, 512))
    for Q in (1, 9, 130, 257):
        for W in (1, 9, 33, 64):
            for D in (5, 5000):
                dw = torch.randint(-(2**31), 2**31 - 1, (W, D), device=dev, generator=gen,
                                   dtype=torch.int32)
                qw = torch.randint(-(2**31), 2**31 - 1, (Q, W), device=dev, generator=gen,
                                   dtype=torch.int32)
                cases = [(nb, k) for nb in (0, 137, 16 * W) for k in (1, SEARCH_TOPK, kmax)]
                compare("tc_search", f"Q={Q} W={W} D={D}, n_bases 0, 137, 16W x k 1, "
                        f"{SEARCH_TOPK}, {kmax}",
                        [hamming.hdist_search_tc_kernel(qw, dw, nb, k) for nb, k in cases],
                        [hamming.hdist_search_tc_torch(qw, dw, nb, k) for nb, k in cases])
    for D in (130, 300_000):  # one repeated entry: entries 0..k-1 win every row
        rep_db = db[:, :1].expand(W_db, D).contiguous()
        got = hamming.hdist_search_tc_kernel(q_max[:130].contiguous(), rep_db, 512, SEARCH_TOPK)
        compare("tc_search", f"ties: Q=130 D={D} one repeated entry", got,
                hamming.hdist_search_tc_torch(q_max[:130].contiguous(), rep_db, 512, SEARCH_TOPK))
        check(f"tc_search ties at D={D} go to the lowest indices",
              bool((got[1] == torch.arange(SEARCH_TOPK, device=dev)).all()))
    del rep_db

    def search_library():
        s_lib = torch._int_mm(lib_q, lib_planes.t())
        return hamming.topk_batch_dispatch(torch.div(3 * 512 - s_lib, 4, rounding_mode="floor"),
                                           SEARCH_TOPK, 512)

    compare("tc_search", f"torch._int_mm + top-k Q={SEARCH_QUERIES} k={SEARCH_TOPK}",
            search_library(), hamming.hdist_search_tc_kernel(q, db, 512, SEARCH_TOPK))
    timed("tc_search", f"Q={SEARCH_QUERIES} D={DB_ENTRIES} n_bases=512 k={SEARCH_TOPK}",
          lambda: hamming.hdist_search_tc_kernel(q, db, 512, SEARCH_TOPK),
          lambda: hamming.hdist_search_tc_torch(q, db, 512, SEARCH_TOPK), reps=5, plain_reps=1,
          main=True,
          nbytes=4 * W_db * DB_ENTRIES + SEARCH_QUERIES * 48 * W_db + 8 * SEARCH_QUERIES * SEARCH_TOPK,
          ops_ms=2 * SEARCH_QUERIES * DB_ENTRIES * 48 * W_db / INT8_TC_OPS_PER_S * 1e3,
          library=search_library)
    del lib_planes, lib_q

    # search_batch's two routes at each swept Q, k = 10: tc_search against
    # distances_batch + topk_batch_dispatch, at 512- and 150-base entries.
    # This feeds database.SEARCH_TC_MIN_Q.
    search_sweep = {}
    for nb in (DB_BASES, READ_LEN):
        d = db[: bitops.n_words_for(nb)].contiguous() if nb < DB_BASES else db
        pdb = PackedDB(d, nb)
        search_sweep[nb] = {}
        for Q in SEARCH_SWEEP_Q:
            qq = q_max[:Q, : d.shape[0]].contiguous()
            fused = lambda: hamming.hdist_search_tc_kernel(qq, d, nb, SEARCH_TOPK)
            two_step = lambda: hamming.topk_batch_dispatch(pdb.distances_batch(qq), SEARCH_TOPK, nb)
            compare("tc_search", f"Q={Q} n_bases={nb} k={SEARCH_TOPK} against the two-step route",
                    fused(), two_step())
            t2, tf = timer(two_step, 3), timer(fused, 3)
            search_sweep[nb][Q] = {"two_step_ms": t2, "fused_ms": tf}
            print(f"    search sweep Q={Q} D={DB_ENTRIES} n_bases={nb}: two-step {t2:.4f} ms, "
                  f"fused {tf:.4f} ms", flush=True)
        faster = [Q for Q in SEARCH_SWEEP_Q
                  if search_sweep[nb][Q]["fused_ms"] < search_sweep[nb][Q]["two_step_ms"]]
        print(f"    n_bases={nb}: fused faster at Q = {faster} (SEARCH_TC_MIN_Q = "
              f"{SEARCH_TC_MIN_Q})", flush=True)
        del d, pdb
    results["phases"]["search_sweep_ms"] = search_sweep
    del q_max, db_small

    # K10: its timed shapes (orf_shapes: (r) the table's row, (b) phase 8's
    # batch on both strands, the main row, as longest_orf launches it; (c)
    # phase 8's contigs, (l) rows of 100,000 bp, past the TPU's 32,767; (s),
    # (k), (g) reads of 300, 1,000 and 4,000 bp), and edge shapes: W = 1, lengths 0, 1, 2, 16 W
    # and not multiples of 3, no ATG, all stops, nested starts sharing a stop
    orf_rows = orf_shapes(torch, dev, args.seed)
    orf_cases = [(label, w, n) for label, (w, n) in orf_rows.items()]
    for label, seqs in (("W=1 edge lengths", [b"", b"A", b"AT", b"ATG", b"ATGT", b"ATGTAA",
                                              b"ATGAAAAAAAAAAAAA", b"TTTATGATGAAATGAA"]),
                        ("W=2 motifs", [b"TTTATGATGAAATGAAAATAG", b"TAATAGTGA" * 3,
                                        b"CCCCCCCCCCCCCCCCCCCCCC", b"ATG" * 10 + b"TA",
                                        b"ATGC" * 8]),
                        ("W=10 reverse motifs", [b"CAT" * 50, b"TTA" * 50, b"CATCTATCA" * 16,
                                                 b"TTACATGCC" * 16 + b"CA", b"TCA" * 49])):
        pr = bnt.PackedReads.from_ascii(seqs, device=dev)
        w = pr.words[:, :1].contiguous() if label.startswith("W=1") else pr.words
        orf_cases.append((label, w, pr.lengths))
    # lengths past 16 W: bases there read as A, and the reverse strand's
    # source words wrap (16 W < n <= 32 W) or fill (below)
    for label, w, ln in orf_cases[-3:] + [orf_cases[0]]:
        past = 16 * w.shape[1] + torch.arange(1, len(ln) + 1, device=dev, dtype=torch.int32) * 7
        orf_cases.append((label + ", n past 16 W", w, past))
    for label, w, ln in orf_cases:
        compare("orf_scan", label + ", one strand", orf.best_orf_one_strand_kernel(w, ln),
                orf.best_orf_one_strand_torch(w, ln))
        compare("orf_scan", label + ", both strands", orf.best_orf_two_strands_kernel(w, ln),
                orf.best_orf_two_strands_torch(w, ln))
    for label, (w, ln) in orf_rows.items():
        both = orf_both(label)
        kern, plain = ((orf.best_orf_two_strands_kernel, orf.best_orf_two_strands_torch) if both
                       else (orf.best_orf_one_strand_kernel, orf.best_orf_one_strand_torch))
        nbytes, ops_ms = orf_bound(torch, w, ln, 2 if both else 1)
        timed("orf_scan", label + (", both strands" if both else ", one strand"),
              lambda: kern(w, ln), lambda: plain(w, ln), main=both,
              nbytes=nbytes, ops_ms=ops_ms)
    del orf_cases, orf_rows, long_ascii, long_words

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
    check("the host API tier: as_2bit, from_2bit, encode/decode, hdist, PackedSequence",
          bnt.as_2bit(b"ACGT") == 0b11100100
          and bnt.from_2bit(71620941647064936, 28) == b"AGGCTTGAGGCCCATTCTCTGATCGTTT"
          and bnt.decode(bnt.encode(b"ACGT" * 250), 1000) == b"ACGT" * 250
          and bnt.hdist(bnt.encode(b"ACTGACTG"), bnt.encode(b"TGCATGCA"), 8) == 8
          and bnt.PackedSequence(b"ACGTACGT").slice(1, 5) == b"CGTA"
          and bnt.PackedSequence(b"ACGTACGT").gc_content() == 50.0
          and g[0] == bnt.PackedSequence(b"ACGT"))

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
        step_launches = dict(kernels.LAUNCHES)
        t = time.perf_counter()
        hist_k = pipeline.count_fastq(fq, STREAM_K, **count_kw)
        count_s = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
        print(f"  flagship step {step_s * 1e3:.1f} ms (first call), streaming count "
              f"{count_s:.2f} s, launches {launches}", flush=True)
        for name in ("pack", "hist_keys", "hist_words", "hdist_scan"):
            check(f"{name} launched on the main path", launches[name] > 0,
                  f"{launches[name]} launches")
        check("the flagship step's two k = 8 counts are two K3b launches and no K3a",
              step_launches["hist_words"] == 2 and step_launches["hist_keys"] == 0,
              f"step launches {step_launches}")
        results["phases"].update(step_kernel_s=step_s, count_kernel_s=count_s, launches=launches,
                                 step_launches=step_launches)

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
            "count k=8 canonical (K3b)": lambda: kmer.count_kmers_reads(
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
        for depth in (0, 2):
            t = time.perf_counter()
            for _ in bnt.io.iter_fastq_batches(fq, FASTQ_BATCH, validate=False, prefetch=depth,
                                               with_validity=True, with_offsets=True, device=dev):
                pass
            torch.cuda.synchronize()
            results["phases"][f"ingest_only_prefetch{depth}_s"] = time.perf_counter() - t
        # the count at both depths, in turns (the main path's run was at 2)
        hists = {}
        for depth in (0, 2, 0, 2):
            t = time.perf_counter()
            hists[depth] = pipeline.count_fastq(fq, STREAM_K, prefetch=depth, **count_kw)
            results["phases"].setdefault(f"count_prefetch{depth}_s", []).append(
                time.perf_counter() - t)
        print(f"  framing + upload + K1 alone: {results['phases']['ingest_only_prefetch0_s']:.2f} s "
              f"at prefetch 0, {results['phases']['ingest_only_prefetch2_s']:.2f} s at 2; count "
              f"at prefetch 0 {results['phases']['count_prefetch0_s']} s, at 2 "
              f"{results['phases']['count_prefetch2_s']} s (main path, first: {count_s:.2f} s)",
              flush=True)
        check("count_fastq prefetch=0 == prefetch=2 == main path",
              np.array_equal(hists[0], hist_k) and np.array_equal(hists[2], hist_k))
        del hists
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

        fa, genome, reads_g, true_starts, true_rev = large_k_phase(
            args, torch, dev, timer, tmp, results)
        index = mapping_phase(args, torch, dev, timer, results, fa, genome, reads_g,
                              true_starts, true_rev, compare, timed)
        queries, contigs = search_orf_phase(args, torch, dev, timer, results, tmp, db, genome,
                                            reads_g)
        public_phase(args, torch, dev, timer, results, tmp, db, queries, contigs, fq)
        long_calls_phase(args, torch, dev, timer, results, fa, genome, reads_g, index, compare,
                         timed)
        read_tier_phase(args, torch, dev, timer, results, tmp, genome, reads_g, true_starts,
                        true_rev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches.update({name: LARGE_K_LAUNCHES[name] for name in ("unpack", "merge")})
    launches.update({name: MAP_LAUNCHES[name] for name in ("fit_banded", "sw_score")})
    launches.update({name: SEARCH_ORF_LAUNCHES[name]
                     for name in ("hdist_scan_batch", "tc_scan", "tc_search", "orf_scan")})
    launches["chain"] = LONG_LAUNCHES["chain"]

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
        "hdist_scan_batch": ("bitnuc_tpu_torch/csrc/hamming.cu",
                             "bitnuc_tpu/ops/pallas/hamming.py:115",
                             "bitnuc_tpu/ops/pallas/hamming.py:151"),
        "tc_scan": ("bitnuc_tpu_torch/csrc/tcscan.cu", "bitnuc_tpu/ops/pallas/hamming.py:243",
                    "bitnuc_tpu/ops/pallas/hamming.py:268"),
        "tc_search": ("bitnuc_tpu_torch/csrc/tcscan.cu", "bitnuc_tpu/ops/pallas/hamming.py:243",
                      "bitnuc_tpu/ops/pallas/hamming.py:268"),
        "unpack": ("bitnuc_tpu_torch/csrc/unpack.cu", "bitnuc_tpu/ops/pallas/unpack.py:61",
                   "bitnuc_tpu/ops/pallas/unpack.py:83"),
        "merge": ("bitnuc_tpu_torch/csrc/merge.cu", "bitnuc_tpu/ops/pallas/merge.py:141",
                  "bitnuc_tpu/ops/pallas/merge.py:121"),
        "fit_banded": ("bitnuc_tpu_torch/csrc/wavefront.cu",
                       "bitnuc_tpu/ops/pallas/wavefront.py:255",
                       "bitnuc_tpu/ops/pallas/wavefront.py:315"),
        "sw_score": ("bitnuc_tpu_torch/csrc/wavefront.cu",
                     "bitnuc_tpu/ops/pallas/wavefront.py:444",
                     "bitnuc_tpu/ops/pallas/wavefront.py:482"),
        "orf_scan": ("bitnuc_tpu_torch/csrc/orf.cu", "bitnuc_tpu/ops/pallas/orfscan.py:93",
                     "bitnuc_tpu/ops/pallas/orfscan.py:117"),
        # C1 replaces no pallas_call: the JAX package's chaining is a lax.scan
        "chain": ("bitnuc_tpu_torch/csrc/chain.cu", "bitnuc_tpu/ops/chain.py:43", None),
    }
    lines = []
    for name, (src, replaces, call) in sources.items():
        for head in (t for t in timings[name] if t["main"]):  # K3b: (b) and (c)
            lines.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "pallas_call": call, "launches": launches[name], "max_abs_err": errs[name],
                "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "shape": head["shape"]})
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
