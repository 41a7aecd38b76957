"""Time the read-processing tier's file stages under two checkouts of
bitnuc_tpu_torch, in fresh processes that alternate between them.

Each child process imports bitnuc_tpu_torch from one checkout, writes a
seeded pair of FASTQ files (262,144 reads of 150 bases each, the size of
chip_smoke.py's phase 11), and times, in this order: a Python readline loop
over both files (script code, the same in every child: a control for the
host's speed), filter_fastq of R1, and filter_fastq_paired of R1 and R2
(phase 11's filter settings, batches of 65,536 records, on the card).
The parent process prints one JSON line per child and a summary with each
stage's median per checkout, and writes all of it to --out.

    python3 scripts/host_ab.py PARENT_DIR CHANGE_DIR --pairs 5 --out chiprun_out/host_ab.json
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

READS, READ_LEN, BATCH = 262_144, 150, 65_536
FILTER_KW = dict(trim_q=20, min_len=30, min_mean_q=20, max_n=5, adapter=b"AGATCGGAAGAGC",
                 min_complexity=0.3, min_entropy=3.0)


def write_fastq(path, rng, np):
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (READS, READ_LEN))]
    quals = rng.integers(35, 75, (READS, READ_LEN)).astype(np.uint8)
    with open(path, "wb") as f:
        for i in range(READS):
            f.write(b"@r%09d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), quals[i].tobytes()))


def child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from bitnuc_tpu_torch import filters

    try:  # a checkout with the host library builds it before the clock
        from bitnuc_tpu_torch import native

        native.build()
    except ImportError:
        native = None
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    times = {}
    with tempfile.TemporaryDirectory() as d:
        r1, r2 = os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq")
        write_fastq(r1, rng, np)
        write_fastq(r2, rng, np)
        # kernels build and load on a small first call, off the clock
        filters.filter_fastq_paired(r1, r1, os.path.join(d, "w1"), os.path.join(d, "w2"),
                                    batch_reads=64, device=dev, **FILTER_KW)
        t = time.perf_counter()
        n = 0
        for path in (r1, r2):
            with open(path, "rb") as f:
                for line in f:
                    n += len(line.strip())
        times["control: Python readline loop"] = time.perf_counter() - t
        t = time.perf_counter()
        filters.filter_fastq(r1, os.path.join(d, "f.fq"), batch_reads=BATCH, device=dev,
                             **FILTER_KW)
        torch.cuda.synchronize()
        times["filter_fastq"] = time.perf_counter() - t
        t = time.perf_counter()
        filters.filter_fastq_paired(r1, r2, os.path.join(d, "p1.fq"), os.path.join(d, "p2.fq"),
                                    batch_reads=BATCH, device=dev, **FILTER_KW)
        torch.cuda.synchronize()
        times["filter_fastq_paired"] = time.perf_counter() - t
    return {"tree": tree, "host_library": native is not None and native.available(),
            "s": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    runs = []
    for i in range(args.pairs):  # parent first in even pairs, change first in odd ones
        order = (args.parent, args.change) if i % 2 == 0 else (args.change, args.parent)
        for tree in order:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.parent,
                                   args.change, "--child", tree],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            run["pair"] = i
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {}
    for tree in (args.parent, args.change):
        mine = [r["s"] for r in runs if r["tree"] == tree]
        summary[tree] = {k: statistics.median(s[k] for s in mine) for k in mine[0]}
    print(json.dumps({"median_s": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "median_s": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
