"""Time K4/K5 (hdist_scan_kernel) of several checkouts of bitnuc_tpu_torch
at every Q from 1 to 33, and at 48 and 64, on one card.

Each checkout's package is imported under its own name by
chip_smoke.load_other_tree and builds its own kernels. The database is
chip_smoke.py's scan database (4,194,304 random entries of 512 bases, from
the seed). At each Q every checkout's result is first held to this
checkout's plain version (hdist_scan_torch) bit for bit, then every
checkout is timed in the order given (CUDA events, median of 5, L2 flushed
before each run). One line per Q, then the card's name and power limit;
--out gets the JSON. Exits 1 if a result differs from the plain version.

    python3 scripts/scan_qcurve.py TREE [TREE ...] --out qcurve.json
"""

import argparse
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from bitnuc_tpu_torch.ops import hamming  # noqa: E402

QS = list(range(1, 34)) + [48, 64]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_qcurve: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    trees = {}
    for i, path in enumerate(args.trees):
        cs.load_other_tree(path, f"bnt_{i}")
        trees[path] = importlib.import_module(f"bnt_{i}.ops.hamming")
    if "jax" in sys.modules:
        print("scan_qcurve: jax was imported", file=sys.stderr)
        return 1
    timer = cs.Timer(torch)
    db, q = cs.scan_inputs(torch, torch.device("cuda"), args.seed)
    res = {path: {} for path in trees}
    for Q in QS:
        want = hamming.hdist_scan_torch(q[:Q], db, cs.DB_BASES)
        for path, h in trees.items():
            cs.check(f"{path} Q={Q} == plain",
                     cs.max_abs_diff(h.hdist_scan_kernel(q[:Q], db, cs.DB_BASES), want) == 0)
        del want
        for path, h in trees.items():
            res[path][Q] = timer(lambda: h.hdist_scan_kernel(q[:Q], db, cs.DB_BASES))
        print(Q, " ".join(f"{res[p][Q]:.4f}" for p in trees), flush=True)
    smi = cs.nvidia_smi_line()
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"ms": res, "ok": not cs.FAILURES, "nvidia_smi": smi}, f, indent=1)
    return 0 if not cs.FAILURES else 1


if __name__ == "__main__":
    sys.exit(main())
