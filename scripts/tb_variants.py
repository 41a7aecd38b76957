"""Time variants of C2's warp form (csrc/traceback.cu) on one card, at the
operands of chip_smoke.py phase 7's first traceback_cigars chunk (262,144
reads of phase 6's genome, mapped at the CLI defaults; M 160, N 224).

A variant is a list of source edits ([old, new] pairs, each old text found
once) applied to this checkout's traceback.cu; "base" has none. Each is
built by its own nvcc (all started together) into a temporary directory,
bound with ctypes and called through bn_traceback_warp (mismatch 1, gap 1,
no ends_free_b). Each variant's output is compared with this checkout's
align_ops_codes_kernel; a variant that takes work away (no walk, no masks)
differs by design, and one that changes the arithmetic is only checked on
this chunk. Each is timed three times (CUDA events, median of 5, L2
flushed before each run). One line a variant, then the card's name and
power limit; --out gets the JSON. Exits 1 if "base" differs.

    python3 scripts/tb_variants.py scripts/tb_variants.json --out variants.json
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from bitnuc_tpu_torch import mapper  # noqa: E402
from bitnuc_tpu_torch.kernels import _build  # noqa: E402
from bitnuc_tpu_torch.ops import align  # noqa: E402
from bitnuc_tpu_torch.sequence import PackedReads  # noqa: E402


def build(src: str, k: int, name: str, edits, out_dir: str) -> str:
    """The shared library of traceback.cu with variant ``k``'s ``edits``."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"{name}: an edit's old text is not in traceback.cu once")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"v{k}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"libv{k}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-shared", "-o", so, cu, str(_build.CSRC / "common.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name} does not build:\n{proc.stderr[-3000:]}")
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON: {name: [[old, new], ...]}")
    ap.add_argument("--out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tb_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    with open(args.variants) as f:
        variants = json.load(f)
    src = (_build.CSRC / "traceback.cu").read_text()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        with ThreadPoolExecutor(len(variants)) as ex:
            libs = dict(zip(variants, ex.map(lambda a: build(src, *a, d),
                                             [(k, *kv) for k, kv in enumerate(variants.items())])))
        print(f"built {len(libs)} variants in {time.perf_counter() - t:.1f} s", flush=True)
        rng = np.random.default_rng(args.seed + 1)
        genome = cs.make_genome(rng)
        reads = cs.sample_reads(rng, genome, cs.FASTQ_READS, cs.READ_LEN)[0][:mapper.MAP_BATCH]
        index = mapper.MinimizerIndex.build_multi([genome.tobytes()], k=cs.MAP_K, w=cs.MAP_W,
                                                  max_occ=cs.MAP_OCC, device=dev)
        packed = PackedReads.from_ascii(reads, lengths=np.full(len(reads), cs.READ_LEN, np.int32),
                                        validate=False, device=dev)
        res = mapper.map_reads(index, packed, min_seeds=cs.MAP_MIN_SEEDS)
        (ca, la, cb, lb), _ = cs.traceback_operands(torch, dev, index, packed, res)
        del index, packed, res
        B, M = ca.shape
        N = cb.shape[1]
        print(f"[{B}] M={M} N={N}; n largest {int(lb.max())}, median {int(lb.median())}",
              flush=True)
        want = align.align_ops_codes_kernel(ca, la, cb, lb, 1, 1, False)
        timer = cs.Timer(torch)
        out = {"shape": [B, M, N], "ms": {}, "equal": {}}
        for name, so in libs.items():
            fn = ctypes.CDLL(so).bn_traceback_warp
            fn.argtypes = _build._SIGNATURES["bn_traceback_warp"]
            cost, endj = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
            ops = torch.empty((B, M + N), dtype=torch.uint8, device=dev)

            def run():
                code = fn(ca.data_ptr(), la.data_ptr(), cb.data_ptr(), lb.data_ptr(), None, B,
                          M, N, 1, 1, 0, cost.data_ptr(), endj.data_ptr(), ops.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"{name}: bn_traceback_warp returned {code}")

            run()
            torch.cuda.synchronize()
            out["equal"][name] = all(torch.equal(x, y) for x, y in zip((cost, endj, ops), want))
            out["ms"][name] = [timer(run) for _ in range(3)]
            print(f"  {name}: {' / '.join(f'{x:.4f}' for x in out['ms'][name])} ms; equal to "
                  f"this checkout's kernel: {out['equal'][name]}", flush=True)
    smi = cs.nvidia_smi_line()
    out["nvidia_smi"] = smi
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(smi)
    print(json.dumps(out))
    return 0 if out["equal"].get("base", True) else 1


if __name__ == "__main__":
    sys.exit(main())
