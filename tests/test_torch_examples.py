"""The port's five example scripts (examples/torch_*.py), each run as a
subprocess from the repo root with BITNUC_EXAMPLE_DEVICE=cpu, print the
lines that tests/test_examples.py asserts of their JAX namesakes, for the
same arguments; the search and sketch examples print the JAX examples'
output byte for byte."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **env):
    res = subprocess.run(
        [sys.executable] + args,
        cwd=REPO,
        env={**os.environ, "BITNUC_EXAMPLE_DEVICE": "cpu", "JAX_PLATFORMS": "cpu", **env},
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, f"{args}:\n{res.stdout}\n{res.stderr}"
    return res.stdout


def test_kmer_pipeline(tmp_path, rng):
    fastq = tmp_path / "small.fastq"
    with open(fastq, "wb") as f:
        for i in range(40):
            seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=80))
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 80))
    out = _run(["examples/torch_kmer_pipeline.py", str(fastq), "5"])
    assert "40 reads, 3200 bases, k=5" in out
    assert "top canonical k-mers:" in out
    assert "pipeline recount: 3040 windows" in out, out  # 40 * (80 - 4)
    assert (tmp_path / "small.fastq.ckpt.npz").exists()


def test_hdist_search():
    out = _run(["examples/torch_hdist_search.py", "2000", "64"])
    assert "row      17  distance 0" in out, out
    assert "batch search: 8/8 queries found themselves at distance 0" in out, out
    assert out == _run(["examples/hdist_search.py", "2000", "64"])


def test_distributed_counting():
    out = _run(["examples/torch_distributed_counting.py"])
    assert "mesh: 8 x cpu" in out, out
    assert "batch-sharded: 31680 windows counted (expect 31680)" in out, out
    assert "seq-sharded:   16379 windows counted (expect 16379)" in out, out
    assert "mesh streaming k=21: 8640 distinct k-mers, 8640 windows (expect 8640)" in out, out


def test_sketch_compare():
    out = _run(["examples/torch_sketch_compare.py", "20000", "0.03"])
    jac_mut = float(out.split("mutated 3%) = ")[1].split()[0])
    jac_rnd = float(out.split("unrelated)     = ")[1].split()[0])
    con = float(out.split("ref) = ")[1].split()[0])
    assert jac_mut > 0.4 and jac_rnd < 0.05 and con > 0.95, out
    assert out == _run(["examples/sketch_compare.py", "20000", "0.03"])


def test_resequencing():
    out = _run(["examples/torch_resequencing.py", "20000", "600", "100"])
    assert "resequencing example OK" in out, out
    assert "spurious: 0" in out, out
