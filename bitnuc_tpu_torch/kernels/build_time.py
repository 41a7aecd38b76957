"""Seconds to build the kernel library from nothing, two ways: one nvcc over
every source (compiled one after another) and ``_build.build()`` (one nvcc
per source, all started together, then a link). Both build into fresh
temporary directories, so neither reuses the other's output.

    python -m bitnuc_tpu_torch.kernels.build_time
    python -m bitnuc_tpu_torch.kernels.build_time --ptxas

Prints one JSON object: {"serial_s": ..., "parallel_s": ..., "sources": N}.
With ``--ptxas`` it prints instead, for each source, what ``nvcc -Xptxas -v``
says of each kernel: registers, shared memory, spills, warnings.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import _build


def serial_build(out_dir: Path) -> float:
    """The whole library from one nvcc invocation; returns seconds."""
    srcs = [str(s) for s in sorted(_build.CSRC.glob("*.cu"))]
    t = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / "serial.so"), *srcs], check=True, capture_output=True)
    return time.perf_counter() - t


def parallel_build(out_dir: Path) -> float:
    """``_build.build()`` into ``out_dir``; returns seconds."""
    saved = _build.BUILD_DIR
    _build.BUILD_DIR = out_dir
    try:
        t = time.perf_counter()
        _build.build()
        return time.perf_counter() - t
    finally:
        _build.BUILD_DIR = saved


def ptxas_report(out_dir: Path, names=None) -> dict:
    """{source: the ptxas lines of its kernels} from ``-Xptxas -v``, for
    every source or for those ``names`` (such as ``("tcscan.cu",)``); one
    nvcc a source, all started together."""
    procs = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        if names is None or src.name in names:
            procs[src.name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 str(out_dir / f"{src.stem}.o"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args, log)
        report[name] = [ln.strip() for ln in log.splitlines()
                        if "ptxas info" in ln and ("Compiling" not in ln or "entry" in ln)
                        or "spill" in ln or "warning" in ln]
    return report


def main() -> None:
    if "--ptxas" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as d:
            print(json.dumps(ptxas_report(Path(d)), indent=1))
        return
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        serial = serial_build(Path(a))
        parallel = parallel_build(Path(b))
    print(json.dumps({"serial_s": serial, "parallel_s": parallel,
                      "sources": len(list(_build.CSRC.glob("*.cu")))}))


if __name__ == "__main__":
    main()
