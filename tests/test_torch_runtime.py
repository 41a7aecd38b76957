"""bitnuc_tpu_torch.parallel.runtime in a real 2-process gloo group, as
tests/test_runtime.py runs the JAX package's: is_initialized before and
after, initialize from arguments and from torchrun's environment, the
idempotent second call, process_info's four keys, and the mesh
collectives across the processes (psum of 1 and 2 gives 3, all_gather
gives [1, 2], a sharded k-mer count of each process's half of a batch
equals the whole batch's count). Each process has its own free port and
time limit, so a hung rendezvous fails the test instead of holding the
suite."""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
import numpy as np
import torch

from bitnuc_tpu_torch.parallel import mesh as pmesh, runtime

assert not runtime.is_initialized()
assert runtime.world_size() == 1 and runtime.process_index() == 0
addr, rank, spec = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if spec == "env":  # torchrun's variables instead of arguments
    host, port = addr.split(":")
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank))
    runtime.initialize(timeout_s=60)
else:
    runtime.initialize(coordinator_address=addr, num_processes=2, process_id=rank,
                       timeout_s=60)
assert runtime.is_initialized()
runtime.initialize()  # a second call does nothing
assert torch.distributed.get_backend() == "gloo"

info = runtime.process_info()
assert set(info) == {"process_index", "process_count", "local_devices", "global_devices"}
assert info["process_index"] == rank and info["process_count"] == 2, info
assert info["global_devices"] == 2 * info["local_devices"] == 2, info

cpu = torch.device("cpu")
mesh = pmesh.make_mesh((1,), ("x",), devices=[cpu])
got = pmesh.psum([torch.tensor([rank + 1], dtype=torch.int32)], mesh, "x")[0]
assert got.tolist() == [3] and got.dtype == torch.int32, got
got = pmesh.all_gather([torch.tensor([rank + 1])], mesh, "x")[0]
assert got.tolist() == [1, 2], got
got = pmesh.pmax([torch.tensor([rank + 5])], mesh, "x")[0]
assert got.tolist() == [6], got
print("PSUM_OK", rank, flush=True)

# each process holds half of a batch on 2 local shards; one psum crosses both
from bitnuc_tpu_torch.ops import kmer
from bitnuc_tpu_torch.parallel import kmer as pkmer
from bitnuc_tpu_torch.sequence import PackedReads

rng = np.random.default_rng(7)
seqs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 50).tobytes() for _ in range(8)]
full = PackedReads.from_ascii(seqs, device=cpu)
half = PackedReads.from_ascii(seqs[4 * rank : 4 * rank + 4], device=cpu)
mesh2 = pmesh.make_mesh((2,), ("data",), devices=[cpu, cpu])
hist = pkmer.count_kmers_sharded(half.words, half.lengths, 5, mesh2)
assert torch.equal(hist, kmer.count_kmers_dense(full.words, full.lengths, 5))
print("KMERS_OK", rank, flush=True)
runtime.shutdown()
assert not runtime.is_initialized()
assert "jax" not in sys.modules
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("spec", ["args", "env"])
def test_two_process_group(tmp_path, spec):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    env["CUDA_VISIBLE_DEVICES"] = ""  # gloo on the CPU
    procs = [subprocess.Popen([sys.executable, str(worker), addr, str(i), spec],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"PSUM_OK {i}" in out and f"KMERS_OK {i}" in out, out


def test_single_process_noop(monkeypatch):
    """No arguments and no torchrun variables: nothing happens."""
    from bitnuc_tpu_torch.parallel import runtime

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    runtime.initialize()
    assert not runtime.is_initialized()
    assert runtime.process_info()["process_count"] == 1
    runtime.shutdown()  # nothing to leave
