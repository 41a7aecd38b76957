"""Distributed k-mer counting over a mesh of torch devices.

    python examples/torch_distributed_counting.py

On the card the mesh spans the visible CUDA devices;
BITNUC_EXAMPLE_DEVICE=cpu gives a mesh of 8 CPU shards (another device name
gives 8 shards of that device). Shows both sharding regimes of
bitnuc_tpu_torch.parallel: batch-sharded reads (one psum merge) and one
long sequence split across the mesh with a halo exchange for windows that
cross shard edges; then a streaming large-k count of a FASTQ file with a
run list a device and one merge at the end. Across processes, call
bitnuc_tpu_torch.parallel.runtime.initialize() first.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, ".")

import bitnuc_tpu_torch as bn  # noqa: E402
from bitnuc_tpu_torch import pipeline  # noqa: E402
from bitnuc_tpu_torch.parallel import kmer as pkmer, mesh as pmesh  # noqa: E402

DEVICE = os.environ.get("BITNUC_EXAMPLE_DEVICE")  # None: the cards


def main():
    k = 6
    if DEVICE is None:
        mesh = pmesh.make_mesh()
    else:
        mesh = pmesh.make_mesh((8,), devices=[torch.device(DEVICE)] * 8)
    dev0 = mesh.flat_devices[0]
    print(f"mesh: {mesh.size} x {dev0.type}")

    # --- batch-sharded counting ---
    rng = np.random.default_rng(0)
    reads = bn.PackedReads.from_ascii(
        [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500)) for _ in range(64)],
        device=dev0)
    sharded = pmesh.shard_reads(reads, mesh)
    hist = pkmer.count_kmers_sharded(sharded.words, sharded.lengths, k, mesh)
    print(f"batch-sharded: {int(hist.sum())} windows counted (expect {64 * (500 - k + 1)})")

    # --- sequence-sharded counting, halo exchange ---
    long_seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=16 * 1024))
    one = bn.PackedSequence(long_seq)
    words = bn.PackedReads.from_u64(np.asarray(one.data)[None, :], np.array([len(one)]),
                                    device=dev0).words[0]
    hist_seq = pkmer.count_kmers_seqsharded(words, len(long_seq), k, mesh, "data")
    print(f"seq-sharded:   {int(hist_seq.sum())} windows counted "
          f"(expect {len(long_seq) - k + 1})")

    # --- streaming large-k counting, file -> counts ---
    # a batch: no communication (each device keeps its shard's run list);
    # one all_gather merge at the end
    k_big = 21
    with tempfile.NamedTemporaryFile(suffix=".fq", delete=False) as f:
        for i in range(48):
            s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200))
            f.write(b"@s%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
        path = f.name
    try:
        counts = pipeline.count_fastq(path, k_big, batch_size=16, mesh=mesh)
    finally:
        os.unlink(path)
    print(f"mesh streaming k={k_big}: {len(counts)} distinct k-mers, "
          f"{sum(counts.values())} windows (expect {48 * (200 - k_big + 1)})")
    assert sum(counts.values()) == 48 * (200 - k_big + 1)


if __name__ == "__main__":
    main()
