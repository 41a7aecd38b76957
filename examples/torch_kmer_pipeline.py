"""End-to-end k-mer counting through the PyTorch port: FASTQ -> packed
reads -> histogram.

Usage:
    python examples/torch_kmer_pipeline.py [reads.fastq[.gz]] [k]

Without arguments, writes a synthetic FASTQ to the temporary directory and
counts 8-mers. The reference README workflow (README.md:164-180) at batch
scale: streaming ingestion, canonical counting on the device (K1 packs,
K3b counts), a top-k report, then the same job through the managed
pipeline. Runs on the card; BITNUC_EXAMPLE_DEVICE=cpu (or another device
name) runs elsewhere.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

import bitnuc_tpu_torch as bn  # noqa: E402
from bitnuc_tpu_torch.ops import kmer  # noqa: E402

DEVICE = os.environ.get("BITNUC_EXAMPLE_DEVICE")  # None: the card


def synth_fastq(path, n_reads=2000, read_len=300, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n_reads):
            seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=read_len))
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, seq, b"I" * read_len))
    return path


def main():
    path = (sys.argv[1] if len(sys.argv) > 1
            else synth_fastq(os.path.join(tempfile.gettempdir(), "example.fastq")))
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    t0 = time.perf_counter()
    total = None
    n_reads = 0
    n_bases = 0
    for batch in bn.io.iter_fastq_batches(path, batch_size=4096, device=DEVICE):
        # mode='dense' pins the [4^k] layout this example adds up across
        # batches (the managed pipeline below returns a dict above k = 12)
        hist = kmer.count_kmers_reads(batch.words, batch.lengths, k, mode="dense",
                                      canonical=True)
        total = hist if total is None else total + hist
        n_reads += len(batch)
        n_bases += int(batch.lengths.sum())
    dt = time.perf_counter() - t0

    counts, keys = kmer.top_kmers(total, 10)
    print(f"{n_reads} reads, {n_bases} bases, k={k}, {dt:.2f}s")
    print("top canonical k-mers:")
    for c, key in zip(counts.tolist(), keys.tolist()):
        if c == 0:
            break
        print(f"  {bn.from_2bit(int(key), k).decode()}  x{int(c)}")

    # the same job through the managed pipeline: crash-safe checkpoints,
    # N-tolerant windows, framing on a producer thread, progress metrics
    ckpt = path + ".ckpt.npz"
    hist = bn.pipeline.count_fastq(
        path,
        k,
        batch_size=4096,
        on_invalid="skip",
        checkpoint=ckpt,
        checkpoint_every=10,
        on_progress=lambda m: print(
            f"  progress: {m['reads']} reads, {m['bases_per_sec'] / 1e6:.0f} Mbases/s"
        ),
        progress_every=5,
        device=DEVICE,
    )
    n_win = int(hist.sum()) if not isinstance(hist, dict) else sum(hist.values())
    print(f"pipeline recount: {n_win} windows (checkpoint at {ckpt})")


if __name__ == "__main__":
    main()
