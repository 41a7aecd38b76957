"""Hamming-distance database search through the PyTorch port: query reads
against a packed database.

Usage:
    python examples/torch_hdist_search.py [db_size] [read_len]

Builds a random packed database on the device, plants a few near-duplicates
of the query, and finds them with the exact top-k scan (K4), then searches
a batch of queries in one pass over the word-major PackedDB (K5, or K6's
fused tc_search from database.SEARCH_TC_MIN_Q queries on). On a mesh,
PackedDB.search takes mesh= (bitnuc_tpu_torch.parallel). Runs on the card;
BITNUC_EXAMPLE_DEVICE=cpu (or another device name) runs elsewhere.
"""

import os
import sys

import numpy as np

sys.path.insert(0, ".")

import bitnuc_tpu_torch as bn  # noqa: E402

DEVICE = os.environ.get("BITNUC_EXAMPLE_DEVICE")  # None: the card


def main():
    db_size = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    rng = np.random.default_rng(0)

    bases = np.frombuffer(b"ACGT", np.uint8)
    db_ascii = rng.choice(bases, size=(db_size, read_len))
    query = rng.choice(bases, size=read_len)

    # plant 3 near-duplicates at known rows (scaled to the database size)
    for row, n_mut in [(17, 0), (db_size // 2, 3), (db_size - 1, 7)]:
        mutated = query.copy()
        pos = rng.choice(read_len, size=n_mut, replace=False)
        mutated[pos] = bases[(np.searchsorted(bases, mutated[pos]) + 1) % 4]
        db_ascii[row] = mutated

    db = bn.PackedReads.from_ascii(db_ascii, lengths=np.full(db_size, read_len), device=DEVICE)
    q = bn.PackedReads.from_ascii(query[None, :], lengths=np.array([read_len]), device=DEVICE)
    pdb = bn.PackedDB.from_reads(db)

    dists, idx = pdb.search(q.words[0], 5)
    print(f"database: {db_size} x {read_len} bases")
    for d, i in zip(dists.tolist(), idx.tolist()):
        print(f"  row {int(i):>7}  distance {int(d)}")

    # many queries in one pass over the word-major layout
    queries = bn.PackedReads.from_ascii(db_ascii[:8], lengths=np.full(8, read_len),
                                        device=DEVICE)
    bd, bi = pdb.search_batch(queries.words, 3)
    bd, bi = bd.cpu().numpy(), bi.cpu().numpy()
    hits = sum(int(bi[qi][0]) == qi and int(bd[qi][0]) == 0 for qi in range(8))
    print(f"batch search: {hits}/8 queries found themselves at distance 0")


if __name__ == "__main__":
    main()
