"""Sketch-based sequence similarity through the PyTorch port: minimizers ->
Jaccard / containment.

Usage:
    python examples/torch_sketch_compare.py [seq_len] [mutation_rate]

Generates a random sequence, derives mutated and unrelated variants, and
compares their (w,k)-minimizer sketches on the device: the Mash/sourmash
workflow on the packed 2-bit representation. Runs on the card;
BITNUC_EXAMPLE_DEVICE=cpu (or another device name) runs elsewhere.
"""

import os
import sys

import numpy as np

sys.path.insert(0, ".")

import bitnuc_tpu_torch as bn  # noqa: E402

DEVICE = os.environ.get("BITNUC_EXAMPLE_DEVICE")  # None: the card


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    rate = float(sys.argv[2]) if len(sys.argv) > 2 else 0.03
    k, w = 13, 9
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)

    ref = rng.choice(bases, size=n)
    mutated = ref.copy()
    pos = rng.random(n) < rate
    mutated[pos] = bases[(np.searchsorted(bases, mutated[pos])
                          + rng.integers(1, 4, pos.sum())) % 4]
    unrelated = rng.choice(bases, size=n)

    def sketch(arr):
        r = bn.PackedReads.from_ascii(arr[None, :], lengths=np.array([len(arr)]),
                                      device=DEVICE)
        return bn.minimizer_sketch(r.words, r.lengths, k, w)

    (v_ref, n_ref), (v_mut, _), (v_rnd, _) = map(sketch, (ref, mutated, unrelated))
    print(f"sketch: {int(n_ref)} distinct ({k},{w})-minimizers of {n} bases")
    print(f"jaccard(ref, mutated {rate:.0%}) = {float(bn.sketch_jaccard(v_ref, v_mut)):.3f}")
    print(f"jaccard(ref, unrelated)     = {float(bn.sketch_jaccard(v_ref, v_rnd)):.3f}")
    print(f"containment(ref[:half], ref) = "
          f"{float(bn.sketch_containment(sketch(ref[: n // 2])[0], v_ref)):.3f}")


if __name__ == "__main__":
    main()
