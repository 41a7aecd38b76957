"""bitnuc_tpu_torch.ops.dedupe against bitnuc_tpu.ops.dedupe on the same
numpy-seeded batches, keep and counts exactly: R = 0, all rows equal,
equal words under unequal lengths, W = 1 to 3 and a read batch with
planted copies through dedupe_reads."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import dedupe as jdedupe
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch.ops import dedupe
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _check(words_u32, lengths):
    want = jdedupe.mark_duplicates(jnp.asarray(words_u32), jnp.asarray(lengths))
    got = dedupe.mark_duplicates(words_from_u32_np(words_u32), torch.from_numpy(lengths))
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_mark_duplicates_matches_jax(W, seed):
    rng = np.random.default_rng(seed * 7 + W)
    R = 200
    # few distinct rows, with bit 31 set in some words, so groups form
    pool = rng.integers(0, 2**32, (12, W), dtype=np.uint64).astype(np.uint32)
    pool[::3, 0] |= np.uint32(1 << 31)
    words = pool[rng.integers(0, 12, R)]
    lengths = rng.integers(14, 16, R).astype(np.int32)
    keep, counts = _check(words, lengths)
    assert int(counts.sum()) == R and keep.sum() < R


def test_mark_duplicates_empty_batch():
    keep, counts = _check(np.zeros((0, 2), np.uint32), np.zeros(0, np.int32))
    assert keep.shape == counts.shape == (0,)


def test_mark_duplicates_all_rows_equal():
    keep, counts = _check(np.full((50, 2), 0xDEADBEEF, np.uint32), np.full(50, 40, np.int32))
    assert keep.numpy().tolist() == [True] + [False] * 49 and counts[0] == 50


def test_mark_duplicates_splits_equal_words_by_length():
    """Poly-A reads of different lengths share all-zero words."""
    lengths = np.array([0, 5, 5, 16, 0, 32, 5], np.int32)
    keep, counts = _check(np.zeros((7, 2), np.uint32), lengths)
    assert counts.numpy().tolist() == [2, 3, 0, 1, 0, 1, 0]


def test_dedupe_reads_matches_jax(rng):
    seqs = [random_seq(rng, int(rng.integers(1, 70))) for _ in range(60)]
    seqs += [seqs[int(i)] for i in rng.integers(0, 60, 40)]
    order = rng.permutation(len(seqs))
    seqs = [seqs[int(i)] for i in order]
    want = jdedupe.dedupe_reads(JPackedReads.from_ascii(seqs))
    got = dedupe.dedupe_reads(PackedReads.from_ascii(seqs, device=CPU))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) == 100
