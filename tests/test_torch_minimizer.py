"""bitnuc_tpu_torch minimizers (the mapper's seeds) against bitnuc_tpu.ops.kmer:
minimizer_positions (k <= 16), minimizer_positions64 (k <= 31) and
minimizer_sketch_mask on ragged reads (lengths 0, shorter than k + w - 1,
full), base_valid masks, all-T reads whose k = 16 keys equal the sentinel,
and repeated k-mers. Every output is an integer: equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import kmer as jkmer
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch.ops import kmer
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)


def _batch():
    """Random reads with a tandem repeat, all-T and all-A reads, and
    lengths from 0 up to the full row."""
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bytes(acgt[rng.integers(0, 4, n)]) for n in (0, 3, 9, 14, 40, 64, 90, 127)]
    seqs += [b"ACGTTGCA" * 12, b"T" * 70, b"A" * 33, b"GATTACA" * 15]
    return seqs


def _eq(got, want):
    """A port tensor equals a JAX array (int32 views read as uint32 where
    the JAX array is uint32)."""
    want = np.asarray(want)
    a = got.numpy()
    np.testing.assert_array_equal(a.view(np.uint32) if want.dtype == np.uint32 else a, want)


@pytest.fixture(scope="module")
def reads():
    seqs = _batch()
    jr = JPackedReads.from_ascii(seqs)
    words = np.asarray(jr.words)
    lengths = np.asarray(jr.lengths)
    rng = np.random.default_rng(12)
    bv = rng.random((len(seqs), 16 * words.shape[1])) > 0.04
    return jr, words_from_u32_np(words), torch.from_numpy(lengths.copy()), bv


def _jax_out(out):
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("w", [1, 4, 10])
@pytest.mark.parametrize("k", [5, 13, 15, 16, 21, 31])
def test_minimizer_positions_match_jax(reads, k, w):
    jr, words, lengths, _ = reads
    want = _jax_out(jkmer.minimizer_positions64(jr.words, jr.lengths, k, w))
    got = kmer.minimizer_positions64(words, lengths, k, w)
    for g, wnt in zip(got, want):
        _eq(g, wnt)
    if k <= 16:
        want = _jax_out(jkmer.minimizer_positions(jr.words, jr.lengths, k, w))
        got = kmer.minimizer_positions(words, lengths, k, w)
        for g, wnt in zip(got, want):
            _eq(g, wnt)
        sel = kmer.minimizer_sketch_mask(got[1], got[2])
        jsel = jkmer.minimizer_sketch_mask(jnp.asarray(want[1]), jnp.asarray(want[2]))
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,w", [(15, 10), (16, 5), (21, 10)])
def test_minimizers_with_base_valid_match_jax(reads, k, w, canonical):
    jr, words, lengths, bv = reads
    jbv = jnp.asarray(bv)
    want = _jax_out(jkmer.minimizer_positions64(jr.words, jr.lengths, k, w, canonical,
                                                base_valid=jbv))
    got = kmer.minimizer_positions64(words, lengths, k, w, canonical,
                                     base_valid=torch.from_numpy(bv))
    for g, wnt in zip(got, want):
        _eq(g, wnt)
    if k <= 16:
        want = _jax_out(jkmer.minimizer_positions(jr.words, jr.lengths, k, w, canonical,
                                                  base_valid=jbv))
        got = kmer.minimizer_positions(words, lengths, k, w, canonical,
                                       base_valid=torch.from_numpy(bv))
        for g, wnt in zip(got, want):
            _eq(g, wnt)


def test_all_t_k16_keys_are_the_sentinel(reads):
    """At k = 16 the all-T key is 0xFFFFFFFF: no window of the all-T read
    has a minimizer, in either package; at k = 15 every window has one."""
    jr, words, lengths, _ = reads
    row = _batch().index(b"T" * 70)
    _, _, valid16 = kmer.minimizer_positions(words, lengths, 16, 4)
    assert not valid16[row].any()
    _, pos15, valid15 = kmer.minimizer_positions(words, lengths, 15, 4)
    assert valid15[row].sum() == 70 - 15 - 4 + 2
    np.testing.assert_array_equal(
        pos15.numpy(), np.asarray(jkmer.minimizer_positions(jr.words, jr.lengths, 15, 4)[1]))


@pytest.mark.parametrize("w", [1, 3, 8, 64, 200])
def test_sliding_argmin_unsigned_order(w):
    """Keys with bit 31 set order above small ones, the sentinel last; the
    leftmost of equal minima wins; windows past the row end see the fill."""
    rng = np.random.default_rng(w)
    vals = rng.choice(np.array([0, 1, 7, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64),
                      (4, 100)).astype(np.uint32)
    t = words_from_u32_np(vals)
    v, p = kmer._sliding_argmin(t, w, kmer.SENT)
    jv, jp = jkmer._sliding_argmin(jnp.asarray(vals), w, np.uint32(0xFFFFFFFF))
    _eq(v, jv)
    _eq(p, jp)
    hi = rng.choice(np.array([0, 5, 2**31, 2**32 - 1], np.uint64), (4, 100)).astype(np.uint32)
    h2, l2, p2 = kmer._sliding_argmin2(words_from_u32_np(hi), t, w, kmer.SENT)
    jh, jl, jp2 = jkmer._sliding_argmin2(jnp.asarray(hi), jnp.asarray(vals), w,
                                         np.uint32(0xFFFFFFFF))
    for g, wnt in zip((h2, l2, p2), (jh, jl, jp2)):
        _eq(g, wnt)


def test_shift_tail_and_rejects():
    x = torch.arange(6, dtype=torch.int32).reshape(1, 6)
    assert kmer._shift_tail(x, 2, -1).tolist() == [[2, 3, 4, 5, -1, -1]]
    assert kmer._shift_tail(x, 9, 7).tolist() == [[7] * 6]
    words = torch.zeros((1, 2), dtype=torch.int32)
    lens = torch.tensor([20], dtype=torch.int32)
    with pytest.raises(ValueError):
        kmer.minimizer_positions(words, lens, 17, 4)
    with pytest.raises(ValueError):
        kmer.minimizer_positions64(words, lens, 32, 4)
    with pytest.raises(ValueError):
        kmer.minimizer_positions(words, lens, 5, 0)
