"""bitnuc_tpu_torch.sequence.PackedSequence, stack_sequences and
PackedReads' item access against the JAX package's on the same
numpy-seeded sequences: every PackedSequence method, ==, hash and repr,
to_reads and stack_sequences words, PackedReads[i] at lengths 0, 16 W and
past 16 W, and iteration."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu import sequence as jseq
from bitnuc_tpu_torch import errors
from bitnuc_tpu_torch.sequence import PackedReads, PackedSequence, stack_sequences

CPU = torch.device("cpu")
LENGTHS = [0, 1, 31, 32, 33, 64, 200]
ACGT_MIXED = np.frombuffer(b"ACGTacgt", np.uint8)


def _seq(n, seed):
    return np.random.default_rng(seed).choice(ACGT_MIXED, n).tobytes()


def _outcome(fn, *args):
    try:
        r = fn(*args)
    except Exception as e:  # compared by name: the two packages' classes differ
        return ("raised", type(e).__name__, str(e))
    if isinstance(r, (PackedSequence, jseq.PackedSequence)):
        return ("seq", len(r), r.data.tolist())
    if isinstance(r, tuple):
        return tuple(_outcome(lambda x=x: x) for x in r)
    return r


def _pair(s):
    return PackedSequence(s), jseq.PackedSequence(s)


@pytest.mark.parametrize("n", LENGTHS)
def test_methods_match_jax(n):
    s = _seq(n, n)
    p, j = _pair(s)
    assert p.data.dtype == np.uint64 and p.data.tolist() == j.data.tolist()
    assert (len(p), p.len(), p.is_empty()) == (len(j), j.len(), j.is_empty())
    assert p.to_vec() == j.to_vec() == s.upper()
    assert p.base_counts() == j.base_counts()
    assert p.gc_content() == j.gc_content()
    for i in sorted({0, 1, n // 2, 31, 32, n - 1, n, -1, -n}):
        assert _outcome(p.get, i) == _outcome(j.get, i), i
        assert _outcome(p.__getitem__, i) == _outcome(j.__getitem__, i), i
    for a, b in [(0, n), (1, n - 1), (n // 3, n // 2), (32, 33), (n, n), (2, 1), (0, n + 1)]:
        assert _outcome(p.slice, a, b) == _outcome(j.slice, a, b), (a, b)
    assert repr(p) == repr(j)


@pytest.mark.parametrize("n", [40, 64, 100])
def test_slicing_sugar_matches_jax(n):
    p, j = _pair(_seq(n, 5))
    for key in [slice(None), slice(-10, None), slice(3, -3), slice(-5, -20), slice(0, n, 2),
                slice(None, None, -1), slice(-1000, 1000)]:
        assert _outcome(p.__getitem__, key) == _outcome(j.__getitem__, key), key
    with pytest.raises(errors.InvalidRange):
        p[::2]


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 64, 65, 200])
def test_split_matches_jax(n):
    p, j = _pair(_seq(n, 7))
    for idx in sorted({0, 32, n, n // 2, 1, n + 1}):
        got, want = _outcome(p.split, idx), _outcome(j.split, idx)
        assert got == want, idx
        if idx <= n:
            left, right = p.split(idx)
            assert left.to_vec() + right.to_vec() == p.to_vec()


def test_equality_and_hash():
    a, b = PackedSequence(b"ACGTACGT"), PackedSequence("acgtacgt")
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != PackedSequence(b"ACGTACGA") and a != PackedSequence(b"ACGTACG")
    assert a != b"ACGTACGT"
    # a trailing zero word from split_packed normalises away
    s = _seq(64, 9)
    left, _ = PackedSequence(s).split(32)
    assert left == PackedSequence(s[:32])
    assert hash(left) == hash(PackedSequence(s[:32]))
    jl, _ = jseq.PackedSequence(s).split(32)
    assert left.data.tolist() == jl.data.tolist()
    assert PackedSequence(a) == a
    assert repr(PackedSequence(b"A" * 50)) == repr(jseq.PackedSequence(b"A" * 50))


def test_invalid_base_raises():
    with pytest.raises(errors.InvalidBase) as e:
        PackedSequence(b"ACGN")
    assert e.value.base == ord("N")


@pytest.mark.parametrize("length,words", [(0, []), (5, [7]), (40, [1]), (70, [1, 2, 3, 4])])
def test_from_packed_normalises_like_jax(length, words):
    w = np.array(words, np.uint64)
    p, j = PackedSequence.from_packed(w, length), jseq.PackedSequence.from_packed(w, length)
    assert p.data.tolist() == j.data.tolist() and len(p) == len(j)
    assert p == PackedSequence.from_packed(p.data, length)


@pytest.mark.parametrize("n", LENGTHS)
def test_to_reads_matches_jax(n):
    p, j = _pair(_seq(n, 11))
    r, jr = p.to_reads(device=CPU), j.to_reads()
    np.testing.assert_array_equal(r.to_numpy()[0], np.asarray(jr.words))
    np.testing.assert_array_equal(r.lengths.numpy(), np.asarray(jr.lengths))
    assert r.to_ascii() == jr.to_ascii()


def test_stack_sequences_matches_jax():
    seqs = [_seq(n, 30 + n) for n in (0, 1, 33, 200, 64)]
    got = stack_sequences([PackedSequence(s) for s in seqs], device=CPU)
    want = jseq.stack_sequences([jseq.PackedSequence(s) for s in seqs])
    np.testing.assert_array_equal(got.to_numpy()[0], np.asarray(want.words))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    empty = stack_sequences([], device=CPU)
    jempty = jseq.stack_sequences([])
    assert tuple(empty.words.shape) == tuple(jempty.words.shape)


def _batch_pair(words_u32, lengths):
    got = PackedReads.from_numpy(words_u32, lengths, device=CPU)
    want = jseq.PackedReads(words=jnp.asarray(words_u32), lengths=jnp.asarray(lengths, jnp.int32))
    return got, want


@pytest.mark.parametrize("W", [2, 4])
def test_getitem_matches_jax(W):
    """PackedReads[i] is a host PackedSequence equal to JAX's, at lengths
    0, 1, 16 W and past 16 W (the row's words, then zeros), and negative
    indices."""
    rng = np.random.default_rng(W)
    words = rng.integers(0, 2**32, (5, W), dtype=np.uint64).astype(np.uint32)
    lengths = np.array([0, 1, 16 * W, 16 * W + 40, 16 * W - 3], np.int32)
    got, want = _batch_pair(words, lengths)
    for i in range(-5, 5):
        g, w = got[i], want[i]
        assert isinstance(g, PackedSequence)
        assert (len(g), g.data.tolist()) == (len(w), w.data.tolist()), i
        assert g.to_vec() == w.to_vec()
    with pytest.raises(IndexError):
        got[5]


def test_iter_matches_jax():
    seqs = [_seq(n, 50 + n) for n in (3, 0, 70, 32)]
    got = PackedReads.from_ascii(seqs, device=CPU)
    want = jseq.PackedReads.from_ascii(seqs)
    items = list(got)
    assert [s.to_vec() for s in items] == [s.to_vec() for s in want] == [s.upper() for s in seqs]
    assert items == [PackedSequence(s) for s in seqs]
