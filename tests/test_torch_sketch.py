"""The sketch family of bitnuc_tpu_torch.ops.kmer against bitnuc_tpu.ops.kmer:
minimizers, minimizer_sketch, sketch_jaccard, sketch_containment and their
pair-key forms (minimizers64, minimizer_sketch64, sketch_jaccard64,
sketch_containment64), with _sliding_min2 and _sketch_overlap, at k = 1,
15, 16 and 31, canonical and not, on the same numpy-seeded reads; and a
host set model of the distinct minimizers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnuc_tpu.ops import kmer as jkmer
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch.ops import kmer
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np, words_to_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _reads(seed, n=12, lo=0, hi=90):
    rng = np.random.default_rng(seed)
    out = [ACGT[rng.integers(0, 4, int(rng.integers(lo, hi)))].tobytes() for _ in range(n)]
    out[0] = b"T" * 40  # the all-T key: the u32 sentinel at k = 16
    out[1] = b"ACGT" * 12
    return out


def _both(reads):
    return (JPackedReads.from_ascii(reads),
            PackedReads.from_ascii(reads, device=CPU))


def _equal(got, want):
    """Port results against JAX's, int32 views read as uint32 where JAX's
    are uint32."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = words_to_u32_np(g) if w.dtype == np.uint32 else g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


KW = [(1, 1), (1, 5), (15, 10), (16, 4), (31, 3), (21, 10), (7, 1)]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,w", KW)
def test_minimizers_match_jax(k, w, canonical):
    jr, tr = _both(_reads(k * 10 + w))
    if k <= 16:
        _equal(kmer.minimizers(tr.words, tr.lengths, k, w, canonical),
               jkmer.minimizers(jr.words, jr.lengths, k, w, canonical))
    _equal(kmer.minimizers64(tr.words, tr.lengths, k, w, canonical),
           jkmer.minimizers64(jr.words, jr.lengths, k, w, canonical))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,w", KW)
def test_sketches_and_ratios_match_jax(k, w, canonical):
    ra, rb = _reads(k + 1, hi=120), _reads(k + 2, hi=120)
    rb[2:5] = ra[2:5]  # shared content
    (ja, ta), (jb, tb) = _both(ra), _both(rb)
    if k <= 15:
        sa = kmer.minimizer_sketch(ta.words, ta.lengths, k, w, canonical)
        sb = kmer.minimizer_sketch(tb.words, tb.lengths, k, w, canonical)
        wa = jkmer.minimizer_sketch(ja.words, ja.lengths, k, w, canonical)
        wb = jkmer.minimizer_sketch(jb.words, jb.lengths, k, w, canonical)
        _equal(sa, wa)
        _equal(sb, wb)
        for fn in ("sketch_jaccard", "sketch_containment"):
            _equal([getattr(kmer, fn)(sa[0], sb[0])], [getattr(jkmer, fn)(wa[0], wb[0])])
            _equal([getattr(kmer, fn)(sb[0], sa[0])], [getattr(jkmer, fn)(wb[0], wa[0])])
    sa = kmer.minimizer_sketch64(ta.words, ta.lengths, k, w, canonical)
    sb = kmer.minimizer_sketch64(tb.words, tb.lengths, k, w, canonical)
    wa = jkmer.minimizer_sketch64(ja.words, ja.lengths, k, w, canonical)
    wb = jkmer.minimizer_sketch64(jb.words, jb.lengths, k, w, canonical)
    _equal(sa, wa)
    for fn in ("sketch_jaccard64", "sketch_containment64"):
        _equal([getattr(kmer, fn)(*sa[:2], *sb[:2])], [getattr(jkmer, fn)(*wa[:2], *wb[:2])])


def test_sketch_empty_and_overlap():
    """Empty sketches give 0.0; _sketch_overlap counts as JAX's does."""
    jr, tr = _both([b"ACG", b""])
    s = kmer.minimizer_sketch(tr.words, tr.lengths, 15, 10)
    assert int(s[1]) == 0
    assert float(kmer.sketch_jaccard(s[0], s[0])) == 0.0
    assert float(kmer.sketch_containment(s[0], s[0])) == 0.0
    s64 = kmer.minimizer_sketch64(tr.words, tr.lengths, 21, 10)
    assert float(kmer.sketch_jaccard64(*s64[:2], *s64[:2])) == 0.0
    rng = np.random.default_rng(4)
    a = np.unique(rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32))
    b = np.unique(np.concatenate([a[:20], rng.integers(0, 2**32, 30, dtype=np.uint64)
                                  .astype(np.uint32)]))
    pad = lambda x, n: np.concatenate([x, np.full(n - len(x), 0xFFFFFFFF, np.uint32)])
    a, b = pad(a, 64), pad(b, 64)
    got = kmer._sketch_overlap(words_from_u32_np(a), words_from_u32_np(b))
    want = jkmer._sketch_overlap(jnp.asarray(a), jnp.asarray(b))
    assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("w", [1, 2, 3, 7, 8, 13])
def test_sliding_min2_matches_jax(w):
    rng = np.random.default_rng(w)
    hi = rng.integers(0, 4, (3, 37), dtype=np.uint64).astype(np.uint32)
    hi[0, ::5] = 0xFFFFFFFF
    lo = rng.integers(0, 2**32, (3, 37), dtype=np.uint64).astype(np.uint32)
    want = jkmer._sliding_min2(jnp.asarray(hi), jnp.asarray(lo), w, jnp.uint32(0xFFFFFFFF))
    got = kmer._sliding_min2(words_from_u32_np(hi), words_from_u32_np(lo), w, -1)
    _equal(got, want)


def test_sketch_equals_host_set_model():
    """The sketch's distinct values are the set of every valid window's
    minimum k-mer; Jaccard and containment follow from the sets."""
    k, w = 11, 6
    ra, rb = _reads(91, hi=200), _reads(92, hi=200)
    rb[3:8] = ra[3:8]

    def model(reads):
        out = set()
        for r in reads:
            keys = [int(r[p : p + k].translate(bytes.maketrans(b"ACGT", b"0123"))[::-1], 4)
                    for p in range(len(r) - k + 1)]
            out |= {min(keys[p : p + w]) for p in range(len(keys) - w + 1)}
        return out

    sets = [model(ra), model(rb)]
    sk = []
    for reads, want in zip((ra, rb), sets):
        t = PackedReads.from_ascii(reads, device=CPU)
        vals, n = kmer.minimizer_sketch(t.words, t.lengths, k, w)
        assert set(words_to_u32_np(vals[: int(n)]).tolist()) == want
        sk.append(vals)
    inter, union = len(sets[0] & sets[1]), len(sets[0] | sets[1])
    assert float(kmer.sketch_jaccard(*sk)) == np.float32(inter) / np.float32(union)
    assert float(kmer.sketch_containment(*sk)) == np.float32(inter) / np.float32(len(sets[0]))


def test_sketch_asserts_on_k():
    t = PackedReads.from_ascii([b"ACGT" * 10], device=CPU)
    for fn, k in ((kmer.minimizers, 17), (kmer.minimizer_sketch, 16), (kmer.minimizers64, 32),
                  (kmer.minimizer_sketch64, 32), (kmer.minimizers, 0)):
        with pytest.raises(AssertionError):
            fn(t.words, t.lengths, k, 4)
