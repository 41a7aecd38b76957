"""bitnuc_tpu_torch k-mer counting against bitnuc_tpu: count_kmers_reads
(plain, canonical, N-skip) against the JAX dispatcher, the plain versions
of the K3a/K3b kernels against the Pallas histograms in interpret mode,
K3b's plain version and count_kmers_dense, canonical or not, against JAX's
count_kmers_dense at edge lengths, a numpy model of K3b's register reverse
complement against JAX's revcomp_key, which kernel count_kmers_dense
routes to, canonical keys at k = 16 and 32 (unsigned compare), top_kmers
and spectrum. Every count matches exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import kmer as jkmer, revcomp as jrevcomp
from bitnuc_tpu.ops.pallas import histogram as jhist
from bitnuc_tpu_torch.ops import kmer, revcomp
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np, words_to_u32_np

torch.set_num_threads(1)


def _reads(rng, B, L, invalid=0.0):
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    from bitnuc_tpu.ops import codec as jcodec

    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    valid = rng.random((B, L)) >= invalid
    return np.asarray(w), lens, valid


@pytest.mark.parametrize("k", [1, 4, 8, 9, 12])
@pytest.mark.parametrize("variant", ["plain", "canonical", "base_valid"])
def test_count_kmers_reads_matches_jax(rng, k, variant):
    w, lens, valid = _reads(rng, 6, 70, invalid=0.05)
    canonical = variant == "canonical"
    bv = valid if variant == "base_valid" else None
    want = np.asarray(
        jkmer.count_kmers_reads(jnp.asarray(w), jnp.asarray(lens), k,
                                canonical=canonical, base_valid=bv)
    )
    got = kmer.count_kmers_reads(
        words_from_u32_np(w), torch.from_numpy(lens), k, canonical=canonical,
        base_valid=None if bv is None else torch.from_numpy(bv),
    )
    assert got.dtype == torch.int32 and got.shape == (4**k,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [2, 5, 8, 10])  # 10: the Pallas kernel's largest k
@pytest.mark.parametrize("kind", ["uniform", "poly_a", "out_of_range"])
def test_histogram_from_keys_plain_matches_pallas(rng, k, kind):
    keys = rng.integers(0, 4**k + 1, size=3000).astype(np.int32)  # 4^k = sentinel
    keys[:50] = 4**k
    if kind == "poly_a":  # every valid key 0
        keys[keys < 4**k] = 0
    elif kind == "out_of_range":  # negative keys and keys above 4^k, not counted
        keys[50:1050:2] = rng.integers(-(2**31), 0, size=500)
        keys[51:1051:2] = rng.integers(4**k + 1, 2**31, size=500)
        keys[1051:1055] = [-1, 4**k + 1, -(2**31), 2**31 - 1]
    want = np.asarray(jhist.histogram_from_keys(jnp.asarray(keys), k, interpret=True))
    got = kmer.histogram_from_keys_torch(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((keys >= 0) & (keys < 4**k)).sum())


@pytest.mark.parametrize("B,L,k", [(3, 40, 4), (1, 16, 1), (2, 33, 8)])
def test_histogram_from_words_plain_matches_pallas(rng, B, L, k):
    w, lens, _ = _reads(rng, B, L)
    want = np.asarray(
        jhist.histogram_from_words(jnp.asarray(w), jnp.asarray(lens), k, interpret=True)
    )
    got = kmer.histogram_from_words_torch(words_from_u32_np(w), torch.from_numpy(lens), k)
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_batch(rng, W, k):
    """[14, W] random words (bases past each length are not zero) with
    lengths -2, 0, k - 1, 16 W, 16 W + 7 and random ones, then an ACGT
    repeat (at k = 4, 8 and 12 its windows at even offsets are their own
    reverse complements), poly-A and poly-T rows."""
    lens = [-2, 0, k - 1, 16 * W, 16 * W + 7] + rng.integers(0, 16 * W + 1, 6).tolist()
    words = rng.integers(0, 2**32, size=(len(lens) + 3, W), dtype=np.uint32)
    words[-3], words[-2], words[-1] = 0xE4E4E4E4, 0, 0xFFFFFFFF  # ACGT..., A..., T...
    lens += [16 * W - 3, 16 * W + 7, 16 * W]
    return words, np.array(lens, np.int32)


@pytest.mark.parametrize("k", [1, 4, 7, 8, 9, 12])
@pytest.mark.parametrize("canonical", [False, True])
def test_histogram_from_words_matches_jax_dense(rng, k, canonical):
    """K3b's plain version and count_kmers_dense (which routes to it) equal
    JAX's count_kmers_dense, lengths <= 0, < k and past 16 W included."""
    words, lens = _edge_batch(rng, 3, k)
    want = np.asarray(jkmer.count_kmers_dense(jnp.asarray(words), jnp.asarray(lens), k,
                                              canonical=canonical))
    tw, tl = words_from_u32_np(words), torch.from_numpy(lens)
    for got in (kmer.histogram_from_words_torch(tw, tl, k, canonical),
                kmer.count_kmers_dense(tw, tl, k, canonical)):
        assert got.dtype == torch.int32 and got.shape == (4**k,)
        np.testing.assert_array_equal(got.numpy(), want)


def _brev32(x):
    """Bit reversal of uint32 values (CUDA's __brev)."""
    x = x.astype(np.uint32)
    for s, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x >> np.uint32(s)) & np.uint32(m)) | ((x & np.uint32(m)) << np.uint32(s))
    return (x >> np.uint32(16)) | (x << np.uint32(16))


def _revcomp16(x):
    """csrc/histogram.cu revcomp16: the pair swap of __brev(~x)."""
    b = _brev32(~x.astype(np.uint32))
    m = np.uint32(0x55555555)
    return ((b >> np.uint32(1)) & m) | ((b & m) << np.uint32(1))


def _funnelshift_r(lo, hi, s):
    """CUDA's __funnelshift_r: the low 32 bits of hi:lo >> (s & 31)."""
    pair = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (pair >> np.uint64(s & 31)).astype(np.uint32)


def _canonical_model(w, nx, j, k):
    """csrc/histogram.cu word_windows with kCanonical: (key, rc, min(key,
    rc)) of window j of the word pair nx:w, rc read from rc(w):rc(nx)
    shifted down by 32 - 2k."""
    mask = np.uint32(4**k - 1)
    rw, rn = _revcomp16(w), _revcomp16(nx)
    hi = rw >> np.uint32(32 - 2 * k)
    lo = _funnelshift_r(rn, rw, 32 - 2 * k)
    key = _funnelshift_r(w, nx, 2 * j) & mask
    rc = (hi if j == 0 else _funnelshift_r(lo, hi, 32 - 2 * j)) & mask
    return key, rc, np.minimum(key, rc)


@pytest.mark.parametrize("k", range(1, 13))
def test_register_revcomp_model_matches_jax(rng, k):
    """Every window j of a word pair, each holding every key for k <= 9 and
    200,000 random keys above, the pair's other bases random."""
    if k <= 9:
        key = np.arange(4**k, dtype=np.uint64)
    else:
        key = rng.integers(0, 4**k, 200_000, dtype=np.uint64)
    zero = jnp.zeros(key.shape, jnp.uint32)
    want_rc, _ = jrevcomp.revcomp_key(jnp.asarray(key.astype(np.uint32)), zero, k)
    want_canon, _ = jrevcomp.canonical_keys(jnp.asarray(key.astype(np.uint32)), zero, k)
    for j in range(16):
        pair = rng.integers(0, 2**32, (2,) + key.shape, dtype=np.uint64)
        pair = (pair[0] << np.uint64(32)) | pair[1]
        field = np.uint64(4**k - 1) << np.uint64(2 * j)
        pair = (pair & ~field) | (key << np.uint64(2 * j))
        w = (pair & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        nx = (pair >> np.uint64(32)).astype(np.uint32)
        got_key, rc, canon = _canonical_model(w, nx, j, k)
        np.testing.assert_array_equal(got_key, key.astype(np.uint32))
        np.testing.assert_array_equal(rc, np.asarray(want_rc))
        np.testing.assert_array_equal(canon, np.asarray(want_canon))


@pytest.mark.parametrize("canonical", [False, True])
def test_count_kmers_dense_routes(rng, monkeypatch, canonical):
    """Counts with no base_valid reach K3b (histogram_from_words), canonical
    or not; counts with base_valid reach K3a (histogram_from_keys)."""
    w, lens, valid = _reads(rng, 3, 40)
    calls = []
    real_words, real_keys = kmer.histogram_from_words, kmer.histogram_from_keys

    def words_spy(*args):
        calls.append(("words", args[3]))
        return real_words(*args)

    def keys_spy(*args):
        calls.append(("keys", None))
        return real_keys(*args)

    monkeypatch.setattr(kmer, "histogram_from_words", words_spy)
    monkeypatch.setattr(kmer, "histogram_from_keys", keys_spy)
    tw, tl = words_from_u32_np(w), torch.from_numpy(lens)
    kmer.count_kmers_dense(tw, tl, 8, canonical)
    assert calls == [("words", canonical)]
    kmer.count_kmers_dense(tw, tl, 8, canonical, base_valid=torch.from_numpy(valid))
    assert calls == [("words", canonical), ("keys", None)]


@pytest.mark.parametrize("k", [16, 17, 32])
def test_canonical_keys_unsigned(rng, k):
    lo = rng.integers(0, 2**32, 400, dtype=np.uint32)
    hi = rng.integers(0, 2**32, 400, dtype=np.uint32)
    if k <= 16:
        hi[:] = 0
    else:
        hi &= np.uint32((1 << (2 * (k - 16))) - 1) if k < 32 else np.uint32(0xFFFFFFFF)
    lo[:3] = [0xFFFFFFFF, 0x80000000, 0]
    want = jrevcomp.canonical_keys(jnp.asarray(lo), jnp.asarray(hi), k)
    got = revcomp.canonical_keys(words_from_u32_np(lo), words_from_u32_np(hi), k)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(words_to_u32_np(g), np.asarray(w_))


@pytest.mark.parametrize("k", [5, 20])
def test_kmer_keys_match(rng, k):
    codes = rng.integers(0, 4, size=(2, 64)).astype(np.uint8)
    want = jkmer.kmer_keys(jnp.asarray(codes), k)
    got = kmer.kmer_keys(torch.from_numpy(codes), k)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(words_to_u32_np(g)[:, : 64 - k + 1],
                                      np.asarray(w_)[:, : 64 - k + 1])


def test_top_kmers_and_spectrum(rng):
    hist = rng.integers(0, 6, size=256).astype(np.int32)
    hist[[3, 7, 200]] = 9  # ties resolve to the lowest key
    for n in (5, 300):
        want = jkmer.top_kmers(jnp.asarray(hist), n)
        got = kmer.top_kmers(torch.from_numpy(hist), n)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    for max_mult in (1, 4, 255):
        want = np.asarray(jkmer.spectrum(jnp.asarray(hist), max_mult))
        got = kmer.spectrum(torch.from_numpy(hist), max_mult)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sort_engines_not_ported_yet(rng):
    """The sort engines are ported: modes 'sorted', 'runs', 'auto' and
    'auto_layout' give the JAX package's arrays (tests/test_torch_sparse.py
    covers them in depth); an unknown mode still raises."""
    w, lens, _ = _reads(rng, 3, 40)
    jw, tw, tl = jnp.asarray(w), words_from_u32_np(w), torch.from_numpy(lens)
    for mode, k, jfn in (
        ("sorted", 5, jkmer.count_kmers_sorted),
        ("runs", 5, jkmer.count_kmers_runs),
        ("auto", 13, jkmer.count_kmers_runs),
        ("auto_layout", 13, jkmer.count_kmers_runs),
        ("auto_layout", 9, jkmer.count_kmers_dense),
    ):
        got = kmer.count_kmers_reads(tw, tl, k, mode=mode)
        want = jfn(jw, jnp.asarray(lens), k)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy().reshape(-1).view(np.uint32),
                np.asarray(w_).reshape(-1).view(np.uint32),
            )
    with pytest.raises(ValueError):
        kmer.count_kmers_reads(tw, tl, 5, mode="nope")
