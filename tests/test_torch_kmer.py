"""bitnuc_tpu_torch k-mer counting against bitnuc_tpu: count_kmers_reads
(plain, canonical, N-skip) against the JAX dispatcher, the plain versions
of the K3a/K3b kernels against the Pallas histograms in interpret mode,
canonical keys at k = 16 and 32 (unsigned compare), top_kmers and
spectrum. Every count matches exactly."""

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


@pytest.mark.parametrize("k", [2, 5])
def test_histogram_from_keys_plain_matches_pallas(rng, k):
    keys = rng.integers(0, 4**k + 1, size=3000).astype(np.int32)  # 4^k = sentinel
    keys[:50] = 4**k
    want = np.asarray(jhist.histogram_from_keys(jnp.asarray(keys), k, interpret=True))
    got = kmer.histogram_from_keys_torch(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((keys < 4**k).sum())


@pytest.mark.parametrize("B,L,k", [(3, 40, 4), (1, 16, 1), (2, 33, 8)])
def test_histogram_from_words_plain_matches_pallas(rng, B, L, k):
    w, lens, _ = _reads(rng, B, L)
    want = np.asarray(
        jhist.histogram_from_words(jnp.asarray(w), jnp.asarray(lens), k, interpret=True)
    )
    got = kmer.histogram_from_words_torch(words_from_u32_np(w), torch.from_numpy(lens), k)
    np.testing.assert_array_equal(got.numpy(), want)


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


def test_sort_engines_not_ported_yet():
    w = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.tensor([20, 20], dtype=torch.int32)
    for mode, k in (("sorted", 5), ("runs", 5), ("auto", 13)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            kmer.count_kmers_reads(w, lens, k, mode=mode)
    with pytest.raises(ValueError):
        kmer.count_kmers_reads(w, lens, 5, mode="nope")
