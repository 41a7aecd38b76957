"""bitnuc_tpu_torch.ops.split against bitnuc_tpu.ops.split: funnel shifts,
splits, slices and single-base reads of random packed words (garbage past
each length, bits in the sign position), with scalar and per-read
offsets, offsets at word boundaries, zero and past each length. Every
output is equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import split as jsplit
from bitnuc_tpu_torch.ops import split
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)


def _eq(got, want):
    want = np.asarray(want)
    g = got.numpy()
    if want.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.shape == want.shape
    np.testing.assert_array_equal(g, want)


def _batch(seed, B, W):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, 16 * W + 1, B).astype(np.int32)
    return rng, words, lengths


@pytest.mark.parametrize("B,W", [(7, 1), (20, 4), (9, 10)])
def test_shift_reads_down_matches_jax(B, W):
    rng, words, _ = _batch(B + W, B, W)
    per_read = rng.integers(0, 16 * W + 20, B).astype(np.int32)
    per_read[:4] = [0, 16, 15, 16 * W]
    for n in (per_read, 0, 16, 17, 16 * W - 1):
        # the JAX function takes per-read shifts only; the port also a scalar
        want = jsplit.shift_reads_down(jnp.asarray(words), jnp.asarray(np.broadcast_to(n, B)))
        _eq(split.shift_reads_down(words_from_u32_np(words), torch.as_tensor(n)), want)


@pytest.mark.parametrize("B,W", [(7, 2), (30, 4), (5, 10)])
def test_split_reads_matches_jax(B, W):
    rng, words, lengths = _batch(2 * B + W, B, W)
    per_read = rng.integers(0, 16 * W + 1, B).astype(np.int32)
    for idx in (per_read, 0, 16, 33):
        got = split.split_reads(words_from_u32_np(words), torch.from_numpy(lengths),
                                torch.as_tensor(idx))
        want = jsplit.split_reads(jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(idx))
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("B,W", [(7, 2), (30, 4), (5, 10)])
def test_slice_reads_matches_jax(B, W):
    rng, words, lengths = _batch(3 * B + W, B, W)
    start = rng.integers(0, 16 * W + 4, B).astype(np.int32)
    size = rng.integers(0, 16 * W + 4, B).astype(np.int32)
    for s, z in ((start, size), (0, 20), (start, 1), (5, size), (16 * W, 3)):
        got = split.slice_reads(words_from_u32_np(words), torch.from_numpy(lengths),
                                torch.as_tensor(s), torch.as_tensor(z))
        want = jsplit.slice_reads(jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(s),
                                  jnp.asarray(z))
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("B,W", [(11, 2), (40, 6)])
def test_get_reads_matches_jax(B, W):
    rng, words, lengths = _batch(4 * B + W, B, W)
    index = rng.integers(0, 16 * W, B).astype(np.int32)
    for i in (index, 0, 15, 16, 16 * W - 1):
        _eq(split.get_reads(words_from_u32_np(words), torch.from_numpy(lengths),
                            torch.as_tensor(i)),
            jsplit.get_reads(jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(i)))
