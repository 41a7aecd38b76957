"""bitnuc_tpu_torch.utils.bitops against bitnuc_tpu.utils.bitops: the int32
bit-view helpers must give the JAX package's uint32 bits, including for
words with the high bit set. Integer results match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.utils import bitops as jb
from bitnuc_tpu_torch.utils import bitops as tb

torch.set_num_threads(1)


def _words(rng, shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    w.reshape(-1)[:4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    return w


def test_pack_unpack_codes(rng):
    codes = rng.integers(0, 4, size=(3, 5, 64)).astype(np.uint8)
    want = np.asarray(jb.pack_codes(jnp.asarray(codes)))
    got = tb.pack_codes(torch.from_numpy(codes))
    np.testing.assert_array_equal(tb.words_to_u32_np(got), want)
    words = _words(rng, (4, 6))
    want_c = np.asarray(jb.unpack_words(jnp.asarray(words)))
    got_c = tb.unpack_words(tb.words_from_u32_np(words)).numpy()
    np.testing.assert_array_equal(got_c, want_c)


def test_pack_codes_rejects_ragged_length():
    with pytest.raises(ValueError):
        tb.pack_codes(torch.zeros((2, 17), dtype=torch.int32))


@pytest.mark.parametrize("W", [1, 2, 6])
def test_word_valid_mask(W):
    lengths = np.arange(-3, 16 * W + 20, dtype=np.int32)
    want = np.asarray(jb.word_valid_mask(W, jnp.asarray(lengths)))
    got = tb.word_valid_mask(W, torch.from_numpy(lengths))
    np.testing.assert_array_equal(tb.words_to_u32_np(got), want)


def test_popcount_and_basewise_diff(rng):
    x = _words(rng, (257,))
    y = _words(rng, (257,))
    want = np.asarray(jb.popcount32(jnp.asarray(x)))
    got = tb.popcount32(tb.words_from_u32_np(x)).numpy()
    np.testing.assert_array_equal(got, want)
    want_d = np.asarray(jb.basewise_diff(jnp.asarray(x), jnp.asarray(y)))
    got_d = tb.basewise_diff(tb.words_from_u32_np(x), tb.words_from_u32_np(y))
    np.testing.assert_array_equal(tb.words_to_u32_np(got_d), want_d)


def test_logical_shifts(rng):
    x = _words(rng, (64,))
    t = tb.words_from_u32_np(x)
    for s in range(32):
        np.testing.assert_array_equal(tb.words_to_u32_np(tb.srl(t, s)), x >> np.uint32(s))
    s = rng.integers(0, 32, size=64).astype(np.int32)
    got = tb.srl(t, torch.from_numpy(s))
    np.testing.assert_array_equal(tb.words_to_u32_np(got), x >> s.astype(np.uint32))


def test_flip_sign_orders_unsigned(rng):
    a, b = _words(rng, (500,)), _words(rng, (500,))
    f = tb.flip_sign
    got = (f(tb.words_from_u32_np(a)) < f(tb.words_from_u32_np(b))).numpy()
    np.testing.assert_array_equal(got, a < b)


def test_ascii_helpers_all_bytes():
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tb.ascii_is_valid(torch.from_numpy(b)).numpy(),
        np.asarray(jb.ascii_is_valid(jnp.asarray(b))),
    )
    np.testing.assert_array_equal(
        tb.ascii_to_code(torch.from_numpy(b)).numpy(),
        np.asarray(jb.ascii_to_code(jnp.asarray(b))).astype(np.int32),
    )
    codes = np.arange(4, dtype=np.uint8)
    np.testing.assert_array_equal(
        tb.code_to_ascii(torch.from_numpy(codes)).numpy(),
        np.asarray(jb.code_to_ascii(jnp.asarray(codes))),
    )


def test_host_views_roundtrip(rng):
    w = _words(rng, (3, 8))
    np.testing.assert_array_equal(tb.words_u32_to_u64_np(w), jb.words_u32_to_u64_np(w))
    np.testing.assert_array_equal(tb.words_u64_to_u32_np(tb.words_u32_to_u64_np(w)), w)
    np.testing.assert_array_equal(tb.words_to_u32_np(tb.words_from_u32_np(w)), w)
    assert tb.n_words_for(33) == jb.n_words_for(33) == 4
