"""bitnuc_tpu_torch analysis and reverse complement against bitnuc_tpu.
Base counts and reverse complements match exactly; GC content is float32
computed in the JAX package's order of operations, so it matches exactly
too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import analysis as janalysis, codec as jcodec, revcomp as jrevcomp
from bitnuc_tpu_torch.ops import analysis, revcomp
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np, words_to_u32_np

torch.set_num_threads(1)


def _reads(rng, B, L):
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[:4] = [0, 1, min(16, L), L][: min(4, B)]
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    return np.asarray(w), lens


@pytest.mark.parametrize("B,L", [(5, 7), (40, 150), (9, 333)])
def test_base_counts_and_gc(rng, B, L):
    w, lens = _reads(rng, B, L)
    tw, tl = words_from_u32_np(w), torch.from_numpy(lens)
    np.testing.assert_array_equal(
        analysis.base_counts_reads(tw, tl).numpy(),
        np.asarray(janalysis.base_counts_reads(jnp.asarray(w), jnp.asarray(lens))),
    )
    got = analysis.gc_content_reads(tw, tl)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(janalysis.gc_content_reads(jnp.asarray(w), jnp.asarray(lens)))
    )


@pytest.mark.parametrize("B,L", [(5, 7), (40, 150), (9, 333), (3, 64)])
def test_reverse_complement_reads(rng, B, L):
    w, lens = _reads(rng, B, L)
    want = np.asarray(jrevcomp.reverse_complement_reads(jnp.asarray(w), jnp.asarray(lens)))
    got = revcomp.reverse_complement_reads(words_from_u32_np(w), torch.from_numpy(lens))
    np.testing.assert_array_equal(words_to_u32_np(got), want)


def test_revcomp_word_high_bits(rng):
    x = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    x[:2] = [0xFFFFFFFF, 0x80000000]
    want = np.asarray(jrevcomp.revcomp_word(jnp.asarray(x)))
    got = revcomp.revcomp_word(words_from_u32_np(x))
    np.testing.assert_array_equal(words_to_u32_np(got), want)
