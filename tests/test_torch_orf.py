"""bitnuc_tpu_torch.ops.orf against bitnuc_tpu.ops.orf (its XLA path): the
longest ORF over six frames and frame-0 translation on the JAX tests'
planted reads, on ragged random reads (lengths 0 to 700, rows not a
multiple of 3, reads with no ATG and all-stop reads), and the ``orf
--translate`` steps (reverse complement, slice, translate). The plain
version of K10 is also held against the TPU kernel in interpret mode.
Every output is an integer: equal bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu import config as jconfig
from bitnuc_tpu.ops import orf as jorf
from bitnuc_tpu.ops import revcomp as jrevcomp
from bitnuc_tpu.ops import split as jsplit
from bitnuc_tpu.ops.pallas.orfscan import best_orf_one_strand_pallas
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu.utils import bitops as jbitops
from bitnuc_tpu_torch.ops import orf, revcomp, split
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)

PLANTED = [
    b"CCGGCC" + b"ATG" + b"GCC" * 10 + b"TAA" + b"CCGGCC",
    b"GG" + b"ATG" + b"GTC" * 12 + b"GG",
    b"ATGAAATAA", b"ATGAAAAA", b"CCCCCCCC", b"ATGTAA",
    b"TTTATGATGAAATGAAAATAG",  # nested starts sharing one stop
    b"", b"A", b"AT", b"ATG", b"TTACAT",
    b"TAATAGTGA" * 7, b"ATG" * 20,
]


def _random_reads(seed, n, max_len, p=None):
    """n reads of random length in [0, max_len]; ``p`` weights ACGT (ATG-
    and stop-rich with A and T heavy)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [bytes(acgt[rng.choice(4, int(m), p=p)])
            for m in rng.integers(0, max_len + 1, n)]


def _pack(seqs):
    jr = JPackedReads.from_ascii(seqs)
    w, n = np.asarray(jr.words), np.asarray(jr.lengths)
    return jr, words_from_u32_np(w), torch.from_numpy(n.copy())


def _jax_xla(fn, *args):
    with jconfig.backend("xla"):
        return fn(*args)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


READ_SETS = {
    "planted": PLANTED,
    "random": _random_reads(1, 60, 300),
    "at_rich": _random_reads(2, 60, 700, p=[0.35, 0.1, 0.2, 0.35]),
    "long": _random_reads(3, 4, 2000, p=[0.3, 0.2, 0.2, 0.3]),
}


@pytest.mark.parametrize("name", list(READ_SETS))
def test_longest_orf_matches_jax(name):
    jr, w, n = _pack(READ_SETS[name])
    jorf.longest_orf.clear_cache()
    want = _jax_xla(jorf.longest_orf, jr.words, jr.lengths)
    jorf.longest_orf.clear_cache()
    got = orf.longest_orf(w, n)
    for i, (g, x) in enumerate(zip(got, want)):
        _eq(g, x, f"output {i}")


@pytest.mark.parametrize("name", list(READ_SETS))
def test_plain_one_strand_matches_pallas_interpret(name):
    jr, w, n = _pack(READ_SETS[name])
    codes = jbitops.unpack_words(jr.words)
    b, s, st = best_orf_one_strand_pallas(codes, jr.lengths, interpret=True)
    want = (b, jnp.where(b > 0, s, 0), st)
    got = orf.best_orf_one_strand_torch(w, n)
    for g, x, what in zip(got, want, ("length", "start", "stopped")):
        _eq(g, x, what)


def test_one_strand_past_the_tpu_bound():
    """Rows past 32,767 bases, where the TPU kernel does not go: the plain
    version equals JAX's XLA path."""
    seqs = _random_reads(4, 3, 40_000, p=[0.3, 0.2, 0.2, 0.3])
    seqs[0] = b"ATG" + b"GCC" * 12_000 + b"TAG"
    jr, w, n = _pack(seqs)
    want = _jax_xla(jorf._best_orf_one_strand, jr.words, jr.lengths)
    for g, x in zip(orf.best_orf_one_strand_torch(w, n), want):
        _eq(g, x)
    assert int(orf.best_orf_one_strand_torch(w, n)[0][0]) == 36_003


@pytest.mark.parametrize("name", ["planted", "random", "at_rich"])
def test_translate_reads_matches_jax(name):
    jr, w, n = _pack(READ_SETS[name])
    want = jorf.translate_reads(jr.words, jr.lengths)
    got = orf.translate_reads(w, n)
    for g, x in zip(got, want):
        _eq(g, x)
    assert got[0].dtype == torch.uint8


def test_orf_translate_steps_match_jax():
    """bitnuc-tpu orf --translate: each ORF sliced from its own strand and
    translated."""
    jr, w, n = _pack(READ_SETS["at_rich"])
    jorf.longest_orf.clear_cache()
    ln, s, e, isrc, _ = map(np.asarray, _jax_xla(jorf.longest_orf, jr.words, jr.lengths))
    jorf.longest_orf.clear_cache()
    jrc = jrevcomp.reverse_complement_reads(jr.words, jr.lengths)
    jw = jnp.where(jnp.asarray(isrc)[:, None], jrc, jr.words)
    start = np.where(isrc, np.asarray(jr.lengths) - e, s)
    ow, olen = jsplit.slice_reads(jw, jr.lengths, jnp.asarray(start, np.int32), jnp.asarray(ln))
    want = jorf.translate_reads(ow, olen)

    gl, gs, ge, grc, _ = orf.longest_orf(w, n)
    rc = revcomp.reverse_complement_reads(w, n)
    tw = torch.where(grc[:, None], rc, w)
    tstart = torch.where(grc, n - ge, gs)
    tw, tlen = split.slice_reads(tw, n, tstart, gl)
    got = orf.translate_reads(tw, tlen)
    for g, x in zip(got, want):
        _eq(g, x)
