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
from bitnuc_tpu_torch import config
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


# A numpy model of csrc/orf.cu's SWAR codon masks: bit 2t of a mask is
# base t of a word; words are uint32 and the next word's low bases come in
# by a funnel shift.
_EVEN = np.uint32(0x55555555)
_FRAME = np.array([0x41041041, 0x04104104, 0x10410410], np.uint32)  # t mod 3 = 0, 1, 2


def _is_a(w):
    return ~(w | (w >> np.uint32(1))) & _EVEN


def _is_g(w):
    return ~w & (w >> np.uint32(1)) & _EVEN


def _is_t(w):
    return w & (w >> np.uint32(1)) & _EVEN


def _funnel(w, nx, s):
    return ((w.astype(np.uint64) | (nx.astype(np.uint64) << np.uint64(32)))
            >> np.uint64(s)).astype(np.uint32)


def _swar_codons(w, nx):
    """(stop, start) masks: stop = T & (A1 & (A2 | G2) | G1 & A2), start =
    A & T1 & G2, where 1 and 2 are the bases after."""
    w1, w2 = _funnel(w, nx, 2), _funnel(w, nx, 4)
    a1, g1, a2, g2 = _is_a(w1), _is_g(w1), _is_a(w2), _is_g(w2)
    return _is_t(w) & ((a1 & (a2 | g2)) | (g1 & a2)), _is_a(w) & _is_t(w1) & g2


def test_swar_masks_match_codon_table():
    """Every codon at every base offset t of a word (the last two spilling
    into the next word) and every word index mod 3: the stop and start
    masks hold bit 2t exactly for TAA, TAG, TGA and ATG; the frame mask of
    t mod 3 holds it; the first stop of each frame, relabelled for the word
    before (the kernel's rotation), lands in absolute frame (16 j + t) mod 3
    at position 16 j + t."""
    codon, t, jm = np.meshgrid(np.arange(64), np.arange(16), np.arange(3), indexing="ij")
    codon, t, jm = codon.ravel(), t.ravel(), jm.ravel()
    codes = np.ones((codon.size, 32), np.uint64)  # C around the codon: no other codon forms
    for k, shift in enumerate((4, 2, 0)):
        codes[np.arange(codon.size), t + k] = (codon >> shift) & 3
    packed = (codes.reshape(-1, 2, 16) << (2 * np.arange(16, dtype=np.uint64))).sum(-1)
    w, nx = packed[:, 0].astype(np.uint32), packed[:, 1].astype(np.uint32)
    stop, start = _swar_codons(w, nx)
    bit = np.uint32(1) << (2 * t).astype(np.uint32)
    is_stop = np.isin(codon, [0b110000, 0b110010, 0b111000])  # TAA, TAG, TGA
    np.testing.assert_array_equal(stop, np.where(is_stop, bit, 0))
    np.testing.assert_array_equal(start, np.where(codon == 0b001110, bit, 0))  # ATG
    np.testing.assert_array_equal(_FRAME[t % 3] & bit, bit)
    np.testing.assert_array_equal(_FRAME[(t + 1) % 3] & bit, 0)
    # fold: each frame's first stop, then word j - 1's labels (r -> r - 1)
    j = 3 + jm
    p = 16 * j + t
    first = np.where((stop[:, None] & _FRAME) != 0, p[:, None], -1)  # [n, 3] by t mod 3
    relabelled = first[:, [2, 0, 1]]
    absolute = (j[:, None] - 1 + np.arange(3)) % 3
    hit = relabelled >= 0
    np.testing.assert_array_equal(hit.sum(1), is_stop)
    np.testing.assert_array_equal(absolute[hit], p[is_stop] % 3)
    np.testing.assert_array_equal(relabelled[hit], p[is_stop])


def test_reverse_complement_word_by_bit_reversal():
    """The kernel's reverse-complement word, the 2-bit pairs of the bit
    reversal of ~w swapped, equals ops.revcomp.revcomp_word."""
    w = np.random.default_rng(5).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    rev = np.array([int(f"{int(x):032b}"[::-1], 2) for x in ~w], np.uint32)
    want = ((rev >> np.uint32(1)) & _EVEN) | ((rev & _EVEN) << np.uint32(1))
    got = revcomp.revcomp_word(words_from_u32_np(w))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _past_the_words(seqs):
    """Rows whose lengths pass 16 W (bases there read as A), 16 W - 1 and
    ragged: the reverse complement's clamped source words."""
    jr, w, n = _pack(seqs)
    W = w.shape[1]
    n = n.clone()
    n[0::3] = 16 * W + torch.arange(1, len(n[0::3]) + 1, dtype=torch.int32) % 40
    n[1::3] = 16 * W - 1
    return w, n


@pytest.mark.parametrize("name", list(READ_SETS) + ["past_words"])
def test_plain_two_strands_match_jax(name):
    """best_orf_two_strands_torch == JAX's one-strand scan (XLA path) of the
    words and of JAX's reverse_complement_reads."""
    if name == "past_words":
        w, n = _past_the_words(READ_SETS["at_rich"])
    else:
        _, w, n = _pack(READ_SETS[name])
    jw, jn = jnp.asarray(w.numpy().view(np.uint32)), jnp.asarray(n.numpy())
    jrc = jrevcomp.reverse_complement_reads(jw, jn)
    got = orf.best_orf_two_strands_torch(w, n)
    for strand, words in enumerate((jw, jrc)):
        want = _jax_xla(jorf._best_orf_one_strand, words, jn)
        for g, x, what in zip(got, want, ("length", "start", "stopped")):
            _eq(g[strand], x, f"strand {strand} {what}")


def test_longest_orf_kernel_backend_refuses_cpu_words():
    """Under the kernel backend a CPU tensor raises: no silent fallback to
    the plain version."""
    _, w, n = _pack(PLANTED)
    with config.backend("kernel"), pytest.raises(ValueError, match="CUDA"):
        orf.longest_orf(w, n)
