"""bitnuc_tpu_torch.ops.correct against bitnuc_tpu.ops.correct on the same
numpy-seeded reads and tables, words and counts exactly: reads drawn from
a genome with planted substitutions (at the first and last base too),
k > L, N sites through base_valid (narrower than the words' bases too),
canonical keys on and off, ties between variants, min_count as a tensor,
and rounds 1 and 4 with the early exit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import codec as jcodec, correct as jcorrect
from bitnuc_tpu_torch.ops import correct
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np, words_to_u32_np
from conftest import random_seq

torch.set_num_threads(1)
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _key(win: bytes, canonical: bool) -> int:
    from bitnuc_tpu import oracle

    key = oracle.as_2bit(win)
    return min(key, oracle.as_2bit(win.translate(_RC)[::-1])) if canonical else key


def _table(seqs, k, canonical):
    out = {}
    for s in seqs:
        for p in range(len(s) - k + 1):
            w = s[p : p + k]
            if b"N" not in w:
                out[_key(w, canonical)] = out.get(_key(w, canonical), 0) + 1
    keys = np.fromiter(out.keys(), np.uint64, len(out))
    return ((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (keys >> np.uint64(32)).astype(np.uint32),
            np.fromiter(out.values(), np.int64, len(out)).astype(np.int32))


def _batch(seqs):
    L = max(max(len(s) for s in seqs), 1)
    a = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        a[i, : len(s)] = np.frombuffer(s, np.uint8)
    lens = np.array([len(s) for s in seqs], np.int32)
    w, _ = jcodec.encode_reads(jnp.asarray(a), jnp.asarray(lens))
    bv = np.array(jcodec.validity_mask(jnp.asarray(a), jnp.asarray(lens)))
    return np.asarray(w), lens, bv


def _reads_with_errors(rng, genome: bytes, n, L, n_err=(0, 3), n_rate=0.0, edges=False):
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(genome) - L + 1))
        s = bytearray(genome[p : p + L])
        sites = list(rng.integers(0, L, int(rng.integers(*n_err))))
        if edges:
            sites.append(0 if i % 2 else L - 1)
        for q in sites:
            s[q] = b"ACGT"[(b"ACGT".index(s[q]) + int(rng.integers(1, 4))) % 4]
        for q in range(L):
            if rng.random() < n_rate:
                s[q] = ord("N")
        if i % 3 == 0:
            s = bytearray(bytes(s).translate(_RC)[::-1])
        out.append(bytes(s))
    return out


def _run(seqs, table, k, canonical, min_count=2, rounds=None, base_valid=None, bv_width=None,
         n_words=None):
    """(port, JAX) outputs of correct_reads (rounds given) or
    correct_reads_once; n_words keeps only the first words."""
    w, lens, bv = _batch(seqs)
    w = w[:, :n_words]
    if bv_width is not None:
        bv = bv[:, :bv_width]
    use_bv = base_valid or bv_width is not None
    tj = tuple(jnp.asarray(x) for x in table)
    tt = (words_from_u32_np(table[0]), words_from_u32_np(table[1]), torch.from_numpy(table[2]))
    kw_j = dict(min_count=min_count, canonical=canonical,
                base_valid=jnp.asarray(bv) if use_bv else None)
    mc_t = torch.as_tensor(min_count) if isinstance(min_count, np.ndarray) else min_count
    kw_t = dict(min_count=mc_t, canonical=canonical,
                base_valid=torch.from_numpy(bv) if use_bv else None)
    if rounds is None:
        want = jcorrect.correct_reads_once(jnp.asarray(w), jnp.asarray(lens), k, *tj, **kw_j)
        got = correct.correct_reads_once(words_from_u32_np(w), torch.from_numpy(lens), k, *tt,
                                         **kw_t)
        assert got[1].dtype == torch.bool
    else:
        want = jcorrect.correct_reads(jnp.asarray(w), jnp.asarray(lens), k, *tj,
                                      rounds=rounds, **kw_j)
        got = correct.correct_reads(words_from_u32_np(w), torch.from_numpy(lens), k, *tt,
                                    rounds=rounds, **kw_t)
        assert got[1].dtype == torch.int32
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(words_to_u32_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got


@pytest.mark.parametrize("k", [5, 11, 21, 31])
@pytest.mark.parametrize("canonical", [False, True])
def test_correct_reads_once_matches_jax(k, canonical):
    rng = np.random.default_rng(k + 100 * canonical)
    genome = random_seq(rng, 400).upper()
    clean = _reads_with_errors(rng, genome, 200, 50, (0, 1))
    table = _table(clean, k, canonical)
    seqs = _reads_with_errors(rng, genome, 40, 50, (0, 3), edges=k == 11)
    _, applied = _run(seqs, table, k, canonical)
    assert applied.any()


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("canonical", [False, True])
def test_correct_reads_rounds_match_jax(rounds, canonical):
    rng = np.random.default_rng(rounds + 10 * canonical)
    genome = random_seq(rng, 600).upper()
    table = _table(_reads_with_errors(rng, genome, 120, 60, (0, 1)), 13, canonical)
    seqs = _reads_with_errors(rng, genome, 50, 60, (1, 4))
    _, n = _run(seqs, table, 13, canonical, rounds=rounds)
    assert n.max() <= rounds and n.any()


def test_correct_reads_stops_early_when_nothing_changes():
    rng = np.random.default_rng(3)
    genome = random_seq(rng, 300).upper()
    seqs = _reads_with_errors(rng, genome, 30, 40, (0, 1))
    table = _table(seqs, 9, False)
    _, n = _run(seqs, table, 9, False, min_count=1, rounds=4)
    assert not n.any()
    with pytest.raises(ValueError, match="rounds"):
        correct.correct_reads(torch.zeros((1, 2), dtype=torch.int32),
                              torch.tensor([20], dtype=torch.int32), 9, *(
                                  torch.zeros(1, dtype=torch.int32),) * 3, rounds=0)


@pytest.mark.parametrize("bv_width", [None, 45])
def test_correct_reads_with_n_sites_match_jax(bv_width):
    rng = np.random.default_rng(5 + (bv_width or 0))
    genome = random_seq(rng, 500).upper()
    table = _table(_reads_with_errors(rng, genome, 100, 50, (0, 1)), 11, True)
    seqs = _reads_with_errors(rng, genome, 40, 50, (0, 3), n_rate=0.02, edges=True)
    _run(seqs, table, 11, True, base_valid=True, bv_width=bv_width, rounds=3)


def test_correct_k_past_read_length_moves_nothing():
    """One word a read (L = 16 bases) and k = 21: no window fits."""
    rng = np.random.default_rng(6)
    genome = random_seq(rng, 300).upper()
    seqs = [genome[:10], genome[5:21], b"", genome[40:42]]
    table = _table([genome], 21, False)
    for rounds in (None, 2):
        _, applied = _run(seqs, table, 21, False, rounds=rounds, n_words=1)
        assert not applied.any()


def test_correct_ties_between_variants_and_tensor_min_count():
    """The read's base at site 7 is absent from the table and the three
    other bases are solid with the same count: the first variant,
    orig + 1, wins. A read of a base the table lacks everywhere stays."""
    k = 7
    variants = []
    for j in range(4):
        s = bytearray(b"ACGTTGCTAGGCTAC")
        s[7] = b"ACGT"[j]
        variants.append(bytes(s))
    table = _table(variants[1:] * 3, k, False)
    seqs = [variants[0], variants[2], b"TTTTTTTTTTTTTTT"]
    for mc in (2, np.int32(3)):
        got, applied = _run(seqs, table, k, False, min_count=mc)
        assert applied.tolist() == [True, False, False]
        assert words_to_u32_np(got)[0, 0] >> 14 & 3 == 1  # C, orig (A) + 1
        _run(seqs, table, k, False, min_count=mc, rounds=2)
    ct = table[2].copy()
    ct[::5] = 1  # some weak rows among them
    _run(seqs, (table[0], table[1], ct), k, False, min_count=2, rounds=3)


@pytest.mark.parametrize("seed", range(6))
def test_correct_fuzz_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    k = int(rng.choice([3, 8, 15, 16, 17, 32]))
    genome = random_seq(rng, 300).upper()
    table = _table(_reads_with_errors(rng, genome, 80, 40, (0, 2)), k, bool(seed % 2))
    L = int(rng.integers(2, 60))
    seqs = _reads_with_errors(rng, genome, 25, L, (0, 4), n_rate=0.01 * (seed % 3))
    _run(seqs, table, k, bool(seed % 2), min_count=int(rng.integers(1, 4)),
         base_valid=seed % 3 == 1, rounds=int(rng.integers(1, 5)))
