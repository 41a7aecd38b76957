"""bitnuc_tpu_torch.ops.lookup against bitnuc_tpu.ops.lookup on the same
numpy-seeded tables and queries, every output exactly: duplicate and dead
table rows, an empty table, keys with bit 31 set in lo and in hi, all-
invalid queries, k = 1, 12, 21 and 32 through kmer_hits_reads,
screen_reads and solid_prefix_len, and the host adapters."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import codec as jcodec, lookup as jlookup
from bitnuc_tpu_torch.ops import lookup
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np, words_to_u32_np
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _split(keys):
    keys = np.asarray(keys, np.uint64)
    return (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), (keys >> np.uint64(32)).astype(
        np.uint32)


def _both(q_lo, q_hi, q_valid, t_lo, t_hi, t_ct):
    """(port, JAX) answers of lookup_counts on host uint32 keys."""
    want = np.asarray(jlookup.lookup_counts(jnp.asarray(q_lo), jnp.asarray(q_hi),
                                            jnp.asarray(q_valid), jnp.asarray(t_lo),
                                            jnp.asarray(t_hi), jnp.asarray(t_ct)))
    got = lookup.lookup_counts(words_from_u32_np(q_lo), words_from_u32_np(q_hi),
                               torch.from_numpy(q_valid), words_from_u32_np(t_lo),
                               words_from_u32_np(t_hi), torch.from_numpy(t_ct))
    assert got.dtype == torch.int32
    return got.numpy(), want


def _table(rng, n, key_bits=64, dups=0.2, dead=0.2):
    """n counted-list rows over random keys of key_bits bits, a share of
    them repeated and a share with counts <= 0."""
    keys = rng.integers(0, 2**min(key_bits, 63), n, dtype=np.uint64)
    if key_bits == 64:
        keys |= rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63)
    rep = rng.random(n) < dups
    keys[rep] = keys[rng.integers(0, n, int(rep.sum()))]
    ct = rng.integers(1, 50, n).astype(np.int32)
    ct[rng.random(n) < dead] = rng.integers(-3, 1, 1)[0]
    return keys, ct


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_table", [0, 1, 7, 300])
def test_lookup_counts_matches_jax(seed, n_table):
    rng = np.random.default_rng(seed)
    keys, ct = _table(rng, n_table)
    present = keys[rng.integers(0, max(n_table, 1), 60)] if n_table else np.zeros(0, np.uint64)
    absent = rng.integers(0, 2**63, 60, dtype=np.uint64) | np.uint64(1 << 63)
    q = np.concatenate([present, absent, np.array([2**64 - 1, 0, 2**31, 2**63 + 2**31],
                                                  np.uint64)])
    rng.shuffle(q)
    q_valid = rng.random(q.size) < 0.8
    got, want = _both(*_split(q), q_valid, *_split(keys), ct)
    np.testing.assert_array_equal(got, want)


def test_lookup_sums_duplicate_rows_and_ignores_dead_ones():
    keys = np.array([5, 5, 9, 9, 2**63 + 7, 2**64 - 1, 2**64 - 1], np.uint64)
    ct = np.array([3, 4, 0, -2, 8, 1, 0], np.int32)
    q = np.array([5, 9, 2**63 + 7, 2**64 - 1, 6, 5], np.uint64)
    got, want = _both(*_split(q), np.ones(q.size, bool), *_split(keys), ct)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [7, 0, 8, 1, 0, 7])


def test_lookup_all_invalid_queries_and_empty_inputs():
    keys, ct = _table(np.random.default_rng(3), 50)
    q = keys[:20]
    got, want = _both(*_split(q), np.zeros(20, bool), *_split(keys), ct)
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    got, want = _both(*_split(np.zeros(0, np.uint64)), np.zeros(0, bool), *_split(keys), ct)
    assert got.shape == want.shape == (0,)


def _reads(rng, n, lo=0, hi=90, n_rate=0.05):
    seqs = []
    for _ in range(n):
        s = bytearray(random_seq(rng, int(rng.integers(lo, hi))))
        for i in range(len(s)):
            if rng.random() < n_rate:
                s[i] = ord("N")
        seqs.append(bytes(s))
    return seqs


def _batch(seqs):
    """Host uint32 words, lengths and base validity, packed by the JAX
    package's codec (N sites as code 0)."""
    L = max(max(len(s) for s in seqs), 1)
    a = np.zeros((len(seqs), L), np.uint8)
    for i, s in enumerate(seqs):
        a[i, : len(s)] = np.frombuffer(s, np.uint8)
    lens = np.array([len(s) for s in seqs], np.int32)
    w, _ = jcodec.encode_reads(jnp.asarray(a), jnp.asarray(lens))
    bv = np.array(jcodec.validity_mask(jnp.asarray(a), jnp.asarray(lens)))
    return np.asarray(w), lens, bv


def _read_table(rng, seqs, k, n_noise=40):
    """A table of some of the reads' own k-mers (with duplicates and dead
    rows) plus random keys of k bases."""
    from bitnuc_tpu import oracle

    keys = []
    for s in seqs[::2]:
        keys += list(oracle.count_kmers(s.upper().replace(b"N", b"A"), k))
    keys = np.array(keys + rng.integers(0, 4**k if k < 32 else 2**63, n_noise,
                                         dtype=np.uint64).tolist(), np.uint64)
    ct = rng.integers(-1, 6, keys.size).astype(np.int32)
    return keys, ct


@pytest.mark.parametrize("k", [1, 12, 21, 32])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("with_bv", [False, True])
def test_kmer_hits_screen_and_solid_prefix_match_jax(k, canonical, with_bv):
    rng = np.random.default_rng(k * 4 + 2 * canonical + with_bv)
    seqs = _reads(rng, 23, 0, 80)
    w, lens, bv = _batch(seqs)
    keys, ct = _read_table(rng, seqs, k)
    t_lo, t_hi = _split(keys)
    bvj = jnp.asarray(bv) if with_bv else None
    bvt = torch.from_numpy(bv) if with_bv else None
    tj = (jnp.asarray(t_lo), jnp.asarray(t_hi), jnp.asarray(ct))
    tt = (words_from_u32_np(t_lo), words_from_u32_np(t_hi), torch.from_numpy(ct))
    wt, lt = words_from_u32_np(w), torch.from_numpy(lens)
    wj, lj = jnp.asarray(w), jnp.asarray(lens)

    cj, vj = jlookup.kmer_hits_reads(wj, lj, k, *tj, canonical=canonical, base_valid=bvj)
    ct_, vt = lookup.kmer_hits_reads(wt, lt, k, *tt, canonical=canonical, base_valid=bvt)
    np.testing.assert_array_equal(ct_.numpy(), np.asarray(cj))
    assert (ct_.numpy() > 0).any()
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    for mc in (1, 2, 4):
        nj = jlookup.screen_reads(wj, lj, k, *tj, min_count=mc, canonical=canonical,
                                  base_valid=bvj)
        nt = lookup.screen_reads(wt, lt, k, *tt, min_count=mc, canonical=canonical,
                                 base_valid=bvt)
        for g, x in zip(nt, nj):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        sj = jlookup.solid_prefix_len(cj, vj, lj, k, min_count=mc)
        st = lookup.solid_prefix_len(ct_, vt, lt, k, min_count=mc)
        assert st.dtype == torch.int32
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_solid_prefix_cases_match_jax():
    """No valid window, first window weak, a later window weak, all solid."""
    L, k = 40, 5
    counts = np.full((5, L), 3, np.int32)
    valid = np.zeros((5, L), bool)
    lens = np.array([3, 40, 40, 40, 20], np.int32)
    for r in range(1, 5):
        valid[r, : lens[r] - k + 1] = True
    counts[1, 0] = 0
    counts[2, 17] = 1
    counts[4, 15] = 0
    for mc in (1, 2, 3, 4):
        want = jlookup.solid_prefix_len(jnp.asarray(counts), jnp.asarray(valid),
                                        jnp.asarray(lens), k, mc)
        got = lookup.solid_prefix_len(torch.from_numpy(counts), torch.from_numpy(valid),
                                      torch.from_numpy(lens), k, mc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_table_adapters_match_jax():
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 3, 4**6).astype(np.int64)
    hist[7] = 2**33  # clamped to int32's largest
    got, want = lookup.table_from_dense(hist, device=CPU), jlookup.table_from_dense(hist)
    np.testing.assert_array_equal(words_to_u32_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(words_to_u32_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    got = lookup.table_from_dense(torch.from_numpy(hist), device=CPU)
    assert torch.equal(got[2], lookup.table_from_dense(hist, device=CPU)[2])
    keys = rng.integers(0, 2**64 - 1, 200, dtype=np.uint64)
    d = dict(zip(keys.tolist(), rng.integers(1, 2**34, 200).tolist()))
    got = lookup.table_from_dict(d, device=CPU)
    want = jlookup.table_from_dict(d)
    np.testing.assert_array_equal(words_to_u32_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(words_to_u32_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32


def test_prepared_table_answers_as_lookup_counts():
    rng = np.random.default_rng(9)
    keys, ct = _table(rng, 500)
    q = np.concatenate([keys[:100], rng.integers(0, 2**63, 50, dtype=np.uint64)])
    lo, hi = _split(q)
    t = lookup._prepare(*(words_from_u32_np(x) for x in _split(keys)), torch.from_numpy(ct))
    valid = torch.ones(q.size, dtype=torch.bool)
    got = lookup._lookup_prepared(t, words_from_u32_np(lo), words_from_u32_np(hi), valid)
    want, _ = _both(lo, hi, valid.numpy(), *_split(keys), ct)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_adapters_need_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lookup.table_from_dict({1: 2})
