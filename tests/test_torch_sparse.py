"""bitnuc_tpu_torch's sort-based k-mer counting against bitnuc_tpu.ops.kmer
on the same packed batches: count_kmers_sorted, count_kmers_runs,
raw_window_keys, merge_sorted_runs, pack_runs_front and compact_runs at
k = 13..32, plain and canonical, with N-skip and all-T reads (whose key is
the all-ones sentinel at k = 32). Raw arrays match bit for bit through
uint32 views."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import codec as jcodec, kmer as jkmer
from bitnuc_tpu_torch.ops import kmer
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)

KS = [13, 15, 16, 17, 21, 31, 32]


def _batch(seed, variant, B=6, L=70):
    """(uint32 words, lengths, base_valid or None) made with numpy and
    packed by the JAX encoder; rows 1 and 2 hold all-T stretches."""
    rng = np.random.default_rng(seed)
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    a[1] = ord("T")
    a[2, :40] = ord("T")
    if variant == "all_t":
        a[:] = ord("T")
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[1:3] = L
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    valid = None
    if variant != "plain":
        valid = rng.random((B, L)) >= 0.05
    return np.asarray(w), lens, valid


def _u32(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.reshape(-1).view(np.uint32) if a.dtype.itemsize == 4 else a.reshape(-1)


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_u32(g), _u32(w), err_msg=f"output {i}")


def _both(w, lens, valid):
    jargs = (jnp.asarray(w), jnp.asarray(lens))
    targs = (words_from_u32_np(w), torch.from_numpy(lens))
    tvalid = None if valid is None else torch.from_numpy(valid)
    return jargs, targs, valid, tvalid


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("variant", ["plain", "canonical_nskip", "all_t"])
def test_sort_engines_match_jax(k, variant):
    w, lens, valid = _batch(k, variant)
    canonical = variant == "canonical_nskip"
    jargs, targs, jv, tv = _both(w, lens, valid)
    for jfn, tfn in (
        (jkmer.count_kmers_sorted, kmer.count_kmers_sorted),
        (jkmer.count_kmers_runs, kmer.count_kmers_runs),
        (jkmer.raw_window_keys, kmer.raw_window_keys),
    ):
        want = jfn(*jargs, k, canonical, jv)
        got = tfn(*targs, k, canonical, tv)
        _assert_same(got, want)
    # the dispatcher: 'auto' is the runs engine above k = 12
    _assert_same(
        kmer.count_kmers_reads(*targs, k, canonical=canonical, base_valid=tv),
        jkmer.count_kmers_runs(*jargs, k, canonical, jv),
    )
    assert kmer.count_kmers_sorted(*targs, k, canonical, tv)[2].dtype == torch.int32


@pytest.mark.parametrize("k", KS)
def test_merge_pack_compact_runs_match_jax(k):
    """Two batches' run lists, concatenated, merged, pushed to the front
    and compacted, by both packages from the same arrays."""
    parts = []
    for seed, variant in ((1, "canonical_nskip"), (2, "all_t")):
        w, lens, valid = _batch(seed + k, variant)
        parts.append(jkmer.count_kmers_runs(jnp.asarray(w), jnp.asarray(lens), k, True, valid))
    cat = [np.concatenate([np.asarray(p[i]) for p in parts]) for i in range(3)]
    tcat = [torch.from_numpy(c.view(np.int32).copy()) for c in cat]
    want = jkmer.merge_sorted_runs(*(jnp.asarray(c) for c in cat))
    got = kmer.merge_sorted_runs(*tcat)
    _assert_same(got, want)
    front_w = jkmer.pack_runs_front(*want[:3])
    front_g = kmer.pack_runs_front(*got[:3])
    _assert_same(front_g, front_w)
    _assert_same(kmer.compact_runs(*got[:3]), jkmer.compact_runs(*want[:3]))
    lo, hi, ct = kmer.compact_runs(*front_g)
    assert lo.dtype == np.uint32 and hi.dtype == np.uint32
    assert ct.size == int(got[3]) and (ct > 0).all()


def test_sentinel_key_at_k32_keeps_its_count():
    """At k = 32 the all-T key equals the sentinel of invalid windows: its
    count is the valid all-T windows only."""
    a = np.full((3, 40), ord("T"), np.uint8)
    lens = np.array([40, 35, 3], np.int32)  # 9 + 4 + 0 windows
    valid = np.ones((3, 40), bool)
    valid[0, 5] = False  # drops windows 0..5 of read 0: 3 valid remain
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    targs = (words_from_u32_np(np.asarray(w)), torch.from_numpy(lens))
    for fn in (kmer.count_kmers_sorted, kmer.count_kmers_runs):
        lo, hi, ct, n = fn(*targs, 32, False, torch.from_numpy(valid))
        glo, ghi, gct = kmer.compact_runs(lo, hi, ct)
        assert int(n) == 1 and list(gct) == [7]
        assert int(glo[0]) == int(ghi[0]) == 0xFFFFFFFF
