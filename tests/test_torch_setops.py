"""bitnuc_tpu_torch.ops.setops against bitnuc_tpu.ops.setops: combine_counts
in its four modes, compacted and not, raw arrays bit for bit against the
JAX function under both of its backends ("xla", a full sort; "pallas", the
bitonic merge in interpret mode), on a sorted-layout A and a run-start B
with interior dead rows; the k = 32 all-T key that equals the sentinel;
validate=True; chains of combinations; combine_dicts."""

import numpy as np
import pytest
import torch

from bitnuc_tpu import config as jconfig
from bitnuc_tpu.ops import kmer as jkmer, setops as jsetops
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch.ops import kmer, setops

torch.set_num_threads(1)


def _seqs(seed, n, length, shared=()):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    return list(shared) + [bytes(rng.choice(alphabet, length)) for _ in range(n)]


def _jax_lists(seqs, k, engine):
    r = JPackedReads.from_ascii(seqs)
    lo, hi, ct, _ = engine(r.words, r.lengths, k)
    return lo, hi, ct


def _t(x):
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


def _u32(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.reshape(-1).view(np.uint32)


def _assert_same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_u32(g), _u32(w), err_msg=f"output {i}")


def _as_dict(lo, hi, ct):
    lo, hi, ct = kmer.compact_runs(*(x if isinstance(x, torch.Tensor) else _t(x)
                                     for x in (lo, hi, ct)))
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return dict(zip(keys.tolist(), ct.tolist()))


def _jax_combine(a, b, mode, compact, backend):
    with jconfig.backend(backend):
        jsetops.combine_counts.clear_cache()
        try:
            return jsetops.combine_counts(*a, *b, mode=mode, compact=compact)
        finally:
            jsetops.combine_counts.clear_cache()


def _pair(k=21):
    shared = _seqs(1, 3, 80)
    a = _jax_lists(_seqs(2, 4, 60, shared), k, jkmer.count_kmers_sorted)
    b = _jax_lists(_seqs(3, 4, 70, shared[:2]), k, jkmer.count_kmers_runs)
    return a, b


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("mode", setops.MODES)
def test_combine_counts_matches_jax(mode, compact):
    a, b = _pair()
    got = setops.combine_counts(*map(_t, a), *map(_t, b), mode=mode, compact=compact)
    assert got[2].dtype == torch.int32 and got[3].ndim == 0
    for backend in ("xla", "pallas"):
        _assert_same(got, _jax_combine(a, b, mode, compact, backend))
    want = jsetops.combine_dicts(_as_dict(*a), _as_dict(*b), mode)
    assert _as_dict(*got[:3]) == want
    assert int(got[3]) == len(want)


@pytest.mark.parametrize("mode", setops.MODES)
def test_combine_k32_all_t_sentinel(mode):
    """The all-T 32-mer packs to the dead-row sentinel; it must survive
    pairing and compaction in every mode."""
    a = _jax_lists([b"T" * 40, b"ACGT" * 10], 32, jkmer.count_kmers_sorted)
    b = _jax_lists([b"T" * 36, b"A" * 40], 32, jkmer.count_kmers_runs)
    for compact in (True, False):
        got = setops.combine_counts(*map(_t, a), *map(_t, b), mode=mode, compact=compact)
        _assert_same(got, _jax_combine(a, b, mode, compact, "xla"))
    want = jsetops.combine_dicts(_as_dict(*a), _as_dict(*b), mode)
    assert _as_dict(*got[:3]) == want
    assert (1 << 64) - 1 in want  # the edge is exercised (9 - 5 > 0 for subtract)


def test_combine_chain_and_empty():
    """An uncompacted result feeds another combination; subtracting a
    list from itself leaves nothing."""
    a, b = _pair(17)
    ta, tb = list(map(_t, a)), list(map(_t, b))
    mid = setops.combine_counts(*ta, *tb, mode="union_sum", compact=False)
    got = setops.combine_counts(*mid[:3], *ta, mode="union_max")
    jmid = jsetops.combine_counts(*a, *b, mode="union_sum", compact=False)
    _assert_same(got, jsetops.combine_counts(*jmid[:3], *a, mode="union_max"))
    empty = setops.combine_counts(*ta, *ta, mode="subtract")
    assert int(empty[3]) == 0 and (empty[2] == 0).all()
    assert (empty[0] == -1).all() and (empty[1] == -1).all()


def test_validate_rejects_unsorted():
    a, b = _pair()
    ta, tb = list(map(_t, a)), list(map(_t, b))
    setops.combine_counts(*ta, *tb, validate=True)  # sorted: accepted
    live = torch.nonzero(ta[2] > 0).flatten()
    i, j = int(live[0]), int(live[-1])
    bad = [x.clone() for x in ta]
    for x in bad:
        x[i], x[j] = x[j].clone(), x[i].clone()
    with pytest.raises(ValueError, match="not sorted"):
        setops.combine_counts(*bad, *tb, validate=True)
    with pytest.raises(ValueError, match="not sorted"):
        setops.combine_counts(*tb, *bad, validate=True)
    with pytest.raises(ValueError):
        setops.combine_counts(*ta, *tb, mode="xor")


def test_combine_dicts_matches_jax():
    rng = np.random.default_rng(5)
    a = {int(k): int(v) for k, v in zip(rng.integers(0, 50, 30), rng.integers(1, 9, 30))}
    b = {int(k): int(v) for k, v in zip(rng.integers(0, 50, 30), rng.integers(1, 9, 30))}
    for mode in setops.MODES:
        assert setops.combine_dicts(a, b, mode) == jsetops.combine_dicts(a, b, mode)
    with pytest.raises(ValueError):
        setops.combine_dicts(a, b, "xor")
