"""The plain version of K7 (bitnuc_tpu_torch.ops.merge.merge_sorted on CPU
tensors) against bitnuc_tpu's bitonic merge_sorted in interpret mode, on
the cases of tests/test_merge_engine.py.

The port's merge is the STABLE sort of concat(a, b), so it is also held
row for row against numpy's stable lexsort. The JAX merge equals it up to
the order of rows whose full keys tie, and may place its padding among
real all-ones keys; those are compared as row multisets, the way
test_merge_engine.py's _check does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops.pallas.merge import merge_sorted as jmerge_sorted
from bitnuc_tpu_torch.ops import merge

torch.set_num_threads(1)

SENT = np.uint32(0xFFFFFFFF)


def _sorted_list(rng, n, n_keys, hi=1 << 32, payloads=1):
    ks = [rng.integers(0, hi, size=n).astype(np.uint32) for _ in range(n_keys)]
    order = np.lexsort(tuple(reversed(ks)))
    out = [k[order] for k in ks]
    for _ in range(payloads):
        out.append(rng.integers(-100, 100, size=n).astype(np.int32))
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


def _rows(arrs):
    return sorted(zip(*[a.tolist() for a in arrs]))


def _check(a, b, n_keys, pad_val=None):
    na, nb = len(a[0]), len(b[0])
    got = merge.merge_sorted([_t(x) for x in a], [_t(y) for y in b], n_keys, pad_val)
    got = [g.numpy().view(np.uint32) if i < n_keys else g.numpy()
           for i, g in enumerate(got)]
    n = merge.next_pow2(max(na + nb, 1))
    assert all(g.shape == (n,) for g in got)

    # exact: the stable sort of the concatenation, then the padding
    cat = [np.concatenate([x, y]) for x, y in zip(a, b)]
    order = np.lexsort(tuple(reversed(cat[:n_keys])), axis=0)
    for i, (g, c) in enumerate(zip(got, cat)):
        np.testing.assert_array_equal(g[: na + nb], c[order], err_msg=f"column {i}")
        fill = SENT if i < n_keys else (-1 if pad_val is None else pad_val[i - n_keys])
        assert np.all(g[na + nb :] == fill)

    # against the JAX engine, as test_merge_engine.py compares it with lax.sort
    want = jmerge_sorted(tuple(jnp.asarray(x) for x in a),
                         tuple(jnp.asarray(y) for y in b), n_keys,
                         pad_val=pad_val, interpret=True)
    want = [np.asarray(w) for w in want]
    real_sent = np.all([c == SENT for c in cat[:n_keys]], axis=0)
    if not real_sent.any():
        for g, w in zip(got[:n_keys], want[:n_keys]):
            np.testing.assert_array_equal(g, w)
        assert _rows(got) == _rows(want)
    else:
        keep_g = ~np.all([g == SENT for g in got[:n_keys]], axis=0)
        keep_w = ~np.all([w == SENT for w in want[:n_keys]], axis=0)
        assert _rows([g[keep_g] for g in got]) == _rows([w[keep_w] for w in want])


@pytest.mark.parametrize("na,nb", [(5, 3), (100, 28), (700, 300)])
def test_merge_small(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    _check(_sorted_list(rng, na, 1), _sorted_list(rng, nb, 1), 1)


@pytest.mark.parametrize("na,nb", [(600, 424), (1024, 1024), (5000, 3000), (40000, 30000)])
def test_merge_single_key(na, nb):
    rng = np.random.default_rng(na + nb)
    _check(_sorted_list(rng, na, 1), _sorted_list(rng, nb, 1), 1)


def test_merge_beyond_one_block():
    rng = np.random.default_rng(7)
    _check(_sorted_list(rng, 70000, 1), _sorted_list(rng, 70000, 1), 1)


def test_merge_two_key_words():
    rng = np.random.default_rng(11)
    _check(_sorted_list(rng, 3000, 2, hi=4), _sorted_list(rng, 2000, 2, hi=4), 2)


def test_merge_three_key_words():
    rng = np.random.default_rng(13)
    _check(
        _sorted_list(rng, 1500, 3, hi=3, payloads=2),
        _sorted_list(rng, 1700, 3, hi=3, payloads=2),
        3,
    )


def test_merge_heavy_duplicates():
    rng = np.random.default_rng(17)
    _check(_sorted_list(rng, 4000, 1, hi=50), _sorted_list(rng, 4000, 1, hi=50), 1)


def test_merge_with_real_sentinels():
    rng = np.random.default_rng(19)
    a = _sorted_list(rng, 2000, 1, hi=1 << 20)
    b = _sorted_list(rng, 1000, 1, hi=1 << 20)
    a[0][-50:] = SENT
    b[0][-30:] = SENT
    _check(a, b, 1)


def test_merge_empty_and_lopsided():
    rng = np.random.default_rng(23)
    _check(_sorted_list(rng, 0, 1), _sorted_list(rng, 3000, 1), 1)
    _check(_sorted_list(rng, 3000, 1), _sorted_list(rng, 1, 1), 1)
    _check(_sorted_list(rng, 0, 2, payloads=0), _sorted_list(rng, 0, 2, payloads=0), 2)


def test_merge_pad_values():
    rng = np.random.default_rng(29)
    _check(_sorted_list(rng, 1000, 1), _sorted_list(rng, 500, 1), 1, pad_val=(1234,))


def test_merge_rejects_bad_columns():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        merge.merge_sorted([x], [x, x], 1)
    with pytest.raises(ValueError):
        merge.merge_sorted([x, x, x, x], [x, x, x, x], 4)
    with pytest.raises(TypeError):
        merge.merge_sorted([x.long()], [x.long()], 1)


_POOL = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
@pytest.mark.parametrize("kind", ["all_equal", "few_valued"])
def test_merge_plain_keeps_stable_tie_order(kind, n_keys):
    """merge_sorted_torch (the kernel's yardstick on the card) is the stable
    sort of concat(a, b): with payload = row index in the concatenation,
    the payload column comes out as numpy's stable lexsort order."""
    rng = np.random.default_rng(31 + n_keys)
    na, nb = 1500, 1001

    def side(start, n):
        if kind == "all_equal":
            ks = [np.full(n, 0x80000000, np.uint32) for _ in range(n_keys)]
        else:
            ks = [rng.choice(_POOL, n) for _ in range(n_keys)]
        order = np.lexsort(tuple(reversed(ks)))
        return [k[order] for k in ks] + [np.arange(start, start + n, dtype=np.int32)]

    a, b = side(0, na), side(na, nb)
    got = merge.merge_sorted_torch([_t(x) for x in a], [_t(y) for y in b], n_keys, (-7,))
    cat = [np.concatenate([x, y]) for x, y in zip(a, b)]
    order = np.lexsort(tuple(reversed(cat[:n_keys])))
    np.testing.assert_array_equal(got[n_keys][: na + nb].numpy(), order)
    for i in range(n_keys):
        np.testing.assert_array_equal(got[i][: na + nb].numpy().view(np.uint32), cat[i][order])
        assert np.all(got[i][na + nb :].numpy().view(np.uint32) == SENT)
    assert np.all(got[n_keys][na + nb :].numpy() == -7)
