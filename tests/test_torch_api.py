"""bitnuc_tpu_torch.api and bitnuc_tpu_torch.oracle against the JAX
package's api (its native library where built; loaded where the two forms
differ) and oracle, on the same
numpy-seeded sequences: every function at lengths 0, 1, 31, 32, 33, 64 and
200 with lower case, the four error types, count_kmers at k = 1, 2, 15, 31
and 32, and the oracle's alignment functions."""

import numpy as np
import pytest

from bitnuc_tpu import api as japi, oracle as joracle
from bitnuc_tpu_torch import api, errors, native as tnative, oracle
from test_torch_native import jax_native, port_native

LENGTHS = [0, 1, 31, 32, 33, 64, 200]
ACGT_MIXED = np.frombuffer(b"ACGTacgt", np.uint8)


def _seq(n, seed):
    return np.random.default_rng(seed).choice(ACGT_MIXED, n).tobytes()


def _outcome(fn, *args):
    """What a call gives: its value (arrays as (dtype, list)) or the
    name and fields of the error it raised."""
    try:
        r = fn(*args)
    except Exception as e:  # compared by name: the two packages' classes differ
        ours = any(c.__name__ == "NucleotideError" for c in type(e).__mro__)
        return ("raised", type(e).__name__, str(e) if ours else "")
    if isinstance(r, tuple):
        return tuple(_outcome(lambda x=x: x) for x in r)
    if isinstance(r, np.ndarray):
        return (r.dtype.str, r.tolist())
    return r


def _same(name, *args, want_oracle=True):
    got = _outcome(getattr(api, name), *args)
    assert got == _outcome(getattr(japi, name), *args), (name, args)
    if want_oracle and hasattr(joracle, name):  # the oracle has no *_alloc aliases
        assert got == _outcome(getattr(joracle, name), *args), (name, args)
        assert _outcome(getattr(oracle, name), *args) == got, (name, args)
    return got


@pytest.mark.parametrize("n", LENGTHS)
def test_codec_matches_jax(n):
    s = _seq(n, n)
    words = _same("encode", s)
    _same("encode_alloc", s)
    _same("encode", s.decode())
    _same("encode", np.frombuffer(s, np.uint8))
    e = api.encode(s)
    assert _same("decode", e, n) == s.upper()
    _same("decode", e, n + 1)
    _same("as_2bit", s)
    if n:
        _same("from_2bit", int(e[0]), min(n, 32))
        _same("from_2bit_alloc", int(e[-1]), n % 32 or 32)
    assert words[0] == "<u8"


@pytest.mark.parametrize("n", LENGTHS)
def test_hdist_matches_jax(n):
    a, b = api.encode(_seq(n, 1)), api.encode(_seq(n, 2))
    for nb in sorted({0, n // 2, n, max(n - 1, 0)}):
        _same("hdist", a, b, nb)
    _same("hdist", a, a, n)
    _same("hdist", a, b, n + 32)  # past the words: InvalidLength
    if n:
        for length in (0, 1, min(n, 32)):
            _same("hdist_scalar", int(a[0]), int(b[0]), length)


@pytest.mark.parametrize("n", LENGTHS)
def test_split_packed_matches_jax(n):
    e = api.encode(_seq(n, 3))
    for idx in sorted({0, 1, n // 2, 31, 32, 33, n - 1, n}):
        if 0 <= idx <= n:
            left, right = _same("split_packed", e, n, idx)
            assert api.decode(api.split_packed(e, n, idx)[1], n - idx) == _seq(n, 3).upper()[idx:]
    _same("split_packed", e, n, n + 1)  # IndexOutOfBounds


@pytest.mark.parametrize("k", [1, 2, 15, 31, 32])
@pytest.mark.parametrize("n", LENGTHS)
def test_count_kmers_matches_jax(n, k):
    _same("count_kmers", _seq(n, 10 + n), k)


def test_count_kmers_repeats_and_edges():
    for s, k in [(b"AAAA", 2), (b"ACGT" * 50, 4), (b"acgtACGT" * 9, 32), (b"A", 1)]:
        assert _same("count_kmers", s, k) == joracle.count_kmers(s, k)
    for k in (0, 33):  # api checks k; the oracle does not
        _same("count_kmers", b"ACGT", k, want_oracle=False)


def _pinned_routes(monkeypatch):
    """The JAX package with its native library loaded; yields once with the
    port's host library and once with its numpy forms."""
    jax_native()
    port_native()
    yield "library"
    with monkeypatch.context() as m:
        m.setattr(tnative, "available", lambda: False)
        yield "numpy"


def test_count_kmers_short_invalid_follows_native(monkeypatch):
    """A sequence shorter than k with an invalid byte: JAX's native library
    (k <= 12) raises InvalidBase, its oracle and k > 12 return {}; the port
    follows bitnuc_tpu.api with its library, on both of its routes."""
    for _ in _pinned_routes(monkeypatch):
        for k in (3, 12, 13):
            _same("count_kmers", b"AN", k, want_oracle=False)
        assert api.count_kmers(b"AN", 13) == joracle.count_kmers(b"AN", 13) == {}


@pytest.mark.parametrize("case", [
    ("as_2bit", (b"A" * 33,), "SequenceTooLong"),
    ("as_2bit", (b"ACNT",), "InvalidBase"),
    ("encode", (b"ACGTx" * 10,), "InvalidBase"),
    ("from_2bit", (5, 33), "InvalidLength"),
    ("decode", (np.zeros(1, np.uint64), 33), "InvalidLength"),
    ("hdist", (np.zeros(1, np.uint64), np.zeros(2, np.uint64), 40), "InvalidLength"),
    ("hdist_scalar", (1, 2, 33), "InvalidLength"),
    ("split_packed", (np.zeros(1, np.uint64), 5, 6), "IndexOutOfBounds"),
    ("count_kmers", (b"ACGT", 33), "InvalidLength"),
])
def test_errors_match_jax(case):
    name, args, err = case
    got = _same(name, *args, want_oracle=name != "count_kmers")  # api checks k
    assert got[:2] == ("raised", err)
    with pytest.raises(getattr(errors, err)):
        getattr(api, name)(*args)


def test_invalid_range_and_error_fields():
    with pytest.raises(errors.InvalidRange) as e:
        oracle.slice_(api.encode(b"ACGT"), 4, 3, 2)
    assert (e.value.start, e.value.end, e.value.length) == (3, 2, 4)
    with pytest.raises(errors.InvalidBase) as e:
        api.encode(b"ACGTACGTAN")
    assert e.value.base == ord("N") and isinstance(e.value, errors.NucleotideError)


def test_negative_lengths_follow_native(monkeypatch):
    """Where the JAX package's native library and its oracle differ on a
    negative length or index, the port follows bitnuc_tpu.api with its
    library, on both of its routes."""
    for _ in _pinned_routes(monkeypatch):
        e = api.encode(b"ACGT" * 20)
        for name, args in [("decode", (e, -1)), ("from_2bit", (5, -1)), ("hdist", (e, e, -5)),
                           ("hdist_scalar", (1, 2, -1)), ("split_packed", (e, 80, -1))]:
            _same(name, *args, want_oracle=False)


def test_goldens():
    assert api.as_2bit(b"ACGT") == 0b11100100
    assert api.from_2bit(71620941647064936, 28) == b"AGGCTTGAGGCCCATTCTCTGATCGTTT"
    assert api.hdist(api.encode(b"ACTGACTG"), api.encode(b"TGCATGCA"), 8) == 8
    assert api.decode(api.encode(b"ACGT" * 250), 1000) == b"ACGT" * 250


@pytest.mark.parametrize("name", ["get", "slice_", "base_counts", "gc_content", "u64_to_u32",
                                  "u32_to_u64"])
def test_oracle_helpers_match_jax(name):
    for n in LENGTHS:
        s = _seq(n, 20 + n)
        e = joracle.encode(s)
        args = {
            "get": [(e, n, i) for i in (0, n // 2, n - 1, n)],
            "slice_": [(e, n, 0, n), (e, n, n // 3, n // 2), (e, n, 1, 0)],
            "base_counts": [(e, n)],
            "gc_content": [(e, n)],
            "u64_to_u32": [(e,)],
            "u32_to_u64": [(joracle.u64_to_u32(e),)],
        }[name]
        for a in args:
            assert _outcome(getattr(oracle, name), *a) == _outcome(getattr(joracle, name), *a)


@pytest.mark.parametrize("name,kw", [
    ("edit_distance", {}),
    ("global_distance", {"mismatch": 2, "gap": 3}),
    ("fit_distance", {"mismatch": 1, "gap": 2}),
    ("sw_score", {}),
    ("sw_score", {"match": 1, "mismatch": -1, "gap_open": -2, "gap_extend": -1}),
])
def test_oracle_alignment_matches_jax(name, kw):
    rng = np.random.default_rng(7)
    for _ in range(12):
        a = rng.choice(ACGT_MIXED[:4], int(rng.integers(0, 30))).tobytes()
        b = rng.choice(ACGT_MIXED[:4], int(rng.integers(0, 40))).tobytes()
        assert getattr(oracle, name)(a, b, **kw) == getattr(joracle, name)(a, b, **kw)


# JAX's exports that wait for their modules: none since the read-processing tier
NOT_YET = set()


def test_exports_follow_jax():
    """Every name of bitnuc_tpu.__all__ is exported by the port, under the
    same name, apart from the modules still to port."""
    import bitnuc_tpu
    import bitnuc_tpu_torch

    missing = [n for n in bitnuc_tpu.__all__
               if n not in NOT_YET and n not in bitnuc_tpu_torch.__all__]
    assert missing == []
    assert all(hasattr(bitnuc_tpu_torch, n) for n in bitnuc_tpu_torch.__all__)
    for name in ("MinimizerIndex", "map_reads", "hdist_one_to_many", "windowed_gc",
                 "map_pairs", "map_reads_long", "minimizer_sketch", "sketch_jaccard",
                 "minimizers64", "minimizer_sketch64", "sketch_jaccard64",
                 "sketch_containment64"):
        assert hasattr(bitnuc_tpu_torch, name) and hasattr(bitnuc_tpu, name)
    assert bitnuc_tpu_torch.hdist_search_batch.__name__ == "hdist_topk_batch"
    assert bitnuc_tpu_torch.assemble_reads is bitnuc_tpu_torch.assemble.assemble_reads
    assert hasattr(bitnuc_tpu, "assemble_reads")
    for name in ("filters", "qc", "assemble"):  # modules reachable as attributes, as in JAX
        assert getattr(bitnuc_tpu_torch, name).__name__ == f"bitnuc_tpu_torch.{name}"
        assert hasattr(bitnuc_tpu, name)
    assert bitnuc_tpu_torch.as_2bit(b"ACGT") == bitnuc_tpu.as_2bit(b"ACGT")
