"""bitnuc_tpu_torch.ops.pileup against bitnuc_tpu.ops.pileup: pileup_counts,
consensus_calls (with the two float32 boundary cases), pileup_counts_ops
and call_variants in both modes, on the same numpy-seeded inputs, every
output equal. The end-to-end cases follow tests/test_pileup.py: a planted
SNP, a cost filter, planted indels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnuc_tpu import mapper as jmapper
from bitnuc_tpu.ops import pileup as jpileup
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch import mapper
from bitnuc_tpu_torch.ops import pileup
from bitnuc_tpu_torch.parallel import mesh as pmesh
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def rc(s: bytes) -> bytes:
    return s[::-1].translate(_RC)


def _seq(rng, n: int) -> bytes:
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            if isinstance(want[key], list):
                assert got[key] == want[key], key
            else:
                g, w = _np(got[key]), _np(want[key])
                assert g.dtype == w.dtype, key
                np.testing.assert_array_equal(g, w, err_msg=key)
        return
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _batch(seed, ref_len, B=40):
    rng = np.random.default_rng(seed)
    reads = [_seq(rng, int(rng.integers(0, 80))) for _ in range(B)]
    starts = rng.integers(-30, ref_len + 10, B).astype(np.int32)  # some hang off
    flags = rng.random(B) < 0.4
    keep = rng.random(B) < 0.85
    return reads, starts, flags, keep


@pytest.mark.parametrize("n", [1, 3, 8])
def test_pileup_counts_sharded_matches_jax(n):
    """One psum of the int32 grid over n CPU shards against JAX's n-device
    mesh and the unsharded grid; the batch of 48 divides 1, 3 and 8."""
    import jax

    ref_len = 300
    reads, starts, flags, keep = _batch(9 + n, ref_len, B=48)
    jr = JPackedReads.from_ascii(reads)
    tr = PackedReads.from_ascii(reads, device=CPU)
    jmesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
    want = jpileup.pileup_counts_sharded(jr.words, jr.lengths, jnp.asarray(starts),
                                         jnp.asarray(flags), jnp.asarray(keep), ref_len, jmesh)
    mesh = pmesh.make_mesh((n,), ("data",), devices=[CPU] * n)
    args = (tr.words, tr.lengths, torch.from_numpy(starts), torch.from_numpy(flags),
            torch.from_numpy(keep))
    got = pileup.pileup_counts_sharded(*args, ref_len, mesh)
    _equal([got], [want])
    assert torch.equal(got, pileup.pileup_counts(*args, ref_len)) and int(got.sum()) > 0
    if n > 1:
        with pytest.raises(AssertionError, match="must divide"):
            pileup.pileup_counts_sharded(*(a[:-1] for a in args), ref_len, mesh)


@pytest.mark.parametrize("seed", range(3))
def test_pileup_counts_matches_jax(seed):
    ref_len = 300
    reads, starts, flags, keep = _batch(seed, ref_len)
    jr = JPackedReads.from_ascii(reads)
    tr = PackedReads.from_ascii(reads, device=CPU)
    want = jpileup.pileup_counts(jr.words, jr.lengths, jnp.asarray(starts), jnp.asarray(flags),
                                 jnp.asarray(keep), ref_len)
    got = pileup.pileup_counts(tr.words, tr.lengths, torch.from_numpy(starts),
                               torch.from_numpy(flags), torch.from_numpy(keep), ref_len)
    _equal([got], [want])
    assert int(got.sum()) > 0


def test_consensus_calls_matches_jax():
    rng = np.random.default_rng(3)
    ref = _seq(rng, 512)
    words = JPackedReads.from_ascii([ref]).words.reshape(-1)
    counts = rng.integers(0, 6, (500, 4)).astype(np.int32)
    counts[::7] = 0
    counts[1::9] = counts[1::9, :1]  # four-way ties
    for min_depth, min_frac in ((1, 0.5), (2, 0.5), (4, 0.8), (0, 0.0), (3, 0.26)):
        want = jpileup.consensus_calls(jnp.asarray(counts), words, min_depth, min_frac)
        got = pileup.consensus_calls(torch.from_numpy(counts), words_from_u32_np(np.asarray(words)),
                                     min_depth, min_frac)
        _equal(got, want)


@pytest.mark.parametrize("min_frac,depth,best,confident", [(0.6, 25, 15, False),
                                                           (0.55, 100, 55, True)])
def test_consensus_float32_boundary(min_frac, depth, best, confident):
    """float32(best) >= float32(min_frac) * float32(depth), as JAX decides;
    float64 decides these two the other way."""
    assert (best >= min_frac * depth) != confident
    counts = np.zeros((16, 4), np.int32)
    counts[:, 1] = best
    counts[:, 0] = depth - best
    words = JPackedReads.from_ascii([b"A" * 16]).words.reshape(-1)
    want = jpileup.consensus_calls(jnp.asarray(counts), words, 1, min_frac)
    got = pileup.consensus_calls(torch.from_numpy(counts), words_from_u32_np(np.asarray(words)),
                                 1, min_frac)
    _equal(got, want)
    assert bool(got[2].all()) == confident


def _planted(seed):
    """A 3-kbp reference; reads of 120 bp tiling it with a 3-bp deletion, a
    2-bp insertion and a SNP planted in the reads over them, both strands."""
    rng = np.random.default_rng(seed)
    ref = _seq(rng, 3000)
    DEL_AT, INS_AT, SNP_AT = 1003, 2001, 503
    free = set(b"ACGT") - set(ref[INS_AT - 1 : INS_AT + 2])
    ins_seq = bytes([sorted(free)[0]]) * 2
    alt = b"ACGT"[(b"ACGT".index(ref[SNP_AT : SNP_AT + 1]) + 1) % 4]
    reads = []
    for i in range(120):
        s = 23 * i + 10
        r = ref[s : s + 120]
        if s < DEL_AT - 10 and s + 120 > DEL_AT + 13:
            r = ref[s:DEL_AT] + ref[DEL_AT + 3 : s + 123]
        elif s < INS_AT - 10 and s + 120 > INS_AT + 10:
            r = ref[s:INS_AT] + ins_seq + ref[INS_AT : s + 118]
        elif s <= SNP_AT < s + 120:
            r = r[: SNP_AT - s] + bytes([alt]) + r[SNP_AT - s + 1 :]
        r = r[:120]
        reads.append(rc(r) if i % 3 == 1 else r)
    reads.append(_seq(rng, 120))  # unmapped
    return ref, reads


@pytest.fixture(scope="module")
def planted():
    ref, reads = _planted(17)
    ji = jmapper.MinimizerIndex.build(ref, k=13, w=8)
    jr = JPackedReads.from_ascii(reads)
    res = jmapper.map_reads(ji, jr)
    tb = jmapper.traceback_cigars(ji, jr, res)
    ti = mapper.MinimizerIndex.build(ref, k=13, w=8, device=CPU)
    tr = PackedReads.from_ascii(reads, device=CPU)
    return ji, jr, res, tb, ti, tr


def test_pileup_counts_ops_matches_jax(planted):
    ji, jr, res, tb, ti, tr = planted
    keep = res["mapped"]
    rs = res["ref_start"].astype(np.int32)
    use_rc = res["strand"] == b"-"
    want = jpileup.pileup_counts_ops(jr.words, jr.lengths, jnp.asarray(rs), jnp.asarray(use_rc),
                                     jnp.asarray(keep), jnp.asarray(tb["ops"]), ji.ref_len)
    got = pileup.pileup_counts_ops(tr.words, tr.lengths, torch.from_numpy(rs),
                                   torch.from_numpy(use_rc), torch.from_numpy(keep),
                                   torch.from_numpy(tb["ops"]), ti.ref_len)
    _equal(got, want)
    assert int(got[1].sum()) > 0 and int(got[2].sum()) > 0


@pytest.mark.parametrize("cigar", [False, True])
@pytest.mark.parametrize("max_cost,min_depth,min_frac", [(8, 2, 0.5), (0, 1, 0.5),
                                                         (20, 3, 0.8)])
def test_call_variants_matches_jax(planted, cigar, max_cost, min_depth, min_frac):
    ji, jr, res, tb, ti, tr = planted
    kw = dict(max_cost=max_cost, min_depth=min_depth, min_frac=min_frac, cigar=cigar)
    if cigar:
        kw["ops"] = tb["ops"]
    want = jpileup.call_variants(ji, jr, res, **kw)
    got = pileup.call_variants(ti, tr, res, **kw)
    _equal(got, want)


def test_call_variants_planted_calls_and_own_traceback(planted, monkeypatch):
    """cigar=True without ops runs the port's traceback_cigars; the planted
    deletion, insertion and SNP come out; batches change no output."""
    ji, jr, res, tb, ti, tr = planted
    want = jpileup.call_variants(ji, jr, res, max_cost=20, cigar=True)
    monkeypatch.setattr(pileup, "PILEUP_BATCH", 13)
    got = pileup.call_variants(ti, tr, res, max_cost=20, cigar=True)
    _equal(got, want)
    assert 1003 in got["del_pos"].tolist()
    assert got["del_len"][got["del_pos"].tolist().index(1003)] == 3
    assert 2001 in got["ins_pos"].tolist()
    assert 503 in got["variant_pos"].tolist()
    gapless = pileup.call_variants(ti, tr, res)
    _equal(gapless, jpileup.call_variants(ji, jr, res))
