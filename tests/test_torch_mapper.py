"""bitnuc_tpu_torch.mapper against bitnuc_tpu.mapper: MinimizerIndex (build,
build_multi, .npz files both ways), map_reads and traceback_cigars on the
same genome and reads, every field and every CIGAR equal.

The genome is two random contigs (about 30 kbp) with runs of N, a segment
repeated across the contigs and a tandem repeat, so that minimizers repeat
and the join and vote meet tied rows. The reads are 150 bp from both
strands with substitutions and small indels, plus unmapped random reads,
reads shorter than k + w, and reads over the contig junction. The JAX
results of each configuration are computed once per module."""

import numpy as np
import pytest
import torch

from bitnuc_tpu import mapper as jmapper
from bitnuc_tpu.ops.pallas import wavefront as jwavefront
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch import mapper
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_to_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _contigs():
    rng = np.random.default_rng(2024)
    c1 = bytearray(ACGT[rng.integers(0, 4, 17_000)].tobytes())
    c2 = bytearray(ACGT[rng.integers(0, 4, 13_000)].tobytes())
    c1[4000:4100] = b"N" * 100
    c2[2500:2530] = b"N" * 30
    c2[8000:8200] = c1[9000:9200]  # repeated across the contigs
    c1[12000:12240] = b"ACGTTGCAGT" * 24  # tandem repeat
    return [bytes(c1), bytes(c2)]


def _reads(genome: bytes):
    rng = np.random.default_rng(7)
    reads = []
    junction = 17_000  # the separator base of build_multi
    for i in range(200):
        L = 150
        s = int(rng.integers(0, len(genome) - L))
        if i % 25 == 3:
            s = junction - 60  # over the contig junction
        r = bytearray(genome[s : s + L])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(r)))
            op = int(rng.integers(0, 4))
            if op < 2:
                r[p] = int(ACGT[rng.integers(0, 4)])
            elif op == 2:
                del r[p]
            else:
                r.insert(p, int(ACGT[rng.integers(0, 4)]))
        r = bytes(r[:L])
        if i % 2:
            r = r.translate(COMP)[::-1]
        if i % 31 == 5:
            r = ACGT[rng.integers(0, 4, L)].tobytes()  # unmapped
        if i % 40 == 7:
            r = r[: int(rng.integers(0, 20))]  # shorter than k + w
        reads.append(r)
    return reads


@pytest.fixture(scope="module")
def data():
    contigs = _contigs()
    genome = contigs[0] + b"A" + contigs[1]
    reads = _reads(genome)
    return contigs, reads, JPackedReads.from_ascii(reads, validate=False), \
        PackedReads.from_ascii(reads, validate=False, device=CPU)


_JAX_RUNS = {}


def _jax_run(data, k):
    """JAX index, map and traceback results for k (computed once)."""
    if k not in _JAX_RUNS:
        contigs, _, jr, _ = data
        ji = jmapper.MinimizerIndex.build_multi(contigs, k=k, w=10, max_occ=8)
        res = jmapper.map_reads(ji, jr)
        _JAX_RUNS[k] = (ji, res, jmapper.traceback_cigars(ji, jr, res))
    return _JAX_RUNS[k]


def _index_equal(ti, ji):
    for name in ("keys", "keys_hi", "ref_words"):
        np.testing.assert_array_equal(words_to_u32_np(getattr(ti, name)), getattr(ji, name),
                                      err_msg=name)
    np.testing.assert_array_equal(ti.pos.numpy(), ji.pos)
    np.testing.assert_array_equal(ti.nocc.numpy(), ji.nocc)
    assert (ti.ref_len, ti.k, ti.w, ti.max_occ) == (ji.ref_len, ji.k, ji.w, ji.max_occ)
    if ji.contig_starts is None:
        assert ti.contig_starts is None
    else:
        np.testing.assert_array_equal(ti.contig_starts, ji.contig_starts)


@pytest.mark.parametrize("k,max_occ", [(13, 4), (15, 8), (21, 8), (21, 4)])
def test_index_build_multi_matches_jax(data, k, max_occ):
    contigs = data[0]
    ji = jmapper.MinimizerIndex.build_multi(contigs, k=k, w=10, max_occ=max_occ)
    ti = mapper.MinimizerIndex.build_multi(contigs, k=k, w=10, max_occ=max_occ, device=CPU)
    assert len(ti) == len(ji) > 1000
    _index_equal(ti, ji)


@pytest.mark.parametrize("k,w", [(15, 10), (21, 5)])
def test_index_build_from_bytes_and_words_matches_jax(data, k, w):
    """One sequence with N runs and lower case, and the packed-words path."""
    seq = data[0][0][:9000].lower()
    ji = jmapper.MinimizerIndex.build(seq, k=k, w=w, max_occ=4)
    ti = mapper.MinimizerIndex.build(seq, k=k, w=w, max_occ=4, device=CPU)
    _index_equal(ti, ji)
    jw = jmapper.MinimizerIndex.build(ji.ref_words, k=k, w=w, max_occ=4, ref_len=ji.ref_len)
    tw = mapper.MinimizerIndex.build(ji.ref_words, k=k, w=w, max_occ=4, ref_len=ji.ref_len,
                                     device=CPU)
    _index_equal(tw, jw)


def test_index_npz_both_ways(data, tmp_path):
    ji = _jax_run(data, 15)[0]
    ti = mapper.MinimizerIndex.build_multi(data[0], device=CPU)
    ti.save(tmp_path / "t.npz")
    _index_equal(ti, jmapper.MinimizerIndex.load(tmp_path / "t.npz"))
    ji.save(tmp_path / "j.npz")
    _index_equal(mapper.MinimizerIndex.load(tmp_path / "j.npz", device=CPU), ji)
    with np.load(tmp_path / "t.npz") as z:
        assert z["keys"].dtype == z["keys_hi"].dtype == z["ref_words"].dtype == np.uint32


def _result_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("k", [15, 21])
def test_map_reads_and_cigars_match_jax(data, k):
    """The CLI defaults (k = 15, w = 10, max_occ = 8, min_seeds = 2) and k = 21:
    every map_reads field, then traceback_cigars' strings, costs and ops."""
    ji, want, want_tb = _jax_run(data, k)
    ti = mapper.MinimizerIndex.build_multi(data[0], k=k, device=CPU)
    reads = data[3]
    got = mapper.map_reads(ti, reads)
    _result_equal(got, want)
    assert 150 <= got["mapped"].sum() < len(got["mapped"])
    tb = mapper.traceback_cigars(ti, reads, got, chunk=64)
    assert tb["cigar"] == want_tb["cigar"]
    np.testing.assert_array_equal(tb["tb_cost"], want_tb["tb_cost"])
    np.testing.assert_array_equal(tb["ops"], want_tb["ops"])


def test_map_batches_change_no_output(data, monkeypatch):
    ji, want, _ = _jax_run(data, 15)
    ti = mapper.MinimizerIndex.build_multi(data[0], device=CPU)
    monkeypatch.setattr(mapper, "MAP_BATCH", 37)
    _result_equal(mapper.map_reads(ti, data[3]), want)
    empty = PackedReads(words=data[3].words[:0], lengths=data[3].lengths[:0])
    assert all(len(v) == 0 for v in mapper.map_reads(ti, empty).values())


def test_banded_cigars_match_jax(data):
    ji, res, _ = _jax_run(data, 15)
    ti = mapper.MinimizerIndex.build_multi(data[0], device=CPU)
    want = jmapper.traceback_cigars(ji, data[2], res, band=20)
    got = mapper.traceback_cigars(ti, data[3], res, band=20)
    assert got["cigar"] == want["cigar"]
    np.testing.assert_array_equal(got["ops"], want["ops"])


def test_band_widening_matches_jax():
    for lo, hi in ((-32, 112), (-8, 40), (-16, 96), (0, 0), (-5, 200)):
        assert mapper._band_k8(lo, hi) == jwavefront._band_k8(lo, hi)
    assert mapper._band_k8(-32, 80 + 32) == (80, 124)  # the CLI defaults


def test_seed_cap_and_mesh():
    for L in (16, 100, 160, 1000):
        for w in (1, 5, 10):
            assert mapper._seed_cap(L, w) == jmapper._seed_cap(L, w)
    ti = mapper.MinimizerIndex.build(b"ACGT" * 40, k=5, w=3, device=CPU)
    reads = PackedReads.from_ascii([b"ACGTACGTACGT"], device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mapper.map_reads(ti, reads, mesh=object())
    with pytest.raises(ValueError):
        mapper.MinimizerIndex.build(b"ACGT" * 10, k=32, device=CPU)


# -- long reads and pairs ---------------------------------------------------------


def _rc(s: bytes) -> bytes:
    return s.translate(COMP)[::-1]


def _indel_read(rng, src: bytes) -> bytes:
    """src with an insertion or deletion of 1-14 bp every 120-300 bp, as
    tests/test_mapper.py builds its long read."""
    read = bytearray()
    p = 0
    while p < len(src):
        chunk = int(rng.integers(120, 300))
        read += src[p : p + chunk]
        p += chunk
        if p < len(src):
            if rng.random() < 0.5:
                read += ACGT[rng.integers(0, 4, int(rng.integers(1, 15)))].tobytes()
            else:
                p += int(rng.integers(1, 15))
    return bytes(read)


@pytest.fixture(scope="module")
def long_data():
    """A 14-kbp reference with a repeat; indel-rich reads of 600-2,500 bp
    from both strands, one with substitutions, a junk read, a read shorter
    than k + w and an empty one."""
    rng = np.random.default_rng(11)
    ref = bytearray(ACGT[rng.integers(0, 4, 14_000)].tobytes())
    ref[9000:9400] = ref[2000:2400]  # a repeat: anchors on two loci
    ref = bytes(ref)
    reads = []
    for i, (s, n) in enumerate(((3000, 2000), (500, 1200), (6000, 2500), (1800, 900),
                                (11_000, 2400), (8700, 600))):
        r = _indel_read(rng, ref[s : s + n])
        if i == 3:  # substitutions too
            b = bytearray(r)
            for p in rng.integers(0, len(b), 20):
                b[p] = int(ACGT[rng.integers(0, 4)])
            r = bytes(b)
        reads.append(_rc(r) if i % 2 else r)
    reads.append(ACGT[rng.integers(0, 4, 1500)].tobytes())  # junk
    reads += [reads[0][:18], b""]
    return ref, reads


def _long_pair(long_data, k=15, w=10):
    ref, reads = long_data
    ji = jmapper.MinimizerIndex.build(ref, k=k, w=w)
    ti = mapper.MinimizerIndex.build(ref, k=k, w=w, device=CPU)
    return (ji, JPackedReads.from_ascii(reads, validate=False), ti,
            PackedReads.from_ascii(reads, validate=False, device=CPU))


_JAX_LONG = {}


def _jax_long(long_data, extend):
    """JAX's map_reads_long at min_chain 10 (computed once per mode)."""
    if extend not in _JAX_LONG:
        ji, jr = _long_pair(long_data)[:2]
        _JAX_LONG[extend] = jmapper.map_reads_long(ji, jr, min_chain=10, extend=extend)
    return _JAX_LONG[extend]


@pytest.mark.parametrize("extend", [False, True])
def test_map_reads_long_matches_jax(long_data, extend):
    ti, tr = _long_pair(long_data)[2:]
    got = mapper.map_reads_long(ti, tr, min_chain=10, extend=extend)
    _result_equal(got, _jax_long(long_data, extend))
    assert got["mapped"].tolist() == [True] * 6 + [False] * 3
    assert got["strand"][:6].tolist() == [b"+", b"-"] * 3
    assert ("cost" in got) == extend


def test_map_reads_long_parameters_match_jax(long_data):
    """Other gaps, lookback, padding and costs, at k = 13 and w = 8."""
    ji, jr, ti, tr = _long_pair(long_data, k=13, w=8)
    kw = dict(min_chain=3, max_gap=300, gap_unit=4, lookback=9, pad=20, mismatch=2, gap=3)
    _result_equal(mapper.map_reads_long(ti, tr, extend=True, **kw),
                  jmapper.map_reads_long(ji, jr, extend=True, **kw))


@pytest.mark.parametrize("extend", [False, True])
def test_map_reads_long_chunks_change_no_output(long_data, monkeypatch, extend):
    """Chunks of two reads against JAX's one batch."""
    ti, tr = _long_pair(long_data)[2:]
    W = tr.words.shape[1]
    per_read = mapper._LONG_BYTES // mapper._long_chunk(W, ti, extend, 32)
    monkeypatch.setattr(mapper, "_LONG_BYTES", 2 * per_read)
    assert mapper._long_chunk(W, ti, extend, 32) == 2
    _result_equal(mapper.map_reads_long(ti, tr, min_chain=10, extend=extend),
                  _jax_long(long_data, extend))
    empty = PackedReads(words=tr.words[:0], lengths=tr.lengths[:0])
    assert all(len(v) == 0 for v in mapper.map_reads_long(ti, empty, extend=extend).values())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mapper.map_reads_long(ti, tr, mesh=object())


def test_reverse_reads_matches_jax(long_data):
    reads = long_data[1]
    jr = JPackedReads.from_ascii(reads, validate=False)
    tr = PackedReads.from_ascii(reads, validate=False, device=CPU)
    got = mapper._reverse_reads(tr.words, tr.lengths)
    want = jmapper._reverse_reads(jr.words, jr.lengths)
    np.testing.assert_array_equal(words_to_u32_np(got), np.asarray(want))
    back = PackedReads(words=got, lengths=tr.lengths).to_ascii()
    assert back == [r[::-1] for r in reads]


def _pairs(seed, ref: bytes, n: int = 40, L: int = 120):
    """R1/R2 as tests/test_mapper.py's fuzz lays them out: FR, RF, FF, RR
    and junk mates, inserts of 80-700 bp."""
    rng = np.random.default_rng(seed)
    r1s, r2s = [], []
    for _ in range(n):
        s1 = int(rng.integers(0, len(ref) - 200))
        s2 = min(s1 + int(rng.integers(80, 700)) - L, len(ref) - L)
        a, b = ref[s1 : s1 + L], ref[max(s2, 0) : max(s2, 0) + L]
        layout = int(rng.integers(0, 5))
        r1s.append((a, _rc(a), a, _rc(a), a)[layout])
        r2s.append((_rc(b), b, b, _rc(b), ACGT[rng.integers(0, 4, L)].tobytes())[layout])
    return r1s, r2s


def _pairs_equal(got, want):
    for mate in ("r1", "r2"):
        _result_equal(got[mate], want[mate])
    for key in ("proper", "insert"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("seed", [0, 1])
def test_map_pairs_fuzz_matches_jax(seed):
    rng = np.random.default_rng(40 + seed)
    ref = ACGT[rng.integers(0, 4, 12_000)].tobytes()
    ji = jmapper.MinimizerIndex.build(ref, k=13, w=8)
    ti = mapper.MinimizerIndex.build(ref, k=13, w=8, device=CPU)
    r1s, r2s = _pairs(seed, ref)
    r2s[3] = r2s[3][:90]  # a narrower mate: the batches widen to one W
    kw = dict(min_insert=150, max_insert=450)
    want = jmapper.map_pairs(ji, JPackedReads.from_ascii(r1s), JPackedReads.from_ascii(r2s), **kw)
    got = mapper.map_pairs(ti, PackedReads.from_ascii(r1s, device=CPU),
                           PackedReads.from_ascii(r2s, device=CPU), **kw)
    _pairs_equal(got, want)
    assert got["proper"].any() and not got["proper"].all()


def test_map_pairs_proper_discordant_rf_and_mismatched():
    rng = np.random.default_rng(8)
    ref = ACGT[rng.integers(0, 4, 8000)].tobytes()
    ji = jmapper.MinimizerIndex.build(ref, k=13, w=8)
    ti = mapper.MinimizerIndex.build(ref, k=13, w=8, device=CPU)
    frag = ref[2000:2400]
    r1s = [frag[:120], ref[500:620], ref[3000:3120], ref[4000:4120], _rc(ref[5000:5120])]
    r2s = [_rc(frag[-120:]), _rc(ref[6000:6120]), ref[3200:3320],
           ACGT[rng.integers(0, 4, 120)].tobytes(), ref[5300:5420]]  # proper, far, FF, junk, RF
    kw = dict(min_insert=100, max_insert=800, bin_bits=4, pad=24)
    want = jmapper.map_pairs(ji, JPackedReads.from_ascii(r1s), JPackedReads.from_ascii(r2s), **kw)
    got = mapper.map_pairs(ti, PackedReads.from_ascii(r1s, device=CPU),
                           PackedReads.from_ascii(r2s, device=CPU), **kw)
    _pairs_equal(got, want)
    assert got["proper"].tolist() == [True, False, False, False, False]
    assert got["insert"].tolist() == [400, -1, -1, -1, -1]
    with pytest.raises(ValueError, match="mate batches differ"):
        mapper.map_pairs(ti, PackedReads.from_ascii(r1s[:1], device=CPU),
                         PackedReads.from_ascii(r2s[:2], device=CPU))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mapper.map_pairs(ti, PackedReads.from_ascii(r1s, device=CPU),
                         PackedReads.from_ascii(r2s, device=CPU), mesh=object())
