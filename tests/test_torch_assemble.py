"""bitnuc_tpu_torch.assemble against bitnuc_tpu.assemble on the same
numpy-seeded inputs, with the JAX package's native library loaded and with
it switched off: unitigs (linear, circular, palindromes at
even k, k = 1, 2, 31 and 32), the strand union, tip and bubble cleaning,
graph links, GFA and FASTA bytes, the three spectrum engines of
assemble_reads with base_valid, and assemble_counts."""

import re

import numpy as np
import pytest
import torch

import bitnuc_tpu as jbn
from bitnuc_tpu import assemble as jasm, native as jnative
from bitnuc_tpu.ops import codec as jcodec
import bitnuc_tpu_torch as tbn
from bitnuc_tpu_torch import assemble as asm
from bitnuc_tpu_torch.ops import codec
from bitnuc_tpu_torch.parallel import mesh as pmesh
from test_torch_native import jax_native

torch.set_num_threads(1)
CPU = torch.device("cpu")
BASES = "ACGT"
CODE = {c: i for i, c in enumerate(BASES)}


@pytest.fixture(params=["native", "numpy"])
def jax_side(request, monkeypatch):
    """The JAX package with its native library loaded, or with it
    switched off (its numpy forms)."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        jax_native()
    return request.param


def packed(s: str) -> int:
    return sum(CODE[c] << (2 * i) for i, c in enumerate(s))


def windows(seq: str, k: int):
    return [seq[i : i + k] for i in range(len(seq) - k + 1)]


def kmer_set(rng, k, mode):
    """Chains from random sequences, noise k-mers and pure cycles."""
    kmers = set()
    if mode in ("seq", "mixed"):
        for _ in range(rng.integers(1, 4)):
            L = int(rng.integers(k, 6 * k + 2))
            kmers |= set(windows("".join(rng.choice(list(BASES), L)), k))
    if mode in ("noise", "mixed"):
        for _ in range(int(rng.integers(0, 12))):
            kmers.add("".join(rng.choice(list(BASES), k)))
    if mode == "cycle":
        for _ in range(int(rng.integers(1, 3))):
            L = int(rng.integers(k + 1, 4 * k + 2))
            g = "".join(rng.choice(list(BASES), L))
            kmers |= set(windows(g + g[: k - 1], k))
    if mode == "palindrome":  # even k: rc(x) == x for half-and-rc k-mers
        comp = str.maketrans("ACGT", "TGCA")
        for _ in range(int(rng.integers(2, 8))):
            h = "".join(rng.choice(list(BASES), k // 2))
            kmers.add(h + h.translate(comp)[::-1])
        L = int(rng.integers(k, 4 * k))
        kmers |= set(windows("".join(rng.choice(list(BASES), L)), k))
    return kmers


def keys_of(kmers):
    return np.sort(np.array([packed(x) for x in kmers], dtype=np.uint64))


def same(got, want):
    """Equal outputs: tuples and lists element-wise, arrays by dtype and
    value."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (got, want)
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            same(g, w)
    else:
        assert got == want and type(got) is type(want), (got, want)


KS = {"seq": [1, 2, 3, 5, 31, 32], "noise": [2, 4, 31], "mixed": [3, 4, 5, 32],
      "cycle": [1, 2, 3, 5, 31], "palindrome": [2, 4, 6, 32]}
CASES = [(m, k) for m in KS for k in KS[m]]


@pytest.mark.parametrize("mode,k", CASES)
def test_key_set_functions_match_jax(jax_side, mode, k):
    """unitigs_from_keys, unitig_graph, prepare_keys, clean_keys and
    assemble_keys (one strand and both, cleaned and not) on random key
    sets: every output equal to JAX's."""
    rng = np.random.default_rng(hash((mode, k)) % 2**31)
    for _ in range(5):
        kmers = kmer_set(rng, k, mode)
        if k == 1:
            kmers = set(rng.choice(list(BASES), int(rng.integers(1, 5))).tolist())
        keys = keys_of(kmers)
        cts = rng.integers(1, 30, keys.shape[0]).astype(np.int64)
        same(asm.unitigs_from_keys(keys, k), jasm.unitigs_from_keys(keys, k))
        same(asm.unitig_graph(keys, k), jasm.unitig_graph(keys, k))
        for both in (False, True):
            kw = dict(both_strands=both)
            same(asm.prepare_keys(keys, cts, k, **kw), jasm.prepare_keys(keys, cts, k, **kw))
            same(asm.prepare_keys(keys, None, k, clean=True, **kw),
                 jasm.prepare_keys(keys, None, k, clean=True, **kw))
            for clean in (False, True):
                same(asm.assemble_keys(keys, k, counts=cts, clean=clean, **kw),
                     jasm.assemble_keys(keys, k, counts=cts, clean=clean, **kw))
        for tip_len, pop in ((None, True), (3 * k, False), (k + 1, True)):
            same(asm.clean_keys(keys, cts, k, tip_len=tip_len, pop_bubbles=pop),
                 jasm.clean_keys(keys, cts, k, tip_len=tip_len, pop_bubbles=pop))
        same(asm._expand_both_strands(keys, cts, k), jasm._expand_both_strands(keys, cts, k))
        same(asm._rc_keys(keys, k), jasm._rc_keys(keys, k))


def test_empty_and_errors_match_jax(jax_side):
    for k in (1, 21, 32):
        same(asm.unitigs_from_keys(np.array([], np.uint64), k),
             jasm.unitigs_from_keys(np.array([], np.uint64), k))
        same(asm.unitig_graph(np.array([], np.uint64), k),
             jasm.unitig_graph(np.array([], np.uint64), k))
        same(asm.assemble_keys(np.array([], np.uint64), k, both_strands=True, clean=True),
             jasm.assemble_keys(np.array([], np.uint64), k, both_strands=True, clean=True))
    for bad in ((np.array([3, 1], np.uint64), 3), (np.array([1], np.uint64), 0),
                (np.array([1], np.uint64), 33)):
        with pytest.raises(ValueError) as want:
            jasm.unitigs_from_keys(*bad)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            asm.unitigs_from_keys(*bad)
    with pytest.raises(ValueError, match="align"):
        asm.clean_keys(np.array([1, 2], np.uint64), np.array([1]), 3)


def _genome(rng, n):
    return "".join(rng.choice(list(BASES), n))


def _reads_covering(genome, rlen=100, step=7, wrap=False):
    src = genome + genome[: rlen - 1] if wrap else genome
    reads = [src[i : i + rlen] for i in range(0, len(src) - rlen + 1, step)]
    if not wrap and (len(genome) - rlen) % step:
        reads.append(genome[-rlen:])
    return [r.encode() for r in reads]


def _mutate(read: bytes, pos: int) -> bytes:
    b = bytearray(read)
    b[pos] = ord("A") if b[pos] != ord("A") else ord("C")
    return bytes(b)


def _with_ns(reads, rng, rate):
    out = []
    for r in reads:
        b = bytearray(r)
        for p in np.flatnonzero(rng.random(len(b)) < rate):
            b[p] = ord("N")
        out.append(bytes(b))
    return out


def _both(reads):
    """The same reads packed by both packages (N packs arithmetically),
    with their base-validity masks: (JAX reads, JAX mask, port reads,
    port mask)."""
    jr = jbn.PackedReads.from_ascii(reads, validate=False)
    tr = tbn.PackedReads.from_ascii(reads, validate=False, device=CPU)
    L = max(len(r) for r in reads)
    a = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        a[i, : len(r)] = np.frombuffer(r, np.uint8)
    jbv = np.asarray(jcodec.validity_mask(a, np.asarray(jr.lengths)))
    tbv = codec.validity_mask(torch.from_numpy(a), tr.lengths)
    np.testing.assert_array_equal(tbv.numpy(), jbv)
    return jr, jbv, tr, tbv


GENOMES = {
    "linear": (21, 300, dict()),
    "circular": (21, 240, dict(wrap=True)),
    "tips_and_bubbles": (21, 300, dict()),
    "repeats": (11, 260, dict()),
}


@pytest.fixture(scope="module")
def read_sets():
    """Read sets of small genomes: plain, circular, with a tip and a bubble
    error read (each coverage doubled), and with an inserted repeat; all
    with Ns at 0.5%."""
    out = {}
    for i, (name, (k, n, kw)) in enumerate(GENOMES.items()):
        rng = np.random.default_rng(100 + i)
        g = _genome(rng, n)
        if name == "repeats":
            g = g[:100] + g[20:60] + g[100:] + g[20:60]
        good = _reads_covering(g, 90, 5, **kw) * 2
        if name == "tips_and_bubbles":
            good += [_mutate(good[4], 89), _mutate(good[6], 40), _mutate(good[9], 0)]
        out[name] = (k, _with_ns(good, rng, 0.005))
    return out


@pytest.mark.parametrize("genome", list(GENOMES))
def test_assemble_reads_engines_match_jax(jax_side, read_sets, genome):
    """assemble_reads' three engines, with base_valid and without, one
    strand and both, min_count 1 and 2, cleaned and not: each equal to the
    JAX package's same engine, and the engines equal to each other."""
    k, reads = read_sets[genome]
    jr, jbv, tr, tbv = _both(reads)
    for both in (True, False):
        for min_count, clean in ((1, False), (1, True), (2, False)):
            kw = dict(min_count=min_count, both_strands=both, clean=clean)
            want = jasm.assemble_reads(jr, k, base_valid=jbv, engine="device", **kw)
            assert want[0]
            for engine in ("auto", "device", "host"):
                got = asm.assemble_reads(tr, k, base_valid=tbv, engine=engine, **kw)
                same(got, want)
                if engine == "host":
                    same(got, jasm.assemble_reads(jr, k, base_valid=jbv, engine="host", **kw))
            if not both:
                continue
            # a numpy mask, and no mask (N windows counted as their code)
            same(asm.assemble_reads(tr, k, base_valid=tbv.numpy(), **kw), want)
            same(asm.assemble_reads(tr, k, **kw),
                 jasm.assemble_reads(jr, k, engine="device", **kw))


def test_assemble_reads_recovers_genomes(read_sets):
    """Cleaning restores the genome past a tip and a bubble; a circular
    genome comes back as one circular unitig."""
    rng = np.random.default_rng(7)
    g = _genome(rng, 300)
    good = _reads_covering(g, 90, 5) * 2
    tr = tbn.PackedReads.from_ascii(good + [_mutate(good[4], 89), _mutate(good[6], 40)],
                                    device=CPU)
    seqs, circ = asm.assemble_reads(tr, 21, min_count=1, clean=True)
    assert seqs == [min(g.encode(), asm.rc_ascii(g.encode()))] and circ == [False]
    assert len(asm.assemble_reads(tr, 21, min_count=1)[0]) > 1
    g = _genome(rng, 240)
    tr = tbn.PackedReads.from_ascii(_reads_covering(g, 90, 5, wrap=True), device=CPU)
    seqs, circ = asm.assemble_reads(tr, 21, min_count=1, both_strands=False)
    assert circ == [True] and len(seqs[0]) == 240 + 20 and seqs[0][:20] == seqs[0][-20:]


def test_assemble_reads_arguments():
    tr = tbn.PackedReads.from_ascii([b"ACGT" * 10], device=CPU)
    with pytest.raises(ValueError, match="engine must be"):
        asm.assemble_reads(tr, 5, engine="gpu")
    mesh = pmesh.make_mesh((3,), ("data",), devices=[CPU] * 3)
    assert asm.assemble_reads(tr, 5, min_count=1, mesh=mesh) == asm.assemble_reads(
        tr, 5, min_count=1)
    for engine in ("auto", "device", "host"):  # too short for any window
        assert asm.assemble_reads(tbn.PackedReads.from_ascii([b"ACG"], device=CPU), 5,
                                  engine=engine) == ([], [])


@pytest.mark.parametrize("k", [1, 2, 15, 16, 31, 32])
@pytest.mark.parametrize("canonical", [False, True])
def test_host_spectrum_matches_jax(jax_side, k, canonical):
    """The host engine's spectrum against the JAX package's (its C++
    library, or its numpy form) and against the device engine's keys."""
    rng = np.random.default_rng(k)
    reads = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), int(n)))
             for n in rng.integers(0, 70, 40)]
    reads[0] = b"T" * 64  # the all-T key: the sentinel at k = 32
    jr, jbv, tr, tbv = _both(reads)
    words, lens = tr.to_numpy()
    for bv in (None, jbv, jbv[:, :7]):
        want = jnative.spectrum(np.asarray(jr.words), np.asarray(jr.lengths), k,
                                canonical=canonical, valid=bv)
        same(asm._np_spectrum(words, lens, k, canonical, bv), want)
    from bitnuc_tpu_torch.ops import kmer

    lo, hi, ct, _ = kmer.count_kmers_runs(tr.words, tr.lengths, k, canonical, tbv)
    keys, cts = asm._runs_to_keys(lo, hi, ct, 1)
    hk, hc = asm._np_spectrum(words, lens, k, canonical, jbv)
    same(keys, hk)
    same(cts, hc.astype(np.int64))


def test_runs_to_keys_reads_lo_unsigned():
    """A key whose low word has bit 31 set comes back unsigned."""
    lo = torch.tensor([1, -2, 5, -1], dtype=torch.int32)
    hi = torch.tensor([0, 0, 7, -1], dtype=torch.int32)
    ct = torch.tensor([3, 2, 0, 9], dtype=torch.int32)
    keys, cts = asm._runs_to_keys(lo, hi, ct, 2)
    same(keys, np.array([1, 0xFFFFFFFE, 0xFFFFFFFFFFFFFFFF], np.uint64))
    same(cts, np.array([3, 2, 9], np.int64))


@pytest.mark.parametrize("k", [13, 21, 31])
def test_assemble_counts_matches_jax(jax_side, read_sets, tmp_path, k):
    """assemble_counts of count_fastq's dict (the streaming entry point)."""
    from bitnuc_tpu import pipeline as jpipeline
    from bitnuc_tpu_torch import pipeline

    _, reads = read_sets["tips_and_bubbles"]
    p = tmp_path / "r.fq"
    with open(p, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    kw = dict(canonical=True, on_invalid="skip")
    table = pipeline.count_fastq(p, k, device=CPU, **kw)
    assert table == jpipeline.count_fastq(p, k, **kw)
    for min_count, both, clean, tip in ((2, True, False, None), (1, True, True, None),
                                        (1, False, True, 30), (3, False, False, None)):
        kw = dict(min_count=min_count, both_strands=both, clean=clean, tip_len=tip)
        same(asm.assemble_counts(table, k, **kw), jasm.assemble_counts(table, k, **kw))


def test_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), int(n)))
            for n in rng.integers(1, 40, 60)] + [b"AAAA", b"ACAC", b"CGCGCGC", b"A"]
    for s in seqs:
        assert asm.rc_ascii(s) == jasm.rc_ascii(s)
        assert asm._least_rotation(s) == jasm._least_rotation(s)
        assert asm._canonical_rotation(s) == jasm._canonical_rotation(s)
    circ = [bool(c) for c in rng.random(len(seqs)) < 0.3]
    twins = seqs + [asm.rc_ascii(s) for s in seqs[::3]]
    tcirc = circ + circ[::3]
    for k in (1, 3, 5):
        same(asm.dedupe_strand_twins(twins, tcirc, k), jasm.dedupe_strand_twins(twins, tcirc, k))
    same(asm._sort_longest_first(twins, tcirc), jasm._sort_longest_first(twins, tcirc))


def test_gfa_and_fasta_bytes_match_jax(tmp_path, read_sets):
    """write_gfa and write_fasta of the same graph: the same bytes, with
    and without circular flags and with another prefix."""
    for name in ("circular", "tips_and_bubbles"):
        k, reads = read_sets[name]
        jr, jbv, tr, tbv = _both(reads)
        keys, cts = asm.prepare_keys(*asm._runs_to_keys(
            *tbn.count_kmers_runs(tr.words, tr.lengths, k, True, tbv)[:3], 1), k,
            both_strands=True)
        seqs, circ, links = asm.unitig_graph(keys, k)
        assert (seqs, circ, links) == jasm.unitig_graph(keys, k) and links
        for circular, prefix in ((circ, "utg"), (None, "ctg")):
            for mod, tag in ((asm, "t"), (jasm, "j")):
                mod.write_gfa(tmp_path / f"{tag}.gfa", seqs, links, k, circular=circular,
                              prefix=prefix)
                mod.write_fasta(tmp_path / f"{tag}.fa", seqs, circular, prefix=prefix)
            for ext in ("gfa", "fa"):
                assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("genome", ["linear", "repeats"])
@pytest.mark.parametrize("n", [3, 8])
def test_assemble_reads_mesh_matches_jax(read_sets, genome, n):
    """The spectrum over n CPU shards (the reads padded to a multiple, the
    validity mask with them) against JAX's n-device mesh path and the
    unsharded run; one strand and both."""
    import jax

    k, reads = read_sets[genome]
    jr, jbv, tr, tbv = _both(reads[: len(reads) - 1])  # a count no mesh divides
    jmesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
    mesh = pmesh.make_mesh((n,), ("data",), devices=[CPU] * n)
    for both in (True, False):
        kw = dict(min_count=2, both_strands=both)
        want = jasm.assemble_reads(jr, k, base_valid=jbv, mesh=jmesh, **kw)
        assert want[0]
        got = asm.assemble_reads(tr, k, base_valid=tbv, mesh=mesh, **kw)
        same(got, want)
        same(got, asm.assemble_reads(tr, k, base_valid=tbv, **kw))
    same(asm.assemble_reads(tr, k, base_valid=tbv.numpy(), mesh=mesh, engine="host"),
         jasm.assemble_reads(jr, k, base_valid=jbv, mesh=jmesh))
