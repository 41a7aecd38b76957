"""bitnuc_tpu_torch codec and PackedReads against bitnuc_tpu: encode against
encode_reads_xla and the K1 Pallas kernel in interpret mode (the plain
version of the port's K1 runs here, on CPU tensors), decode against
decode_reads_xla and the K2 Pallas kernel in interpret mode, validity, the
golden vectors, and .npz interchange. Integer outputs match exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu import io as jio
from bitnuc_tpu.errors import InvalidBase as JInvalidBase
from bitnuc_tpu.ops import codec as jcodec
from bitnuc_tpu.ops.pallas import pack as jpack, unpack as jpallas_unpack
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch import io as tio
from bitnuc_tpu_torch.errors import InvalidBase
from bitnuc_tpu_torch.ops import codec
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_to_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")

CASES = [(1, 1), (3, 50), (17, 33), (4, 160), (2, 1000)]


def _batch(rng, B, L, invalid):
    a = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[0] = 0 if B > 1 else lens[0]
    if invalid:
        a[rng.random((B, L)) < 0.05] = ord("N")
        a[-1, L - 1] = 0
    return a, lens


@pytest.mark.parametrize("invalid", [False, True])
@pytest.mark.parametrize("B,L", CASES)
def test_encode_matches_xla_and_pallas(rng, B, L, invalid):
    a, lens = _batch(rng, B, L, invalid)
    w1, fb1 = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    w2, fb2 = jpack.encode_reads_pallas(jnp.asarray(a), jnp.asarray(lens), interpret=True)
    w, fb = codec.encode_reads(torch.from_numpy(a), torch.from_numpy(lens))
    for want_w, want_fb in ((w1, fb1), (w2, fb2)):
        np.testing.assert_array_equal(words_to_u32_np(w), np.asarray(want_w))
        np.testing.assert_array_equal(fb.numpy(), np.asarray(want_fb))


def test_encode_any_rank_and_n_words(rng):
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(2, 3, 40))
    lens = np.full((2, 3), 37, np.int32)
    w1, fb1 = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens), n_words=6)
    w, fb = codec.encode_reads(torch.from_numpy(a), torch.from_numpy(lens), n_words=6)
    np.testing.assert_array_equal(words_to_u32_np(w), np.asarray(w1))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(fb1))
    with pytest.raises(ValueError):
        codec.encode_reads(torch.from_numpy(a), torch.from_numpy(lens), n_words=3)


@pytest.mark.parametrize("max_len", [None, 20, 300])
def test_decode_matches_xla(rng, max_len):
    a, lens = _batch(rng, 9, 130, False)
    w, _ = jcodec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    want = np.asarray(jcodec.decode_reads_xla(w, jnp.asarray(lens), max_len=max_len))
    tw = torch.from_numpy(np.asarray(w).view(np.int32).copy())
    got = codec.decode_reads(tw, torch.from_numpy(lens), max_len=max_len).numpy()
    np.testing.assert_array_equal(got, want)


def test_validity_and_kmer_packing(rng):
    a, lens = _batch(rng, 6, 32, True)
    want = np.asarray(jcodec.validity_mask(jnp.asarray(a), jnp.asarray(lens)))
    got = codec.validity_mask(torch.from_numpy(a), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    w1, fb1 = jcodec.pack_kmers(jnp.asarray(a), jnp.asarray(lens))
    w, fb = codec.pack_kmers(torch.from_numpy(a), torch.from_numpy(lens))
    np.testing.assert_array_equal(words_to_u32_np(w), np.asarray(w1))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(fb1))
    back = codec.unpack_kmers(w, torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jcodec.unpack_kmers(w1, jnp.asarray(lens))))


def test_goldens():
    r = PackedReads.from_ascii([b"ACGT"], device=CPU)
    assert int(r.to_u64()[0, 0]) == 0b11100100
    g = PackedReads.from_u64(np.array([[71620941647064936]], np.uint64), [28], device=CPU)
    assert g.to_ascii() == [b"AGGCTTGAGGCCCATTCTCTGATCGTTT"]
    assert g[0].to_vec() == b"AGGCTTGAGGCCCATTCTCTGATCGTTT"


def test_roundtrip_and_invalid_base(rng):
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), n)) for n in (1, 31, 32, 33, 100, 1000)]
    r = PackedReads.from_ascii(seqs, device=CPU)
    assert r.to_ascii() == [s.upper() for s in seqs]
    assert len(r) == 6 and r.n_words == 64 and r.max_bases == 1024
    bad = [b"ACGT", b"ACNT", b"AXGT"]
    with pytest.raises(JInvalidBase) as je:
        JPackedReads.from_ascii(bad)
    with pytest.raises(InvalidBase) as te:
        PackedReads.from_ascii(bad, device=CPU)
    assert te.value.base == je.value.base == ord("N")


def test_from_ascii_copies_array(rng):
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(3, 20))
    r = PackedReads.from_ascii(a, device=CPU)
    want = r.to_ascii()
    a[:] = ord("A")
    assert r.to_ascii() == want


def test_packed_npz_interchange(rng, tmp_path):
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), int(n))) for n in rng.integers(1, 90, 7)]
    jr = JPackedReads.from_ascii(seqs)
    jio.save_packed(tmp_path / "j.npz", jr)
    tr = tio.load_packed(tmp_path / "j.npz", device=CPU)
    assert tr.to_ascii() == seqs
    tio.save_packed(tmp_path / "t.npz", PackedReads.from_ascii(seqs, device=CPU))
    back = jio.load_packed(tmp_path / "t.npz")
    np.testing.assert_array_equal(np.asarray(back.words), np.asarray(jr.words))
    np.testing.assert_array_equal(np.asarray(back.lengths), np.asarray(jr.lengths))


# (B, W words, lengths rule, max_len): the K2 edge shapes
DECODE_EDGES = [
    (1, 2, "full", 1),  # [1, 1]
    (5, 4, "random", 33),  # [5, 33]
    (4, 2, "zero", None),  # zero lengths
    (6, 10, "long", 150),  # lengths past max_len (capacity 160)
    (3, 2, "random", 48),  # max_len past the capacity 16 * W
    (7, 4, "random", 0),
]


def _decode_case(rng, B, W, rule, max_len):
    words = rng.integers(0, 2**32, size=(B, W), dtype=np.uint64).astype(np.uint32)
    cap = 16 * W
    L = cap if max_len is None else max_len
    if rule == "full":
        lens = np.full(B, min(L, cap))
    elif rule == "random":
        lens = rng.integers(0, min(L, cap) + 1, B)
    elif rule == "zero":
        lens = np.zeros(B)
    else:
        lens = rng.integers(L + 1, cap + 1, B)
    return words, lens.astype(np.int32)


@pytest.mark.parametrize("B,W,rule,max_len", DECODE_EDGES)
def test_decode_matches_pallas_at_edges(rng, B, W, rule, max_len):
    """The plain K2 against the Pallas kernel in interpret mode and the XLA
    decode, batched and as the 1-D call PackedReads.__getitem__ makes."""
    words, lens = _decode_case(rng, B, W, rule, max_len)
    tw = torch.from_numpy(words.view(np.int32).copy())
    got = codec.decode_reads(tw, torch.from_numpy(lens), max_len).numpy()
    for want in (
        jpallas_unpack.decode_reads_pallas(jnp.asarray(words), jnp.asarray(lens), max_len,
                                           interpret=True),
        jcodec.decode_reads_xla(jnp.asarray(words), jnp.asarray(lens), max_len),
    ):
        np.testing.assert_array_equal(got, np.asarray(want))
    row = codec.decode_reads(tw[0], torch.from_numpy(lens)[0], max_len)
    np.testing.assert_array_equal(row.numpy(), got[0])
    assert codec.decode_reads_torch(tw, torch.from_numpy(lens), max_len).dtype == torch.uint8


def test_decode_past_capacity_is_zero():
    """Lengths past 16 * W decode to zeros there, as decode_reads_xla does
    (the Pallas kernel writes 'A' for those bases instead)."""
    words = np.array([[0x1B1B1B1B, 0xE4E4E4E4]], np.uint32)
    lens = np.array([40], np.int32)
    want = jcodec.decode_reads_xla(jnp.asarray(words), jnp.asarray(lens), 48)
    got = codec.decode_reads(torch.from_numpy(words.view(np.int32).copy()),
                             torch.from_numpy(lens), 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bytes(got.numpy()[0, 32:]) == bytes(16)
