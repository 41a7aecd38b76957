"""bitnuc_tpu_torch.ops.merge_pairs against bitnuc_tpu.ops.merge_pairs on
the same numpy-seeded pairs, both scans ('packed' and 'codes'), every
output exactly: fuzz over min_overlap and max_mismatch_frac, ragged
lengths, R2 much shorter than R1 (the offsets where a clamped shift window
would compare at the wrong word shift), containment, and batches where
nothing merges."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import codec as jcodec, merge_pairs as jmp
from bitnuc_tpu_torch.ops import merge_pairs as tmp
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")
_RC = bytes.maketrans(b"ACGT", b"TGCA")
NAMES = ("words", "lens", "merged", "overlap", "mismatches")


def rc(s: bytes) -> bytes:
    return s[::-1].translate(_RC)


def _packed(seqs):
    r = PackedReads.from_ascii(seqs, device=CPU)
    return r.to_numpy()


def _check(seqs1, seqs2, *args, **kw):
    """Both scans of the port against JAX's default scan, every output;
    returns the port's outputs as numpy."""
    w1, l1 = _packed(seqs1)
    w2, l2 = _packed(seqs2)
    want = jmp.merge_pairs(jnp.asarray(w1), jnp.asarray(l1), jnp.asarray(w2), jnp.asarray(l2),
                           *args, **kw)
    want = [np.asarray(x) for x in want]
    want[0] = want[0].view(np.int32)
    for scan in ("packed", "codes"):
        got = tmp.merge_pairs(words_from_u32_np(w1), torch.from_numpy(l1), words_from_u32_np(w2),
                              torch.from_numpy(l2), *args, scan=scan, **kw)
        for g, w, name in zip(got, want, NAMES):
            assert g.dtype == (torch.bool if name == "merged" else torch.int32), name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{scan} {name}")
    return want


def _frag_pairs(rng, n, frag=(120, 300), n1=(80, 151), n2=(80, 151), errors=3):
    seqs1, seqs2 = [], []
    for _ in range(n):
        f = random_seq(rng, int(rng.integers(*frag))).upper()
        a, b = int(rng.integers(*n1)), int(rng.integers(*n2))
        r2 = bytearray(f[-b:])
        for _ in range(int(rng.integers(0, errors + 1))):
            r2[int(rng.integers(0, len(r2)))] = int(rng.choice(np.frombuffer(b"ACGT", np.uint8)))
        seqs1.append(f[:a])
        seqs2.append(rc(bytes(r2)))
    return seqs1, seqs2


@pytest.mark.parametrize("min_overlap,frac", [(10, 0.1), (20, 0.0), (5, 0.25), (30, 0.05),
                                              (1, 0.5)])
def test_fuzz_matches_jax(rng, min_overlap, frac):
    seqs1, seqs2 = _frag_pairs(rng, 24)
    seqs1.append(random_seq(rng, 100).upper())  # unrelated
    seqs2.append(random_seq(rng, 100).upper())
    out = _check(seqs1, seqs2, min_overlap, frac)
    assert out[2].any()


@pytest.mark.parametrize("frac", [0.1, 0.0333, 0.3])
def test_float32_budget_matches_jax(rng, frac):
    """floor(float32(frac) * float32(overlap)) at fractions that round."""
    _check(*_frag_pairs(rng, 32, errors=6), 10, frac)


def test_ragged_lengths(rng):
    frag = random_seq(rng, 180).upper()
    out = _check([frag[:120], random_seq(rng, 150).upper()],
                 [rc(frag[-90:]), random_seq(rng, 150).upper()])
    assert out[2][0] and out[1][0] == 180 and out[3][0] == 30


@pytest.mark.parametrize("off", list(range(0, 120, 7)))
def test_r2_much_shorter_every_offset(rng, off):
    """W1 = 10, W2 = 4: the shift stack needs its right pad at small
    offsets (the round-5 case)."""
    r1 = random_seq(rng, 150).upper()
    out = _check([r1], [rc(r1[off : off + 60])])
    assert out[2][0]


def test_containment_keeps_r1(rng):
    r1 = random_seq(rng, 150).upper()
    filler = random_seq(rng, 150).upper()
    out = _check([r1, filler], [rc(r1[20:100]), rc(filler)])
    assert out[2][0] and out[1][0] == 150 and out[3][0] == 80 and out[4][0] == 0


def test_none_merged_carries_r1(rng):
    seqs1 = [random_seq(rng, int(n)).upper() for n in rng.integers(30, 150, 9)]
    seqs2 = [random_seq(rng, int(n)).upper() for n in rng.integers(30, 150, 9)]
    out = _check(seqs1, seqs2, 40, 0.0)
    assert not out[2].any() and (out[4] == -1).all()
    assert out[1].tolist() == [len(s) for s in seqs1]


def test_overlap_longer_than_r1_can_give(rng):
    """min_overlap past 16 W1: no offset is searched."""
    out = _check([b"ACGT" * 5], [rc(b"ACGT" * 5)], 40, 0.1)
    assert not out[2].any()


def test_merged_fragment_decodes(rng):
    frag = random_seq(rng, 260).upper()
    w1, l1 = _packed([frag[:150]])
    w2, l2 = _packed([rc(frag[-150:])])
    w, ln, m, ov, mm = tmp.merge_pairs(words_from_u32_np(w1), torch.from_numpy(l1),
                                       words_from_u32_np(w2), torch.from_numpy(l2))
    assert m[0] and ln[0] == 260 and ov[0] == 40 and mm[0] == 0
    assert PackedReads(w, ln).to_ascii()[0] == frag
    want = jcodec.decode_reads(jnp.asarray(w.numpy().view(np.uint32)), jnp.asarray(ln.numpy()))
    assert bytes(np.asarray(want)[0, :260]) == frag


def test_scan_name_checked():
    w = torch.zeros((1, 2), dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmp.merge_pairs(w, n, w, n, scan="bits")
