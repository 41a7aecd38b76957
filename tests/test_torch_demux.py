"""bitnuc_tpu_torch.ops.demux against bitnuc_tpu.ops.demux on the same
numpy-seeded reads and barcodes, index and distance exactly: ties between
barcodes, reads shorter than the barcode, max_dist 0, 1 and 2 (and as a
tensor), barcodes of 8, 12, 16, 20 and 32 bases, barcode words wider
than the barcode needs, and lower-case reads."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bitnuc_tpu.ops import demux as jdemux
from bitnuc_tpu.sequence import PackedReads as JPackedReads
from bitnuc_tpu_torch.ops import demux
from bitnuc_tpu_torch.sequence import PackedReads
from bitnuc_tpu_torch.utils.bitops import words_from_u32_np
from conftest import random_seq

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mutate(rng, s: bytes, n: int) -> bytes:
    s = bytearray(s)
    for q in rng.choice(len(s), n, replace=False):
        s[q] = b"ACGT"[(b"ACGT".index(bytes(s[q : q + 1]).upper()) + int(rng.integers(1, 4))) % 4]
    return bytes(s)


def _check(reads, bcs, bc_len, max_dist, bc_pad_words=0):
    pr = JPackedReads.from_ascii(reads)
    pb = JPackedReads.from_ascii(bcs)
    bw = np.asarray(pb.words)
    if bc_pad_words:
        extra = np.random.default_rng(1).integers(0, 2**32, (bw.shape[0], bc_pad_words),
                                                  dtype=np.uint64).astype(np.uint32)
        bw = np.concatenate([bw, extra], 1)
    want = jdemux.assign_barcodes(pr.words, pr.lengths, jnp.asarray(bw), bc_len,
                                  jnp.int32(max_dist))
    tr = PackedReads.from_ascii(reads, device=CPU)
    md = torch.tensor(max_dist, dtype=torch.int32) if max_dist == 2 else max_dist
    got = demux.assign_barcodes(tr.words, tr.lengths, words_from_u32_np(bw), bc_len, md)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("bc_len", [8, 12, 16, 20, 32])
@pytest.mark.parametrize("max_dist", [0, 1, 2])
def test_assign_barcodes_matches_jax(bc_len, max_dist):
    rng = np.random.default_rng(bc_len * 3 + max_dist)
    bcs = [random_seq(rng, bc_len).upper() for _ in range(12)]
    bcs.append(_mutate(rng, bcs[0], 2))  # a near pair: ties at one edit from both
    reads = []
    for i in range(150):
        b = bcs[int(rng.integers(0, len(bcs)))]
        head = _mutate(rng, b, int(rng.integers(0, 4)))
        tail = random_seq(rng, int(rng.integers(0, 60)))
        reads.append(head + tail if i % 11 else head[: int(rng.integers(0, bc_len))])
    idx, dist = _check(reads, bcs, bc_len, max_dist)
    assert (idx >= 0).any() and (idx < 0).any()


def test_assign_barcodes_ties_and_short_reads():
    bcs = [b"AAAAAAAA", b"AAAAAACC", b"GGGGTTTT"]
    reads = [b"AAAAAAAC" + b"ACGT" * 5, b"AAAAAAAA", b"AAAAAAA", b"", b"ggggtttt" + b"A"]
    for max_dist in (0, 1, 2):
        idx, dist = _check(reads, bcs, 8, max_dist)
        assert idx[0] == -1 and dist[0] == 1
        assert idx[2] == idx[3] == -1 and dist[2] == dist[3] == 8


@pytest.mark.parametrize("pad", [1, 2, 3])
def test_assign_barcodes_with_wider_barcode_words(pad):
    rng = np.random.default_rng(pad)
    bcs = [random_seq(rng, 10).upper() for _ in range(8)]
    reads = [_mutate(rng, bcs[i % 8], i % 3) + random_seq(rng, 30) for i in range(40)]
    _check(reads, bcs, 10, 1, bc_pad_words=pad)
