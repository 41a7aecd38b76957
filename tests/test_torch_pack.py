"""A numpy model of K1's arithmetic (``bitnuc_tpu_torch/csrc/pack.cu``)
against the port's plain version, on the CPU: the four-byte validity test
and code fold of ``bad_bytes`` and ``code_word`` for every byte value at
each byte position, and the whole kernel (staging at the stream's 16-byte
offset, tiles of whole rows or segments of a long row, the funnel-shifted
reads, first_bad finished per row) against ``encode_reads_torch``. The
kernel itself runs only on the card (``tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from bitnuc_tpu_torch.ops import codec
from bitnuc_tpu_torch.utils import bitops

torch.set_num_threads(1)

# pack.cu's constants
THREADS, SHORT_ROW_MAX, STAGE_BYTES, MAX_TILE_ROWS, MAX_TILE_WORDS = 256, 4096, 8192, 512, 4096
SEG_WORDS = THREADS
M32 = np.uint64(0xFFFFFFFF)


def _u64(x):
    return np.asarray(x, dtype=np.uint64)


def byte_perm(x, s):
    """__byte_perm(x, 0, s) for selector nibbles 0..3."""
    x, s = _u64(x), _u64(s)
    out = np.zeros(np.broadcast(x, s).shape, np.uint64)
    for n in range(4):
        sel = (s >> _u64(4 * n)) & _u64(7)
        out |= ((x >> (_u64(8) * sel)) & _u64(0xFF)) << _u64(8 * n)
    return out


def codes(v):
    v = _u64(v)
    return ((v >> _u64(1)) ^ (v >> _u64(2))) & _u64(0x03030303)


def bad_bytes(v, c):
    """pack.cu's bad_bytes: bit 28 + k set where byte k of v is not in
    ACGTacgt, bits below undefined."""
    v, c = _u64(v), _u64(c)
    sel = byte_perm(c | (c >> _u64(4)), 0x0020)
    d = (v | _u64(0x20202020)) ^ byte_perm(0x74676361, sel)
    hi = ((((d & _u64(0x7F7F7F7F)) + _u64(0x7F7F7F7F)) | d) & _u64(0x80808080))
    return (hi * _u64(0x00204081)) & M32


def fold(c):
    """The four codes of a lane as one byte of the word (bits 24..31 of
    the kernel's product)."""
    return ((_u64(c) * _u64(0x01041040)) & M32) >> _u64(24)


@pytest.mark.parametrize("pos", range(4))
def test_lane_validity_and_fold(pos):
    rng = np.random.default_rng(pos)
    lanes = rng.integers(0, 256, (256 * 64, 4), dtype=np.uint8)  # the other bytes: any value
    lanes[:, pos] = np.repeat(np.arange(256, dtype=np.uint8), 64)
    v = lanes.view("<u4").reshape(-1).astype(np.uint64)
    c = codes(v)
    bad, packed = bad_bytes(v, c) >> _u64(28), fold(c)
    t = torch.from_numpy(lanes)
    want_bad = (~bitops.ascii_is_valid(t)).numpy()
    want_codes = bitops.ascii_to_code(t).numpy()
    for k in range(4):
        np.testing.assert_array_equal(((bad >> _u64(k)) & _u64(1)).astype(bool), want_bad[:, k])
        np.testing.assert_array_equal((packed >> _u64(2 * k)) & _u64(3), want_codes[:, k])
    assert not (bad >> _u64(4)).any()


def code_words(stage32, off, n):
    """code_word at byte offsets ``off`` with n (1..16) bases in length:
    (words, index of the first invalid base or -1)."""
    off, n = _u64(off), np.asarray(n)
    p = (off >> _u64(2)).astype(np.int64)
    shift = _u64(8) * (off & _u64(3))
    x = [stage32[p + j].astype(np.uint64) for j in range(5)]
    word, bits = np.zeros_like(off), np.zeros_like(off)
    for i in range(4):
        v = (((x[i + 1] << _u64(32)) | x[i]) >> shift) & M32
        c = codes(v)
        word |= fold(c) << _u64(8 * i)
        bits |= (bad_bytes(v, c) >> _u64(28 - 4 * i)) & _u64(0xF << (4 * i))
    bits &= _u64(0xFFFF) >> (_u64(16) - n.astype(np.uint64))
    low = bits & (~bits + _u64(1))  # the lowest set bit, as __ffs finds it
    first = np.where(bits > 0, np.log2(np.maximum(low, _u64(1))), -1)
    mask = np.where(n >= 16, M32, (_u64(1) << (_u64(2) * n.astype(np.uint64))) - _u64(1))
    return word & mask, first.astype(np.int64)


def stage(stream, start, n, rng, size):
    """The stage after stage_bytes: stream[start, start + n) at byte offset
    start mod 16 (the stream's own alignment), garbage elsewhere."""
    head = start % 16
    buf = rng.integers(0, 256, size, dtype=np.uint8)
    buf[head : head + n] = stream[start : start + n]
    return buf.view("<u4"), head


def model_encode(ascii, lens, W, base, seed=0):
    """K1 as pack.cu computes it, on a stream starting ``base`` bytes past
    a 16-byte boundary: (words [B, W] uint32, first_bad [B] int32)."""
    rng = np.random.default_rng(seed)
    B, L = ascii.shape
    stream = np.concatenate([np.zeros(base, np.uint8), ascii.reshape(-1)])
    words = np.zeros((B, W), np.uint64)
    first = np.full(B, -1, np.int64)
    clamped = np.clip(lens.astype(np.int64), 0, L)
    if L <= SHORT_ROW_MAX:
        rows = min(STAGE_BYTES // max(L, 1), MAX_TILE_ROWS)
        if W > 0 and rows * W > MAX_TILE_WORDS:
            rows = 1 if W >= MAX_TILE_WORDS else MAX_TILE_WORDS // W
        if rows * W > THREADS and 2 * W <= THREADS:  # whole rounds of a word a thread
            rows = rows * W // THREADS * THREADS // W
        for r0 in range(0, B, rows):
            nr = min(rows, B - r0)
            s32, head = stage(stream, base + r0 * L, nr * L, rng, STAGE_BYTES + 48)
            r, w = np.divmod(np.arange(nr * W), W) if W else (np.zeros(0, int),) * 2
            n = np.clip(clamped[r0 + r] - 16 * w, 0, 16)
            live = n > 0
            got, bad = code_words(s32, head + r[live] * L + 16 * w[live], n[live])
            words[r0 + r[live], w[live]] = got
            for row, off in zip(r0 + r[live][bad >= 0], 16 * w[live][bad >= 0] + bad[bad >= 0]):
                first[row] = off if first[row] < 0 else min(first[row], off)
    else:
        for row in range(B):
            for w0 in range(0, W, SEG_WORDS):
                nbytes = int(np.clip(clamped[row] - 16 * w0, 0, 16 * SEG_WORDS))
                s32, head = stage(stream, base + row * L + 16 * w0, nbytes, rng,
                                  16 * SEG_WORDS + 48)
                w = np.arange(SEG_WORDS)
                n = np.clip(nbytes - 16 * w, 0, 16)
                live = n > 0
                got, bad = code_words(s32, head + 16 * w[live], n[live])
                words[row, w0 + w[live]] = got
                if (bad >= 0).any():  # the unsigned atomicMin on all ones
                    off = 16 * w0 + int((16 * w[live] + np.where(bad >= 0, bad, 1 << 40)).min())
                    first[row] = off if first[row] < 0 else min(first[row], off)
    return words.astype(np.uint32), first.astype(np.int32)


def _rows(seed, B, L, lens=None):
    rng = np.random.default_rng(seed)
    a = rng.choice(np.frombuffer(b"ACGTacgtNn-\x00\xc1", np.uint8), size=(B, L),
                   p=[0.12] * 8 + [0.02, 0.005, 0.005, 0.005, 0.005])
    if lens is None:
        lens = rng.integers(-2, L + 8, B)
    return a, np.asarray(lens, np.int32)


@pytest.mark.parametrize("B,L,extra_words,base,lens", [
    (300, 150, 0, 0, None),
    (300, 150, 0, 3, None),       # a base pointer off 16-byte alignment
    (40, 16, 0, 15, None),
    (1200, 15, 0, 1, None),       # more rows than a tile holds (512)
    (9, 33, 2, 7, None),          # n_words above ceil(L / 16)
    (5, 20, 4096, 2, None),       # a row with more words than a tile
    (4, 1, 0, 5, [-2, 0, 1, 8]),
    (6, 0, 0, 0, [-2, 0, 0, 1, 5, 0]),
    (5, 4000, 0, 4, None),        # tiles of two rows of more than 128 words
    (3, 4096, 0, 9, [4096, 4103, 4000]),  # the widest row a tile takes
    (3, 4097, 0, 6, [4097, 4104, 2000]),  # the narrowest a segment takes
    (2, 9000, 4, 11, [9000, 4097]),
])
def test_model_matches_plain(B, L, extra_words, base, lens):
    a, ln = _rows(B + L + base, B, L, lens)
    W = bitops.n_words_for(L) + extra_words
    want_w, want_fb = codec.encode_reads_torch(torch.from_numpy(a), torch.from_numpy(ln), W)
    got_w, got_fb = model_encode(a, ln, W, base)
    np.testing.assert_array_equal(got_w, bitops.words_to_u32_np(want_w))
    np.testing.assert_array_equal(got_fb, want_fb.numpy())
