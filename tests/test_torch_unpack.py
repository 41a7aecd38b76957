"""A numpy model of K2's addressing and arithmetic
(``bitnuc_tpu_torch/csrc/unpack.cu``) against the port's plain version and
the JAX package, on the CPU: the host's choice of rows a tile, each tile's
or segment's staged words at their own 16-byte offset, each thread's
aligned 16-byte chunk of the output stream with the pieces of the rows it
touches, the selectors that give letters and zeros in one permute, the
bytes before a block's first aligned chunk and after its last, and
segments of long rows. Garbage fills every staged byte the kernel does not
copy, so a read of a wrong word shows. The kernel itself runs only on the
card (``tests/test_torch_kernels.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitnuc_tpu.ops import codec as jcodec
from bitnuc_tpu.ops.pallas import unpack as jpallas_unpack
from bitnuc_tpu_torch.ops import codec

torch.set_num_threads(1)

# unpack.cu's constants
TILE_BYTES, MAX_TILE_ROWS, MAX_TILE_WORDS = 32768, 4096, 4096
SHORT_ROW_MAX, SEG_BYTES = 4096, 4096
ACGT = 0x54474341
M32 = np.uint64(0xFFFFFFFF)
U = np.uint64


def plan(B, W, L):
    """bn_unpack's launch: ("rows", rows, sw, inv, cap) or ("segments", segs,
    cap)."""
    cap = min(16 * W, L)
    if L <= SHORT_ROW_MAX:
        sw = min(W, -(-L // 16))
        rows = min(TILE_BYTES // L, MAX_TILE_ROWS)
        if sw > 0 and rows * sw > MAX_TILE_WORDS:
            rows = MAX_TILE_WORDS // sw
        step = 16 // math.gcd(L, 16)
        if rows >= step:
            rows -= rows % step
        inv = (0xFFFFFFFF // L + 1) if rows > 1 and L > 1 else 0
        return "rows", rows, sw, inv, cap
    return "segments", -(-L // SEG_BYTES), cap


def base_mask(v):
    v = np.asarray(v, np.int64)
    m = (U(1) << (U(2) * np.clip(v, 0, 16).astype(U))) - U(1)
    return np.where(v <= 0, U(0), np.where(v >= 16, M32, m & M32))


def prmt(a, sel):
    """prmt.b32 a, 0, sel: byte k from nibble k of sel (0..3 a byte of a,
    4..7 zero); the kernel never sets a nibble's bit 3."""
    a, sel = U(a), np.asarray(sel, U)
    out = np.zeros(sel.shape, U)
    for k in range(4):
        nib = (sel >> U(4 * k)) & U(0xF)
        assert not (nib & U(8)).any(), "sign-replicating selector"
        byte = np.where(nib < U(4), (a >> (U(8) * (nib & U(3)))) & U(0xFF), U(0))
        out |= byte << U(8 * k)
    return out


def spread_codes(x):
    x = np.asarray(x, U)
    x = prmt_bytes(x)
    x = (x | (x << U(4))) & U(0x0F0F0F0F)
    return (x | (x << U(2))) & U(0x33333333)


def prmt_bytes(x):
    """prmt(x, 0x4140): bytes 0 and 1 of x to bytes 0 and 2."""
    return (x & U(0xFF)) | (((x >> U(8)) & U(0xFF)) << U(16))


def funnelshift_r(lo, hi, sh):
    return (((U(hi) << U(32)) | U(lo)) >> (np.asarray(sh, U) & U(31))) & M32


def row_of(s, L, inv):
    s = np.asarray(s, U)
    return s.astype(np.int64) if L == 1 else ((s * U(inv)) >> U(32)).astype(np.int64)


def decode_tile(stage, h, lim, nr, sw, L, inv, dst_addr, out, out0, written):
    """decode_tile: writes out[out0, out0 + nr * L) from stage[h:] as the
    kernel's threads do; dst_addr is the tile's output address mod 16."""
    st = lambda i: stage[h + np.asarray(i, np.int64)]  # noqa: E731 (a shared load)
    n = nr * L
    lead = (16 - dst_addr % 16) % 16
    chunks = (n - lead) >> 4 if n > lead else 0
    if chunks:
        s0 = lead + 16 * np.arange(chunks, dtype=np.int64)
        assert ((dst_addr + s0) % 16 == 0).all()
        r = row_of(s0, L, inv)
        p = s0 - r * L
        codes = np.zeros(chunks, U)
        valid = np.zeros(chunks, U)
        j = np.zeros(chunks, np.int64)
        live = np.ones(chunks, bool)
        while live.any():  # the do-while over pieces, all chunks at once
            rl = np.where(live, r, 0)
            e = np.minimum(16 - j, L - p)
            v = np.clip(lim[rl] - p, 0, e)
            take = live & (v > 0)
            w = rl * sw + (p >> 4)
            lo = np.where(take, st(np.where(take, w, 0)), U(0))
            hi = np.where(take, st(np.where(take, w + 1, 0)), U(0))
            m = np.where(take, base_mask(v), U(0))
            codes |= ((funnelshift_r(lo, hi, 2 * p) & m) << (U(2) * j.astype(U))) & M32
            valid |= (m << (U(2) * j.astype(U))) & M32
            j = np.where(live, j + e, j)
            r, p = np.where(live, r + 1, r), np.where(live, 0, p)
            live &= j < 16
        inv_valid = ~valid & M32
        lo = spread_codes(codes) | (spread_codes(inv_valid) << U(1))
        hi = spread_codes(codes >> U(16)) | (spread_codes(inv_valid >> U(16)) << U(1))
        lanes = [prmt(ACGT, lo), prmt(ACGT, lo >> U(16)), prmt(ACGT, hi), prmt(ACGT, hi >> U(16))]
        chunk = np.stack(lanes, 1).astype("<u4").view(np.uint8).reshape(chunks, 16)
        idx = out0 + s0[:, None] + np.arange(16)
        out[idx] = chunk
        written[idx] += 1
    tail = lead + 16 * chunks
    singles = list(range(n)) if not chunks else list(range(lead)) + list(range(tail, n))
    assert len(singles) <= 32 and (not chunks or (lead < 16 and n - tail < 16))
    for s in singles:  # one a thread
        r = int(row_of(s, L, inv))
        p = s - r * L
        letter = 0
        if p < lim[r]:
            code = (int(st(r * sw + (p >> 4))) >> (2 * (p & 15))) & 3
            letter = (ACGT >> (8 * code)) & 0xFF
        out[out0 + s] = letter
        written[out0 + s] += 1


def stage_words(src, n, h, rng, size):
    """The stage after stage_words: src[0, n) at word offset h (the source
    address's word mod 4), garbage elsewhere."""
    stage = rng.integers(0, 2**32, size, dtype=np.uint64)
    stage[h : h + n] = src[:n]
    return stage


def model_decode(words, lens, max_len, word_off=0, seed=0):
    """K2 as unpack.cu computes it, on words whose first lies ``word_off``
    words past a 16-byte boundary, into a 16-byte-aligned output."""
    rng = np.random.default_rng(seed)
    B, W = words.shape
    L = max_len
    out = rng.integers(0, 256, B * L, dtype=np.uint8)  # torch.empty
    written = np.zeros(B * L, np.int64)
    flat = words.astype(np.uint64).reshape(-1)
    lens = lens.astype(np.int64)
    if B == 0 or L == 0:
        return out.reshape(B, L), written
    p = plan(B, W, L)
    if p[0] == "rows":
        _, rows, sw, inv, cap = p
        for r0 in range(0, B, rows):
            nr = min(rows, B - r0)
            lim = np.clip(lens[r0 : r0 + nr], 0, cap)
            src_word = word_off + r0 * W
            if sw == W:
                h = src_word % 4
                stage = stage_words(flat[r0 * W :], nr * sw, h, rng, MAX_TILE_WORDS + 8)
            else:
                h = 0
                rows_src = flat[r0 * W : (r0 + nr) * W].reshape(nr, W)[:, :sw].reshape(-1)
                stage = stage_words(rows_src, nr * sw, 0, rng, MAX_TILE_WORDS + 8)
            assert nr * sw <= MAX_TILE_WORDS and nr <= MAX_TILE_ROWS
            decode_tile(stage, h, lim, nr, sw, L, inv, r0 * L, out, r0 * L, written)
    else:
        _, segs, cap = p
        for row in range(B):
            for seg in range(segs):
                q0 = seg * SEG_BYTES
                ln = min(L - q0, SEG_BYTES)
                v = int(np.clip(np.clip(lens[row], 0, cap) - q0, 0, ln))
                nw = -(-v // 16)
                h = (word_off + row * W + q0 // 16) % 4
                src = flat[row * W + q0 // 16 : row * W + q0 // 16 + nw]
                stage = stage_words(src, nw, h, rng, SEG_BYTES // 16 + 8)
                decode_tile(stage, h, np.array([v]), 1, 0, ln, 0, row * L + q0, out,
                            row * L + q0, written)
    return out.reshape(B, L), written


def _case(seed, B, W, L, word_off=0):
    """B rows of W random words; lengths -2, 0, L, L + 7, 16 W and 16 W + 3
    first, the rest in [-2, max(L, 16 W) + 8)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (word_off + B) * W, dtype=np.uint64).astype(np.uint32)
    words = words[word_off * W :].reshape(B, W)
    lens = rng.integers(-2, max(L, 16 * W) + 8, B)
    edge = np.array([-2, 0, L, L + 7, 16 * W, 16 * W + 3])[:B]
    lens[: len(edge)] = edge
    return words, lens.astype(np.int32)


def _check(words, lens, L, word_off=0, pallas=True):
    got, written = model_decode(words, lens, L, word_off, seed=L)
    assert (written == 1).all(), "every output byte is stored exactly once"
    tw = torch.from_numpy(words.view(np.int32).copy())
    want = codec.decode_reads_torch(tw, torch.from_numpy(lens), L).numpy()
    np.testing.assert_array_equal(got, want)
    xla = jcodec.decode_reads_xla(jnp.asarray(words), jnp.asarray(lens), max_len=L)
    np.testing.assert_array_equal(got, np.asarray(xla))
    if pallas:  # the Pallas kernel writes 'A' past 16 W: lengths held to it
        cap = np.minimum(lens, 16 * words.shape[1])
        got_cap, _ = model_decode(words, cap, L, word_off, seed=L + 1)
        pl = jpallas_unpack.decode_reads_pallas(jnp.asarray(words), jnp.asarray(cap), L,
                                                interpret=True)
        np.testing.assert_array_equal(got_cap, np.asarray(pl))


WIDTHS = list(range(1, 34)) + [150, 151, 300, 1000, 4000, 4096, 4097, 16_384]


@pytest.mark.parametrize("L", WIDTHS)
def test_model_every_width(L):
    """Every residue of max_len mod 16 and the timed widths, at n_words =
    ceil(L / 16), with a tile and a bit more of rows, from a base off
    16-byte alignment."""
    W = -(-L // 16)
    kind, rows = plan(1, W, L)[:2]
    B = rows + 3 if kind == "rows" else 7
    words, lens = _case(L, B, W, L, word_off=3)
    _check(words, lens, L, word_off=3, pallas=L <= 4096)


@pytest.mark.parametrize("B,W,L", [
    (0, 10, 150),     # no rows
    (5, 4, 0),        # no bytes
    (1, 10, 150),     # one row
    (215, 10, 150),   # below a tile's rows (216)
    (216, 10, 150),   # at it
    (217, 10, 150),   # above it
    (435, 10, 150),   # a bit more than two tiles
    (3, 2, 48),       # max_len past 16 W
    (4, 3, 48),       # max_len at 16 W
    (6, 10, 20),      # max_len below 16 W: two staged words of ten a row
    (9, 1000, 16),    # one staged word of 1,000 a row
    (5, 0, 33),       # no words at all
    (300, 2, 32),     # the large-k decode: 2-word rows, max_len 32
    (3, 256, 4096),   # the widest row a tile takes
    (3, 257, 4097),   # the narrowest a segment takes
    (2, 100, 5000),   # segments past the words' capacity
])
def test_model_edges(B, W, L):
    words, lens = _case(B + W + L, B, W, L)
    _check(words, lens, L, pallas=0 < B and 0 < L <= 4096 and W > 0)


@pytest.mark.parametrize("word_off", range(4))
@pytest.mark.parametrize("W,L", [(10, 150), (19, 300), (3, 40), (2, 32)])
def test_model_unaligned_words(W, L, word_off):
    """Words that start a few rows into a batch: each tile's stage starts at
    its own word offset from 16 bytes."""
    words, lens = _case(W + word_off, 60, W, L, word_off)
    _check(words, lens, L, word_off, pallas=False)


@pytest.mark.parametrize("L", [150, 151, 300, 1000, 4000, 33, 1])
def test_tiles_start_aligned(L):
    """Rows a tile make whole 16-byte chunks where they fit, so every tile
    of a 16-byte-aligned output starts and ends on a chunk: only the last
    tile stores single bytes."""
    _, rows, sw, _, _ = plan(1000, -(-L // 16), L)
    step = 16 // math.gcd(L, 16)
    assert rows * L <= TILE_BYTES and rows * sw <= MAX_TILE_WORDS
    if rows >= step:
        assert rows * L % 16 == 0
    assert plan(1, 10, 150)[1] == 216  # the main row's tile: 32,400 bytes
