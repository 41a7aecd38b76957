"""The hand-written CUDA kernels against their plain PyTorch versions, bit
for bit, on the card. Every test here carries the ``cuda`` marker and skips
where no CUDA device is present. The file imports neither jax nor the
conftest's helpers, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

chip_smoke.py runs the same comparisons at the main path's full sizes."""

import numpy as np
import pytest
import torch

from bitnuc_tpu_torch import config, entry, kernels
from bitnuc_tpu_torch.kernels import _build
from bitnuc_tpu_torch.ops import align, chain, codec, hamming, kmer, merge, orf
from bitnuc_tpu_torch.utils import bitops

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the hand-written kernels")
    return torch.device("cuda")


def _reads_on(device, B, L, seed):
    g = torch.Generator().manual_seed(seed)
    alphabet = torch.tensor(list(b"ACGTacgtN"), dtype=torch.uint8)
    a = alphabet[torch.randint(0, 9, (B, L), generator=g)]
    lens = torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)
    return a.to(device), lens.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 1), (5, 33), (3, 1000), (300, 150)])
def test_pack_kernel_matches_plain(cuda, B, L):
    a, lens = _reads_on(cuda, B, L, 1)
    for got, want in zip(codec.encode_reads_kernel(a, lens), codec.encode_reads_torch(a, lens)):
        assert torch.equal(got, want)


def _pack_equal(a, lens, n_words=None):
    got = codec.encode_reads_kernel(a, lens, n_words)
    for g, w in zip(got, codec.encode_reads_torch(a, lens, n_words)):
        assert torch.equal(g, w)


def _edge_rows(device, B, L, seed):
    """B reads of L bytes with lengths -2, 0, L and L + 7 first."""
    a, lens = _reads_on(device, B, L, seed)
    lens[: min(B, 4)] = torch.tensor([-2, 0, L, L + 7], dtype=torch.int32)[:B]
    return a, lens


@pytest.mark.cuda
@pytest.mark.parametrize("L", list(range(1, 34)) + [150])
def test_pack_kernel_every_width(cuda, L):
    a, lens = _edge_rows(cuda, 77, L, L)
    _pack_equal(a, lens)
    _pack_equal(a, lens, bitops.n_words_for(L) + 4)  # n_words above ceil(L / 16)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [33, 150, 4097])
def test_pack_kernel_unaligned_base(cuda, L):
    a, lens = _edge_rows(cuda, 40, L, 3)
    _pack_equal(a[3:], lens[3:])
    flat = a.reshape(-1)
    for off in range(1, 16):  # a base pointer at every offset from 16 bytes
        _pack_equal(flat[off : off + 30 * L].view(30, L), lens[:30])


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1025, 8), (1, 16), (513, 16), (51, 150), (52, 150),
                                 (154, 150), (4, 4000), (5, 4000), (3, 4096), (40_000, 150)])
def test_pack_kernel_tile_edges(cuda, B, L):
    """B on either side of a tile's rows (512 at L <= 16, 51 at 150, 2 at
    4,000 and 4,096), and more tiles than the persistent blocks (40,000
    x 150 bp)."""
    _pack_equal(*_edge_rows(cuda, B, L, B))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(3, 4096), (3, 4097), (4, 8192), (2, 16_384), (1, 1_000_000)])
def test_pack_kernel_long_rows(cuda, B, L):
    """Rows on both sides of the short/long split (4,096 bytes) and past it."""
    _pack_equal(*_edge_rows(cuda, B, L, B + L))
    a, _ = _reads_on(cuda, B, L, 7)
    _pack_equal(a, torch.full((B,), L, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
def test_pack_kernel_empty(cuda):
    _pack_equal(torch.zeros((5, 0), dtype=torch.uint8, device=cuda),
                torch.tensor([-2, 0, 0, 3, 1], dtype=torch.int32, device=cuda))
    _pack_equal(torch.zeros((3, 0), dtype=torch.uint8, device=cuda),
                torch.zeros(3, dtype=torch.int32, device=cuda), 4)
    _pack_equal(torch.zeros((0, 150), dtype=torch.uint8, device=cuda),
                torch.zeros(0, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 16, 150, 5000])
def test_pack_kernel_bad_byte_placement(cuda, L):
    """A bad byte at offset 0, at the last byte in length, and only past it."""
    a = torch.full((4, L), ord("G"), dtype=torch.uint8, device=cuda)
    lens = torch.full((4,), L, dtype=torch.int32, device=cuda)
    a[0, 0] = ord("N")
    a[1, L - 1] = ord("N")
    if L > 1:
        lens[2] = L - 1
        a[2, L - 1] = ord("N")
    _pack_equal(a, lens)
    first_bad = codec.encode_reads_kernel(a, lens)[1].tolist()
    assert first_bad == [0, L - 1, -1, -1]


@pytest.mark.cuda
@pytest.mark.parametrize("pos", range(16))
def test_pack_kernel_every_byte_value(cuda, pos):
    """Each of the 256 byte values at one position of a word."""
    a = torch.tensor(list(b"ACGTacgtTGCAtgca"), dtype=torch.uint8).repeat(256, 1)
    a[:, pos] = torch.arange(256, dtype=torch.uint8)
    _pack_equal(a.to(cuda), torch.full((256,), 16, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 21, 31, 32])
def test_pack_kmers_kernel(cuda, k):
    a, lens = _reads_on(cuda, 500, k, k)
    for g, w in zip(codec.pack_kmers(a, lens), codec.encode_reads_torch(a, lens, 2)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [300, 65])
def test_pack_is_one_launch(cuda, B, monkeypatch):
    """An encode of short rows launches K1 once and nothing around it."""
    a, lens = _reads_on(cuda, B, 150, B)
    want = codec.encode_reads_torch(a, lens)

    def refused(*args, **kwargs):
        raise AssertionError("encode_reads made a fill or a select around K1")

    monkeypatch.setattr(torch, "full", refused)
    monkeypatch.setattr(torch, "where", refused)
    before = kernels.LAUNCHES["pack"]
    got = codec.encode_reads(a, lens)
    assert kernels.LAUNCHES["pack"] == before + 1
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _hist_words_batch(device, kind, k):
    """(words, lengths) of K3b's cases: ``reads``, 300 encoded reads of up
    to 150 bp; ``edges``, random words (bases past each length not zero)
    with lengths -2, 0, k - 1, 16 W, 16 W + 7 and random, an ACGT repeat, a
    poly-A and a poly-T row; ``poly_a`` and ``poly_t``, 300 x 10 words of one
    base (a warp's windows all one key); ``one``, a single word, fewer
    words than a block's threads; ``strides``, 40,000 x 7 random words
    with lengths -3 to 16 W + 8, more words than the grid's threads."""
    g = torch.Generator().manual_seed(k)
    if kind == "reads":
        a, lens = _reads_on(device, 300, 150, 2)
        return codec.encode_reads_torch(a, lens)[0], lens
    if kind in ("poly_a", "poly_t"):
        words = torch.full((300, 10), 0 if kind == "poly_a" else -1, dtype=torch.int32)
        return words.to(device), torch.full((300,), 160, dtype=torch.int32, device=device)
    if kind == "one":
        words = torch.randint(-(2**31), 2**31 - 1, (1, 1), generator=g, dtype=torch.int32)
        return words.to(device), torch.tensor([16], dtype=torch.int32, device=device)
    if kind == "strides":
        words = torch.randint(-(2**31), 2**31 - 1, (40_000, 7), generator=g, dtype=torch.int32)
        lens = torch.randint(-3, 16 * 7 + 9, (40_000,), generator=g, dtype=torch.int32)
        return words.to(device), lens.to(device)
    W = 3
    words = torch.randint(-(2**31), 2**31 - 1, (14, W), generator=g, dtype=torch.int32)
    words[-3:] = torch.tensor([[0xE4E4E4E4 - 2**32], [0], [-1]], dtype=torch.int32)
    lens = [-2, 0, k - 1, 16 * W, 16 * W + 7]
    lens += torch.randint(0, 16 * W + 1, (6,), generator=g).tolist()
    lens += [16 * W - 3, 16 * W + 7, 16 * W]
    return words.to(device), torch.tensor(lens, dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 8, 9, 12])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("kind", ["reads", "edges", "poly_a", "poly_t", "one", "strides"])
def test_histogram_kernels_match_plain(cuda, k, canonical, kind):
    words, lens = _hist_words_batch(cuda, kind, k)
    assert torch.equal(kmer.histogram_from_words_kernel(words, lens, k, canonical),
                       kmer.histogram_from_words_torch(words, lens, k, canonical))
    if kind == "reads" and canonical:  # K3a on the N-skip keys of the same reads
        a, lens = _reads_on(cuda, 300, 150, 2)
        lo, _, v = kmer._window_keys(words, lens, k, True, codec.validity_mask(a, lens))
        keys = torch.where(v, lo, 4**k).reshape(-1).contiguous()
        assert torch.equal(kmer.histogram_from_keys_kernel(keys, k),
                           kmer.histogram_from_keys_torch(keys, k))


@pytest.mark.cuda
def test_hist_words_refused_launch_raises(cuda):
    """An error of bn_hist_words (here a batch of 2^30 rows, refused before
    any launch) raises and falls back to nothing; the next count is right."""
    words, lens = _hist_words_batch(cuda, "reads", 8)
    hist = torch.zeros(4**8, dtype=torch.int32, device=cuda)
    code = _build.library().bn_hist_words(
        words.data_ptr(), lens.data_ptr(), 2**30, words.shape[1], 8, 0, hist.data_ptr(),
        kernels.stream_handle(cuda))
    with pytest.raises(RuntimeError, match="hist_words: CUDA error"):
        _build.check(code, "hist_words")
    assert not hist.any()
    assert torch.equal(kmer.histogram_from_words_kernel(words, lens, 8),
                       kmer.histogram_from_words_torch(words, lens, 8))


_SLICE_BINS = 1 << 14  # csrc/histogram.cu: kSliceBits, the bins of a slice
_CHUNK_KEYS = 1 << 17  # csrc/histogram.cu: kChunkKeys, the most keys a chunk


def _edge_keys(kind, k, seed):
    rng = np.random.default_rng(seed)
    nb = 4**k
    n = 100_003
    if kind == "uniform":  # the sentinel 4^k among them
        keys = rng.integers(0, nb + 1, n)
    elif kind == "poly_a":
        keys = np.zeros(n)
    elif kind == "sentinel":
        keys = np.full(n, nb)
    elif kind == "out_of_range":  # negative keys and keys above 4^k mixed in
        keys = rng.integers(0, nb, n)
        keys[::3] = rng.integers(-(2**31), 0, len(keys[::3]))
        keys[1::3] = rng.integers(nb + 1, 2**31, len(keys[1::3]))
        keys[:4] = [-1, nb + 1, -(2**31), 2**31 - 1]
    elif kind == "slice_edges":  # only the first and last bin of each slice
        first = np.arange(0, nb, _SLICE_BINS)
        edges = np.concatenate([first, first + min(nb, _SLICE_BINS) - 1])
        keys = rng.choice(edges, n)
    elif kind == "empty":
        keys = np.zeros(0)
    elif kind == "one":
        keys = np.array([nb - 1])
    elif kind == "ragged":  # N not a multiple of the chunk
        keys = rng.integers(0, nb, 5 * _CHUNK_KEYS + 1)
    elif kind == "multi_chunk":  # the last slice holds more than 2 chunks
        last = rng.integers(nb - min(nb, _SLICE_BINS), nb, 2 * _CHUNK_KEYS + 77)
        keys = rng.permutation(np.concatenate([last, rng.integers(0, nb + 1, 5000)]))
    return torch.from_numpy(np.asarray(keys, dtype=np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 8, 9, 10, 12])
@pytest.mark.parametrize("kind", ["uniform", "poly_a", "sentinel", "out_of_range",
                                  "slice_edges", "empty", "one", "ragged", "multi_chunk"])
def test_hist_keys_kernel_edges(cuda, k, kind):
    keys = _edge_keys(kind, k, k).to(cuda)
    assert torch.equal(kmer.histogram_from_keys_kernel(keys, k),
                       kmer.histogram_from_keys_torch(keys, k))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 64, 127])
@pytest.mark.parametrize("nb", [1, 7, 16, 17, 150, 511, 512])
@pytest.mark.parametrize("W", [1, 10, 32, 33])
def test_hdist_scan_kernel_matches_plain(cuda, Q, nb, W):
    """Every query tile, full and partial, and past 32 queries; n_bases on
    both sides of a word's end (clamped to 16 W); odd and even W; D = 1,
    1,000 and 1,001 (a ragged block)."""
    g = torch.Generator().manual_seed(3)
    for D in (1, 1000, 1001):
        db = torch.randint(-(2**31), 2**31 - 1, (W, D), generator=g, dtype=torch.int32)
        q = torch.randint(-(2**31), 2**31 - 1, (Q, W), generator=g, dtype=torch.int32)
        db, q = db.to(cuda), q.to(cuda)
        assert torch.equal(hamming.hdist_scan_kernel(q, db, nb),
                           hamming.hdist_scan_torch(q, db, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,W", [(1, 13000), (2, 30000), (3, 3100), (32, 385), (33, 800),
                                 (32, 1900)])
def test_hdist_scan_kernel_long_queries(cuda, Q, W):
    """Long queries, among them tiles whose merged words overflow shared
    memory and are halved (2 x 30,000 words, 32 x 1,900); n_bases inside the
    last word, at its end, and 0."""
    g = torch.Generator().manual_seed(4)
    db = torch.randint(-(2**31), 2**31 - 1, (W, 300), generator=g, dtype=torch.int32).to(cuda)
    q = torch.randint(-(2**31), 2**31 - 1, (Q, W), generator=g, dtype=torch.int32).to(cuda)
    for nb in (16 * W - 5, 16 * W, 0):
        assert torch.equal(hamming.hdist_scan_kernel(q, db, nb),
                           hamming.hdist_scan_torch(q, db, nb))


@pytest.mark.cuda
def test_flagship_step_on_card_matches_plain(cuda):
    fwd, args = entry.entry(device=cuda, batch=300, read_len=150, db_size=5000)
    kernels.reset_launches()
    got = fwd(*args)
    assert all(kernels.LAUNCHES[name] > 0 for name in ("pack", "hdist_scan")), kernels.LAUNCHES
    # both k = 8 counts, plain and canonical, are one K3b launch each
    assert kernels.LAUNCHES["hist_words"] == 2 and kernels.LAUNCHES["hist_keys"] == 0, \
        kernels.LAUNCHES
    with config.backend("torch"):
        want = fwd(*args)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# (B, W, max_len) of K2's cases (csrc/unpack.cu): every residue of max_len
# mod 16 and the timed widths at W = ceil(max_len / 16); B = 0 and B of 1,
# below, at and above a tile's rows (216 at 150 bytes, 4,096 at 8) and many
# tiles; rows on both sides of the tile/segment split (4,096 bytes) and a
# row of 1,000,000; max_len below, at and past 16 W, and 0; no words
_UNPACK_CASES = (
    [(1, 2, 1), (5, 4, 33), (300, 10, 150), (3, 2, 48), (4, 2, None), (7, 4, 0)]
    + [(77, -(-L // 16), L) for L in range(1, 34) if L not in (1, 33)]
    + [(100, 10, 151), (60, 19, 300), (20, 63, 1000), (5, 250, 4000), (3, 1024, 16_384)]
    + [(0, 10, 150), (1, 10, 150), (215, 10, 150), (216, 10, 150), (217, 10, 150),
       (40_000, 10, 150), (4096, 1, 8), (4097, 1, 8)]
    + [(3, 256, 4096), (3, 257, 4097), (1, 62_500, 1_000_000)]
    + [(6, 10, 20), (9, 1000, 16), (4, 3, 48), (2, 100, 5000), (5, 0, 33)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,max_len", _UNPACK_CASES)
def test_unpack_kernel_matches_plain(cuda, B, W, max_len):
    """K2 equals its plain version with lengths -2, 0, L, L + 7 and 16 W
    first, on the words and on views of them that start off 16-byte
    alignment (rows 3 on, and one to three words into a flat buffer); each
    decode, batched or a 1-D row, is one launch."""
    g = torch.Generator().manual_seed(B + W + (max_len or 0))
    L = 16 * W if max_len is None else max_len
    flat = torch.randint(-(2**31), 2**31 - 1, (B * W + 3,), generator=g, dtype=torch.int32)
    lens = torch.randint(-2, max(L, 16 * W) + 20, (B,), generator=g, dtype=torch.int32)
    lens[:5] = torch.tensor([-2, 0, L, L + 7, 16 * W], dtype=torch.int32)[: min(B, 5)]
    flat, lens = flat.to(cuda), lens.to(cuda)
    views = [(flat[: B * W].view(B, W), lens)]
    views += [(flat[off : off + B * W].view(B, W), lens) for off in (1, 2, 3)]
    if B > 3:
        views.append((views[0][0][3:], lens[3:]))
    for words, ln in views:
        want = codec.decode_reads_torch(words, ln, max_len)
        before = kernels.LAUNCHES["unpack"]
        assert torch.equal(codec.decode_reads(words, ln, max_len), want)
        assert kernels.LAUNCHES["unpack"] == before + 1
    if B:
        words = views[0][0]
        want = codec.decode_reads_torch(words, lens, max_len)
        before = kernels.LAUNCHES["unpack"]
        assert torch.equal(codec.decode_reads(words[0], lens[0], max_len), want[0])
        assert kernels.LAUNCHES["unpack"] == before + 1


@pytest.mark.cuda
def test_unpack_refused_launch_raises(cuda):
    """An error of bn_unpack (here 2^40 rows, more tiles than a grid holds,
    refused before any launch) raises and falls back to nothing; the next
    decode is right."""
    words = torch.randint(-(2**31), 2**31 - 1, (4, 10), dtype=torch.int32).to(cuda)
    lens = torch.full((4,), 150, dtype=torch.int32, device=cuda)
    out = torch.zeros((4, 150), dtype=torch.uint8, device=cuda)
    code = _build.library().bn_unpack(words.data_ptr(), lens.data_ptr(), 2**40, 10, 150,
                                      out.data_ptr(), kernels.stream_handle(cuda))
    with pytest.raises(RuntimeError, match="unpack: CUDA error"):
        _build.check(code, "unpack")
    assert not out.any()
    assert torch.equal(codec.decode_reads_kernel(words, lens, 150),
                       codec.decode_reads_torch(words, lens, 150))


def _sorted_cols(rng, n, n_keys, n_pay, dups):
    """n rows sorted by unsigned key words; ``dups`` draws keys from a few
    values around the sign bit and the all-ones word."""
    pool = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    ks = [rng.choice(pool, n) if dups else
          rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
          for _ in range(n_keys)]
    order = np.lexsort(tuple(reversed(ks)))
    cols = [k[order] for k in ks]
    cols += [rng.integers(-100, 100, n).astype(np.int32) for _ in range(n_pay)]
    return [torch.from_numpy(c.view(np.int32).copy()) for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("n_keys,n_pay", [(1, 0), (2, 1), (3, 2)])
@pytest.mark.parametrize("na,nb", [(0, 5), (7, 0), (300, 200), (5000, 3000)])
def test_merge_kernel_matches_plain(cuda, na, nb, n_keys, n_pay, dups):
    rng = np.random.default_rng(na + 7 * nb + n_keys)
    a = [c.to(cuda) for c in _sorted_cols(rng, na, n_keys, n_pay, dups)]
    b = [c.to(cuda) for c in _sorted_cols(rng, nb, n_keys, n_pay, dups)]
    pad = tuple(range(n_pay)) or None
    got = merge.merge_sorted_kernel(a, b, n_keys, pad)
    want = merge.merge_sorted_torch(a, b, n_keys, pad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


_EDGE_POOL = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _edge_lists(kind, tile, n_keys, n_pay, rng):
    """Two sorted lists for K7's edge cases, sized from the kernel's tile.
    Payload 0 is the row's index in concat(a, b), so a stable merge leaves
    it equal to the order numpy's stable lexsort gives."""
    sizes = {"tile_minus_1": (tile // 3, tile - 1 - tile // 3),
             "tile": (tile // 2 + 5, tile - tile // 2 - 5),
             "tile_plus_1": (tile - 1, 2), "tiles": (3 * tile + 17, 2 * tile - 250),
             "straddle": (tile, tile), "all_equal": (2 * tile + 3, tile + 5),
             "a_empty": (0, tile + 9), "b_empty": (tile + 9, 0), "both_empty": (0, 0),
             "one_then_many": (1, 100_000), "many_then_one": (100_000, 1),
             "sign_bits": (3000, 2000)}
    na, nb = sizes[kind]

    def keys(n):
        if kind == "all_equal":
            return [np.full(n, 0x80000000, np.uint32) for _ in range(n_keys)]
        if kind == "straddle":  # the run of 7s covers output rows tile -+ 128
            runs = [tile // 2 - 64, 128, n - tile // 2 - 64]
            word = np.repeat(np.array([1, 7, 9], np.uint32), runs)
            return [word] + [np.zeros(n, np.uint32) for _ in range(n_keys - 1)]
        return [rng.choice(_EDGE_POOL, n) for _ in range(n_keys)]

    lists = []
    for start, n in ((0, na), (na, nb)):
        ks = keys(n)
        order = np.lexsort(tuple(reversed(ks)))
        cols = [k[order] for k in ks] + [np.arange(start, start + n, dtype=np.uint32)]
        cols += [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                 for _ in range(n_pay - 1)]
        lists.append([torch.from_numpy(c.view(np.int32).copy()) for c in cols])
    return lists


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,n_pay", [(1, 1), (2, 1), (3, 1), (3, 5)])
@pytest.mark.parametrize("kind", ["tile_minus_1", "tile", "tile_plus_1", "tiles", "straddle",
                                  "all_equal", "a_empty", "b_empty", "both_empty",
                                  "one_then_many", "many_then_one", "sign_bits"])
def test_merge_kernel_edges(cuda, kind, n_keys, n_pay):
    a, b = _edge_lists(kind, merge.tile_rows(), n_keys, n_pay, np.random.default_rng(n_keys))
    a, b = [c.to(cuda) for c in a], [c.to(cuda) for c in b]
    pad = tuple(range(n_pay))
    got = merge.merge_sorted_kernel(a, b, n_keys, pad)
    want = merge.merge_sorted_torch(a, b, n_keys, pad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n = a[0].numel() + b[0].numel()
    cat = [torch.cat([x, y]).cpu().numpy().view(np.uint32) for x, y in zip(a, b)]
    order = np.lexsort(tuple(reversed(cat[:n_keys])))
    assert np.array_equal(got[n_keys][:n].cpu().numpy(), order)


def _pairs(seed, B, Wa, Wb):
    """B (read, window) pairs as packed words [B, Wa], [B, Wb] with int32
    lengths: a's prefix planted in b at a random offset with three
    substitutions; lengths random, with 0 and full rows at the start."""
    rng = np.random.default_rng(seed)
    M, N = 16 * Wa, 16 * Wb
    a = rng.integers(0, 4, (B, M))
    b = rng.integers(0, 4, (B, N))
    n = min(M, N)
    for r in range(B):
        off = int(rng.integers(0, N - n + 1))
        b[r, off : off + n] = a[r, :n]
        if N:
            b[r, rng.integers(0, N, 3)] = rng.integers(0, 4, 3)
    la = rng.integers(0, M + 1, B)
    lb = rng.integers(0, N + 1, B)
    la[:3], lb[:3] = [0, M, M], [N, 0, N]
    return (bitops.pack_codes(torch.from_numpy(a)), torch.from_numpy(la.astype(np.int32)),
            bitops.pack_codes(torch.from_numpy(b)), torch.from_numpy(lb.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planted", "short", "ties"])
@pytest.mark.parametrize("costs", [(1, 1), (3, 2)])
@pytest.mark.parametrize("B,Wa,Wb,band", [
    # the mapper's shape and effective band (K = 80): runs 1-32 (base 0),
    # 33-127 (alternating slides, row-0 fixes), 128-354 (no fixes), 355-390
    (300, 10, 15, (-32, 124)),
    (300, 10, 15, (-33, 125)),  # odd off_lo: the runs' parities flip
    (64, 10, 15, (0, 60)),      # off_lo = 0: no diagonal with base 0
    (64, 10, 15, (-8, 52)),     # (-8, 40) widened to K = 32
    (40, 10, 10, (-16, 250)),   # the fixes end inside the top range (N > 2 top - off_lo)
    (30, 1, 4, (-90, 10)),      # base 0 and every fix over the whole read
    (20, 10, 10, (-16, 300)),   # K = N: top = 1, two alternating diagonals
    (40, 4, 8, (0, 0)),         # the narrowest band, K = 2
    (33, 2, 40, (-300, 700)),   # K = 502: 16 cells per lane
    (9, 4, 50, (-500, 700)),    # K = 602: 24
    (9, 4, 70, (-700, 900)),    # K = 802: 32, codes read from shared memory
    (17, 0, 4, (-4, 4)),        # an empty read side
    (9, 6, 2, (-1, 3)),
    (9, 8, 100, (-1100, 1100)),  # K = 1102 > 1024: the wide kernel
    (40, 10, 80, (-1030, 1030)),  # K = 1032
])
def test_fit_banded_kernel_matches_plain(cuda, B, Wa, Wb, band, costs, kind):
    """Every run of the register kernel's diagonal loop and the seams
    between them: reads whose m + n ends inside each run (random lengths,
    0 on either side, and short reads), and tie-heavy rows."""
    wa, la, wb, lb = (x.to(cuda) for x in _sw_pairs(B + Wb, B, Wa, Wb, kind))
    got = align.fit_distance_span_banded_kernel(wa, la, wb, lb, *costs, *band)
    want = align.fit_distance_span_banded_torch(wa, la, wb, lb, *costs, *band)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = kernels.LAUNCHES["fit_banded"]
    align.fit_distance_span_banded(wa, la, wb, lb, *costs, *band)
    assert kernels.LAUNCHES["fit_banded"] == before + 1


def _sw_pairs(seed, B, Wa, Wb, kind):
    """_pairs, or with each side's lengths at most a quarter of its width
    ("short"), or low-entropy rows with many tied scores ("ties": runs of
    one base and period-2 and period-3 repeats on both sides), or a's
    lengths past 16 Wa and b's past 16 Wb ("past")."""
    wa, la, wb, lb = _pairs(seed, B, Wa, Wb)
    rng = np.random.default_rng(seed + 1)
    M, N = 16 * Wa, 16 * Wb
    if kind == "short":
        la = torch.from_numpy(rng.integers(0, M // 4 + 1, B).astype(np.int32))
        lb = torch.from_numpy(rng.integers(0, N // 4 + 1, B).astype(np.int32))
    elif kind == "ties":
        period = rng.integers(1, 4, (B, 1))
        a = np.arange(M)[None, :] % period
        b = (np.arange(N)[None, :] + rng.integers(0, 3, (B, 1))) % period
        wa = bitops.pack_codes(torch.from_numpy(np.ascontiguousarray(a)))
        wb = bitops.pack_codes(torch.from_numpy(np.ascontiguousarray(b)))
    elif kind == "past":
        la = torch.from_numpy(rng.integers(M, M + N + 9, B).astype(np.int32))
        lb = torch.from_numpy(rng.integers(N // 2, N + 9, B).astype(np.int32))
    return wa, la, wb, lb


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planted", "short", "ties", "past"])
@pytest.mark.parametrize("params", [(2, -3, -5, -2), (1, -1, -2, -1)])
@pytest.mark.parametrize("B,Wa,Wb", [
    (300, 10, 14),  # a 150-bp read against a 224-bp window
    (20, 6, 0),     # empty b side
    (20, 0, 6),     # empty a side
    (40, 2, 1),     # N + 1 = 17 lanes: 1 cell per lane
    (30, 3, 2),     # 2 cells per lane
    (30, 5, 9),     # 5
    (30, 8, 11),    # 6
    (30, 4, 20),    # 12
    (20, 9, 30),    # 16
    (12, 6, 40),    # 24
    (7, 2, 62),     # N + 1 = 993 lanes: 32 cells per lane
    (50, 4, 4),
    (6, 3, 80),     # N + 1 = 1281 lanes > 1024: the wide kernel
    (12, 10, 100),  # N + 1 = 1601
])
def test_sw_kernel_matches_plain(cuda, B, Wa, Wb, params, kind):
    """Every cells-per-lane template of the row-pipelined kernel and the
    wide kernel; pairs that end early, tie-heavy rows, and lengths past the
    widths, where only cells with i + j <= 16 (Wa + Wb) count."""
    wa, la, wb, lb = (x.to(cuda) for x in _sw_pairs(B + Wa, B, Wa, Wb, kind))
    got = align.sw_score_kernel(wa, la, wb, lb, *params)
    want = align.sw_score_torch(wa, la, wb, lb, *params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = kernels.LAUNCHES["sw_score"]
    align.sw_score(wa, la, wb, lb, *params)
    assert kernels.LAUNCHES["sw_score"] == before + 1


@pytest.mark.cuda
def test_wide_kernels_stride_over_pairs(cuda, monkeypatch):
    """Fewer warps than pairs: each warp of the wide kernels reuses its ring
    for several pairs."""
    monkeypatch.setattr(align, "_WIDE_WARPS", 3)
    wa, la, wb, lb = (x.to(cuda) for x in _pairs(11, 20, 6, 70))
    for g, w in zip(align.fit_distance_span_banded_kernel(wa, la, wb, lb, 1, 1, -1030, 1030),
                    align.fit_distance_span_banded_torch(wa, la, wb, lb, 1, 1, -1030, 1030)):
        assert torch.equal(g, w)
    for g, w in zip(align.sw_score_kernel(wa, la, wb, lb), align.sw_score_torch(wa, la, wb, lb)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("costs", [(-1, 1), (2**29, 3), (5, -2), (3, 2**29)])
@pytest.mark.parametrize("band,Wb", [((-8, 8), 4), ((-1100, 1100), 100)])  # register, wide
def test_fit_banded_kernel_any_int32_costs(cuda, costs, band, Wb):
    """Negative costs and sums past 2^31 wrap as the plain version's int32
    tensors do, in the register and in the wide kernel."""
    wa, la, wb, lb = (x.to(cuda) for x in _pairs(5 + Wb, 9, 6, Wb))
    got = align.fit_distance_span_banded_kernel(wa, la, wb, lb, *costs, *band)
    want = align.fit_distance_span_banded_torch(wa, la, wb, lb, *costs, *band)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("params", [(2**28, -3, -5, -2), (2, -3, -2**29, -2**29),
                                    (3, 1, 2, 1)])
@pytest.mark.parametrize("kind", ["planted", "past"])
@pytest.mark.parametrize("Wb", [4, 80])  # register, wide (N + 1 = 1281)
def test_sw_kernel_any_int32_scores(cuda, params, kind, Wb):
    """Sums past 2^31 wrap as int32 tensors do; positive mismatch and gap
    scores make cells past either length (or past i + j = 16 (Wa + Wb))
    outscore those in range, so only the range rule keeps them out."""
    wa, la, wb, lb = (x.to(cuda) for x in _sw_pairs(6 + Wb, 9, 3, Wb, kind))
    got = align.sw_score_kernel(wa, la, wb, lb, *params)
    want = align.sw_score_torch(wa, la, wb, lb, *params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tb_codes(seed, B, M, N, kind):
    """B (read, window) code pairs [B, M], [B, N] int32, garbage (codes 0-7)
    past each length: "planted" (a in b with a few edits), "drift" (6-40
    bases deleted from or inserted into a's middle: indel drift past a
    narrow band), "ties" (runs of one base and period-2 and period-3
    repeats on both sides). Lengths random, with m = 0, n = 0 and both 0 in
    the first rows, and full rows."""
    rng = np.random.default_rng(seed)
    ca = rng.integers(0, 8, (B, M))
    cb = rng.integers(0, 8, (B, N))
    la = rng.integers(0, M + 1, B)
    lb = rng.integers(0, N + 1, B)
    la[:5], lb[:5] = [0, M, 0, M, M // 2], [N, 0, 0, N, N]
    la, lb = np.minimum(la, M), np.minimum(lb, N)
    for r in range(B):
        m, n = int(la[r]), int(lb[r])
        if kind == "ties":
            p = int(rng.integers(1, 4))
            ca[r, :m] = np.arange(m) % p
            cb[r, :n] = (np.arange(n) + rng.integers(0, 3)) % p
            continue
        a = list(rng.integers(0, 4, m))
        ca[r, :m] = a
        if kind == "drift" and m > 60:
            k = int(rng.integers(6, 41))
            mid = m // 2
            a = a[: mid - k] + a[mid:] if r % 2 else a[:mid] + list(rng.integers(0, 4, k)) + a[mid:]
        else:
            for _ in range(int(rng.integers(0, 5))):
                q = int(rng.integers(0, max(len(a), 1)))
                op = int(rng.integers(0, 3))
                if op == 0 and a:
                    a[q] = int(rng.integers(0, 4))
                elif op == 1 and a:
                    del a[q]
                else:
                    a.insert(q, int(rng.integers(0, 4)))
        body = rng.integers(0, 4, N)
        lead = int(rng.integers(0, max(1, N - len(a)) + 1))
        body[lead : lead + len(a)] = a[: max(0, N - lead)]
        cb[r, :n] = body[:n]
    return tuple(torch.from_numpy(x.astype(np.int32)) for x in (ca, la, cb, lb))


def _tb_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w.to(g.device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planted", "ties"])
@pytest.mark.parametrize("efb", [False, True])
@pytest.mark.parametrize("B,M,N", [
    (40, 13, 16),     # K = N + 1 = 17, odd M: the warp form at C = 1
    (40, 50, 31),     # 32: C = 1, every lane's column
    (40, 33, 32),     # 33: C = 2
    (40, 50, 63),     # 64: C = 2, full
    (40, 50, 95),     # 96: C = 3
    (40, 60, 127),    # 128: C = 4
    (40, 50, 159),    # 160: C = 5
    (40, 50, 191),    # 192: C = 6
    (300, 160, 224),  # 225: phase 7's shape, C = 8
    (100, 160, 255),  # 256: C = 8, full
    (40, 60, 256),    # 257: C = 12, two mask words a lane
    (30, 80, 383),    # 384: C = 12, full
    (30, 80, 511),    # 512: C = 16
    (20, 100, 767),   # 768: C = 24, three words
    (12, 150, 1023),  # 1,024: C = 32, full
    (8, 440, 1000),   # C = 32 at 227,232 bytes a warp: one warp a block
    (10, 1700, 200),  # C = 8 at 219,632 bytes a warp
    (12, 900, 1023),  # 1,024 lanes, a plane past shared memory: the block form
    (10, 1000, 1024),  # 1,025: the block form
    (6, 1101, 1251),  # 1,252
    (20, 0, 37),      # an empty a side
    (20, 45, 0),      # an empty b side
    (20, 0, 0),       # both
])
def test_traceback_kernel_matches_plain(cuda, B, M, N, efb, kind):
    """C2 unbanded against its plain version, on the warp form at each of
    its cells a lane and at the edges of its rows and shared memory, and on
    the block form past them: the ops, costs and ends of global and fitting
    alignments (tie_late on every third row), rows with m = 0 or n = 0,
    tie-heavy rows, and one launch a call."""
    ca, la, cb, lb = (x.to(cuda) for x in _tb_codes(B + M + N, B, M, N, kind))
    late = (torch.arange(B, device=cuda) % 3 == 1) if efb else None
    for costs in ((1, 1), (3, 2)):
        got = align.align_ops_codes_kernel(ca, la, cb, lb, *costs, efb, late)
        _tb_equal(got, align.align_ops_codes_torch(ca, la, cb, lb, *costs, efb, late))
    before = kernels.LAUNCHES["traceback"]
    align.align_ops_codes(ca, la, cb, lb, 1, 1, efb, late)
    assert kernels.LAUNCHES["traceback"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planted", "drift", "ties"])
@pytest.mark.parametrize("efb", [False, True])
@pytest.mark.parametrize("band,M,N", [
    ((-15, 15), 50, 61),         # K = 17
    ((-31, 31), 77, 70),         # 33
    ((-40, 24), 101, 90),        # 34, asymmetric
    ((-223, 223), 160, 300),     # 225
    ((-1022, 1022), 1100, 1200),  # 1,024
    ((-1023, 1023), 1200, 1100),  # 1,025
    ((-1250, 1250), 1500, 1700),  # 1,252: the band of a 10-kb --long --sam read
    ((-3, 3), 40, 41),           # K = 5: most walks leave the band
])
def test_traceback_banded_kernel_matches_plain(cuda, band, M, N, efb, kind):
    """C2 banded against its plain version, planted indel drift past the
    band included (the walk reads clamped lanes, cells with i < 0 or past
    the lengths among them)."""
    B = 24 if M < 1000 else 5
    ca, la, cb, lb = (x.to(cuda) for x in _tb_codes(B + M - band[0], B, M, N, kind))
    got = align.align_ops_codes_banded_kernel(ca, la, cb, lb, 1, 1, efb, *band)
    _tb_equal(got, align.align_ops_codes_banded_torch(ca, la, cb, lb, 1, 1, efb, *band))
    before = kernels.LAUNCHES["traceback"]
    align.align_ops_codes_banded(ca, la, cb, lb, 1, 1, efb, *band)
    assert kernels.LAUNCHES["traceback"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("costs", [(-1, 1), (2**29, 3), (5, -2), (3, 2**29),
                                   (-2**31, 2**31 - 1), (2**31 - 1, -2**31)])
@pytest.mark.parametrize("band,M,N", [
    (None, 40, 57),     # the warp form at C = 2
    (None, 30, 255),    # C = 8, full rows
    (None, 30, 256),    # C = 12
    (None, 20, 1023),   # C = 32, full rows
    (None, 20, 1024),   # the block form
    ((-8, 8), 40, 57),
])
def test_traceback_kernel_any_int32_costs(cuda, costs, band, M, N):
    """Negative costs and sums past 2^31 wrap as the plain version's int32
    tensors do; so do the boundary products d * gap, in both forms."""
    ca, la, cb, lb = (x.to(cuda) for x in _tb_codes(9, 30, M, N, "planted"))
    for efb in (False, True):
        if band is None:
            late = torch.arange(30, device=cuda) % 2 == 0
            _tb_equal(align.align_ops_codes_kernel(ca, la, cb, lb, *costs, efb, late),
                      align.align_ops_codes_torch(ca, la, cb, lb, *costs, efb, late))
        else:
            _tb_equal(align.align_ops_codes_banded_kernel(ca, la, cb, lb, *costs, efb, *band),
                      align.align_ops_codes_banded_torch(ca, la, cb, lb, *costs, efb, *band))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["plane", "ring"])
def test_traceback_kernel_scratch_and_grid_stride(cuda, monkeypatch, where):
    """The plane, or the ring and the plane, in device scratch, with fewer
    blocks than pairs, so each block reuses its slice for several pairs."""
    monkeypatch.setattr(align, "_TB_WARP_LANES", 0)  # the unbanded form on the block form
    monkeypatch.setattr(align, "_TB_SMEM_BYTES", 0)
    if where == "ring":
        monkeypatch.setattr(align, "_TB_RING_SMEM_BYTES", 0)
    monkeypatch.setattr(align, "_TB_MAX_BLOCKS", 3)
    ca, la, cb, lb = (x.to(cuda) for x in _tb_codes(3, 40, 150, 224, "planted"))
    for efb in (False, True):
        _tb_equal(align.align_ops_codes_kernel(ca, la, cb, lb, 1, 1, efb),
                  align.align_ops_codes_torch(ca, la, cb, lb, 1, 1, efb))
        _tb_equal(align.align_ops_codes_banded_kernel(ca, la, cb, lb, 1, 1, efb, -20, 20),
                  align.align_ops_codes_banded_torch(ca, la, cb, lb, 1, 1, efb, -20, 20))


def _tb_entry_calls(monkeypatch):
    """Counts of C2's C entry points called from here on: "warp"
    (bn_traceback_warp) and "block" (bn_traceback)."""
    lib = _build.library()
    calls = {"warp": 0, "block": 0}
    for form, name in (("warp", "bn_traceback_warp"), ("block", "bn_traceback")):
        fn = getattr(lib, name)

        def spy(*a, _fn=fn, _form=form):
            calls[_form] += 1
            return _fn(*a)
        monkeypatch.setattr(lib, name, spy)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["banded", "wide", "plane past shared memory", "scratch",
                                  "warp"])
def test_traceback_forms(cuda, monkeypatch, case):
    """The banded form, rows past 1,024 lanes, planes past a warp's shared
    memory and the scratch layouts still launch the block form and equal
    the plain version; phase 7's shape launches the warp form."""
    M, N = {"wide": (150, 1024), "plane past shared memory": (1_800, 200)}.get(case, (150, 224))
    ca, la, cb, lb = (x.to(cuda) for x in _tb_codes(31, 6, M, N, "planted"))
    if case == "scratch":
        monkeypatch.setattr(align, "_TB_WARP_LANES", 0)
        monkeypatch.setattr(align, "_TB_SMEM_BYTES", 0)
    calls = _tb_entry_calls(monkeypatch)
    for efb in (False, True):
        if case == "banded":
            _tb_equal(align.align_ops_codes_banded_kernel(ca, la, cb, lb, 1, 1, efb, -20, 20),
                      align.align_ops_codes_banded_torch(ca, la, cb, lb, 1, 1, efb, -20, 20))
        else:
            _tb_equal(align.align_ops_codes_kernel(ca, la, cb, lb, 1, 1, efb),
                      align.align_ops_codes_torch(ca, la, cb, lb, 1, 1, efb))
    assert calls == ({"warp": 2, "block": 0} if case == "warp" else {"warp": 0, "block": 2})


@pytest.mark.cuda
def test_traceback_kernel_edges(cuda):
    """An empty batch launches nothing; align_ops on packed words runs C2;
    lengths outside [0, M] and [0, N] raise; a band as wide as the window
    runs the unbanded form."""
    ca, la, cb, lb = (x.to(cuda) for x in _tb_codes(4, 20, 48, 64, "planted"))
    before = kernels.LAUNCHES["traceback"]
    out = align.align_ops_codes_kernel(ca[:0], la[:0], cb[:0], lb[:0])
    assert [tuple(x.shape) for x in out] == [(0,), (0,), (0, 112)]
    assert kernels.LAUNCHES["traceback"] == before
    wa, wb = bitops.pack_codes(ca & 3), bitops.pack_codes(cb & 3)
    _tb_equal(align.align_ops(wa, la, wb, lb, 1, 1, True),
              align.align_ops_codes_torch(ca & 3, la, cb & 3, lb, 1, 1, True))
    assert kernels.LAUNCHES["traceback"] == before + 1
    for side, bad in ((0, 49), (0, -1), (1, 65), (1, -2)):
        lens = [la.clone(), lb.clone()]
        lens[side][7] = bad
        with pytest.raises(ValueError, match="lengths"):
            align.align_ops_codes_kernel(ca, lens[0], cb, lens[1])
    _tb_equal(align.align_ops_codes_banded_kernel(ca, la, cb, lb, 1, 1, False, -80, 80),
              align.align_ops_codes_torch(ca, la, cb, lb, 1, 1, False))


def _fs_words(seed, B, M, N, kind):
    """_tb_codes packed into words (M and N multiples of 16): the codes past
    each length stay in the words."""
    ca, la, cb, lb = _tb_codes(seed, B, M, N, kind)
    return bitops.pack_codes(ca & 3), la, bitops.pack_codes(cb & 3), lb


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planted", "ties"])
@pytest.mark.parametrize("B,M,N", [
    (40, 16, 16),
    (40, 48, 32),       # m > n
    (300, 160, 224),    # the mapping shape
    (12, 1008, 1008),   # N + 1 = 1,009: two lanes a thread
    (10, 1008, 1024),   # N + 1 = 1,025
    (6, 1104, 1248),
    (5, 1504, 1920),    # half of phase 10's extend shape
    (20, 0, 48),        # an empty a side
    (20, 48, 0),        # an empty b side
])
def test_fit_span_kernel_matches_plain(cuda, B, M, N, kind):
    """C3's span form against its plain version: rows with m = 0 or n = 0,
    full rows, tie-heavy rows, and one launch a call."""
    wa, la, wb, lb = (x.to(cuda) for x in _fs_words(B + M + N, B, M, N, kind))
    for costs in ((1, 1), (3, 2)):
        got = align.fit_distance_span_kernel(wa, la, wb, lb, *costs)
        _tb_equal(got, align.fit_distance_span_torch(wa, la, wb, lb, *costs))
    before = kernels.LAUNCHES["fit_span"]
    align.fit_distance_span(wa, la, wb, lb)
    assert kernels.LAUNCHES["fit_span"] == before + 1


def _distance_equal(wa, la, wb, lb, costs, late):
    """C3's distance form against its plain version: global, and fitting
    with and without tie_late rows."""
    for efb, tl in ((False, None), (True, None), (True, late)):
        _tb_equal(align._distance_wavefront_kernel(wa, la, wb, lb, *costs, efb, tl),
                  align._distance_wavefront_torch(wa, la, wb, lb, *costs, efb, tl))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["planted", "ties"])
@pytest.mark.parametrize("B,M,N", [
    (40, 16, 16),
    (40, 48, 32),       # m > n
    (300, 160, 224),    # the mapping shape (align --mode fit and global)
    (10, 1008, 1024),   # N + 1 = 1,025
    (6, 1104, 1248),
    (20, 0, 48),        # an empty a side
    (20, 48, 0),        # an empty b side
])
def test_fit_span_distance_kernel_matches_plain(cuda, B, M, N, kind):
    """C3's distance form against its plain version (tie_late on every
    third row), and one launch for each of edit_distance, global_distance
    and fit_distance."""
    wa, la, wb, lb = (x.to(cuda) for x in _fs_words(B + M + N + 1, B, M, N, kind))
    late = torch.arange(B, device=cuda) % 3 == 1
    for costs in ((1, 1), (3, 2)):
        _distance_equal(wa, la, wb, lb, costs, late)
    before = kernels.LAUNCHES["fit_span"]
    assert torch.equal(align.edit_distance(wa, la, wb, lb),
                       align._distance_wavefront_torch(wa, la, wb, lb, 1, 1)[0])
    align.global_distance(wa, la, wb, lb, 3, 2)
    align.fit_distance(wa, la, wb, lb, 1, 1, late)
    assert kernels.LAUNCHES["fit_span"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("costs", [(-1, 1), (2**29, 3), (5, -2), (3, 2**29), (0, 0),
                                   (-2**31, 2**31 - 1), (2**31 - 1, -2**31), (-7, 2**30)])
def test_fit_span_kernel_any_int32_costs(cuda, costs):
    """Negative costs and sums past 2^31 wrap as the plain version's int32
    tensors do; so do the boundary products d * gap."""
    wa, la, wb, lb = (x.to(cuda) for x in _fs_words(19, 30, 48, 64, "planted"))
    _tb_equal(align.fit_distance_span_kernel(wa, la, wb, lb, *costs),
              align.fit_distance_span_torch(wa, la, wb, lb, *costs))
    _distance_equal(wa, la, wb, lb, costs, torch.arange(30, device=cuda) % 2 == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["ring", "codes"])
def test_fit_span_kernel_scratch_and_grid_stride(cuda, monkeypatch, where):
    """The ring, or the ring and the codes, in device scratch, with fewer
    blocks than pairs, so each block reuses its slice for several pairs."""
    monkeypatch.setattr(align, "_FIT_RING_SMEM_BYTES", 0)
    if where == "codes":
        monkeypatch.setattr(align, "_FIT_SMEM_BYTES", 0)
    monkeypatch.setattr(align, "_FIT_MAX_BLOCKS", 3)
    wa, la, wb, lb = (x.to(cuda) for x in _fs_words(5, 40, 160, 224, "planted"))
    for planes in (1, 2):
        ring_smem, codes_smem, stride, nblocks = align._fit_layout(40, 160, 224, planes)
        assert (ring_smem, codes_smem, nblocks) == (0, int(where == "ring"), 3) and stride
    _tb_equal(align.fit_distance_span_kernel(wa, la, wb, lb, 1, 1),
              align.fit_distance_span_torch(wa, la, wb, lb, 1, 1))
    _distance_equal(wa, la, wb, lb, (1, 1), torch.arange(40, device=cuda) % 2 == 0)


@pytest.mark.cuda
def test_fit_span_kernel_edges(cuda):
    """An empty batch launches nothing; lengths outside [0, 16 Wa] and
    [0, 16 Wb] raise; a band as wide as the window runs C3 and not K8."""
    wa, la, wb, lb = (x.to(cuda) for x in _fs_words(6, 20, 48, 64, "planted"))
    before = dict(kernels.LAUNCHES)
    out = align.fit_distance_span_kernel(wa[:0], la[:0], wb[:0], lb[:0])
    assert [tuple(x.shape) for x in out] == [(0,)] * 3
    assert kernels.LAUNCHES["fit_span"] == before["fit_span"]
    out = align._distance_wavefront_kernel(wa[:0], la[:0], wb[:0], lb[:0], 1, 1, True)
    assert [tuple(x.shape) for x in out] == [(0,)] * 2
    assert kernels.LAUNCHES["fit_span"] == before["fit_span"]
    for side, bad in ((0, 49), (0, -1), (1, 65), (1, -2)):
        lens = [la.clone(), lb.clone()]
        lens[side][7] = bad
        with pytest.raises(ValueError, match="lengths"):
            align.fit_distance_span_kernel(wa, lens[0], wb, lens[1])
        with pytest.raises(ValueError, match="lengths"):
            align.global_distance(wa, lens[0], wb, lens[1])
    _tb_equal(align.fit_distance_span_banded(wa, la, wb, lb, 1, 1, -80, 80),
              align.fit_distance_span_torch(wa, la, wb, lb, 1, 1))
    assert kernels.LAUNCHES["fit_span"] == before["fit_span"] + 1
    assert kernels.LAUNCHES["fit_banded"] == before["fit_banded"]


# Q covers each query-tile width of K6 (8, 32, 64, 128, 256) and the walk
# over tiles of 256 past it; W = 64 takes the ring of B stages around more
# than once a tile.
K6_Q = [1, 7, 8, 9, 64, 130, 256, 257, 512]
K6_W = [1, 9, 32, 33, 64]


def _k6_inputs(seed, Q, W, D):
    g = torch.Generator().manual_seed(seed)
    db = torch.randint(-(2**31), 2**31 - 1, (W, D), generator=g, dtype=torch.int32)
    q = torch.randint(-(2**31), 2**31 - 1, (Q, W), generator=g, dtype=torch.int32)
    return q, db


NB_OF = {"zero": lambda W: 0, "137": lambda W: 137, "all": lambda W: 16 * W}


@pytest.mark.cuda
@pytest.mark.parametrize("Q", K6_Q)
@pytest.mark.parametrize("W", K6_W)
@pytest.mark.parametrize("nb_of", list(NB_OF))
@pytest.mark.parametrize("D", [5, 1000, 1001])
def test_tc_scan_kernel_matches_plain(cuda, Q, W, nb_of, D):
    """K6 at ragged D (5; 1000 and 1001, not multiples of the 128-entry
    tile), n_bases of 0, 137 (clamped at W = 1) and 16 W: equal to its
    plain version and to K4/K5."""
    nb = NB_OF[nb_of](W)
    q, db = (x.to(cuda) for x in _k6_inputs(Q + W + D, Q, W, D))
    got = hamming.hdist_scan_tc_kernel(q, db, nb)
    assert torch.equal(got, hamming.hdist_scan_tc_torch(q, db, nb))
    assert torch.equal(got, hamming.hdist_scan_kernel(q, db, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [9, 257])
@pytest.mark.parametrize("W", [9, 32])
@pytest.mark.parametrize("nb_of", ["137", "all"])
def test_tc_scan_kernel_over_many_tiles_a_block(cuda, Q, W, nb_of):
    """D = 300,000: every block walks several 128-entry tiles."""
    nb = NB_OF[nb_of](W)
    q, db = (x.to(cuda) for x in _k6_inputs(Q * W, Q, W, 300_000))
    got = hamming.hdist_scan_tc_kernel(q, db, nb)
    assert torch.equal(got, hamming.hdist_scan_kernel(q, db, nb))
    assert torch.equal(got, hamming.hdist_scan_tc_torch(q, db, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [10, 27, 28, 31, 32, 64])
def test_distances_batch_routes_by_tc_min_q(cuda, W):
    """K6 from tc_min_q(W) queries on and K5 below it; K5 at any Q where it
    is None."""
    from bitnuc_tpu_torch import database

    g = torch.Generator().manual_seed(9)
    nb = 16 * W - 3
    db = database.PackedDB(
        torch.randint(-(2**31), 2**31 - 1, (W, 3000), generator=g, dtype=torch.int32).to(cuda),
        nb)
    t = database.tc_min_q(W)
    cases = ([(2, "hdist_scan_batch"), (600, "hdist_scan_batch")] if t is None else
             [(t, "tc_scan"), (t - 1, "hdist_scan_batch"), (2 * t + 1, "tc_scan")])
    for Q, name in cases:
        q = torch.randint(-(2**31), 2**31 - 1, (Q, W), generator=g, dtype=torch.int32).to(cuda)
        before = dict(kernels.LAUNCHES)
        got = db.distances_batch(q)
        assert kernels.LAUNCHES[name] == before[name] + 1
        assert torch.equal(got, hamming.hdist_scan_torch(q, db.words_wm, nb))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", K6_Q)
@pytest.mark.parametrize("W", K6_W)
@pytest.mark.parametrize("nb_of", list(NB_OF))
@pytest.mark.parametrize("D", [5, 1001])
@pytest.mark.parametrize("k", [1, 10, hamming.SEARCH_TOPK_MAX])
def test_tc_search_kernel_matches_plain(cuda, Q, W, nb_of, D, k):
    """The fused search at ragged D (5: k past D), n_bases 0, 137 and 16 W,
    k = 1, 10 and the largest: equal to its plain version and to the top-k
    of K6's and of K5's matrix."""
    nb = NB_OF[nb_of](W)
    q, db = (x.to(cuda) for x in _k6_inputs(Q + W + D + 1, Q, W, D))
    got = hamming.hdist_search_tc_kernel(q, db, nb, k)
    for want in (hamming.hdist_search_tc_torch(q, db, nb, k),
                 hamming.topk_smallest_batch(hamming.hdist_scan_tc_kernel(q, db, nb), k),
                 hamming.topk_smallest_batch(hamming.hdist_scan_kernel(q, db, nb), k)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [8, 257])
@pytest.mark.parametrize("D", [1000, 300_000])
@pytest.mark.parametrize("k", [1, 10, hamming.SEARCH_TOPK_MAX])
def test_tc_search_kernel_over_many_tiles_a_block(cuda, Q, D, k):
    q, db = (x.to(cuda) for x in _k6_inputs(Q + D, Q, 32, D))
    got = hamming.hdist_search_tc_kernel(q, db, 512, k)
    want = hamming.topk_smallest_batch(hamming.hdist_scan_kernel(q, db, 512), k)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_k6_launches_once_at_q8(cuda):
    """A call at Q = 8 launches its kernel once and no other counted
    kernel: the B stages are laid out by PyTorch."""
    q, db = (x.to(cuda) for x in _k6_inputs(8, 8, 32, 3000))
    for name, call in (("tc_scan", lambda: hamming.hdist_scan_tc_kernel(q, db, 512)),
                       ("tc_search", lambda: hamming.hdist_search_tc_kernel(q, db, 512, 10))):
        kernels.reset_launches()
        call()
        assert kernels.LAUNCHES == {n: int(n == name) for n in kernels.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("Q,D,k", [(130, 130, 10), (5, 300_000, 32), (130, 300_000, 7),
                                   (257, 300_000, 32), (8, 130, 10)])
def test_tc_search_ties_go_to_the_lowest_index(cuda, Q, D, k):
    """A database of one repeated entry: every distance ties, across
    blocks, tiles and lanes, so each query's list is entries 0..k-1 (a
    block of D = 130 holds fewer than k entries; D = 300,000 walks several
    tiles a block)."""
    g = torch.Generator().manual_seed(D)
    entry = torch.randint(-(2**31), 2**31 - 1, (32, 1), generator=g, dtype=torch.int32)
    db = entry.expand(32, D).contiguous().to(cuda)
    q = torch.randint(-(2**31), 2**31 - 1, (Q, 32), generator=g, dtype=torch.int32).to(cuda)
    d, i = hamming.hdist_search_tc_kernel(q, db, 500, k)
    assert torch.equal(i, torch.arange(k, dtype=torch.int32, device=cuda).expand(Q, k))
    assert torch.equal(d, hamming.hdist_scan_kernel(q, db[:, :1].contiguous(), 500).expand(Q, k))
    wd, wi = hamming.hdist_search_tc_torch(q, db, 500, k)
    assert torch.equal(d, wd) and torch.equal(i, wi)


@pytest.mark.cuda
def test_search_batch_routes_by_q_and_k(cuda):
    """search_batch takes tc_search from SEARCH_TC_MIN_Q queries on for
    k <= SEARCH_TOPK_MAX, else the two-step route; both give the same."""
    from bitnuc_tpu_torch import database

    g = torch.Generator().manual_seed(11)
    db = database.PackedDB(
        torch.randint(-(2**31), 2**31 - 1, (32, 3000), generator=g, dtype=torch.int32).to(cuda),
        512)
    cases = [(database.SEARCH_TC_MIN_Q, 10, True), (256, hamming.SEARCH_TOPK_MAX, True),
             (256, hamming.SEARCH_TOPK_MAX + 1, False)]
    if database.SEARCH_TC_MIN_Q > 1:
        cases.append((database.SEARCH_TC_MIN_Q - 1, 10, False))
    for Q, k, fused in cases:
        q = torch.randint(-(2**31), 2**31 - 1, (Q, 32), generator=g, dtype=torch.int32).to(cuda)
        before = kernels.LAUNCHES["tc_search"]
        got = db.search_batch(q, k)
        assert kernels.LAUNCHES["tc_search"] == before + int(fused)
        want = hamming.topk_batch_dispatch(db.distances_batch(q), k, 512)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, hamming.SEARCH_TOPK_MAX, hamming.SEARCH_TOPK_MAX + 1])
@pytest.mark.parametrize("dq", [-1, 0, 120])
@pytest.mark.parametrize("W,D,nb", [(32, 3000, 512), (10, 1001, 150), (2, 40, 20)])
def test_hdist_topk_batch_card_route_matches_plain(cuda, k, dq, W, D, nb):
    """hdist_topk_batch on the card (the word-major route of search_batch:
    K4/K5 or K6 and the top-k below SEARCH_TC_MIN_Q queries, tc_search from
    it on for k <= SEARCH_TOPK_MAX) against its plain composition on the
    same rows, with half the database repeated so distances tie."""
    from bitnuc_tpu_torch import database

    Q = max(database.SEARCH_TC_MIN_Q + dq, 1)
    g = torch.Generator().manual_seed(W * 1000 + Q)
    db = torch.randint(-(2**31), 2**31 - 1, (D, W), generator=g, dtype=torch.int32)
    db[D - D // 2 :] = db[: D // 2].clone()  # the upper rows repeat the lower ones
    q = db[torch.randint(0, D, (Q,), generator=g)] ^ torch.randint(
        0, 4, (Q, W), generator=g, dtype=torch.int32)
    want = hamming.hdist_topk_batch_torch(q, db, nb, k)
    before = kernels.LAUNCHES["tc_search"]
    got = hamming.hdist_topk_batch(q.to(cuda), db.to(cuda), nb, k)
    fused = Q >= database.SEARCH_TC_MIN_Q and k <= hamming.SEARCH_TOPK_MAX
    assert kernels.LAUNCHES["tc_search"] == before + int(fused)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["packed", "codes"])
@pytest.mark.parametrize("W1,W2", [(10, 10), (10, 4), (4, 10), (20, 20)])
def test_merge_pairs_on_the_card_matches_the_cpu(cuda, scan, W1, W2):
    """merge_pairs (plain PyTorch, no kernel) on CUDA tensors equals the same
    call on the CPU, output for output, on planted overlaps and random
    pairs."""
    from bitnuc_tpu_torch.ops import merge_pairs, revcomp

    g = torch.Generator().manual_seed(W1 * 100 + W2)
    B = 300
    frag = torch.randint(0, 4, (B, 16 * (W1 + W2)), generator=g, dtype=torch.int32)
    lens1 = torch.randint(0, 16 * W1 + 1, (B,), generator=g, dtype=torch.int32)
    lens2 = torch.randint(0, 16 * W2 + 1, (B,), generator=g, dtype=torch.int32)
    w1 = bitops.pack_codes(frag[:, : 16 * W1])
    # R2 as sequenced: the reverse complement of the fragment's tail, which
    # starts inside R1 for about half the rows
    start = torch.clamp(lens1 - torch.randint(0, 60, (B,), generator=g, dtype=torch.int32), min=0)
    idx = torch.clamp(start[:, None] + torch.arange(16 * W2), max=frag.shape[1] - 1)
    tail = bitops.pack_codes(torch.gather(frag, 1, idx.long()))
    w2 = revcomp.reverse_complement_reads(tail, lens2)
    w2[1::2] = torch.randint(-(2**31), 2**31 - 1, (B // 2, W2), generator=g, dtype=torch.int32)
    for mo, frac in ((10, 0.1), (1, 0.0), (25, 0.3)):
        want = merge_pairs.merge_pairs(w1, lens1, w2, lens2, mo, frac, scan)
        got = merge_pairs.merge_pairs(w1.to(cuda), lens1.to(cuda), w2.to(cuda), lens2.to(cuda),
                                      mo, frac, scan)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
        assert bool(want[2].any())


def _orf_reads(seed, B, W, lengths=None, motifs=None):
    """B reads of W words, codes weighted towards A and T (ATG- and
    stop-rich), or drawn from ``motifs`` (codons joined at random); without
    given lengths, the first rows are planted edges."""
    rng = np.random.default_rng(seed)
    L = 16 * W
    codes = rng.choice(4, (B, L), p=[0.35, 0.1, 0.2, 0.35])
    if motifs is not None:
        pool = np.array([["ACGT".index(c) for c in m] for m in motifs])
        codes = pool[rng.integers(0, len(pool), (B, -(-L // 3)))].reshape(B, -1)[:, :L]
    lens = rng.integers(0, L + 1, B) if lengths is None else np.asarray(lengths)
    plants = [b"TTTATGATGAAATGAAAATAG", b"TAATAGTGA" * 4, b"CCCCCCCCCCCC", b"ATGAAAAA"]
    for r, s in enumerate(plants[: B // 2] if lengths is None else []):
        s = s[:L]
        codes[r, : len(s)] = [b"ACGT".index(c) for c in s]
        lens[r] = len(s)
    return (bitops.pack_codes(torch.from_numpy(np.ascontiguousarray(codes))),
            torch.from_numpy(lens.astype(np.int32)))


def _edge_lengths(W):
    """0, 16 W - 1, 16 W, 16 W + 5 (bases past the words read as A) and a
    few inside the row."""
    return [0, 16 * W - 1, 16 * W, 16 * W + 5, 16 * W - 16, 16 * W - 17, 3, 2]


# the reverse strand's motifs read forward: CAT (ATG), TTA, CTA, TCA (stops)
_RC_MOTIFS = ("CAT", "TTA", "CTA", "TCA", "GCC")


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,lengths,motifs", [
    (9, 1, [0, 1, 2, 3, 4, 5, 14, 15, 16], None),  # lengths 0, 1, 2 and 16 W
    (300, 10, None, None),                          # 150-bp rows
    (600, 16, None, None),                          # a thread a row, 256 rows a block
    (8, 16, _edge_lengths(16), None),
    (40, 17, None, None),
    (8, 17, _edge_lengths(17), None),
    (300, 18, None, None),                          # 128 rows a block
    (300, 19, None, None),                          # 300-bp rows
    (40, 32, None, None),
    (20, 33, None, None),
    (200, 34, None, None),                          # 64 rows a block
    (6, 40, [640, 639, 638, 637, 600, 0], None),
    (100, 63, None, None),                          # 1-kb rows
    (100, 68, None, None),                          # 32 rows a block
    (70, 128, None, None),                          # the widest row a thread takes
    (8, 128, _edge_lengths(128), None),
    (40, 129, None, None),                          # the narrowest row a block takes
    (8, 129, _edge_lengths(129), None),
    (8, 512, _edge_lengths(512), None),             # one warp's round of 512 words
    (8, 513, _edge_lengths(513), None),             # its seam
    (4, 4097, [16 * 4097, 16 * 4097 - 1, 65_536, 16 * 4097 + 5], None),  # a block's round
    (3, 6250, [100_000, 99_999, 65_536], None),     # past the TPU's 32,767 bound
    (200, 10, None, _RC_MOTIFS),                    # reverse-strand motifs
    (8, 10, _edge_lengths(10), _RC_MOTIFS),
    (8, 600, _edge_lengths(600), _RC_MOTIFS),
    (40, 10, None, ("ATG", "TAA", "TAG", "TGA")),   # ATG- and stop-dense
    (6, 2, [33, 40, 48, 64, 100, 2**31 - 1], None),  # 16 W < n: the reverse gather wraps
    (4, 20, [321, 330, 700, 2**31 - 1], None),
])
@pytest.mark.parametrize("strands", ["one", "two"])
def test_orf_scan_kernel_matches_plain(cuda, B, W, lengths, motifs, strands, monkeypatch):
    words, lens = (x.to(cuda) for x in _orf_reads(B + W, B, W, lengths, motifs))
    kern, plain = {"one": (orf.best_orf_one_strand_kernel, orf.best_orf_one_strand_torch),
                   "two": (orf.best_orf_two_strands_kernel, orf.best_orf_two_strands_torch)}[strands]
    before = kernels.LAUNCHES["orf_scan"]
    got = kern(words, lens)
    assert kernels.LAUNCHES["orf_scan"] == before + 1
    for g, w in zip(got, plain(words, lens)):
        assert torch.equal(g, w)
    # longest_orf: one launch, and no reverse complement made on the device
    def no_revcomp(*args):
        raise AssertionError("longest_orf made a reverse complement")
    monkeypatch.setattr(orf.revcomp, "reverse_complement_reads", no_revcomp)
    before = kernels.LAUNCHES["orf_scan"]
    orf.longest_orf(words, lens)
    assert kernels.LAUNCHES["orf_scan"] == before + 1


# -- C1 chain ---------------------------------------------------------------------


def _anchor_rows(seed, B, A, neg=False, big=False):
    """B rows of A anchors in any order: a noisy diagonal, noise, repeated
    anchors, about 15% invalid, row 0 all invalid; neg shifts coordinates
    below -1, big makes some valid anchors dead (r >= 2^30)."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, 90, (B, A))
    r = np.cumsum(step, 1) + rng.integers(0, 4000, (B, 1))
    q = np.cumsum(np.maximum(step + rng.integers(-9, 10, (B, A)), 1), 1)
    noise = rng.random((B, A)) < 0.3
    r = np.where(noise, rng.integers(0, 9000, (B, A)), r)
    q = np.where(noise, rng.integers(0, 3000, (B, A)), q)
    src = rng.integers(0, max(A, 1), (B, A))
    dup = rng.random((B, A)) < 0.15
    r = np.where(dup, np.take_along_axis(r, src, 1), r)
    q = np.where(dup, np.take_along_axis(q, src, 1), q)
    if neg:
        r, q = r - 7000, q - 2500
    if big:
        r = np.where(rng.random((B, A)) < 0.1, 2**30 + 2, r)
    v = rng.random((B, A)) < 0.85
    v[:1] = False
    return tuple(torch.from_numpy(x) for x in (r.astype(np.int32), q.astype(np.int32), v))


def _chain_equal(cuda, rows, max_gap, gap_unit, lookback):
    """C1 on the card (one launch) equals the plain version on the CPU."""
    before = kernels.LAUNCHES["chain"]
    got = chain.chain_anchors(*(x.to(cuda) for x in rows), max_gap, gap_unit, lookback)
    assert kernels.LAUNCHES["chain"] == before + 1
    for g, w in zip(got, chain.chain_anchors_torch(*rows, max_gap, gap_unit, lookback)):
        assert torch.equal(g.cpu(), w)


_CHAIN_LOOKBACKS = [1, 32, 33, 64, chain.REG_LOOKBACK, chain.REG_LOOKBACK + 1, chain.MAX_LOOKBACK]
_CHAIN_GAPS = [(2048, 16), (512, 8), (0, 1), (300, 1000), (100, -3), (2**31 - 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,A", [(1, 1), (3, 31), (40, 33), (9, 64), (130, 200), (5, 1000)])
@pytest.mark.parametrize("lookback", _CHAIN_LOOKBACKS)
@pytest.mark.parametrize("max_gap,gap_unit", _CHAIN_GAPS)
def test_chain_kernel_matches_plain(cuda, B, A, lookback, max_gap, gap_unit):
    """Unsorted rows: the register ring at 1, 2 and 8 slots a lane and its
    edge (REG_LOOKBACK), the shared-memory ring past it; a shift, a
    multiply-high and a floor for the division; rows of A % 16 == 0 on the
    16-byte loads, the others on single ones."""
    _chain_equal(cuda, _anchor_rows(B * A, B, A), max_gap, gap_unit, lookback)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["negative", "dead", "duplicates", "no_valid", "empty"])
@pytest.mark.parametrize("max_gap,gap_unit", _CHAIN_GAPS[:5])
def test_chain_kernel_edges(cuda, case, max_gap, gap_unit):
    if case == "duplicates":  # every anchor five times: ties in every column
        r = torch.tensor([[100, 150, 204, 260] * 5, [-100, -50, 4, 60] * 5], dtype=torch.int32)
        rows = (r, r - 90, torch.ones_like(r, dtype=torch.bool))
    elif case == "no_valid":
        r, q, v = _anchor_rows(2, 6, 70)
        rows = (r, q, torch.zeros_like(v))
    elif case == "empty":
        z = torch.zeros((3, 0), dtype=torch.int32)
        rows = (z, z, z.bool())
    else:
        rows = _anchor_rows(7, 50, 160, neg=case == "negative", big=case == "dead")
    for lookback in (1, 2, 64, chain.REG_LOOKBACK, 500):
        _chain_equal(cuda, rows, max_gap, gap_unit, lookback)


def _long_rows(B, A, live, seed):
    """Rows laid out as map_reads_long's: anchors of a minimizer in groups of
    8 (its occurrences), about `live` of them valid, the rest -1."""
    rng = np.random.default_rng(seed)
    S = A // 8
    r = np.full((B, S, 8), -1, np.int64)
    q = np.broadcast_to(np.arange(S) * 6, (B, S))[:, :, None].repeat(8, 2).copy()
    hit = rng.random((B, S)) < live / S
    r[:, :, 0] = np.where(hit, rng.integers(0, 5_000_000, (B, 1)) + np.arange(S) * 6
                          + rng.integers(-3, 4, (B, S)), -1)
    extra = rng.random((B, S, 7)) < 0.01
    r[:, :, 1:] = np.where(extra, rng.integers(0, 5_000_000, (B, S, 7)), -1)
    r, q = r.reshape(B, A).astype(np.int32), q.reshape(B, A).astype(np.int32)
    return torch.from_numpy(r), torch.from_numpy(q), torch.from_numpy(r >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,live", [(300, 4096, 200), (64, 16_384, 1_800), (17, 1024, 120),
                                      (2_000, 2_048, 900)])
def test_chain_kernel_long_read_rows(cuda, monkeypatch, B, A, live):
    """Rows shaped as the long-read path's (live anchors about one in eight
    slots of a row's front), more rows than the card holds warps at once
    among them; no torch.sort on the way."""
    rows = _long_rows(B, A, live, A + live)
    on_card = [x.to(cuda) for x in rows]
    want = chain.chain_anchors_torch(*rows, 2048, 16, 64)

    def no_sort(*args, **kwargs):
        raise AssertionError("chain_anchors sorted on the card")
    monkeypatch.setattr(torch, "sort", no_sort)
    got = chain.chain_anchors(*on_card, 2048, 16, 64)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("lookback", [64, chain.REG_LOOKBACK + 44])
@pytest.mark.parametrize("n", [chain.ROW_CAP + 1, chain.ROW_CAP + 900, chain.SMEM_KEYS + 700])
def test_chain_kernel_rows_past_shared_memory(cuda, lookback, n):
    """A row of n live anchors past a warp's slice of shared memory (a block
    sorts it, in shared memory below SMEM_KEYS and in device memory past
    it) beside short rows, all in one launch; the same row unaligned (single
    loads)."""
    rng = np.random.default_rng(n)
    A = n + 16 - n % 16
    r = np.cumsum(rng.integers(1, 40, (4, A)), 1) - 5000
    q = r + rng.integers(-30, 31, (4, A))
    v = np.zeros((4, A), bool)
    v[0, :n] = True
    v[1:, : 300] = rng.random((3, 300)) < 0.9
    perm = rng.permutation(A)
    rows = tuple(torch.from_numpy(np.ascontiguousarray(x[:, perm]))
                 for x in (r.astype(np.int32), q.astype(np.int32), v))
    _chain_equal(cuda, rows, 512, 8, lookback)
    if n == chain.ROW_CAP + 900:
        flat = [torch.cat([x.reshape(-1)[:1], x.reshape(-1)]) for x in rows]
        unaligned = tuple(f[1:].view(4, A) for f in flat)  # 4 bytes past 16-byte alignment
        _chain_equal(cuda, unaligned, 512, 8, lookback)


@pytest.mark.cuda
def test_chain_kernel_refuses_a_ring_past_shared_memory(cuda):
    r = torch.zeros((2, chain.MAX_LOOKBACK + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        chain.chain_anchors_kernel(r, r, r.bool(), 512, 8, chain.MAX_LOOKBACK + 1)
    chain.chain_anchors_kernel(r, r, r.bool(), 512, 8, chain.MAX_LOOKBACK)  # the largest fits
    with config.backend("kernel"), pytest.raises(ValueError, match="CUDA"):
        chain.chain_anchors(r.cpu(), r.cpu(), r.cpu().bool())


@pytest.mark.cuda
@pytest.mark.parametrize("extend", [False, True])
def test_map_reads_long_on_card_matches_cpu(cuda, extend):
    """map_reads_long on the card (C1, one chain launch a chunk) equals the
    CPU run: indel-rich reads of 600-2,000 bp from both strands, and junk."""
    from bitnuc_tpu_torch import mapper
    from bitnuc_tpu_torch.sequence import PackedReads

    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = acgt[rng.integers(0, 4, 30_000)].tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(24):
        s = int(rng.integers(0, 27_000))
        src = bytearray(ref[s : s + int(rng.integers(600, 2000))])
        for _ in range(int(rng.integers(0, 12))):
            p = int(rng.integers(0, len(src) - 4))
            if rng.random() < 0.5:
                del src[p : p + int(rng.integers(1, 4))]
            else:
                src[p:p] = acgt[rng.integers(0, 4, int(rng.integers(1, 4)))].tobytes()
        r = bytes(src)
        reads.append(r.translate(comp)[::-1] if i % 2 else r)
    reads.append(acgt[rng.integers(0, 4, 1500)].tobytes())
    index_cpu = mapper.MinimizerIndex.build(ref, device="cpu")
    index_gpu = mapper.MinimizerIndex.build(ref, device=cuda)
    want = mapper.map_reads_long(index_cpu, PackedReads.from_ascii(reads, device="cpu"),
                                 extend=extend)
    kernels.reset_launches()
    got = mapper.map_reads_long(index_gpu, PackedReads.from_ascii(reads, device=cuda),
                                extend=extend)
    assert kernels.LAUNCHES["chain"] == 1
    assert kernels.LAUNCHES["fit_span"] == int(extend)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["mapped"][:-1].all() and not got["mapped"][-1]


@pytest.mark.cuda
def test_map_reads_long_extend_launches_c3_once_a_chunk(cuda, monkeypatch):
    """map_reads_long(extend=True) in chunks of 3 reads on the card: one C1
    and one C3 launch a chunk, and the result of one chunk."""
    from bitnuc_tpu_torch import mapper
    from bitnuc_tpu_torch.sequence import PackedReads

    rng = np.random.default_rng(10)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = acgt[rng.integers(0, 4, 20_000)].tobytes()
    reads = [ref[s : s + n] for s, n in zip(rng.integers(0, 17_000, 10).tolist(),
                                            rng.integers(700, 2500, 10).tolist())]
    index = mapper.MinimizerIndex.build(ref, device=cuda)
    pr = PackedReads.from_ascii(reads, device=cuda)
    want = mapper.map_reads_long(index, pr, extend=True)
    W = pr.words.shape[1]
    per_read = mapper._LONG_BYTES // mapper._long_chunk(W, index, True, 32)
    monkeypatch.setattr(mapper, "_LONG_BYTES", 3 * per_read)
    kernels.reset_launches()
    got = mapper.map_reads_long(index, pr, extend=True)
    assert kernels.LAUNCHES["chain"] == kernels.LAUNCHES["fit_span"] == 4
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["mapped"].all()


# -- the read-processing tier: plain PyTorch on the card against the CPU ----------
#
# lookup, dedupe, correct, demux, filters and qc have no kernel of their
# own; on CUDA tensors their PyTorch ops run on the card, and K1/K2 pack
# and decode. Each is held to the same call on the CPU.


def _genome_reads(seed, n, L, genome_bp=3_000, sub=0.01, n_rate=0.0):
    """ASCII reads of L bp drawn from a random genome (both strands), with
    substitutions and Ns, and the genome."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, genome_bp)]
    starts = rng.integers(0, genome_bp - L + 1, n)
    reads = np.lib.stride_tricks.sliding_window_view(genome, L)[starts].copy()
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    rev = rng.random(n) < 0.5
    reads[rev] = comp[reads[rev, ::-1]]
    err = rng.random(reads.shape) < sub
    reads[err] = acgt[rng.integers(0, 4, int(err.sum()))]
    reads[rng.random(reads.shape) < n_rate] = ord("N")
    return reads, genome


def _packed_both(cuda, ascii_rows, lens=None):
    from bitnuc_tpu_torch.sequence import PackedReads

    lens = np.full(len(ascii_rows), ascii_rows.shape[1], np.int32) if lens is None else lens
    out = []
    for dev in ("cpu", cuda):
        r = PackedReads.from_ascii(ascii_rows, lens, validate=False, device=dev)
        bv = codec.validity_mask(torch.from_numpy(ascii_rows).to(dev),
                                 torch.from_numpy(lens).to(dev))
        out.append((r.words, r.lengths, bv))
    return out


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want)


def _table_of(words, lengths, k, canonical, bv=None):
    lo, hi, ct, _ = kmer.count_kmers_sorted(words, lengths, k, canonical, bv)
    return lo, hi, ct


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 12, 21, 32])
@pytest.mark.parametrize("canonical", [False, True])
def test_tier_lookup_and_screen_match_cpu(cuda, k, canonical):
    from bitnuc_tpu_torch.ops import lookup

    reads, _ = _genome_reads(k, 300, 90, n_rate=0.01)
    (wc, lc, bc), (wg, lg, bg) = _packed_both(cuda, reads)
    t_cpu = _table_of(wc[::2], lc[::2], k, canonical, bc[::2])
    t_cpu = (t_cpu[0], t_cpu[1], t_cpu[2] - (torch.arange(t_cpu[2].numel()) % 5 == 0).int())
    t_gpu = tuple(t.to(cuda) for t in t_cpu)
    for bv_c, bv_g in ((None, None), (bc, bg)):
        want = lookup.kmer_hits_reads(wc, lc, k, *t_cpu, canonical, bv_c)
        _same(lookup.kmer_hits_reads(wg, lg, k, *t_gpu, canonical, bv_g), want)
        for mc in (1, 3):
            _same(lookup.screen_reads(wg, lg, k, *t_gpu, mc, canonical, bv_g),
                  lookup.screen_reads(wc, lc, k, *t_cpu, mc, canonical, bv_c))
            _same(lookup.solid_prefix_len(*(x.to(cuda) for x in want), lg, k, mc),
                  lookup.solid_prefix_len(*want, lc, k, mc))


@pytest.mark.cuda
@pytest.mark.parametrize("n_table", [0, 1, 1000])
def test_tier_lookup_counts_match_cpu(cuda, n_table):
    from bitnuc_tpu_torch.ops import lookup

    g = torch.Generator().manual_seed(n_table)
    t = torch.randint(-2**31, 2**31 - 1, (3, n_table), generator=g, dtype=torch.int32)
    t[:, n_table // 2:] = t[:, : n_table - n_table // 2]  # duplicate rows
    t[2] = torch.randint(-2, 9, (n_table,), generator=g, dtype=torch.int32)
    q = torch.cat([t[:2, torch.randint(0, max(n_table, 1), (500,), generator=g) % max(n_table, 1)]
                   if n_table else torch.zeros((2, 0), dtype=torch.int32),
                   torch.randint(-2**31, 2**31 - 1, (2, 300), generator=g, dtype=torch.int32)], 1)
    valid = torch.rand(q.shape[1], generator=g) < 0.8
    want = lookup.lookup_counts(q[0], q[1], valid, *t)
    _same(lookup.lookup_counts(q[0].to(cuda), q[1].to(cuda), valid.to(cuda),
                               *(x.to(cuda) for x in t)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 3, 10])
@pytest.mark.parametrize("R", [0, 1, 777])
def test_tier_mark_duplicates_matches_cpu(cuda, W, R):
    from bitnuc_tpu_torch.ops import dedupe

    g = torch.Generator().manual_seed(W * 1000 + R)
    pool = torch.randint(-2**31, 2**31 - 1, (30, W), generator=g, dtype=torch.int32)
    pick = torch.randint(0, 30, (R,), generator=g)
    words, lengths = pool[pick], torch.randint(15, 17, (R,), generator=g, dtype=torch.int32)
    want = dedupe.mark_duplicates(words, lengths)
    _same(dedupe.mark_duplicates(words.to(cuda), lengths.to(cuda)), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,L", [(21, 150), (11, 60), (31, 40), (21, 16)])
@pytest.mark.parametrize("canonical", [False, True])
def test_tier_correct_reads_matches_cpu(cuda, k, L, canonical):
    from bitnuc_tpu_torch.ops import correct

    clean, _ = _genome_reads(k + L, 600, L, sub=0.0)
    reads, _ = _genome_reads(k + L + 1, 200, L, sub=0.02, n_rate=0.005)
    (cc, clc, cbc), _ = _packed_both(cuda, clean)
    t_cpu = _table_of(cc, clc, k, canonical, cbc)
    t_gpu = tuple(t.to(cuda) for t in t_cpu)
    (wc, lc, bc), (wg, lg, bg) = _packed_both(cuda, reads)
    if L == 16:  # one word a read: k > 16 bases, no window fits
        wc, wg = wc[:, :1].contiguous(), wg[:, :1].contiguous()
        bc, bg = bc[:, :16], bg[:, :16]
    for rounds in (1, 4):
        want = correct.correct_reads(wc, lc, k, *t_cpu, 2, rounds, canonical, bc)
        _same(correct.correct_reads(wg, lg, k, *t_gpu, 2, rounds, canonical, bg), want)
    mc = torch.tensor(3, dtype=torch.int32)
    _same(correct.correct_reads_once(wg, lg, k, *t_gpu, mc.to(cuda), canonical),
          correct.correct_reads_once(wc, lc, k, *t_cpu, mc, canonical))


@pytest.mark.cuda
@pytest.mark.parametrize("bc_len", [8, 16, 24])
@pytest.mark.parametrize("max_dist", [0, 1, 2])
def test_tier_assign_barcodes_matches_cpu(cuda, bc_len, max_dist):
    from bitnuc_tpu_torch.ops import demux

    rng = np.random.default_rng(bc_len + max_dist)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bcs = acgt[rng.integers(0, 4, (40, bc_len))]
    bcs[1] = bcs[0]
    bcs[1, 0] = acgt[(np.flatnonzero(acgt == bcs[0, 0])[0] + 1) % 4]  # a near pair: ties
    reads = np.concatenate([bcs[rng.integers(0, 40, 500)], acgt[rng.integers(0, 4, (500, 60))]],
                           1)
    reads[:, :bc_len][rng.random((500, bc_len)) < 0.05] = ord("A")
    lens = rng.integers(0, reads.shape[1] + 1, 500).astype(np.int32)
    (wc, lc, _), (wg, lg, _) = _packed_both(cuda, reads, lens)
    (bw, _, _), _ = _packed_both(cuda, bcs)
    md = torch.tensor(max_dist, dtype=torch.int32)
    want = demux.assign_barcodes(wc, lc, bw, bc_len, md)
    _same(demux.assign_barcodes(wg, lg, bw.to(cuda), bc_len, md.to(cuda)), want)


def _fastq_rows(seed, R, L):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(b"ACGTacgtN", np.uint8)[rng.integers(0, 9, (R, L))]
    a[rng.random(R) < 0.1] = ord("A")  # poly-A rows
    adapter = np.frombuffer(b"AGATCGGAAGAGC", np.uint8)
    for r in range(0, R, 4):
        p = int(rng.integers(0, L))
        a[r, p : p + 13] = adapter[: L - p]
    q = (np.clip(rng.normal(36, 4, (R, L)) - np.arange(L) * 0.1, 2, 41) + 33).astype(np.uint8)
    lens = rng.integers(0, L + 1, R).astype(np.int64)
    return a, q, lens


@pytest.mark.cuda
@pytest.mark.parametrize("R,L", [(1, 1), (300, 2), (300, 3), (1000, 150), (64, 400)])
@pytest.mark.parametrize("adapter", [None, b"AGATCGGAAGAGC"])
def test_tier_filter_reads_matches_cpu(cuda, R, L, adapter):
    """The fused filter core on the card against the CPU: start and end
    exactly; keep exactly wherever the float64 triplet entropy lies more
    than 1e-4 from min_entropy (log2 and the sum's order differ in the
    last bit between the two devices)."""
    from bitnuc_tpu_torch import filters

    a, q, lens = _fastq_rows(R * L, R, L)
    kw = dict(min_len=5, min_mean_q=20, trim_q=20, max_n=3, adapter=adapter,
              min_complexity=0.3, min_entropy=3.0)
    want = filters.filter_reads(a, q, lens, device="cpu", **kw)
    got = filters.filter_reads(a, q, lens, device=cuda, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    h = filters.triplet_entropy(a, want[1], want[2])
    sure = np.abs(h - 3.0) > 1e-4
    np.testing.assert_array_equal(got[0][sure], want[0][sure])


@pytest.mark.cuda
def test_tier_filter_fastq_and_qc_match_cpu(cuda, tmp_path):
    from bitnuc_tpu_torch import filters, qc

    a, q, lens = _fastq_rows(5, 3000, 151)
    lens = np.maximum(lens, 1)  # an empty record would be a blank line
    with open(tmp_path / "in.fq", "wb") as f:
        for i in range(len(lens)):
            n = int(lens[i])
            f.write(b"@r%d x\n%s\n+\n%s\n" % (i, a[i, :n].tobytes(), q[i, :n].tobytes()))
    kw = dict(min_len=30, min_mean_q=20, trim_q=20, max_n=5, adapter=b"AGATCGGAAGAGC",
              min_complexity=0.3, batch_reads=1000)
    assert filters.filter_fastq(tmp_path / "in.fq", tmp_path / "g.fq", device=cuda, **kw) == \
        filters.filter_fastq(tmp_path / "in.fq", tmp_path / "c.fq", device="cpu", **kw)
    assert (tmp_path / "g.fq").read_bytes() == (tmp_path / "c.fq").read_bytes()
    assert filters.filter_fastq_paired(tmp_path / "in.fq", tmp_path / "in.fq", tmp_path / "g1",
                                       tmp_path / "g2", device=cuda, **kw) == \
        filters.filter_fastq_paired(tmp_path / "in.fq", tmp_path / "in.fq", tmp_path / "c1",
                                    tmp_path / "c2", device="cpu", **kw)
    assert (tmp_path / "g1").read_bytes() == (tmp_path / "c1").read_bytes()
    assert qc.qc_profile(tmp_path / "in.fq", 700, device=cuda) == \
        qc.qc_profile(tmp_path / "in.fq", 700, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [11, 21, 31])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_assemble_reads_on_card_matches_cpu(cuda, k, engine):
    """assemble_reads of reads packed on the card == of the same reads
    packed on the CPU: both strands and one, cleaned and not, N windows
    dropped and counted."""
    from bitnuc_tpu_torch import assemble
    from bitnuc_tpu_torch.sequence import PackedReads

    reads, _ = _genome_reads(k, 1500, 100, genome_bp=4_000, sub=0.003, n_rate=0.002)
    (wc, lc, bc), (wg, lg, bg) = _packed_both(cuda, reads)
    rc_, rg = PackedReads(words=wc, lengths=lc), PackedReads(words=wg, lengths=lg)
    for both in (True, False):
        for min_count, clean, use_bv in ((2, False, True), (1, True, True), (2, False, False)):
            kw = dict(min_count=min_count, both_strands=both, clean=clean, engine=engine)
            want = assemble.assemble_reads(rc_, k, base_valid=bc if use_bv else None, **kw)
            got = assemble.assemble_reads(rg, k, base_valid=bg if use_bv else None, **kw)
            assert got == want and want[0]


def _cli_inputs(d):
    """Small inputs of every phase-12 command: a two-contig reference,
    reads of it with Ns and without, long reads, pairs, a search database
    with 64 and 3 queries, one align target and a packed .npz."""
    from bitnuc_tpu_torch import io as bnio
    from bitnuc_tpu_torch.sequence import PackedReads

    rng = np.random.default_rng(22)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.arange(256, dtype=np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    contigs = [acgt[rng.integers(0, 4, n)] for n in (6_000, 3_000)]

    def fastq(name, rows):
        with open(d / name, "wb") as f:
            for i, r in enumerate(rows):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, bytes(r), b"I" * len(r)))

    def fasta(name, rows):
        with open(d / name, "wb") as f:
            for i, r in enumerate(rows):
                f.write(b">s%d x\n%s\n" % (i, bytes(r)))

    def draw(c, n, L, sub, n_rate=0.0):
        s = rng.integers(0, len(c) - L + 1, n)
        r = np.lib.stride_tricks.sliding_window_view(c, L)[s].copy()
        rev = rng.random(n) < 0.5
        r[rev] = comp[r[rev, ::-1]]
        err = rng.random(r.shape) < sub
        r[err] = acgt[rng.integers(0, 4, int(err.sum()))]
        r[rng.random(r.shape) < n_rate] = ord("N")
        return r

    fasta("ref.fa", contigs)
    reads = np.concatenate([draw(contigs[0], 800, 150, 0.005, 0.002),
                            draw(contigs[1], 400, 150, 0.005, 0.002)])
    fastq("reads.fq", reads)
    clean = draw(contigs[0], 600, 150, 0.005)
    fastq("clean.fq", clean)
    fastq("db.fq", clean[:400])
    q = clean[rng.integers(0, 400, 64)].copy()
    q[rng.random(q.shape) < 0.05] = ord("A")
    fasta("q64.fa", q)
    fasta("q3.fa", q[:3])
    fasta("target.fa", [contigs[0][:1000]])
    longs = [bytes(contigs[0][s : s + n]) for s, n in ((100, 1500), (2000, 2500), (500, 900))]
    fastq("long.fq", [np.frombuffer(s, np.uint8) for s in longs])
    flen = rng.integers(180, 400, 300)
    fs = rng.integers(0, 6_000 - flen)
    win = np.lib.stride_tricks.sliding_window_view(contigs[0], 150)
    left, right = win[fs], comp[win[fs + flen - 150][:, ::-1]]
    fastq("r1.fq", left)
    fastq("r2.fq", right)
    bnio.save_packed(d / "clean.npz", PackedReads.from_ascii(clean[:100], device="cpu"))


# phase 12's commands: each launches a kernel on the card
CLI_CARD_RUNS = {
    "count": ["count", "{in}/reads.fq", "-k", "12", "--canonical", "--skip-invalid"],
    "count_k21": ["count", "{in}/reads.fq", "-k", "21", "--skip-invalid", "--min-count", "2"],
    "spectrum": ["spectrum", "{in}/ref.fa", "-k", "8"],
    "search_64": ["search", "{in}/db.fq", "{in}/q64.fa", "--n-bases", "150", "-n", "5"],
    "search_3": ["search", "{in}/db.fq", "{in}/q3.fa", "--n-bases", "150", "-n", "5"],
    "pack": ["pack", "{in}/clean.fq", "-o", "{out}/p.npz"],
    "unpack": ["unpack", "{in}/clean.npz"],
    "setop": ["setop", "subtract", "{in}/reads.fq", "{in}/ref.fa", "-k", "21", "--canonical",
              "--skip-invalid"],
    "align_fit": ["align", "{in}/q64.fa", "{in}/target.fa", "--mode", "fit"],
    "align_local": ["align", "{in}/q64.fa", "{in}/target.fa", "--mode", "local"],
    "map": ["map", "{in}/ref.fa", "{in}/reads.fq"],
    "map_sam": ["map", "{in}/ref.fa", "{in}/reads.fq", "--sam"],
    "map_paired": ["map", "{in}/ref.fa", "{in}/r1.fq", "--paired", "{in}/r2.fq", "--sam"],
    "map_long": ["map", "{in}/ref.fa", "{in}/long.fq", "--long", "--all"],
    "call": ["call", "{in}/ref.fa", "{in}/reads.fq", "--vcf", "--consensus", "{out}/c.fa"],
    "merge": ["merge", "{in}/r1.fq", "{in}/r2.fq", "--unmerged", "{out}/u.fa"],
    "orf": ["orf", "{in}/reads.fq", "--translate"],
    "correct": ["correct", "{in}/reads.fq", "-k", "21"],
    "assemble": ["assemble", "{in}/reads.fq", "-k", "21", "--skip-invalid", "--gfa",
                 "{out}/a.gfa"],
}


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_card_in")
    _cli_inputs(d)
    return d


def _cli_bytes(argv, d_in, d_out, capsysbinary):
    from bitnuc_tpu_torch import cli

    d_out.mkdir()
    argv = [a.replace("{in}", str(d_in)).replace("{out}", str(d_out)) for a in argv]
    assert cli.main(argv) == 0
    out = capsysbinary.readouterr()
    files = {p.name: p.read_bytes() for p in sorted(d_out.iterdir()) if p.suffix != ".npz"}
    for p in d_out.glob("*.npz"):
        with np.load(p) as z:
            files[p.name] = {k: z[k].tobytes() for k in z.files}
    return out.out, out.err.replace(str(d_out).encode(), b"{out}"), files


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLI_CARD_RUNS))
def test_cli_on_card_matches_cpu(cuda, cli_inputs, tmp_path, capsysbinary, name):
    """The command with the default device (the card) writes the bytes it
    writes with --device cpu, and launches a kernel."""
    argv = CLI_CARD_RUNS[name]
    want = _cli_bytes(["--device", "cpu", *argv], cli_inputs, tmp_path / "cpu", capsysbinary)
    kernels.reset_launches()
    got = _cli_bytes(argv, cli_inputs, tmp_path / "card", capsysbinary)
    assert sum(kernels.LAUNCHES.values()) > 0
    assert got == want and (got[0] or got[2])


# -- the mesh paths on shards of the card ---------------------------------------------


def _card_mesh(cuda, n):
    from bitnuc_tpu_torch.parallel import mesh as pmesh

    return pmesh.make_mesh((n,), ("data",), devices=[cuda] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("k,use_bv", [(8, False), (12, True), (5, True)])
def test_count_kmers_sharded_on_card(cuda, n, k, use_bv):
    """One K3b (or K3a with a mask) launch a shard; the psum equals the
    unsharded count, on the card."""
    from bitnuc_tpu_torch import parallel
    from bitnuc_tpu_torch.parallel import mesh as pmesh
    from bitnuc_tpu_torch.sequence import PackedReads

    a, lens = _reads_on(cuda, 1001, 150, 40 + k)
    words, _ = codec.encode_reads(a, lens)
    bv = (a != ord("N")) if use_bv else None
    mesh = _card_mesh(cuda, n)
    sh = parallel.shard_reads(PackedReads(words=words, lengths=lens), mesh)
    bvs = pmesh.pad_rows(bv, sh.batch_size) if use_bv else None
    kernels.reset_launches()
    got = parallel.count_kmers_sharded(sh.words, sh.lengths, k, mesh, base_valid=bvs)
    launched = dict(kernels.LAUNCHES)
    assert launched["hist_keys" if use_bv else "hist_words"] == n
    assert got.is_cuda and torch.equal(got, kmer.count_kmers_dense(words, lens, k, False, bv))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("Q,k", [(1, 10), (8, 10), (64, 32), (40, 40)])
def test_search_mesh_on_card(cuda, n, Q, k):
    """PackedDB.search / search_batch on n shards of the card (the last
    slab padded) equal the unsharded search; the fused tc_search runs on
    every slab, the padded one over its real columns."""
    from bitnuc_tpu_torch.database import PackedDB, SEARCH_TC_MIN_Q

    g = torch.Generator().manual_seed(Q + k + n)
    D, W = 40_001, 8
    db = torch.randint(-(2**31), 2**31 - 1, (W, 5), generator=g, dtype=torch.int32)
    db = db[:, torch.randint(0, 5, (D,), generator=g)].contiguous().to(cuda)  # ties
    qs = torch.randint(-(2**31), 2**31 - 1, (Q, W), generator=g, dtype=torch.int32).to(cuda)
    pdb = PackedDB(words_wm=db, n_bases=120)
    mesh = _card_mesh(cuda, n)
    kernels.reset_launches()
    got = pdb.search_batch(qs, k, mesh=mesh)
    launched = dict(kernels.LAUNCHES)
    want = pdb.search_batch(qs, k)
    assert all(t.is_cuda for t in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fused = Q >= SEARCH_TC_MIN_Q and k <= hamming.SEARCH_TOPK_MAX
    assert launched["tc_search"] == (n if fused else 0)
    one = pdb.search(qs[0], k, mesh=mesh)
    assert torch.equal(one[0], pdb.search(qs[0], k)[0])
    assert torch.equal(one[1], pdb.search(qs[0], k)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
def test_sorted_and_seq_sharded_on_card(cuda, n):
    from bitnuc_tpu_torch import parallel

    a, lens = _reads_on(cuda, 513, 150, 7)
    words, _ = codec.encode_reads(a, lens)
    mesh = _card_mesh(cuda, n)
    got = parallel.count_kmers_sorted_sharded(words[:512], lens[:512], 21, mesh)
    cpu = parallel.count_kmers_sorted_sharded(words[:512].cpu(), lens[:512].cpu(), 21,
                                              _card_mesh(torch.device("cpu"), n))
    for x, y in zip(got, cpu):
        assert x.is_cuda and torch.equal(x.cpu(), y)
    seq = words[0, :8].repeat(n * 16)  # [n * 128] words
    total = seq.shape[0] * 16 - 9
    kernels.reset_launches()
    h = parallel.count_kmers_seqsharded(seq, total, 11, mesh, "data")
    assert kernels.LAUNCHES["hist_keys"] == n
    assert torch.equal(h.cpu(), parallel.count_kmers_seqsharded(
        seq.cpu(), total, 11, _card_mesh(torch.device("cpu"), n), "data"))


@pytest.mark.cuda
def test_map_reads_mesh_on_card(cuda):
    """map_reads and map_reads_long on 4 shards of the card equal the
    unsharded runs; K8 and C1 launch on every shard."""
    from bitnuc_tpu_torch import mapper
    from bitnuc_tpu_torch.sequence import PackedReads

    reads, genome = _genome_reads(15, 301, 150, genome_bp=20_000, sub=0.01, n_rate=0.0)
    idx = mapper.MinimizerIndex.build(genome.tobytes(), device=cuda)
    pr = PackedReads.from_ascii(reads, np.full(len(reads), 150, np.int32), validate=False,
                                device=cuda)
    mesh = _card_mesh(cuda, 4)
    want = mapper.map_reads(idx, pr)
    kernels.reset_launches()
    got = mapper.map_reads(idx, pr, mesh=mesh)
    assert kernels.LAUNCHES["fit_banded"] >= 4
    for f in want:
        assert np.array_equal(got[f], want[f]), f
    want = mapper.map_reads_long(idx, pr, min_chain=3)
    kernels.reset_launches()
    got = mapper.map_reads_long(idx, pr, min_chain=3, mesh=mesh)
    assert kernels.LAUNCHES["chain"] >= 4
    for f in want:
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.cuda
def test_nccl_psum_in_one_process_group(cuda, tmp_path):
    """runtime.initialize on the card joins an NCCL group; a psum of a CUDA
    tensor crosses it and stays on the card."""
    import os
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = (
        "import torch\n"
        "from bitnuc_tpu_torch.parallel import mesh as pmesh, runtime\n"
        f"runtime.initialize('127.0.0.1:{port}', 1, 0, timeout_s=60)\n"
        "assert torch.distributed.get_backend() == 'nccl'\n"
        "m = pmesh.make_mesh((2,), devices=[torch.device('cuda')] * 2)\n"
        "x = [torch.tensor([1, 2], device='cuda'), torch.tensor([3, 4], device='cuda')]\n"
        "y = pmesh.psum(x, m, 'data')\n"
        "assert y[0].is_cuda and y[0].tolist() == [4, 6], y\n"
        "runtime.shutdown()\n"
        "print('NCCL_OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "NCCL_OK" in res.stdout, res.stderr
