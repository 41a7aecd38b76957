"""Per-base Hamming distance on packed words, and exact top-k.

The counterpart of ``bitnuc_tpu/ops/hamming.py``. XOR the packed streams,
collapse each 2-bit group to one bit (lower | upper>>1), mask to the valid
length, popcount, sum over words.

The database scan over a word-major [W, D] database (``PackedDB``) runs
the hand-written K4/K5 kernel (``csrc/hamming.cu``) on CUDA tensors and its
plain version ``hdist_scan_torch`` on CPU tensors; for many queries K6
(``csrc/tcscan.cu``, plain version ``hdist_scan_tc_torch``) computes the
same distances as an int8 tensor-core product of +-1 bit planes, and its
search form (``hdist_search_tc``, plain version ``hdist_search_tc_torch``)
keeps each query's k nearest entries in the kernel, so a many-query search
never builds the [Q, D] matrix. The row-major helpers
(``hdist_words``, ``hdist_one_to_many``, ``hdist_many_to_many``) are plain
PyTorch, as their JAX counterparts are plain XLA.

Top-k is plain PyTorch, as in the JAX package. ``torch.topk`` gives no tie
order, so each (value, index) pair is packed into one int64 key,
value << 32 | index: the keys are unique, and ordering them orders by value
and then by lowest index. Results are ascending; past the input's size the
tail is (2^30, -1).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

TOPK_CHUNK = 512  # columns per stage-1 chunk of topk_smallest_batch
_BIG = 2**30  # sentinel distance of the top-k tail


def _clamp_nb(n_bases, W: int) -> int:
    """n_bases clamped to [0, 16 W]: bases past the words count as none."""
    return max(min(int(n_bases), 16 * W), 0)


def _n_bases_tensor(n_bases, device) -> torch.Tensor:
    return torch.as_tensor(n_bases, dtype=torch.int32, device=device)


def hdist_words(words1: torch.Tensor, words2: torch.Tensor, n_bases) -> torch.Tensor:
    """Per-base Hamming distance between paired packed reads: [..., W]
    words, n_bases [...] (or scalar) -> [...] int32."""
    W = words1.shape[-1]
    mask = bitops.word_valid_mask(W, _n_bases_tensor(n_bases, words1.device))
    diff = bitops.basewise_diff(words1, words2) & mask
    return bitops.popcount32(diff).sum(-1, dtype=torch.int32)


def hdist_one_to_many(query: torch.Tensor, database: torch.Tensor, n_bases) -> torch.Tensor:
    """Distance from one packed query [W] to every row of [D, W]."""
    return hdist_words(query[None, :], database, n_bases)


def hdist_many_to_many(queries: torch.Tensor, database: torch.Tensor, n_bases) -> torch.Tensor:
    """All-pairs distances [Q, W] x [D, W] -> [Q, D] int32, one database
    pass per query (the [Q, D, W] broadcast is never built)."""
    rows = [hdist_one_to_many(q, database, n_bases) for q in queries]
    if not rows:
        return torch.zeros((0, database.shape[0]), dtype=torch.int32, device=database.device)
    return torch.stack(rows)


# -- K4/K5: scan of a word-major database ---------------------------------------


def _check_scan(queries: torch.Tensor, db_wm: torch.Tensor) -> None:
    if queries.ndim != 2 or db_wm.ndim != 2 or queries.shape[1] != db_wm.shape[0]:
        raise ValueError(
            f"hdist_scan: queries [Q, W] and db [W, D] must share W, got "
            f"{tuple(queries.shape)} and {tuple(db_wm.shape)}"
        )


def hdist_scan_torch(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int) -> torch.Tensor:
    """Plain version of K4/K5: [Q, W] queries x [W, D] word-major db ->
    [Q, D] int32 distances over the first n_bases bases."""
    _check_scan(queries, db_wm)
    W, D = db_wm.shape
    masks = bitops.word_valid_mask(W, _n_bases_tensor(n_bases, db_wm.device))
    out = torch.zeros((queries.shape[0], D), dtype=torch.int32, device=db_wm.device)
    for w in range(min(W, -(-max(int(n_bases), 0) // 16))):
        x = (db_wm[w] & masks[w])[None, :]
        q = (queries[:, w] & masks[w])[:, None]
        out += bitops.popcount32(bitops.basewise_diff(x, q))
    return out


def hdist_scan_kernel(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int) -> torch.Tensor:
    """K4/K5 on the card (``csrc/hamming.cu``). K4 is the Q = 1 case and
    counts under ``hdist_scan``; K5, any other Q, under
    ``hdist_scan_batch``."""
    kernels.require(queries, "hdist_scan queries", torch.int32, 2)
    kernels.require(db_wm, "hdist_scan db", torch.int32, 2)
    _check_scan(queries, db_wm)
    if queries.device != db_wm.device:
        raise ValueError("hdist_scan: queries and db must be on one device")
    Q, W = queries.shape
    D = db_wm.shape[1]
    nb = _clamp_nb(n_bases, W)
    out = torch.empty((Q, D), dtype=torch.int32, device=db_wm.device)
    code = _build.library().bn_hdist_scan(
        queries.data_ptr(), db_wm.data_ptr(), Q, W, D, nb, out.data_ptr(),
        kernels.stream_handle(db_wm.device),
    )
    _build.check(code, "hdist_scan")
    kernels.LAUNCHES["hdist_scan" if Q == 1 else "hdist_scan_batch"] += 1
    return out


def hdist_scan(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int) -> torch.Tensor:
    """Backend-dispatching K4/K5: [Q, W] x [W, D] -> [Q, D] int32."""
    if config.use_kernel(db_wm):
        return hdist_scan_kernel(
            queries.to(torch.int32).contiguous(), db_wm.contiguous(), n_bases
        )
    return hdist_scan_torch(queries, db_wm, n_bases)


# -- K6: the same scan on the tensor cores ---------------------------------------
#
# With x0, x1 the +-1 codes of a base's two bits and x01 = x0 * x1, two
# bases match iff 1 + x0q x0d + x1q x1d + x01q x01d = 4, and it is 0
# otherwise. So over the first nb bases, S = sum (x0q x0d + x1q x1d +
# x01q x01d) = 4 matches - nb, and the distance is (3 nb - S) / 4: one
# int8 matrix product [Q, 48W] x [48W, D] with an int32 sum. The query
# planes are zero past nb, so the database side needs no mask.
#
# Plane order (both sides): the words in pairs p (an odd W gets a zero
# word), then the group g (x0, x1, x01), then the pair's 32 bases: column
# 96 p + 32 g + j holds base 32 p + j. A step of 32 columns is then one
# group of one word pair, which is what a k-step of the kernel's
# wgmma.m64nNk32 reads: the database entries are its M rows (expanded in
# registers), the queries its N columns (read from shared memory).

TC_CHUNK = 65536  # database entries per product of the plain version


def _planes(codes: torch.Tensor, valid=None) -> torch.Tensor:
    """[R, 16W] codes -> [R, 96 ceil(W / 2)] int8 planes in the order
    above; zero where ``valid`` [16W] is False."""
    R, L = codes.shape
    P = -(-L // 32)
    codes = torch.nn.functional.pad(codes, (0, 32 * P - L))
    b0, b1 = codes & 1, (codes >> 1) & 1
    planes = torch.stack([2 * b0 - 1, 2 * b1 - 1, 1 - 2 * (b0 ^ b1)], 1)  # [R, 3, 32P]
    if valid is not None:
        planes = planes * torch.nn.functional.pad(valid, (0, 32 * P - L)).to(planes.dtype)
    planes = planes.reshape(R, 3, P, 32).transpose(1, 2)  # [R, P, 3, 32]
    return planes.reshape(R, 96 * P).to(torch.int8)


def query_planes(queries: torch.Tensor, n_bases) -> torch.Tensor:
    """[Q, W] packed queries -> [Q, 96 ceil(W / 2)] int8 +-1 planes of
    their first n_bases bases, zero past them."""
    W = queries.shape[1]
    pos = torch.arange(16 * W, device=queries.device)
    return _planes(bitops.unpack_words(queries), pos < _clamp_nb(n_bases, W))


def hdist_scan_tc_torch(queries: torch.Tensor, db_wm: torch.Tensor, n_bases) -> torch.Tensor:
    """Plain version of K6: the plane identity with float32 products (exact:
    every term is 0 or +-1 and |S| <= 48W < 2^24), TC_CHUNK database
    entries at a time. Equal to hdist_scan_torch and hdist_many_to_many."""
    _check_scan(queries, db_wm)
    W, D = db_wm.shape
    nb = _clamp_nb(n_bases, W)
    qp = query_planes(queries, nb).to(torch.float32)
    out = torch.empty((queries.shape[0], D), dtype=torch.int32, device=db_wm.device)
    for d0 in range(0, D, TC_CHUNK):
        dp = _planes(bitops.unpack_words(db_wm[:, d0 : d0 + TC_CHUNK].t()))
        s = qp @ dp.to(torch.float32).t()
        out[:, d0 : d0 + TC_CHUNK] = torch.div(3 * nb - s.to(torch.int32), 4,
                                               rounding_mode="floor")
    return out


TC_TILE_N = (8, 32, 64, 128, 256)  # the kernel's query-tile widths
B_LBO = 128  # bytes between the two 16-byte k halves of a group of 8 query rows
B_SBO = 256  # bytes between groups of 8 query rows
_TILE_M = 128  # database entries of a K6 block tile


def _tile_n(Q: int) -> int:
    """The kernel's query-tile width for Q queries: the smallest of
    TC_TILE_N that covers Q, else 256 (and ceil(Q / 256) tiles)."""
    return next((n for n in TC_TILE_N if n >= Q), TC_TILE_N[-1])


def _b_stages(planes: torch.Tensor, N: int) -> torch.Tensor:
    """Query planes [Q, 96P] int8 -> the shared-memory image of K6's B
    operand, one contiguous stage for each (query tile, word pair): [ceil(Q /
    N), P, 3 k-steps, N / 8, 2, 8, 16] int8. A k-step's tile is K-major core
    matrices of 8 query rows x 16 bytes, without swizzle: byte (n, j) at
    (n // 8) B_SBO + (j // 16) B_LBO + (n % 8) 16 + j % 16. Rows past Q are
    zero."""
    Q, K = planes.shape
    P = K // 96
    n_qt = max(1, -(-Q // N))
    b = torch.nn.functional.pad(planes, (0, 0, 0, n_qt * N - Q))
    b = b.reshape(n_qt, N // 8, 8, P, 3, 2, 16)  # tile, row group, row, pair, step, k half, byte
    return b.permute(0, 3, 4, 1, 5, 2, 6).contiguous()


_OCCUPANCY = {}


def _blocks_per_sm(N: int, search: bool, k: int = 1) -> int:
    """Blocks of the K6 kernel at tile width N that fit an SM, as the card
    reports it (``bn_tc_blocks_per_sm``)."""
    key = (N, bool(search), k if search else 1)
    if key not in _OCCUPANCY:
        n = ctypes.c_int(0)
        code = _build.library().bn_tc_blocks_per_sm(N, int(search), key[2], ctypes.addressof(n))
        _build.check(code, "tc_blocks_per_sm")
        _OCCUPANCY[key] = max(1, n.value)
    return _OCCUPANCY[key]


def _tile_grid(n_qt: int, D: int, n_sm: int, blocks_per_sm: int) -> Tuple[int, int]:
    """K6's persistent schedule: (G, tiles a block). Each of the n_qt query
    tiles gets G blocks, block g walking the contiguous 128-entry tiles [g
    per_block, (g + 1) per_block), so that about one wave of blocks_per_sm
    blocks an SM runs and none is empty."""
    n_mt = max(1, -(-D // _TILE_M))
    want = max(1, -(-blocks_per_sm * n_sm // n_qt))
    per_block = -(-n_mt // min(want, n_mt))
    return -(-n_mt // per_block), per_block


def _k6_launch(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int, what: str,
               k: int = 1):
    """What both K6 entry points need: (B stages, nb, N, G, per_block)."""
    kernels.require(queries, f"{what} queries", torch.int32, 2)
    kernels.require(db_wm, f"{what} db", torch.int32, 2)
    _check_scan(queries, db_wm)
    if queries.device != db_wm.device:
        raise ValueError(f"{what}: queries and db must be on one device")
    Q, W = queries.shape
    nb = _clamp_nb(n_bases, W)
    N = _tile_n(Q)
    stages = _b_stages(query_planes(queries, nb), N)
    n_sm = torch.cuda.get_device_properties(db_wm.device).multi_processor_count
    G, per_block = _tile_grid(stages.shape[0], db_wm.shape[1], n_sm,
                              _blocks_per_sm(N, what == "tc_search", k))
    return stages, nb, N, G, per_block


def hdist_scan_tc_kernel(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int) -> torch.Tensor:
    """K6 on the card (``csrc/tcscan.cu``): [Q, W] x [W, D] int32 words ->
    [Q, D] int32, int8 tensor-core products of the plane identity."""
    stages, nb, N, G, per_block = _k6_launch(queries, db_wm, n_bases, "tc_scan")
    Q, D = queries.shape[0], db_wm.shape[1]
    out = torch.empty((Q, D), dtype=torch.int32, device=db_wm.device)
    code = _build.library().bn_tc_scan(
        stages.data_ptr(), db_wm.data_ptr(), Q, queries.shape[1], D, nb, N, G, per_block,
        out.data_ptr(), kernels.stream_handle(db_wm.device),
    )
    _build.check(code, "tc_scan")
    kernels.LAUNCHES["tc_scan"] += 1
    return out


def hdist_scan_tc(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int) -> torch.Tensor:
    """Backend-dispatching K6: [Q, W] x [W, D] -> [Q, D] int32."""
    if config.use_kernel(db_wm):
        return hdist_scan_tc_kernel(
            queries.to(torch.int32).contiguous(), db_wm.contiguous(), n_bases
        )
    return hdist_scan_tc_torch(queries, db_wm, n_bases)


# -- top-k ------------------------------------------------------------------------


def _packed_keys(values: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    return values.to(torch.int64) * (1 << 32) + idx


def _unpack_keys(top: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed keys [..., m] -> (values, indices) [..., k], tail-filled."""
    m = top.shape[-1]
    lead = top.shape[:-1]
    dist = torch.full(lead + (k,), _BIG, dtype=torch.int32, device=top.device)
    idx = torch.full(lead + (k,), -1, dtype=torch.int32, device=top.device)
    dist[..., :m] = (top >> 32).to(torch.int32)  # arithmetic: floor for < 0
    idx[..., :m] = (top & 0xFFFFFFFF).to(torch.int32)
    return dist, idx


def topk_smallest(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k smallest of a 1-D int array with their indices, ascending,
    ties by lowest index; for k > n the tail is (2^30, -1)."""
    m = min(k, values.shape[0])
    top = torch.topk(_packed_keys(values), m, largest=False, sorted=True).values
    return _unpack_keys(top, k)


def topk_smallest_batch(
    values: torch.Tensor, k: int, chunk: int = TOPK_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest of a [Q, D] int array, each row ascending, ties
    by lowest index. Two stages: the k smallest of every ``chunk``-column
    block, then the k smallest of those candidates — every row's winners
    lie among their blocks' winners."""
    Q, D = values.shape
    m = min(k, D)
    keys = _packed_keys(values)
    if m == 0:
        return _unpack_keys(keys[:, :0], k)
    nC = -(-D // chunk)
    pad = nC * chunk - D
    if pad:  # (F.pad would round an int64 fill through float)
        fill = torch.full((Q, pad), torch.iinfo(torch.int64).max, device=keys.device)
        keys = torch.cat([keys, fill], dim=1)
    blocks = keys.reshape(Q, nC, chunk)
    cand = torch.topk(blocks, min(m, chunk), dim=-1, largest=False).values
    top = torch.topk(cand.reshape(Q, -1), m, dim=-1, largest=False, sorted=True).values
    return _unpack_keys(top, k)


def topk_batch_dispatch(d: torch.Tensor, k: int, n_bases=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of a [Q, D] distance matrix.

    The JAX package chooses here between a one-pass extractor whose u32
    keys must hold (value bits + index bits), which it checks against a
    concrete ``n_bases``, and a per-row loop. The int64 keys of this port
    hold any int32 value beside a 32-bit index, so no such test is needed:
    ``n_bases`` is accepted for JAX's signature and not read, and the one
    path serves every input."""
    return topk_smallest_batch(d, k)


# -- K6 with a top-k epilogue: the many-query search ------------------------------
#
# tc_search runs K6's main loop over a contiguous range of 128-entry tiles a
# block and keeps, for each query of the block's tile, the k smallest keys
# dist << 32 | index seen so far in shared memory (the keys of
# _packed_keys). The blocks' lists, [Q, G, k] int64 padded with INT64_MAX,
# are merged by one torch.topk (stage two).

SEARCH_TOPK_MAX = 32  # largest k of the fused search: the per-query lists share shared memory


def _merge_candidates(cand: torch.Tensor, k: int, D: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage two: the k smallest of each row's candidate keys [Q, ...]."""
    top = torch.topk(cand.reshape(cand.shape[0], -1), min(k, D), dim=-1, largest=False,
                     sorted=True).values
    return _unpack_keys(top, k)


def _check_search_k(k: int) -> None:
    if not 1 <= k <= SEARCH_TOPK_MAX:
        raise ValueError(f"tc_search: k must be in [1, {SEARCH_TOPK_MAX}], got {k}")


def hdist_search_tc_torch(queries: torch.Tensor, db_wm: torch.Tensor, n_bases,
                          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused search: hdist_scan_tc_torch on TC_CHUNK
    entries at a time, the k smallest keys of each chunk, then the k
    smallest of those. Equal to topk_smallest_batch of the whole matrix,
    which it never holds: (distances [Q, k], indices [Q, k]) int32,
    ascending, ties by lowest index, tail (2^30, -1) past D."""
    _check_scan(queries, db_wm)
    D = db_wm.shape[1]
    parts = [torch.zeros((queries.shape[0], 0), dtype=torch.int64, device=db_wm.device)]
    for d0 in range(0, D, TC_CHUNK):
        keys = _packed_keys(hdist_scan_tc_torch(queries, db_wm[:, d0 : d0 + TC_CHUNK], n_bases))
        parts.append(torch.topk(keys + d0, min(k, keys.shape[1]), dim=-1, largest=False).values)
    return _merge_candidates(torch.cat(parts, 1), k, D)


def tc_search_candidates(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int,
                         k: int) -> torch.Tensor:
    """The fused search kernel on the card (``csrc/tcscan.cu``,
    ``bn_tc_search``): [Q, W] x [W, D] int32 words -> each block's k
    smallest keys of each query, [Q, G, k] int64 padded with INT64_MAX."""
    _check_search_k(k)
    stages, nb, N, G, per_block = _k6_launch(queries, db_wm, n_bases, "tc_search", k)
    Q, W = queries.shape
    cand = torch.empty((Q, G, k), dtype=torch.int64, device=db_wm.device)
    code = _build.library().bn_tc_search(
        stages.data_ptr(), db_wm.data_ptr(), Q, W, db_wm.shape[1], nb, k, N, G, per_block,
        cand.data_ptr(), kernels.stream_handle(db_wm.device),
    )
    _build.check(code, "tc_search")
    kernels.LAUNCHES["tc_search"] += 1
    return cand


def hdist_search_tc_kernel(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused search on the card: tc_search, then stage two."""
    Q, D = queries.shape[0], db_wm.shape[1]
    if Q == 0 or D == 0:
        return _unpack_keys(torch.zeros((Q, 0), dtype=torch.int64, device=db_wm.device), k)
    return _merge_candidates(tc_search_candidates(queries, db_wm, n_bases, k), k, D)


def hdist_search_tc(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend-dispatching fused search: the k nearest entries of each
    query, 1 <= k <= SEARCH_TOPK_MAX on the card."""
    if config.use_kernel(db_wm):
        return hdist_search_tc_kernel(
            queries.to(torch.int32).contiguous(), db_wm.contiguous(), n_bases, k
        )
    return hdist_search_tc_torch(queries, db_wm, n_bases, k)


def hdist_topk(query: torch.Tensor, database: torch.Tensor, n_bases, k: int):
    """Top-k nearest rows of a row-major [D, W] database: (distances [k],
    indices [k]), ascending, ties by index."""
    return topk_smallest(hdist_one_to_many(query, database, n_bases), k)


def hdist_topk_batch_torch(queries: torch.Tensor, database: torch.Tensor, n_bases,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of hdist_topk_batch, the JAX package's composition:
    hdist_many_to_many, then topk_batch_dispatch."""
    return topk_batch_dispatch(hdist_many_to_many(queries, database, n_bases), k, n_bases)


def hdist_topk_batch(queries: torch.Tensor, database: torch.Tensor, n_bases,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k nearest rows of a row-major database: [Q, W] x [D,
    W] -> (distances [Q, k], indices [Q, k]), each row ascending, ties by
    lowest index; past D the tail is (2^30, -1).

    On the card the database is transposed to word-major once and searched
    as ``PackedDB.search_batch`` searches: the fused tc_search (K6) from
    ``database.SEARCH_TC_MIN_Q`` queries on for k <= SEARCH_TOPK_MAX, else
    K4/K5 (or K6 tc_scan) and the top-k. ``hdist_many_to_many`` would read
    the whole [D, W] database once a query. n_bases is one int there."""
    if not config.use_kernel(database):
        return hdist_topk_batch_torch(queries, database, n_bases, k)
    from ..database import PackedDB  # database imports this module

    db = PackedDB(words_wm=database.t().contiguous(), n_bases=int(n_bases))
    return db.search_batch(queries.to(torch.int32), k)
