"""Per-base Hamming distance on packed words, and exact top-k.

The counterpart of ``bitnuc_tpu/ops/hamming.py``. XOR the packed streams,
collapse each 2-bit group to one bit (lower | upper>>1), mask to the valid
length, popcount, sum over words.

The database scan over a word-major [W, D] database (``PackedDB``) runs
the hand-written K4/K5 kernel (``csrc/hamming.cu``) on CUDA tensors and its
plain version ``hdist_scan_torch`` on CPU tensors. The row-major helpers
(``hdist_words``, ``hdist_one_to_many``, ``hdist_many_to_many``) are plain
PyTorch, as their JAX counterparts are plain XLA.

Top-k is plain PyTorch, as in the JAX package. ``torch.topk`` gives no tie
order, so each (value, index) pair is packed into one int64 key,
value << 32 | index: the keys are unique, and ordering them orders by value
and then by lowest index. Results are ascending; past the input's size the
tail is (2^30, -1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

TOPK_CHUNK = 512  # columns per stage-1 chunk of topk_smallest_batch
_BIG = 2**30  # sentinel distance of the top-k tail


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
    """K4/K5 on the card (``csrc/hamming.cu``); K4 is the Q = 1 case."""
    kernels.require(queries, "hdist_scan queries", torch.int32, 2)
    kernels.require(db_wm, "hdist_scan db", torch.int32, 2)
    _check_scan(queries, db_wm)
    if queries.device != db_wm.device:
        raise ValueError("hdist_scan: queries and db must be on one device")
    Q, W = queries.shape
    D = db_wm.shape[1]
    nb = max(min(int(n_bases), 16 * W), 0)
    out = torch.empty((Q, D), dtype=torch.int32, device=db_wm.device)
    code = _build.library().bn_hdist_scan(
        queries.data_ptr(), db_wm.data_ptr(), Q, W, D, nb, out.data_ptr(),
        kernels.stream_handle(db_wm.device),
    )
    _build.check(code, "hdist_scan")
    kernels.LAUNCHES["hdist_scan"] += 1
    return out


def hdist_scan(queries: torch.Tensor, db_wm: torch.Tensor, n_bases: int) -> torch.Tensor:
    """Backend-dispatching K4/K5: [Q, W] x [W, D] -> [Q, D] int32."""
    if config.use_kernel(db_wm):
        return hdist_scan_kernel(
            queries.to(torch.int32).contiguous(), db_wm.contiguous(), n_bases
        )
    return hdist_scan_torch(queries, db_wm, n_bases)


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


def topk_batch_dispatch(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of a [Q, D] distance matrix.

    The JAX package chooses here between a one-pass extractor whose u32
    keys bound (value bits + index bits) and a per-row loop. The int64 keys
    of this port hold any int32 value beside a 32-bit index, so the one
    path serves every input."""
    return topk_smallest_batch(d, k)


def hdist_topk(query: torch.Tensor, database: torch.Tensor, n_bases, k: int):
    """Top-k nearest rows of a row-major [D, W] database: (distances [k],
    indices [k]), ascending, ties by index."""
    return topk_smallest(hdist_one_to_many(query, database, n_bases), k)
