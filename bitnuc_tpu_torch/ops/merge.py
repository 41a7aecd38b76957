"""Merge of two sorted lists of rows: K7 ``merge``.

The counterpart of ``bitnuc_tpu/ops/pallas/merge.py::merge_sorted``. Rows
are tuples of 1-D int32 columns (bit-views of the JAX package's uint32
and int32 columns); the first ``n_keys`` columns (1 to 3) are key words,
most significant first, compared as unsigned, and the rest ride along as
payloads. Each input is sorted ascending by its key words.

The result has next_pow2(na + nb) rows: rows [0, na + nb) are the stable
sort of concat(a, b) by the key words, so on equal keys the rows of ``a``
come first and each list keeps its own order; rows past that are padding
with all-ones key words and payloads from ``pad_val`` (default -1, the
all-ones word). The JAX package's bitonic merge equals this up to the order
of rows whose full keys tie, and places its padding among rows whose keys
are all-ones.

``merge_sorted_kernel`` runs the hand-written kernel (``csrc/merge.cu``, a
merge path: the output cut into tiles of ``tile_rows()`` rows, each merged
in shared memory) on CUDA tensors; ``merge_sorted_torch`` is its plain
version, a stable ``torch.sort`` over the unsigned keys. ``merge_sorted``
picks one by the device of the first column (see ``config``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

MAX_COLUMNS = 8  # key + payload columns a kernel launch takes


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _check_args(a, b, n_keys: int) -> Tuple[int, int]:
    if len(a) != len(b) or not 1 <= n_keys <= min(3, len(a)):
        raise ValueError(
            f"merge_sorted: a and b need the same columns and 1 <= n_keys <= 3 "
            f"key columns among them (got {len(a)}, {len(b)}, n_keys={n_keys})"
        )
    na, nb = int(a[0].shape[0]), int(b[0].shape[0])
    for x, y in zip(a, b):
        if x.ndim != 1 or y.ndim != 1 or x.shape[0] != na or y.shape[0] != nb:
            raise ValueError("merge_sorted: every column of a list needs its length, 1-D")
        if x.dtype != torch.int32 or y.dtype != torch.int32:
            raise TypeError(f"merge_sorted: columns must be int32, got {x.dtype}, {y.dtype}")
    return na, nb


def _pad_rows(outs, start: int, n_keys: int, pad_val) -> None:
    """Fill rows [start, len) of the output columns in place."""
    for i, o in enumerate(outs):
        if i < n_keys:
            fill = bitops.ALL_ONES
        elif pad_val is not None:
            fill = pad_val[i - n_keys]
        else:
            fill = -1
        o[start:].fill_(fill)


def merge_sorted_torch(
    a: Sequence[torch.Tensor],
    b: Sequence[torch.Tensor],
    n_keys: int,
    pad_val: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of K7: a stable sort of concat(a, b) by the unsigned
    key words, then the padding rows."""
    na, nb = _check_args(a, b, n_keys)
    n = next_pow2(max(na + nb, 1))
    cat = [torch.cat([x, y]) for x, y in zip(a, b)]
    keys = cat[:n_keys]
    sort_keys = []
    if n_keys >= 2:
        sort_keys.append(bitops.u64_sort_key(keys[0], keys[1]))
        sort_keys += [bitops.u32_sort_key(k) for k in keys[2:]]
    else:
        sort_keys.append(bitops.u32_sort_key(keys[0]))
    perm = bitops.lex_argsort(sort_keys)
    outs = [torch.empty(n, dtype=c.dtype, device=c.device) for c in cat]
    for o, c in zip(outs, cat):
        o[: na + nb] = c[perm]
    _pad_rows(outs, na + nb, n_keys, pad_val)
    return tuple(outs)


def tile_rows() -> int:
    """Output rows that one block of the kernel merges (card only: asks the
    built library)."""
    rows = ctypes.c_int64()
    _build.check(_build.library().bn_merge_tile(ctypes.byref(rows)), "merge tile")
    return rows.value


def merge_sorted_kernel(
    a: Sequence[torch.Tensor],
    b: Sequence[torch.Tensor],
    n_keys: int,
    pad_val: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """K7 on the card (``csrc/merge.cu``): contiguous 1-D int32 CUDA
    columns, at most MAX_COLUMNS of them, with the scratch of its tiles'
    splits (bytes as the library reports them)."""
    na, nb = _check_args(a, b, n_keys)
    if len(a) > MAX_COLUMNS:
        raise ValueError(f"merge: at most {MAX_COLUMNS} columns, got {len(a)}")
    for i, (x, y) in enumerate(zip(a, b)):
        kernels.require(x, f"merge a[{i}]", torch.int32, 1)
        kernels.require(y, f"merge b[{i}]", torch.int32, 1)
        if x.device != a[0].device or y.device != a[0].device:
            raise ValueError("merge: every column must lie on one device")
    n = next_pow2(max(na + nb, 1))
    outs = [torch.empty(n, dtype=torch.int32, device=x.device) for x in a]
    _pad_rows(outs, na + nb, n_keys, pad_val)
    lib = _build.library()
    nbytes = ctypes.c_int64()
    _build.check(lib.bn_merge_scratch(na, nb, ctypes.byref(nbytes)), "merge scratch")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=a[0].device)
    ptrs = ctypes.c_void_p * MAX_COLUMNS
    a_p = ptrs(*[x.data_ptr() for x in a])
    b_p = ptrs(*[y.data_ptr() for y in b])
    o_p = ptrs(*[o.data_ptr() for o in outs])
    code = lib.bn_merge(
        ctypes.addressof(a_p), ctypes.addressof(b_p), ctypes.addressof(o_p),
        len(a), n_keys, na, nb, scratch.data_ptr(), kernels.stream_handle(a[0].device),
    )
    _build.check(code, "merge")
    kernels.LAUNCHES["merge"] += 1
    return tuple(outs)


def merge_sorted(
    a: Sequence[torch.Tensor],
    b: Sequence[torch.Tensor],
    n_keys: int,
    pad_val: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Backend-dispatching K7: merge two sorted column tuples into
    next_pow2(len_a + len_b) rows (see the module docstring)."""
    if config.use_kernel(a[0]):
        return merge_sorted_kernel(
            [x.contiguous() for x in a], [y.contiguous() for y in b], n_keys, pad_val
        )
    return merge_sorted_torch(a, b, n_keys, pad_val)
