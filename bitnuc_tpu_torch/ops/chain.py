"""Collinear anchor chaining (the minimap2 chaining DP).

The counterpart of ``bitnuc_tpu/ops/chain.py``. Given seed anchors
(rpos, qpos) of each row, ``chain_anchors`` finds the best strictly
increasing chain under a gap penalty and reports its score and its first
and last anchors:

  f(i) = 1 + max(0, max_j f(j) - |dr - dq| // gap_unit)

over the predecessors j among the previous ``lookback`` anchors in (r, q)
order with 0 < dr = r_i - r_j <= max_gap and 0 < dq = q_i - q_j <= max_gap;
an anchor with no such predecessor starts a chain with f = 1. The
predecessor has the largest candidate score, then the largest r, then the
largest q; among the slots that tie on all three the chain start (sr, sq)
takes each column's max. A chain start is inherited only where the best
candidate is positive. The best anchor is the first, in sorted order, with
the largest f. Every difference wraps modulo 2^32, as the JAX package's
int32 arithmetic does.

The JAX package sorts each row and runs the DP as a ``lax.scan`` over it,
carrying a [B, lookback] ring of (f, r, q, sr, sq), which XLA compiles
into one device loop. Eager PyTorch has no such loop. On the card the whole
function is one hand-written kernel (C1 ``chain``, ``csrc/chain.cu``): a
warp a row compacts the row's live anchors into shared memory, sorts them
there and runs the scan with the ring in registers, from the unsorted
[B, A] inputs. The plain version (``chain_anchors_torch``) sorts each row
with ``torch.sort`` over one int64 key, (r << 32) + (q + 2^31), which orders
the signed pairs (r, q) as the JAX package's two-key sort does, then
transcribes the scan step for step (``chain_sorted_torch``). Invalid
anchors become (2^30, 2^30) and sort last; every anchor with r >= 2^30 is
dead (it never extends a chain or becomes a predecessor), so the plain
version stops at the last row's first dead anchor and the kernel keeps only
the live ones (valid and r < 2^30).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import config, kernels
from ..kernels import _build

_BIG = 2**30
_NEG = -(2**30)
# C1 keeps a ring of up to REG_LOOKBACK slots in registers. Above that its
# five int32 columns of `lookback` slots sit in one block's shared memory,
# at most 227 KB after a 16-byte header.
REG_LOOKBACK = 256
RING_COLUMNS = 5
MAX_SMEM_BYTES = 227 * 1024
MAX_LOOKBACK = (MAX_SMEM_BYTES - 16) // (4 * RING_COLUMNS)
# A warp sorts up to ROW_CAP live anchors in its slice of shared memory;
# a row with more goes to a block of its own, which sorts up to SMEM_KEYS
# in shared memory (with the ring in registers) and more in device memory.
ROW_CAP = 2016
SMEM_KEYS = (MAX_SMEM_BYTES - 16) // 8


def _check_params(max_gap, gap_unit, lookback) -> Tuple[int, int, int]:
    max_gap, gap_unit, lookback = int(max_gap), int(gap_unit), int(lookback)
    for name, v in (("max_gap", max_gap), ("gap_unit", gap_unit)):
        if not -(2**31) <= v < 2**31:
            raise ValueError(f"chain_anchors: {name} must fit int32, got {v}")
    if gap_unit == 0:
        raise ValueError("chain_anchors: gap_unit must not be 0")
    if lookback < 1:
        raise ValueError(f"chain_anchors: lookback must be >= 1, got {lookback}")
    return max_gap, gap_unit, lookback


def gap_divider(gap_unit: int) -> Tuple[int, int, int]:
    """C1's division of a drift x in [0, 2^31) by gap_unit, chosen once a
    launch: (mode, magic, shift). Mode 0 is x >> shift for gap_unit =
    2^shift; mode 1 is umulhi(2x, magic) >> shift for another positive
    gap_unit, with shift = ceil(log2 gap_unit) and magic = ceil(2^(31 +
    shift) / gap_unit) < 2^32; mode 2 is the floor of x / gap_unit for a
    negative one."""
    d = int(gap_unit)
    if d > 0 and d & (d - 1) == 0:
        return 0, 0, d.bit_length() - 1
    if d > 0:
        shift = (d - 1).bit_length()
        return 1, -(-(1 << (31 + shift)) // d), shift
    return 2, 0, 0


def sort_anchors(rpos: torch.Tensor, qpos: torch.Tensor, valid: torch.Tensor):
    """(r, q) [B, A] int32: each row's anchors ascending by signed (r, q),
    invalid anchors as (2^30, 2^30)."""
    r = torch.where(valid, rpos.to(torch.int32), _BIG).to(torch.int64)
    q = torch.where(valid, qpos.to(torch.int32), _BIG).to(torch.int64)
    key = torch.sort(r * (1 << 32) + (q + (1 << 31)), dim=-1).values
    return (key >> 32).to(torch.int32), ((key & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _empty_best(B: int, device):
    """(score 0, start_r, end_r, start_q, end_q all -1), [B] int32 each."""
    z = torch.zeros(B, dtype=torch.int32, device=device)
    return (z,) + tuple(torch.full_like(z, -1) for _ in range(4))


def chain_sorted_torch(r: torch.Tensor, q: torch.Tensor, max_gap=512, gap_unit=8,
                       lookback: int = 64):
    """Plain version of C1: the scan of chain_anchors over sorted anchors
    (``sort_anchors``), one step an anchor. Returns (score, start_r, end_r,
    start_q, end_q), [B] int32 each."""
    max_gap, gap_unit, lookback = _check_params(max_gap, gap_unit, lookback)
    B, A = r.shape
    dev = r.device
    best = list(_empty_best(B, dev))
    LB = min(lookback, A)
    steps = int((r < _BIG).sum(-1).max()) if B and A else 0
    if not steps:
        return tuple(best)
    ring_f = torch.zeros((B, LB), dtype=torch.int32, device=dev)  # 0: an empty slot
    ring_r = torch.full((B, LB), _BIG, dtype=torch.int32, device=dev)
    ring_q = torch.full((B, LB), _BIG, dtype=torch.int32, device=dev)
    ring_sr = torch.full((B, LB), -1, dtype=torch.int32, device=dev)
    ring_sq = torch.full((B, LB), -1, dtype=torch.int32, device=dev)
    for i in range(steps):  # steps past every row's last live anchor change nothing
        ri, qi = r[:, i], q[:, i]
        live = ri < _BIG
        dr = ri[:, None] - ring_r
        dq = qi[:, None] - ring_q
        ok = (ring_f > 0) & (dr > 0) & (dq > 0) & (dr <= max_gap) & (dq <= max_gap)
        cand = torch.where(
            ok, ring_f - torch.div(torch.abs(dr - dq), gap_unit, rounding_mode="floor"), _NEG)
        pbest = cand.amax(1)
        has_pred = pbest > _NEG
        # the predecessor: max score, then largest r, then largest q
        sel = ok & (cand == pbest[:, None])
        pr = torch.where(sel, ring_r, -1).amax(1)
        sel = sel & (ring_r == pr[:, None])
        pq = torch.where(sel, ring_q, -1).amax(1)
        take = sel & (ring_q == pq[:, None])
        psr = torch.where(take, ring_sr, -1).amax(1)
        psq = torch.where(take, ring_sq, -1).amax(1)

        f_i = torch.where(has_pred, 1 + torch.clamp(pbest, min=0), 1).to(torch.int32)
        extend = has_pred & (pbest > 0)
        sr_i = torch.where(extend, psr, ri)
        sq_i = torch.where(extend, psq, qi)
        f_i = torch.where(live, f_i, 0)

        slot = i % LB
        ring_f[:, slot] = f_i
        ring_r[:, slot] = torch.where(live, ri, _BIG)
        ring_q[:, slot] = torch.where(live, qi, _BIG)
        ring_sr[:, slot] = sr_i
        ring_sq[:, slot] = sq_i

        better = live & (f_i > best[0])
        for j, v in enumerate((f_i, sr_i, ri, sq_i, qi)):
            best[j] = torch.where(better, v, best[j])
    return tuple(best)


def chain_anchors_kernel(rpos: torch.Tensor, qpos: torch.Tensor, valid: torch.Tensor,
                         max_gap=512, gap_unit=8, lookback: int = 64):
    """C1 on the card (``csrc/chain.cu``): chain_anchors of contiguous
    [B, A] CUDA tensors, rpos and qpos int32 and valid bool, in any order
    within a row. Raises when a ring of min(lookback, A) slots past
    REG_LOOKBACK does not fit in shared memory (lookback <= MAX_LOOKBACK
    always fits)."""
    max_gap, gap_unit, lookback = _check_params(max_gap, gap_unit, lookback)
    kernels.require(rpos, "chain rpos", torch.int32, 2)
    kernels.require(qpos, "chain qpos", torch.int32, 2)
    kernels.require(valid, "chain valid", torch.bool, 2)
    if not (rpos.shape == qpos.shape == valid.shape
            and rpos.device == qpos.device == valid.device):
        raise ValueError("chain: rpos, qpos and valid need one shape and one device")
    B, A = rpos.shape
    LB = min(lookback, A)
    if LB > REG_LOOKBACK and RING_COLUMNS * 4 * LB + 16 > MAX_SMEM_BYTES:
        raise ValueError(
            f"chain: a ring of {LB} slots needs {RING_COLUMNS * 4 * LB} bytes of shared "
            f"memory, over the limit of {MAX_SMEM_BYTES - 16} bytes (lookback <= {MAX_LOOKBACK})")
    mode, magic, shift = gap_divider(gap_unit)
    lib = _build.library()
    nbytes = ctypes.c_int64()
    _build.check(lib.bn_chain_scratch(B, A, ctypes.byref(nbytes)), "chain scratch")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=rpos.device)
    outs = tuple(torch.empty(B, dtype=torch.int32, device=rpos.device) for _ in range(5))
    code = lib.bn_chain(
        rpos.data_ptr(), qpos.data_ptr(), valid.data_ptr(), B, A, max_gap, mode, magic, shift,
        gap_unit, LB, scratch.data_ptr(), *(o.data_ptr() for o in outs),
        kernels.stream_handle(rpos.device),
    )
    _build.check(code, "chain")
    kernels.LAUNCHES["chain"] += 1
    return outs


def chain_anchors_torch(rpos, qpos, valid, max_gap=512, gap_unit=8, lookback: int = 64):
    """Plain chain_anchors: the row sort, then chain_sorted_torch."""
    r, q = sort_anchors(rpos, qpos, valid)
    return chain_sorted_torch(r, q, max_gap, gap_unit, lookback)


def chain_anchors(
    rpos: torch.Tensor,
    qpos: torch.Tensor,
    valid: torch.Tensor,
    max_gap=512,
    gap_unit=8,
    lookback: int = 64,
):
    """Best anchor chain of each row.

    rpos/qpos: [B, A] int32 anchor coordinates (reference / query), in any
    order within a row; valid: [B, A] bool. Returns (score, start_r, end_r,
    start_q, end_q), [B] int32 each: the chain's anchor count net of gap
    penalties and its first and last anchor coordinates (inclusive); a row
    with no live anchor has score 0 and -1 coordinates. Dispatches C1 on
    CUDA tensors (see ``config``)."""
    rpos, qpos = torch.as_tensor(rpos), torch.as_tensor(qpos)
    valid = torch.as_tensor(valid).to(torch.bool)
    if config.use_kernel(rpos):
        return chain_anchors_kernel(rpos.to(torch.int32).contiguous(),
                                    qpos.to(torch.int32).contiguous(), valid.contiguous(),
                                    max_gap, gap_unit, lookback)
    return chain_anchors_torch(rpos, qpos, valid, max_gap, gap_unit, lookback)
