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

The JAX package runs the DP as a ``lax.scan`` over the sorted anchors,
carrying a [B, lookback] ring of (f, r, q, sr, sq), which XLA compiles into
one device loop. Eager PyTorch has no such loop, so the scan is a
hand-written kernel on the card (C1 ``chain``, ``csrc/chain.cu``, one warp
a row) with a plain PyTorch loop beside it that transcribes the scan step
for step (``chain_sorted_torch``). The row sort comes first in both, with
``torch.sort`` over one int64 key a row: (r << 32) + (q + 2^31) orders the
signed pairs (r, q) as the JAX package's two-key sort does. Invalid
anchors become (2^30, 2^30) and sort last; every anchor with r >= 2^30 is
dead (it never extends a chain or becomes a predecessor), so both versions
stop at the last row's first dead anchor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import config, kernels
from ..kernels import _build

_BIG = 2**30
_NEG = -(2**30)
# The kernel keeps a warp's ring, five int32 columns of `lookback` slots, in
# shared memory: at most 227 KB for one block of one warp.
RING_COLUMNS = 5
MAX_SMEM_BYTES = 227 * 1024
MAX_LOOKBACK = MAX_SMEM_BYTES // (4 * RING_COLUMNS)


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


def chain_sorted_kernel(r: torch.Tensor, q: torch.Tensor, max_gap=512, gap_unit=8,
                        lookback: int = 64):
    """C1 on the card (``csrc/chain.cu``): the scan of chain_sorted_torch
    over contiguous int32 CUDA anchors [B, A] sorted by ``sort_anchors``.
    Raises when the ring of min(lookback, A) slots does not fit in shared
    memory (lookback <= MAX_LOOKBACK always fits)."""
    max_gap, gap_unit, lookback = _check_params(max_gap, gap_unit, lookback)
    kernels.require(r, "chain r", torch.int32, 2)
    kernels.require(q, "chain q", torch.int32, 2)
    if q.shape != r.shape or q.device != r.device:
        raise ValueError("chain: r and q need one shape and one device")
    B, A = r.shape
    LB = min(lookback, A)
    if RING_COLUMNS * 4 * LB > MAX_SMEM_BYTES:
        raise ValueError(
            f"chain: a ring of {LB} slots needs {RING_COLUMNS * 4 * LB} bytes of shared "
            f"memory, over the limit of {MAX_SMEM_BYTES} bytes (lookback <= {MAX_LOOKBACK})")
    outs = tuple(torch.empty(B, dtype=torch.int32, device=r.device) for _ in range(5))
    code = _build.library().bn_chain(
        r.data_ptr(), q.data_ptr(), B, A, max_gap, gap_unit, LB,
        *(o.data_ptr() for o in outs), kernels.stream_handle(r.device),
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
        r, q = sort_anchors(rpos, qpos, valid)
        return chain_sorted_kernel(r.contiguous(), q.contiguous(), max_gap, gap_unit, lookback)
    return chain_anchors_torch(rpos, qpos, valid, max_gap, gap_unit, lookback)
