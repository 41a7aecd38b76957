"""Distributed Hamming-distance database search over a mesh of torch devices.

The counterpart of ``bitnuc_tpu/parallel/search.py``. Each device scans
its slab of the database through the port's routing (K4 for one query,
``PackedDB.search_batch`` for many: K5 below ``database.tc_min_q(W)``
queries and K6 from there, or the fused ``tc_search``), takes a local
top-k with global indices ``idx + shard * D_loc``, and the candidates are
gathered in mesh order and merged with one more ``topk_smallest``, so ties
break by the lowest global index, as on one device.

``d_valid`` (a database zero-padded to a device multiple) gives the
padding columns distance n_bases + 1 before a shard's top-k. The fused
``tc_search`` takes its top-k inside the kernel and knows no ``d_valid``,
so the shard that holds padding searches its real columns alone and
appends the padding columns its top-k would have taken: they rank after
every real column (distance n_bases + 1) in index order.

Replicated results are tensors on the mesh's first device; results that
the JAX package leaves sharded are ``parallel.mesh.Sharded``s.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops import hamming
from . import mesh as pmesh


def _mask_padding(d: torch.Tensor, offset: int, d_valid, n_bases: int) -> torch.Tensor:
    gidx = offset + torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    return torch.where(gidx < int(d_valid), d, int(n_bases) + 1)


def _merge_one(cand_d: torch.Tensor, cand_i: torch.Tensor, topk: int):
    dd, sel = hamming.topk_smallest(cand_d, min(topk, cand_d.shape[0]))
    return dd, cand_i[sel.to(torch.int64)]


def _merge_candidates_batch(cand_d, cand_i, mesh: pmesh.Mesh, topk: int, axis: str = None):
    """Gather per-device per-query candidate lists [Q, k_loc] along ``axis``
    (default: the mesh's only axis) in mesh order and take each query's
    final top-k: (distances [Q, topk], indices [Q, topk]) on the first
    device of each group, one pair per group."""
    axis = axis or mesh.axis_names[0]
    gd = pmesh.all_gather(cand_d, mesh, axis, dim=1)
    gi = pmesh.all_gather(cand_i, mesh, axis, dim=1)
    out = []
    for group in mesh.groups(axis):
        i = group[0]
        with pmesh.on_device(mesh.flat_devices[i]):
            k = min(topk, gd[i].shape[1])
            dd, sel = hamming.topk_smallest_batch(gd[i], k)
            out.append((dd, torch.gather(gi[i], 1, sel.to(torch.int64))))
    return out


def hdist_search_sharded(query, db_words, n_bases, topk: int, mesh: pmesh.Mesh,
                         axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows of a ROW-MAJOR database [D, W] sharded on ``axis``
    (D divisible by the axis size) to one packed query [W]. Each slab is
    scanned by K4 (word-major, one transpose a slab). Returns (distances
    [topk], global indices [topk]) ascending. Zero padding rows rank by
    their true distance."""
    slabs = pmesh.split(db_words, mesh, axis)
    qs = pmesh.replicate(query, mesh)
    D_loc = int(slabs[0].shape[0])
    k_loc = min(topk, D_loc)
    cand = []
    for d, q, db_loc, me in zip(mesh.flat_devices, qs, slabs, mesh.axis_index(axis)):
        with pmesh.on_device(d):
            dist = hamming.hdist_scan(q.reshape(1, -1), db_loc.t().contiguous(), int(n_bases))
            dd, idx = hamming.topk_smallest(dist[0], k_loc)
            cand.append((dd, idx + me * D_loc))
    cd, ci = (list(c) for c in zip(*cand))
    gd, gi = pmesh.all_gather(cd, mesh, axis), pmesh.all_gather(ci, mesh, axis)
    return _merge_one(gd[0], gi[0], topk)


def hdist_search_batch_sharded(queries, db_words, n_bases, topk: int, mesh: pmesh.Mesh,
                               axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k over a sharded ROW-MAJOR database: queries [Q, W]
    replicated, db_words [D, W] sharded on ``axis``. Each device runs
    ``hamming.hdist_topk_batch`` on its slab. Returns (distances [Q, topk],
    global indices [Q, topk]), each row ascending, exactly
    ``hdist_topk_batch`` of the whole database."""
    slabs = pmesh.split(db_words, mesh, axis)
    qs = pmesh.replicate(queries, mesh)
    D_loc = int(slabs[0].shape[0])
    k_loc = min(topk, D_loc)
    cand = []
    for d, q, db_loc, me in zip(mesh.flat_devices, qs, slabs, mesh.axis_index(axis)):
        with pmesh.on_device(d):
            dd, idx = hamming.hdist_topk_batch(q, db_loc, n_bases, k_loc)
            cand.append((dd, idx + me * D_loc))
    cd, ci = (list(c) for c in zip(*cand))
    return _merge_candidates_batch(cd, ci, mesh, topk, axis)[0]


def _scan_slab(qs: torch.Tensor, db_loc_wm: torch.Tensor, n_bases: int, k_loc: int,
               offset: int, d_valid):
    """One slab's per-query top-k with global indices, through
    ``PackedDB.search_batch`` (the fused tc_search from SEARCH_TC_MIN_Q
    queries, else distances_batch and the top-k) over the slab's real
    columns; the padding columns it would take follow at n_bases + 1."""
    from ..database import PackedDB

    D_loc = int(db_loc_wm.shape[1])
    n_real = D_loc if d_valid is None else max(0, min(D_loc, int(d_valid) - offset))
    db = PackedDB(words_wm=db_loc_wm[:, :n_real], n_bases=int(n_bases))
    dd, idx = db.search_batch(qs, min(k_loc, n_real))
    extra = k_loc - dd.shape[1]
    if extra:
        Q = qs.shape[0]
        dd = torch.cat([dd, dd.new_full((Q, extra), int(n_bases) + 1)], 1)
        pad = torch.arange(n_real, n_real + extra, dtype=idx.dtype, device=idx.device)
        idx = torch.cat([idx, pad.expand(Q, extra)], 1)
    return dd, idx + offset


def hdist_search_batch_db_sharded(queries, db_words_wm, n_bases: int, topk: int,
                                  mesh: pmesh.Mesh, axis: str = "data", d_valid=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k over a sharded WORD-MAJOR database [W, D] (the
    PackedDB layout, columns sharded on ``axis``). d_valid: the count of
    real columns of a database zero-padded to a device multiple; padding
    columns rank at distance n_bases + 1. Returns (distances [Q, topk],
    global indices [Q, topk])."""
    slabs = pmesh.split(db_words_wm, mesh, axis, dim=1)
    qs = pmesh.replicate(queries, mesh)
    D_loc = int(slabs[0].shape[1])
    k_loc = min(topk, D_loc)
    cand = []
    for d, q, db_loc, me in zip(mesh.flat_devices, qs, slabs, mesh.axis_index(axis)):
        with pmesh.on_device(d):
            cand.append(_scan_slab(q, db_loc, n_bases, k_loc, me * D_loc, d_valid))
    cd, ci = (list(c) for c in zip(*cand))
    return _merge_candidates_batch(cd, ci, mesh, topk, axis)[0]


def hdist_search_grid(queries, db_words_wm, n_bases: int, topk: int, mesh: pmesh.Mesh,
                      qaxis: str = "data", daxis: str = "model", d_valid=None):
    """2-D sharded search: queries [Q, W] split over ``qaxis``, WORD-MAJOR
    database columns [W, D] over ``daxis``. Every device scans (its query
    slab x its database slab); the candidates merge along the database
    axis only, and the result stays split over ``qaxis``: (distances,
    global indices) ``Sharded``s of [Q, topk], each row equal to
    ``hdist_topk_batch`` of the whole database. d_valid as in
    hdist_search_batch_db_sharded."""
    q_slabs = pmesh.split(queries, mesh, qaxis)
    d_slabs = pmesh.split(db_words_wm, mesh, daxis, dim=1)
    D_loc = int(d_slabs[0].shape[1])
    k_loc = min(topk, D_loc)
    cand = []
    for d, q, db_loc, me in zip(mesh.flat_devices, q_slabs, d_slabs, mesh.axis_index(daxis)):
        with pmesh.on_device(d):
            cand.append(_scan_slab(q, db_loc, n_bases, k_loc, me * D_loc, d_valid))
    cd, ci = (list(c) for c in zip(*cand))
    merged = _merge_candidates_batch(cd, ci, mesh, topk, daxis)
    out_d: List = [None] * mesh.size
    out_i: List = [None] * mesh.size
    for (dd, ii), group in zip(merged, mesh.groups(daxis)):
        for g in group:
            dev = mesh.flat_devices[g]
            out_d[g], out_i[g] = dd.to(dev), ii.to(dev)
    return pmesh.Sharded(out_d, mesh, qaxis), pmesh.Sharded(out_i, mesh, qaxis)


def hdist_many_to_many_sharded(queries, db_words, n_bases, mesh: pmesh.Mesh,
                               axis: str = "data") -> pmesh.Sharded:
    """All-pairs distances [Q, D] with the ROW-MAJOR database [D, W] sharded
    on ``axis`` and the queries replicated; the result is sharded on its D
    column axis."""
    slabs = pmesh.split(db_words, mesh, axis)
    qs = pmesh.replicate(queries, mesh)
    out = []
    for d, q, db_loc in zip(mesh.flat_devices, qs, slabs):
        with pmesh.on_device(d):
            out.append(hamming.hdist_many_to_many(q, db_loc, n_bases))
    return pmesh.Sharded(out, mesh, axis, dim=1)


def hdist_search_db_sharded(query, db_words_wm, n_bases: int, topk: int, mesh: pmesh.Mesh,
                            axis: str = "data", d_valid=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest entries of one packed query [W] in a WORD-MAJOR
    database [W, D] sharded column-wise on ``axis``: K4 on each slab, the
    padding mask with d_valid, the slab's top-k, one merge. Returns
    (distances [topk], global indices [topk]) ascending."""
    slabs = pmesh.split(db_words_wm, mesh, axis, dim=1)
    qs = pmesh.replicate(query, mesh)
    D_loc = int(slabs[0].shape[1])
    k_loc = min(topk, D_loc)
    cand = []
    for d, q, db_loc, me in zip(mesh.flat_devices, qs, slabs, mesh.axis_index(axis)):
        with pmesh.on_device(d):
            dist = hamming.hdist_scan(q.reshape(1, -1), db_loc, int(n_bases))[0]
            if d_valid is not None and (me + 1) * D_loc > int(d_valid):  # a padded slab
                dist = _mask_padding(dist, me * D_loc, d_valid, n_bases)
            dd, idx = hamming.topk_smallest(dist, k_loc)
            cand.append((dd, idx + me * D_loc))
    cd, ci = (list(c) for c in zip(*cand))
    gd, gi = pmesh.all_gather(cd, mesh, axis), pmesh.all_gather(ci, mesh, axis)
    return _merge_one(gd[0], gi[0], topk)
