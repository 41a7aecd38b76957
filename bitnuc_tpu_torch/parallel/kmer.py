"""Distributed k-mer counting over a mesh of torch devices.

The counterpart of ``bitnuc_tpu/parallel/kmer.py``, with its two sharding
regimes, both giving the single-device result bit for bit:

  * batch-sharded: each device counts its slab of reads into a dense
    histogram (K3b, or K3a with an N-skip mask), merged with one ``psum``;
    the sparse forms sort-count each slab and merge the lists with one
    ``all_gather`` and a sort (``ops.kmer.merge_sorted_runs``).
  * sequence-sharded: one long sequence's packed words are split along
    the word axis; windows that cross a shard edge take the first
    HALO_WORDS words of the right neighbour (``ppermute``), the ring
    wrapping at the last shard, whose halo the validity window masks.

Arguments that the JAX package takes as global arrays sharded on ``axis``
are tensors (cut into slabs here) or ``parallel.mesh.Sharded``s of this
mesh and axis (used as they lie). Replicated results are tensors on the
mesh's first device; results kept sharded are ``Sharded``s.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops import kmer as kmer_ops
from ..utils import bitops
from . import mesh as pmesh

HALO_WORDS = 2  # ceil((k-1)/16) for k <= 32
_DENSE_MODES = ("auto", "mxu", "pallas", "dense")  # the TPU's routes count dense here


def _slabs(words, lengths, base_valid, mesh, axis):
    """Per-device (words, lengths, base_valid or None) of a batch sharded
    on ``axis``."""
    ws = pmesh.split(words, mesh, axis)
    ls = pmesh.split(lengths, mesh, axis)
    bvs = pmesh.split(base_valid, mesh, axis) if base_valid is not None else [None] * len(ws)
    return ws, ls, bvs


def _per_shard(fn, mesh, *cols) -> List:
    """fn(*row) on each shard's device in mesh order; no shard's result is
    read back before the next shard's launch."""
    out = []
    for d, row in zip(mesh.flat_devices, zip(*cols)):
        with pmesh.on_device(d):
            out.append(fn(*row))
    return out


def count_kmers_sharded(
    words,
    lengths,
    k: int,
    mesh: pmesh.Mesh,
    axis: str = "data",
    mode: str = "auto",
    canonical: bool = False,
    base_valid=None,
) -> torch.Tensor:
    """Dense k-mer histogram over a batch sharded on ``axis``.

    words: [B, W] int32 (B divisible by the axis size), lengths: [B].
    Returns the [4^k] int32 histogram (one psum of the per-device
    histograms, on the mesh's first device) == the single-device result.
    mode: 'auto', 'mxu', 'pallas' or 'dense', all the port's dense count
    (K3b; K3a with base_valid); k <= MAX_DENSE_K. base_valid: optional
    [B, L] bool sharded alongside, dropping windows that touch an
    N/ambiguous base."""
    assert k <= kmer_ops.MAX_DENSE_K
    if mode not in _DENSE_MODES:
        raise ValueError(f"mode must be one of {_DENSE_MODES}, got {mode!r}")
    ws, ls, bvs = _slabs(words, lengths, base_valid, mesh, axis)
    hists = _per_shard(
        lambda w, n, bv: kmer_ops.count_kmers_dense(w, n, k, canonical, bv), mesh, ws, ls, bvs)
    return pmesh.psum(hists, mesh, axis)[0]


def _allgather_merge_sorted(lo, hi, counts, mesh, axis):
    """Merge per-device run-start lists into the global run-start list: one
    all_gather in mesh order, then ``merge_sorted_runs`` (zero-count rows
    go to the sentinel and fold into the tail). Returns (lo, hi, counts,
    n_unique) on the first device of each group, one tuple per group."""
    g = [pmesh.all_gather(x, mesh, axis) for x in (lo, hi, counts)]
    out = []
    for group in mesh.groups(axis):
        i = group[0]
        with pmesh.on_device(mesh.flat_devices[i]):
            out.append(kmer_ops.merge_sorted_runs(g[0][i], g[1][i], g[2][i]))
    return out


def count_kmers_sorted_sharded(
    words,
    lengths,
    k: int,
    mesh: pmesh.Mesh,
    axis: str = "data",
    canonical: bool = False,
    base_valid=None,
):
    """Sparse (sorted) k-mer counting over a sharded batch, any k <= 32.

    Each device sort-counts its slab (``count_kmers_runs``); the lists are
    all-gathered and merged with one more sort and weighted run
    aggregation. Returns (lo, hi, counts, n_unique) in the run-start layout
    on the mesh's first device, the JAX package's arrays bit for bit.
    base_valid: optional [B, L] bool sharded alongside (N-skip windows)."""
    ws, ls, bvs = _slabs(words, lengths, base_valid, mesh, axis)
    runs = _per_shard(
        lambda w, n, bv: kmer_ops.count_kmers_runs(w, n, k, canonical, bv)[:3],
        mesh, ws, ls, bvs)
    lo, hi, ct = (list(c) for c in zip(*runs))
    return _allgather_merge_sorted(lo, hi, ct, mesh, axis)[0]


def raw_window_keys_sharded(
    words,
    lengths,
    k: int,
    mesh: pmesh.Mesh,
    axis: str = "data",
    canonical: bool = False,
    base_valid=None,
):
    """Per-device raw window keys of a sharded batch, kept sharded on
    ``axis``: (lo, hi, weight) ``Sharded``s, weight 0 on invalid and
    padding slots. No communication; the streaming accumulator's feed
    (``pipeline.count_fastq(mesh=...)`` above k = 12)."""
    ws, ls, bvs = _slabs(words, lengths, base_valid, mesh, axis)
    keys = _per_shard(
        lambda w, n, bv: kmer_ops.raw_window_keys(w, n, k, canonical, bv), mesh, ws, ls, bvs)
    return tuple(pmesh.Sharded(list(c), mesh, axis) for c in zip(*keys))


def sparse_state_sharded(cap: int, mesh: pmesh.Mesh, axis: str = "data"):
    """Empty per-device run-list state: (lo, hi, counts) ``Sharded``s of
    ``cap`` sentinel rows a device."""
    cols = []
    for fill in (kmer_ops.SENT, kmer_ops.SENT, 0):
        cols.append(pmesh.Sharded(
            [torch.full((int(cap),), fill, dtype=torch.int32, device=d)
             for d in mesh.flat_devices], mesh, axis))
    return tuple(cols)


def merge_runs_sharded(parts, cap: int, mesh: pmesh.Mesh, axis: str = "data"):
    """One merge step, independently on each device (no communication but
    the max): each device concatenates its slices of every (lo, hi, count)
    part, merges them (``merge_sorted_runs``), keeps its first ``cap``
    rows of live runs ascending with dead sentinel rows behind them
    (``compact_live``: negated totals as the last key, so a live all-ones
    key stays ahead of the sentinel rows). Returns (lo, hi, counts
    ``Sharded``s, the largest per-device unique count as a 0-d tensor on
    the first device), the signal that doubles the capacity."""
    cols = [pmesh.split(a, mesh, axis) for p in parts for a in p]

    def local(*flat):
        lo = torch.cat(flat[0::3])
        hi = torch.cat(flat[1::3])
        ct = torch.cat([c.to(torch.int32) for c in flat[2::3]])
        lo_u, hi_u, tot, n_u = kmer_ops.merge_sorted_runs(lo, hi, ct)
        return (*kmer_ops.compact_live(lo_u, hi_u, tot, int(cap)), n_u)

    res = _per_shard(local, mesh, *cols)
    lo, hi, ct, n_u = (list(c) for c in zip(*res))
    n_max = pmesh.pmax(n_u, mesh, axis)[0]
    return (pmesh.Sharded(lo, mesh, axis), pmesh.Sharded(hi, mesh, axis),
            pmesh.Sharded(ct, mesh, axis), n_max)


def grow_state_sharded(state, new_cap: int, mesh: pmesh.Mesh, axis: str = "data"):
    """Raise a sharded state's per-device capacity to ``new_cap``: each
    device pads its own rows with sentinel rows."""
    out = []
    for col, fill in zip(state, (kmer_ops.SENT, kmer_ops.SENT, 0)):
        shards = pmesh.split(col, mesh, axis)
        out.append(pmesh.Sharded(
            [torch.cat([s, s.new_full((int(new_cap) - s.shape[0],), fill)]) for s in shards],
            mesh, axis))
    return tuple(out)


def gather_runs_sharded(lo, hi, counts, mesh: pmesh.Mesh, axis: str = "data"):
    """Final fold of a sharded accumulator: one all_gather and a merge of
    every device's run list into the global (lo, hi, counts, n_unique)
    run-start list, on the mesh's first device."""
    cols = [pmesh.split(a, mesh, axis) for a in (lo, hi, counts)]
    return _allgather_merge_sorted(*cols, mesh, axis)[0]


def _halo_keys(words, total_len, k: int, mesh: pmesh.Mesh, axis: str):
    """Per-device (lo, hi, valid) window keys of one long sequence's word
    slabs, each extended by its right neighbour's first HALO_WORDS words
    (the ring wraps; a window must start in its shard and end by
    ``total_len``)."""
    n_shards = mesh.shape[axis]
    slabs = pmesh.split(words, mesh, axis)
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    halos = pmesh.ppermute([s[:HALO_WORDS] for s in slabs], mesh, axis, perm)
    total = int(total_len)

    def local(words_loc, halo, me):
        W_loc = words_loc.shape[0]
        ext = torch.cat([words_loc, halo])
        codes = bitops.unpack_words(ext[None, :])
        lo, hi = kmer_ops.kmer_keys(codes, k)
        base0 = me * (W_loc * bitops.BASES_PER_WORD)
        pos = torch.arange(codes.shape[-1], dtype=torch.int64, device=ext.device)
        valid = (pos < W_loc * bitops.BASES_PER_WORD) & (base0 + pos <= total - k)
        return lo, hi, valid[None, :]

    return _per_shard(local, mesh, slabs, halos, mesh.axis_index(axis))


def count_kmers_seqsharded(words, total_len, k: int, mesh: pmesh.Mesh, axis: str = "seq"
                           ) -> torch.Tensor:
    """Dense k-mer histogram of one long sequence split along its words.

    words: [Wtot] int32, Wtot divisible by the axis size; total_len: the
    sequence's bases. Each device counts the windows that start in its
    slab with K3a (invalid windows carry the sentinel 4^k), and one psum
    merges them. Returns the [4^k] int32 histogram on the first device."""
    assert k <= kmer_ops.MAX_DENSE_K, f"seq-sharded dense capped at k={kmer_ops.MAX_DENSE_K}"
    keys = _halo_keys(words, total_len, k, mesh, axis)
    hists = _per_shard(
        lambda lo, hi, valid: kmer_ops.histogram_from_keys(
            torch.where(valid, lo, 4**k).reshape(-1), k),
        mesh, *zip(*keys))
    return pmesh.psum(hists, mesh, axis)[0]


def count_kmers_seqsharded_sorted(words, total_len, k: int, mesh: pmesh.Mesh,
                                  axis: str = "seq"):
    """Sparse (sorted) k-mer counting of one long sequence split along its
    words, any k <= 32: the same halo, each device sort-counts its own
    windows (``runs_from_keys``), and one all_gather merge. Returns (lo,
    hi, counts, n_unique) in the run-start layout on the first device."""
    keys = _halo_keys(words, total_len, k, mesh, axis)
    runs = _per_shard(lambda lo, hi, valid: kmer_ops.runs_from_keys(lo, hi, valid, k)[:3],
                      mesh, *zip(*keys))
    lo, hi, ct = (list(c) for c in zip(*runs))
    return _allgather_merge_sorted(lo, hi, ct, mesh, axis)[0]
