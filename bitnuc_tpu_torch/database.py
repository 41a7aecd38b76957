"""PackedDB: a fixed-length packed-sequence database in scan layout.

The counterpart of ``bitnuc_tpu/database.py::PackedDB``. Entries are stored WORD-MAJOR, int32 [W, D]: a warp of the K4/K5
scan kernel (``csrc/hamming.cu``) then reads 32 neighbouring entries of one
word in one coalesced load. ``save``/``load`` use the JAX package's .npz
keys (``words_wm`` as uint32, ``n_bases``), so either package reads the
other's files.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import config
from . import io as bnio
from .ops import hamming
from .utils import bitops

# distances_batch runs K6 (the tensor cores) from tc_min_q(W) queries on,
# and K5 below it, or K5 at any Q where tc_min_q(W) is None. K5 reads the
# database once for each tile of 32 queries; K6 expands the whole database
# whatever Q is, in tiles of up to 256 queries (384 is a tile and a half).
# chip_smoke.py's sweep over 4,194,304 entries on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit, K5 / K6 in ms, in two runs. 512 bases (W = 32)
# at Q = 1, 8, 16, 24, 32, 48, 64, 128, 256, 512: 0.207 / 1.786, 0.236 /
# 1.702, 0.348 / 1.965, 0.537 / 1.730, 0.643 / 1.682, 1.070 / 2.295, 1.329
# / 2.379, 2.559 / 3.363, 5.105 / 4.616, 10.042 / 8.684, and 0.202 / 1.706,
# 0.237 / 1.839, 0.348 / 1.773, 0.526 / 2.222, 0.678 / 2.049, 1.091 /
# 1.919, 1.322 / 2.354, 2.506 / 3.223, 5.136 / 5.058, 10.074 / 8.634 (and
# 3.852 / 4.847 at 192, 7.501 / 8.925 at 384). 150 bases (W = 10): K5 led
# at every Q in both runs, 4.497 / 6.089 and 4.488 / 6.029 at 512; 448 and
# 320 bases (W = 28, 20, the second run): K5 led at every Q but 512 queries
# of 448 bases, 8.308 / 7.828 (4.330 / 4.944 at 256), and 6.347 / 7.190 at
# 512 of 320. So K6 from 256 queries on 32-word entries, where it led at
# 256 and 512 in both runs (it loses at 384, a query tile left part
# empty); from 512 on 28 to 31 words; none below 28 (the sweep's 384-base
# row, W = 24, is in PERF.md). 29 to 31 words and more than 32 are not
# swept: K6's lead grows with W, so they take the threshold of the swept
# width below them.


def tc_min_q(n_words: int):
    """The fewest queries for which distances_batch runs K6 on entries of
    ``n_words`` packed words, or None where K5 serves any number."""
    if n_words >= 32:
        return 256
    return 512 if n_words >= 28 else None


# search_batch runs the fused search (K6 with its top-k epilogue, the
# tc_search kernel) for k <= hamming.SEARCH_TOPK_MAX from this many queries
# on; below it, and above that k, distances_batch and then
# topk_batch_dispatch. Both routes are exact. chip_smoke.py's sweep over
# 4,194,304 entries, k = 10, on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, two-step / fused in ms at Q = 1, 8, 32, 64, 128, 256, 512, with
# K5 as redesigned for Hopper: 512 bases 0.945 / 1.771, 4.761 / 1.744,
# 17.053 / 2.131, 30.885 / 2.715, 59.004 / 4.345, 113.859 / 5.758, 235.178
# / 9.385; 150 bases 1.177 / 1.502, 4.571 / 1.065, 14.784 / 1.197, 28.488 /
# 1.785, 56.910 / 2.410, 111.296 / 3.829, 231.140 / 6.794. The two-step
# route's top-k over [Q, D], not its scan, holds it from 8 queries on. One
# query stays on K4 and its top-k: the fused route expands the whole
# database whatever Q is.
SEARCH_TC_MIN_Q = 8


@dataclasses.dataclass(frozen=True)
class PackedDB:
    """words_wm: int32 [W, D] word-major packed entries; n_bases: the length
    in bases that every entry shares."""

    words_wm: torch.Tensor
    n_bases: int

    @classmethod
    def from_reads(cls, reads, n_bases=None) -> "PackedDB":
        """From a PackedReads batch of equal-length entries (n_bases
        overrides the first read's length)."""
        nb = int(n_bases) if n_bases is not None else int(reads.lengths[0])
        return cls(words_wm=reads.words.t().contiguous(), n_bases=nb)

    @classmethod
    def from_numpy(cls, words_wm_u32: np.ndarray, n_bases: int, device=None) -> "PackedDB":
        """From host uint32 word-major words [W, D] (the JAX layout), on
        ``device`` (default: the card, see ``config.resolve_device``)."""
        device = config.resolve_device(device)
        return cls(
            words_wm=bitops.words_from_u32_np(words_wm_u32).to(device),
            n_bases=int(n_bases),
        )

    @classmethod
    def from_fastq(cls, path, n_bases: int, batch_size: int = 8192, validate: bool = True,
                   device=None) -> "PackedDB":
        """Stream a FASTQ file (plain or ``.gz``) into the word-major layout
        on ``device`` (default: the card). Entries are truncated or
        zero-padded to exactly n_bases; validate=True raises InvalidBase on
        the first invalid base. Records are framed by ``io.iter_fastq_batches``
        (the host library's scanner where it loads) and packed by K1."""
        device = config.resolve_device(device)
        W = bitops.n_words_for(n_bases)
        slabs = []
        for batch in bnio.iter_fastq_batches(path, batch_size, max_len=int(n_bases),
                                             validate=validate, device=device):
            w = batch.words
            if w.shape[1] < W:
                w = torch.nn.functional.pad(w, (0, W - w.shape[1]))
            slabs.append(w[:, :W].t())
        if not slabs:
            return cls(words_wm=torch.zeros((W, 0), dtype=torch.int32, device=device),
                       n_bases=int(n_bases))
        return cls(words_wm=torch.cat(slabs, 1).contiguous(), n_bases=int(n_bases))

    @classmethod
    def from_u64(cls, words_u64: np.ndarray, n_bases: int, device=None) -> "PackedDB":
        """From host reference-layout u64 words [D, n_u64]."""
        lanes = bitops.words_u64_to_u32_np(np.asarray(words_u64, np.uint64))
        return cls.from_numpy(lanes.T, n_bases, device)

    @property
    def size(self) -> int:
        return self.words_wm.shape[1]

    @property
    def n_words(self) -> int:
        return self.words_wm.shape[0]

    def __len__(self) -> int:
        return self.size

    # -- persistence ----------------------------------------------------------

    def save(self, path) -> None:
        """Persist as .npz (word-major uint32 words + n_bases)."""
        np.savez_compressed(
            path,
            words_wm=bitops.words_to_u32_np(self.words_wm),
            n_bases=np.int64(self.n_bases),
        )

    @classmethod
    def load(cls, path, device=None) -> "PackedDB":
        with np.load(path) as z:
            return cls.from_numpy(z["words_wm"], int(z["n_bases"]), device)

    # -- queries --------------------------------------------------------------

    def distances(self, query: torch.Tensor) -> torch.Tensor:
        """Per-entry Hamming distances [D] for one packed query [W] (K4)."""
        return hamming.hdist_scan(query.reshape(1, -1), self.words_wm, self.n_bases)[0]

    def _sharded_wm(self, mesh, axis: str):
        """(words_wm zero-padded to a device multiple on D and split
        column-wise over ``axis``, the true D)."""
        from .parallel import mesh as pmesh

        D = self.size
        pad = (-D) % mesh.shape[axis]
        wm = torch.nn.functional.pad(self.words_wm, (0, pad)) if pad else self.words_wm
        return pmesh.Sharded(pmesh.split(wm, mesh, axis, dim=1), mesh, axis, dim=1), D

    def search(self, query: torch.Tensor, k: int, mesh=None,
               axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k nearest entries: (distances [k], indices [k]).

        mesh: a ``parallel.mesh.Mesh`` — the database splits column-wise
        over ``axis`` (each device scans its slab with K4, the candidates
        merge with one top-k; ``parallel.search.hdist_search_db_sharded``),
        and min(k, D) entries come back, as in the JAX package. Results
        equal the single-device scan's."""
        if mesh is not None:
            from .parallel import search as psearch

            wm, D = self._sharded_wm(mesh, axis)
            return psearch.hdist_search_db_sharded(
                query, wm, self.n_bases, min(k, D), mesh, axis, d_valid=D)
        return hamming.topk_smallest(self.distances(query), k)

    def distances_batch(self, queries: torch.Tensor) -> torch.Tensor:
        """All-pairs distances [Q, D] for a packed query batch [Q, W]: K6 on
        the tensor cores from tc_min_q(W) queries on, K5 below (and at any
        Q where it is None)."""
        t = tc_min_q(self.words_wm.shape[0])
        if t is not None and queries.shape[0] >= t:
            return hamming.hdist_scan_tc(queries, self.words_wm, self.n_bases)
        return hamming.hdist_scan(queries, self.words_wm, self.n_bases)

    def search_batch(self, queries: torch.Tensor, k: int, mesh=None,
                     axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query exact top-k: (distances [Q, k], indices [Q, k]),
        ascending, ties by lowest index. From SEARCH_TC_MIN_Q queries on and
        for k <= hamming.SEARCH_TOPK_MAX the fused search (tc_search) keeps
        each query's k nearest entries in the kernel and never builds the
        [Q, D] matrix; otherwise distances_batch, then
        topk_batch_dispatch. mesh: the column-sharded scan, each slab
        searched this way (``parallel.search.hdist_search_batch_db_sharded``;
        the slab that holds padding takes the unfused route); min(k, D)
        entries a query come back."""
        if mesh is not None:
            from .parallel import search as psearch

            wm, D = self._sharded_wm(mesh, axis)
            return psearch.hdist_search_batch_db_sharded(
                queries, wm, self.n_bases, min(k, D), mesh, axis, d_valid=D)
        if 0 < k <= hamming.SEARCH_TOPK_MAX and queries.shape[0] >= SEARCH_TC_MIN_Q:
            return hamming.hdist_search_tc(queries, self.words_wm, self.n_bases, k)
        return hamming.topk_batch_dispatch(self.distances_batch(queries), k, self.n_bases)
