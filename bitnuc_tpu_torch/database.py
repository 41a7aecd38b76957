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
# and K5 below it. chip_smoke.py's sweep over 4,194,304 entries on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit, K5 / K6 in ms at Q = 1, 8, 16,
# 32, 64, 128, 256, 512, in two runs. 512 bases (W = 32): 0.199 / 1.320,
# 0.678 / 1.243, 0.695 / 1.381, 1.388 / 1.363, 2.740 / 2.053, 5.397 /
# 2.699, 10.834 / 4.102, 21.799 / 8.638 and 0.196 / 1.256, 0.682 / 1.185,
# 0.700 / 1.455, 1.380 / 1.371, 2.741 / 1.576, 5.392 / 2.676, 10.729 /
# 4.057, 21.739 / 7.820. 150 bases (W = 10): 0.081 / 0.774, 0.247 / 0.854,
# 0.265 / 0.776, 0.510 / 0.938, 1.011 / 1.117, 2.013 / 1.855, 4.103 /
# 2.791, 8.262 / 5.181 and 0.080 / 0.634, 0.245 / 0.683, 0.265 / 0.571,
# 0.519 / 0.779, 1.016 / 0.978, 2.022 / 1.690, 4.037 / 2.620, 8.153 /
# 5.225. K6 sizes its query tile to Q (8 to 256) and expands the whole
# database whatever Q is, so the crossover depends on the entries' width:
# K6 led from Q = 32 at 512 bases in both runs, from 64 or from 128 at 150.
# Only W = 10 and 32 were swept: entries of fewer than 32 words keep the
# larger threshold.


def tc_min_q(n_words: int) -> int:
    """The fewest queries for which distances_batch runs K6 on entries of
    ``n_words`` packed words."""
    return 32 if n_words >= 32 else 128


# search_batch runs the fused search (K6 with its top-k epilogue, the
# tc_search kernel) for k <= hamming.SEARCH_TOPK_MAX from this many queries
# on; below it, and above that k, distances_batch and then
# topk_batch_dispatch. Both routes are exact. chip_smoke.py's sweep over
# 4,194,304 entries, k = 10, on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, two-step / fused in ms at Q = 1, 8, 32, 64, 128, 256, 512: 512
# bases 0.904 / 1.612, 5.071 / 1.426, 15.968 / 2.123, 30.739 / 1.938,
# 58.019 / 3.357, 113.558 / 4.785, 234.638 / 9.409; 150 bases 0.761 /
# 0.895, 4.634 / 1.109, 14.945 / 1.392, 28.887 / 1.390, 56.851 / 2.459,
# 111.428 / 3.622, 230.302 / 6.246. One query stays on K4 and its top-k:
# the fused route expands the whole database whatever Q is.
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
        the tensor cores from tc_min_q(W) queries on, K5 below."""
        if queries.shape[0] >= tc_min_q(self.words_wm.shape[0]):
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
