"""PackedDB: a fixed-length packed-sequence database in scan layout.

The counterpart of ``bitnuc_tpu/database.py::PackedDB`` without its mesh
paths. Entries are stored WORD-MAJOR, int32 [W, D]: a warp of the K4/K5
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

# distances_batch runs K6 (the tensor cores) from this many queries on, and
# K5 below it. chip_smoke.py's sweep over 4,194,304 entries on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit, K5 / K6 in ms at Q = 32, 64,
# 128, 256, 512: 512 bases (W = 32) 1.418 / 3.444, 2.740 / 3.376, 5.557 /
# 4.023, 10.826 / 6.444, 21.780 / 12.775; 150 bases (W = 10) 0.518 /
# 1.382, 1.027 / 1.599, 2.002 / 1.814, 4.084 / 3.463, 8.047 / 5.734. K6
# pads Q to tiles of 128, so the crossover is 128 at both widths.
TC_MIN_Q = 128

# search_batch runs the fused search (K6 with its top-k epilogue, the
# tc_search kernel) for k <= hamming.SEARCH_TOPK_MAX from this many queries
# on; below it, and above that k, distances_batch and then
# topk_batch_dispatch. Both routes are exact. chip_smoke.py's sweep over
# 4,194,304 entries, k = 10, on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, two-step / fused in ms at Q = 1, 8, 32, 64, 128, 256, 512: 512
# bases 0.901 / 4.006, 5.153 / 3.955, 15.900 / 4.186, 30.706 / 4.524,
# 58.890 / 3.942, 115.905 / 7.602, 239.315 / 13.551; 150 bases 0.762 /
# 1.612, 4.697 / 1.699, 14.907 / 1.853, 28.876 / 2.005, 56.713 / 2.020,
# 111.746 / 3.407, 230.823 / 6.668. The fused route computes a whole
# 128-query tile, so one query stays on K4 and its top-k.
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
        the first invalid base."""
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

    def search(self, query: torch.Tensor, k: int, mesh=None,
               axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k nearest entries: (distances [k], indices [k]). A
        ``mesh`` (the JAX package's column-sharded scan) raises
        NotImplementedError."""
        config.require_no_mesh(mesh, "PackedDB.search")
        return hamming.topk_smallest(self.distances(query), k)

    def distances_batch(self, queries: torch.Tensor) -> torch.Tensor:
        """All-pairs distances [Q, D] for a packed query batch [Q, W]: K6 on
        the tensor cores from TC_MIN_Q queries on, K5 below."""
        if queries.shape[0] >= TC_MIN_Q:
            return hamming.hdist_scan_tc(queries, self.words_wm, self.n_bases)
        return hamming.hdist_scan(queries, self.words_wm, self.n_bases)

    def search_batch(self, queries: torch.Tensor, k: int, mesh=None,
                     axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query exact top-k: (distances [Q, k], indices [Q, k]),
        ascending, ties by lowest index. From SEARCH_TC_MIN_Q queries on and
        for k <= hamming.SEARCH_TOPK_MAX the fused search (tc_search) keeps
        each query's k nearest entries in the kernel and never builds the
        [Q, D] matrix; otherwise distances_batch, then
        topk_batch_dispatch. A ``mesh`` raises NotImplementedError."""
        config.require_no_mesh(mesh, "PackedDB.search_batch")
        if 0 < k <= hamming.SEARCH_TOPK_MAX and queries.shape[0] >= SEARCH_TC_MIN_Q:
            return hamming.hdist_search_tc(queries, self.words_wm, self.n_bases, k)
        return hamming.topk_batch_dispatch(self.distances_batch(queries), k, self.n_bases)
