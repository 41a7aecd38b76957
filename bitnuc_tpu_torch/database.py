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

from .ops import hamming
from .utils import bitops


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
        """From host uint32 word-major words [W, D] (the JAX layout)."""
        return cls(
            words_wm=bitops.words_from_u32_np(words_wm_u32).to(device),
            n_bases=int(n_bases),
        )

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

    def search(self, query: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k nearest entries: (distances [k], indices [k])."""
        return hamming.topk_smallest(self.distances(query), k)

    def distances_batch(self, queries: torch.Tensor) -> torch.Tensor:
        """All-pairs distances [Q, D] for a packed query batch [Q, W] (K5;
        the tensor-core variant, K6, is a later port)."""
        return hamming.hdist_scan(queries, self.words_wm, self.n_bases)

    def search_batch(self, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query exact top-k: (distances [Q, k], indices [Q, k])."""
        return hamming.topk_batch_dispatch(self.distances_batch(queries), k)
