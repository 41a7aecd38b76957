"""The flagship single-device step of the port.

The counterpart of ``__graft_entry__.entry()``: an ASCII batch goes to packed
words (K1), a k-mer histogram plain and canonical (K3b, K3a), GC content,
reverse complements, and a Hamming top-k of the first read against a
packed database (K4). It calls the dispatching functions, so CUDA tensors
run the kernels and CPU tensors their plain versions, and it returns the
JAX step's eight named outputs (words as int32 bit-views).
"""

from __future__ import annotations

import numpy as np
import torch

from .database import PackedDB
from .ops import analysis, codec, kmer, revcomp
from .utils import bitops

K = 8
TOPK = 16


def example_batch(batch=64, read_len=128, db_size=256, seed=0):
    """Host inputs (ascii uint8 [batch, read_len], lengths int32 [batch],
    db uint32 [db_size, W]) made exactly as ``__graft_entry__`` makes them."""
    rng = np.random.default_rng(seed)
    ascii_u8 = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(batch, read_len))
    lengths = np.full((batch,), read_len, dtype=np.int32)
    n_words = bitops.n_words_for(read_len)
    db_words = rng.integers(0, 2**32, size=(db_size, n_words), dtype=np.uint32)
    return ascii_u8, lengths, db_words


def forward(ascii_u8: torch.Tensor, lengths: torch.Tensor, db: PackedDB) -> dict:
    """One step over a [B, L] uint8 batch and a word-major database whose
    entries have the reads' word count."""
    words, first_bad = codec.encode_reads(ascii_u8, lengths)
    hist = kmer.count_kmers_reads(words, lengths, K)
    hist_canon = kmer.count_kmers_reads(words, lengths, K, canonical=True)
    gc = analysis.gc_content_reads(words, lengths)
    rc = revcomp.reverse_complement_reads(words, lengths)
    dists, idx = db.search(words[0], TOPK)
    return {
        "words": words,
        "first_bad": first_bad,
        "kmer_hist": hist,
        "kmer_hist_canonical": hist_canon,
        "gc_content": gc,
        "revcomp_words": rc,
        "top_dists": dists,
        "top_idx": idx,
    }


def entry(device=None, **sizes):
    """(forward, args): the step and its example inputs on ``device``.
    The database's n_bases is min(lengths[0], 16 W), as in the JAX step."""
    ascii_np, lengths_np, db_np = example_batch(**sizes)
    n_bases = min(int(lengths_np[0]), 16 * db_np.shape[1])
    db = PackedDB.from_numpy(db_np.T, n_bases, device)
    return forward, (
        torch.from_numpy(ascii_np).to(device),
        torch.from_numpy(lengths_np).to(device),
        db,
    )
