"""Launch bookkeeping shared by the kernel wrappers.

The wrappers themselves live beside their plain PyTorch versions in
``ops/codec.py`` (``pack``, ``unpack``), ``ops/kmer.py`` (``hist_keys``,
``hist_words``), ``ops/hamming.py`` (``hdist_scan`` for one query and
``hdist_scan_batch`` for more, one kernel; ``tc_scan``, and ``tc_search``,
its search form with a per-block top-k), ``ops/merge.py``
(``merge``), ``ops/align.py`` (``fit_banded``, ``sw_score``),
``ops/orf.py`` (``orf_scan``) and ``ops/chain.py`` (``chain``, which
replaces no TPU kernel: it is the JAX package's chaining, its row sort
and scan, on the card), and ``traceback`` in ``ops/align.py`` (C2, which
replaces no TPU kernel either: the JAX package's direction-recording
wavefront and its walk behind every CIGAR), and ``fit_span`` in
``ops/align.py`` (C3, which replaces no TPU kernel: the JAX package's
unbanded wavefront, a ``lax.scan``, behind ``fit_distance_span`` and the
distance forms). Each adds one to its entry in ``LAUNCHES``
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = {
    "pack": 0,
    "hist_keys": 0,
    "hist_words": 0,
    "hdist_scan": 0,
    "unpack": 0,
    "merge": 0,
    "fit_banded": 0,
    "sw_score": 0,
    "hdist_scan_batch": 0,
    "tc_scan": 0,
    "tc_search": 0,
    "orf_scan": 0,
    "chain": 0,
    "traceback": 0,
    "fit_span": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim`` — the only input a kernel takes."""
    if not t.is_cuda:
        raise ValueError(
            f"{name}: the CUDA kernel needs a CUDA tensor, got one on {t.device}"
        )
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
