"""Launch bookkeeping shared by the kernel wrappers.

The wrappers themselves live beside their plain PyTorch versions in
``ops/codec.py`` (``pack``), ``ops/kmer.py`` (``hist_keys``,
``hist_words``) and ``ops/hamming.py`` (``hdist_scan``). Each adds one to
its entry in ``LAUNCHES`` where it launches its kernel, and nowhere else,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = {"pack": 0, "hist_keys": 0, "hist_words": 0, "hdist_scan": 0}


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
