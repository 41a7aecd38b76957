"""Backend selection: the hand-written CUDA kernels or their plain twins.

The counterpart of ``bitnuc_tpu/config.py``. Every kernel of the port has
a plain PyTorch version of the same function beside it, bit-identical by
contract:

* ``auto`` (default): the kernel for CUDA tensors, the plain version for
  CPU tensors. The choice follows the device of the tensor alone.
* ``torch``: the plain version everywhere. It exists for comparisons.
* ``kernel``: the kernel everywhere; a CPU tensor raises.

Set it with the ``BITNUC_TORCH_BACKEND`` environment variable or, for a
block of code, ``with bitnuc_tpu_torch.config.backend("torch"): ...``.

Entry points that put host data on a device (``PackedReads.from_ascii``,
``PackedDB.load``, ``pipeline.count_fastq``, ``MinimizerIndex.build`` and
the rest) take a ``device`` argument and use the card when it is None
(``default_device``); without a CUDA device they raise rather than run on
the CPU, which a caller asks for by name (``device="cpu"``). Functions
under ``ops/`` follow the device of their input tensors.
"""

from __future__ import annotations

import contextlib
import os

import torch

_VALID = ("auto", "torch", "kernel")
_backend = os.environ.get("BITNUC_TORCH_BACKEND", "auto")
if _backend not in _VALID:
    raise ValueError(
        f"BITNUC_TORCH_BACKEND must be one of {_VALID}, got {_backend!r}"
    )


def get_backend() -> str:
    return _backend


def set_backend(name: str) -> None:
    global _backend
    if name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    _backend = name


@contextlib.contextmanager
def backend(name: str):
    """Temporarily select a backend: ``with config.backend("torch"): ...``."""
    old = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(old)


def default_device() -> torch.device:
    """The device of an entry point whose caller names none: the card."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``default_device()``; raises when none was
    named and no CUDA device is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: entry points run on the card unless the `device` "
            "argument names another (device='cpu' runs on the CPU)"
        )
    return default_device()


def use_kernel(t: torch.Tensor) -> bool:
    """True when the call on tensor ``t`` must go to the CUDA kernel.

    Under ``kernel`` this is True for a CPU tensor too, and the kernel's
    wrapper then raises: there is no silent fallback to the plain version.
    """
    b = get_backend()
    if b == "kernel":
        return True
    if b == "torch":
        return False
    return t.is_cuda


def require_no_mesh(mesh, what: str) -> None:
    """Raise NotImplementedError unless ``mesh`` is None: the JAX package's
    mesh paths wait for the distributed tier."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: the mesh path waits for the distributed tier (ROADMAP §1, "
            "'The distributed tier')"
        )
