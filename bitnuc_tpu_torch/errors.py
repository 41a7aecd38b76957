"""Error types for bitnuc_tpu_torch.

A copy of ``bitnuc_tpu/errors.py``: importing any ``bitnuc_tpu`` module
imports jax, so the port carries its own. Mirrors the reference error
contract (``src/error.rs:4-18``): one exception type with structured
variants. Because device code cannot raise, batched device ops return
per-read status codes; host wrappers inspect them and raise the matching
exception (see ``bitnuc_tpu_torch/sequence.py``).
"""

from __future__ import annotations


class NucleotideError(Exception):
    """Base error for all bitnuc_tpu failures (reference: src/error.rs:4)."""


class InvalidBase(NucleotideError):
    """A byte outside {A,C,G,T,a,c,g,t} was encountered (src/error.rs:5)."""

    def __init__(self, base: int):
        self.base = int(base)
        super().__init__(f"Invalid nucleotide base: {self.base}")


class SequenceTooLong(NucleotideError):
    """Sequence exceeds the 32-base single-word limit (src/error.rs:6)."""

    def __init__(self, length: int):
        self.length = int(length)
        super().__init__(f"Sequence length {self.length} exceeds maximum")


class InvalidLength(NucleotideError):
    """A length argument is out of range for the operation (src/error.rs:7)."""

    def __init__(self, length: int):
        self.length = int(length)
        super().__init__(f"Invalid length: {self.length}")


class IndexOutOfBounds(NucleotideError):
    """Index past the end of a sequence (src/error.rs:8-11)."""

    def __init__(self, index: int, length: int):
        self.index = int(index)
        self.length = int(length)
        super().__init__(
            f"Index {self.index} out of bounds for sequence of length {self.length}"
        )


class InvalidRange(NucleotideError):
    """start > end or end > length for a slice (src/error.rs:12-16)."""

    def __init__(self, start: int, end: int, length: int):
        self.start = int(start)
        self.end = int(end)
        self.length = int(length)
        super().__init__(
            f"Invalid range {self.start}..{self.end} for sequence of "
            f"length {self.length}"
        )


class Unsupported(NucleotideError):
    """Requested backend/feature is unavailable (src/error.rs:17)."""

    def __init__(self, what: str = "Unsupported architecture"):
        super().__init__(what)
