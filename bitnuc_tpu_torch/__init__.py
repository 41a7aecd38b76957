"""bitnuc_tpu_torch — the PyTorch and CUDA port of bitnuc_tpu.

It keeps the JAX package's packed layout (2-bit codes, 16 bases per 32-bit
word, word pairs equal to the reference's u64 words) and its module names,
and runs the packed-reads main path on an NVIDIA GPU through hand-written
CUDA kernels (``csrc/``), each with a plain PyTorch version beside it for
CPU tensors:

* ``ops.codec.encode_reads`` — K1 ``pack``
* ``ops.kmer.count_kmers_reads`` — K3a ``hist_keys``, K3b ``hist_words``
* ``PackedDB.distances`` / ``distances_batch`` — K4/K5 ``hdist_scan``

Device words are int32 bit-views of the JAX package's uint32 words
(``utils/bitops.py``). This package imports neither jax nor bitnuc_tpu.
"""

from . import config  # noqa: F401
from .database import PackedDB  # noqa: F401
from .errors import (  # noqa: F401
    IndexOutOfBounds,
    InvalidBase,
    InvalidLength,
    InvalidRange,
    NucleotideError,
    SequenceTooLong,
    Unsupported,
)
from .ops.analysis import base_counts_reads, gc_content_reads  # noqa: F401
from .ops.codec import decode_reads, encode_reads  # noqa: F401
from .ops.kmer import count_kmers_reads, spectrum, top_kmers  # noqa: F401
from .ops.revcomp import reverse_complement_reads  # noqa: F401
from .sequence import PackedReads  # noqa: F401
from . import io, pipeline  # noqa: F401

__all__ = [
    "config",
    "PackedDB",
    "PackedReads",
    "encode_reads",
    "decode_reads",
    "count_kmers_reads",
    "top_kmers",
    "spectrum",
    "base_counts_reads",
    "gc_content_reads",
    "reverse_complement_reads",
    "io",
    "pipeline",
    "NucleotideError",
    "InvalidBase",
    "SequenceTooLong",
    "InvalidLength",
    "IndexOutOfBounds",
    "InvalidRange",
    "Unsupported",
]
