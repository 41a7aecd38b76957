"""bitnuc_tpu_torch — the PyTorch and CUDA port of bitnuc_tpu.

API tiers, as in the JAX package (the reference's layering,
src/lib.rs:210-220):

* host functional API (``api``, numpy): as_2bit, from_2bit, encode,
  decode, hdist, hdist_scalar, split_packed, count_kmers
* host sequence type: ``PackedSequence`` (get/slice/to_vec/gc_content/...)
* device batch tier: ``PackedReads``, ``PackedDB`` and ``ops``

It keeps the JAX package's packed layout (2-bit codes, 16 bases per 32-bit
word, word pairs equal to the reference's u64 words) and its module names,
and runs the packed-reads main path and the large-k counting and set-algebra
path on an NVIDIA GPU through hand-written CUDA kernels (``csrc/``), each
with a plain PyTorch version beside it for CPU tensors:

* ``ops.codec.encode_reads`` — K1 ``pack``
* ``ops.codec.decode_reads`` (``PackedReads.to_ascii``, ``unpack_kmers``)
  — K2 ``unpack``
* ``ops.kmer.count_kmers_reads`` (dense, k <= 12) — K3a ``hist_keys``, K3b
  ``hist_words``
* ``PackedDB.distances`` / ``distances_batch`` — K4 ``hdist_scan``, K5
  ``hdist_scan_batch`` (one kernel), and from ``database.tc_min_q(W)``
  queries on K6 ``tc_scan`` (int8 tensor cores)
* ``ops.setops.combine_counts`` (through ``ops.merge.merge_sorted``) — K7
  ``merge``
* ``ops.align.fit_distance_span_banded`` (the fit of ``mapper.map_reads``)
  — K8 ``fit_banded``
* ``ops.align.sw_score`` — K9 ``sw_score``
* ``ops.orf.longest_orf`` — K10 ``orf_scan``, once for both strands
* ``ops.chain.chain_anchors`` (the chaining of ``mapper.map_reads_long``) —
  C1 ``chain``, the device loop of the JAX package's chaining scan (it
  replaces no TPU kernel)

``hdist_search_batch`` searches as ``PackedDB.search_batch`` does (K4/K5,
or K6's ``tc_search``). ``ops.merge_pairs.merge_pairs`` merges read pairs
in plain PyTorch (the JAX package has no kernel there). Sort-based
counting for any k <= 32 (``count_kmers_sorted``, ``count_kmers_runs``,
and ``pipeline.count_fastq``/``count_fasta`` above k = 12) sorts with
``torch.sort``. Short reads map with
``mapper.MinimizerIndex.build_multi``, ``mapper.map_reads`` and
``mapper.traceback_cigars``; long reads with ``mapper.map_reads_long``,
read pairs with ``mapper.map_pairs``; ``ops.pileup.call_variants`` calls
SNPs and indels from a mapping, and ``minimizer_sketch`` with
``sketch_jaccard`` and ``sketch_containment`` (and their pair-key forms for
k up to 31) compares sequence sets. ``ops.split`` slices packed reads and
``ops.orf.translate_reads`` translates them.

The read-processing tier runs in plain PyTorch on the device of its
inputs (the JAX package has no kernel there): ``ops.lookup`` answers
k-mer table lookups and screens reads (``lookup_counts``,
``kmer_hits_reads``, ``screen_reads``, ``solid_prefix_len``),
``ops.dedupe`` marks duplicate reads, ``ops.correct`` corrects single-base
errors against a k-mer spectrum, ``ops.demux`` assigns barcodes, and
``filters`` (``filter_fastq``, ``filter_fastq_paired``) and ``qc``
(``qc_profile``) trim, filter and profile FASTQ files.

Entry points that put host data on a device use the card unless their
``device`` argument names another (``config.resolve_device``).

Device words are int32 bit-views of the JAX package's uint32 words
(``utils/bitops.py``). This package imports neither jax nor bitnuc_tpu.
"""

from . import config  # noqa: F401
from .api import (  # noqa: F401
    as_2bit,
    count_kmers,
    decode,
    encode,
    encode_alloc,
    from_2bit,
    from_2bit_alloc,
    hdist,
    hdist_scalar,
    split_packed,
)
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
from .ops.analysis import base_counts_reads, gc_content_reads, windowed_gc  # noqa: F401
from .ops.codec import decode_reads, encode_reads  # noqa: F401
from .ops.hamming import (  # noqa: F401
    hdist_many_to_many,
    hdist_one_to_many,
    hdist_topk as hdist_search,
    hdist_topk_batch as hdist_search_batch,
)
from .ops.kmer import (  # noqa: F401
    count_kmers_reads,
    count_kmers_runs,
    count_kmers_sorted,
    minimizer_positions,
    minimizer_sketch,
    minimizer_sketch64,
    minimizers,
    minimizers64,
    sketch_containment,
    sketch_containment64,
    sketch_jaccard,
    sketch_jaccard64,
    spectrum,
    top_kmers,
)
from .ops.lookup import (  # noqa: F401
    kmer_hits_reads,
    lookup_counts,
    screen_reads,
    solid_prefix_len,
)
from .ops.revcomp import reverse_complement_reads  # noqa: F401
from .ops.dedupe import dedupe_reads, mark_duplicates  # noqa: F401
from .ops.setops import combine_counts, combine_dicts  # noqa: F401
from .sequence import PackedReads, PackedSequence, stack_sequences  # noqa: F401
from . import filters, io, mapper, pipeline, qc  # noqa: F401
from .ops import orf, split  # noqa: F401
from .io import read_fasta  # noqa: F401
from .mapper import MinimizerIndex, map_pairs, map_reads, map_reads_long  # noqa: F401

__all__ = [
    "as_2bit",
    "from_2bit",
    "from_2bit_alloc",
    "encode",
    "encode_alloc",
    "decode",
    "hdist",
    "hdist_scalar",
    "split_packed",
    "count_kmers",
    "PackedSequence",
    "stack_sequences",
    "config",
    "PackedDB",
    "PackedReads",
    "encode_reads",
    "decode_reads",
    "count_kmers_reads",
    "count_kmers_sorted",
    "count_kmers_runs",
    "minimizers",
    "minimizer_sketch",
    "sketch_containment",
    "sketch_jaccard",
    "combine_counts",
    "combine_dicts",
    "read_fasta",
    "top_kmers",
    "spectrum",
    "minimizer_positions",
    "hdist_search",
    "hdist_search_batch",
    "hdist_one_to_many",
    "hdist_many_to_many",
    "base_counts_reads",
    "gc_content_reads",
    "windowed_gc",
    "reverse_complement_reads",
    "lookup_counts",
    "kmer_hits_reads",
    "screen_reads",
    "solid_prefix_len",
    "mark_duplicates",
    "dedupe_reads",
    "io",
    "mapper",
    "pipeline",
    "MinimizerIndex",
    "map_reads",
    "NucleotideError",
    "InvalidBase",
    "SequenceTooLong",
    "InvalidLength",
    "IndexOutOfBounds",
    "InvalidRange",
    "Unsupported",
]
