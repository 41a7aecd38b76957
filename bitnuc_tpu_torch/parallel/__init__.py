"""The distributed tier: a mesh of torch devices in one process, sharded
tensors, explicit collectives (``mesh``), sharded k-mer counting
(``kmer``), sharded database search (``search``) and the process group
(``runtime``). The counterpart of ``bitnuc_tpu/parallel``."""

from .mesh import make_mesh, pad_batch, replicate, shard_reads  # noqa: F401
from .kmer import (  # noqa: F401
    count_kmers_seqsharded,
    count_kmers_seqsharded_sorted,
    count_kmers_sharded,
    count_kmers_sorted_sharded,
)
from .search import (  # noqa: F401
    hdist_many_to_many_sharded,
    hdist_search_batch_db_sharded,
    hdist_search_batch_sharded,
    hdist_search_db_sharded,
    hdist_search_sharded,
)
from . import runtime  # noqa: F401
