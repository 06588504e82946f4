"""Distribution layer: BWT-interval sharding over a device mesh.

The reference scales by splitting the population BWT across backend server
processes and merging per-shard counts on a TCP front end (SURVEY.md §1 L5,
§2.4).  Here the same axis — contiguous global BWT position ranges — is
sharded across the ``'shard'`` mesh axis; every shard computes a masked
local contribution to each rank and a single ``psum`` produces the
global value.  Query batches stream over the ``'dp'`` axis.  The star
topology of the reference becomes one SPMD program.
"""

from readserver_tpu.parallel.mesh import make_mesh
from readserver_tpu.parallel.doc_sharded import (
    DocShardedIndex,
    build_doc_sharded,
    make_doc_query_fn,
    place_doc_sharded,
)
from readserver_tpu.parallel.sharded import (
    ShardedIndex,
    build_prefix_lut_sharded,
    build_sharded,
    make_sharded_query_fn,
    place_sharded,
)

__all__ = [
    "make_mesh",
    "ShardedIndex",
    "build_sharded",
    "place_sharded",
    "make_sharded_query_fn",
    "build_prefix_lut_sharded",
    "DocShardedIndex",
    "build_doc_sharded",
    "place_doc_sharded",
    "make_doc_query_fn",
]
