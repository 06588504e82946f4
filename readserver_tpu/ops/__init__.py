"""Device-side query ops: rank / backward search / LF-resolve.

This package is the device-side core of the framework — the replacement for
SGA's FM-index classes (``Occurrence``, ``BWTAlgorithms``, the LF walk;
SURVEY.md §2.1, L2).  All ops are pure functions over a :class:`DeviceIndex`
pytree, jit-friendly (static shapes, ``lax.scan``/``fori_loop`` control
flow), and explicitly int32/uint32 on the hot path.
"""

from readserver_tpu.ops.types import DeviceIndex
from readserver_tpu.ops.rank import occ
from readserver_tpu.ops.search import (
    backward_search,
    backward_search_lut,
    backward_search_pair,
    encode_query_batch,
)
from readserver_tpu.ops.lut import build_prefix_lut, default_lut_order
from readserver_tpu.ops.resolve import (
    exact_sample_histogram,
    resolve_intervals,
    resolve_rows_dsa,
    resolve_rows_fused,
    sample_histogram,
    select_walk,
)

__all__ = [
    "DeviceIndex",
    "occ",
    "backward_search",
    "backward_search_lut",
    "backward_search_pair",
    "build_prefix_lut",
    "default_lut_order",
    "encode_query_batch",
    "exact_sample_histogram",
    "resolve_intervals",
    "resolve_rows_dsa",
    "resolve_rows_fused",
    "sample_histogram",
    "select_walk",
]
