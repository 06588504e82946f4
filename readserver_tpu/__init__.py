"""readserver_tpu — a compressed read-index query engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``wtsi-svi/ReadServer`` (see SURVEY.md; the reference mount was empty at
survey time, so parity is defined against the in-repo BASELINE.json spec and
the NumPy oracle in :mod:`readserver_tpu.oracle`):

* a multi-string BWT / FM-index over pooled sequencing reads, held in device
  memory as bit-packed rank-block arrays (replacing the reference's RLE-BWT
  file format + SGA ``Occurrence`` checkpoints),
* batched lockstep backward search under ``jit`` (replacing the reference's
  sequential per-query C++ search loop),
* a vectorized LF-walk for read-ID / sample-ID attribution (replacing the
  RocksDB payload tier with dense on-device arrays),
* BWT-interval sharding over a ``jax.sharding.Mesh`` with ``psum`` merges
  (replacing the reference's TCP front-end → shard fan-out),
* a thin asyncio dispatcher + REST endpoint (replacing the C++ server tier).

Global and sharded interval arithmetic uses int64 (BWT lengths for
whole-genome read pools exceed 2**32), so x64 is enabled at import; every
hot-path array is explicitly typed int32/uint32 so this costs nothing on the
performance path.
"""

import jax

jax.config.update("jax_enable_x64", True)

from readserver_tpu.config import IndexConfig, ServeConfig  # noqa: E402
from readserver_tpu import alphabet  # noqa: E402

__version__ = "0.1.0"

__all__ = ["IndexConfig", "ServeConfig", "alphabet", "__version__"]
