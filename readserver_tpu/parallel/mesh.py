"""Mesh construction: (dp, shard) over local devices or a multi-host slice."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    data_parallel: int = 1,
    num_shards: int | None = None,
    devices: list | None = None,
) -> Mesh:
    """Build a ``(dp, shard)`` mesh.

    ``dp`` is the query-throughput axis (the reference's replica
    load-balancing); ``shard`` is the BWT-interval axis (the reference's
    backend split).  Defaults to using every visible device on the shard
    axis.  The device list is reshaped as given, with no topology
    assumption: on one machine every card reaches every other at the same
    rate.  Across hosts, call ``jax.distributed.initialize()`` first and
    pass ``jax.devices()``.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if num_shards is None:
        num_shards = n // data_parallel
    if data_parallel * num_shards != n:
        raise ValueError(
            f"dp({data_parallel}) * shard({num_shards}) != devices({n})"
        )
    arr = np.asarray(devices).reshape(data_parallel, num_shards)
    return Mesh(arr, axis_names=("dp", "shard"))
