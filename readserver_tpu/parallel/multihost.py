"""Multi-host process group: jax.distributed wiring (SURVEY.md §2.4).

The reference scales by running backend shard *processes* behind a TCP
front end; the equivalent here is one JAX process per host joined into a
single SPMD program: ``init_multihost`` wires the process group,
``make_global_mesh`` lays the ('dp', 'shard') mesh so the **shard axis
stays inside a host** (collective merges stay on the host's own links)
and **dp spans hosts** (each host ingests its own query stream over the
network), and ``host_local_queries`` / ``gather_results`` are the
ingest/egress hops.

One process per host: each process opens every card its host shows it.
Running several processes on one machine needs each one restricted to
its own cards (``CUDA_VISIBLE_DEVICES``) — otherwise every process would
claim every card's memory.

Testable without a cluster: N local processes with CPU devices form a real
process group with real cross-process collectives (tests/test_multihost.py
drives 2 processes and SIGKILLs one for the fault-injection case).
"""

from __future__ import annotations

import numpy as np


def init_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    heartbeat_timeout_s: int | None = None,
) -> None:
    """Join this process into the group (idempotent per process).

    ``coordinator`` is ``host:port`` of process 0.  Each process uses
    the devices its host makes visible (one process per host, see the
    module docstring); on the CPU-simulated rig set
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` per process
    BEFORE importing jax.  A small ``heartbeat_timeout_s`` makes
    peer-death detection fast enough for CI fault injection.
    """
    import jax

    kw = {}
    if heartbeat_timeout_s is not None:
        kw["heartbeat_timeout_seconds"] = heartbeat_timeout_s
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def make_global_mesh(num_shards: int | None = None):
    """('dp', 'shard') mesh over every device in the process group.

    ``num_shards`` defaults to the per-process device count, which pins
    the whole shard axis inside one host: the per-step psum merges of the
    interval-sharded search then never leave the host — the layout SURVEY.md
    §2.4 prescribes.  jax.devices() orders by process, so the reshape
    below puts 'shard' (fast axis) within a process whenever
    ``num_shards`` divides the local device count.
    """
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    local = jax.local_device_count()
    if num_shards is None:
        num_shards = local
    total = len(devs)
    if total % num_shards:
        raise ValueError(f"{num_shards} shards do not divide {total} devices")
    dp = total // num_shards
    arr = np.array(devs).reshape(dp, num_shards)
    return Mesh(arr, ("dp", "shard"))


def host_local_queries(mesh, codes: np.ndarray, lengths: np.ndarray):
    """Per-host ingest: this process's batch slice → global dp-sharded
    arrays.  Every process contributes ``codes [B_local, K]``; the global
    batch is their concatenation in process order (B_local must be equal
    across processes and divisible by the host's dp share)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    gc = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp", None)), np.ascontiguousarray(codes)
    )
    gl = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp")), np.ascontiguousarray(lengths)
    )
    return gc, gl


def gather_results(tree):
    """Egress: fetch every process's result slices to THIS host as NumPy
    (an all-gather over DCN — each host only needs its own slice in
    production; this is the parity/testing hop)."""
    import jax
    from jax.experimental import multihost_utils

    return jax.tree_util.tree_map(
        lambda x: np.asarray(multihost_utils.process_allgather(x, tiled=True)),
        tree,
    )


def local_slice(tree, nq: int | None = None):
    """This process's addressable rows of each dp-sharded output (the
    production egress: a host answers only the queries it ingested)."""
    import jax

    def one(x):
        shards = sorted(
            (s for s in x.addressable_shards), key=lambda s: s.index[0].start or 0
        )
        out = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
        return out[:nq] if nq is not None else out

    return jax.tree_util.tree_map(one, tree)
