"""Production-shape sharded correctness (opt-in slow):
the interval-sharded owner-routed query path over the REAL chr20 artifact
(n = 1.94e9 symbols — per-shard positions near the top of the int32
range, block counts in the tens of millions) on the virtual CPU mesh.

Gated on the artifact cache plus READSERVER_CHR20=1 (loading 29 GB and
slicing per-shard tables takes minutes and tens of GB of host RAM — a
workstation job, not a CI job):

    READSERVER_CHR20=1 JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m pytest tests/test_chr20_sharded.py -q
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

import jax

ARTIFACT = Path(__file__).resolve().parent.parent / "data" / "bench_chr20_s1_v5"

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        os.environ.get("READSERVER_CHR20") != "1",
        reason="opt-in: set READSERVER_CHR20=1 (needs ~40 GB RAM)",
    ),
    pytest.mark.skipif(
        not (ARTIFACT / "manifest.json").exists()
        or not (ARTIFACT / "parity_cache.npz").exists(),
        reason="chr20 artifact cache (+ parity cache) not built",
    ),
]


def test_chr20_interval_sharded_parity():
    from readserver_tpu.index import artifact
    from readserver_tpu.ops import encode_query_batch
    from readserver_tpu.parallel import (
        build_sharded,
        make_mesh,
        make_sharded_query_fn,
        place_sharded,
    )

    packed = artifact.load_artifact(ARTIFACT, mmap=True)
    assert packed.n > 1_900_000_000

    # parity anchor: the build-time oracle cache (bench.py writes it)
    pc = np.load(ARTIFACT / "parity_cache.npz")
    queries, want = pc["queries"][:64], pc["counts"][:64]
    k = queries.shape[1]
    codes, lengths = encode_query_batch(
        ["".join("$ACGT"[c] for c in q) for q in queries], k
    )

    # 2 shards, not 4: XLA CPU collectives have a hard 40 s rendezvous
    # timeout, and at 13 GB of sliced tables the per-device-thread
    # startup skew on a 2-core host blows it with 4 participants
    mesh = make_mesh(
        data_parallel=1, num_shards=2, devices=jax.devices()[:2]
    )
    sidx = place_sharded(build_sharded(packed, 2), mesh)
    fn = make_sharded_query_fn(
        sidx, mesh, max_hits=8, lut_p=0, kstep=1, owner_route=True
    )
    out = fn(sidx, None, codes, lengths)
    got = np.asarray(out["count"]).astype(np.int64)
    assert np.array_equal(got, want), (
        f"sharded chr20 counts diverge: {got[:8]} vs {want[:8]}"
    )
