"""Simulated-mesh scaling validation (config 4 shape, BASELINE.json:10).

Runs the full sharded query program at every (dp, shard) factorization of
the available devices, asserting bit-exact parity across widths.  On the
CPU host-platform simulation this validates program correctness and
collective structure; wall-clock scaling efficiency must be measured on a
cards (ROADMAP.md S6).

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m readserver_tpu.bench.scaling_sim
"""

from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import jax
    import numpy as np

    from readserver_tpu.corpus import simulate
    from readserver_tpu.index.builder import build_index
    from readserver_tpu.ops import encode_query_batch
    from readserver_tpu.parallel import (
        build_prefix_lut_sharded,
        build_sharded,
        make_mesh,
        make_sharded_query_fn,
        place_sharded,
    )

    corpus = simulate.simulate_config("wg", scale=2e-6)  # tiny stand-in
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    k = corpus.spec.kmer_len
    kmers = simulate.sample_query_kmers(corpus, 64, k, seed=91, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)

    n_dev = len(jax.devices())
    widths = []
    d = 1
    while d <= n_dev:
        if n_dev % d == 0:
            widths.append(d)
        d *= 2

    from readserver_tpu.parallel.stats import (
        collective_stats,
        query_psum_estimate,
    )

    kstep = (
        3 if packed.rank3_blocks is not None
        else 2 if packed.rank2_blocks is not None
        else 1
    )
    reference = None
    results = []
    for shards in widths:
        dp = n_dev // shards
        mesh = make_mesh(data_parallel=dp, num_shards=shards)
        sidx = place_sharded(build_sharded(packed, shards), mesh)
        p = min(6, k)
        lut = build_prefix_lut_sharded(sidx, mesh, p)
        qfn = make_sharded_query_fn(sidx, mesh, max_hits=32, lut_p=p)
        t0 = time.perf_counter()
        out = qfn(sidx, lut, codes, lengths)
        jax.block_until_ready(out)
        counts = np.asarray(out["count"])
        hits = np.asarray(out["read_id"])
        if reference is None:
            reference = (counts, hits)
        else:
            assert np.array_equal(counts, reference[0]), f"shards={shards}"
            assert np.array_equal(hits, reference[1]), f"shards={shards}"
        # collective accounting: HLO-emitted ops (static) + analytic
        # per-batch psum count (dynamic) — shard-scaling regressions show
        # up here before they show up as wall-clock
        coll = collective_stats(qfn, sidx, lut, codes, lengths)
        est = query_psum_estimate(
            k, lut_p=p, kstep=kstep,
            sample_rate=sidx.sample_rate,
            fast_resolve=sidx.has_fast_resolve,
            max_read_len=sidx.max_read_len,
        )
        results.append(
            dict(
                dp=dp,
                shards=shards,
                first_run_s=round(time.perf_counter() - t0, 2),
                parity="exact",
                kstep=kstep,
                hlo_collectives=coll,
                psums_per_batch=est,
            )
        )
        print(
            f"# mesh(dp={dp}, shard={shards}): parity exact; "
            f"kstep={kstep} psums/batch={est['total']} "
            f"(search {est['search']} + resolve {est['resolve']}); "
            f"hlo all-reduce sites={coll['all-reduce']}",
            file=sys.stderr,
        )
    print(json.dumps({"scaling_sim": results, "devices": n_dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
