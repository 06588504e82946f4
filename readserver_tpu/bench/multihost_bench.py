"""Multi-process scaling harness: one process per (simulated) host.

Each process joins the jax.distributed group, loads the SAME deterministic
index (the artifact is immutable and replicated, as in the reference's
shard deployment), ingests ITS OWN query stream (per-host dp ingest), and
the group executes the interval-sharded SPMD query program together —
per-step psums ride the intra-host 'shard' axis, dp spans processes.

    # 2-process CPU rig (what tests/test_multihost.py drives):
    for i in 0 1; do
      python -m readserver_tpu.bench.multihost_bench \
          --coordinator 127.0.0.1:29520 --num-processes 2 --process-id $i \
          --local-devices 4 &
    done; wait

Process 0 prints one JSON line: global qps, per-process qps, and a parity
verdict over EVERY process's queries (gathered + diffed vs the oracle).
``--serve-loop`` instead ticks forever printing heartbeats — the fault-
injection test SIGKILLs one process and watches the survivor stop making
progress, then relaunches the group and asserts identical answers
(restart-on-crash supervision, SURVEY.md §5 "Failure detection").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="CPU-simulated devices per process (0 = real)")
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=64,
                    help="per-process query batch size")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--heartbeat-timeout", type=int, default=10)
    ap.add_argument("--num-shards", type=int, default=0,
                    help="global mesh shard-axis size (0 = this host's "
                         "device count).  The scaling bench pins this so "
                         "its 1-process control runs the SAME (dp, shard) "
                         "program as the N-process run — otherwise the "
                         "efficiency ratio conflates process count with "
                         "decomposition shape")
    ap.add_argument("--serve-loop", action="store_true",
                    help="tick forever, one heartbeat line per step")
    ap.add_argument("--owner-route", action="store_true",
                    help="owner-computes search ranks (compacted gathers)")
    ap.add_argument("--route-capacity", type=int, default=0,
                    help="per-round gather capacity (0 = heuristic); "
                         "undersize to force overflow rounds")
    ap.add_argument("--exact-hist", action="store_true",
                    help="exact per-sample attribution sweep")
    ap.add_argument("--strip-dsa", action="store_true",
                    help="drop the direct-resolve tier to exercise the "
                         "sampled-LF walk's cross-process collectives")
    args = ap.parse_args(argv)

    if args.local_devices:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.local_devices}"
        ).strip()

    import jax

    if args.local_devices:
        jax.config.update("jax_platforms", "cpu")

    from readserver_tpu.parallel.multihost import (
        gather_results,
        host_local_queries,
        init_multihost,
        make_global_mesh,
    )

    init_multihost(
        args.coordinator,
        args.num_processes,
        args.process_id,
        heartbeat_timeout_s=args.heartbeat_timeout,
    )
    pid, nproc = jax.process_index(), jax.process_count()

    import numpy as np

    from readserver_tpu.corpus import simulate
    from readserver_tpu.index.builder import build_index
    from readserver_tpu.ops import encode_query_batch
    from readserver_tpu.parallel import (
        build_sharded,
        make_sharded_query_fn,
        place_sharded,
    )

    corpus = simulate.simulate_config(args.config, scale=args.scale)
    packed = build_index(corpus.reads, sample_ids=corpus.sample_ids)
    mesh = make_global_mesh(args.num_shards or None)
    sidx = place_sharded(build_sharded(packed, mesh.shape["shard"]), mesh)
    if args.strip_dsa:
        import dataclasses as _dc

        sidx = _dc.replace(sidx, dsa_chunk=None, dsa_bits=0)
    qfn = make_sharded_query_fn(
        sidx, mesh, max_hits=16,
        owner_route=args.owner_route,
        route_capacity=args.route_capacity or None,
        exact_hist=args.exact_hist,
    )

    # per-host ingest: each process samples a DIFFERENT query stream
    k = corpus.spec.kmer_len
    B = args.batch
    kmers = simulate.sample_query_kmers(
        corpus, B, k, seed=100 + pid, miss_frac=0.2
    )
    codes, lengths = encode_query_batch(kmers, k)
    gcodes, glengths = host_local_queries(mesh, codes, lengths)

    out = qfn(sidx, None, gcodes, glengths)
    jax.block_until_ready(out)

    if args.serve_loop:
        t = 0
        while True:
            out = qfn(sidx, None, gcodes, glengths)
            jax.block_until_ready(out)
            t += 1
            print(f"tick {t} ok proc {pid}", flush=True)
            time.sleep(0.05)
        return 0  # unreachable

    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = qfn(sidx, None, gcodes, glengths)
        # block EVERY step: queuing dozens of cross-process collective
        # programs deadlocks the XLA CPU transport's rendezvous when the
        # processes' dispatch fronts diverge (measured: 16 in-flight
        # worked, 48 hung past the 600 s group timeout).  The real-chip
        # serving path blocks per batch anyway (the dispatcher transfers
        # each batch's results), so this is also the honest shape.
        jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    qps_global = B * nproc * args.iters / dt

    # egress + parity: gather every host's counts, diff vs the oracle over
    # every host's queries (process 0 re-derives each host's seed)
    gathered = gather_results({"l": out["l"], "u": out["u"]})
    if pid == 0:
        from readserver_tpu.oracle import OracleFMIndex

        fm = OracleFMIndex(corpus.reads)
        bad = 0
        for p in range(nproc):
            km_p = simulate.sample_query_kmers(
                corpus, B, k, seed=100 + p, miss_frac=0.2
            )
            for b, km in enumerate(km_p):
                want = fm.backward_search(km)
                got = (
                    int(gathered["l"][p * B + b]),
                    int(gathered["u"][p * B + b]),
                )
                if got != want:
                    bad += 1
        print(
            json.dumps(
                {
                    "metric": "multihost_sharded_queries_per_s",
                    "value": round(qps_global),
                    "processes": nproc,
                    "devices": jax.device_count(),
                    "shards": int(mesh.shape["shard"]),
                    "dp": int(mesh.shape["dp"]),
                    "per_process_batch": B,
                    "parity_bad": bad,
                    "parity_queries": B * nproc,
                }
            ),
            flush=True,
        )
        if bad:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
