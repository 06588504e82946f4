#!/usr/bin/env python
"""Wire-level serving benchmark: HTTP loopback → dispatcher → device → JSON.

bench.py times the device-side programs; this measures what a client
actually sees through the full serving stack (REST parse, dispatcher
micro-batching, device step, JSON encode) — the end-to-end number the
reference's ab/loadtest workflows would report (SURVEY.md §1 L4).

    python scripts/bench_wire.py --config ecoli            # on the chip
    JAX_PLATFORMS=cpu python scripts/bench_wire.py --config tiny

Writes BENCH_wire.json at the repo root and prints one JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(engine, port: int) -> tuple[threading.Thread, asyncio.AbstractEventLoop]:
    from readserver_tpu.serve.dispatcher import Dispatcher
    from readserver_tpu.serve.http import RestServer

    loop = asyncio.new_event_loop()
    server = RestServer(Dispatcher(engine), "127.0.0.1", port)

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(server.start())
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True, name="rest-server")
    t.start()
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            c.request("GET", "/health")
            if c.getresponse().status == 200:
                c.close()
                return t, loop
        except Exception:
            time.sleep(0.2)
    raise RuntimeError("REST server never came up")


def client_worker(
    port: int,
    batches: list[list[str]],
    mode: str,
    latencies: list[tuple[int, float]],
    counts: list[int],
    errors: list[str],
) -> None:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        for seq, kmers in enumerate(batches):
            body = json.dumps({"kmers": kmers, "mode": mode}).encode()
            t0 = time.perf_counter()
            conn.request(
                "POST", "/batch", body,
                {"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            data = json.loads(resp.read())
            latencies.append((seq, time.perf_counter() - t0))
            if resp.status != 200:
                errors.append(str(data)[:200])
                return
            counts.append(len(data["results"]))
    except Exception as e:  # surfaces in the main thread's error check
        errors.append(repr(e))
    finally:
        conn.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="auto")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device-batch", type=int, default=8192)
    ap.add_argument("--request-kmers", type=int, default=2048,
                    help="k-mers per POST /batch request")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests-per-client", type=int, default=16)
    ap.add_argument("--modes", default="count,samples")
    ap.add_argument("--out", default="BENCH_wire.json",
                    help="output JSON filename (repo root)")
    args = ap.parse_args()

    from bench import get_packed, pick_auto_config

    import jax

    from readserver_tpu import alphabet
    from readserver_tpu.runtime import card_info
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.corpus import simulate
    from readserver_tpu.serve import QueryEngine

    if args.config == "auto":
        args.config = pick_auto_config()
    packed, spec = get_packed(args.config, args.scale)
    k = spec.kmer_len

    # precompile the workload's uniform k (column-sliced shape) so no
    # full-width XLA compile lands inside a measured request
    cfg = ServeConfig(
        batch_size=args.device_batch, warmup_query_lengths=(k,)
    )
    engine = QueryEngine(packed, cfg)
    engine.warmup()

    total_kmers = args.clients * args.requests_per_client * args.request_kmers
    # query source: the bench query-pool cache when present (chr20
    # re-simulation costs minutes per run), else simulate
    from bench import bench_cache

    qcache = bench_cache(args.config, args.scale) / "bench_queries_s1.npy"
    if qcache.exists():
        pool = np.load(qcache, mmap_mode="r")
        kms = np.asarray(pool[np.arange(total_kmers) % len(pool)])
        print(f"# {total_kmers} queries from pool cache", file=sys.stderr)
    else:
        corpus = simulate.simulate_config(args.config, scale=args.scale)
        kms = simulate.sample_query_kmers_fast(
            corpus, total_kmers, k, seed=3, miss_frac=0.1
        )
    strings = ["".join(alphabet.decode(km)) for km in np.asarray(kms)]

    port = _free_port()
    start_server(engine, port)

    result = {
        "metric": "served_wire_qps",
        "unit": "queries/s over HTTP loopback",
        "config": args.config,
        "scale": args.scale,
        "device_batch": args.device_batch,
        "request_kmers": args.request_kmers,
        "clients": args.clients,
        "kmer_len": k,
        "device": jax.devices()[0].device_kind,
        "card": card_info(),
    }
    for mode in args.modes.split(","):
        # slice per client, then per request
        per_client = args.requests_per_client * args.request_kmers
        batches_by_client = []
        for c in range(args.clients):
            chunk = strings[c * per_client : (c + 1) * per_client]
            batches_by_client.append([
                chunk[i * args.request_kmers : (i + 1) * args.request_kmers]
                for i in range(args.requests_per_client)
            ])
        # warm this mode's program once (tiny request)
        warm_lat, warm_cnt, errs = [], [], []
        client_worker(port, [strings[:4]], mode, warm_lat, warm_cnt, errs)
        if errs:
            print(json.dumps({"error": f"warmup {mode}: {errs[0]}"}))
            return 1
        pack_before = dict(getattr(engine, "pack_stats", {}) or {})
        latencies: list[tuple[int, float]] = []
        counts: list[int] = []
        threads = [
            threading.Thread(
                target=client_worker,
                args=(port, batches_by_client[c], mode, latencies, counts,
                      errs),
            )
            for c in range(args.clients)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        if errs:
            print(json.dumps({"error": f"{mode}: {errs[0]}"}))
            return 1
        served = sum(counts)
        lat = np.array([t for _, t in latencies])
        # startup transients (every client's first request lands while
        # the queue warms) reported separately from steady state
        steady = np.array([t for seq, t in latencies if seq > 0])
        result[f"{mode}_qps"] = round(served / dt)
        result[f"{mode}_request_p50_ms"] = round(
            float(np.median(lat)) * 1e3, 2
        )
        result[f"{mode}_request_p95_ms"] = round(
            float(np.percentile(lat, 95)) * 1e3, 2
        )
        result[f"{mode}_request_max_ms"] = round(float(lat.max()) * 1e3, 2)
        if len(steady):
            result[f"{mode}_steady_p95_ms"] = round(
                float(np.percentile(steady, 95)) * 1e3, 2
            )
        result[f"{mode}_queries"] = served
        pack = dict(getattr(engine, "pack_stats", {}) or {})
        if pack:
            # sparse-pack overflow accounting for THIS mode's run
            # (how often does /samples spill to the dense fallback, and
            # how many bytes actually moved)
            delta = {
                kk: pack.get(kk, 0) - pack_before.get(kk, 0) for kk in pack
            }
            nb = max(delta.get("batches", 0), 1)
            result[f"{mode}_pack_batches"] = delta.get("batches", 0)
            result[f"{mode}_dense_fallback_rate"] = round(
                (delta.get("hist_dense_fallbacks", 0)
                 + delta.get("hits_dense_fallbacks", 0)) / nb, 4
            )
            result[f"{mode}_sparse_mib"] = round(
                delta.get("sparse_bytes", 0) / 2**20, 2
            )
            result[f"{mode}_dense_mib"] = round(
                delta.get("dense_bytes", 0) / 2**20, 2
            )
    result["value"] = result.get("count_qps", 0)
    # vs device-side search throughput: the dispatcher+JSON overhead factor
    (REPO / args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
