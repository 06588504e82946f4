#!/usr/bin/env python
"""Config-5 bench: multi-sample cohort attribution at spec size
(BASELINE.json:11 — 128 samples, population presence queries with
per-sample hit attribution).

Builds the cohort via the out-of-core streaming path (doc shards), serves
it on the available device(s) (MultiEngine time-multiplexed when shards >
devices — the one-chip deployment), measures full attribution queries/s,
and parity-checks counts (2-bit window multiset) AND exact per-sample
histograms (vectorized host oracle) for a query sample.

    python scripts/bench_cohort.py [--scale 1.0] [--shards 4] [--batch 4096]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def host_attribution_oracle(mat, sample_ids, num_samples, kmer):
    """Exact per-sample occurrence counts of `kmer` (vectorized scan)."""
    k = len(kmer)
    m, L = mat.shape
    per_read = np.zeros(m, dtype=np.int64)
    for off in range(L - k + 1):
        per_read += (mat[:, off : off + k] == kmer).all(axis=1)
    return np.bincount(
        sample_ids, weights=per_read, minlength=num_samples
    ).astype(np.int64)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--parity-queries", type=int, default=16)
    args = ap.parse_args()

    import jax

    from readserver_tpu import alphabet
    from readserver_tpu.runtime import card_info
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.corpus import simulate
    from readserver_tpu.index.cohort import build_cohort, load_cohort
    from readserver_tpu.oracle.naive import window_multiset_counts
    from readserver_tpu.serve import QueryEngine
    from readserver_tpu.serve.engine import MultiEngine

    t0 = time.time()
    corpus = simulate.simulate_config("cohort", scale=args.scale)
    S = corpus.spec.num_samples
    cache = REPO / "data" / f"bench_cohort_s{args.scale:g}_d{args.shards}"
    if not (cache / "cohort.json").exists():
        build_cohort(
            corpus.reads,
            corpus.sample_ids,
            args.shards,
            cache,
            sample_names=[f"s{i:03d}" for i in range(S)],
        )
    parts, _manifest = load_cohort(cache, mmap=False)
    n_total = sum(p.n for p in parts)
    print(
        f"# cohort: {S} samples, {len(corpus.reads)} reads, n={n_total}, "
        f"{args.shards} shards, prep {time.time()-t0:.0f}s",
        file=sys.stderr,
    )

    cfg = ServeConfig(batch_size=args.batch, max_hits=64)
    devs = jax.devices()
    if len(devs) >= len(parts):
        from readserver_tpu.parallel import make_mesh

        mesh = make_mesh(
            data_parallel=1, num_shards=len(parts),
            devices=devs[: len(parts)],
        )
        eng = QueryEngine(parts, cfg, mesh=mesh)
        deploy = "doc-sharded"
    else:
        eng = MultiEngine(parts, cfg)
        deploy = "multi-engine"
    eng.warmup()
    print(f"# engine up ({deploy}) at {time.time()-t0:.0f}s", file=sys.stderr)

    k = corpus.spec.kmer_len
    B = args.batch
    km_codes = simulate.sample_query_kmers_fast(
        corpus, B * args.iters, k, seed=17, miss_frac=0.1
    )
    kmers = [alphabet.decode(km_codes[i]) for i in range(B * args.iters)]

    # parity: counts for ALL of batch 0 (window multiset) + exact
    # attribution histograms for a random sample of queries
    res0 = eng.query_batch(kmers[:B])
    mat = np.stack(corpus.reads)
    want_counts = window_multiset_counts(mat, km_codes[:B])
    for i, r in enumerate(res0):
        if r.count != int(want_counts[i]):
            print(json.dumps({"error": f"count parity q{i}"}))
            return 1
    rng = np.random.default_rng(23)
    nchk = min(args.parity_queries, B)
    for i in rng.choice(B, nchk, replace=False):
        r = res0[int(i)]
        if not r.sample_hist_complete:
            print(json.dumps({"error": f"incomplete hist q{i}"}))
            return 1
        want = host_attribution_oracle(
            mat, corpus.sample_ids, S, km_codes[int(i)]
        )
        got = np.zeros(S, dtype=np.int64)
        for nm, c in (r.sample_hist or {}).items():
            got[int(nm[1:])] = c
        if not np.array_equal(got, want):
            print(json.dumps({"error": f"attribution parity q{i}"}))
            return 1
    print(f"# parity OK ({B} counts, {nchk} exact histograms) at "
          f"{time.time()-t0:.0f}s", file=sys.stderr)

    # bulk path: MultiEngine.query_batches pipelines device compute of
    # batch i+1 behind transfer+assembly of batch i (one chip serving all
    # shards); plain loop otherwise
    t1 = time.perf_counter()
    if hasattr(eng, "query_batches"):
        eng.query_batches(
            [kmers[it * B : (it + 1) * B] for it in range(args.iters)]
        )
    else:
        for it in range(args.iters):
            eng.query_batch(kmers[it * B : (it + 1) * B])
    dt = time.perf_counter() - t1

    extras = {}
    if hasattr(eng, "_dispatch_merged"):
        # single-batch breakdown: device compute vs host transfer vs
        # assembly (partitions merge and sparse-compact on device, so the
        # transfer is one small buffer)
        import jax

        t = time.perf_counter()
        pend = eng._dispatch_merged(kmers[:B])
        jax.block_until_ready(pend[-1])
        extras["device_ms"] = round((time.perf_counter() - t) * 1e3, 1)
        t = time.perf_counter()
        arr = np.asarray(pend[-1][0])
        extras["transfer_ms"] = round((time.perf_counter() - t) * 1e3, 1)
        extras["transfer_mib"] = round(arr.nbytes / 2**20, 2)
        t = time.perf_counter()
        eng._assemble_merged(*pend)
        extras["assemble_ms"] = round((time.perf_counter() - t) * 1e3, 1)

        # adversarial rung: a batch of the most frequent
        # sampled k-mer exercises the exact-attribution sweep at volume;
        # rerun with an undersized max_sweep_rows to pin the cap contract
        # (complete=False, answers never wrong) as a recorded number
        hot = int(np.argmax(want_counts))
        hot_batch = [kmers[hot]] * B
        rows_needed = int(want_counts[hot]) * B
        eng.query_batch(hot_batch)  # warm
        t = time.perf_counter()
        res_hot = eng.query_batch(hot_batch)
        extras["hot_kmer_batch_ms"] = round((time.perf_counter() - t) * 1e3, 1)
        extras["hot_kmer_count"] = int(want_counts[hot])
        extras["hot_kmer_sweep_rows"] = rows_needed
        extras["hot_kmer_complete_frac"] = round(
            sum(r.sample_hist_complete for r in res_hot) / B, 3
        )
        # the cap binds in whole sweep-window rounds and applies PER
        # SHARD (each doc shard sweeps its own intervals: worklist ≈
        # count·B/S rows), so pick window == cap, both well under one
        # shard's worklist
        cap = B // 8
        capped_cfg = ServeConfig(
            batch_size=B, max_hits=64, max_sweep_rows=cap, sweep_window=cap
        )
        eng_cap = MultiEngine(parts, capped_cfg)
        eng_cap.query_batch(hot_batch)  # warm/compile
        t = time.perf_counter()
        res_cap = eng_cap.query_batch(hot_batch)
        extras["capped_batch_ms"] = round((time.perf_counter() - t) * 1e3, 1)
        extras["capped_max_sweep_rows"] = cap
        extras["capped_complete_frac"] = round(
            sum(r.sample_hist_complete for r in res_cap) / B, 3
        )
        # the cap must cut off, not silently lie: incomplete flags pop and
        # counts are still exact
        assert extras["capped_complete_frac"] < 1.0
        assert all(r.count == int(want_counts[hot]) for r in res_cap)

    result = {
        "metric": "cohort_attribution_queries_per_s",
        "value": round(B * args.iters / dt),
        "unit": "queries/s",
        "config": "cohort",
        "scale": args.scale,
        "num_samples": S,
        "num_reads": len(corpus.reads),
        "n_symbols": int(n_total),
        "doc_shards": args.shards,
        "deployment": deploy,
        "batch": B,
        "max_hits": cfg.max_hits,
        "exact_attribution": True,
        "parity_counts": B,
        "parity_histograms": nchk,
        "device": devs[0].device_kind,
        "card": card_info(),
        **extras,
    }
    (REPO / "BENCH_cohort.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
