#!/usr/bin/env python
"""Config-5 bench AT config-5 scale: 128 samples x 1.03e9 symbols.

BASELINE.json:11 pins "multi-sample cohort
(UK10K-style, 100+ samples): population-scale k-mer presence queries with
per-sample hit attribution", and no prior artifact combined both axes.
Serves the prebuilt cohort_big artifact (scripts/build_cohort_big.py) on
one chip via MultiEngine (4 doc shards, time-multiplexed, device-side
merge + sparse pack), measures exact-attribution queries/s with the
device/transfer/assembly breakdown, and parity-checks counts AND exact
128-wide per-sample histograms against the build-time oracle cache.

    python scripts/bench_cohort_big.py [--shards 4] [--batch 4096]

Writes BENCH_cohort_big.json; prints one JSON line.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--hbm-budget-gb", type=float, default=14.0,
                    help="total chip budget split across shard engines")
    args = ap.parse_args()

    import jax

    from readserver_tpu import alphabet
    from readserver_tpu.runtime import card_info
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.index.cohort import load_cohort
    from readserver_tpu.serve.engine import MultiEngine

    sys.path.insert(0, str(REPO / "scripts"))
    from build_cohort_big import cache_dir

    cache = cache_dir(args.shards)
    pcf = cache / "parity_cache.npz"
    if not (cache / "cohort.json").exists() or not pcf.exists():
        print(json.dumps({
            "error": f"build first: python scripts/build_cohort_big.py "
                     f"--shards {args.shards} ({cache} incomplete)"
        }))
        return 1

    t0 = time.time()
    parts, manifest = load_cohort(cache, mmap=True)
    n_total = sum(p.n for p in parts)
    S = int(manifest["num_samples"])
    assert S >= 100 and n_total >= 1_000_000_000, (
        "cohort_big must hit BOTH config-5 axes (100+ samples, >=1e9 "
        f"symbols); got {S} samples, n={n_total}"
    )
    cfg = ServeConfig(
        batch_size=args.batch,
        max_hits=64,
        hbm_budget_gb=args.hbm_budget_gb / len(parts),
    )
    eng = MultiEngine(parts, cfg)
    eng.warmup()
    plans = [e.tier_plan for e in eng.engines]
    print(
        f"# cohort_big: {S} samples, n={n_total}, {len(parts)} shards, "
        f"per-shard tiers={sorted(plans[0].keep) or ['base-only']}, "
        f"engine up at {time.time()-t0:.0f}s",
        file=sys.stderr, flush=True,
    )

    z = np.load(pcf)
    pool, pool_counts = z["queries"], z["counts"]
    hist_idx, hists = z["hist_idx"], z["hists"]
    k = pool.shape[1]
    B = args.batch
    total_q = B * args.iters
    km_codes = pool[np.arange(total_q) % len(pool)]
    want = pool_counts[np.arange(total_q) % len(pool)]
    kmers = ["".join(alphabet.decode(c)) for c in km_codes]

    # ---- parity: counts for a full batch + ALL cached exact histograms
    res0 = eng.query_batch(kmers[:B])
    for i in range(B):
        if res0[i].count != int(want[i]):
            print(json.dumps({
                "error": f"count parity q{i}: {res0[i].count} != "
                         f"{int(want[i])}"
            }))
            return 1
    hq_kmers = ["".join(alphabet.decode(pool[q])) for q in hist_idx]
    hres = eng.query_batch(hq_kmers)
    for j, r in enumerate(hres):
        if not r.sample_hist_complete:
            print(json.dumps({"error": f"incomplete hist hq{j}"}))
            return 1
        got = np.zeros(S, dtype=np.int64)
        for nm, c in (r.sample_hist or {}).items():
            got[int(nm[1:])] = c
        if not np.array_equal(got, hists[j]):
            print(json.dumps({"error": f"attribution parity hq{j}"}))
            return 1
    print(
        f"# parity OK ({B} counts, {len(hist_idx)} exact {S}-wide "
        f"histograms) at {time.time()-t0:.0f}s",
        file=sys.stderr, flush=True,
    )

    # ---- throughput: pipelined full-attribution batches
    batches = [kmers[it * B : (it + 1) * B] for it in range(args.iters)]
    # warm passes: any first-use compile (real-pool shapes) must land
    # outside the measured window
    if hasattr(eng, "query_batches"):
        eng.query_batches(batches[:1])
    else:
        eng.query_batch(batches[0])
    if hasattr(eng, "count_batches"):
        eng.count_batches(batches[:1])
    else:
        eng.count_batch(batches[0])
    t1 = time.perf_counter()
    eng.query_batches(batches)
    dt = time.perf_counter() - t1
    t2 = time.perf_counter()
    if hasattr(eng, "count_batches"):
        eng.count_batches(batches)
    else:
        for b_ in batches:
            eng.count_batch(b_)
    dtc = time.perf_counter() - t2

    # ---- single-batch breakdown: device vs transfer vs assembly
    extras = {}
    t = time.perf_counter()
    pend = eng._dispatch_merged(kmers[:B])
    jax.block_until_ready(pend[-1])
    extras["device_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    t = time.perf_counter()
    arr = np.asarray(pend[-1][0])
    extras["transfer_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    extras["transfer_mib"] = round(arr.nbytes / 2**20, 3)
    t = time.perf_counter()
    eng._assemble_merged(*pend)
    extras["assemble_ms"] = round((time.perf_counter() - t) * 1e3, 1)

    # ---- adversarial rungs: hottest pool k-mer at volume, then a
    # deliberately undersized sweep cap (flags pop, answers never wrong)
    hot = int(np.argmax(pool_counts))
    hot_batch = ["".join(alphabet.decode(pool[hot]))] * B
    hot_count = int(pool_counts[hot])
    eng.query_batch(hot_batch)  # warm
    t = time.perf_counter()
    res_hot = eng.query_batch(hot_batch)
    extras["hot_kmer_batch_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    extras["hot_kmer_count"] = hot_count
    extras["hot_kmer_complete_frac"] = round(
        sum(r.sample_hist_complete for r in res_hot) / B, 3
    )
    cap = B // 8
    # free the main engine's HBM first: two resident MultiEngines at this
    # scale (2 x 4 x 2.37 GiB + LUTs + workspace) exhaust the chip
    del eng
    import gc

    gc.collect()
    eng_cap = MultiEngine(parts, ServeConfig(
        batch_size=B, max_hits=64, max_sweep_rows=cap, sweep_window=cap,
        hbm_budget_gb=args.hbm_budget_gb / len(parts),
    ))
    eng_cap.query_batch(hot_batch)  # warm/compile
    t = time.perf_counter()
    res_cap = eng_cap.query_batch(hot_batch)
    extras["capped_batch_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    extras["capped_max_sweep_rows"] = cap
    extras["capped_complete_frac"] = round(
        sum(r.sample_hist_complete for r in res_cap) / B, 3
    )
    assert extras["capped_complete_frac"] < 1.0
    assert all(r.count == hot_count for r in res_cap)

    result = {
        "metric": "cohort_big_attribution_queries_per_s",
        "value": round(B * args.iters / dt),
        "unit": "full search+resolve+attribution queries/s",
        "vs_baseline": None,
        "config": "cohort_big",
        "num_samples": S,
        "num_reads": int(manifest["num_reads"]),
        "n_symbols": int(n_total),
        "doc_shards": len(parts),
        "deployment": "multi-engine (1 chip, time-multiplexed)",
        "per_shard_tiers": sorted(plans[0].keep),
        "count_queries_per_s": round(B * args.iters / dtc),
        "batch": B,
        "max_hits": cfg.max_hits,
        "exact_attribution": True,
        "parity_counts": B,
        "parity_histograms": int(len(hist_idx)),
        "parity_source": "cached",
        "device": jax.devices()[0].device_kind,
        "card": card_info(),
        **extras,
    }
    (REPO / "BENCH_cohort_big.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
