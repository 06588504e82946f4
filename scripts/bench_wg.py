#!/usr/bin/env python
"""Config-4 (wg) bench: whole-genome scale fraction where sharding is a
correctness requirement, served on one chip (BASELINE.json:10).

At the built scale the global BWT exceeds the int32 position range a
single DeviceIndex can address (n > 2^31 — index/builder refuses the
monolithic build) and the full tier set is several times one chip's HBM,
so the ONLY correct deployment is the doc-sharded cohort: independent
per-shard FM-indexes, counts/histograms merged at the end, read ids
mapped to the global space — `MultiEngine` time-multiplexes the shards
on this host's single chip (a pod slice would run them device-parallel
via `parallel/doc_sharded.py`, same answers by construction).

    python scripts/build_wg.py --scale 0.05 --shards 5   # hours, resumable
    python scripts/bench_wg.py --scale 0.05 --shards 5

Writes BENCH_wg.json and prints one JSON line.
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
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--shards", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--parity-queries", type=int, default=128)
    ap.add_argument("--hbm-budget-gb", type=float, default=14.0,
                    help="total chip budget split across shard engines")
    ap.add_argument("--drop-tiers", default="",
                    help="comma-separated tiers force-excluded from each "
                         "shard's HBM plan (budget reallocates): "
                         "'rank2' yields the dsa-resident resolve profile")
    args = ap.parse_args()

    import jax

    from readserver_tpu import alphabet
    from readserver_tpu.runtime import card_info
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.corpus import simulate
    from readserver_tpu.index.cohort import load_cohort
    from readserver_tpu.oracle.naive import window_multiset_counts
    from readserver_tpu.serve.engine import MultiEngine

    sys.path.insert(0, str(REPO / "scripts"))
    from build_wg import wg_cache

    cache = wg_cache(args.scale, args.shards)
    if not (cache / "cohort.json").exists():
        print(json.dumps({"error": f"build first: {cache} missing"}))
        return 1
    t0 = time.time()
    parts, manifest = load_cohort(cache, mmap=True)
    n_total = sum(p.n for p in parts)
    assert n_total >= (1 << 31), (
        "wg demo must exceed the int32 single-device range"
    )
    # split the chip budget across the time-multiplexed shard engines
    cfg = ServeConfig(
        batch_size=args.batch,
        max_hits=64,
        hbm_budget_gb=args.hbm_budget_gb / len(parts),
        drop_tiers=tuple(
            t.strip() for t in args.drop_tiers.split(",") if t.strip()
        ),
    )
    eng = MultiEngine(parts, cfg)
    eng.warmup()
    plans = [e.tier_plan for e in eng.engines]
    print(
        f"# wg: n={n_total} ({n_total/(1<<31):.2f}x int32 range), "
        f"{len(parts)} shards, per-shard tiers="
        f"{sorted(plans[0].keep) or ['base-only']}, "
        f"engine up at {time.time()-t0:.0f}s",
        file=sys.stderr, flush=True,
    )

    spec = simulate.CONFIGS["wg"]
    k = spec.kmer_len
    B = args.batch
    total_q = B * args.iters
    pcf = cache / "parity_cache.npz"
    mat = None
    if pcf.exists():
        # build-time oracle cache: fixed query pool with exact counts for
        # every entry — the bench needs neither the 22M-read simulation
        # nor the multi-minute window-multiset sort
        z = np.load(pcf)
        pool, pool_counts = z["queries"], z["counts"]
        km_codes = pool[np.arange(total_q) % len(pool)]
        want = pool_counts[np.arange(total_q) % len(pool)]
        parity_source = "cached"
    else:
        corpus = simulate.simulate_config("wg", scale=args.scale)
        mat = corpus.reads[0].base
        corpus.reads.clear()
        rng = np.random.default_rng(41)
        rows = rng.integers(0, mat.shape[0], size=total_q)
        offs = rng.integers(0, mat.shape[1] - k + 1, size=total_q)
        km_codes = mat[rows[:, None], offs[:, None] + np.arange(k)[None, :]]
        miss = rng.random(total_q) < 0.1
        km_codes[miss] = rng.integers(1, 5, size=(int(miss.sum()), k))
        want = None
        parity_source = "multiset"
    kmers = ["".join(alphabet.decode(c)) for c in km_codes]
    print(f"# queries staged ({parity_source}) at {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)

    res0 = eng.query_batch(kmers[:B])
    nchk = min(args.parity_queries, B)
    if want is None:
        want = window_multiset_counts(mat, km_codes[:nchk].astype(np.uint8))
    for i in range(nchk):
        if res0[i].count != int(want[i]):
            print(json.dumps({
                "error": f"count parity q{i}: {res0[i].count} != "
                         f"{int(want[i])}"
            }))
            return 1
        # every enumerated hit must spell the query (global read-id
        # space); spelled against mat when simulated, else against the
        # engine's cold corpus store
        for h in res0[i].hits:
            r, o = h["read_id"], h["offset"]
            text = (
                mat[r] if mat is not None
                else alphabet.encode(eng.read_sequence(r))
            )
            if not np.array_equal(text[o : o + k], km_codes[i]):
                print(json.dumps({"error": f"hit parity q{i}"}))
                return 1
    print(f"# parity OK ({nchk} counts + hit spells, {parity_source}) at "
          f"{time.time()-t0:.0f}s", file=sys.stderr, flush=True)

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
    if hasattr(eng, "query_batches"):
        eng.query_batches(batches)
    else:
        for b_ in batches:
            eng.query_batch(b_)
    dt = time.perf_counter() - t1
    t2 = time.perf_counter()
    if hasattr(eng, "count_batches"):
        eng.count_batches(batches)
    else:
        for b_ in batches:
            eng.count_batch(b_)
    dtc = time.perf_counter() - t2

    # single-batch breakdown: where does a full-attribution batch's time
    # go — device compute, the device->host transfer, or host assembly
    extras = {}
    t = time.perf_counter()
    pend = eng._dispatch_merged(batches[0])
    jax.block_until_ready(pend[-1])
    extras["device_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    t = time.perf_counter()
    arr = np.asarray(pend[-1][0])
    extras["transfer_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    extras["transfer_mib"] = round(arr.nbytes / 2**20, 3)
    t = time.perf_counter()
    eng._assemble_merged(*pend)
    extras["assemble_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    # and the count tier's split (the 6,430 q/s question): one count
    # dispatch + its merged transfer
    codes, lengths, nqc = eng.engines[0]._pad_encode(batches[0])
    t = time.perf_counter()
    outs = tuple(
        e._dispatch_single(codes, lengths, nqc, True) for e in eng.engines
    )
    merged_c = eng._merge_count_jit(outs)
    jax.block_until_ready(merged_c)
    extras["count_device_ms"] = round((time.perf_counter() - t) * 1e3, 1)
    t = time.perf_counter()
    np.asarray(merged_c)
    extras["count_transfer_ms"] = round((time.perf_counter() - t) * 1e3, 1)

    result = {
        "metric": "wg_sharded_queries_per_s",
        "value": round(B * args.iters / dt),
        "unit": "full search+resolve+attribution queries/s",
        "vs_baseline": None,
        "config": "wg",
        "scale": args.scale,
        "n_symbols": int(n_total),
        "int32_range_multiple": round(n_total / (1 << 31), 2),
        "num_reads": int(manifest["num_reads"]),
        "doc_shards": len(parts),
        "deployment": "multi-engine (1 chip, time-multiplexed)",
        "per_shard_tiers": sorted(plans[0].keep),
        "count_queries_per_s": round(B * args.iters / dtc),
        "batch": B,
        "max_hits": cfg.max_hits,
        "exact_attribution": True,
        "parity_queries": nchk,
        "parity_source": parity_source,
        "drop_tiers": list(cfg.drop_tiers),
        "device": jax.devices()[0].device_kind,
        "card": card_info(),
        **extras,
    }
    (REPO / "BENCH_wg.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
