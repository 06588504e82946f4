#!/usr/bin/env python
"""Multi-process scaling efficiency on the CPU rig (BASELINE.json metric 3).

It measures multi-process overhead without a cluster: the 1 → N host
efficiency pinned by BASELINE.json ("≥80% at 2+ hosts") is proxied by the
SAME global workload over the SAME total virtual device count, run (a) as
one process and (b) as N processes joined through
``jax.distributed`` with real cross-process collectives.  The ratio
isolates exactly the thing multi-host adds — cross-process collective +
dispatch overhead — while holding compute constant.  It says nothing
about a GPU interconnect: the transport is XLA-CPU's gRPC.

Writes BENCH_scaling.json at the repo root and prints one JSON line:

    {"metric": "multihost_scaling_efficiency", "value": 0.93, ...}
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(
    nproc: int,
    local_devices: int,
    batch_global: int,
    iters: int,
    config: str,
    num_shards: int = 0,
) -> dict:
    """Launch an nproc multihost_bench group; return process 0's JSON."""
    port = _free_port()
    cmd = [
        sys.executable, "-m", "readserver_tpu.bench.multihost_bench",
        "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", str(nproc),
        "--local-devices", str(local_devices),
        "--batch", str(batch_global // nproc),
        "--iters", str(iters),
        "--config", config,
        "--num-shards", str(num_shards),
    ]
    procs = [
        subprocess.Popen(
            cmd + ["--process-id", str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=REPO,
        )
        for i in range(nproc)
    ]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        # never orphan a group: a stuck member would keep the
        # jax.distributed coordinator port and CPU forever (killed by
        # exact PID — these are OUR children, never a pattern match)
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"group member failed:\n{out[-2000:]}")
    line = [l for l in outs[0].splitlines() if l.startswith("{")][-1]
    return json.loads(line)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="small")
    ap.add_argument("--batch", type=int, default=512,
                    help="GLOBAL batch (split across processes)")
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--devices", type=int, default=4,
                    help="total virtual devices for the HEADLINE rig. "
                         "4 = the smallest mesh whose dp axis covers 2 "
                         "processes (per-host ingest needs dp >= nproc) "
                         "while keeping a 2-wide shard/psum axis; both "
                         "sides run the same 4-device footprint")
    ap.add_argument("--nprocs", default="2",
                    help="comma-separated process counts to measure")
    ap.add_argument("--num-shards", type=int, default=2,
                    help="shard-axis size, held CONSTANT across every run")
    ap.add_argument("--group-repeats", type=int, default=5,
                    help="run each (nproc, mesh) config N times, keep the "
                         "best — the host scheduler adds run-to-run noise")
    ap.add_argument("--aux-devices", type=int, default=8,
                    help="secondary oversubscribed rig (recorded with a "
                         "caveat, nprocs 2 and 4); 0 disables")
    ap.add_argument("--sweep-batches", default="",
                    help="comma-separated GLOBAL batch sizes: run a "
                         "2-process batch-amortization sweep only and "
                         "merge it into the existing BENCH_scaling.json "
                         "(the per-collective rendezvous is a fixed cost "
                         "per step, so eff_same_shape should rise with "
                         "per-step work)")
    args = ap.parse_args()
    nprocs = [int(x) for x in args.nprocs.split(",")]

    def best_group(nproc, local, shards, batch=None):
        """Median-of-N group runs, repeats recorded: the 2-core host's
        scheduling of collective rendezvous is bimodal, and a best-of
        statistic amplifies that noise when it lands in a ratio's
        numerator and denominator independently."""
        rs = []
        for _ in range(max(args.group_repeats, 1)):
            r = run_group(
                nproc, local, batch or args.batch, args.iters, args.config,
                num_shards=shards,
            )
            assert r["parity_bad"] == 0
            rs.append(r)
        rs.sort(key=lambda r: r["value"])
        med = rs[len(rs) // 2]
        med["repeat_values"] = [r["value"] for r in rs]
        return med

    if args.sweep_batches:
        t0 = time.time()
        sweep = {}
        for b in (int(x) for x in args.sweep_batches.split(",")):
            one = best_group(1, args.devices, args.num_shards, batch=b)
            two = best_group(2, args.devices // 2, args.num_shards, batch=b)
            sweep[b] = {
                "qps_1proc": one["value"],
                "qps_2proc": two["value"],
                "eff_same_shape": round(two["value"] / one["value"], 3),
                "repeat_qps_1proc": one["repeat_values"],
                "repeat_qps_2proc": two["repeat_values"],
            }
            print(f"# batch {b}: eff {sweep[b]['eff_same_shape']}",
                  file=sys.stderr)
        out = REPO / "BENCH_scaling.json"
        result = json.loads(out.read_text()) if out.exists() else {}
        result["batch_amortization"] = {
            "note": "2-process same-shape efficiency vs GLOBAL batch: the "
                    "gRPC rendezvous is a fixed per-collective cost, so "
                    "efficiency amortizes as per-step work grows — the "
                    "regime a production batch size actually serves in",
            "sweep": sweep,
            "wall_s": round(time.time() - t0, 1),
        }
        out.write_text(json.dumps(result, indent=2))
        print(json.dumps({"batch_amortization": sweep}))
        return 0

    def measure(devices, nproc_list, shards):
        """Same-mesh efficiency: the only varied factor is process count
        (a control with shard=devices would be a different program whose
        psum fan-in and table sizes differ)."""
        one = best_group(1, devices, shards)
        runs = {}
        for n in nproc_list:
            r = best_group(n, devices // n, shards)
            assert (r["shards"], r["dp"]) == (one["shards"], one["dp"])
            runs[n] = r
        return one, runs

    t0 = time.time()
    one_same, runs = measure(args.devices, nprocs, args.num_shards)
    # Control B — the DEPLOYMENT shape a real 1-host serving process would
    # pick (shard axis = all local devices); ratio vs this mixes
    # decomposition change with process count, recorded for operators.
    one_deploy = best_group(1, args.devices, args.devices)
    eff_same = {
        n: round(r["value"] / one_same["value"], 3) for n, r in runs.items()
    }
    eff_deploy = {
        n: round(r["value"] / one_deploy["value"], 3)
        for n, r in runs.items()
    }
    headline = min(eff_same.values())
    result = {
        "metric": "multihost_scaling_efficiency",
        "value": headline,
        "unit": "qps_Nproc / qps_1proc, identical (dp,shard) mesh",
        "vs_baseline": round(headline / 0.8, 3),  # target >= 0.8
        "config": args.config,
        "global_batch": args.batch,
        "devices": args.devices,
        "num_shards": args.num_shards,
        "dp": one_same["dp"],
        "qps_1proc_same_shape": one_same["value"],
        "qps_1proc_deployment_shape": one_deploy["value"],
        "qps_nproc": {n: r["value"] for n, r in runs.items()},
        "repeat_qps_1proc_same_shape": one_same.get("repeat_values"),
        "repeat_qps_nproc": {
            n: r.get("repeat_values") for n, r in runs.items()
        },
        "eff_same_shape": eff_same,
        "eff_deployment_shape": eff_deploy,
        "eff_dp_only_deployment_layout": None,  # filled below
        "note": (
            "CPU-rig proxy: identical (dp,shard) mesh, workload, and "
            "total virtual-device footprint in every run — the only "
            "program-level difference in eff_same_shape is the "
            "jax.distributed process boundary on the per-step psum path. "
            "Measured diagnosis: with shards=1 (ZERO collectives in the "
            "program) 2 processes beat 1 (eff_dp_only >= 1.0), so the "
            "same-shape gap is entirely the XLA CPU runtime's "
            "per-collective gRPC rendezvous, which fires even though "
            "every psum group lies within one process — an artifact of "
            "the CPU transport.  The deployment routes ALL per-step "
            "psums within a host by construction (make_global_mesh), "
            "so its cross-host axis is dp — eff_dp_only_deployment_layout is the "
            "deployment-faithful scaling number; eff_same_shape is the "
            "conservative bound."
        ),
    }
    # dp-only rig: shards=1 → the compiled program carries ZERO
    # collectives, so this measures the deployment's actual cross-process
    # axis (make_global_mesh pins 'shard' inside a host BY DESIGN — "the
    # per-step psum merges then never cross DCN"; adding a host adds dp
    # rows only).  The gap between this and eff_same_shape is the XLA CPU
    # runtime's per-collective global rendezvous, which fires even when
    # every psum group is entirely within one process — a CPU-transport
    # artifact.
    dp_one, dp_runs = measure(args.devices, nprocs, 1)
    result_dp = {
        n: round(r["value"] / dp_one["value"], 3) for n, r in dp_runs.items()
    }
    result["eff_dp_only_deployment_layout"] = result_dp
    result["qps_dp_only_1proc"] = dp_one["value"]
    result["qps_dp_only_nproc"] = {n: r["value"] for n, r in dp_runs.items()}
    if args.aux_devices:
        # oversubscribed rig: more virtual devices than cores; the 1-proc
        # control is thread-parallel while N-proc runs are process-
        # parallel, so this ratio folds host scheduling into the number —
        # recorded for completeness, NOT the headline
        aux_nprocs = [n for n in (2, 4) if args.aux_devices % n == 0]
        aux_one, aux_runs = measure(
            args.aux_devices, aux_nprocs, args.num_shards
        )
        result["oversubscribed_rig"] = {
            "devices": args.aux_devices,
            "qps_1proc": aux_one["value"],
            "qps_nproc": {n: r["value"] for n, r in aux_runs.items()},
            "eff_same_shape": {
                n: round(r["value"] / aux_one["value"], 3)
                for n, r in aux_runs.items()
            },
            "caveat": "1-proc control is thread-parallel on a 2-core "
                      "host; ratios fold in OS scheduling, not just "
                      "collective overhead",
        }
    result["wall_s"] = round(time.time() - t0, 1)
    (REPO / "BENCH_scaling.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
