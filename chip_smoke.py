#!/usr/bin/env python
"""Smoke run of the served query path on the GPU, with exact answers.

    python chip_smoke.py                 # one card: E. coli 30x through REST
    python chip_smoke.py --four-cards    # the multi-card paths, four cards

Default run (one process, card 0 only):

1. device — JAX must report one GPU; on any other platform the script
   exits non-zero before it builds anything.  Prints the card's name and
   power limit (``nvidia-smi``), the JAX/jaxlib versions and device kind.
2. index  — E. coli 30x (BASELINE config 2: 4.6 Mbp, 100 bp reads,
   1.38M reads) simulated from its seed and built with ``sample_rate=32``;
   cached under ``data/`` keyed by config and artifact format version.
3. serve  — the ``cli serve`` path: ``cli._load_engine`` →
   ``engine.warmup()`` → ``serve.http.serve_forever`` on a background
   event loop; ``/health``, then ``/count``, ``/reads`` and ``/samples``
   over loopback HTTP for 384 31-mers (~15% misses) and 16 10-mers (counts
   above ``max_hits``), plus ``both_strands`` queries.
4. device path at full width — the k-step + prefix-LUT search at
   B=262144 against the plain 1-step search, resolve + sample histogram at
   B=16384, H=64, and the rate of XLA's rank gather over the rank table.

``--four-cards`` runs only the two multi-card paths, on four cards:

* the ``cohort`` config (128 samples) built as 4 document shards
  (``cli build --doc-shards 4``), served over the 4-card mesh that
  ``cli._load_engine`` picks, against the oracle and against the same
  artifact served by ``MultiEngine`` on card 0;
* E. coli served interval-sharded (``num_shards=4``) against the one-card
  engine on card 0, plus the compiled step's collective counts.

Every answer is an integer and no floating-point product is on any path
(the package has no dot/matmul/einsum), so TF32 cannot arise and every
comparison is exact equality.  Answers are checked against the NumPy
oracle (2-bit window multiset) and by spelling each hit out of the
simulated reads.  Any failed check raises; the last line of standard
output, printed only when every phase passed, is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import http.client
import json
import os
import re
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_QUERIES = 384       # full-length k-mers sent over REST
MISS_FRAC = 0.15      # share of random (absent) k-mers among them
N_SHORT = 16          # short k-mers whose counts exceed max_hits
SHORT_LEN = 10
N_BOTH = 16           # queries also sent with both_strands=1
BATCH = 256           # `cli serve --batch` default
FULL_B = 262144       # full-width device batch
RES_B, RES_H = 16384, 64
CLIENTS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


class Timer:
    """Phase wall times, printed as each phase ends."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.seconds[name] = dt = time.perf_counter() - t0
        log(f"# phase {name}: {dt:.3f} s")


# ------------------------------------------------------------------ device


def open_devices(count: int):
    """Pin the process to ``count`` GPUs; exit non-zero on anything else.

    Must run before JAX initialises its backend (the visible-device set
    is read once)."""
    import jax

    if count == 1 and "CUDA_VISIBLE_DEVICES" not in os.environ:
        jax.config.update("jax_cuda_visible_devices", "0")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(
            f"chip_smoke: no GPU — JAX found {devs[0].platform!r} devices; "
            "nothing was built"
        )
    if len(devs) != count:
        sys.exit(f"chip_smoke: need {count} GPU(s), JAX sees {len(devs)}")
    return devs


def print_device(devs) -> None:
    import jax
    import jaxlib

    from readserver_tpu.runtime import card_info

    card = card_info()
    check(card is not None, "nvidia-smi reported no card")
    log(f"# card (nvidia-smi name, power.limit): {card}")
    log(
        f"# jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"device_kind {devs[0].device_kind!r} count {len(devs)}"
    )


def memory_line(dev) -> str:
    st = dev.memory_stats() or {}
    return (
        f"bytes_limit {st.get('bytes_limit')} "
        f"peak_bytes_in_use {st.get('peak_bytes_in_use')}"
    )


# ---------------------------------------------------------- index + oracle


def build_config(name: str, data_dir: Path, timer: Timer, scale: float = 1.0,
                 doc_shards: int = 1):
    """→ (artifact path, corpus).  Simulates from the config's seed; builds
    the artifact through ``cli build`` unless it is already cached."""
    from readserver_tpu import cli
    from readserver_tpu.config import IndexConfig
    from readserver_tpu.corpus import simulate
    from readserver_tpu.index import artifact
    from readserver_tpu.index.cohort import is_cohort

    fmt = IndexConfig().format_version
    tag = f"_doc{doc_shards}" if doc_shards > 1 else ""
    path = data_dir / f"smoke_{name}_s{scale:g}{tag}_v{fmt}"
    with timer(f"simulate_{name}"):
        corpus = simulate.simulate_config(name, scale=scale)
    log(f"# {name}: {corpus.num_reads} reads of {corpus.spec.read_len} bp, "
        f"{corpus.spec.num_samples} sample(s)")
    exists = is_cohort(path) if doc_shards > 1 else artifact.artifact_exists(
        path
    )
    if exists:
        log(f"# {name}: artifact cached at {path}")
    else:
        with timer(f"build_{name}"):
            rc = cli.main([
                "build", "--config", name, "--scale", f"{scale:g}",
                "--doc-shards", str(doc_shards), "--out", str(path),
            ])
        check(rc == 0, f"cli build {name} failed (rc {rc})")
    size = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    log(f"# {name}: artifact {size} bytes on disk")
    return path, corpus


def make_queries(corpus, n_queries: int, seed: int = 7) -> list[np.ndarray]:
    """Full-length k-mers (a MISS_FRAC share random) + short k-mers."""
    from readserver_tpu.corpus import simulate

    k = corpus.spec.kmer_len
    full = simulate.sample_query_kmers_fast(
        corpus, n_queries, k, seed=seed, miss_frac=MISS_FRAC
    )
    short = simulate.sample_query_kmers_fast(
        corpus, N_SHORT, SHORT_LEN, seed=seed + 1, miss_frac=0.0
    )
    return list(full) + list(short)


def revcomp(km: np.ndarray) -> np.ndarray:
    return (5 - km)[::-1].astype(np.uint8)


class Oracle:
    """Exact counts, per-sample counts and read matrix for a query set,
    from the simulated reads alone (independent of the index)."""

    def __init__(self, corpus, queries: list[np.ndarray]):
        from readserver_tpu.oracle.naive import window_multiset_counts

        self.mat = np.stack(corpus.reads)
        self.sample_ids = np.asarray(corpus.sample_ids)
        ns = int(self.sample_ids.max()) + 1
        both = queries + [revcomp(q) for q in queries]
        self.count: dict[bytes, int] = {}
        self.per_sample: dict[bytes, np.ndarray] = {}
        for k in sorted({len(q) for q in both}):
            qs = np.stack([q for q in both if len(q) == k])
            tot = window_multiset_counts(self.mat, qs)
            if ns == 1:
                per = tot[:, None]
            else:
                per = np.stack(
                    [
                        window_multiset_counts(
                            self.mat[self.sample_ids == s], qs
                        )
                        for s in range(ns)
                    ],
                    axis=1,
                )
            for q, c, p in zip(qs, tot, per):
                self.count[q.tobytes()] = int(c)
                self.per_sample[q.tobytes()] = p

    def spells(self, read_id: int, offset: int, km: np.ndarray) -> bool:
        m, L = self.mat.shape
        return (
            0 <= read_id < m
            and 0 <= offset <= L - len(km)
            and np.array_equal(self.mat[read_id, offset : offset + len(km)], km)
        )


# ------------------------------------------------------------------- REST


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class BackgroundServer:
    """``serve.http.serve_forever`` on its own event loop thread — the
    code path of ``python -m readserver_tpu.cli serve``."""

    def __init__(self, engine):
        from readserver_tpu.serve.http import serve_forever

        self.port = _free_port()
        self.loop = asyncio.new_event_loop()
        self.task = self.loop.create_task(
            serve_forever(engine, "127.0.0.1", self.port)
        )
        self.thread = threading.Thread(
            target=self._run, daemon=True, name="smoke-rest"
        )
        self.thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.task)
        except asyncio.CancelledError:
            pass

    def get(self, path: str, conn=None) -> dict:
        c = conn or http.client.HTTPConnection(
            "127.0.0.1", self.port, timeout=900
        )
        c.request("GET", path)
        r = c.getresponse()
        body = json.loads(r.read())
        check(r.status == 200, f"GET {path}: HTTP {r.status} {body}")
        if conn is None:
            c.close()
        return body

    def wait_healthy(self, timeout: float = 900.0) -> None:
        deadline = time.time() + timeout
        while True:
            if self.task.done():
                self.task.result()  # re-raise the server's failure
                raise AssertionError("REST server exited")
            try:
                body = self.get("/health")
                check(body == {"status": "ok"}, f"/health: {body}")
                return
            except (ConnectionError, OSError):
                if time.time() > deadline:
                    raise
                time.sleep(0.2)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(timeout=60)
        check(not self.thread.is_alive(), "REST server did not stop")


def rest_answers(server: BackgroundServer, queries, n_both: int) -> dict:
    """/count, /reads, /samples for every query (and /count with
    both_strands for the first ``n_both``), from CLIENTS concurrent
    keep-alive connections so the dispatcher batches them."""
    from readserver_tpu import alphabet

    strs = [alphabet.decode(q) for q in queries]
    local = threading.local()

    def ask(i: int) -> tuple:
        if not hasattr(local, "conn"):
            local.conn = http.client.HTTPConnection(
                "127.0.0.1", server.port, timeout=900
            )
        s = strs[i]
        out = (
            server.get(f"/count?kmer={s}", local.conn),
            server.get(f"/reads?kmer={s}", local.conn),
            server.get(f"/samples?kmer={s}", local.conn),
            server.get(f"/count?kmer={s}&both_strands=1", local.conn)
            if i < n_both else None,
        )
        return out

    with ThreadPoolExecutor(CLIENTS) as ex:
        got = list(ex.map(ask, range(len(strs))))
    return {strs[i]: g for i, g in enumerate(got)}


def check_answers(answers: dict, queries, oracle: Oracle, sample_names,
                  max_hits: int, what: str) -> dict:
    """Every answer against the oracle, exactly.  → summary counts."""
    from readserver_tpu import alphabet

    n_hits = n_trunc = n_miss = 0
    for q in queries:
        s = alphabet.decode(q)
        cnt, reads, samples, both = answers[s]
        want = oracle.count[q.tobytes()]
        check(cnt == {"kmer": s, "count": want},
              f"{what} /count {s}: {cnt} != {want}")
        n_miss += want == 0
        # /reads: every hit spells the k-mer; the set is exact when the
        # count fits max_hits, a truncated subset otherwise
        check(reads["count"] == want, f"{what} /reads count {s}")
        hits = reads["hits"]
        pairs = {(h["read_id"], h["offset"]) for h in hits}
        check(len(pairs) == len(hits), f"{what} /reads {s}: duplicate hit")
        for h in hits:
            check(oracle.spells(h["read_id"], h["offset"], q),
                  f"{what} /reads {s}: hit {h} does not spell the k-mer")
            check(h["sample_id"] == int(oracle.sample_ids[h["read_id"]]),
                  f"{what} /reads {s}: hit {h} has the wrong sample")
        if want <= max_hits:
            check(len(hits) == want and not reads["hits_truncated"],
                  f"{what} /reads {s}: {len(hits)} hits for count {want}")
        else:
            check(0 < len(hits) <= max_hits and reads["hits_truncated"],
                  f"{what} /reads {s}: truncation of {len(hits)}/{want}")
            n_trunc += 1
        n_hits += len(hits)
        # /samples: exact per-sample counts (not capped at max_hits)
        per = oracle.per_sample[q.tobytes()]
        want_hist = {
            sample_names[i]: int(c) for i, c in enumerate(per) if c
        }
        check(samples["count"] == want and samples["samples"] == want_hist
              and samples["samples_exact"],
              f"{what} /samples {s}: {samples} != {want_hist}")
        if both is not None:
            rc = revcomp(q)
            want_b = want + (
                oracle.count[rc.tobytes()] if not np.array_equal(rc, q) else 0
            )
            check(both["count"] == want_b,
                  f"{what} /count both_strands {s}: {both} != {want_b}")
    return {"queries": len(queries), "misses": n_miss, "hits": n_hits,
            "truncated": n_trunc}


def canonical(answers: dict) -> dict:
    """Answers with hit lists as sorted tuples (order is not part of the
    contract between deployments)."""
    out = {}
    for s, (cnt, reads, samples, both) in answers.items():
        hits = sorted(
            (h["read_id"], h["offset"], h["sample_id"]) for h in reads["hits"]
        )
        out[s] = (cnt, reads["count"], hits, reads["hits_truncated"],
                  samples, both)
    return out


def serve_and_check(engine, queries, oracle, what: str, timer: Timer,
                    warmup: bool) -> dict:
    if warmup:
        with timer(f"warmup_{what}"):
            engine.warmup()
    server = BackgroundServer(engine)
    try:
        with timer(f"first_request_{what}"):
            server.wait_healthy()
        with timer(f"rest_{what}"):
            answers = rest_answers(server, queries, N_BOTH)
        summary = check_answers(
            answers, queries, oracle, engine.sample_names, engine.H, what
        )
        stats = server.get("/stats")
    finally:
        server.close()
    log(f"# {what}: REST answers exact vs oracle {json.dumps(summary)}; "
        f"dispatcher {json.dumps(stats, sort_keys=True)[:400]}")
    return answers


# ------------------------------------------------------- one card (default)


def device_path(engine, corpus, oracle, queries, full_b: int, res_b: int,
                timer: Timer, card: str) -> None:
    """Full-width k-step + LUT search vs the plain search (bit-identical),
    resolve + histogram, and the rank gather's rate."""
    import jax
    import jax.numpy as jnp

    from readserver_tpu.corpus import simulate
    from readserver_tpu.ops import (
        backward_search,
        backward_search_pair,
        occ,
        resolve_intervals,
        sample_histogram,
    )

    idx, lut, p = engine.index, engine.lut, engine.lut_p
    k = corpus.spec.kmer_len
    head = np.stack([q for q in queries if len(q) == k])
    kmers = simulate.sample_query_kmers_fast(
        corpus, full_b, k, seed=1, miss_frac=0.1
    )
    kmers[: len(head)] = head
    codes = jnp.asarray(kmers.astype(np.int32))
    lengths = jnp.full(full_b, k, dtype=jnp.int32)
    fast = jax.jit(
        lambda idx, lut, km: backward_search_pair(idx, km, lut, p)
    )
    plain = jax.jit(backward_search)
    with timer("fullwidth_compile_run"):
        lf, uf = jax.block_until_ready(fast(idx, lut, codes))
        lp, up = jax.block_until_ready(plain(idx, codes, lengths))
    lf, uf, lp, up = (np.asarray(x) for x in (lf, uf, lp, up))
    check(np.array_equal(lf, lp) and np.array_equal(uf, up),
          "k-step+LUT search differs from the plain search")
    want = np.array([oracle.count[q.tobytes()] for q in head])
    check(np.array_equal((uf - lf)[: len(head)], want),
          "full-width counts differ from the oracle")
    iters = 10
    t0 = time.perf_counter()
    jax.block_until_ready([fast(idx, lut, codes) for _ in range(iters)])
    dt = time.perf_counter() - t0
    log(f"# full-width B={full_b}: k-step(k={3 if idx.rank3_rows is not None else 2})"
        f"+LUT(p={p}) == plain on all {full_b} queries, {len(head)} oracle "
        f"counts exact; k-step+LUT search {full_b * iters / dt:.0f} "
        f"searches/s ({card})")

    # resolve + sample histogram at the served hit cap
    rb, H = min(res_b, full_b), RES_H

    def res(idx, lut, km):
        l, u = backward_search_pair(idx, km, lut, p)
        rid, off, valid = resolve_intervals(
            idx, l, u, max_hits=H, row_budget=int(0.6 * rb * H)
        )
        return u - l, rid, off, valid, sample_histogram(idx, rid, valid)

    with timer("resolve_compile_run"):
        out = jax.block_until_ready(jax.jit(res)(idx, lut, codes[:rb]))
    cnt, rid, off, valid, hist = (np.asarray(x) for x in out)
    sub = kmers[:rb]
    check(np.array_equal(cnt, uf[:rb] - lf[:rb]), "resolve-step counts")
    nval = valid.sum(axis=1)
    full = cnt <= H
    check(np.array_equal(nval[full], cnt[full]),
          "resolved hits != count where count <= max_hits")
    check((nval <= np.minimum(cnt, H)).all(), "more hits than the interval")
    r = np.where(valid, rid, 0).astype(np.int64)
    o = np.where(valid, off, 0).astype(np.int64)
    m, L = oracle.mat.shape
    check(((r < m) & (o <= L - k)).all(), "hit outside the read store")
    spelled = oracle.mat[r[:, :, None], o[:, :, None] + np.arange(k)]
    check((spelled == sub[:, None, :]).all(axis=2)[valid].all(),
          "a resolved hit does not spell its k-mer")
    key = np.where(valid, r * L + o, -1 - np.arange(H)[None, :])
    key.sort(axis=1)
    check((np.diff(key, axis=1) != 0).all(), "duplicate resolved hit")
    smp = oracle.sample_ids[r]
    want_hist = np.zeros_like(hist)
    rows = np.broadcast_to(np.arange(rb)[:, None], r.shape)
    np.add.at(want_hist, (rows[valid], smp[valid]), 1)
    check(np.array_equal(hist, want_hist), "sample histogram")
    log(f"# resolve B={rb} H={H}: {int(nval.sum())} hits spelled out of "
        f"the reads, histograms exact")

    # the rank gather alone: one 16-byte row per rank, random rows
    rng = np.random.default_rng(5)
    reps = 16
    cs = [jnp.asarray(rng.integers(0, 5, full_b, dtype=np.int32))
          for _ in range(reps)]
    ps = [jnp.asarray(rng.integers(0, idx.n + 1, full_b, dtype=np.int32))
          for _ in range(reps)]
    occ_j = jax.jit(occ)
    jax.block_until_ready(occ_j(idx, cs[0], ps[0]))
    t0 = time.perf_counter()
    jax.block_until_ready([occ_j(idx, c, i) for c, i in zip(cs, ps)])
    dt = time.perf_counter() - t0
    rows_s = full_b * reps / dt
    row_bytes = idx.rank_rows.shape[1] * 4
    log(f"# XLA rank gather (ops.rank.occ) B={full_b} over the "
        f"{idx.rank_rows.nbytes} B rank table: {rows_s:.0f} rows/s, "
        f"{rows_s * row_bytes:.0f} B/s of {row_bytes} B rows "
        f"({rows_s * 32:.0f} B/s in 32 B sectors) ({card})")


def run_one_card(data_dir: Path, timer: Timer, config: str = "ecoli",
                 scale: float = 1.0, full_b: int = FULL_B,
                 res_b: int = RES_B, card: str = "") -> None:
    import jax

    from readserver_tpu import cli

    path, corpus = build_config(config, data_dir, timer, scale)
    queries = make_queries(corpus, N_QUERIES)
    with timer("oracle"):
        oracle = Oracle(corpus, queries)
    misses = sum(oracle.count[q.tobytes()] == 0 for q in queries[:N_QUERIES])
    check(0.10 <= misses / N_QUERIES <= 0.25,
          f"miss share {misses}/{N_QUERIES} outside 10-25%")
    with timer("load_engine"):
        engine = cli._load_engine(str(path), BATCH, 1,
                                  warmup_k=(corpus.spec.kmer_len,))
    plan = engine.tier_plan
    log(f"# tiers_kept {sorted(plan.keep)} tiers_dropped "
        f"{list(plan.dropped)} plan_bytes {plan.total_bytes} "
        f"budget_bytes {plan.budget_bytes}")
    log(f"# setup: index staging {engine.setup_seconds['stage']:.3f} s, "
        f"LUT build (p={engine.lut_p}) {engine.setup_seconds['lut']:.3f} s")
    serve_and_check(engine, queries, oracle, config, timer, warmup=True)
    device_path(engine, corpus, oracle, queries, full_b, res_b, timer, card)
    log(f"# memory: {memory_line(jax.devices()[0])}")


# ------------------------------------------------------------- four cards


def _devices_of(tree) -> set:
    import jax

    devs = set()
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "sharding"):
            devs |= set(leaf.sharding.device_set)
    return devs


def run_four_cards(data_dir: Path, timer: Timer, scale: float = 1.0,
                   ecoli: str = "ecoli") -> None:
    import jax

    from readserver_tpu import cli
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.index.cohort import load_cohort
    from readserver_tpu.parallel.stats import (
        hlo_collective_stats,
        query_psum_estimate,
    )
    from readserver_tpu.serve.engine import MultiEngine

    devs = jax.devices()[:4]

    # --- document-sharded cohort: 4-card mesh vs MultiEngine on card 0
    path, corpus = build_config("cohort", data_dir, timer, scale,
                                doc_shards=4)
    queries = make_queries(corpus, N_QUERIES)
    with timer("oracle_cohort"):
        oracle = Oracle(corpus, queries)
    with timer("load_engine_cohort_doc4"):
        doc = cli._load_engine(str(path), BATCH, 1)
    check(doc._doc and doc.mesh.devices.size == 4,
          "cohort not served over a 4-device mesh")
    check(_devices_of(doc.didx) == set(devs),
          "doc shards are not spread over the four cards")
    a_doc = serve_and_check(doc, queries, oracle, "cohort_doc4", timer,
                            warmup=False)
    del doc
    parts, _ = load_cohort(path, mmap=False)
    with timer("load_engine_cohort_multi"):
        multi = MultiEngine(parts, ServeConfig(batch_size=BATCH))
    check(all(_devices_of(e.index) == {devs[0]} for e in multi.engines),
          "MultiEngine partitions not on card 0")
    a_multi = serve_and_check(multi, queries, oracle, "cohort_multi", timer,
                              warmup=False)
    del multi
    check(canonical(a_doc) == canonical(a_multi),
          "doc-sharded and MultiEngine answers differ")
    log("# cohort: 4-card doc-sharded == MultiEngine on card 0 == oracle")

    # --- interval-sharded E. coli: 4 shards vs one card
    path, corpus = build_config(ecoli, data_dir, timer, scale)
    queries = make_queries(corpus, N_QUERIES)
    with timer("oracle_ecoli"):
        oracle = Oracle(corpus, queries)
    with timer("load_engine_ecoli_1"):
        one = cli._load_engine(str(path), BATCH, 1)
    check(_devices_of(one.index) == {devs[0]}, "one-card engine not on card 0")
    a_one = serve_and_check(one, queries, oracle, "ecoli_1card", timer,
                            warmup=False)
    del one
    with timer("load_engine_ecoli_4shards"):
        four = cli._load_engine(str(path), BATCH, 4)
    check(four._sharded and _devices_of(four.sidx) == set(devs),
          "interval shards are not spread over the four cards")
    a_four = serve_and_check(four, queries, oracle, "ecoli_4shards", timer,
                             warmup=False)
    check(canonical(a_four) == canonical(a_one),
          "interval-sharded and one-card answers differ")
    log("# ecoli: 4-card interval-sharded == one card == oracle")

    # collectives of the compiled full-width uniform step
    k = corpus.spec.kmer_len
    codes = np.ones((BATCH, k), dtype=np.int32)
    lengths = np.full(BATCH, k, dtype=np.int32)
    hlo = four._query_fn_lut.lower(
        four.sidx, four.lut, codes, lengths
    ).compile().as_text()
    ops = [ln.strip()[:240] for ln in hlo.splitlines()
           if re.search(r" (all-reduce|all-gather|reduce-scatter|"
                        r"collective-permute|all-to-all)[-a-z]*\(", ln)]
    log(f"# compiled step: {len(ops)} collective HLO lines")
    for ln in ops[:40]:
        log(f"#   {ln}")
    stats = hlo_collective_stats(hlo)
    starts = len(re.findall(r" all-reduce-start\(", hlo))
    dones = len(re.findall(r" all-reduce-done\(", hlo))
    plain = len(re.findall(r" all-reduce\(", hlo))
    check(starts == dones, f"all-reduce start/done unpaired {starts}/{dones}")
    check(stats["all-reduce"] == starts + plain,
          f"parser counted {stats['all-reduce']} all-reduces, HLO has "
          f"{starts} start/done pairs + {plain} synchronous")
    sidx = four.sidx
    est = query_psum_estimate(
        k, lut_p=four.lut_p or 0,
        kstep=3 if sidx.rank3_rows is not None else 2,
        sample_rate=sidx.sample_rate, fast_resolve=sidx.has_fast_resolve,
        max_read_len=sidx.max_read_len,
        direct_resolve=sidx.dsa_chunk is not None,
    )
    log(f"# ecoli 4 shards, compiled step collectives {json.dumps(stats)}; "
        f"all-reduce start/done pairs {starts}, synchronous {plain}; "
        f"executed psums per batch (schedule estimate) {json.dumps(est)}")
    for d in devs:
        log(f"# memory {d}: {memory_line(d)}")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the doc-sharded and interval-sharded "
                         "paths, on four cards")
    ap.add_argument("--data-dir", default=str(REPO / "data"),
                    help="where built artifacts are cached")
    args = ap.parse_args(argv)

    count = 4 if args.four_cards else 1
    devs = open_devices(count)

    from readserver_tpu.runtime import card_info, enable_compile_cache

    print_device(devs)
    log(f"# compile cache: {enable_compile_cache()}")
    card = card_info().splitlines()[0]
    timer = Timer()
    t0 = time.perf_counter()
    if args.four_cards:
        run_four_cards(Path(args.data_dir), timer)
    else:
        run_one_card(Path(args.data_dir), timer, card=card)
    log(f"# phases (s): {json.dumps({k: round(v, 3) for k, v in timer.seconds.items()})}")
    log(f"# total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
