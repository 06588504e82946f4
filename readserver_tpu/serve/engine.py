"""QueryEngine: artifact → device arrays → jitted query functions.

Startup mirrors the reference's backend boot (load BWT + marks + payload DB,
then serve; SURVEY.md §3.1) but collapses to: deserialize artifact →
device_put (single chip or sharded mesh) → warm up the jitted steps.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from readserver_tpu import alphabet
from readserver_tpu.config import ServeConfig
from readserver_tpu.index.builder import PackedIndex
from readserver_tpu.ops import (
    DeviceIndex,
    backward_search,
    encode_query_batch,
    resolve_intervals,
    sample_histogram,
)


@dataclass
class QueryResult:
    kmer: str
    count: int
    interval: tuple[int, int] | None = None
    hits: list[dict] = field(default_factory=list)      # read_id/sample_id/offset
    sample_hist: dict[str, int] | None = None
    hits_truncated: bool = False
    # exact-attribution contract: the histogram covers the FULL interval
    # (False only when the engine's max_sweep_rows safety cap cut it off,
    # or when running with exact_attribution disabled and count > max_hits)
    sample_hist_complete: bool = True


def rc_string(kmer: str) -> str:
    """Reverse complement of an ACGT query string."""
    return alphabet.decode(alphabet.revcomp(alphabet.encode(kmer)))


def _require_global_sample_space(partitions, names) -> None:
    """Partition merges (histogram psum / device-side column sums) are by
    sample ID, so every partition's sample names must be a prefix of the
    global name table.  Independently-built artifacts that each call
    their local sample 0 something different would otherwise have their
    counts silently added together under one label — refuse instead
    (build/append through the cohort API, which keeps the space global)."""
    for s, p in enumerate(partitions):
        for i, nm in enumerate(p.sample_names):
            if i < len(names) and nm != names[i]:
                raise ValueError(
                    f"partition {s} calls sample id {i} {nm!r} but the "
                    f"cohort calls it {names[i]!r}: partitions must share "
                    "the GLOBAL sample-id space (merges are by id) — "
                    "rebuild or append via the cohort API"
                )


def fold_strand_results(
    kmer: str, fwd: QueryResult, rev: QueryResult | None
) -> QueryResult:
    """Combine forward + reverse-complement answers into one both-strands
    result (``rev is None`` for palindromic queries — one strand is the
    other, so folding twice would double count).

    Reads are stored single-stranded (as in the reference's read pool), so
    "present on either strand" = search the k-mer and its reverse
    complement; hits carry a ``strand`` tag, and a ``-`` hit's ``offset``
    is where the reverse complement sits on the stored strand.
    """
    fwd_hits = [{**h, "strand": "+"} for h in fwd.hits]
    if rev is None:
        return QueryResult(
            kmer=kmer,
            count=fwd.count,
            interval=fwd.interval,
            hits=fwd_hits,
            sample_hist=fwd.sample_hist,
            hits_truncated=fwd.hits_truncated,
        )
    hist = None
    if fwd.sample_hist is not None or rev.sample_hist is not None:
        hist = dict(fwd.sample_hist or {})
        for k, v in (rev.sample_hist or {}).items():
            hist[k] = hist.get(k, 0) + v
    return QueryResult(
        kmer=kmer,
        count=fwd.count + rev.count,
        interval=fwd.interval,
        hits=fwd_hits + [{**h, "strand": "-"} for h in rev.hits],
        sample_hist=hist,
        hits_truncated=fwd.hits_truncated or rev.hits_truncated,
    )


# sparse transfer compaction budget: entries kept on the fast path per
# padded-batch-width query (typical low-multiplicity workloads fit; denser
# batches fall back to dense device buffers, transferred only when needed)
COMPACT_PER_QUERY = 16


def _compact_cols(mask, cols, R):
    """Order-preserving compaction of ``cols`` where ``mask`` → fixed [R]
    buffers + the kept count (-1 signals overflow → dense fallback)."""
    m32 = mask.astype(jnp.int32)
    pos = jnp.cumsum(m32) - m32
    keep = mask & (pos < R)
    slot = jnp.where(keep, pos, R)
    outs = [
        jnp.full(R, -1, jnp.int32).at[slot].set(
            c.astype(jnp.int32), mode="drop"
        )
        for c in cols
    ]
    total = m32.sum()
    return jnp.where(total > R, -1, total), outs


def sparse_pack_device(
    count, complete, hist, rid, off, smp, nq, cpq, l=None, u=None,
    trunc=None, count_hi=None,
):
    """Device-side sparse pack of a query batch's answers into ONE small
    int32 buffer (one small device→host copy per batch instead of the
    dense result tensors):

      [count(W), count_hi(W)?, complete(W), (l(W), u(W))?,
       n_hist, hist_idx(R), hist_val(R),
       (n_hits, hit_idx(R), read_id(R), offset(R), sample(R))?]

    ``rid=None`` packs a histogram-only answer (the /samples wire shape —
    no hit resolution shipped at all).  ``count_hi`` carries bits 31+ of
    an int64 cross-partition count sum as a second int32 lane (per-
    partition counts fit int32 — each partition's n < 2^31 — but their
    sum over a cohort's partitions need not).  Returns
    ``(packed, hist, dense_hits)`` — the dense device tensors back the
    rare overflow case (n == -1), transferred only when actually
    needed."""
    W = count.shape[0]
    R = cpq * W
    one = lambda x: x[None].astype(jnp.int32)
    segs = [count.astype(jnp.int32)]
    if count_hi is not None:
        segs.append(count_hi.astype(jnp.int32))
    segs.append(complete.astype(jnp.int32))
    if trunc is not None:
        # hist-only tier: whether a follow-up hits query would truncate
        # (computed exactly where per-partition counts are still visible)
        segs.append(trunc.astype(jnp.int32))
    if l is not None:
        segs += [l.astype(jnp.int32), u.astype(jnp.int32)]
    NS = hist.shape[1]
    cell_q = jnp.arange(W * NS, dtype=jnp.int32) // NS
    n_hist, (hist_idx, hist_val) = _compact_cols(
        (hist.reshape(-1) > 0) & (cell_q < nq),
        [jnp.arange(W * NS, dtype=jnp.int32), hist.reshape(-1)],
        R,
    )
    segs += [one(n_hist), hist_idx, hist_val]
    dense_hits = None
    if rid is not None:
        SH = rid.shape[1]
        lane_q = jnp.arange(W * SH, dtype=jnp.int32) // SH
        n_hits, (hit_idx, hit_rid, hit_off, hit_smp) = _compact_cols(
            (rid.reshape(-1) >= 0) & (lane_q < nq),
            [
                jnp.arange(W * SH, dtype=jnp.int32),
                rid.reshape(-1),
                off.reshape(-1),
                smp.reshape(-1),
            ],
            R,
        )
        segs += [one(n_hits), hit_idx, hit_rid, hit_off, hit_smp]
        dense_hits = jnp.concatenate([rid, off, smp], axis=1)
    return jnp.concatenate(segs), hist, dense_hits


def assemble_sparse(
    kmers,
    nq,
    W,
    arr,
    NS,
    SH,
    cpq,
    sample_names,
    has_lu,
    has_hits,
    dense_hist_dev,
    dense_hits_dev,
    has_count_hi=False,
    stats=None,
) -> list[QueryResult]:
    """Host-side assembly of the sparse packed buffer → QueryResults.

    ``stats`` (optional dict) accumulates transfer accounting: batches,
    sparse-path bytes, and dense-fallback events/bytes — the overflow
    frequency, measured (the /samples
    tier's p95 gap vs /count is explained by exactly these fallbacks)."""
    R = cpq * W
    if stats is not None:
        stats["batches"] += 1
        stats["sparse_bytes"] += int(arr.nbytes)
    p = W
    count_m = arr[:W].astype(np.int64)
    if has_count_hi:  # recombine the int64 cross-partition count sum
        count_m = count_m + (arr[p : p + W].astype(np.int64) << 31)
        p += W
    complete_m = arr[p : p + W].astype(bool)
    p += W
    trunc_m = None
    if not has_hits:  # hist tier packs the exact truncation flag instead
        trunc_m = arr[p : p + W].astype(bool)
        p += W
    l_m = u_m = None
    if has_lu:
        l_m = arr[p : p + W]
        u_m = arr[p + W : p + 2 * W]
        p += 2 * W
    n_hist = int(arr[p])
    hist_idx = arr[p + 1 : p + 1 + R]
    hist_val = arr[p + 1 + R : p + 1 + 2 * R]
    p += 1 + 2 * R
    hist_q: list[dict[str, int]] = [{} for _ in range(nq)]
    if n_hist >= 0:
        for j in range(n_hist):
            cell = int(hist_idx[j])
            hist_q[cell // NS][sample_names[cell % NS]] = int(hist_val[j])
    else:  # dense fallback: transfer just the histogram
        hist_m = np.asarray(dense_hist_dev)[:nq]
        if stats is not None:
            stats["hist_dense_fallbacks"] += 1
            stats["dense_bytes"] += int(hist_m.nbytes)
        for i in range(nq):
            nz = np.nonzero(hist_m[i])[0]
            hist_q[i] = {
                sample_names[int(s)]: int(hist_m[i][s]) for s in nz
            }
    hits_q: list[list[dict]] = [[] for _ in range(nq)]
    if has_hits:
        n_hits = int(arr[p])
        hit_idx = arr[p + 1 : p + 1 + R]
        hit_rid = arr[p + 1 + R : p + 1 + 2 * R]
        hit_off = arr[p + 1 + 2 * R : p + 1 + 3 * R]
        hit_smp = arr[p + 1 + 3 * R : p + 1 + 4 * R]
        if n_hits >= 0:
            for j in range(n_hits):
                q = int(hit_idx[j]) // SH
                hits_q[q].append(
                    dict(
                        read_id=int(hit_rid[j]),
                        sample_id=int(hit_smp[j]),
                        offset=int(hit_off[j]),
                    )
                )
        else:  # dense fallback: transfer just the hit tensor
            dh = np.asarray(dense_hits_dev)[:nq]
            if stats is not None:
                stats["hits_dense_fallbacks"] += 1
                stats["dense_bytes"] += int(dh.nbytes)
            rid_m = dh[:, :SH]
            off_m = dh[:, SH : 2 * SH]
            smp_m = dh[:, 2 * SH :]
            for i in range(nq):
                v = rid_m[i] >= 0
                hits_q[i] = [
                    dict(read_id=r, sample_id=s, offset=o)
                    for r, s, o in zip(
                        rid_m[i][v].tolist(),
                        smp_m[i][v].tolist(),
                        off_m[i][v].tolist(),
                    )
                ]
    out = []
    for i, km in enumerate(kmers):
        count = int(count_m[i])
        out.append(
            QueryResult(
                kmer=km,
                count=count,
                interval=(
                    (int(l_m[i]), int(u_m[i])) if has_lu else None
                ),
                hits=hits_q[i],
                sample_hist=hist_q[i],
                hits_truncated=(
                    count > len(hits_q[i])
                    if has_hits
                    else bool(trunc_m[i])
                ),
                sample_hist_complete=bool(complete_m[i]),
            )
        )
    return out


class QueryEngine:
    """Batched query API over a built index.

    Three deployment shapes (SURVEY.md §1 L5, §2.3):
    * single device — ``QueryEngine(packed)``
    * interval-sharded — ``QueryEngine(packed, cfg(num_shards=S), mesh)``
    * document-sharded — ``QueryEngine([packed_1..packed_S], cfg, mesh)``
      (a list of per-partition indexes; the reference's split-by-sample
      deployment — counts sum, hit sets union, ids map by offsets)
    """

    COMPACT_PER_QUERY = COMPACT_PER_QUERY

    def __init__(
        self,
        packed: PackedIndex | list[PackedIndex],
        serve_config: ServeConfig | None = None,
        mesh=None,
    ):
        self.cfg = serve_config or ServeConfig()
        # sparse-pack transfer accounting (see assemble_sparse)
        self.pack_stats = {
            "batches": 0, "sparse_bytes": 0, "dense_bytes": 0,
            "hist_dense_fallbacks": 0, "hits_dense_fallbacks": 0,
        }
        self._doc = isinstance(packed, (list, tuple))
        if self._doc:
            self.partitions = list(packed)
            packed = self.partitions[0]
            self._read_base = []
            base = 0
            for p_ in self.partitions:
                self._read_base.append(base)
                base += p_.num_reads
        self.packed = packed
        self.K = packed.config.max_query_len
        self.B = self.cfg.batch_size
        self.H = self.cfg.max_hits
        if self._doc:
            ns = max(p_.num_samples for p_ in self.partitions)
            self.sample_names = [f"sample_{i}" for i in range(ns)]
            names = {}
            for p_ in self.partitions:
                for i, nm in enumerate(p_.sample_names):
                    names[i] = nm
            for i, nm in names.items():
                if i < ns:
                    self.sample_names[i] = nm
            _require_global_sample_space(self.partitions, self.sample_names)
        else:
            self.sample_names = packed.sample_names or ["sample_0"]
        self._sharded = not self._doc and mesh is not None and (
            self.cfg.num_shards > 1 or self.cfg.data_parallel > 1
        )
        if self._doc:
            if mesh is None:
                raise ValueError("document sharding requires a mesh")
            from readserver_tpu.ops import default_lut_order
            from readserver_tpu.parallel import (
                build_doc_sharded,
                make_doc_query_fn,
                place_doc_sharded,
            )

            self.mesh = mesh
            self.lut_p = (
                self.cfg.prefix_lut_order
                if self.cfg.prefix_lut_order is not None
                else default_lut_order(max(p_.n for p_ in self.partitions))
            )
            self.lut = None
            self.didx = place_doc_sharded(
                build_doc_sharded(self.partitions, lut_p=self.lut_p), mesh
            )
            frac = self.cfg.resolve_budget_frac
            budget = int(frac * self.B * self.H) if frac else None
            ex = dict(
                exact_hist=self.cfg.exact_attribution,
                exact_max_rows=self.cfg.max_sweep_rows,
            )
            self._doc_fn = make_doc_query_fn(
                self.didx, mesh, max_hits=self.H, row_budget=budget, **ex
            )
            # plain variant (same arrays, LUT disabled) for short queries
            self.didx_plain = dataclasses.replace(
                self.didx, lut=None, lut_p=0
            )
            self._doc_fn_plain = make_doc_query_fn(
                self.didx_plain, mesh, max_hits=self.H, row_budget=budget,
                **ex,
            )
            return
        if self._sharded:
            from readserver_tpu.ops import default_lut_order
            from readserver_tpu.parallel import (
                build_prefix_lut_sharded,
                build_sharded,
                make_sharded_query_fn,
                place_sharded,
            )

            self.mesh = mesh
            # multi-host process group (SURVEY.md §2.4): the mesh spans
            # every process's devices; batches are broadcast from process
            # 0 each tick and all processes execute the SPMD step together
            # (followers loop in .follow()).  Single-process when 1.
            self._mh = jax.process_count() > 1
            # tiered widths must divide the dp mesh axis (each dp rank —
            # and each host under multi-host — takes an equal batch slice)
            self._width_quantum = int(mesh.shape["dp"]) if mesh else 1
            self.sidx = place_sharded(
                build_sharded(packed, self.cfg.num_shards), mesh
            )
            self.lut_p = (
                self.cfg.prefix_lut_order
                if self.cfg.prefix_lut_order is not None
                else default_lut_order(packed.n)
            )
            self.lut = (
                build_prefix_lut_sharded(self.sidx, mesh, self.lut_p)
                if self.lut_p
                else None
            )
            # k-step variants serve uniform full-width batches (the common
            # shape after _pad_encode's slicing); 1-step variants serve
            # mixed-length batches, whose per-query masks the k-step
            # schedule cannot express
            # resolve collective budget: per-device hit lanes compacted to
            # frac·(B/dp)·H before the walk (psum width ∝ real hits), and
            # the walk while_loop exits when the global batch drains
            frac = self.cfg.resolve_budget_frac
            dp = max(self.cfg.data_parallel, 1)
            budget = (
                max(int(frac * (self.B // dp) * self.H), 1) if frac else None
            )
            ex = dict(
                exact_hist=self.cfg.exact_attribution,
                exact_max_rows=self.cfg.max_sweep_rows,
                resolve_budget=budget,
                walk_early_exit=True,
                owner_route=True,  # no-op at num_shards == 1
                route_capacity=self.cfg.owner_route_capacity,
            )
            self._query_fn = make_sharded_query_fn(
                self.sidx, mesh, max_hits=self.H, lut_p=0, **ex
            )
            self._query_fn_1 = make_sharded_query_fn(
                self.sidx, mesh, max_hits=self.H, lut_p=0, kstep=1, **ex
            )
            self._query_fn_lut = (
                make_sharded_query_fn(
                    self.sidx, mesh, max_hits=self.H, lut_p=self.lut_p, **ex
                )
                if self.lut is not None
                else None
            )
            self._query_fn_lut_1 = (
                make_sharded_query_fn(
                    self.sidx, mesh, max_hits=self.H, lut_p=self.lut_p,
                    kstep=1, **ex,
                )
                if self.lut is not None
                else None
            )
        else:
            from readserver_tpu.index.budget import (
                device_budget_bytes,
                plan_tiers,
            )

            budget = (
                int(self.cfg.hbm_budget_gb * 2**30)
                if self.cfg.hbm_budget_gb is not None
                else device_budget_bytes()
            )
            self.tier_plan = plan_tiers(
                packed, budget, exclude=self.cfg.drop_tiers
            )
            if self.tier_plan.dropped:
                import logging

                logging.getLogger("readserver_tpu.engine").warning(
                    "HBM budget %.2f GiB: shipping %s (%.2f GiB), "
                    "dropping tiers %s",
                    (budget or 0) / 2**30,
                    sorted(self.tier_plan.keep) or ["base only"],
                    self.tier_plan.total_bytes / 2**30,
                    list(self.tier_plan.dropped),
                )
            t0 = time.perf_counter()
            self.index = jax.block_until_ready(
                DeviceIndex.from_packed(packed, tiers=self.tier_plan.keep)
            )
            t1 = time.perf_counter()
            from readserver_tpu.ops import (
                backward_search_lut,
                backward_search_pair,
                build_prefix_lut,
                default_lut_order,
            )

            self.lut_p = (
                self.cfg.prefix_lut_order
                if self.cfg.prefix_lut_order is not None
                else default_lut_order(packed.n)
            )
            self.lut = jax.block_until_ready(
                build_prefix_lut(self.index, self.lut_p) if self.lut_p else None
            )
            # cold set-up split, seconds: index staging vs LUT build
            self.setup_seconds = {
                "stage": t1 - t0, "lut": time.perf_counter() - t1,
            }
            self.has_pair = self.index.rank2_rows is not None

            ee = self.cfg.early_exit

            def _search(idx, lut, codes, lengths, use_lut: bool,
                        use_pair: bool = False):
                if use_pair:
                    # uniform full-length batch: 2-step path (half the
                    # dependent rank gathers)
                    return backward_search_pair(
                        idx, codes,
                        lut if use_lut else None,
                        self.lut_p if use_lut else 0,
                        early_exit=ee,
                    )
                if use_lut:
                    return backward_search_lut(
                        idx, lut, self.lut_p, codes, lengths
                    )
                return backward_search(idx, codes, lengths, early_exit=ee)

            frac = self.cfg.resolve_budget_frac
            budget = int(frac * self.B * self.H) if frac else None
            self._ns = max(packed.num_samples, 1)

            # query-step pieces on device: search interval, exact (or
            # capped) histogram, and — when the endpoint needs them —
            # resolved hits with device-gathered sample ids, invalid
            # lanes forced to -1
            def _pieces(idx, lut, codes, lengths, use_lut, use_pair,
                        with_hits):
                l, u = _search(idx, lut, codes, lengths, use_lut, use_pair)
                rid = off = smp = None
                valid = None
                if with_hits:
                    rid, off, valid = resolve_intervals(
                        idx, l, u, self.H, row_budget=budget
                    )
                    # per-hit sample ids gathered on device (saves the
                    # host read_to_sample gather during assembly)
                    smp = jnp.take(
                        idx.read_to_sample,
                        jnp.clip(rid, 0, max(packed.num_reads - 1, 0)),
                        axis=0,
                    )
                    neg = jnp.int32(-1)
                    rid = jnp.where(valid, rid, neg).astype(jnp.int32)
                    off = jnp.where(valid, off, neg).astype(jnp.int32)
                    smp = jnp.where(valid, smp, neg).astype(jnp.int32)
                if self.cfg.exact_attribution and self._ns == 1:
                    # single-sample index: the exact per-sample histogram
                    # IS the count — no interval sweep needed (chr20/wg
                    # shards; the sweep was most of their serve cost)
                    hist = (u - l)[:, None].astype(jnp.int32)
                    complete = jnp.ones(l.shape[0], dtype=bool)
                elif self.cfg.exact_attribution:
                    from readserver_tpu.ops import exact_sample_histogram

                    W = codes.shape[0]
                    hist, complete = exact_sample_histogram(
                        idx, l, u,
                        window=self.cfg.sweep_window
                        or min(W * self.H, 8 * W),
                        max_rows=self.cfg.max_sweep_rows,
                    )
                elif with_hits:
                    hist = sample_histogram(idx, rid, valid)
                    # complete only when every interval row was actually
                    # resolved: count fits the hit cap AND no lane was
                    # dropped by resolve_intervals' row budget
                    resolved = valid.sum(axis=1).astype(jnp.int64)
                    complete = ((u - l) <= self.H) & (resolved == (u - l))
                else:
                    # hist-only serving without exact attribution still
                    # resolves under the hit cap for the histogram
                    rid2, _, valid2 = resolve_intervals(
                        idx, l, u, self.H, row_budget=budget
                    )
                    hist = sample_histogram(idx, rid2, valid2)
                    resolved = valid2.sum(axis=1).astype(jnp.int64)
                    complete = ((u - l) <= self.H) & (resolved == (u - l))
                return l, u, hist, complete, rid, off, smp

            # dense per-batch buffer [B, 4+NS(+3H)] — the form MultiEngine
            # merges across partitions on device; ``with_hits=False``
            # skips hit resolution AND its buffer columns (the /samples
            # tier on the multi-partition deployments)
            def _full(idx, lut, codes, lengths, use_lut, use_pair,
                      with_hits=True):
                l, u, hist, complete, rid, off, smp = _pieces(
                    idx, lut, codes, lengths, use_lut, use_pair, with_hits
                )
                cols = [
                    l[:, None].astype(jnp.int32),
                    u[:, None].astype(jnp.int32),
                    (u - l)[:, None].astype(jnp.int32),
                    complete[:, None].astype(jnp.int32),
                    hist.astype(jnp.int32),
                ]
                if with_hits:
                    cols += [rid, off, smp]
                return jnp.concatenate(cols, axis=1)

            # sparse-packed serving buffer — the single-engine wire path
            # (one small transfer; dense fallbacks ride along on device)
            def _served(idx, lut, codes, lengths, nq, use_lut, use_pair,
                        with_hits):
                l, u, hist, complete, rid, off, smp = _pieces(
                    idx, lut, codes, lengths, use_lut, use_pair, with_hits
                )
                # hist-tier trunc flag reflects the per-query hit cap
                # ONLY (not resolve_intervals' whole-batch row budget) —
                # see the MultiEngine merge for the contract note
                return sparse_pack_device(
                    u - l, complete, hist, rid, off, smp, nq,
                    self.COMPACT_PER_QUERY, l=l, u=u,
                    trunc=None if with_hits else (u - l) > self.H,
                )

            def _count(idx, lut, codes, lengths, use_lut, use_pair):
                l, u = _search(idx, lut, codes, lengths, use_lut, use_pair)
                return jnp.stack(
                    [l.astype(jnp.int32), u.astype(jnp.int32),
                     (u - l).astype(jnp.int32)],
                    axis=1,
                )

            self._full_jit = jax.jit(
                _full, static_argnames=("use_lut", "use_pair", "with_hits")
            )
            self._served_jit = jax.jit(
                _served,
                static_argnames=("use_lut", "use_pair", "with_hits"),
            )
            self._count_jit = jax.jit(
                _count, static_argnames=("use_lut", "use_pair")
            )

    # ------------------------------------------------------------- helpers

    def _pad_encode(self, kmers: list[str]) -> tuple[np.ndarray, np.ndarray, int]:
        nq = len(kmers)
        if nq > self.B:
            raise ValueError(f"batch of {nq} exceeds configured {self.B}")
        # tiered widths: pad to the smallest compiled width that fits so a
        # lone query doesn't pay the full-batch program (p50 under light
        # load); jit specializes per width on first use.  Multi-host ticks
        # broadcast the chosen width in a fixed-shape header first, so
        # light batches run tiered there too; widths must stay divisible
        # by the dp mesh axis (per-host ingest slices, parallel/multihost)
        width = self.B
        quantum = getattr(self, "_width_quantum", 1)
        for w in sorted(self.cfg.small_batch_sizes):
            if nq <= w <= self.B and w % quantum == 0:
                width = w
                break
        self.last_width = width
        # dummies match the longest real query, so a uniform-length batch
        # stays uniform after padding (keeps the k-step tiers usable) and
        # padding never disables the LUT path
        lmax = max((len(k) for k in kmers), default=self.K)
        padded = list(kmers) + ["A" * lmax] * (width - nq)
        codes, lengths = encode_query_batch(padded, self.K)
        # uniform-length batches slice to exactly L columns: the k-step
        # paths require every column to be a real character (they ignore
        # per-query lengths), and fewer columns = fewer scan steps anyway
        # (multi-host broadcasts fixed [B, K] payloads; the identical
        # slicing decision is re-derived per process after the broadcast)
        if (
            not getattr(self, "_mh", False)
            and nq
            and int(lengths.min()) == lmax
            and lmax < self.K
        ):
            codes = np.ascontiguousarray(codes[:, self.K - lmax:])
        return codes, lengths, nq

    def _run(self, kmers: list[str], counts_only: bool) -> dict[str, np.ndarray]:
        codes, lengths, nq = self._pad_encode(kmers)
        if self._doc:
            use_lut = bool(
                self.lut_p and nq and int(lengths[:nq].min()) >= self.lut_p
            )
            if use_lut:
                out = self._doc_fn(self.didx, codes, lengths)
            else:
                out = self._doc_fn_plain(self.didx_plain, codes, lengths)
            out = {k: np.asarray(v) for k, v in out.items()}
            S = len(self.partitions)
            # merge stacked per-shard hit tensors: [S, B, H] → [B, S*H]
            merged = {
                "count": out["count"][:nq],
                "sample_hist": out["sample_hist"][:nq],
                "hist_complete": out["hist_complete"][:nq],
            }
            for key in ["read_id", "offset", "valid"]:
                merged[key] = (
                    out[key].transpose(1, 0, 2).reshape(-1, S * self.H)[:nq]
                )
            return merged
        if self._sharded:
            if self._mh:
                from jax.experimental import multihost_utils

                # two-phase tick: a fixed-shape header carries the chosen
                # tier width so followers can allocate the matching
                # payload buffers — light batches then compile/run the
                # small-width program on every host (not the full-B one)
                multihost_utils.broadcast_one_to_all(
                    (np.int32(codes.shape[0]), np.int32(nq), np.int32(0))
                )
                codes, lengths = multihost_utils.broadcast_one_to_all(
                    (codes, lengths)
                )
                out = self._mh_execute(
                    np.asarray(codes), np.asarray(lengths), nq
                )
                return {k: v[:nq] for k, v in out.items()}
            use_lut = bool(
                self.lut is not None
                and nq
                and int(lengths[:nq].min()) >= self.lut_p
            )
            uniform = bool(nq and int(lengths.min()) == codes.shape[1])
            if use_lut:
                fn = self._query_fn_lut if uniform else self._query_fn_lut_1
                out = fn(self.sidx, self.lut, codes, lengths)
            else:
                fn = self._query_fn if uniform else self._query_fn_1
                out = fn(self.sidx, None, codes, lengths)
        else:
            out = self._dispatch_single(codes, lengths, nq, counts_only)
            arr = np.asarray(out)[:nq]  # the ONE device->host transfer
            return self._unpack_single(arr, counts_only)
        return {k: np.asarray(v)[:nq] for k, v in out.items()}

    def _dispatch_single(self, codes, lengths, nq: int, mode):
        """Dispatch the single-device query program; returns the packed
        device buffer WITHOUT blocking or transferring (MultiEngine issues
        one of these per partition before the device-side merge).

        ``mode``: "count" | "hist" | "full" (True/False accepted as
        legacy aliases for count/full)."""
        if self._doc or self._sharded:
            raise RuntimeError("raw dispatch is single-device only")
        if mode is True:
            mode = "count"
        elif mode is False:
            mode = "full"
        use_lut = bool(
            self.lut is not None and int(lengths[:nq].min()) >= self.lut_p
        ) if nq else False
        # k-step path requires a uniform batch spanning every column
        # (guaranteed by _pad_encode's slicing for uniform lengths);
        # results are bit-identical to the 1-step path
        use_pair = bool(
            self.has_pair and nq and int(lengths.min()) == codes.shape[1]
        )
        if mode == "count":
            return self._count_jit(
                self.index, self.lut, codes, lengths, use_lut, use_pair
            )
        return self._full_jit(
            self.index, self.lut, codes, lengths, use_lut, use_pair,
            with_hits=(mode == "full"),
        )

    def _unpack_single(
        self, arr: np.ndarray, counts_only: bool
    ) -> dict[str, np.ndarray]:
        """Packed [nq, 4+NS+3H] (or [nq, 3]) buffer → the result dict."""
        if counts_only:
            return dict(l=arr[:, 0], u=arr[:, 1], count=arr[:, 2])
        ns, H = self._ns, self.H
        o = 4 + ns
        rid = arr[:, o : o + H]
        return dict(
            l=arr[:, 0],
            u=arr[:, 1],
            count=arr[:, 2],
            hist_complete=arr[:, 3].astype(bool),
            sample_hist=arr[:, 4:o],
            read_id=rid,
            offset=arr[:, o + H : o + 2 * H],
            sample=arr[:, o + 2 * H : o + 3 * H],
            valid=rid >= 0,
        )

    def _mh_execute(
        self, codes: np.ndarray, lengths: np.ndarray, nq: int
    ) -> dict[str, np.ndarray]:
        """One multi-host tick: every process runs this with the SAME
        (broadcast) batch.  Per-process dp ingest slice → SPMD step →
        allgather egress (process 0 answers clients; followers discard).
        All routing decisions derive from the broadcast payload, so every
        process picks the same compiled variant."""
        import jax

        from readserver_tpu.parallel.multihost import (
            gather_results,
            host_local_queries,
        )

        nq = int(nq)
        K = codes.shape[1]
        lmax = int(lengths.max()) if len(lengths) else K
        if int(lengths.min()) == lmax and lmax < K:
            codes = np.ascontiguousarray(codes[:, K - lmax:])
        use_lut = bool(
            self.lut is not None
            and nq
            and int(lengths[:nq].min()) >= self.lut_p
        )
        uniform = bool(int(lengths.min()) == codes.shape[1])
        B = codes.shape[0]
        nproc = jax.process_count()
        if B % nproc:
            raise ValueError(f"batch_size {B} must divide by {nproc} hosts")
        share = B // nproc
        pid = jax.process_index()
        lc, ll = host_local_queries(
            self.mesh,
            codes[pid * share : (pid + 1) * share],
            lengths[pid * share : (pid + 1) * share],
        )
        if use_lut:
            fn = self._query_fn_lut if uniform else self._query_fn_lut_1
            out = fn(self.sidx, self.lut, lc, ll)
        else:
            fn = self._query_fn if uniform else self._query_fn_1
            out = fn(self.sidx, None, lc, ll)
        return gather_results(out)

    def follow(self) -> None:
        """Follower loop for processes != 0: execute broadcast ticks until
        process 0 sends the stop flag (or this process is killed).  Each
        tick is two broadcasts: a fixed-shape header (width, nq, stop)
        then the width-shaped query payload."""
        from jax.experimental import multihost_utils

        while True:
            width, nq, stop = multihost_utils.broadcast_one_to_all(
                (np.int32(0), np.int32(0), np.int32(0))
            )
            if int(stop):
                return
            codes, lengths = multihost_utils.broadcast_one_to_all(
                (
                    np.zeros((int(width), self.K), dtype=np.int32),
                    np.ones(int(width), dtype=np.int32),
                )
            )
            self._mh_execute(np.asarray(codes), np.asarray(lengths), int(nq))

    def stop_followers(self) -> None:
        """Release .follow() loops on the other processes."""
        if not getattr(self, "_mh", False):
            return
        from jax.experimental import multihost_utils

        multihost_utils.broadcast_one_to_all(
            (np.int32(0), np.int32(0), np.int32(1))
        )

    # ------------------------------------------------------------ public

    def warmup(self) -> None:
        """Compile all serving path variants — every answer tier at every
        compiled width, INCLUDING the full batch width (a first full-width
        flight otherwise pays its ~seconds of XLA compile inside a served
        request: that was the entire wire-bench p95 tail) — and pay the
        first-transfer handshake."""
        widths = sorted(
            {w for w in self.cfg.small_batch_sizes if w < self.B}
            | {self.B}
        )
        lengths = sorted(
            {int(k) for k in self.cfg.warmup_query_lengths} | {self.K}
        )
        # short query (plain path) at the smallest width; each configured
        # uniform length (its own column-sliced XLA shape) at every width
        for q in [["A"]] + [
            ["A" * k] * w for w in widths for k in lengths
        ]:
            self.count_batch(q)
            if self._doc or self._sharded:
                self._run(q, counts_only=False)
            else:
                self.query_batch(q)
                self.query_batch(q, include_hits=False)

    def _locate(self, rid: int) -> tuple[int, int]:
        """Global read id → (partition, local id)."""
        s = bisect.bisect_right(self._read_base, rid) - 1
        return s, rid - self._read_base[s]

    def _sample_of(self, rid: int) -> int:
        if self._doc:
            s, local = self._locate(rid)
            return int(self.partitions[s].read_to_sample[local])
        return int(self.packed.read_to_sample[rid])

    def _expand_rc(self, kmers: list[str]) -> tuple[list[str], dict[int, int]]:
        """→ (kmers + non-palindromic RCs appended, original→rc index map).

        Both-strands batches therefore hold up to 2× the queries; callers
        must stay within ``batch_size`` after expansion.
        """
        rcs = [rc_string(k) for k in kmers]
        exp = list(kmers)
        back: dict[int, int] = {}
        for i, (km, rc) in enumerate(zip(kmers, rcs)):
            if rc != km:
                back[i] = len(exp)
                exp.append(rc)
        return exp, back

    def count_batch(
        self, kmers: list[str], both_strands: bool = False
    ) -> list[QueryResult]:
        if both_strands:
            exp, back = self._expand_rc(kmers)
            res = self.count_batch(exp)
            return [
                fold_strand_results(
                    km, res[i], res[back[i]] if i in back else None
                )
                for i, km in enumerate(kmers)
            ]
        out = self._run(kmers, counts_only=True)
        return [
            QueryResult(
                kmer=km,
                count=int(out["count"][i]),
                interval=(
                    (int(out["l"][i]), int(out["u"][i]))
                    if "l" in out
                    else None
                ),
            )
            for i, km in enumerate(kmers)
        ]

    def query_batch(
        self,
        kmers: list[str],
        both_strands: bool = False,
        include_hits: bool = True,
    ) -> list[QueryResult]:
        """Full answers: counts + per-sample attribution, plus hit sets
        unless ``include_hits=False`` (the /samples wire shape — skipping
        hit resolution also skips shipping the hit tensor)."""
        if both_strands:
            exp, back = self._expand_rc(kmers)
            res = self.query_batch(exp, include_hits=include_hits)
            return [
                fold_strand_results(
                    km, res[i], res[back[i]] if i in back else None
                )
                for i, km in enumerate(kmers)
            ]
        if not (self._doc or self._sharded):
            # single-device serving: one fused program → one sparse
            # packed transfer (dense fallbacks stay on device)
            codes, lengths, nq = self._pad_encode(kmers)
            use_lut = bool(
                self.lut is not None
                and nq
                and int(lengths[:nq].min()) >= self.lut_p
            )
            use_pair = bool(
                self.has_pair and nq
                and int(lengths.min()) == codes.shape[1]
            )
            packed_dev, hist_dev, hits_dev = self._served_jit(
                self.index, self.lut, codes, lengths, np.int32(nq),
                use_lut, use_pair, include_hits,
            )
            return assemble_sparse(
                kmers, nq, codes.shape[0], np.asarray(packed_dev),
                self._ns, self.H, self.COMPACT_PER_QUERY,
                self.sample_names, has_lu=True, has_hits=include_hits,
                dense_hist_dev=hist_dev, dense_hits_dev=hits_dev,
                stats=self.pack_stats,
            )
        out = self._run(kmers, counts_only=False)
        # vectorized hit assembly: one NumPy gather maps every hit's read
        # id to its sample id (the old path called _sample_of per hit —
        # ~260k Python dict lookups per full batch on the serving path)
        rid_m = np.asarray(out["read_id"])
        off_m = np.asarray(out["offset"])
        val_m = np.asarray(out["valid"]).astype(bool)
        rid_safe = np.clip(rid_m, 0, None)
        if "sample" in out:
            # per-hit sample ids were gathered on device (packed buffer)
            sample_m = out["sample"]
        elif self._doc:
            base = np.asarray(self._read_base, dtype=np.int64)
            part = np.searchsorted(base, rid_safe, side="right") - 1
            sample_m = np.zeros(rid_m.shape, dtype=np.int64)
            for s, p_ in enumerate(self.partitions):
                msk = val_m & (part == s)
                if msk.any():
                    sample_m[msk] = np.asarray(p_.read_to_sample)[
                        rid_safe[msk] - base[s]
                    ]
        else:
            sample_m = np.asarray(self.packed.read_to_sample)[rid_safe]
        hist_m = np.asarray(out["sample_hist"])
        results = []
        for i, km in enumerate(kmers):
            count = int(out["count"][i])
            v = val_m[i]
            hits = [
                dict(read_id=r, sample_id=s, offset=o)
                for r, s, o in zip(
                    rid_m[i][v].tolist(),
                    sample_m[i][v].tolist(),
                    off_m[i][v].tolist(),
                )
            ]
            nz = np.nonzero(hist_m[i])[0]
            sample_hist = {
                self.sample_names[int(s)]: int(hist_m[i][s]) for s in nz
            }
            results.append(
                QueryResult(
                    kmer=km,
                    count=count,
                    interval=(
                        (int(out["l"][i]), int(out["u"][i]))
                        if "l" in out
                        else None
                    ),
                    hits=hits,
                    sample_hist=sample_hist,
                    # truncated by the per-query cap OR the global row budget
                    hits_truncated=count > len(hits),
                    sample_hist_complete=bool(
                        out["hist_complete"][i]
                    ) if "hist_complete" in out else True,
                )
            )
        return results

    def read_sequence(self, read_id: int) -> str:
        """Read text from the host-side cold store (RocksDB replacement)."""
        if self._doc:
            s, local = self._locate(read_id)
            return alphabet.decode(self.partitions[s].extract_read(local))
        return alphabet.decode(self.packed.extract_read(read_id))

    def read_name(self, read_id: int) -> str:
        """Stored ingest name (FASTA/FASTQ header); synthesized when the
        artifact was built without names."""
        if self._doc:
            s, local = self._locate(read_id)
            nm = self.partitions[s].read_name(local)
        else:
            nm = self.packed.read_name(read_id)
        return nm if nm is not None else f"read_{read_id}"

    def read_meta(self, read_id: int) -> bytes | None:
        """Opaque per-read metadata bytes (None when absent)."""
        if self._doc:
            s, local = self._locate(read_id)
            return self.partitions[s].read_meta(local)
        return self.packed.read_meta(read_id)


class MultiEngine:
    """Sequential front end over per-partition engines (fewer devices than
    cohort shards — e.g. one chip serving a many-shard cohort artifact).

    The reference's front-end/backend split as a time-multiplexed loop:
    each partition answers the full batch on the same device(s); counts
    sum, hit sets union with global read-id offsets, histograms merge —
    identical answers to the device-parallel doc-sharded path, trading
    latency for HBM footprint.  Duck-types ``QueryEngine`` for the
    dispatcher and REST front.
    """

    def __init__(self, partitions, serve_config: ServeConfig | None = None):
        if not partitions:
            raise ValueError("no partitions")
        self.cfg = serve_config or ServeConfig()
        # sparse-pack transfer accounting (see assemble_sparse)
        self.pack_stats = {
            "batches": 0, "sparse_bytes": 0, "dense_bytes": 0,
            "hist_dense_fallbacks": 0, "hits_dense_fallbacks": 0,
        }
        self.partitions = list(partitions)
        self._doc = True
        self.packed = self.partitions[0]
        self.engines = [QueryEngine(p, self.cfg) for p in self.partitions]
        self._read_base = []
        base = 0
        for p in self.partitions:
            self._read_base.append(base)
            base += p.num_reads
        self.K = self.engines[0].K
        self.B = self.cfg.batch_size
        self.H = self.cfg.max_hits
        ns = max(p.num_samples for p in self.partitions)
        self.sample_names = [f"sample_{i}" for i in range(ns)]
        for p in self.partitions:
            for i, nm in enumerate(p.sample_names):
                if i < ns:
                    self.sample_names[i] = nm
        _require_global_sample_space(self.partitions, self.sample_names)
        self._ns = ns
        self._merge_jit = jax.jit(
            self._merge_full, static_argnames=("with_hits",)
        )
        # int64 accumulation: per-partition counts fit int32, the cohort
        # sum need not (a 1-mer on a >2^31-symbol
        # cohort must not wrap negative)
        self._merge_count_jit = jax.jit(
            lambda outs: sum(o[:, 2].astype(jnp.int64) for o in outs)
        )

    # see module-level COMPACT_PER_QUERY; class attribute so tests can
    # pin the budget per engine class
    COMPACT_PER_QUERY = COMPACT_PER_QUERY

    def _merge_full(self, outs, nq, with_hits=True):
        """Device-side merge of per-partition dense packed buffers.

        The time-multiplexed front previously assembled per-partition
        QueryResults on host and merged them in Python — one device→host
        transfer per partition per batch.  Here counts/hists/hit-sets merge in one fused program
        (global read ids and per-hit samples resolved on device) and the
        result ships through :func:`sparse_pack_device` — one small
        buffer, dense fallbacks transferred only on budget overflow."""
        W = outs[0].shape[0]
        count = 0
        complete = 1
        trunc = False
        hist = jnp.zeros((W, self._ns), dtype=jnp.int32)
        rids, offs, smps = [], [], []
        H = self.H
        for e, o, base in zip(self.engines, outs, self._read_base):
            ns_s = e._ns
            # int64: the cross-partition sum can exceed int32 even though
            # every per-partition count fits it
            count = count + o[:, 2].astype(jnp.int64)
            complete = complete * o[:, 3]
            hist = hist.at[:, :ns_s].add(o[:, 4 : 4 + ns_s])
            if with_hits:
                rid = o[:, 4 + ns_s : 4 + ns_s + H]
                rids.append(jnp.where(rid >= 0, rid + base, -1))
                offs.append(o[:, 4 + ns_s + H : 4 + ns_s + 2 * H])
                smps.append(o[:, 4 + ns_s + 2 * H : 4 + ns_s + 3 * H])
            else:
                # a follow-up hits query truncates iff some PARTITION's
                # local count exceeds its per-query cap — computed here
                # where per-partition counts are still visible.  NOTE
                # (contract): this flag reflects the per-query
                # hit cap ONLY; a follow-up /reads on a batch dense
                # enough to trip resolve_intervals' whole-batch row
                # budget (resolve_budget_frac) can still return fewer
                # than ``count`` hits with this flag False — the full
                # tier's own ``count > len(hits)`` flag stays exact.
                trunc = trunc | (o[:, 2] > H)
        return sparse_pack_device(
            count & jnp.int64(0x7FFFFFFF),
            complete,
            hist,
            jnp.concatenate(rids, axis=1) if with_hits else None,
            jnp.concatenate(offs, axis=1) if with_hits else None,
            jnp.concatenate(smps, axis=1) if with_hits else None,
            nq,
            self.COMPACT_PER_QUERY,
            trunc=None if with_hits else trunc,
            count_hi=count >> 31,
        )

    def warmup(self) -> None:
        # compile the merged front-end paths (count + full + hist-only)
        # at every compiled width including the full batch (see
        # QueryEngine.warmup on why full-width compiles must not land
        # inside a served request); the per-partition programs compile as
        # part of these, so no separate per-engine warmup is needed
        widths = sorted(
            {w for w in self.cfg.small_batch_sizes if w < self.B}
            | {self.B}
        )
        lengths = sorted(
            {int(k) for k in self.cfg.warmup_query_lengths} | {self.K}
        )
        for kmers in [["A"]] + [
            ["A" * k] * w for w in widths for k in lengths
        ]:
            self.query_batch(kmers)
            self.query_batch(kmers, include_hits=False)
            self.count_batch(kmers)

    def _locate(self, rid: int) -> tuple[int, int]:
        s = bisect.bisect_right(self._read_base, rid) - 1
        return s, rid - self._read_base[s]

    def count_batch(
        self, kmers: list[str], both_strands: bool = False
    ) -> list[QueryResult]:
        """Summed counts across partitions.  ``interval`` is None by
        contract: each partition is its own BWT, so no single global
        (l, u) exists — the same convention the device-parallel
        doc-sharded engine uses (its merged ``_run`` dict carries no
        'l'/'u' either); only the un-partitioned engine reports BWT
        coordinates."""
        if both_strands:
            exp, back = self._expand_rc(kmers)
            res = self.count_batch(exp)
            return [
                fold_strand_results(
                    km, res[i], res[back[i]] if i in back else None
                )
                for i, km in enumerate(kmers)
            ]
        return self._assemble_counts(*self._dispatch_counts(kmers))

    def _dispatch_counts(self, kmers: list[str]):
        codes, lengths, nq = self.engines[0]._pad_encode(kmers)
        outs = tuple(
            e._dispatch_single(codes, lengths, nq, True)
            for e in self.engines
        )
        return kmers, nq, self._merge_count_jit(outs)

    def _assemble_counts(self, kmers, nq, merged) -> list[QueryResult]:
        counts = np.asarray(merged)[:nq]
        return [
            QueryResult(kmer=km, count=int(counts[i]))
            for i, km in enumerate(kmers)
        ]

    def count_batches(
        self, batches: list[list[str]]
    ) -> list[list[QueryResult]]:
        """Bulk count tier, pipelined like :meth:`query_batches` — the
        un-pipelined loop left the count tier SLOWER than full
        attribution on the cohort_big rung (each batch serialized its
        device step behind the previous batch's transfer+assembly)."""
        results: list[list[QueryResult]] = []
        pend = None
        for kmers in batches:
            cur = self._dispatch_counts(kmers)
            if pend is not None:
                results.append(self._assemble_counts(*pend))
            pend = cur
        if pend is not None:
            results.append(self._assemble_counts(*pend))
        return results

    _expand_rc = QueryEngine._expand_rc

    def query_batch(
        self,
        kmers: list[str],
        both_strands: bool = False,
        include_hits: bool = True,
    ) -> list[QueryResult]:
        if both_strands:
            exp, back = self._expand_rc(kmers)
            res = self.query_batch(exp, include_hits=include_hits)
            return [
                fold_strand_results(
                    km, res[i], res[back[i]] if i in back else None
                )
                for i, km in enumerate(kmers)
            ]
        pend = self._dispatch_merged(kmers, include_hits)
        return self._assemble_merged(*pend)

    def query_batches(
        self, batches: list[list[str]], include_hits: bool = True
    ) -> list[list[QueryResult]]:
        """Bulk path: pipeline device compute of batch i+1 behind the
        transfer + host assembly of batch i (the dispatcher gets this
        overlap for free from asyncio; synchronous bulk callers — the
        cohort bench, offline scans — get it here)."""
        results: list[list[QueryResult]] = []
        pend = None
        for kmers in batches:
            cur = self._dispatch_merged(kmers, include_hits)
            if pend is not None:
                results.append(self._assemble_merged(*pend))
            pend = cur
        if pend is not None:
            results.append(self._assemble_merged(*pend))
        return results

    def _dispatch_merged(self, kmers: list[str], include_hits: bool = True):
        """Async-dispatch all partitions + the device merge; no transfer.
        Hist-only batches run the per-partition hist program (no hit
        resolution anywhere, not just no transfer)."""
        codes, lengths, nq = self.engines[0]._pad_encode(kmers)
        mode = "full" if include_hits else "hist"
        outs = tuple(
            e._dispatch_single(codes, lengths, nq, mode)
            for e in self.engines
        )
        return (
            kmers,
            nq,
            include_hits,
            self._merge_jit(outs, np.int32(nq), with_hits=include_hits),
        )

    def _assemble_merged(
        self, kmers, nq, include_hits, merged
    ) -> list[QueryResult]:
        packed_dev, dense_hist_dev, dense_hits_dev = merged
        arr = np.asarray(packed_dev)  # the one (small) transfer
        NS, SH = self._ns, len(self.engines) * self.H
        cpq = self.COMPACT_PER_QUERY
        if include_hits:  # [count, count_hi, complete] + hist + hits
            W = (len(arr) - 2) // (3 + cpq * 6)
        else:  # [count, count_hi, complete, trunc] + hist sections
            W = (len(arr) - 1) // (4 + cpq * 2)
        return assemble_sparse(
            kmers, nq, W, arr, NS, SH, cpq, self.sample_names,
            has_lu=False, has_hits=include_hits,
            dense_hist_dev=dense_hist_dev, dense_hits_dev=dense_hits_dev,
            has_count_hi=True, stats=self.pack_stats,
        )

    def read_sequence(self, read_id: int) -> str:
        s, local = self._locate(read_id)
        return alphabet.decode(self.partitions[s].extract_read(local))

    def read_name(self, read_id: int) -> str:
        s, local = self._locate(read_id)
        nm = self.partitions[s].read_name(local)
        return nm if nm is not None else f"read_{read_id}"

    def read_meta(self, read_id: int) -> bytes | None:
        s, local = self._locate(read_id)
        return self.partitions[s].read_meta(local)
