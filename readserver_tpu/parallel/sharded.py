"""BWT-interval sharding: the sharded index + SPMD query program.

Decomposition (SURVEY.md §2.3 "Shard/tensor parallel"): the global BWT is
split into contiguous position ranges, one per device on the ``'shard'``
mesh axis.  For any global position ``i``:

    occ_global(c, i) = Σ_shards occ_local_s(c, clamp(i - start_s, 0, len_s))

— every shard computes a clamped local rank (out-of-range shards hit their
checkpoint fast path: clamp yields 0 or the shard total) and one ``psum``
yields the global value.  This is the "masked contribution" form
(SURVEY.md §7.6): simplest SPMD, no owner routing, one collective per scan
step.  Payload tables (dollar_map, read→sample) shard the same way over
their own dense key ranges.

Global interval arithmetic is int64 (whole-genome BWT lengths exceed
2**32); all local ranks remain int32/uint32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from readserver_tpu import alphabet
from readserver_tpu.index.builder import PackedIndex
from readserver_tpu.index import packing
from readserver_tpu.ops.rank import occ_rows

_U32 = jnp.uint32


@dataclass(frozen=True)
class ShardedIndex:
    """Per-shard arrays stacked on a leading 'shard' axis (size S)."""

    rank_rows: jax.Array    # uint32 [S, 5*(nbl_max+1), row_words]
    sym4: jax.Array         # uint32 [S, W4max]
    dollar_chunk: jax.Array # int32  [S, DMAX] ($-rank range → read id)
    sample_chunk: jax.Array # int32  [S, RMAX] (read-id range → sample id)
    starts: jax.Array       # int64  [S] global BWT position of shard start
    lens: jax.Array         # int64  [S]
    dstarts: jax.Array      # int64  [S] global $-rank at shard start
    dlens: jax.Array        # int64  [S]
    rstarts: jax.Array      # int64  [S] read-id chunk start
    rlens: jax.Array        # int64  [S]
    C: jax.Array            # int64  [6] global, replicated
    # fast-resolve tier (optional; same trio as DeviceIndex, sharded):
    # lf by position range, mark rank re-packed per shard (global rank via
    # the clamped-psum identity), sample pairs by global mark-rank range
    lf_chunk: jax.Array | None = None      # int32 [S, maxlen]
    mark_table: jax.Array | None = None    # uint32 [S, nbl_max+1, row_words]
    spairs_chunk: jax.Array | None = None  # int32 [S, smax, 2]
    sstarts: jax.Array | None = None       # int64 [S]
    slens: jax.Array | None = None         # int64 [S]
    # direct-resolve tier (optional): per-row (read_id << dsa_bits |
    # offset) sharded by position range — resolution becomes ONE masked
    # psum-gather per lane, eliminating the walk's sample_rate collective
    # rounds entirely (ops/resolve.resolve_rows_dsa under sharding)
    dsa_chunk: jax.Array | None = None     # uint32 [S, maxlen]
    # k-step search tiers (optional, same planes as DeviceIndex but
    # shard-local): one clamped-psum rank over the pair/triple planes
    # advances the whole batch 2/3 characters — the single-chip hot-path
    # treatment (ops/search.backward_search_pair) under interval sharding
    rank2_rows: jax.Array | None = None    # uint32 [S, 16*nbl_max, row_words]
    C2: jax.Array | None = None            # int64 [16] global, replicated
    rank3_rows: jax.Array | None = None    # uint32 [S, 64*nbl_max, row_words]
    C3: jax.Array | None = None            # int64 [64] global, replicated
    # per-shard symbol/k-gram totals (owner-routed rank: the exterior-high
    # contribution occ_local(len) is a table lookup instead of a gather)
    sym_totals: jax.Array | None = None    # int64 [S, NUM_SYMBOLS]
    totals2: jax.Array | None = None       # int64 [S, 16]
    totals3: jax.Array | None = None       # int64 [S, 64]
    # static
    num_shards: int = dataclasses.field(metadata=dict(static=True), default=1)
    n: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_reads: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_samples: int = dataclasses.field(metadata=dict(static=True), default=1)
    rows_per_symbol: int = dataclasses.field(metadata=dict(static=True), default=1)
    block_size: int = dataclasses.field(metadata=dict(static=True), default=256)
    words_per_block: int = dataclasses.field(metadata=dict(static=True), default=8)
    max_read_len: int = dataclasses.field(metadata=dict(static=True), default=256)
    sample_rate: int = dataclasses.field(metadata=dict(static=True), default=0)
    dsa_bits: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def log2_block(self) -> int:
        return self.block_size.bit_length() - 1

    @property
    def has_fast_resolve(self) -> bool:
        return self.sample_rate > 0 and self.lf_chunk is not None


_STACKED = [
    "rank_rows", "sym4", "dollar_chunk", "sample_chunk",
    "starts", "lens", "dstarts", "dlens", "rstarts", "rlens",
    "lf_chunk", "mark_table", "spairs_chunk", "sstarts", "slens",
    "dsa_chunk",
    "rank2_rows", "rank3_rows", "sym_totals", "totals2", "totals3",
]
_REPLICATED = ["C", "C2", "C3"]
_META = [
    "num_shards", "n", "num_reads", "num_samples", "rows_per_symbol",
    "block_size", "words_per_block", "max_read_len", "sample_rate",
    "dsa_bits",
]

jax.tree_util.register_dataclass(
    ShardedIndex, data_fields=_STACKED + _REPLICATED, meta_fields=_META
)


def build_sharded(packed: PackedIndex, num_shards: int) -> ShardedIndex:
    """Host-side: slice the global BWT into S block-aligned ranges and
    re-pack each range with shard-local checkpoints (NumPy arrays)."""
    cfg = packed.config
    S = num_shards
    n, m = packed.n, packed.num_reads
    bs = cfg.block_size
    bwt = packing.unpack_sym4(np.asarray(packed.sym4), n)

    # block-aligned contiguous ranges
    target = -(-n // S)
    target = -(-target // bs) * bs
    starts = np.minimum(np.arange(S, dtype=np.int64) * target, n)
    ends = np.minimum(starts + target, n)
    lens = ends - starts

    rank_stack, sym_stack, dlens = [], [], []
    sym_totals = np.zeros((S, alphabet.NUM_SYMBOLS), dtype=np.int64)
    for s in range(S):
        local = bwt[starts[s] : ends[s]]
        rb, _, counts = packing.pack_rank_blocks(local, cfg)
        rank_stack.append(rb)  # [5, nbl_s+1, R]
        sym_stack.append(packing.pack_sym4(local))
        sym_totals[s] = counts
        dlens.append(int(counts[alphabet.SENTINEL]))
    dlens = np.asarray(dlens, dtype=np.int64)
    dstarts = np.zeros(S, dtype=np.int64)
    np.cumsum(dlens[:-1], out=dstarts[1:])
    assert dstarts[-1] + dlens[-1] == m

    nbl_max = max(rb.shape[1] for rb in rank_stack)
    R = cfg.row_words
    rank_rows = np.zeros(
        (S, alphabet.NUM_SYMBOLS * nbl_max, R), dtype=np.uint32
    )
    for s, rb in enumerate(rank_stack):
        pad = np.zeros((alphabet.NUM_SYMBOLS, nbl_max, R), dtype=np.uint32)
        pad[:, : rb.shape[1]] = rb
        rank_rows[s] = pad.reshape(-1, R)

    w4max = max(x.shape[0] for x in sym_stack)
    sym4 = np.zeros((S, max(w4max, 1)), dtype=np.uint32)
    for s, x in enumerate(sym_stack):
        sym4[s, : x.shape[0]] = x

    dmax = max(1, int(dlens.max()))
    dollar_chunk = np.zeros((S, dmax), dtype=np.int32)
    dm = np.asarray(packed.dollar_map, dtype=np.int32)
    for s in range(S):
        dollar_chunk[s, : dlens[s]] = dm[dstarts[s] : dstarts[s] + dlens[s]]

    rchunk = -(-m // S)
    rstarts = np.minimum(np.arange(S, dtype=np.int64) * rchunk, m)
    rends = np.minimum(rstarts + rchunk, m)
    rlens = rends - rstarts
    sample_chunk = np.zeros((S, max(rchunk, 1)), dtype=np.int32)
    rts = np.asarray(packed.read_to_sample, dtype=np.int32)
    for s in range(S):
        sample_chunk[s, : rlens[s]] = rts[rstarts[s] : rends[s]]

    # direct-resolve tier, sharded by the same position ranges
    dsa_chunk = None
    dsa_bits = 0
    if packed.dsa is not None and packed.dsa_bits > 0:
        dsa_bits = int(packed.dsa_bits)
        dsa_all = np.asarray(packed.dsa, dtype=np.uint32)
        maxlen = int(lens.max())
        dsa_chunk = np.zeros((S, max(maxlen, 1)), dtype=np.uint32)
        for s in range(S):
            dsa_chunk[s, : lens[s]] = dsa_all[starts[s] : ends[s]]

    # fast-resolve tier, sharded the same three ways
    lf_chunk = mark_table = spairs_chunk = sstarts = slens = None
    srate = 0
    if packed.lf is not None and packed.sample_rate > 0:
        srate = int(packed.sample_rate)
        lf_all = np.asarray(packed.lf, dtype=np.int32)
        maxlen = int(lens.max())
        lf_chunk = np.zeros((S, max(maxlen, 1)), dtype=np.int32)
        mark_stack = []
        slens_list = []
        for s in range(S):
            piece = lf_all[starts[s] : ends[s]]
            lf_chunk[s, : lens[s]] = piece
            marked = piece < 0
            mark_stack.append(packing.pack_bit_rank(marked, cfg))
            slens_list.append(int(marked.sum()))
        slens = np.asarray(slens_list, dtype=np.int64)
        sstarts = np.zeros(S, dtype=np.int64)
        np.cumsum(slens[:-1], out=sstarts[1:])
        mb_max = max(t.shape[0] for t in mark_stack)
        mark_table = np.zeros((S, mb_max, cfg.row_words), dtype=np.uint32)
        for s, t in enumerate(mark_stack):
            mark_table[s, : t.shape[0]] = t
        smax = max(1, int(slens.max()))
        spairs_chunk = np.zeros((S, smax, 2), dtype=np.int32)
        pairs = np.asarray(packed.sample_pairs, dtype=np.int32)
        total_marked = int(slens.sum())
        assert total_marked <= pairs.shape[0] or total_marked == 0
        for s in range(S):
            spairs_chunk[s, : slens[s]] = pairs[
                sstarts[s] : sstarts[s] + slens[s]
            ]

    # k-step tiers: shard boundaries are block-aligned, so each shard's
    # pair/triple plane table is a SLICE of the global one with the
    # checkpoint column rebased to the shard start (the bitplane words are
    # bit-identical) — no per-shard repacking pass needed.
    rank2_rows = C2 = rank3_rows = C3 = totals2 = totals3 = None
    if packed.rank2_blocks is not None and packed.C2 is not None:
        rank2_rows = _slice_plane_tiers(
            packed.rank2_blocks, starts, ends, bs, nbl_max
        )
        C2 = np.asarray(packed.C2, dtype=np.int64)
        totals2 = _plane_totals(packed.rank2_blocks, starts, ends, bs)
    if packed.rank3_blocks is not None and packed.C3 is not None:
        rank3_rows = _slice_plane_tiers(
            packed.rank3_blocks, starts, ends, bs, nbl_max
        )
        C3 = np.asarray(packed.C3, dtype=np.int64)
        totals3 = _plane_totals(packed.rank3_blocks, starts, ends, bs)

    return ShardedIndex(
        rank_rows=rank_rows,
        sym4=sym4,
        dollar_chunk=dollar_chunk,
        sample_chunk=sample_chunk,
        starts=starts,
        lens=lens,
        dstarts=dstarts,
        dlens=dlens,
        rstarts=rstarts,
        rlens=rlens,
        C=np.asarray(packed.C, dtype=np.int64),
        rank2_rows=rank2_rows,
        C2=C2,
        rank3_rows=rank3_rows,
        C3=C3,
        sym_totals=sym_totals,
        totals2=totals2,
        totals3=totals3,
        lf_chunk=lf_chunk,
        mark_table=mark_table,
        spairs_chunk=spairs_chunk,
        sstarts=sstarts,
        slens=slens,
        dsa_chunk=dsa_chunk,
        dsa_bits=dsa_bits,
        sample_rate=srate,
        num_shards=S,
        n=n,
        num_reads=m,
        num_samples=max(packed.num_samples, 1),
        rows_per_symbol=nbl_max,
        block_size=cfg.block_size,
        words_per_block=cfg.words_per_block,
        max_read_len=int(packed.read_lengths.max()) if m else 1,
    )


def _plane_totals(
    table: np.ndarray, starts: np.ndarray, ends: np.ndarray, bs: int
) -> np.ndarray:
    """Per-shard plane totals int64 [S, P]: shard ranges are block-aligned
    (the last shard ends at n, whose final checkpoint carries the full
    count — pad codes count in no plane), so the total is a checkpoint
    difference on the GLOBAL table."""
    S = len(starts)
    out = np.zeros((S, table.shape[0]), dtype=np.int64)
    for s in range(S):
        b0 = int(starts[s]) // bs
        b1 = -(-int(ends[s]) // bs)
        out[s] = table[:, b1, 0].astype(np.int64) - table[:, b0, 0].astype(
            np.int64
        )
    return out


def _slice_plane_tiers(
    table: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    bs: int,
    nbl_max: int,
) -> np.ndarray:
    """Global plane table [P, NB+1, R] → per-shard stacked
    [S, P*nbl_max, R] with rebased checkpoints."""
    S = len(starts)
    P_, _, R = table.shape
    out = np.zeros((S, P_ * nbl_max, R), dtype=np.uint32)
    for s in range(S):
        b0 = int(starts[s]) // bs
        b1 = -(-int(ends[s]) // bs)  # ceil
        sl = np.array(table[:, b0 : b1 + 1], dtype=np.uint32)
        sl[:, :, 0] -= sl[:, :1, 0]
        pad = np.zeros((P_, nbl_max, R), dtype=np.uint32)
        pad[:, : sl.shape[1]] = sl
        out[s] = pad.reshape(-1, R)
    return out


def sharding_specs(sidx: ShardedIndex) -> ShardedIndex:
    """Pytree of PartitionSpecs matching ShardedIndex (C/C2/C3 replicated);
    only the leading (stacked) axis of each field is sharded."""
    kw = {}
    for f in _STACKED:
        v = getattr(sidx, f)
        if v is None:
            kw[f] = None
        else:
            kw[f] = P("shard", *([None] * (np.ndim(v) - 1)))
    for f in _REPLICATED:
        kw[f] = P() if getattr(sidx, f) is not None else None
    for f in _META:
        kw[f] = getattr(sidx, f)
    return ShardedIndex(**kw)


def place_sharded(sidx: ShardedIndex, mesh) -> ShardedIndex:
    """device_put every field with its NamedSharding on the mesh."""
    specs = sharding_specs(sidx)
    placed = {}
    for f in _STACKED + _REPLICATED:
        v = getattr(sidx, f)
        if v is None:
            placed[f] = None
            continue
        placed[f] = jax.device_put(
            np.asarray(v), NamedSharding(mesh, getattr(specs, f))
        )
    for f in _META:
        placed[f] = getattr(sidx, f)
    return ShardedIndex(**placed)


# --------------------------------------------------------------- SPMD body


class _ShardLocal:
    """Per-device view inside shard_map (leading stacked dim squeezed)."""

    def __init__(self, sidx: ShardedIndex):
        self.rank_rows = sidx.rank_rows[0]
        self.sym4 = sidx.sym4[0]
        self.dollar_chunk = sidx.dollar_chunk[0]
        self.sample_chunk = sidx.sample_chunk[0]
        self.start = sidx.starts[0]
        self.len = sidx.lens[0]
        self.dstart = sidx.dstarts[0]
        self.dlen = sidx.dlens[0]
        self.rstart = sidx.rstarts[0]
        self.rlen = sidx.rlens[0]
        self.C = sidx.C
        self.meta = sidx
        self.rank2_rows = (
            sidx.rank2_rows[0] if sidx.rank2_rows is not None else None
        )
        self.C2 = sidx.C2
        self.rank3_rows = (
            sidx.rank3_rows[0] if sidx.rank3_rows is not None else None
        )
        self.C3 = sidx.C3
        self.sym_totals = (
            sidx.sym_totals[0] if sidx.sym_totals is not None else None
        )
        self.totals2 = sidx.totals2[0] if sidx.totals2 is not None else None
        self.totals3 = sidx.totals3[0] if sidx.totals3 is not None else None
        if sidx.has_fast_resolve:
            self.lf = sidx.lf_chunk[0]
            self.mark_table = sidx.mark_table[0]
            self.spairs = sidx.spairs_chunk[0]
            self.sstart = sidx.sstarts[0]
            self.slen = sidx.slens[0]
        self.dsa = sidx.dsa_chunk[0] if sidx.dsa_chunk is not None else None

    def occ_global(self, c: jax.Array, i: jax.Array) -> jax.Array:
        """c int32 [X], i int64 [X] → global occ int64 [X] (one psum)."""
        loc = jnp.clip(i - self.start, 0, self.len).astype(jnp.int32)
        r = occ_rows(
            self.rank_rows,
            c,
            loc,
            rows_per_symbol=self.meta.rows_per_symbol,
            log2_block=self.meta.log2_block,
            words_per_block=self.meta.words_per_block,
        )
        return jax.lax.psum(r.astype(jnp.int64), "shard")

    def occ_plane_global(
        self, table: jax.Array, code: jax.Array, i: jax.Array
    ) -> jax.Array:
        """Clamped-psum rank over a k-gram plane table (same identity as
        occ_global; the plane tables share the base layout's geometry)."""
        loc = jnp.clip(i - self.start, 0, self.len).astype(jnp.int32)
        r = occ_rows(
            table,
            code,
            loc,
            rows_per_symbol=self.meta.rows_per_symbol,
            log2_block=self.meta.log2_block,
            words_per_block=self.meta.words_per_block,
        )
        return jax.lax.psum(r.astype(jnp.int64), "shard")

    def occ_global_routed(
        self,
        table: jax.Array,
        totals: jax.Array,
        rows_per_symbol: int,
        code: jax.Array,
        i: jax.Array,
        capacity: int,
    ) -> jax.Array:
        """Owner-computes rank with the SAME single psum as the clamped
        form, but each shard's HBM gather covers only lanes it OWNS.

        The clamped-psum identity makes every shard gather all X lanes
        (out-of-range lanes still cost a full rank-row fetch), so the
        shard axis adds capacity but not rank throughput.  Here the
        exterior contributions are table lookups (0 below the shard,
        ``totals[code]`` above) and only interior lanes — compacted by
        prefix-sum into a static ``capacity`` — hit the rank table:
        expected gather width X/S per shard.  A local while_loop repeats
        the round in the rare case a shard owns more than ``capacity``
        lanes; the body is collective-free, so per-device trip counts may
        diverge safely, and the merge stays ONE psum afterwards.  This is
        the owner-routing fallback SURVEY.md §7.6 names, realized without
        ppermute (positions are already replicated across 'shard', so
        routing needs no data movement — only gather-lane masking).
        """
        X = i.shape[0]
        li = i - self.start
        interior = (li > 0) & (li < self.len)
        contrib = jnp.where(li >= self.len, jnp.take(totals, code), 0)
        lanes = jnp.arange(X, dtype=jnp.int32)

        def round_(state):
            contrib, pending = state
            pi = pending.astype(jnp.int32)
            pos = jnp.cumsum(pi) - pi
            keep = pending & (pos < capacity)
            slot = jnp.where(keep, pos, capacity)
            rows_c = jnp.zeros(capacity, dtype=jnp.int32).at[slot].set(
                jnp.where(keep, li, 0).astype(jnp.int32), mode="drop"
            )
            code_c = jnp.zeros(capacity, dtype=code.dtype).at[slot].set(
                jnp.where(keep, code, 0), mode="drop"
            )
            orig = jnp.full(capacity, X, dtype=jnp.int32).at[slot].set(
                lanes, mode="drop"
            )
            r = occ_rows(
                table,
                code_c,
                rows_c,
                rows_per_symbol=rows_per_symbol,
                log2_block=self.meta.log2_block,
                words_per_block=self.meta.words_per_block,
            )
            add = jnp.zeros(X, dtype=contrib.dtype).at[orig].set(
                r.astype(contrib.dtype), mode="drop"
            )
            return contrib + add, pending & ~keep

        contrib, _ = jax.lax.while_loop(
            lambda st: jnp.any(st[1]), round_, (contrib, interior)
        )
        return jax.lax.psum(contrib, "shard")

    def sym_global(self, i: jax.Array) -> jax.Array:
        """BWT symbol at global positions i (int64 [X]) → int32 [X]."""
        inr = (i >= self.start) & (i < self.start + self.len)
        loc = jnp.clip(i - self.start, 0, jnp.maximum(self.len - 1, 0)).astype(
            jnp.int32
        )
        word = jnp.take(self.sym4, loc >> 3, axis=0)
        v = ((word >> ((loc & 7) << 2).astype(_U32)) & _U32(0xF)).astype(
            jnp.int32
        )
        return jax.lax.psum(jnp.where(inr, v, 0), "shard")

    def dollar_global(self, dr: jax.Array) -> jax.Array:
        """Global $-rank (int64 [X]) → read id int32 [X]."""
        inr = (dr >= self.dstart) & (dr < self.dstart + self.dlen)
        loc = jnp.clip(dr - self.dstart, 0, jnp.maximum(self.dlen - 1, 0)).astype(
            jnp.int32
        )
        v = jnp.take(self.dollar_chunk, loc, axis=0)
        return jax.lax.psum(jnp.where(inr, v, 0), "shard")

    def sample_global(self, rid: jax.Array) -> jax.Array:
        """Read id (int32 [X]) → sample id int32 [X]."""
        r64 = rid.astype(jnp.int64)
        inr = (r64 >= self.rstart) & (r64 < self.rstart + self.rlen)
        loc = jnp.clip(r64 - self.rstart, 0, jnp.maximum(self.rlen - 1, 0)).astype(
            jnp.int32
        )
        v = jnp.take(self.sample_chunk, loc, axis=0)
        return jax.lax.psum(jnp.where(inr, v, 0), "shard")

    # ---------------------------------------------- fast-resolve helpers

    def dsa_global(self, i: jax.Array) -> jax.Array:
        """Packed (read_id << bits | offset) at global rows i (int64 [X])
        — ONE masked psum; the whole resolve for rows this tier covers."""
        inr = (i >= self.start) & (i < self.start + self.len)
        loc = jnp.clip(i - self.start, 0, jnp.maximum(self.len - 1, 0)).astype(
            jnp.int32
        )
        v = jnp.take(self.dsa, loc, axis=0)
        return jax.lax.psum(jnp.where(inr, v, _U32(0)), "shard")

    def lf_raw_global(self, i: jax.Array) -> jax.Array:
        """Raw LF value (sign bit = sampled) at global rows i (int64 [X]).

        Exactly one shard is in range; the masked psum preserves the sign
        bit because all other contributions are 0."""
        lf = self.lf
        inr = (i >= self.start) & (i < self.start + self.len)
        loc = jnp.clip(i - self.start, 0, jnp.maximum(self.len - 1, 0)).astype(
            jnp.int32
        )
        v = jnp.take(lf, loc, axis=0)
        return jax.lax.psum(jnp.where(inr, v, 0), "shard")

    def mark_rank_global(self, i: jax.Array) -> jax.Array:
        """# of sampled rows before global row i — clamped-psum identity,
        same decomposition as occ_global."""
        loc = jnp.clip(i - self.start, 0, self.len).astype(jnp.int32)
        r = occ_rows(
            self.mark_table,
            jnp.zeros_like(loc),
            loc,
            rows_per_symbol=self.mark_table.shape[0],
            log2_block=self.meta.log2_block,
            words_per_block=self.meta.words_per_block,
        )
        return jax.lax.psum(r.astype(jnp.int64), "shard")

    def sample_pair_global(self, slot: jax.Array) -> jax.Array:
        """Global mark-rank slot (int64 [X]) → (read_id, offset) int32 [X,2]."""
        inr = (slot >= self.sstart) & (slot < self.sstart + self.slen)
        loc = jnp.clip(
            slot - self.sstart, 0, jnp.maximum(self.slen - 1, 0)
        ).astype(jnp.int32)
        v = jnp.take(self.spairs, loc, axis=0)
        return jax.lax.psum(jnp.where(inr[:, None], v, 0), "shard")

    # ------------------------------------------ fused terminal collectives
    # The resolve walk's terminal lookups are independent pairs; fusing
    # each pair into one concatenated psum halves the collective COUNT of
    # the tail (4 → 2) without changing any value — masked contributions
    # compose because every element is nonzero on at most one shard.

    def lf_and_mark_global(
        self, i: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """(raw LF int32 [X], mark rank int64 [X]) in ONE psum."""
        X = i.shape[0]
        inr = (i >= self.start) & (i < self.start + self.len)
        loci = jnp.clip(
            i - self.start, 0, jnp.maximum(self.len - 1, 0)
        ).astype(jnp.int32)
        v = jnp.where(inr, jnp.take(self.lf, loci, axis=0), 0)
        locc = jnp.clip(i - self.start, 0, self.len).astype(jnp.int32)
        r = occ_rows(
            self.mark_table,
            jnp.zeros_like(locc),
            locc,
            rows_per_symbol=self.mark_table.shape[0],
            log2_block=self.meta.log2_block,
            words_per_block=self.meta.words_per_block,
        )
        both = jax.lax.psum(
            jnp.concatenate([v.astype(jnp.int64), r.astype(jnp.int64)]),
            "shard",
        )
        return both[:X].astype(jnp.int32), both[X:]

    def dollar_and_pair_global(
        self, dr: jax.Array, slot: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """(read id int32 [X], (rid, off) int32 [X,2]) in ONE psum."""
        X = dr.shape[0]
        inr_d = (dr >= self.dstart) & (dr < self.dstart + self.dlen)
        locd = jnp.clip(
            dr - self.dstart, 0, jnp.maximum(self.dlen - 1, 0)
        ).astype(jnp.int32)
        vd = jnp.where(inr_d, jnp.take(self.dollar_chunk, locd, axis=0), 0)
        inr_s = (slot >= self.sstart) & (slot < self.sstart + self.slen)
        locs = jnp.clip(
            slot - self.sstart, 0, jnp.maximum(self.slen - 1, 0)
        ).astype(jnp.int32)
        vp = jnp.where(
            inr_s[:, None], jnp.take(self.spairs, locs, axis=0), 0
        )
        cat = jax.lax.psum(
            jnp.concatenate([vd, vp.reshape(-1)]), "shard"
        )
        return cat[:X], cat[X:].reshape(X, 2)


def _query_body(
    sidx, lut, kmers, lengths, *,
    max_hits: int, lut_p: int, kstep: int = 1, early_exit: bool = False,
    exact_hist: bool = False, exact_max_rows: int | None = None,
    resolve_budget: int | None = None, walk_early_exit: bool = False,
    owner_route: bool = False, route_capacity: int | None = None,
):
    """Full query step inside shard_map: search + resolve + attribution.

    kmers int32 [Bloc, K]; all interval math int64; outputs replicated
    across 'shard' (established by psum), sharded over 'dp'.  When
    ``lut`` is given (int64 [4^p, 2], replicated) every query length must
    be ≥ lut_p — the engine routes shorter batches to the plain variant.

    ``kstep >= 2`` uses the pair/triple plane tiers (one clamped-psum rank
    advances 2/3 characters — ÷k dependent gathers AND ÷k collectives per
    query); it requires a uniform full-width batch (every length == K),
    like the single-chip ``backward_search_pair``.  ``early_exit`` wraps
    the k-step scan in a while_loop that stops once every interval in the
    whole (global) batch is empty — liveness is made mesh-uniform with a
    ``pmax`` over 'dp' (l/u are already shard-invariant via psum).

    ``resolve_budget`` compacts valid hit lanes before the LF-walk so the
    walk's per-step 'shard' psum width scales with real hits, not B·H
    padding; ``walk_early_exit`` stops the walk when every lane in the
    global batch has terminated.  Both preserve exact answers except that
    budget-dropped lanes surface as ``hits_truncated`` (same contract as
    the single-chip ``resolve_intervals(row_budget=...)``).
    """
    loc = _ShardLocal(sidx)
    B, K = kmers.shape
    n, m = sidx.n, sidx.num_reads

    # owner-routed search rank: static per-round gather capacity, default
    # 1.25 × the uniform share of the 2B (l,u) lanes, 128-lane aligned;
    # ``route_capacity`` (ServeConfig.owner_route_capacity) overrides —
    # an undersized capacity is CORRECT (the overflow while_loop runs
    # more local rounds), just slower
    S_ = sidx.num_shards
    route = 0
    if owner_route and S_ > 1 and loc.sym_totals is not None:
        route = (
            min(2 * B, int(route_capacity))
            if route_capacity
            else min(2 * B, max(128, -(-(2 * B * 5) // (4 * S_ * 128)) * 128))
        )

    def occ_g(c, i):
        if route:
            return loc.occ_global_routed(
                loc.rank_rows, loc.sym_totals, sidx.rows_per_symbol,
                c, i, route,
            )
        return loc.occ_global(c, i)

    def occ_pg(table, totals, code, i):
        if route and totals is not None:
            return loc.occ_global_routed(
                table, totals, sidx.rows_per_symbol, code, i, route
            )
        return loc.occ_plane_global(table, code, i)

    # NB: every loop carry below derives from dp-sharded inputs (kmers →
    # l/u → rows), so carries are born 'dp'-varying and need no pcast
    if lut is not None:
        from readserver_tpu.ops.search import prefix_ids

        rows0 = jnp.take(lut, prefix_ids(kmers, lut_p), axis=0)
        l0, u0 = rows0[:, 0], rows0[:, 1]
        last_col = K - lut_p
    else:
        # right-aligned queries: last char in column K-1 for every query,
        # so the first step's interval comes straight from the C array
        # (occ(c,0)=0, occ(c,n)=count(c))
        c_last = kmers[:, K - 1]
        l0 = jnp.take(loc.C, c_last)  # already 'dp'-varying via kmers
        u0 = jnp.take(loc.C, c_last + 1)
        last_col = K - 1
    if kstep >= 2 and loc.rank2_rows is not None:
        def run_steps(l, u, steps, table, totals, starts):
            nsteps = steps.shape[0]
            if not nsteps:
                return l, u

            def apply(l, u, code):
                active = l < u
                occ2 = occ_pg(
                    table,
                    totals,
                    jnp.concatenate([code, code]),
                    jnp.concatenate([l, u]),
                )
                base = jnp.take(starts, code)
                return (
                    jnp.where(active, base + occ2[:B], l),
                    jnp.where(active, base + occ2[B:], u),
                )

            if early_exit:
                def cond(state):
                    t, l, u = state
                    alive = jnp.any(l < u).astype(jnp.int32)
                    # while cond must agree on every device: l/u are
                    # shard-invariant (psum); pmax makes them dp-uniform
                    return (t < nsteps) & (jax.lax.pmax(alive, "dp") > 0)

                def body(state):
                    t, l, u = state
                    code = jax.lax.dynamic_index_in_dim(
                        steps, t, keepdims=False
                    )
                    l, u = apply(l, u, code)
                    return t + 1, l, u

                _, l, u = jax.lax.while_loop(
                    cond, body, (jnp.int32(0), l, u)
                )
                return l, u

            (l, u), _ = jax.lax.scan(
                lambda c, code: (apply(*c, code), None), (l, u), steps
            )
            return l, u

        # greedy schedule as in ops/search.backward_search_pair: 3-char
        # steps while the tier exists, then a 2- or 1-char remainder at
        # the pattern's LEFT end (runs last)
        r = last_col
        ntriples = r // 3 if (kstep >= 3 and loc.rank3_rows is not None) else 0
        rem = r - 3 * ntriples
        l, u = l0, u0
        if ntriples:
            sub3 = kmers[:, rem:r]
            codes3 = (
                (sub3[:, 0::3] - 1) * 16
                + (sub3[:, 1::3] - 1) * 4
                + (sub3[:, 2::3] - 1)
            )
            l, u = run_steps(
                l, u, jnp.flip(codes3.T, axis=0), loc.rank3_rows,
                loc.totals3, loc.C3,
            )
        npairs = rem // 2
        if npairs:
            sub2 = kmers[:, rem % 2 : rem]
            codes2 = (sub2[:, 0::2] - 1) * 4 + (sub2[:, 1::2] - 1)
            l, u = run_steps(
                l, u, jnp.flip(codes2.T, axis=0), loc.rank2_rows,
                loc.totals2, loc.C2,
            )
        if rem % 2:
            c0 = kmers[:, 0]
            active = l < u
            occ2 = occ_g(
                jnp.concatenate([c0, c0]), jnp.concatenate([l, u])
            )
            base = jnp.take(loc.C, c0)
            l = jnp.where(active, base + occ2[:B], l)
            u = jnp.where(active, base + occ2[B:], u)
    else:
        cols = jnp.flip(kmers[:, :last_col].T, axis=0)
        js = jnp.arange(last_col - 1, -1, -1, dtype=jnp.int32)

        def step(carry, xs):
            l, u = carry
            c, j = xs
            active = (j >= K - lengths) & (l < u)
            occ2 = occ_g(
                jnp.concatenate([c, c]), jnp.concatenate([l, u])
            )
            base = jnp.take(loc.C, c)
            l = jnp.where(active, base + occ2[:B], l)
            u = jnp.where(active, base + occ2[B:], u)
            return (l, u), None

        (l, u), _ = jax.lax.scan(step, (l0, u0), (cols, js))

    # canonical empty intervals (ops/search.canonical_empty contract):
    # frozen bounds differ across step granularities; (0, 0) everywhere
    empty = l >= u
    zero64 = jnp.zeros_like(l)
    l = jnp.where(empty, zero64, l)
    u = jnp.where(empty, zero64, u)

    # resolve: expand intervals, lockstep LF-walk with psum-merged ranks
    H = max_hits
    span = jnp.arange(H, dtype=jnp.int64)
    rows = (l[:, None] + span[None, :]).reshape(-1)
    valid = (span[None, :] < (u - l)[:, None]).reshape(-1)
    rows = jnp.where(valid, rows, 0)

    def run_walk(nsteps, body, state):
        """fori_loop, or (walk_early_exit) a while_loop that stops once
        every lane in the whole global batch terminated — done is shard-
        invariant (derived from psum'd values), so only a scalar 'dp' pmax
        is needed for mesh-uniform liveness.  Saves the expected ~half of
        the walk's per-step 'shard' psum volume at the cost of one scalar
        collective per executed step."""
        if not walk_early_exit:
            return jax.lax.fori_loop(0, nsteps, body, state)

        def cond(st):
            t, inner = st
            alive = jnp.any(~inner[1]).astype(jnp.int32)  # inner[1] = done
            return (t < nsteps) & (jax.lax.pmax(alive, "dp") > 0)

        def wbody(st):
            t, inner = st
            return t + 1, body(t, inner)

        return jax.lax.while_loop(cond, wbody, (jnp.int32(0), state))[1]

    def do_walk(wrows, wvalid):
        """Lockstep LF-walk over global rows → (read_id, offset)."""
        if sidx.dsa_chunk is not None and sidx.dsa_bits > 0:
            # direct tier: the whole resolve is ONE masked psum-gather —
            # no walk, no per-step collective rounds
            p = loc.dsa_global(wrows)
            bits = sidx.dsa_bits
            rid = (p >> bits).astype(jnp.int32)
            off = (p & _U32((1 << bits) - 1)).astype(jnp.int32)
            return (
                jnp.where(wvalid, rid, -1),
                jnp.where(wvalid, off, -1),
            )
        if sidx.has_fast_resolve:
            # sampled-LF walk: 1 psum-gather per step, bound = sample_rate
            # (carries derive from wrows, so they are already dp-varying)
            state = (wrows, ~wvalid, wrows.astype(jnp.int32) * 0)

            def fwalk(t, state):
                cur, done, steps = state
                raw = loc.lf_raw_global(cur)
                val = (raw & jnp.int32(0x7FFFFFFF)).astype(jnp.int64)
                is_term = (raw < 0) | (val < m)
                step_now = ~done & ~is_term
                cur = jnp.where(step_now, val, cur)
                steps = steps + step_now.astype(jnp.int32)
                done = done | is_term
                return cur, done, steps

            cur, done, steps = run_walk(
                max(sidx.sample_rate, 1), fwalk, state
            )
            # terminal: two fused psums (lf+mark_rank, then dollar+pair)
            raw, slot = loc.lf_and_mark_global(cur)
            is_marked = raw < 0
            val = (raw & jnp.int32(0x7FFFFFFF)).astype(jnp.int64)
            rid_d, pair = loc.dollar_and_pair_global(val, slot)
            read_id = jnp.where(is_marked, pair[:, 0], rid_d)
            offset = jnp.where(is_marked, pair[:, 1] + steps, steps)
            ok = wvalid & done
            return jnp.where(ok, read_id, -1), jnp.where(ok, offset, -1)

        # slow walk: carry the terminal $-rank and look the read id up
        # ONCE after the loop — 2 psums/step (sym + occ) instead of 3
        state = (
            wrows,
            ~wvalid,
            wrows * 0 - 1,                       # drank (int64)
            wrows.astype(jnp.int32) * 0 - 1,     # offset
        )

        def walk(t, state):
            cur, done, drank, offset = state
            c = loc.sym_global(cur)
            o = loc.occ_global(c, cur)
            hit = (c == 0) & ~done
            drank = jnp.where(hit, o, drank)
            offset = jnp.where(hit, t, offset)
            done = done | (c == 0)
            nxt = jnp.take(loc.C, c) + o
            cur = jnp.where(done, cur, nxt)
            return cur, done, drank, offset

        _, done, drank, offset = run_walk(sidx.max_read_len, walk, state)
        rid = loc.dollar_global(jnp.maximum(drank, 0))
        ok = wvalid & done
        return jnp.where(ok, rid, -1), jnp.where(ok, offset, -1)

    F = B * H
    if resolve_budget is not None and resolve_budget < F:
        # row-budget compaction (ops/resolve.resolve_intervals contract):
        # valid lanes are prefix-sum-compacted into a static budget before
        # the walk and scattered back after.  Every per-step 'shard' psum
        # in the walk shrinks from F to R_c lanes — the collective VOLUME
        # now scales with actual hits, not with B·max_hits padding.
        # Compaction itself is collective-free: rows/valid are shard-
        # invariant (psum-derived), so every shard compacts identically.
        R_c = resolve_budget
        vi = valid.astype(jnp.int32)
        pos = jnp.cumsum(vi) - vi
        keep = valid & (pos < R_c)
        slot = jnp.where(keep, pos, R_c)  # R_c = overflow slot, dropped
        comp_rows = jnp.zeros(R_c, dtype=rows.dtype).at[slot].set(
            rows, mode="drop"
        )
        comp_valid = jnp.zeros(R_c, dtype=bool).at[slot].set(
            keep, mode="drop"
        )
        orig = jnp.full(R_c, F, dtype=jnp.int32).at[slot].set(
            jnp.arange(F, dtype=jnp.int32), mode="drop"
        )
        rid_c, off_c = do_walk(comp_rows, comp_valid)
        read_id = jnp.full(F, -1, dtype=jnp.int32).at[orig].set(
            rid_c, mode="drop"
        )
        offset = jnp.full(F, -1, dtype=jnp.int32).at[orig].set(
            off_c, mode="drop"
        )
        valid_w = valid & keep
    else:
        read_id, offset = do_walk(rows, valid)
        valid_w = valid
    sample = loc.sample_global(jnp.clip(read_id, 0, max(m - 1, 0)))
    S = sidx.num_samples
    seg = jnp.repeat(jnp.arange(B, dtype=jnp.int32), H) * S + sample
    hist = jax.ops.segment_sum(
        valid_w.astype(jnp.int32), seg, num_segments=B * S
    ).reshape(B, S)
    # complete iff the interval fit the cap AND no lane was budget-dropped
    hist_complete = ((u - l) <= H) & (
        valid_w.reshape(B, H).sum(axis=1) == valid.reshape(B, H).sum(axis=1)
    )

    if exact_hist:
        # exact attribution (no hit cap): dense sweep of the concatenated
        # intervals in windows of B*H rows — same worklist scheme as
        # ops/resolve.exact_sample_histogram, with psum-merged walks.
        # Trip count is made dp-uniform (pmax) so every device runs the
        # same number of 'shard' collectives; spare iterations on shorter
        # dp rows carry no valid lanes.
        W = B * H
        counts64 = u - l
        cum = jnp.cumsum(counts64)
        total_u = jax.lax.pmax(cum[B - 1], "dp")
        span64 = jnp.arange(W, dtype=jnp.int64)
        cap = exact_max_rows

        def scond(state):
            t, _ = state
            alive = t * W < total_u
            if cap is not None:
                alive = alive & (t * W < cap)
            return alive

        def sbody(state):
            t, hh = state
            g = t * W + span64
            gvalid = g < cum[B - 1]
            q = jnp.searchsorted(cum, g, side="right").astype(jnp.int32)
            qc = jnp.minimum(q, B - 1)
            prev = jnp.where(qc > 0, jnp.take(cum, jnp.maximum(qc - 1, 0)), 0)
            wrows = jnp.take(l, qc) + (g - prev)
            rid, _ = do_walk(jnp.where(gvalid, wrows, 0), gvalid)
            samp = loc.sample_global(jnp.clip(rid, 0, max(m - 1, 0)))
            seg2 = qc * S + samp
            hh = hh + jax.ops.segment_sum(
                gvalid.astype(jnp.int32), seg2, num_segments=B * S
            ).reshape(B, S)
            return t + 1, hh

        zero = jnp.zeros((B, S), dtype=jnp.int32) + (l[:, None] * 0).astype(
            jnp.int32
        )
        t_end, hist = jax.lax.while_loop(scond, sbody, (jnp.int64(0), zero))
        hist_complete = cum <= t_end * W

    return dict(
        l=l,
        u=u,
        count=u - l,
        read_id=read_id.reshape(B, H),
        offset=offset.reshape(B, H),
        valid=valid_w.reshape(B, H),
        sample_hist=hist,
        hist_complete=hist_complete,
    )


def make_sharded_query_fn(
    sidx: ShardedIndex,
    mesh,
    max_hits: int = 64,
    lut_p: int = 0,
    kstep: int | None = None,
    early_exit: bool = False,
    exact_hist: bool = False,
    exact_max_rows: int | None = None,
    resolve_budget: int | None = None,
    walk_early_exit: bool = False,
    owner_route: bool = False,
    route_capacity: int | None = None,
):
    """jit'd SPMD query fn with B sharded over 'dp', index over 'shard'.

    ``owner_route=True`` switches the search ranks to owner-computes
    gathers (per-shard width 1.25·2B/S instead of 2B; see
    ``_ShardLocal.occ_global_routed``) — collective volume unchanged,
    per-chip HBM gather traffic ÷S.  No-op at num_shards == 1.

    Signature: ``fn(sidx, lut_or_None, kmers [B,K] i32, lengths [B] i32)
    → dict``.  When built with ``lut_p > 0`` the returned fn REQUIRES a
    replicated int64 [4^p, 2] LUT and query lengths ≥ lut_p.

    ``kstep=None`` auto-selects the deepest k-gram tier the index carries;
    a fn built with ``kstep >= 2`` additionally requires every query
    length == K (uniform full-width batches — the engine routes
    mixed-length batches to a ``kstep=1`` variant).
    """
    if kstep is None:
        kstep = (
            3 if sidx.rank3_rows is not None
            else 2 if sidx.rank2_rows is not None
            else 1
        )
    idx_specs = sharding_specs(sidx)
    fn = jax.shard_map(
        partial(
            _query_body,
            max_hits=max_hits,
            lut_p=lut_p,
            kstep=kstep,
            early_exit=early_exit,
            exact_hist=exact_hist,
            exact_max_rows=exact_max_rows,
            resolve_budget=resolve_budget,
            walk_early_exit=walk_early_exit,
            owner_route=owner_route,
            route_capacity=route_capacity,
        ),
        mesh=mesh,
        in_specs=(idx_specs, P() if lut_p else None, P("dp", None), P("dp")),
        out_specs=dict(
            l=P("dp"),
            u=P("dp"),
            count=P("dp"),
            read_id=P("dp", None),
            offset=P("dp", None),
            valid=P("dp", None),
            sample_hist=P("dp", None),
            hist_complete=P("dp"),
        ),
    )
    return jax.jit(fn)


def build_prefix_lut_sharded(sidx: ShardedIndex, mesh, p: int) -> jax.Array:
    """Prefix LUT (int64 [4^p, 2], replicated) built with the sharded
    global rank — same level-BFS as ops/lut.py, bit-exact with the sharded
    search it accelerates."""
    idx_specs = sharding_specs(sidx)

    def level_body(sidx, l, u):
        loc = _ShardLocal(sidx)
        size = l.shape[0]
        cc = jnp.repeat(jnp.arange(1, 5, dtype=jnp.int32), size)
        l4 = jnp.tile(l, 4)
        u4 = jnp.tile(u, 4)
        occ2 = loc.occ_global(
            jnp.concatenate([cc, cc]), jnp.concatenate([l4, u4])
        )
        base = jnp.take(loc.C, cc)
        # freeze empty intervals — bit-exact with the stepwise search
        alive = l4 < u4
        nl = jnp.where(alive, base + occ2[: 4 * size], l4)
        nu = jnp.where(alive, base + occ2[4 * size :], u4)
        return nl, nu

    level_fn = jax.jit(
        jax.shard_map(
            level_body,
            mesh=mesh,
            in_specs=(idx_specs, P(), P()),
            out_specs=(P(), P()),
        )
    )
    l = sidx.C[1:5]
    u = sidx.C[2:6]
    for _ in range(p - 1):
        l, u = level_fn(sidx, l, u)
    empty = l >= u  # canonical (0, 0) for absent p-mers (search contract)
    zero = jnp.zeros_like(l)
    return jnp.stack([jnp.where(empty, zero, l), jnp.where(empty, zero, u)], axis=1)
