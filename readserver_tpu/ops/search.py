"""Batched lockstep backward search (the hot path, SURVEY.md §3.2).

The reference iterates one k-mer at a time through
``l' = C(c) + Occ(c, l-1)`` / ``u' = C(c) + Occ(c, u) - 1`` (inclusive
bounds, SGA convention).  Here the whole batch advances one character per
``lax.scan`` step over half-open intervals:

    l' = C[c] + occ(c, l);   u' = C[c] + occ(c, u)

with masking for variable-length queries and already-empty intervals.  Both
ranks of a step fuse into one ``[2B]`` row gather per step.

Two accelerations (rank row-gathers are the entire cost):

* **Right-aligned queries + C-array init.** Queries are encoded right-
  aligned, so every query's *last* character sits in column K-1, and the
  first backward step needs no rank at all:
  ``occ(c, 0) = 0`` and ``occ(c, n) = count(c)``, hence
  ``l0 = C[c], u0 = C[c+1]``.
* **Prefix LUT.** ``lut[id(w)] = interval(w)`` for every p-mer ``w``
  (built on device in ~2.7·4^p ranks, ops/lut.py) replaces the first p
  steps of every query with a single row gather — for 31-mers with p=12,
  38 rank gathers instead of 62.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from readserver_tpu import alphabet
from readserver_tpu.ops import rank as rank_ops
from readserver_tpu.ops.types import DeviceIndex


def encode_query_batch(
    kmers: Sequence[np.ndarray | str | bytes], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """k-mers → (codes int32 [B, max_len] RIGHT-aligned 0-padded, lengths).

    Right alignment puts every query's final character in the last column,
    which the C-init and prefix-LUT fast paths rely on.
    """
    B = len(kmers)
    out = np.zeros((B, max_len), dtype=np.int32)
    if B and all(isinstance(k, (str, bytes)) for k in kmers):
        # vectorized fast path (the wire-serving hot spot: encoding was
        # ~9µs/query in the Python loop — 50x one device search step):
        # one join, one LUT gather, one flat scatter for the whole batch
        lengths64 = np.fromiter(
            (len(k) for k in kmers), dtype=np.int64, count=B
        )
        if lengths64.min() < 1 or lengths64.max() > max_len:
            bad = int(
                np.flatnonzero((lengths64 < 1) | (lengths64 > max_len))[0]
            )
            raise ValueError(
                f"query length {lengths64[bad]} outside [1, {max_len}]"
            )
        joined = b"".join(
            k.encode("ascii") if isinstance(k, str) else bytes(k)
            for k in kmers
        )
        raw = np.frombuffer(joined, dtype=np.uint8)
        codes = alphabet._ENCODE_LUT[raw]
        if codes.size and not codes.all():
            bad = chr(raw[int(np.argmin(codes))])
            raise ValueError(f"non-ACGT character {bad!r} in sequence")
        # right-aligned flat scatter: query b's chars land at row b,
        # columns [max_len - L_b, max_len)
        starts = np.repeat(
            max_len * np.arange(B, dtype=np.int64) + (max_len - lengths64),
            lengths64,
        )
        cum = np.cumsum(lengths64) - lengths64
        offs = np.arange(len(raw), dtype=np.int64) - np.repeat(cum, lengths64)
        out.reshape(-1)[starts + offs] = codes
        return out, lengths64.astype(np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for b, km in enumerate(kmers):
        codes = km if isinstance(km, np.ndarray) else alphabet.encode(km)
        L = len(codes)
        if L == 0 or L > max_len:
            raise ValueError(f"query length {L} outside [1, {max_len}]")
        out[b, max_len - L :] = codes
        lengths[b] = L
    return out, lengths


def _scan_steps(
    index, rank_fn, kmers, lengths, l, u, last_col: int,
    early_exit: bool = False,
):
    """Masked lockstep steps over columns last_col-1 .. 0.

    ``early_exit`` switches the ``scan`` to a ``while_loop`` that stops
    once no query can change (every interval empty or already finished) —
    identical results, and on miss-heavy workloads most rank gathers are
    skipped (the reference server's per-query loop gets this for free;
    lockstep batches only get it when the whole batch dies).
    """
    B, K = kmers.shape
    C = index.C
    if last_col <= 0:
        return l, u
    cols = jnp.flip(kmers[:, :last_col].T, axis=0)           # [last_col, B]
    js = jnp.arange(last_col - 1, -1, -1, dtype=jnp.int32)

    def apply(l, u, c, j):
        active = (j >= K - lengths) & (l < u)
        occ2 = rank_fn(jnp.concatenate([c, c]), jnp.concatenate([l, u]))
        base = jnp.take(C, c)
        l = jnp.where(active, base + occ2[:B], l)
        u = jnp.where(active, base + occ2[B:], u)
        return l, u, active

    if not early_exit:
        def step(carry, xs):
            l, u = carry
            l, u, _ = apply(l, u, *xs)
            return (l, u), None

        (l, u), _ = jax.lax.scan(step, (l, u), (cols, js))
        return l, u

    def cond(state):
        t, l, u, alive = state
        return (t < last_col) & alive

    def body(state):
        t, l, u, _ = state
        c = jax.lax.dynamic_index_in_dim(cols, t, keepdims=False)
        j = js[t]
        l, u, active = apply(l, u, c, j)
        # will anyone still be active at a LATER column? (j decreases)
        alive = jnp.any((js[t] - 1 >= K - lengths) & (l < u))
        return t + 1, l, u, alive

    _, l, u, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), l, u, jnp.bool_(True))
    )
    return l, u


def canonical_empty(l: jax.Array, u: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Normalize empty intervals to ``(0, 0)``.

    An empty interval's frozen bounds depend on step granularity (the
    1/2/3-char tiers die at different steps), so bounds would otherwise
    fall outside the parity contract for misses.  Every search output —
    device, sharded, oracle — passes through this normalization, making
    interval bounds exactly comparable for ALL queries.
    """
    empty = l >= u
    zero = jnp.zeros_like(l)
    return jnp.where(empty, zero, l), jnp.where(empty, zero, u)


def backward_search(
    index: DeviceIndex,
    kmers: jax.Array,     # int32 [B, K], codes 1..4 RIGHT-aligned, 0 padding
    lengths: jax.Array,   # int32 [B], all >= 1
    rank_fn=None,
    early_exit: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """→ half-open interval ``(l, u)`` per query, int32 [B] each.

    ``count = u - l`` (occ monotonicity keeps ``l <= u`` throughout);
    empty intervals come out as the canonical ``(0, 0)``.
    """
    B, K = kmers.shape
    if rank_fn is None:
        def rank_fn(c, i):
            return rank_ops.occ(index, c, i)

    # free first step: last char's interval comes straight from C
    # (C[5] == n and C[c+1]-C[c] == count(c), so no static n is needed —
    # this keeps the function valid per-shard under document sharding,
    # where each shard's n differs)
    c_last = kmers[:, K - 1]
    l = jnp.take(index.C, c_last)
    u = jnp.take(index.C, c_last + 1)
    l, u = _scan_steps(
        index, rank_fn, kmers, lengths, l, u, K - 1, early_exit=early_exit
    )
    return canonical_empty(l, u)


def prefix_ids(kmers: jax.Array, p: int) -> jax.Array:
    """int32 [B]: id of each query's last-p-character suffix (first char
    most significant). Valid only for queries with length ≥ p."""
    B, K = kmers.shape
    tail = kmers[:, K - p :]                                  # [B, p]
    weights = 4 ** jnp.arange(p - 1, -1, -1, dtype=jnp.int32)  # [p]
    return jnp.sum((tail - 1) * weights[None, :], axis=1).astype(jnp.int32)


def backward_search_lut(
    index: DeviceIndex,
    lut: jax.Array,       # int32 [4^p, 2] p-mer intervals (ops/lut.py)
    p: int,
    kmers: jax.Array,     # int32 [B, K] right-aligned; ALL lengths >= p
    lengths: jax.Array,
    rank_fn=None,
) -> tuple[jax.Array, jax.Array]:
    """LUT-accelerated search: first p steps collapse to one row gather."""
    B, K = kmers.shape
    if rank_fn is None:
        def rank_fn(c, i):
            return rank_ops.occ(index, c, i)
    rows = jnp.take(lut, prefix_ids(kmers, p), axis=0)        # [B, 2]
    l, u = rows[:, 0], rows[:, 1]
    l, u = _scan_steps(index, rank_fn, kmers, lengths, l, u, K - p)
    return canonical_empty(l, u)


def backward_search_pair(
    index: DeviceIndex,
    kmers: jax.Array,     # int32 [B, K]; EVERY query must have length K
    lut: jax.Array | None = None,
    p: int = 0,
    early_exit: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """k-step backward search: one rank gather advances k characters.

    Uses the deepest k-mer-plane tier the index carries (``rank3_rows``/
    ``C3`` triples, then ``rank2_rows``/``C2`` pairs, then singles): for a
    k-mer ``s``, ``l' = Ck[s] + occk(s, l)`` lands exactly where k single
    steps would, dividing the dependent-gather chain — the hot path's
    latency bound — by k.  The k-step FM-index idea; the 4^k planes cost
    4^k/4 B/sym of device memory, so tier depth is capped by capacity
    (see ``builder.TRIPLE_TIER_MAX_N``).

    Restricted to uniform full-width batches (every query length == K,
    which is how the dispatcher pads batches anyway); the engine routes
    mixed-length batches to the masked 1-step path.

    Equivalence contract vs :func:`backward_search`: bit-identical — the
    k-step tiers land exactly where k single steps would, and empty
    intervals normalize to the canonical ``(0, 0)`` on every path.
    """
    B, K = kmers.shape
    if index.rank2_rows is None:
        raise ValueError("index was built without the pair-rank tier")

    def make_apply(table, starts):
        def apply(l, u, code):
            active = l < u
            occ2 = rank_ops.occ_rows(
                table,
                jnp.concatenate([code, code]),
                jnp.concatenate([l, u]),
                rows_per_symbol=index.rows_per_symbol,
                log2_block=index.log2_block,
                words_per_block=index.words_per_block,
            )
            base = jnp.take(starts, code)
            return (
                jnp.where(active, base + occ2[:B], l),
                jnp.where(active, base + occ2[B:], u),
            )

        return apply

    def run_steps(l, u, steps, apply):
        nsteps = steps.shape[0]
        if not nsteps:
            return l, u
        if early_exit:
            def cond(state):
                t, l, u = state
                return (t < nsteps) & jnp.any(l < u)

            def body(state):
                t, l, u = state
                code = jax.lax.dynamic_index_in_dim(steps, t, keepdims=False)
                l, u = apply(l, u, code)
                return t + 1, l, u

            _, l, u = jax.lax.while_loop(cond, body, (jnp.int32(0), l, u))
            return l, u

        def step(carry, code):
            return apply(*carry, code), None

        (l, u), _ = jax.lax.scan(step, (l, u), steps)
        return l, u

    if lut is not None and p:
        rows = jnp.take(lut, prefix_ids(kmers, p), axis=0)
        l, u = rows[:, 0], rows[:, 1]
        r = K - p
    else:
        c_last = kmers[:, K - 1]
        l = jnp.take(index.C, c_last)
        u = jnp.take(index.C, c_last + 1)
        r = K - 1

    # greedy schedule: 3-char steps while the tier exists, then one 2- or
    # 1-char step for the remainder (leftover columns sit at the LEFT —
    # the pattern's first characters — and run last)
    ntriples = r // 3 if index.rank3_rows is not None else 0
    rem = r - 3 * ntriples
    if ntriples:
        sub3 = kmers[:, rem:r]
        codes3 = (
            (sub3[:, 0::3] - 1) * 16
            + (sub3[:, 1::3] - 1) * 4
            + (sub3[:, 2::3] - 1)
        )
        l, u = run_steps(
            l, u, jnp.flip(codes3.T, axis=0), make_apply(index.rank3_rows, index.C3)
        )
    npairs = rem // 2
    if npairs:
        sub2 = kmers[:, rem % 2 : rem]
        codes2 = (sub2[:, 0::2] - 1) * 4 + (sub2[:, 1::2] - 1)
        l, u = run_steps(
            l, u, jnp.flip(codes2.T, axis=0), make_apply(index.rank2_rows, index.C2)
        )
    if rem % 2:
        single_col = kmers[:, 0]
        active = l < u
        occ2 = rank_ops.occ(
            index,
            jnp.concatenate([single_col, single_col]),
            jnp.concatenate([l, u]),
        )
        base = jnp.take(index.C, single_col)
        l = jnp.where(active, base + occ2[:B], l)
        u = jnp.where(active, base + occ2[B:], u)
    return canonical_empty(l, u)


def interval_counts(l: jax.Array, u: jax.Array) -> jax.Array:
    return (u - l).astype(jnp.int32)
