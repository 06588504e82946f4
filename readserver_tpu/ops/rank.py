"""Vectorized occ/rank on the fused rank-block layout.

``occ(c, i)`` = # of symbol ``c`` in ``BWT[0:i]`` (exclusive).  One row
gather per rank: the row holds ``[checkpoint, plane words...]``, and the
in-block remainder is a masked popcount over the plane words — the batched
replacement for SGA's mark-lookup + run scan (SURVEY.md §3.2 "Occ: HOT
inner loop").  XLA lowers the row fetch to one gather; a hand-written
kernel has nothing to fuse inside one rank, and the scan's data
dependence stops fusion across steps.  Tested against
``index/packing.occ_scalar`` and the oracle FM-index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from readserver_tpu.ops.types import DeviceIndex

_U32 = jnp.uint32


def _inblock_count(rows: jax.Array, within: jax.Array, words_per_block: int) -> jax.Array:
    """rows uint32 [B, row_words], within int32 [B] → masked popcount [B] i32.

    Counts set bits among the first ``within`` positions of the block's
    bitplane (words at columns 1..W, LSB-first within each word).
    """
    words = rows[:, 1 : 1 + words_per_block]  # [B, W] uint32
    word_base = jnp.arange(words_per_block, dtype=jnp.int32) * 32
    bits = jnp.clip(within[:, None] - word_base[None, :], 0, 32)  # [B, W]
    # (1 << 32) is undefined for uint32 — build the full-word mask via where.
    partial = (_U32(1) << jnp.minimum(bits, 31).astype(_U32)) - _U32(1)
    mask = jnp.where(bits >= 32, _U32(0xFFFFFFFF), partial)
    pops = jax.lax.population_count(words & mask)
    return jnp.sum(pops, axis=1).astype(jnp.int32)


def occ_rows(
    rank_rows: jax.Array,
    c: jax.Array,
    i: jax.Array,
    *,
    rows_per_symbol: int,
    log2_block: int,
    words_per_block: int,
) -> jax.Array:
    """Batched rank against an explicit row table (shared with sharded path).

    c int32 [B] in 0..4, i int32 [B] in [0, n] → occ int32 [B].
    """
    block = i >> log2_block
    within = i - (block << log2_block)
    flat = c * rows_per_symbol + block
    rows = jnp.take(rank_rows, flat, axis=0, indices_are_sorted=False)
    base = rows[:, 0].astype(jnp.int32)  # per-shard counts < 2**31 by build
    return base + _inblock_count(rows, within, words_per_block)


def occ(index: DeviceIndex, c: jax.Array, i: jax.Array) -> jax.Array:
    """# of symbol ``c`` in ``BWT[0:i]``; both arguments int32 [B]."""
    return occ_rows(
        index.rank_rows,
        c,
        i,
        rows_per_symbol=index.rows_per_symbol,
        log2_block=index.log2_block,
        words_per_block=index.words_per_block,
    )


def bit_rank_and_test(
    table: jax.Array,
    i: jax.Array,
    *,
    log2_block: int,
    words_per_block: int,
) -> tuple[jax.Array, jax.Array]:
    """Single-bitvector rank + membership in ONE row gather.

    ``table`` is a ``pack_bit_rank`` layout (uint32 [NB+1, row_words]).
    Returns ``(rank int32 [B], bit bool [B])`` where ``rank`` counts set
    bits strictly before position ``i`` and ``bit`` is the bit AT ``i``.
    Used by the mark-walk resolve: the same gathered row answers both
    "is this row sampled?" and "which sampled slot is it?".
    """
    block = i >> log2_block
    within = i - (block << log2_block)
    rows = jnp.take(table, block, axis=0)
    base = rows[:, 0].astype(jnp.int32)
    rank = base + _inblock_count(rows, within, words_per_block)
    word = jnp.take_along_axis(
        rows, (1 + (within >> 5))[:, None], axis=1
    )[:, 0]
    bit = ((word >> (within & 31).astype(_U32)) & _U32(1)) != 0
    return rank, bit


def read_symbol(index: DeviceIndex, i: jax.Array) -> jax.Array:
    """BWT symbol code at positions ``i`` (int32 [B]) via the 4-bit pack."""
    word = jnp.take(index.sym4, i >> 3, axis=0)
    shift = ((i & 7) << 2).astype(_U32)
    return ((word >> shift) & _U32(0xF)).astype(jnp.int32)
