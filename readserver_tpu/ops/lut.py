"""Prefix LUT: intervals of every p-mer, built on device by level BFS.

``lut[id(w)] = [l, u)`` for all 4^p strings ``w`` of length p, where
``id(w) = Σ (w[t]-1)·4^(p-1-t)`` (first character most significant).

Built by extending level ℓ to ℓ+1 with the same backward-search update the
query path uses — so LUT-started searches are bit-exact with step-by-step
searches.  Prepending char c maps id(w) → (c-1)·4^ℓ + id(w), so level ℓ+1
is four c-blocks of the extended level-ℓ table, in c order.  Total cost
≈ 2.7·4^p ranks, a few seconds on device at p=12.

It makes the first p of k scan steps disappear: one device table
(4^p·8 bytes) replaces p·2·B row gathers per batch — the dominant cost of
the whole engine (SURVEY.md §3.2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from readserver_tpu.ops import rank as rank_ops
from readserver_tpu.ops.types import DeviceIndex


@partial(jax.jit, static_argnames=("level_size",))
def _extend_level(index: DeviceIndex, l, u, level_size: int):
    """[S] intervals of level ℓ → [4S] intervals of level ℓ+1 (c-major).

    Already-empty intervals are frozen rather than re-extended so LUT
    entries are bit-identical to what the step-by-step search (whose
    ``active`` mask stops updating on emptiness) would produce."""
    cc = jnp.repeat(jnp.arange(1, 5, dtype=jnp.int32), level_size)  # [4S]
    l4 = jnp.tile(l, 4)
    u4 = jnp.tile(u, 4)
    occ2 = rank_ops.occ(
        index, jnp.concatenate([cc, cc]), jnp.concatenate([l4, u4])
    )
    base = jnp.take(index.C, cc)
    alive = l4 < u4
    nl = jnp.where(alive, base + occ2[: 4 * level_size], l4)
    nu = jnp.where(alive, base + occ2[4 * level_size :], u4)
    return nl, nu


def build_prefix_lut(
    index: DeviceIndex, p: int, max_chunk: int = 1 << 22
) -> jax.Array:
    """→ int32 [4^p, 2] on device.

    Levels above ``max_chunk`` entries extend in chunks: one whole-level
    ``_extend_level`` materializes ~5 gather temporaries of 8·4S·row
    bytes, which RESOURCE_EXHAUSTs at p=13 (S=16.7M) next to a
    chr20-sized tier set.  Chunking is exact — each entry's extension
    depends only on that entry — but must slice PER PREPEND-CHAR c
    (output is c-major: chunk boundaries inside a c-block would
    interleave), so each level-ℓ chunk [a:b) produces four output
    slices k·4^ℓ + [a:b), k = c-1."""
    if not (1 <= p <= 15):
        raise ValueError("prefix LUT order must be in [1, 15]")
    if max_chunk < 1:
        raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
    l = index.C[1:5]
    u = index.C[2:6]
    size = 4
    for _ in range(p - 1):
        if size <= max_chunk:
            l, u = _extend_level(index, l, u, size)
        else:
            parts = [[] for _ in range(8)]  # 4 c-blocks × (l, u)
            for a in range(0, size, max_chunk):
                b = min(a + max_chunk, size)
                cl, cu = _extend_level(index, l[a:b], u[a:b], b - a)
                for k in range(4):
                    parts[2 * k].append(cl[k * (b - a) : (k + 1) * (b - a)])
                    parts[2 * k + 1].append(
                        cu[k * (b - a) : (k + 1) * (b - a)]
                    )
            l = jnp.concatenate([c for k in range(4) for c in parts[2 * k]])
            u = jnp.concatenate(
                [c for k in range(4) for c in parts[2 * k + 1]]
            )
        size *= 4
    from readserver_tpu.ops.search import canonical_empty

    l, u = canonical_empty(l, u)  # absent p-mers: (0, 0), like every path
    return jnp.stack([l, u], axis=1)


def default_lut_order(n: int, max_order: int = 12) -> int:
    """Pick p so the LUT is populated but not wasteful: ~log4(n) - 1,
    clamped to [4, max_order].  The cap keeps the table small (p=12 is
    4^12·8 B = 134 MB; each further order is 4x that) while removing the
    first 12 rank steps of every query."""
    if n <= 0:
        return 4
    logn = int(np.log2(max(n, 2)) / 2)
    return int(np.clip(logn - 1, 4, max_order))
