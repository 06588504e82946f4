"""Naive substring-count oracle — the reference's demo-test idiom.

The reference validates its demo index by diffing served counts against a
naive scan of the raw reads (SURVEY.md §3.5, §4 "oracle-diff integration
tests"). Same here: counts are overlapping occurrences within each read
(never across read boundaries — each read is its own string).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from readserver_tpu import alphabet


def _as_codes(x: np.ndarray | str | bytes) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else alphabet.encode(x)


def _occurrences_in(read: np.ndarray, pat: np.ndarray) -> list[int]:
    k = len(pat)
    if k == 0 or k > len(read):
        return []
    # windowed comparison; overlapping matches count
    windows = np.lib.stride_tricks.sliding_window_view(read, k)
    return np.flatnonzero((windows == pat).all(axis=1)).tolist()


def naive_count(reads: Sequence[np.ndarray | str | bytes], kmer) -> int:
    pat = _as_codes(kmer)
    return sum(len(_occurrences_in(_as_codes(r), pat)) for r in reads)


def naive_count_matrix(reads_matrix: np.ndarray, kmer) -> int:
    """Vectorized overlapping-occurrence count over an equal-length read
    matrix [m, L] — the bench-scale parity spot-check (millions of reads)."""
    pat = _as_codes(kmer)
    k = len(pat)
    m, L = reads_matrix.shape
    if k > L:
        return 0
    total = 0
    for off in range(L - k + 1):
        total += int((reads_matrix[:, off : off + k] == pat).all(axis=1).sum())
    return total


def encode_windows_2bit(reads_matrix: np.ndarray, k: int) -> np.ndarray:
    """All length-``k`` windows of an equal-length read matrix, 2-bit packed
    into uint64 (exact — not a hash: 2 bits/base × k ≤ 31 = 62 bits).

    Returns uint64 [m, L-k+1]; window ``(r, o)`` encodes
    ``Σ_j (mat[r, o+j] - 1) << 2j``.  Codes must be bases 1..4.
    """
    if k > 31:
        raise ValueError("2-bit packing supports k <= 31")
    m, L = reads_matrix.shape
    nw = L - k + 1
    if nw <= 0:
        return np.zeros((m, 0), dtype=np.uint64)
    # rolling encode, one column per step: window o+1 is window o shifted
    # down one base with base o+k entering at the top
    cols = (reads_matrix.T.astype(np.uint64) - np.uint64(1))  # [L, m]
    out = np.empty((nw, m), dtype=np.uint64)
    cur = np.zeros(m, dtype=np.uint64)
    for j in range(k):
        cur |= cols[j] << np.uint64(2 * j)
    out[0] = cur
    top = np.uint64(2 * (k - 1))
    for o in range(1, nw):
        cur = (cur >> np.uint64(2)) | (cols[o + k - 1] << top)
        out[o] = cur
    return out.T


# reads per chunk in window_multiset_counts: bounds its window buffer to
# ~40 MB at 100 bp reads
_CHUNK_ROWS = 1 << 16


def window_multiset_counts(
    reads_matrix: np.ndarray, queries: np.ndarray
) -> np.ndarray:
    """Exact occurrence counts for many query k-mers at once.

    Sorts the (few) 2-bit-packed queries, then streams the read windows
    in chunks of reads: each window is looked up in the
    sorted queries by binary search and tallied on a match — the
    bench-scale widening of the oracle-diff idiom (SURVEY.md §4).  One
    pass over the reads, no sort of the windows, memory bounded by the
    chunk.

    ``queries``: uint8 [Q, k] base codes.  Returns int64 [Q].
    """
    q = np.asarray(queries)
    k = q.shape[1]
    enc = np.zeros(q.shape[0], dtype=np.uint64)
    for j in range(k):
        enc |= (q[:, j].astype(np.uint64) - 1) << np.uint64(2 * j)
    uq, inv = np.unique(enc, return_inverse=True)
    counts = np.zeros(len(uq), dtype=np.int64)
    if not len(uq):
        return counts
    for a in range(0, reads_matrix.shape[0], _CHUNK_ROWS):
        win = encode_windows_2bit(reads_matrix[a : a + _CHUNK_ROWS], k).ravel()
        pos = np.searchsorted(uq, win)
        np.minimum(pos, len(uq) - 1, out=pos)
        hit = uq[pos] == win
        counts += np.bincount(pos[hit], minlength=len(uq))
    return counts[inv.ravel()]


def naive_find_reads(
    reads: Sequence[np.ndarray | str | bytes], kmer
) -> list[tuple[int, int]]:
    """All ``(read_id, offset)`` hits, sorted — one entry per occurrence."""
    pat = _as_codes(kmer)
    hits: list[tuple[int, int]] = []
    for i, r in enumerate(reads):
        for off in _occurrences_in(_as_codes(r), pat):
            hits.append((i, off))
    return sorted(hits)
