"""Prefix-LUT parity: LUT-started searches must be bit-exact with plain
step-by-step searches and with the oracle (SURVEY.md §4.2)."""

import jax
import numpy as np
import pytest

from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.ops import (
    DeviceIndex,
    backward_search,
    backward_search_lut,
    build_prefix_lut,
    default_lut_order,
    encode_query_batch,
)
from readserver_tpu.oracle import OracleFMIndex


@pytest.fixture(scope="module")
def setup(tiny_corpus):
    fm = OracleFMIndex(tiny_corpus.reads)
    packed = build_index(tiny_corpus.reads)
    dev = DeviceIndex.from_packed(packed)
    return tiny_corpus, fm, dev


@pytest.mark.parametrize("p", [1, 2, 4, 6])
def test_lut_entries_match_oracle(setup, p):
    _, fm, dev = setup
    lut = np.asarray(build_prefix_lut(dev, p))
    # spot-check a spread of p-mers (all 4^p at small p)
    ids = range(4**p) if p <= 4 else range(0, 4**p, 97)
    for pid in ids:
        # decode id → p-mer (first char most significant)
        codes = []
        x = pid
        for t in range(p):
            codes.append((x // 4 ** (p - 1 - t)) % 4 + 1)
            x %= 4 ** (p - 1 - t)
        l, u = fm.backward_search(np.asarray(codes, dtype=np.uint8))
        assert (lut[pid, 0], lut[pid, 1]) == (l, u), pid


def test_lut_search_equals_plain(setup):
    corpus, _, dev = setup
    k = corpus.spec.kmer_len
    p = 5
    lut = build_prefix_lut(dev, p)
    kmers = sample_query_kmers(corpus, 64, k, seed=41, miss_frac=0.3)
    codes, lengths = encode_query_batch(kmers, k)
    l1, u1 = jax.jit(backward_search)(dev, codes, lengths)
    f = jax.jit(lambda d, c, ln: backward_search_lut(d, lut, p, c, ln))
    l2, u2 = f(dev, codes, lengths)
    assert np.array_equal(np.asarray(l1), np.asarray(l2))
    assert np.array_equal(np.asarray(u1), np.asarray(u2))


def test_lut_search_matches_oracle(setup):
    corpus, fm, dev = setup
    k = corpus.spec.kmer_len
    p = default_lut_order(dev.n)
    assert p <= k
    lut = build_prefix_lut(dev, p)
    kmers = sample_query_kmers(corpus, 48, k, seed=42, miss_frac=0.25)
    codes, lengths = encode_query_batch(kmers, k)
    f = jax.jit(lambda d, c, ln: backward_search_lut(d, lut, p, c, ln))
    l, u = f(dev, codes, lengths)
    for b, km in enumerate(kmers):
        assert (int(l[b]), int(u[b])) == fm.backward_search(km), b


def test_lut_deep_order_empty_intervals(setup):
    """Regression: at deeper p many p-mers are absent; their LUT entries
    must carry the same frozen-at-death bounds the stepwise search yields
    (caught by the bench parity self-check at p=7 on lambda-scale)."""
    corpus, _, dev = setup
    k = corpus.spec.kmer_len
    for p in [7, 8]:
        if p > k:
            continue
        lut = build_prefix_lut(dev, p)
        rng = np.random.default_rng(p)
        kmers = [rng.integers(1, 5, size=k).astype(np.uint8) for _ in range(64)]
        codes, lengths = encode_query_batch(kmers, k)
        l1, u1 = jax.jit(backward_search)(dev, codes, lengths)
        f = jax.jit(lambda d, c, ln, lut=lut, p=p: backward_search_lut(d, lut, p, c, ln))
        l2, u2 = f(dev, codes, lengths)
        assert np.array_equal(np.asarray(l1), np.asarray(l2)), p
        assert np.array_equal(np.asarray(u1), np.asarray(u2)), p


def test_lut_with_exact_p_length_queries(setup):
    corpus, fm, dev = setup
    p = 6
    lut = build_prefix_lut(dev, p)
    kmers = [r[:p] for r in corpus.reads[:16]]
    codes, lengths = encode_query_batch(kmers, corpus.spec.kmer_len)
    f = jax.jit(lambda d, c, ln: backward_search_lut(d, lut, p, c, ln))
    l, u = f(dev, codes, lengths)
    for b, km in enumerate(kmers):
        assert (int(l[b]), int(u[b])) == fm.backward_search(km), b


def test_lut_chunked_build_bit_identical(setup):
    """Chunked level extension (RESOURCE_EXHAUSTED guard for p>=13 next
    to a chr20-sized tier set) must be bit-identical to the whole-level
    build, including ragged last chunks and c-major output order."""
    _, _, dev = setup
    for p in [5, 8]:
        ref = np.asarray(build_prefix_lut(dev, p))
        for chunk in [64, 100, 1 << 10]:
            got = np.asarray(build_prefix_lut(dev, p, max_chunk=chunk))
            assert np.array_equal(ref, got), (p, chunk)


@pytest.mark.parametrize("chunk", [0, -4])
def test_lut_rejects_nonpositive_chunk(setup, chunk):
    _, _, dev = setup
    with pytest.raises(ValueError, match="max_chunk"):
        build_prefix_lut(dev, 4, max_chunk=chunk)
