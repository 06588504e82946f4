"""Device search parity: jitted lockstep backward search == oracle intervals,
counts == naive counts, on random corpora (SURVEY.md §4.2 property tests)."""

import jax
import numpy as np
import pytest

from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.ops import (
    DeviceIndex,
    backward_search,
    encode_query_batch,
    occ,
)
from readserver_tpu.oracle import OracleFMIndex, naive_count


@pytest.fixture(scope="module")
def setup(tiny_corpus):
    fm = OracleFMIndex(tiny_corpus.reads)
    packed = build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)
    dev = DeviceIndex.from_packed(packed)
    return tiny_corpus, fm, dev


def test_occ_matches_oracle(setup, rng):
    _, fm, dev = setup
    B = 128
    cs = rng.integers(0, 5, size=B).astype(np.int32)
    iis = rng.integers(0, dev.n + 1, size=B).astype(np.int32)
    got = np.asarray(jax.jit(occ)(dev, cs, iis))
    want = np.array([fm.occ(int(c), int(i)) for c, i in zip(cs, iis)])
    assert np.array_equal(got, want)


def test_intervals_match_oracle(setup):
    corpus, fm, dev = setup
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, 64, k, seed=3, miss_frac=0.25)
    codes, lengths = encode_query_batch(kmers, k)
    l, u = jax.jit(backward_search)(dev, codes, lengths)
    l, u = np.asarray(l), np.asarray(u)
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        assert (l[b], u[b]) == (ol, ou), f"query {b}"


def test_counts_match_naive(setup):
    corpus, _, dev = setup
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, 64, k, seed=4, miss_frac=0.3)
    codes, lengths = encode_query_batch(kmers, k)
    l, u = jax.jit(backward_search)(dev, codes, lengths)
    counts = np.asarray(u) - np.asarray(l)
    for b, km in enumerate(kmers):
        assert counts[b] == naive_count(corpus.reads, km)


def test_variable_length_queries(setup):
    corpus, fm, dev = setup
    r = corpus.reads[0]
    kmers = [r[:3], r[:7], r[: corpus.spec.kmer_len]]
    codes, lengths = encode_query_batch(kmers, corpus.spec.kmer_len)
    l, u = jax.jit(backward_search)(dev, codes, lengths)
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        assert (int(l[b]), int(u[b])) == (ol, ou)


def test_absent_kmer_empty_interval(setup):
    corpus, _, dev = setup
    # a k-mer guaranteed absent: longer than reads can't be queried, so use
    # repeated probing of random k-mers verified absent by naive count
    rng = np.random.default_rng(0)
    k = corpus.spec.kmer_len
    absent = []
    while len(absent) < 5:
        km = rng.integers(1, 5, size=k).astype(np.uint8)
        if naive_count(corpus.reads, km) == 0:
            absent.append(km)
    codes, lengths = encode_query_batch(absent, k)
    l, u = jax.jit(backward_search)(dev, codes, lengths)
    assert np.all(np.asarray(u) - np.asarray(l) == 0)
    assert np.all(np.asarray(u) >= np.asarray(l))


def test_search_is_jit_stable(setup):
    corpus, _, dev = setup
    k = corpus.spec.kmer_len
    f = jax.jit(backward_search)
    kmers = sample_query_kmers(corpus, 16, k, seed=5)
    codes, lengths = encode_query_batch(kmers, k)
    l1, u1 = f(dev, codes, lengths)
    l2, u2 = f(dev, codes, lengths)
    assert np.array_equal(np.asarray(l1), np.asarray(l2))
    assert np.array_equal(np.asarray(u1), np.asarray(u2))


def test_occ_block_edges(setup):
    """Ranks at and around rank-block boundaries (where the checkpoint
    word takes over from the in-block popcount) and at both BWT ends."""
    _, fm, dev = setup
    S = dev.block_size
    probes = [0, 1, S - 1, S, S + 1, 2 * S - 1, 2 * S, dev.n - 1, dev.n]
    for c in range(5):
        cs = np.full(len(probes), c, dtype=np.int32)
        iis = np.array(probes, dtype=np.int32)
        got = np.asarray(jax.jit(occ)(dev, cs, iis))
        want = np.array([fm.occ(c, i) for i in probes])
        assert np.array_equal(got, want), c
