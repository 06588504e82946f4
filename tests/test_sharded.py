"""Sharded-path parity on the CPU-simulated 8-device mesh (SURVEY.md §4.4):
interval-sharded search + psum merge must equal the single-device engine and
the oracle exactly, across mesh shapes (dp, shard)."""

import jax
import numpy as np
import pytest

from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index.builder import build_index
from readserver_tpu.ops import DeviceIndex, backward_search, encode_query_batch
from readserver_tpu.oracle import OracleFMIndex
from readserver_tpu.parallel import (
    build_sharded,
    make_mesh,
    make_sharded_query_fn,
    place_sharded,
)

MAX_HITS = 32


@pytest.fixture(scope="module")
def packed(tiny_corpus):
    return build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)


@pytest.fixture(scope="module")
def fm(tiny_corpus):
    return OracleFMIndex(tiny_corpus.reads)


def _run(packed, corpus, dp, shards, num_queries=32, seed=21):
    mesh = make_mesh(data_parallel=dp, num_shards=shards)
    sidx = place_sharded(build_sharded(packed, shards), mesh)
    qfn = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS)
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, num_queries, k, seed=seed, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)
    out = qfn(sidx, None, codes, lengths)
    return kmers, {k2: np.asarray(v) for k2, v in out.items()}


@pytest.mark.parametrize("dp,shards", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_oracle(packed, fm, tiny_corpus, dp, shards):
    kmers, out = _run(packed, tiny_corpus, dp, shards)
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        assert (out["l"][b], out["u"][b]) == (ol, ou), f"query {b}"
        want = sorted(fm.resolve_row(r) for r in range(ol, ou))
        if len(want) > MAX_HITS:
            continue
        got = sorted(
            (int(r), int(o))
            for r, o, v in zip(out["read_id"][b], out["offset"][b], out["valid"][b])
            if v
        )
        assert got == want, f"query {b}"


def test_sharded_matches_single_device(packed, tiny_corpus):
    corpus = tiny_corpus
    dev = DeviceIndex.from_packed(packed)
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, 64, k, seed=22, miss_frac=0.25)
    codes, lengths = encode_query_batch(kmers, k)
    sl, su = jax.jit(backward_search)(dev, codes, lengths)

    mesh = make_mesh(data_parallel=2, num_shards=4)
    sidx = place_sharded(build_sharded(packed, 4), mesh)
    qfn = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS)
    out = qfn(sidx, None, codes, lengths)
    assert np.array_equal(np.asarray(out["l"]), np.asarray(sl))
    assert np.array_equal(np.asarray(out["u"]), np.asarray(su))


def test_sample_attribution_sharded(packed, fm, tiny_corpus):
    kmers, out = _run(packed, tiny_corpus, 2, 4, num_queries=16, seed=23)
    sample_of = tiny_corpus.sample_ids
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        if ou - ol > MAX_HITS:
            continue
        want = np.zeros(out["sample_hist"].shape[1], dtype=np.int64)
        for r in range(ol, ou):
            rid, _ = fm.resolve_row(r)
            want[sample_of[rid]] += 1
        assert np.array_equal(out["sample_hist"][b], want), f"query {b}"


def test_shard_boundaries_block_aligned(packed):
    sidx = build_sharded(packed, 8)
    starts = np.asarray(sidx.starts)
    assert np.all(starts % sidx.block_size == 0)
    lens = np.asarray(sidx.lens)
    assert lens.sum() == packed.n
    assert np.all(lens >= 0)


def test_sharded_lut_path(packed, fm, tiny_corpus):
    """LUT-accelerated sharded search == plain sharded search == oracle."""
    from readserver_tpu.parallel import build_prefix_lut_sharded

    corpus = tiny_corpus
    mesh = make_mesh(data_parallel=2, num_shards=4)
    sidx = place_sharded(build_sharded(packed, 4), mesh)
    p = 5
    lut = build_prefix_lut_sharded(sidx, mesh, p)
    qfn_lut = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS, lut_p=p)
    qfn = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS)
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, 32, k, seed=24, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)
    out_l = qfn_lut(sidx, lut, codes, lengths)
    out_p = qfn(sidx, None, codes, lengths)
    for key in ["l", "u", "count"]:
        assert np.array_equal(np.asarray(out_l[key]), np.asarray(out_p[key])), key
    for key in ["read_id", "offset", "valid"]:
        assert np.array_equal(np.asarray(out_l[key]), np.asarray(out_p[key])), key
    for b, km in enumerate(kmers):
        assert (int(out_l["l"][b]), int(out_l["u"][b])) == fm.backward_search(km)


def test_sharded_fast_resolve_used(packed):
    """Indexes built with fast_resolve shard the LF tier too."""
    sidx = build_sharded(packed, 8)
    assert sidx.has_fast_resolve
    assert np.asarray(sidx.slens).sum() == np.asarray(
        (np.asarray(packed.lf) < 0)
    ).sum()


def test_sharded_dsa_vs_lf_walk_parity(packed, tiny_corpus):
    """The one-psum dsa resolve equals the sampled-LF walk under sharding
    (same mesh, same queries, every output key)."""
    import dataclasses as dc

    mesh = make_mesh(data_parallel=2, num_shards=4)
    sidx = place_sharded(build_sharded(packed, 4), mesh)
    assert sidx.dsa_chunk is not None
    sidx_lf = dc.replace(sidx, dsa_chunk=None, dsa_bits=0)
    k = tiny_corpus.spec.kmer_len
    kmers = sample_query_kmers(tiny_corpus, 32, k, seed=63, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)
    f_dsa = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS)
    f_lf = make_sharded_query_fn(sidx_lf, mesh, max_hits=MAX_HITS)
    a = {k2: np.asarray(v) for k2, v in f_dsa(sidx, None, codes, lengths).items()}
    b = {k2: np.asarray(v) for k2, v in f_lf(sidx_lf, None, codes, lengths).items()}
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sharded_slow_walk_still_works(tiny_corpus, fm):
    """Artifacts without the fast tier fall back to the symbol walk."""
    packed_slow = build_index(
        tiny_corpus.reads,
        sample_ids=tiny_corpus.sample_ids,
        fast_resolve=False,
    )
    kmers, out = _run(packed_slow, tiny_corpus, 2, 4, num_queries=16, seed=25)
    for b, km in enumerate(kmers):
        ol, ou = fm.backward_search(km)
        want = sorted(fm.resolve_row(r) for r in range(ol, ou))
        if len(want) > MAX_HITS:
            continue
        got = sorted(
            (int(r), int(o))
            for r, o, v in zip(out["read_id"][b], out["offset"][b], out["valid"][b])
            if v
        )
        assert got == want


def test_dollar_chunks_cover_all_reads(packed):
    sidx = build_sharded(packed, 8)
    dlens = np.asarray(sidx.dlens)
    assert dlens.sum() == packed.num_reads
    # reassembled dollar map equals the global one
    got = np.concatenate(
        [np.asarray(sidx.dollar_chunk)[s, : dlens[s]] for s in range(8)]
    )
    assert np.array_equal(got, np.asarray(packed.dollar_map, dtype=np.int32))


def test_sharded_kstep_matches_onestep_and_oracle(packed, fm, tiny_corpus):
    """Pair/triple-plane sharded search == 1-step sharded == oracle,
    with and without the LUT, and with early exit — bit-identical
    (canonical (0,0) empties)."""
    from readserver_tpu.parallel import build_prefix_lut_sharded

    corpus = tiny_corpus
    assert packed.rank2_blocks is not None  # auto-built at tiny scale
    mesh = make_mesh(data_parallel=2, num_shards=4)
    sidx = place_sharded(build_sharded(packed, 4), mesh)
    assert sidx.rank2_rows is not None and sidx.rank3_rows is not None
    k = corpus.spec.kmer_len
    kmers = sample_query_kmers(corpus, 48, k, seed=31, miss_frac=0.3)
    codes, lengths = encode_query_batch(kmers, k)
    p = 4
    lut = build_prefix_lut_sharded(sidx, mesh, p)

    variants = {
        "k1": (make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS, kstep=1),
               None),
        "k3": (make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS), None),
        "k3_lut": (
            make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS, lut_p=p),
            lut,
        ),
        "k3_ee": (
            make_sharded_query_fn(
                sidx, mesh, max_hits=MAX_HITS, early_exit=True
            ),
            None,
        ),
        "k2": (
            make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS, kstep=2),
            None,
        ),
    }
    outs = {
        name: {k2: np.asarray(v) for k2, v in fn(sidx, lt, codes, lengths).items()}
        for name, (fn, lt) in variants.items()
    }
    ref = outs["k1"]
    for name, out in outs.items():
        for key in ["l", "u", "count", "read_id", "offset", "valid"]:
            assert np.array_equal(out[key], ref[key]), (name, key)
    for b, km in enumerate(kmers):
        assert (int(ref["l"][b]), int(ref["u"][b])) == fm.backward_search(km), b


def test_pinned_collective_budget():
    """The serving collective budget, pinned (BASELINE.json scaling metric
    / ROADMAP): 31-mer search with a p=6 LUT and the triple tier costs
    exactly 9 search psums per batch; the sampled walk costs
    sample_rate + 3 resolve psums.  A schedule regression fails here
    before it ever reaches a pod."""
    from readserver_tpu.parallel.stats import query_psum_estimate

    e = query_psum_estimate(
        31, lut_p=6, kstep=3, sample_rate=32, fast_resolve=True
    )
    assert e["search"] == 9
    assert e["resolve"] == 32 + 3
    assert e["total"] == 44
    # chr20-rung density (sample_rate 16, bench.SAMPLE_RATES): walk halves
    e16 = query_psum_estimate(
        31, lut_p=6, kstep=3, sample_rate=16, fast_resolve=True
    )
    assert e16["resolve"] == 19
    # 2-step tier (what chr20 actually keeps): 13 search psums
    e2 = query_psum_estimate(
        31, lut_p=6, kstep=2, sample_rate=16, fast_resolve=True
    )
    assert e2["search"] == 13
    # direct-resolve (dsa) tier: the walk's collective rounds vanish —
    # 2 resolve psums total (dsa gather + sample attribution)
    ed = query_psum_estimate(31, lut_p=6, kstep=3, direct_resolve=True)
    assert ed["resolve"] == 2 and ed["total"] == 11


def test_sharded_kstep_collective_accounting(packed, tiny_corpus):
    """HLO-level collective counts are parseable and the analytic per-batch
    psum estimate drops with tier depth (the point of porting the tiers)."""
    from readserver_tpu.parallel.stats import (
        collective_stats,
        query_psum_estimate,
    )

    corpus = tiny_corpus
    k = corpus.spec.kmer_len
    e1 = query_psum_estimate(k, kstep=1, sample_rate=packed.sample_rate,
                             fast_resolve=True)
    e3 = query_psum_estimate(k, kstep=3, sample_rate=packed.sample_rate,
                             fast_resolve=True)
    assert e3["search"] < e1["search"]
    assert e3["search"] <= -(-(k - 1) // 3) + 1

    mesh = make_mesh(data_parallel=2, num_shards=4)
    sidx = place_sharded(build_sharded(packed, 4), mesh)
    kmers = sample_query_kmers(corpus, 16, k, seed=33)
    codes, lengths = encode_query_batch(kmers, k)
    qfn = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS)
    stats = collective_stats(qfn, sidx, None, codes, lengths)
    assert stats["total"] > 0 and stats["all-reduce"] > 0
    assert stats["bytes_out"] > 0


@pytest.mark.parametrize("dp,shards", [(2, 4), (1, 8)])
def test_sharded_resolve_budget_and_walk_exit(packed, fm, tiny_corpus, dp, shards):
    """resolve_budget compaction + walk early-exit return bit-identical
    answers when the budget is not binding, and the compiled walk's psum
    volume shrinks (the 'collective-storming' fix)."""
    from readserver_tpu.parallel.stats import collective_stats

    mesh = make_mesh(data_parallel=dp, num_shards=shards)
    sidx = place_sharded(build_sharded(packed, shards), mesh)
    k = tiny_corpus.spec.kmer_len
    kmers = sample_query_kmers(tiny_corpus, 32, k, seed=77, miss_frac=0.2)
    codes, lengths = encode_query_batch(kmers, k)
    Bloc = 32 // dp

    base_fn = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS)
    # generous budget (= all lanes could fit): answers must be identical
    gen_fn = make_sharded_query_fn(
        sidx, mesh, max_hits=MAX_HITS,
        resolve_budget=Bloc * MAX_HITS - 1, walk_early_exit=True,
    )
    ref = {k2: np.asarray(v) for k2, v in base_fn(sidx, None, codes, lengths).items()}
    got = {k2: np.asarray(v) for k2, v in gen_fn(sidx, None, codes, lengths).items()}
    total_valid = int(ref["valid"].sum())
    assert total_valid < Bloc * MAX_HITS - 1  # budget not binding here
    for key in ["l", "u", "count", "read_id", "offset", "valid",
                "sample_hist", "hist_complete"]:
        assert np.array_equal(got[key], ref[key]), key

    # tight budget: dropped lanes surface as incomplete, never wrong
    tight = max(total_valid // (2 * dp), 1)
    tight_fn = make_sharded_query_fn(
        sidx, mesh, max_hits=MAX_HITS, resolve_budget=tight,
        walk_early_exit=True,
    )
    t = {k2: np.asarray(v) for k2, v in tight_fn(sidx, None, codes, lengths).items()}
    assert np.array_equal(t["l"], ref["l"]) and np.array_equal(t["u"], ref["u"])
    assert int(t["valid"].sum()) <= total_valid
    for b in range(len(kmers)):
        for r, o, v in zip(t["read_id"][b], t["offset"][b], t["valid"][b]):
            if v:  # every surviving hit is a true hit
                assert (int(r), int(o)) in {
                    fm.resolve_row(x) for x in range(ref["l"][b], ref["u"][b])
                }
        if t["hist_complete"][b]:
            assert np.array_equal(t["sample_hist"][b], ref["sample_hist"][b])

    # collective volume: the budgeted walk psums over fewer lanes
    sb = collective_stats(base_fn, sidx, None, codes, lengths)
    sg = collective_stats(
        make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS,
                              resolve_budget=max(Bloc * MAX_HITS // 4, 1)),
        sidx, None, codes, lengths,
    )
    assert sg["bytes_out"] < sb["bytes_out"]


@pytest.mark.parametrize("dp,shards", [(1, 8), (2, 4)])
def test_owner_routed_rank_parity(packed, fm, tiny_corpus, dp, shards):
    """Owner-routed search rank (per-shard compacted gathers) is
    bit-identical to the clamped-psum form — including when the capacity
    is far too small and the local multi-round while_loop must run."""
    from readserver_tpu.parallel.sharded import _query_body
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from readserver_tpu.parallel.sharded import sharding_specs

    mesh = make_mesh(data_parallel=dp, num_shards=shards)
    sidx = place_sharded(build_sharded(packed, shards), mesh)
    assert sidx.sym_totals is not None
    k = tiny_corpus.spec.kmer_len
    kmers = sample_query_kmers(tiny_corpus, 32, k, seed=91, miss_frac=0.25)
    codes, lengths = encode_query_batch(kmers, k)

    def run(**kw):
        fn = make_sharded_query_fn(sidx, mesh, max_hits=MAX_HITS, **kw)
        return {k2: np.asarray(v) for k2, v in fn(sidx, None, codes, lengths).items()}

    ref = run()
    routed = run(owner_route=True)
    for key in ref:
        assert np.array_equal(ref[key], routed[key]), key
    # 1-step variant exercises occ_g in the scan path
    ref1 = run(kstep=1)
    routed1 = run(kstep=1, owner_route=True)
    for key in ref1:
        assert np.array_equal(ref1[key], routed1[key]), key

    # multi-round: capacity 8 ≪ lanes one shard owns, so the local
    # while_loop MUST iterate — results still bit-identical to clamped
    import jax
    import jax.numpy as jnp
    from readserver_tpu.parallel.sharded import _ShardLocal

    rng = np.random.default_rng(5)
    X = 96
    cc = rng.integers(0, 5, size=X).astype(np.int32)
    ii = rng.integers(0, packed.n + 1, size=X).astype(np.int64)

    def both(sidx, c, i):
        loc = _ShardLocal(sidx)
        a = loc.occ_global(c, i)
        b = loc.occ_global_routed(
            loc.rank_rows, loc.sym_totals, sidx.rows_per_symbol, c, i, 8
        )
        return a, b

    a, b = jax.jit(
        jax.shard_map(
            both, mesh=mesh,
            in_specs=(sharding_specs(sidx), P(), P()),
            out_specs=(P(), P()),
        )
    )(sidx, jnp.asarray(cc), jnp.asarray(ii))
    assert np.array_equal(np.asarray(a), np.asarray(b))
    for b_, km in enumerate(kmers):
        assert (int(ref["l"][b_]), int(ref["u"][b_])) == fm.backward_search(km), b_
