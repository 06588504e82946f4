"""Out-of-core cohort build (index/cohort.py): partitioning, shard-wise
build + manifest, resume after interruption, streaming source, and serving
parity against a monolithic build."""

import json

import numpy as np
import pytest

from readserver_tpu import alphabet
from readserver_tpu.config import ServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import artifact, build_index
from readserver_tpu.index.cohort import (
    COHORT_MANIFEST,
    build_cohort,
    build_cohort_stream,
    is_cohort,
    load_cohort,
    partition_spans,
)
from readserver_tpu.oracle import OracleFMIndex
from readserver_tpu.parallel import make_mesh
from readserver_tpu.serve import QueryEngine


def test_partition_spans_cover_and_balance():
    lengths = [100] * 50 + [10] * 500  # skewed
    spans = partition_spans(lengths, 4)
    assert spans[0][0] == 0 and spans[-1][1] == len(lengths)
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c and a < b
    totals = [sum(lengths[a:b]) for a, b in spans]
    assert max(totals) <= 2 * min(totals)  # bases roughly balanced
    # degenerate: as many shards as reads
    assert partition_spans([5, 5, 5], 3) == [(0, 1), (1, 2), (2, 3)]
    with pytest.raises(ValueError):
        partition_spans([5, 5], 3)


@pytest.fixture(scope="module")
def cohort_setup(tiny_corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("cohort")
    path = build_cohort(
        tiny_corpus.reads, tiny_corpus.sample_ids, 4, out / "pop"
    )
    return tiny_corpus, path


def test_cohort_build_and_serve_parity(cohort_setup):
    corpus, path = cohort_setup
    assert is_cohort(path)
    parts, manifest = load_cohort(path)
    assert manifest["num_shards"] == 4
    assert sum(p.num_reads for p in parts) == len(corpus.reads)
    assert all(p.num_samples == manifest["num_samples"] for p in parts)

    import jax

    mesh = make_mesh(data_parallel=1, num_shards=4, devices=jax.devices()[:4])
    eng = QueryEngine(parts, ServeConfig(batch_size=32, max_hits=64), mesh=mesh)
    mono = QueryEngine(
        build_index(corpus.reads, sample_ids=corpus.sample_ids),
        ServeConfig(batch_size=32, max_hits=64),
    )
    fm = OracleFMIndex(corpus.reads)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 12, corpus.spec.kmer_len, seed=91, miss_frac=0.25
        )
    ]
    for rc, rm in zip(eng.query_batch(kmers), mono.query_batch(kmers)):
        assert rc.count == rm.count == fm.count(rc.kmer)
        if not (rc.hits_truncated or rm.hits_truncated):
            key = lambda h: (h["read_id"], h["offset"])
            assert sorted(map(key, rc.hits)) == sorted(map(key, rm.hits))
            assert rc.sample_hist == rm.sample_hist


def test_cohort_resume_skips_complete_shards(tiny_corpus, tmp_path):
    out = tmp_path / "pop"
    build_cohort(tiny_corpus.reads, tiny_corpus.sample_ids, 3, out)
    # simulate interruption: shard 1 incomplete, manifest missing
    (out / COHORT_MANIFEST).unlink()
    (out / "shard_0001" / "manifest.json").unlink()
    mtime0 = (out / "shard_0000" / "manifest.json").stat().st_mtime_ns

    build_cohort(tiny_corpus.reads, tiny_corpus.sample_ids, 3, out)
    assert is_cohort(out)
    # untouched shard not rebuilt; broken shard rebuilt
    assert (out / "shard_0000" / "manifest.json").stat().st_mtime_ns == mtime0
    parts, _ = load_cohort(out)
    assert sum(p.num_reads for p in parts) == len(tiny_corpus.reads)


def _stream(corpus, fail_after=None):
    for i, r in enumerate(corpus.reads):
        if fail_after is not None and i == fail_after:
            raise RuntimeError("simulated crash")
        yield r, int(corpus.sample_ids[i])


def test_cohort_stream_resume_after_crash(tiny_corpus, tmp_path):
    num_samples = int(np.max(tiny_corpus.sample_ids)) + 1
    budget = sum(len(r) for r in tiny_corpus.reads) // 5

    done = tmp_path / "full"
    build_cohort_stream(
        _stream(tiny_corpus), done, budget, num_samples
    )

    crashed = tmp_path / "crashed"
    with pytest.raises(RuntimeError):
        build_cohort_stream(
            _stream(tiny_corpus, fail_after=len(tiny_corpus.reads) // 2),
            crashed,
            budget,
            num_samples,
        )
    assert not is_cohort(crashed)  # no manifest yet → incomplete
    # resume with the full stream: skips consumed prefix, finishes
    build_cohort_stream(_stream(tiny_corpus), crashed, budget, num_samples)
    assert is_cohort(crashed)

    a, ma = load_cohort(done)
    b, mb = load_cohort(crashed)
    assert ma["num_reads"] == mb["num_reads"] == len(tiny_corpus.reads)
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert pa.num_reads == pb.num_reads
        assert np.array_equal(pa.sym4, pb.sym4)
        assert np.array_equal(pa.dollar_map, pb.dollar_map)


def test_multi_engine_matches_monolithic(cohort_setup):
    from readserver_tpu.serve import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    multi = MultiEngine(parts, ServeConfig(batch_size=32, max_hits=64))
    mono = QueryEngine(
        build_index(corpus.reads, sample_ids=corpus.sample_ids),
        ServeConfig(batch_size=32, max_hits=64),
    )
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 10, corpus.spec.kmer_len, seed=92, miss_frac=0.25
        )
    ]
    for rm, rx in zip(mono.query_batch(kmers), multi.query_batch(kmers)):
        assert rm.count == rx.count
        if not (rm.hits_truncated or rx.hits_truncated):
            key = lambda h: (h["read_id"], h["offset"])
            assert sorted(map(key, rm.hits)) == sorted(map(key, rx.hits))
            assert (rm.sample_hist or {}) == (rx.sample_hist or {})
    for rm, rx in zip(
        mono.count_batch(kmers, both_strands=True),
        multi.count_batch(kmers, both_strands=True),
    ):
        assert rm.count == rx.count
    # global read ids resolve through the multi-engine cold store
    rid = next(h["read_id"] for r in multi.query_batch(kmers) for h in r.hits)
    assert multi.read_sequence(rid) == alphabet.decode(corpus.reads[rid])


def test_cli_doc_shards_build_and_query(tiny_corpus, tmp_path, capsys):
    from readserver_tpu.cli import main
    from readserver_tpu.corpus import io as cio
    from readserver_tpu.oracle import naive_count

    fa = tmp_path / "r.fa"
    cio.write_fasta(
        fa,
        (
            (f"read_{i}", alphabet.decode(r))
            for i, r in enumerate(tiny_corpus.reads[:200])
        ),
    )
    out = str(tmp_path / "pop")
    assert main(
        ["build", "--fasta", str(fa), "--out", out, "--doc-shards", "3"]
    ) == 0
    assert is_cohort(out)
    km = alphabet.decode(tiny_corpus.reads[0][:20])
    capsys.readouterr()
    assert main(["query", "--index", out, "--kmer", km]) == 0
    body = json.loads(capsys.readouterr().out.strip())
    assert body["count"] == naive_count(tiny_corpus.reads[:200], km)


def test_append_to_cohort_matches_rebuild(tiny_corpus, tmp_path):
    """Streaming ingest (append_to_cohort): appended reads are queryable
    with answers identical to a monolithic from-scratch rebuild — counts
    sum, read ids continue the global space, histograms pick up the new
    sample name."""
    from readserver_tpu.index.cohort import append_to_cohort
    from readserver_tpu.serve import MultiEngine

    base_reads = tiny_corpus.reads[:300]
    base_sids = np.asarray(tiny_corpus.sample_ids[:300])
    extra = tiny_corpus.reads[300:400]
    old_ns = int(base_sids.max()) + 1

    path = build_cohort(base_reads, base_sids, 2, tmp_path / "pop")
    append_to_cohort(path, extra, sample_names=["donor_x"])

    parts, manifest = load_cohort(path)
    assert manifest["num_shards"] == 3
    assert manifest["num_reads"] == 400
    assert manifest["num_samples"] == old_ns + 1
    assert manifest["sample_names"][-1] == "donor_x"

    cfg = ServeConfig(batch_size=16, max_hits=64)
    multi = MultiEngine(parts, cfg)
    combined_sids = np.concatenate(
        [base_sids, np.full(len(extra), old_ns, dtype=np.int32)]
    )
    mono = QueryEngine(
        build_index(
            tiny_corpus.reads[:400],
            sample_ids=combined_sids,
            sample_names=manifest["sample_names"],
        ),
        cfg,
    )
    corpus = tiny_corpus
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 8, corpus.spec.kmer_len, seed=17, miss_frac=0.25
        )
    ]
    # include k-mers drawn from the APPENDED reads specifically
    k = corpus.spec.kmer_len
    kmers += [alphabet.decode(extra[i][:k]) for i in (0, 50, 99)]
    for rm, rx in zip(mono.query_batch(kmers), multi.query_batch(kmers)):
        assert rm.count == rx.count
        if not (rm.hits_truncated or rx.hits_truncated):
            key = lambda h: (h["read_id"], h["offset"])
            assert sorted(map(key, rm.hits)) == sorted(map(key, rx.hits))
            assert (rm.sample_hist or {}) == (rx.sample_hist or {})
    # appended reads live at global ids past the original cohort
    assert multi.read_sequence(399) == alphabet.decode(corpus.reads[399])
    # a k-mer unique to the appended batch attributes to the new sample
    hist = multi.query_batch([kmers[-1]])[0].sample_hist
    assert hist and hist.get("donor_x", 0) >= 1


def test_cli_append(tiny_corpus, tmp_path, capsys):
    from readserver_tpu.cli import main
    from readserver_tpu.corpus import io as cio
    from readserver_tpu.oracle import naive_count

    fa = tmp_path / "base.fa"
    cio.write_fasta(
        fa,
        (
            (f"read_{i}", alphabet.decode(r))
            for i, r in enumerate(tiny_corpus.reads[:150])
        ),
    )
    out = str(tmp_path / "pop")
    assert main(
        ["build", "--fasta", str(fa), "--out", out, "--doc-shards", "2"]
    ) == 0
    fa2 = tmp_path / "extra.fa"
    cio.write_fasta(
        fa2,
        (
            (f"x_{i}", alphabet.decode(r))
            for i, r in enumerate(tiny_corpus.reads[150:200])
        ),
    )
    assert main(
        ["append", out, "--fasta", str(fa2), "--sample", "late_donor"]
    ) == 0
    km = alphabet.decode(tiny_corpus.reads[180][:20])
    capsys.readouterr()
    assert main(["query", "--index", out, "--kmer", km]) == 0
    body = json.loads(capsys.readouterr().out.strip())
    assert body["count"] == naive_count(tiny_corpus.reads[:200], km)


def test_compact_cohort_preserves_answers(tiny_corpus, tmp_path):
    """append → compact: interleave-merging shards in the SHARED global
    sample space keeps counts, global read ids, and per-sample histograms
    bit-identical (the shared_samples merge must NOT offset sample ids)."""
    from readserver_tpu.index.cohort import append_to_cohort, compact_cohort
    from readserver_tpu.serve import MultiEngine

    base_sids = np.asarray(tiny_corpus.sample_ids[:200])
    path = build_cohort(
        tiny_corpus.reads[:200], base_sids, 2, tmp_path / "pop"
    )
    append_to_cohort(
        path, tiny_corpus.reads[200:260], sample_names=["donor_y"]
    )
    cfg = ServeConfig(batch_size=16, max_hits=64)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            tiny_corpus, 8, tiny_corpus.spec.kmer_len, seed=23,
            miss_frac=0.25,
        )
    ]
    kmers.append(
        alphabet.decode(tiny_corpus.reads[230][: tiny_corpus.spec.kmer_len])
    )
    parts, _ = load_cohort(path)
    before = MultiEngine(parts, cfg).query_batch(kmers)

    compact_cohort(path, target_shards=1)
    parts2, manifest = load_cohort(path)
    assert manifest["num_shards"] == 1
    assert manifest["sample_names"][-1] == "donor_y"
    # old shard dirs are gone; the single compacted shard holds everything
    assert parts2[0].num_reads == 260
    after = MultiEngine(parts2, cfg).query_batch(kmers)
    key = lambda h: (h["read_id"], h["offset"])
    for rb, ra in zip(before, after):
        assert rb.count == ra.count
        if not (rb.hits_truncated or ra.hits_truncated):
            assert sorted(map(key, rb.hits)) == sorted(map(key, ra.hits))
            assert (rb.sample_hist or {}) == (ra.sample_hist or {})


def test_append_inherits_build_config(tiny_corpus, tmp_path):
    """Append with config=None must recover the
    cohort's ACTUAL build-time layout (IndexConfig + sample_rate + tier
    set) from shard 0's manifest, not silently rebuild with defaults —
    doc-sharded serving applies shard 0's parameters to every shard."""
    from readserver_tpu.config import IndexConfig
    from readserver_tpu.index.cohort import append_to_cohort

    cfg = IndexConfig(block_size=32, row_words=4, max_query_len=24)
    path = build_cohort(
        tiny_corpus.reads[:100],
        np.asarray(tiny_corpus.sample_ids[:100]),
        2,
        tmp_path / "pop",
        config=cfg,
        sample_rate=8,
        kstep=2,
    )
    append_to_cohort(path, tiny_corpus.reads[100:140])
    parts, manifest = load_cohort(path)
    assert manifest["config"]["block_size"] == 32
    ref = json.loads(
        (path / manifest["shards"][0] / "manifest.json").read_text()
    )
    new = json.loads(
        (path / manifest["shards"][-1] / "manifest.json").read_text()
    )
    assert new["config"] == ref["config"]
    assert new["sample_rate"] == ref["sample_rate"] == 8
    assert ("rank2_blocks" in new["arrays"]) == (
        "rank2_blocks" in ref["arrays"]
    )
    assert ("rank3_blocks" in new["arrays"]) == (
        "rank3_blocks" in ref["arrays"]
    )
    # an explicitly mismatched config is rejected, not silently mixed in
    with pytest.raises(ValueError, match="config mismatch"):
        append_to_cohort(
            path, tiny_corpus.reads[140:150], config=IndexConfig()
        )


def test_cli_append_rejects_plain_artifact(tiny_corpus, tmp_path, capsys):
    from readserver_tpu.cli import main

    out = tmp_path / "plain"
    artifact.save_artifact(build_index(tiny_corpus.reads[:40]), out)
    rc = main(["append", str(out), "--config", "tiny"])
    assert rc == 2
    assert "cohort" in capsys.readouterr().err


def test_compact_keeps_singletons_and_rewrites_progress(
    tiny_corpus, tmp_path
):
    """Singleton groups keep their shard dir in place (no
    byte-identical re-save), and progress.jsonl is rewritten to the new
    shard list so a later resumed streaming build can't clobber the
    compacted cohort."""
    from readserver_tpu.index.cohort import (
        PROGRESS_LOG,
        build_cohort_stream,
        compact_cohort,
    )

    reads = tiny_corpus.reads[:120]
    path = build_cohort_stream(
        ((r, 0) for r in reads),
        tmp_path / "pop",
        max_bases_per_shard=sum(len(r) for r in reads[:40]),
        num_samples=1,
    )
    parts, manifest = load_cohort(path)
    assert manifest["num_shards"] >= 3
    old_dirs = list(manifest["shards"])
    mtimes = {
        d: (path / d / "manifest.json").stat().st_mtime_ns for d in old_dirs
    }

    # compacting 3+ shards into 2 groups leaves at least one singleton
    compact_cohort(path, target_shards=2)
    parts2, manifest2 = load_cohort(path)
    assert manifest2["num_shards"] == 2
    kept = [d for d in manifest2["shards"] if d in old_dirs]
    assert kept, "singleton group must keep its shard dir in place"
    for d in kept:  # kept dirs were not re-saved
        assert (path / d / "manifest.json").stat().st_mtime_ns == mtimes[d]
    # progress log matches the new shard list, cumulative reads intact
    entries = [
        json.loads(l)
        for l in (path / PROGRESS_LOG).read_text().splitlines()
    ]
    assert [e["shard"] for e in entries] == list(manifest2["shards"])
    assert entries[-1]["reads_consumed"] == 120
    # a resumed stream now skips everything instead of restarting at 0
    build_cohort_stream(
        ((r, 0) for r in reads),
        path,
        max_bases_per_shard=10**9,
        num_samples=1,
    )
    _, manifest3 = load_cohort(path)
    assert manifest3["num_shards"] == 2
    assert manifest3["num_reads"] == 120


def test_multi_engine_compact_overflow_fallback(cohort_setup, monkeypatch):
    """The sparse transfer compaction must fall back to the dense device
    buffers when a batch's hits/histogram entries exceed the budget —
    answers identical either way."""
    from readserver_tpu.serve.engine import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    cfg = ServeConfig(batch_size=16, max_hits=64)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 12, corpus.spec.kmer_len, seed=31, miss_frac=0.2
        )
    ]
    ref = MultiEngine(parts, cfg).query_batch(kmers)
    assert any(r.hits for r in ref)
    monkeypatch.setattr(MultiEngine, "COMPACT_PER_QUERY", 1)
    tiny = MultiEngine(parts, cfg)
    got = tiny.query_batch(kmers)
    key = lambda h: (h["read_id"], h["offset"], h["sample_id"])
    for a, b in zip(ref, got):
        assert a.count == b.count
        assert sorted(map(key, a.hits)) == sorted(map(key, b.hits))
        assert (a.sample_hist or {}) == (b.sample_hist or {})
        assert a.sample_hist_complete == b.sample_hist_complete


def test_hist_only_mode_matches_full(cohort_setup):
    """query_batch(include_hits=False) — the /samples wire tier — must
    return the same counts/histograms/complete flags as the full path,
    for both the single engine and the multi-partition front."""
    from readserver_tpu.serve import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    cfg = ServeConfig(batch_size=16, max_hits=64)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 10, corpus.spec.kmer_len, seed=55, miss_frac=0.25
        )
    ]
    for eng in (
        QueryEngine(build_index(corpus.reads, sample_ids=corpus.sample_ids),
                    cfg),
        MultiEngine(parts, cfg),
    ):
        full = eng.query_batch(kmers)
        hist = eng.query_batch(kmers, include_hits=False)
        assert any(r.sample_hist for r in full)
        for a, b in zip(full, hist):
            assert a.count == b.count
            assert (a.sample_hist or {}) == (b.sample_hist or {})
            assert a.sample_hist_complete == b.sample_hist_complete
            assert b.hits == []


def test_single_engine_compact_overflow_fallback(tiny_corpus, monkeypatch):
    """The single-device sparse pack must fall back to the dense device
    buffers on budget overflow, identical answers (mirror of the
    MultiEngine test for QueryEngine's served path)."""
    cfg = ServeConfig(batch_size=16, max_hits=64)
    packed = build_index(
        tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids
    )
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            tiny_corpus, 12, tiny_corpus.spec.kmer_len, seed=77,
            miss_frac=0.2,
        )
    ]
    ref = QueryEngine(packed, cfg).query_batch(kmers)
    assert any(r.hits for r in ref)
    monkeypatch.setattr(QueryEngine, "COMPACT_PER_QUERY", 1)
    got = QueryEngine(packed, cfg).query_batch(kmers)
    key = lambda h: (h["read_id"], h["offset"], h["sample_id"])
    for a, b in zip(ref, got):
        assert a.count == b.count
        assert a.interval == b.interval
        assert sorted(map(key, a.hits)) == sorted(map(key, b.hits))
        assert (a.sample_hist or {}) == (b.sample_hist or {})


def test_append_after_compaction_no_name_collision(tiny_corpus, tmp_path):
    """Review r4: compaction can keep a high-numbered shard_XXXX dir in
    place; later appends must not re-derive that name from the shard
    COUNT and overwrite the kept shard."""
    from readserver_tpu.index.cohort import append_to_cohort, compact_cohort
    from readserver_tpu.serve import MultiEngine

    reads = tiny_corpus.reads
    path = build_cohort(reads[:120], None, 4, tmp_path / "pop")
    compact_cohort(path, target_shards=2)
    _, m1 = load_cohort(path)
    kept = [d for d in m1["shards"] if d.startswith("shard_")]
    # append twice: names must never collide with the kept shard dirs
    append_to_cohort(path, reads[120:140])
    append_to_cohort(path, reads[140:160])
    parts, m2 = load_cohort(path)
    assert len(set(m2["shards"])) == len(m2["shards"])
    assert all(d in m2["shards"] for d in kept)
    assert m2["num_reads"] == 160
    assert sum(p.num_reads for p in parts) == 160
    # the kept shard still answers (its arrays were not clobbered)
    eng = MultiEngine(parts, ServeConfig(batch_size=16, max_hits=64))
    km = alphabet.decode(reads[150][:15])
    from readserver_tpu.oracle import naive_count

    assert eng.query_batch([km])[0].count == naive_count(reads[:160], km)


def test_append_explicit_config_inherits_tier_kwargs(tiny_corpus, tmp_path):
    """Review r4: passing an explicit (identical) config must still
    inherit the cohort's tier kwargs (sample_rate etc.)."""
    from readserver_tpu.config import IndexConfig
    from readserver_tpu.index.cohort import append_to_cohort

    cfg = IndexConfig()
    path = build_cohort(
        tiny_corpus.reads[:80], None, 2, tmp_path / "pop",
        config=cfg, sample_rate=8,
    )
    append_to_cohort(path, tiny_corpus.reads[80:100], config=IndexConfig())
    _, manifest = load_cohort(path)
    new = json.loads(
        (path / manifest["shards"][-1] / "manifest.json").read_text()
    )
    assert new["sample_rate"] == 8


def test_engines_reject_mismatched_sample_spaces(tiny_corpus):
    """Review r4: partition merges are by sample ID — different name
    spaces would silently sum unrelated samples; refuse at init."""
    from readserver_tpu.serve import MultiEngine

    a = build_index(tiny_corpus.reads[:40], sample_names=["donor_a"])
    b = build_index(tiny_corpus.reads[40:80], sample_names=["donor_b"])
    with pytest.raises(ValueError, match="GLOBAL sample-id space"):
        MultiEngine([a, b], ServeConfig(batch_size=8))


def test_hist_tier_truncation_flag_exact(cohort_setup):
    """Review r4: the hist tier's hits_truncated must reflect whether a
    follow-up hits query WOULD truncate (some partition's local count >
    max_hits), not count > partitions*max_hits."""
    from readserver_tpu.serve import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    cfg = ServeConfig(batch_size=16, max_hits=2)  # tiny cap → truncation
    eng = MultiEngine(parts, cfg)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 10, corpus.spec.kmer_len, seed=99, miss_frac=0.2
        )
    ]
    full = eng.query_batch(kmers)
    hist = eng.query_batch(kmers, include_hits=False)
    assert any(r.hits_truncated for r in full)
    for f, h in zip(full, hist):
        assert f.hits_truncated == h.hits_truncated, f.kmer


def test_merged_count_int64_no_wrap(cohort_setup):
    """Cross-partition counts accumulate in int64.

    Per-partition counts are guaranteed to fit int32 (each partition's
    n < 2^31) but their sum is not; feed the device merge synthetic
    per-partition buffers whose counts sum past 2^31 and require the
    assembled total to come back exact, not wrapped negative."""
    import numpy as np

    from readserver_tpu.serve import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    cfg = ServeConfig(batch_size=8, max_hits=4)
    eng = MultiEngine(parts, cfg)
    W, H, nq = 8, cfg.max_hits, 3
    big = 2**31 - 5
    outs = []
    for e in eng.engines:
        ns = e._ns
        o = np.zeros((W, 4 + ns + 3 * H), dtype=np.int32)
        o[:, 2] = big          # per-partition count (fits int32)
        o[:, 3] = 1            # complete
        o[:, 4 : 4 + ns + 3 * H][:, ns:] = -1  # no hits
        outs.append(o)
    want = big * len(eng.engines)
    assert want > 2**31  # the test is vacuous otherwise

    # count tier
    counts = np.asarray(eng._merge_count_jit(tuple(outs)))
    assert counts.dtype == np.int64 and int(counts[0]) == want

    # full + hist tiers through the packed merge and host assembly
    kmers = ["A" * corpus.spec.kmer_len] * nq
    for with_hits in (True, False):
        merged = eng._merge_jit(tuple(outs), np.int32(nq), with_hits=with_hits)
        res = eng._assemble_merged(kmers, nq, with_hits, merged)
        assert all(r.count == want for r in res), [r.count for r in res]


def test_pack_stats_accounting(cohort_setup, monkeypatch):
    """engine.pack_stats records batches, sparse bytes, and dense-fallback
    events — the /samples overflow accounting."""
    from readserver_tpu.serve.engine import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    cfg = ServeConfig(batch_size=16, max_hits=64)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 12, corpus.spec.kmer_len, seed=31, miss_frac=0.2
        )
    ]
    eng = MultiEngine(parts, cfg)
    eng.query_batch(kmers)
    s = eng.pack_stats
    assert s["batches"] >= 1 and s["sparse_bytes"] > 0
    assert s["hits_dense_fallbacks"] == 0  # normal load fits the budget

    monkeypatch.setattr(MultiEngine, "COMPACT_PER_QUERY", 1)
    tiny = MultiEngine(parts, cfg)
    tiny.query_batch(kmers)
    t = tiny.pack_stats
    assert t["hits_dense_fallbacks"] + t["hist_dense_fallbacks"] >= 1
    assert t["dense_bytes"] > 0


def test_count_batches_pipelined_parity(cohort_setup):
    """MultiEngine.count_batches (pipelined bulk count tier) returns the
    same answers as per-batch count_batch."""
    from readserver_tpu.serve import MultiEngine

    corpus, path = cohort_setup
    parts, _ = load_cohort(path)
    eng = MultiEngine(parts, ServeConfig(batch_size=16, max_hits=8))
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 48, corpus.spec.kmer_len, seed=77, miss_frac=0.2
        )
    ]
    batches = [kmers[i : i + 16] for i in range(0, 48, 16)]
    bulk = eng.count_batches(batches)
    for b_, rs in zip(batches, bulk):
        ref = eng.count_batch(b_)
        assert [r.count for r in rs] == [r.count for r in ref]
