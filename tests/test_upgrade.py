"""Artifact upgrade (index/upgrade.py): a tier-set evolution must never
orphan an artifact — missing tiers are synthesized in place from the base
arrays (sym4 BWT + LF walk), bit-identical to a from-scratch build, and
the upgraded artifact serves identically (a format bump must never
silently orphan a 20 GB chr20 build)."""

import json

import numpy as np
import pytest

from readserver_tpu import alphabet
from readserver_tpu.config import ServeConfig
from readserver_tpu.corpus.simulate import sample_query_kmers
from readserver_tpu.index import artifact, build_index
from readserver_tpu.index.upgrade import plan_upgrade, upgrade_artifact

OPTIONAL = [
    "lf", "mark_rank", "sample_pairs", "dsa", "fused_rows",
    "rank2_blocks", "C2", "rank3_blocks", "C3",
]


def _strip(path, names):
    """Emulate an artifact from before ``names`` existed."""
    manifest = json.loads((path / artifact.MANIFEST_NAME).read_text())
    for name in names:
        (path / f"{name}.npy").unlink()
    manifest["arrays"] = [a for a in manifest["arrays"] if a not in names]
    if "dsa" in names:
        manifest["dsa_bits"] = 0
    if "mark_rank" in names:
        manifest["sample_rate"] = 0
    (path / artifact.MANIFEST_NAME).write_text(json.dumps(manifest))


@pytest.fixture(scope="module")
def full_artifact(tiny_corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("upg") / "full"
    packed = build_index(
        tiny_corpus.reads,
        sample_ids=tiny_corpus.sample_ids,
        sample_rate=16,
        kstep=3,
    )
    artifact.save_artifact(packed, out)
    return tiny_corpus, out, packed


def _copy_artifact(src, dst):
    import shutil

    shutil.copytree(src, dst)


def test_upgrade_restores_all_tiers_bit_identical(full_artifact, tmp_path):
    corpus, src, packed = full_artifact
    old = tmp_path / "old"
    _copy_artifact(src, old)
    _strip(old, OPTIONAL)
    # the stripped artifact still loads and serves (base tiers only)
    base = artifact.load_artifact(old)
    assert base.lf is None and base.dsa is None

    assert set(plan_upgrade(old, kstep=3)) == set(OPTIONAL)
    added = upgrade_artifact(old, kstep=3, sample_rate=16)
    assert sorted(added) == sorted(OPTIONAL)
    assert plan_upgrade(old, kstep=3) == []

    up = artifact.load_artifact(old)
    for name in OPTIONAL:
        a, b = getattr(packed, name), getattr(up, name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name
    assert up.sample_rate == packed.sample_rate
    assert up.dsa_bits == packed.dsa_bits


def test_partial_upgrade_adds_only_missing(full_artifact, tmp_path):
    corpus, src, packed = full_artifact
    old = tmp_path / "partial"
    _copy_artifact(src, old)
    _strip(old, ["dsa", "fused_rows", "rank3_blocks", "C3"])
    before = {
        name: (old / f"{name}.npy").stat().st_mtime_ns
        for name in ("lf", "rank2_blocks", "mark_rank")
    }
    added = upgrade_artifact(old, kstep=3)
    assert sorted(added) == ["C3", "dsa", "fused_rows", "rank3_blocks"]
    for name, mt in before.items():  # untouched arrays not rewritten
        assert (old / f"{name}.npy").stat().st_mtime_ns == mt
    up = artifact.load_artifact(old)
    for name in ("dsa", "fused_rows", "rank3_blocks", "C3"):
        assert np.array_equal(
            np.asarray(getattr(up, name)), np.asarray(getattr(packed, name))
        ), name
    assert up.dsa_bits == packed.dsa_bits


def test_upgraded_artifact_serves_identically(full_artifact, tmp_path):
    from readserver_tpu.serve import QueryEngine

    corpus, src, packed = full_artifact
    old = tmp_path / "served"
    _copy_artifact(src, old)
    _strip(old, OPTIONAL)
    upgrade_artifact(old, kstep=3, sample_rate=16)

    cfg = ServeConfig(batch_size=16, max_hits=64)
    a = QueryEngine(packed, cfg)
    b = QueryEngine(artifact.load_artifact(old), cfg)
    kmers = [
        alphabet.decode(km)
        for km in sample_query_kmers(
            corpus, 10, corpus.spec.kmer_len, seed=41, miss_frac=0.25
        )
    ]
    key = lambda h: (h["read_id"], h["offset"])
    for ra, rb in zip(a.query_batch(kmers), b.query_batch(kmers)):
        assert ra.count == rb.count
        assert sorted(map(key, ra.hits)) == sorted(map(key, rb.hits))
        assert (ra.sample_hist or {}) == (rb.sample_hist or {})


def test_cli_upgrade_cohort(tiny_corpus, tmp_path):
    """cohort upgrade walks every shard."""
    from readserver_tpu.cli import main
    from readserver_tpu.index.cohort import build_cohort, load_cohort

    path = build_cohort(
        tiny_corpus.reads[:120],
        np.asarray(tiny_corpus.sample_ids[:120]),
        2,
        tmp_path / "pop",
    )
    parts, manifest = load_cohort(path)
    ref_dsa = [np.asarray(p.dsa) for p in parts]
    for s in manifest["shards"]:
        _strip(path / s, ["dsa", "fused_rows"])
    assert main(["upgrade", str(path)]) == 0
    parts2, _ = load_cohort(path)
    for p, want in zip(parts2, ref_dsa):
        assert np.array_equal(np.asarray(p.dsa), want)


def test_upgrade_rate_change_rewrites_all_resolve_tiers(
    full_artifact, tmp_path
):
    """Review r4: changing sample_rate must rewrite EVERY resolve tier —
    mixing mark densities makes the rate-bounded walks return garbage."""
    corpus, src, packed = full_artifact
    old = tmp_path / "rate"
    _copy_artifact(src, old)
    _strip(old, ["dsa", "fused_rows"])  # partial: lf/marks remain rate-16
    added = upgrade_artifact(old, kstep=3, sample_rate=8)
    # the present-but-stale tiers were rewritten too, not just the missing
    assert {"lf", "mark_rank", "sample_pairs", "dsa", "fused_rows"} <= set(
        added
    )
    up = artifact.load_artifact(old)
    assert up.sample_rate == 8
    ref = build_index(
        corpus.reads, sample_ids=corpus.sample_ids, sample_rate=8, kstep=3
    )
    for name in ("lf", "mark_rank", "sample_pairs", "dsa", "fused_rows"):
        assert np.array_equal(
            np.asarray(getattr(up, name)), np.asarray(getattr(ref, name))
        ), name
    # manifest arrays stay duplicate-free
    import json as _json

    manifest = _json.loads((old / "manifest.json").read_text())
    assert len(manifest["arrays"]) == len(set(manifest["arrays"]))


def test_rate_change_crash_leaves_artifact_valid(
    full_artifact, tmp_path, monkeypatch
):
    """A crash mid-way through a sample_rate-change
    rewrite must leave the ORIGINAL artifact fully intact — rewrites go
    to rate-versioned files flipped via the atomic manifest update, so
    mixed-density resolve tiers are impossible at any crash point."""
    corpus, src, packed = full_artifact
    old = tmp_path / "crash"
    _copy_artifact(src, old)
    resolve = ("lf", "mark_rank", "sample_pairs", "dsa", "fused_rows")
    before = {
        name: np.asarray(getattr(artifact.load_artifact(old), name)).copy()
        for name in resolve
    }

    calls = {"n": 0}
    real_save = np.save

    def bomb(f, arr, *a, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:  # die after a couple of rewritten arrays
            raise RuntimeError("simulated crash")
        return real_save(f, arr, *a, **kw)

    monkeypatch.setattr(np, "save", bomb)
    with pytest.raises(RuntimeError, match="simulated crash"):
        upgrade_artifact(old, kstep=3, sample_rate=8)
    monkeypatch.setattr(np, "save", real_save)

    # the live artifact is byte-identical to pre-crash: old rate, old tiers
    up = artifact.load_artifact(old)
    assert up.sample_rate == 16
    for name in resolve:
        assert np.array_equal(np.asarray(getattr(up, name)), before[name]), name

    # a re-run completes and matches a fresh rate-8 build bit-for-bit
    upgrade_artifact(old, kstep=3, sample_rate=8)
    up2 = artifact.load_artifact(old)
    ref = build_index(
        corpus.reads, sample_ids=corpus.sample_ids, sample_rate=8, kstep=3
    )
    assert up2.sample_rate == 8
    for name in resolve:
        assert np.array_equal(
            np.asarray(getattr(up2, name)), np.asarray(getattr(ref, name))
        ), name
    # superseded default-named files were reclaimed post-flip
    manifest = json.loads((old / artifact.MANIFEST_NAME).read_text())
    for name, fname in manifest.get("files", {}).items():
        assert (old / fname).exists()
        assert fname != f"{name}.npy"
        assert not (old / f"{name}.npy").exists(), name
