"""HBM tier planner + tier-dropped resolve parity (index/budget.py).

The chr20-scale contract: dropping optional tiers (lf / rank3 / rank2 /
marks) changes gather counts only, never answers.
"""

import jax
import numpy as np
import pytest

from readserver_tpu.index import build_index
from readserver_tpu.index.budget import TIER_ORDER, plan_tiers, tier_bytes
from readserver_tpu.ops import (
    DeviceIndex,
    backward_search,
    encode_query_batch,
    resolve_intervals,
)
from readserver_tpu.corpus import simulate


@pytest.fixture(scope="module")
def packed(tiny_corpus):
    return build_index(
        tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids, kstep=3
    )


def test_plan_no_budget_keeps_all(packed):
    plan = plan_tiers(packed, None)
    assert plan.keep == {"marks", "rank2", "rank3", "lf", "dsa", "fused"}
    assert plan.dropped == ()
    # shared sample_pairs (marks + fused) charged once
    base, tiers = tier_bytes(packed)
    assert plan.total_bytes == base + sum(tiers.values()) - (
        packed.sample_pairs.nbytes
    )


def test_plan_drops_in_value_order(packed):
    base, tiers = tier_bytes(packed)
    # room for rank2 + dsa only (greedy order: rank2 first, dsa second)
    budget = base + tiers["rank2"] + tiers["dsa"]
    plan = plan_tiers(packed, budget)
    assert plan.keep == {"rank2", "dsa"}
    # fused/marks/lf are dominated by the kept dsa; rank3 didn't fit
    assert "rank3" in plan.dropped
    assert plan.total_bytes <= budget
    # base only
    plan0 = plan_tiers(packed, base)
    assert plan0.keep == frozenset()
    # base doesn't fit → explicit error naming sharding
    with pytest.raises(ValueError, match="shard"):
        plan_tiers(packed, base - 1)


def test_plan_chr20_shape(packed):
    """The chr20-scale shape: rank2 fits, dsa does NOT, fused does —
    resolve is served by the fused-row walk, lf/marks dominated/skipped."""
    base, tiers = tier_bytes(packed)
    budget = base + tiers["rank2"] + tiers["fused"]
    if tiers["dsa"] <= tiers["fused"]:
        pytest.skip("corpus too small for the dsa>fused size relation")
    plan = plan_tiers(packed, budget)
    assert plan.keep == {"rank2", "fused"}
    assert "dsa" in plan.dropped


def test_plan_skips_oversized_tier(packed):
    base, tiers = tier_bytes(packed)
    # rank3 doesn't fit but everything before/after does: greedy must
    # skip OVER rank3, not stop at it
    budget = base + tiers["rank2"] + tiers["dsa"] + tiers["rank3"] - 1
    plan = plan_tiers(packed, budget)
    assert "dsa" in plan.keep and "rank3" not in plan.keep


def test_lf_requires_marks(packed):
    base, tiers = tier_bytes(packed)
    # budget that fits lf but NOT marks first? marks is smaller, so force
    # via from_packed directly: tiers={'lf'} must not ship a fast tier
    dev = DeviceIndex.from_packed(packed, tiers={"lf"})
    assert dev.lf is None and dev.mark_rank is None
    assert dev.sample_rate == 0


@pytest.mark.parametrize(
    "tiers",
    [
        frozenset(),
        {"marks"},
        {"fused"},
        {"dsa"},
        {"marks", "rank2"},
        {"fused", "rank2"},
        {"dsa", "rank2", "rank3"},
        {"marks", "rank2", "lf"},
    ],
    ids=lambda t: "+".join(sorted(t)) or "base",
)
def test_tier_drop_answer_parity(packed, tiny_corpus, tiers):
    """Search + resolve answers are identical for every tier subset."""
    k = tiny_corpus.spec.kmer_len
    kmers = simulate.sample_query_kmers(tiny_corpus, 48, k, seed=3)
    codes, lengths = encode_query_batch(kmers, k)

    full = DeviceIndex.from_packed(packed)
    cut = DeviceIndex.from_packed(packed, tiers=tiers)
    if "rank2" not in tiers:
        assert cut.rank2_rows is None
    if "lf" not in tiers:
        assert cut.lf is None

    def run(idx):
        l, u = backward_search(idx, codes, lengths)
        rid, off, valid = resolve_intervals(idx, l, u, max_hits=16)
        return jax.tree_util.tree_map(
            np.asarray, dict(l=l, u=u, rid=rid, off=off, valid=valid)
        )

    a, b = run(full), run(cut)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_all_walks_agree_on_every_row(packed):
    """dsa ≡ lf-walk ≡ fused-walk ≡ mark-walk on every row of the BWT."""
    from readserver_tpu.ops.resolve import (
        resolve_rows_dsa,
        resolve_rows_fast,
        resolve_rows_fused,
        resolve_rows_marked,
    )

    full = DeviceIndex.from_packed(packed)
    marked_only = DeviceIndex.from_packed(packed, tiers={"marks"})
    fused_only = DeviceIndex.from_packed(packed, tiers={"fused"})
    rows = np.arange(packed.n, dtype=np.int32)
    valid = np.ones(packed.n, dtype=bool)
    want = tuple(map(np.asarray, resolve_rows_dsa(full, rows, valid)))
    for name, got in {
        "lf": resolve_rows_fast(full, rows, valid),
        "marks": resolve_rows_marked(marked_only, rows, valid),
        "fused": resolve_rows_fused(fused_only, rows, valid),
    }.items():
        np.testing.assert_array_equal(want[0], np.asarray(got[0]), err_msg=name)
        np.testing.assert_array_equal(want[1], np.asarray(got[1]), err_msg=name)


def test_engine_budget_plumbing(tiny_corpus):
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.serve import QueryEngine

    packed = build_index(tiny_corpus.reads, sample_ids=tiny_corpus.sample_ids)
    base, tiers = tier_bytes(packed)
    budget_gb = (base + tiers["marks"] + tiers["rank2"]) / 2**30
    eng_cut = QueryEngine(
        packed, ServeConfig(batch_size=64, hbm_budget_gb=budget_gb)
    )
    assert "lf" in eng_cut.tier_plan.dropped
    eng_full = QueryEngine(packed, ServeConfig(batch_size=64))
    k = tiny_corpus.spec.kmer_len
    kmers = [
        "".join("ACGT"[c - 1] for c in km)
        for km in simulate.sample_query_kmers(tiny_corpus, 32, k, seed=5)
    ]
    ra = eng_full.query_batch(kmers)
    rb = eng_cut.query_batch(kmers)
    for x, y in zip(ra, rb):
        assert x.count == y.count
        assert x.sample_hist == y.sample_hist
        assert sorted(h["read_id"] for h in x.hits) == sorted(
            h["read_id"] for h in y.hits
        )


def test_tier_order_is_exhaustive():
    from readserver_tpu.index.budget import _TIER_ARRAYS

    assert set(TIER_ORDER) == set(_TIER_ARRAYS)


def test_exclude_reallocates_budget(packed):
    """plan_tiers(exclude=...) frees the excluded tier's budget for later
    tiers: at a budget sized for exactly {rank2, marks}, excluding rank2
    must make the better resolve tiers (dsa/fused) resident instead of
    just shrinking the plan (the wg serving-profile lever)."""
    from readserver_tpu.index.budget import plan_tiers, tier_bytes

    base, tiers = tier_bytes(packed)
    budget = base + tiers["rank2"] + tiers["marks"]
    default = plan_tiers(packed, budget)
    assert "rank2" in default.keep
    resolve_profile = plan_tiers(packed, budget, exclude=("rank2",))
    assert "rank2" not in resolve_profile.keep
    assert "dsa" in resolve_profile.keep  # freed budget reallocated
    assert resolve_profile.total_bytes <= budget


def test_serve_config_drop_tiers_profile(packed, tiny_corpus):
    """ServeConfig.drop_tiers flows through to the engine plan and the
    answers stay identical (tiers only change gather counts)."""
    from readserver_tpu.config import ServeConfig
    from readserver_tpu.corpus import simulate
    from readserver_tpu.serve import QueryEngine

    eng_a = QueryEngine(packed, ServeConfig(batch_size=32))
    eng_b = QueryEngine(
        packed, ServeConfig(batch_size=32, drop_tiers=("rank2", "rank3"))
    )
    assert "rank2" not in eng_b.tier_plan.keep
    k = tiny_corpus.spec.kmer_len
    kmers = [
        "".join("ACGT"[c - 1] for c in km)
        for km in simulate.sample_query_kmers(tiny_corpus, 24, k, seed=9)
    ]
    for x, y in zip(eng_a.query_batch(kmers), eng_b.query_batch(kmers)):
        assert x.count == y.count
        assert x.sample_hist == y.sample_hist


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "platform,stats,want",
    [
        ("cpu", None, None),  # simulated mesh: host RAM, no cap
        ("gpu", {"bytes_limit": 1000, "bytes_in_use": 7}, 920),
        ("gpu", None, RuntimeError),  # no limit reported: no guess
        ("gpu", {"bytes_in_use": 7}, RuntimeError),
    ],
)
def test_device_budget_bytes(monkeypatch, platform, stats, want):
    from readserver_tpu.index.budget import device_budget_bytes

    monkeypatch.setattr(
        jax, "local_devices", lambda: [_FakeDevice(platform, stats)]
    )
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="bytes_limit"):
            device_budget_bytes()
    else:
        assert device_budget_bytes(headroom=0.92) == want
