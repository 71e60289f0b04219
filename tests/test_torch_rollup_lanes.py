"""Maintenance-built rollup lanes (storage/rollup.py) on the CPU.

The cases of tests/test_rollup_lanes.py whose lane grid fits the device
budget: a lane-served answer equals the exact answer bit for bit on
integer data for every lane-derivable function (the port with lanes off,
and the JAX reference), float data agrees within reassociation (the
reference's own latitude, rel 1e-12), edge windows recompute from raw
points, other intervals and functions take the exact path, an acked write
is never served stale, a new series invalidates, and the byte budget,
eviction, coverage and the maintenance cadence behave as the reference's.
A plan whose grid is over tsd.query.streaming.state_mb is served striped
in the reference's three modes (the reference's TestStripedServe): the
host-dense fold, the device fold through T1 and the spill pool's replay,
each equal to the exact answer.  Reference TSDBs run with the mesh off.
"""

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.core.maintenance import MaintenanceThread
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops.costmodel import LANE_CELL_BYTES
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
LANES = {
    "tsd.core.auto_create_metrics": True,
    "tsd.storage.fix_duplicates": True,
    "tsd.rollup.intervals": "1m,1h",
    "tsd.rollup.block_windows": 8,
    "tsd.rollup.delay_ms": 0,
    # the lanes' fallbacks take the exact path in both packages, not the
    # batched route that a small plan prices onto, nor the aggregate
    # cache's rewrite
    "tsd.query.batch.enable": False,
    "tsd.query.cache.enable": False,
}


def make_tsdb(enable=True, **over):
    return TSDB(Config({**LANES, "tsd.rollup.enable": enable, **over}),
                device="cpu")


def make_ref():
    """The reference's exact path: lanes off, mesh off, its batcher off
    (LANES) so its plan decision runs the plain grouped dispatch."""
    return RefTSDB(RefConfig({**LANES, "tsd.rollup.enable": False,
                              "tsd.query.mesh.enable": False}))


def feed_int(tsdb, n=6000, hosts=("a", "b"), metric="lane.i", step=1):
    for i, host in enumerate(hosts):
        key = tsdb._series_key(metric, {"host": host}, create=True)
        ts = (np.arange(n, dtype=np.int64) * step + BASE) * 1000
        vals = (np.arange(n, dtype=np.int64) * 7 + i * 13) % 101
        tsdb.store.add_batch(key, ts, vals, True)


def feed_float(tsdb, n=6000, hosts=("a", "b"), metric="lane.f", seed=3):
    rng = np.random.default_rng(seed)
    for host in hosts:
        key = tsdb._series_key(metric, {"host": host}, create=True)
        ts = (np.arange(n, dtype=np.int64) + BASE) * 1000
        tsdb.store.add_batch(key, ts, rng.standard_normal(n), False)


def run_q(tsdb, m, start=BASE + 7, end=BASE + 5923):
    ref = isinstance(tsdb, RefTSDB)
    q = (RefTSQuery if ref else TSQuery)(
        start=str(start), end=str(end),
        queries=[(ref_parse if ref else parse_m_subquery)(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    out = [r.to_json() for r in runner.run(q)]
    return out, dict(runner.exec_stats)


def warm(tsdb, m, **kw):
    """A consult (records demand), then build the demanded blocks."""
    run_q(tsdb, m, **kw)
    for _ in range(20):
        if not tsdb.rollup_lanes.refresh(tsdb.store, max_blocks=256):
            break


@pytest.fixture
def trio():
    """The port with lanes on, with lanes off, and the reference, holding
    the same integer data."""
    on, off, ref = make_tsdb(), make_tsdb(enable=False), make_ref()
    for tsdb in (on, off, ref):
        feed_int(tsdb)
    return on, off, ref


@pytest.mark.parametrize("fn", ["sum", "count", "avg", "min", "max",
                                "zimsum", "mimmax", "mimmin"])
def test_lane_served_equals_exact_bitwise_on_ints(trio, fn):
    on, off, ref = trio
    m = "sum:60s-%s:lane.i{host=*}" % fn
    warm(on, m)
    served, stats = run_q(on, m)
    assert stats.get("rollupLane") == 1.0, stats
    plain, pstats = run_q(off, m)
    assert "rollupLane" not in pstats
    assert served == plain          # float dps, bit for bit
    assert served == run_q(ref, m)[0]


@pytest.mark.parametrize("m", ["sum:rate:60s-sum:lane.i{host=*}",
                               "max:5m-avg:lane.i",
                               "p95:120s-max:lane.i{host=*}",
                               "sum:5m-count-zero:lane.i{host=*}",
                               "movingAverage3:60s-sum:lane.i{host=*}"])
def test_the_tail_over_a_lane_grid_matches_exact(trio, m):
    """Rate, other cross-series aggregators and fills run on the lane
    grid as on the exact one: bit for bit against the port's exact path,
    and against the reference's at rtol 1e-12 (movingAverage<N> takes a
    window sum as a difference of running sums in both packages, which
    quantise apart in the last ulp, ROADMAP C)."""
    on, off, ref = trio
    warm(on, m)
    served, stats = run_q(on, m)
    assert stats.get("rollupLane") == 1.0
    assert served == run_q(off, m)[0]
    want = run_q(ref, m)[0]
    assert [(r["tags"], list(r["dps"])) for r in served] \
        == [(r["tags"], list(r["dps"])) for r in want]
    for got, exp in zip(served, want):
        for k, v in exp["dps"].items():
            assert got["dps"][k] == pytest.approx(v, rel=1e-12), k


def test_unaligned_edges_recompute_from_raw(trio):
    """The partial edge windows recompute from the raw points; sliding
    ranges keep matching the exact path bit for bit."""
    on, off, _ref = trio
    m = "sum:60s-sum:lane.i{host=*}"
    warm(on, m, start=BASE, end=BASE + 5999)
    for start, end in ((BASE + 7, BASE + 5003), (BASE + 607, BASE + 5603),
                       (BASE + 61, BASE + 5999), (BASE, BASE + 5999)):
        served, stats = run_q(on, m, start, end)
        assert stats.get("rollupLane") == 1.0, (start, end, stats)
        assert served == run_q(off, m, start, end)[0], (start, end)


def test_float_data_matches_within_reassociation():
    """Float sums re-reduce from lane partials: exact in exact arithmetic,
    within the last-ulp latitude of reassociation."""
    on, off = make_tsdb(), make_tsdb(enable=False)
    feed_float(on)
    feed_float(off)
    m = "sum:60s-sum:lane.f{host=*}"
    warm(on, m)
    served, stats = run_q(on, m)
    assert stats.get("rollupLane") == 1.0
    plain, _ = run_q(off, m)
    a, b = served[0]["dps"], plain[0]["dps"]
    assert set(a) == set(b)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-12)


def test_non_multiple_interval_falls_back(trio):
    on, off, _ref = trio
    warm(on, "sum:60s-sum:lane.i{host=*}")     # lanes exist
    m = "sum:90s-sum:lane.i{host=*}"           # 90 s is no multiple of 60 s
    served, stats = run_q(on, m)
    assert "rollupLane" not in stats, stats
    assert served == run_q(off, m)[0]


@pytest.mark.parametrize("fn", ["p95", "dev", "last", "median"])
def test_non_derivable_functions_fall_back(trio, fn):
    on, off, _ref = trio
    warm(on, "sum:60s-sum:lane.i{host=*}")
    m = "sum:60s-%s:lane.i{host=*}" % fn
    served, stats = run_q(on, m)
    assert "rollupLane" not in stats, (fn, stats)
    assert served == run_q(off, m)[0], fn


def test_calendar_and_run_all_grids_fall_back(trio):
    on, off, _ref = trio
    warm(on, "sum:60s-sum:lane.i{host=*}")
    for m in ("sum:1mc-sum:lane.i{host=*}", "sum:0all-sum:lane.i"):
        served, stats = run_q(on, m)
        assert "rollupLane" not in stats, m
        assert served == run_q(off, m)[0], m


def test_cold_lanes_fall_back_and_record_demand():
    on = make_tsdb()
    feed_int(on)
    _, stats = run_q(on, "sum:60s-sum:lane.i{host=*}")
    assert "rollupLane" not in stats
    walk = on.rollup_lanes.collect_stats()
    assert walk["tsd.query.rollup.misses"] >= 1
    assert walk["tsd.query.rollup.demand_entries"] >= 1


def test_acked_write_is_never_served_stale(trio):
    """A write's mark fails the block's generation check, so the next
    query takes the exact path with the write counted; after the rebuild
    the lane serves the new data."""
    on, off, _ref = trio
    m = "sum:60s-sum:lane.i{host=*}"
    warm(on, m)
    assert run_q(on, m)[1].get("rollupLane") == 1.0
    # overwrite a point inside a served window (last write wins)
    for tsdb in (on, off):
        tsdb.add_point("lane.i", BASE + 300, 9999, {"host": "a"})
    served, stats = run_q(on, m)
    assert "rollupLane" not in stats, "stale lane served a write"
    plain, _ = run_q(off, m)
    assert served == plain
    for _ in range(20):
        if not on.rollup_lanes.refresh(on.store, max_blocks=256):
            break
    served, stats = run_q(on, m)
    assert stats.get("rollupLane") == 1.0
    assert served == plain


def test_bulk_and_deleted_series_invalidate(trio):
    """Bulk ingest and a dropped series mark the store as a single point
    does."""
    on, off, _ref = trio
    m = "sum:60s-sum:lane.i{host=*}"
    warm(on, m)
    for tsdb in (on, off):
        tsdb.add_points_bulk([{"metric": "lane.i", "timestamp": BASE + 900,
                               "value": 5, "tags": {"host": "b"}}])
    served, stats = run_q(on, m)
    assert "rollupLane" not in stats
    assert served == run_q(off, m)[0]
    warm(on, m)
    assert run_q(on, m)[1].get("rollupLane") == 1.0
    for tsdb in (on, off):
        key = tsdb._series_key("lane.i", {"host": "b"}, create=False)
        tsdb.store.delete_series(key)
    served, stats = run_q(on, m)
    assert "rollupLane" not in stats
    assert served == run_q(off, m)[0]


def test_new_series_invalidates_row_incomplete_blocks(trio):
    on, off, _ref = trio
    m = "sum:60s-sum:lane.i{host=*}"
    warm(on, m)
    feed_int(on, hosts=("c",))
    feed_int(off, hosts=("c",))
    served, stats = run_q(on, m)
    assert "rollupLane" not in stats
    plain, _ = run_q(off, m)
    assert served == plain
    warm(on, m)
    served, stats = run_q(on, m)
    assert stats.get("rollupLane") == 1.0
    assert served == plain


def test_invalidate_drops_every_block():
    on = make_tsdb()
    feed_int(on)
    m = "sum:60s-sum:lane.i{host=*}"
    warm(on, m)
    assert len(on.rollup_lanes) > 0
    on.rollup_lanes.invalidate()
    assert len(on.rollup_lanes) == 0
    assert "rollupLane" not in run_q(on, m)[1]


def test_over_budget_grid_takes_the_exact_path():
    """A lane plan whose [S, W] grid is over tsd.query.streaming.state_mb:
    until slice 7b the port took the exact path here (the name is kept
    from then); now it is served striped, as the reference serves it, and
    counted a hit: the answer equals the exact one bit for bit."""
    on = make_tsdb(**{"tsd.query.streaming.state_mb": 1})
    off = make_tsdb(enable=False)
    ref = make_ref()
    # 96 series x 1,000 windows (1,024 padded) x 24 bytes: over 1 MB
    hosts = tuple("h%03d" % i for i in range(96))
    end = BASE + 2000 * 30 - 1
    for tsdb in (on, off, ref):
        feed_int(tsdb, n=2000, hosts=hosts, step=30)
    m = "sum:60s-sum:lane.i{host=*}"
    warm(on, m, start=BASE, end=end)
    assert len(on.rollup_lanes) > 0
    before = on.rollup_lanes.collect_stats()
    served, stats = run_q(on, m, BASE, end)
    assert stats.get("rollupLane") == 1.0
    assert stats.get("rollupLaneStriped") == 1.0
    assert served == run_q(off, m, BASE, end)[0] == run_q(ref, m, BASE,
                                                          end)[0]
    after = on.rollup_lanes.collect_stats()
    assert after["tsd.query.rollup.hits"] \
        == before["tsd.query.rollup.hits"] + 1
    assert after["tsd.query.rollup.misses"] \
        == before["tsd.query.rollup.misses"]


class TestStripedServe:
    """The reference's striped cases (tests/test_rollup_lanes.py
    TestStripedServe): grids over a 1 MB budget, each served in its mode
    and equal to the lane-disabled control and to the reference's exact
    answer."""

    COMMON = {"tsd.query.streaming.state_mb": 1,
              "tsd.query.spill.host_mb": 4,
              "tsd.rollup.block_windows": 64,
              "tsd.query.streaming.point_threshold": 1000}

    @staticmethod
    def _feed_wide(tsdb, hosts=96, n=3000, metric="lane.w"):
        for h in range(hosts):
            key = tsdb._series_key(
                metric, {"h": "h%d" % h, "g": "g%d" % (h % 4)}, create=True)
            ts = (np.arange(n, dtype=np.int64) * 10 + BASE) * 1000
            vals = (np.arange(n, dtype=np.int64) * 7 + h * 13) % 101
            tsdb.store.add_batch(key, ts, vals, True)

    @staticmethod
    def _feed_sparse(tsdb, hosts=96, n=300, metric="lane.s"):
        """Holes: ~40% of the 60 s windows have no points."""
        rng = np.random.default_rng(7)
        for h in range(hosts):
            secs = np.sort(rng.choice(30000, size=n, replace=False)
                           .astype(np.int64))
            vals = (np.arange(n, dtype=np.int64) * 7 + h * 13) % 101
            key = tsdb._series_key(
                metric, {"h": "h%d" % h, "g": "g%d" % (h % 4)}, create=True)
            tsdb.store.add_batch(key, (BASE + secs) * 1000, vals, True)

    def _served(self, feed, m, end=BASE + 30000):
        on = make_tsdb(**self.COMMON)
        off = make_tsdb(enable=False, **self.COMMON)
        ref = make_ref()
        for tsdb in (on, off, ref):
            feed(tsdb)
        warm(on, m, start=BASE, end=end)
        served, stats = run_q(on, m, BASE, end)
        assert stats.get("rollupLane") == 1.0, stats
        assert stats.get("rollupLaneStriped") == 1.0, stats
        return (served, stats, run_q(off, m, BASE, end)[0],
                run_q(ref, m, BASE, end)[0])

    @staticmethod
    def _near(got, want):
        assert [(a["tags"], sorted(a["dps"])) for a in got] \
            == [(b["tags"], sorted(b["dps"])) for b in want]
        for a, b in zip(got, want):
            for k in a["dps"]:
                assert a["dps"][k] == pytest.approx(b["dps"][k], rel=1e-12,
                                                    abs=1e-12)

    def test_over_budget_dense_grid_serves_host_fold(self):
        """Every cell populated (regular-cadence telemetry, the query
        ending on the data's last window): the reference folds the group
        partials on the host; the port, which has no host fold, folds
        them on the device through T1, bit for bit all the same."""
        served, stats, plain, ref = self._served(
            self._feed_wide, "sum:60s-sum:lane.w{g=*}", end=BASE + 29999)
        assert stats.get("rollupFoldDevice") == 1.0, stats
        assert "rollupFoldHostDense" not in stats, stats
        assert served == plain == ref

    def test_over_budget_rate_query_applies_rate(self):
        """The rate is applied: rate plans take the device fold (K2
        applies it row by row, then T1)."""
        served, stats, plain, ref = self._served(
            self._feed_wide, "sum:rate:60s-sum:lane.w{g=*}")
        assert stats.get("rollupFoldDevice") == 1.0, stats
        self._near(served, plain)
        self._near(served, ref)

    def test_over_budget_sparse_extreme_folds_on_device_bitwise(self):
        """Holes force the device fold; for an extreme the fold is a
        selection over the same contribution bits, bitwise even with
        fractional interpolated values."""
        served, stats, plain, ref = self._served(
            self._feed_sparse, "max:60s-max:lane.s{g=*}")
        assert stats.get("rollupFoldDevice") == 1.0, stats
        assert served == plain == ref

    def test_over_budget_sparse_sum_folds_within_reassociation(self):
        """The additive device fold over holes: T1 adds each tile's rows
        in row order into the running sums, so the port's fold is K3's
        bit for bit; the reference's per-tile partials carry
        reassociation latitude."""
        served, stats, plain, ref = self._served(
            self._feed_sparse, "sum:60s-sum:lane.s{g=*}")
        assert stats.get("rollupFoldDevice") == 1.0, stats
        assert served == plain
        self._near(served, ref)

    def test_over_budget_non_foldable_agg_replays_through_pool(self):
        """dev does not fold across tiles: the striped serve replays the
        spill pool's window stripes, bitwise against the control."""
        served, stats, plain, ref = self._served(
            self._feed_wide, "dev:60s-sum:lane.w{g=*}")
        assert stats.get("rollupFoldReplay") == 1.0, stats
        assert stats.get("spillBytes", 0) > 0, stats
        assert served == plain == ref


def test_zero_budget_materializes_nothing():
    on = make_tsdb(**{"tsd.rollup.mb": 0})
    feed_int(on)
    m = "sum:60s-sum:lane.i{host=*}"
    run_q(on, m)
    assert on.rollup_lanes.refresh(on.store, max_blocks=256) == 0
    assert "rollupLane" not in run_q(on, m)[1]


def test_selection_refuses_targets_that_cannot_fit():
    """The greedy selection never part-builds a target whose estimate
    exceeds the whole budget (it could never serve)."""
    on = make_tsdb()
    feed_int(on)
    run_q(on, "sum:60s-sum:lane.i{host=*}")
    on.rollup_lanes.max_bytes = 2 * LANE_CELL_BYTES   # under one block
    assert on.rollup_lanes.refresh(on.store, max_blocks=256) == 0


def test_eviction_keeps_bytes_under_budget():
    on = make_tsdb()
    feed_int(on)
    warm(on, "sum:60s-sum:lane.i{host=*}")
    lanes = on.rollup_lanes
    b0 = lanes.collect_stats()["tsd.query.rollup.bytes"]
    assert b0 == len(lanes) * 2 * 8 * LANE_CELL_BYTES   # unpadded blocks
    with lanes._lock:
        lanes.max_bytes = int(b0) - 1
        lanes._evict_for_locked(0)
    walk = lanes.collect_stats()
    assert walk["tsd.query.rollup.bytes"] <= lanes.max_bytes
    assert walk["tsd.query.rollup.evictions"] >= 1


def test_lane_coverage_fraction():
    on = make_tsdb()
    feed_int(on)
    metric = on.metrics.get_id("lane.i")
    lanes = on.rollup_lanes
    span = (BASE * 1000, (BASE + 5999) * 1000)
    assert lanes.coverage(metric, 60_000, "sum", *span) == 0.0
    warm(on, "sum:60s-sum:lane.i{host=*}", start=BASE, end=BASE + 5999)
    assert lanes.coverage(metric, 60_000, "sum", *span) == 1.0
    assert lanes.coverage(metric, 60_000, "p95", *span) == 0.0
    assert lanes.coverage(metric, 90_000, "sum", *span) == 0.0


def test_maintenance_cadence_builds_the_lanes():
    on = make_tsdb(**{"tsd.rollup.interval": 1})
    feed_int(on)
    m = "sum:60s-sum:lane.i{host=*}"
    run_q(on, m)                       # records the demand
    mt = MaintenanceThread(on)         # not started: tick by hand
    mt._next_rollup = 0.0
    mt._maybe_rollup(1.0)
    assert mt.rollup_passes == 1 and mt.rollup_blocks_built > 0
    assert run_q(on, m)[1].get("rollupLane") == 1.0
    mt._maybe_rollup(1.5)              # before the next interval: no pass
    assert mt.rollup_passes == 1
    stats = mt.collect_stats()
    assert stats["tsd.maintenance.rollup_blocks_built"] > 0
    assert make_tsdb(**{"tsd.rollup.interval": 0}) is not None


def test_the_maintenance_thread_builds_the_lanes(monkeypatch):
    monkeypatch.setattr(MaintenanceThread, "TICK_SECONDS", 0.02)
    on = make_tsdb(**{"tsd.rollup.interval": 1})
    feed_int(on)
    m = "sum:60s-sum:lane.i{host=*}"
    run_q(on, m)
    thread = on.start_maintenance()
    try:
        thread._next_rollup = 0.0
        for _ in range(250):
            if thread.rollup_blocks_built:
                break
            thread._stop_event.wait(0.02)
    finally:
        on.shutdown()
    assert run_q(on, m)[1].get("rollupLane") == 1.0


def test_delay_skips_the_head_being_written():
    """tsd.rollup.delay_ms: blocks ending within the delay of now are not
    built this pass."""
    on = make_tsdb(**{"tsd.rollup.delay_ms": 10 ** 6})
    feed_int(on)
    run_q(on, "sum:60s-sum:lane.i{host=*}")
    end_ms = (BASE + 6000) * 1000
    built_near = on.rollup_lanes.refresh(on.store, max_blocks=256,
                                         now_ms=end_ms)
    built_later = on.rollup_lanes.refresh(on.store, max_blocks=256,
                                          now_ms=end_ms + 10 ** 7)
    assert built_near > 0 and built_later > 0


def test_mutation_listeners_hear_every_write_after_it_lands():
    """The memstore's write-then-mark contract: each listener runs after
    the write is visible, with the written range."""
    tsdb = make_tsdb(enable=False)
    seen = []

    def listener(metric, lo, hi):
        series = tsdb.store.series_for_metric(metric)
        seen.append((lo, hi, sum(len(s) for s in series)))

    tsdb.store.add_mutation_listener(listener)
    tsdb.add_point("w.m", BASE, 1, {"h": "a"})
    tsdb.add_points_bulk([{"metric": "w.m", "timestamp": BASE + t,
                           "value": t, "tags": {"h": "a"}}
                          for t in (5, 3)])
    tsdb.store.delete_series(tsdb._series_key("w.m", {"h": "a"}, False))
    ms = BASE * 1000
    assert seen == [(ms, ms, 1), (ms + 3000, ms + 5000, 3),
                    (None, None, 0)]


def test_stats_keys_are_the_reference_lanes():
    ref = RefTSDB(RefConfig({**LANES, "tsd.rollup.enable": True,
                             "tsd.query.mesh.enable": False}))
    port = make_tsdb()
    assert set(port.rollup_lanes.collect_stats()) \
        == set(ref.rollup_lanes.collect_stats())
    assert set(port.rollup_lanes.collect_stats()) <= set(port.collect_stats())


def test_cost_model_terms():
    """The lane terms of ops/costmodel.py: the downsample stage prices
    order functions by K4's constant and moments by K1's, a rate adds a
    stage, and the lane assembly and block build are linear in cells."""
    from opentsdb_tpu_torch.ops import costmodel as cm
    moment = cm.stage_breakdown(1024, 65536, 283, 100, "avg", False)
    order = cm.stage_breakdown(1024, 65536, 283, 100, "p95", True)
    assert set(moment) == {"downsample", "groupby", "aggregate"}
    assert set(order) == set(moment) | {"rate"}
    assert order["downsample"] > moment["downsample"]
    assert cm.stage_breakdown(1, 1, 1, 1, None, False)["downsample"] > 0
    assert cm.predict_lane(100, 50, 4) == pytest.approx(
        2 * cm.predict_lane(100, 25, 4))
    assert cm.predict_lane_build(64, 10) == pytest.approx(
        cm.predict_lane_build(1, 640))
    assert cm.predict_host_build(10 ** 6) == pytest.approx(
        10 ** 6 * cm.CUDA_COSTS["host_build_point"])
