"""The device series cache (storage/device_cache.py) and G1, its gather,
against the reference's, on the CPU.

Each case of tests/test_device_cache.py is run here on three TSDBs that
hold the same state: the reference, the port, and the port with its cache
off.  The reference runs with ``tsd.query.batch.enable`` and
``tsd.query.mesh.enable`` off: with the batched arm on, its plan decision
never reaches the cache on a small query (ROADMAP C), and under conftest's
8 virtual CPU devices a query of >= 8 series would take the mesh.  Every
query checks that:

* ``deviceCacheHit`` and the cache's builds, hits, misses and evictions
  agree between the two packages;
* the port's answer matches the reference's, values at rtol 1e-9
  (torch_parity.RTOL) and timestamps exactly;
* the port's answer with its cache on equals its answer with the cache
  off, bit for bit.

Byte budgets are set from each package's own accounting: the reference
pads an entry to a power of two (at least 1024 points), the port holds
exactly the metric's points, 16 B a point.  Then every grouped query of
tests/test_torch_query_e2e.py, and every downsample function over an
all-integer metric near 2^53, runs with the cache (a hit) and without (a
miss) on the port.  Last, G1's plain version against the reference's
``_gather_windows`` on the same buffers.

Not mirrored here: the reference's streaming case
(``test_cached_metric_preempts_streaming``, mirrored in
tests/test_torch_streaming.py), its rollup-lane and pre-aggregate cases
(``test_rollup_lane_cached_separately``,
``test_pre_aggregate_lane_uses_its_own_entry``) and its int32
``ts_base`` pad contract (B10, not ported).
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.storage.device_cache import (
    DeviceSeriesCache as RefCache, _gather_windows as ref_gather_windows)
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops.pipeline import PAD_TS, build_batch_direct
from opentsdb_tpu_torch.storage.device_cache import (
    DeviceSeriesCache, gather_windows, gather_windows_plain)
from opentsdb_tpu_torch.storage.memstore import Series, SeriesKey
from opentsdb_tpu_torch.utils.config import Config

from test_torch_query_e2e import CASES, _ingest as e2e_ingest, _times
from torch_parity import ATOL, RTOL

BASE = 1_356_998_400
AUTO = {"tsd.core.auto_create_metrics": True}
# both packages price small plans onto the batched route, which skips the
# device cache's consult (plandecision.py), and consult the aggregate
# cache before it: the device cache's cases turn both off
NO_BATCH = {"tsd.query.batch.enable": False,
            "tsd.query.cache.enable": False}
REF_ONLY = {"tsd.query.mesh.enable": False}
OFF = {"tsd.query.device_cache.enable": False}
QUERY = "avg:1m-avg:dc.m{host=*}"


def _ingest(tsdb):
    """tests/test_device_cache.py's make_tsdb: two series of 40 points."""
    for i in range(40):
        tsdb.add_point("dc.m", BASE + i * 10, float(i), {"host": "a"})
        tsdb.add_point("dc.m", BASE + i * 10, float(i * 2), {"host": "b"})
    return tsdb


def _counts(cache):
    return (cache.builds, cache.hits, cache.misses, cache.evictions)


def _dps(results):
    return {tuple(sorted(r.tags.items())): r.dps for r in results}


def _run(tsdb, mod_query, parse, m, start, end):
    q = mod_query(start=str(start), end=str(end), queries=[parse(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    return runner.run(q), runner.exec_stats


def _bits(results) -> str:
    """The answers' JSON as text: equal text is equal bits (NaN too)."""
    return repr([r.to_json(ms_resolution=True, show_tsuids=True)
                 for r in results])


def _same_answer(port, ref):
    """Equal groups and timestamps, values at RTOL/ATOL (NaN = NaN)."""
    port, ref = _dps(port), _dps(ref)
    assert list(port) == list(ref)
    for key in ref:
        assert [t for t, _ in port[key]] == [t for t, _ in ref[key]], key
        for (_, a), (_, b) in zip(port[key], ref[key]):
            if isinstance(b, float) and math.isnan(b):
                assert math.isnan(a), key
            else:
                assert math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL), \
                    (key, a, b)


class Trio:
    """The same state in the reference, the port, and the port with its
    cache off; every mutation and query goes to all three."""

    def __init__(self, ingest=_ingest, **cfg):
        self.ref = ingest(RefTSDB(RefConfig({**AUTO, **NO_BATCH, **REF_ONLY,
                                             **cfg})))
        self.port = ingest(TSDB(Config({**AUTO, **NO_BATCH, **cfg}),
                                device="cpu"))
        self.plain = ingest(TSDB(Config({**AUTO, **NO_BATCH, **cfg, **OFF}),
                                 device="cpu"))

    def each(self, fn) -> None:
        for tsdb in (self.ref, self.port, self.plain):
            fn(tsdb)

    def query(self, m=QUERY, start=BASE, end=BASE + 400) -> bool:
        """Run `m` on all three and check them; True on a cache hit."""
        ref, ref_stats = _run(self.ref, RefTSQuery, ref_parse, m, start,
                              end)
        port, port_stats = _run(self.port, TSQuery, parse_m_subquery, m,
                                start, end)
        plain, plain_stats = _run(self.plain, TSQuery, parse_m_subquery, m,
                                  start, end)
        assert "deviceCacheHit" not in plain_stats
        assert port_stats.get("deviceCacheHit") \
            == ref_stats.get("deviceCacheHit")
        _same_answer(port, ref)
        assert _bits(port) == _bits(plain)
        if self.port.device_cache is not None:
            assert _counts(self.port.device_cache) \
                == _counts(self.ref.device_cache)
        self.last = port
        return port_stats.get("deviceCacheHit") == 1.0

    def refresh(self) -> int:
        done = self.port.device_cache.refresh()
        assert done == self.ref.device_cache.refresh(self.ref.store)
        return done

    def series(self, tsdb, host: str):
        metric = tsdb.metrics.get_id("dc.m")
        return next(s for s in tsdb.store.series_for_metric(metric)
                    if tsdb.resolve_key_tags(s.key)["host"] == host)


# -- tests/test_device_cache.py, case by case ------------------------------

def test_second_query_hits():
    trio = Trio()
    assert trio.query()          # the cold entry builds inline, then hits
    assert trio.query()
    assert _counts(trio.port.device_cache) == (1, 2, 0, 0)


def test_subset_filter_reuses_the_entry():
    trio = Trio()
    trio.query()
    assert trio.query("sum:1m-avg:dc.m{host=a}")
    assert trio.port.device_cache.builds == 1
    (dps,) = _dps(trio.last).values()
    assert dps[0][1] == np.mean([0, 1, 2, 3, 4, 5])


def test_window_narrowing_uses_the_entry():
    trio = Trio()
    trio.query()
    assert trio.query(start=BASE + 60, end=BASE + 180)
    assert trio.port.device_cache.builds == 1


def test_disabled_by_config():
    trio = Trio(**OFF)
    assert trio.port.device_cache is None and trio.ref.device_cache is None
    assert not trio.query()


def test_append_misses_then_refresh_hits():
    trio = Trio()
    trio.query()
    trio.each(lambda t: t.add_point("dc.m", BASE + 400, 99.0,
                                    {"host": "a"}))
    assert not trio.query(end=BASE + 401)    # stale: the host path
    a_dps = next(d for k, d in _dps(trio.last).items()
                 if dict(k)["host"] == "a")
    # the last 1m window holds i = 36..39 and the new 99
    assert a_dps[-1][1] == pytest.approx(49.8)
    assert trio.refresh() == 1
    assert trio.query(end=BASE + 401)
    assert _counts(trio.port.device_cache) == (2, 2, 1, 0)


def test_delete_range_misses_then_refresh_hits():
    trio = Trio()
    trio.query()
    trio.each(lambda t: trio.series(t, "b").delete_range(
        (BASE + 100) * 1000, (BASE + 150) * 1000))
    assert not trio.query()
    assert trio.refresh() == 1
    assert trio.query()


def test_new_series_invalidates():
    trio = Trio()
    trio.query()
    trio.each(lambda t: t.add_point("dc.m", BASE + 5, 7.0, {"host": "c"}))
    assert not trio.query()
    assert len(trio.last) == 3
    trio.refresh()
    assert trio.query()


def test_deleted_and_recreated_series_never_validates():
    trio = Trio()
    trio.query()

    def recreate(tsdb):
        old = trio.series(tsdb, "a")
        assert tsdb.store.get_series(old.key) is old
        assert tsdb.store.delete_series(old.key)
        assert tsdb.store.get_series(old.key) is None
        fresh = tsdb.store.get_or_create_series(old.key)
        for i in range(40):   # one append a point: the SAME version
            fresh.append(BASE * 1000 + i * 10_000, 5.0, False)
        assert fresh.version == old.version and fresh is not old
    trio.each(recreate)
    assert not trio.query()      # stale, not a false hit
    trio.refresh()
    assert trio.query()


def test_fix_duplicates_off_build_is_refused():
    def dup_ingest(tsdb):
        for v in (1.0, 2.0):
            tsdb.add_point("dup.m", BASE + 60, v, {"h": "x"})
        tsdb.add_point("dup.m", BASE + 10, 0.0, {"h": "x"})  # keep it dirty
        return tsdb
    trio = Trio(dup_ingest, **{"tsd.storage.fix_duplicates": "false"})
    for tsdb in (trio.ref, trio.port):
        metric = tsdb.metrics.get_id("dup.m")
        (series,) = tsdb.store.series_for_metric(metric)
        cache = tsdb.device_cache
        assert cache.fix_duplicates is False
        # the port's consult reads with the cache's own policy; the
        # reference's takes it again from its caller
        policy = {"fix_duplicates": False} if tsdb is trio.ref else {}
        got = cache.batch_for(tsdb.store, metric, [series], BASE * 1000,
                              (BASE + 100) * 1000, **policy)
        assert got is None and _counts(cache) == (0, 0, 1, 0)
        with pytest.raises(ValueError):   # the duplicate waits for fsck
            series.normalize(fix_duplicates=False)


@pytest.mark.parametrize("by_metric", [False, True])
def test_invalidate(by_metric):
    trio = Trio()
    trio.query()
    for tsdb in (trio.ref, trio.port):
        assert len(tsdb.device_cache) == 1
        tsdb.device_cache.invalidate(
            tsdb.metrics.get_id("dc.m") if by_metric else None)
        assert len(tsdb.device_cache) == 0
    assert trio.query()          # rebuilds inline
    assert trio.port.device_cache.builds == 2


def _direct(trio, ref_cache, port_cache):
    """batch_for on a cache of each package over its TSDB's dc.m series."""
    out = []
    for t, cache in ((trio.ref, ref_cache), (trio.port, port_cache)):
        metric = t.metrics.get_id("dc.m")
        series = t.store.series_for_metric(metric)
        out.append(cache.batch_for(t.store, metric, series, BASE * 1000,
                                   (BASE + 400) * 1000))
    assert _counts(ref_cache) == _counts(port_cache)
    return out


def test_oversized_metric_never_cached():
    trio = Trio()
    # 80 points: 1,280 B in the port, 1024 padded points (16 KiB) in the
    # reference; both over a 1 KiB budget
    ref_cache, port_cache = RefCache(max_bytes=1024), \
        DeviceSeriesCache(max_bytes=1024, device="cpu")
    assert _direct(trio, ref_cache, port_cache) == [None, None]
    assert port_cache.builds == 0


def test_build_max_points_gate():
    trio = Trio()
    got = _direct(trio,
                  RefCache(max_bytes=1 << 30, build_max_points=10),
                  DeviceSeriesCache(max_bytes=1 << 30, build_max_points=10,
                                    device="cpu"))
    assert got == [None, None]


def test_lru_eviction():
    def two_metrics(tsdb):
        for m in ("m.one", "m.two"):
            for i in range(16):
                tsdb.add_point(m, BASE + i * 10, float(i), {"h": "x"})
        return tsdb
    trio = Trio(two_metrics)
    # each budget fits exactly one entry of 16 points: 1024 padded points
    # in the reference, 16 points in the port
    caches = (RefCache(max_bytes=1024 * 16),
              DeviceSeriesCache(max_bytes=16 * 16, device="cpu"))
    for name in ("m.one", "m.two"):
        for t, cache in zip((trio.ref, trio.port), caches):
            metric = t.metrics.get_id(name)
            series = t.store.series_for_metric(metric)
            assert cache.batch_for(t.store, metric, series, BASE * 1000,
                                   (BASE + 200) * 1000) is not None
    for cache in caches:
        assert cache.evictions == 1 and len(cache) == 1
    assert _counts(caches[0]) == _counts(caches[1])
    assert caches[1].bytes_used == 16 * 16


def test_batch_expansion_guard():
    trio = Trio()
    port_cache = DeviceSeriesCache(max_bytes=1 << 30, batch_max_bytes=64,
                                   device="cpu")
    got = _direct(trio, RefCache(max_bytes=1 << 30, batch_max_bytes=64),
                  port_cache)
    assert got == [None, None]   # the batch would pass 64 B
    assert port_cache.builds == 1    # the entry itself was fine


def test_stats_surface():
    trio = Trio()
    trio.query()
    trio.query()
    ref, port = trio.ref.collect_stats(), trio.port.collect_stats()
    for key in ("hits", "misses", "builds", "evictions", "entries"):
        key = "tsd.query.device_cache." + key
        assert port[key] == ref[key]
    assert port["tsd.query.device_cache.entries"] == 1.0
    assert port["tsd.query.device_cache.builds"] == 1.0
    assert port["tsd.query.device_cache.bytes"] == 80 * 16
    assert port["tsd.storage.datapoints"] == ref["tsd.storage.datapoints"]
    assert "tsd.query.device_cache.hits" not in TSDB(
        Config(OFF), device="cpu").collect_stats()


def test_gather_matches_the_host_build():
    trio = Trio()
    t = trio.port
    metric = t.metrics.get_id("dc.m")
    series = sorted(t.store.series_for_metric(metric),
                    key=lambda s: s.key.tags)
    lo, hi = (BASE + 60) * 1000, (BASE + 180) * 1000
    got = t.device_cache.batch_for(t.store, metric, series, lo, hi)
    ts, val, mask, _ = build_batch_direct(series, lo, hi, True)
    for a, b in zip(got, (ts, val, mask)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_cache_lives_on_the_tsdb_device():
    """The cache has no device of its own to fall back to: it takes the
    TSDB's, and one made without a device is refused."""
    assert Trio().port.device_cache.device == torch.device("cpu")
    with pytest.raises(TypeError):
        DeviceSeriesCache(max_bytes=1 << 30)


def test_maintenance_thread_rebuilds_a_stale_entry():
    """reference tests/test_maintenance.py's thread cadence, driving
    core/maintenance.py:122's pass: a query that finds the entry stale
    misses and queues it, the thread rebuilds it, the next query hits."""
    from opentsdb_tpu.core.maintenance import MaintenanceThread as RefThread
    from opentsdb_tpu_torch.core.maintenance import MaintenanceThread
    import time
    trio = Trio()
    trio.query()
    trio.each(lambda t: t.add_point("dc.m", BASE + 400, 99.0,
                                    {"host": "a"}))
    assert not trio.query(end=BASE + 401)
    for tsdb, cls in ((trio.ref, RefThread), (trio.port, MaintenanceThread)):
        thread = cls(tsdb)
        thread.TICK_SECONDS = 0.02
        thread.start()
        try:
            deadline = time.time() + 30.0
            while tsdb.device_cache.builds < 2 and time.time() < deadline:
                time.sleep(0.02)
        finally:
            thread.stop()
        assert thread.device_cache_refreshes == 1 and not thread.is_alive()
    assert trio.query(end=BASE + 401)
    assert _counts(trio.port.device_cache) == (2, 2, 1, 0)


def test_shutdown_stops_maintenance():
    """reference tests/test_maintenance.py test_stats_exposed and
    test_shutdown_stops_thread, for the port's one pass."""
    tsdb = TSDB(Config(AUTO), device="cpu")
    assert tsdb.maintenance is None
    thread = tsdb.start_maintenance()
    assert tsdb.start_maintenance() is thread and thread.is_alive()
    assert tsdb.collect_stats()[
        "tsd.maintenance.device_cache_refreshes"] == 0.0
    tsdb.shutdown()
    assert not thread.is_alive() and tsdb.maintenance is None
    tsdb.shutdown()
    assert "tsd.maintenance.device_cache_refreshes" \
        not in tsdb.collect_stats()


def test_concurrent_queries_share_one_entry():
    """Eight threads query one cold metric at once: a build in flight
    makes the others miss to the host path, a thread that saw no entry
    just before the build landed takes that entry, so the metric is built
    exactly once; every consult is counted once, one entry stays, and
    every answer is the uncached one."""
    import sys
    import threading
    trio = Trio()
    want = _bits(_run(trio.plain, TSQuery, parse_m_subquery, QUERY, BASE,
                      BASE + 400)[0])
    answers, errors = [], []

    def worker():
        try:
            for _ in range(5):
                res, _ = _run(trio.port, TSQuery, parse_m_subquery, QUERY,
                              BASE, BASE + 400)
                answers.append(_bits(res))
        except Exception as e:     # reported below, in the main thread
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert answers == [want] * 40
    cache = trio.port.device_cache
    assert cache.builds == 1 and cache.hits + cache.misses == 40
    assert cache.hits >= 1 and len(cache) == 1
    assert cache.bytes_used == 80 * 16


def test_load_state_leaves_versions_the_cache_validates():
    from opentsdb_tpu_torch.core import load_state
    src = Trio().port
    uid_maps = {kind: src.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in src.store.all_series()]
    tsdb = load_state(uid_maps, series, config=Config(NO_BATCH),
                      device="cpu")
    assert all(s.version == 1 for s in tsdb.store.all_series())
    answers = []
    for _ in range(2):
        res, stats = _run(tsdb, TSQuery, parse_m_subquery, QUERY, BASE,
                          BASE + 400)
        assert stats.get("deviceCacheHit") == 1.0
        answers.append(_bits(res))
    res, _ = _run(src, TSQuery, parse_m_subquery, QUERY, BASE, BASE + 400)
    assert answers == [_bits(res)] * 2
    assert _counts(tsdb.device_cache) == (1, 2, 0, 0)


def test_entry_does_not_alias_the_store():
    """The build reads each series' live columns inside its lock hold
    into buffers of its own: a later in-place sort of the store's buffers
    leaves the entry as it was."""
    t = Trio().port
    metric = t.metrics.get_id("dc.m")
    series = t.store.series_for_metric(metric)
    lo, hi = BASE * 1000, (BASE + 400) * 1000
    before = [x.clone() for x in t.device_cache.batch_for(
        t.store, metric, series, lo, hi)]
    (entry,) = t.device_cache._entries.values()
    ts_buf, val_buf = entry.ts_dev.clone(), entry.val_dev.clone()
    for s in series:     # out of order: the next read sorts in place
        s.append(lo - 5_000, -1.0, False)
        s.normalize()
    assert torch.equal(entry.ts_dev, ts_buf)
    assert torch.equal(entry.val_dev, val_buf)
    t.device_cache.invalidate()
    after = t.device_cache.batch_for(t.store, metric, series, lo, hi)
    assert [torch.equal(a, b) for a, b in zip(before, after)] \
        == [True] * 3   # the window [lo, hi] holds none of the new points


def test_snapshot_copies_with_the_given_copy():
    s = Series(SeriesKey.make(1, {1: 1}))
    s.append_batch(np.array([3000, 1000, 2000]), np.array([3., 1., 2.]),
                   False)
    ts, val, version = s.snapshot(copy=lambda col: col.tolist())
    assert (ts, val, version) == ([1000, 2000, 3000], [1., 2., 3.],
                                  s.version)


# -- the content version -------------------------------------------------

def test_every_visible_mutation_bumps_the_version():
    s = Series(SeriesKey.make(1, {1: 1}))
    steps = [
        lambda: s.append(2000, 1.0, False),
        lambda: s.append_batch(np.array([3000, 4000]), np.array([2., 3.]),
                               False),
        lambda: s.append(3000, 9.0, False),      # a duplicate, out of order
        lambda: s.normalize(fix_duplicates=True),    # dedup
        lambda: s.delete_range(4000, 4000),
        lambda: s.restore_arrays(np.array([1, 2]), np.array([1., 2.]),
                                 np.zeros(2, np.int64), np.zeros(2, bool)),
    ]
    for step in steps:
        before = s.version
        step()
        assert s.version == before + 1
    before = s.version
    s.append(0, 7.0, False)          # out of order, no duplicate
    ts, val, version = s.snapshot()  # the sort changes no visible data
    assert version == before + 1
    assert ts.tolist() == [0, 1, 2] and val.tolist() == [7.0, 1.0, 2.0]
    assert s.window_bounds(1, 2) == (1, 3, version)
    assert s.delete_range(50, 60) == 0 and s.version == version


# -- hit against miss, every grouped query -------------------------------

@pytest.fixture(scope="module")
def hit_and_miss():
    return (e2e_ingest(TSDB(Config({**AUTO, **NO_BATCH}), device="cpu")),
            e2e_ingest(TSDB(Config({**AUTO, **NO_BATCH, **OFF}),
                            device="cpu")))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_hit_equals_miss(hit_and_miss, case):
    m, start, end = case
    start, end = _times(start, end)
    hit, hit_stats = _run(hit_and_miss[0], TSQuery, parse_m_subquery, m,
                          start, end)
    miss, miss_stats = _run(hit_and_miss[1], TSQuery, parse_m_subquery, m,
                            start, end)
    assert hit_stats.get("deviceCacheHit") == 1.0
    assert "deviceCacheHit" not in miss_stats
    assert hit and _bits(hit) == _bits(miss)


INT_FUNCS = ["sum", "avg", "dev", "min", "max", "count", "squareSum",
             "median", "p99", "p95", "ep99r7", "ep50r3", "mult", "first",
             "last", "diff", "movingAverage2"]


def _big_ingest(tsdb):
    """An all-integer metric near 2^53: odd values do not fit a float64,
    so a hit (the float lane) and a miss (int64 values) start apart."""
    rng = np.random.default_rng(5)
    dps = [{"metric": "big.int", "timestamp": BASE + 10 * k + h,
            "value": int(2**53 + int(rng.integers(-3000, 3000))),
            "tags": {"host": "b%d" % h, "dc": "d%d" % (h % 2)}}
           for h in range(4) for k in range(60)]
    ok, errors = tsdb.add_points_bulk(dps)
    assert errors == [] and ok == len(dps)
    return tsdb


@pytest.fixture(scope="module")
def big_int():
    return Trio(_big_ingest)


def _exact_dev(tsdb, start_ms, end_ms):
    """Per dc and 1m window, the sum of its members' dev over their float64
    values, in exact arithmetic."""
    out = {}
    for s in tsdb.store.all_series():
        ts, fval, _, _ = s.arrays()
        dc = tsdb.resolve_key_tags(s.key)["dc"]
        for w in range(start_ms, end_ms, 60_000):
            vals = [Fraction(float(v)) for v in
                    fval[(ts >= w) & (ts < w + 60_000)]]
            mean = sum(vals) / len(vals)
            var = sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
            out[(dc, w)] = out.get((dc, w), 0.0) + math.sqrt(var)
    return out


@pytest.mark.parametrize("func", INT_FUNCS)
def test_all_integer_metric_near_2_53_hit_equals_miss(big_int, func):
    m = "sum:1m-%s:big.int{dc=*}" % func
    end = BASE + 600
    if func != "dev":
        assert big_int.query(m, end=end)
        return
    # dev: hit and miss are equal bit for bit, but over values near 2^53
    # the two packages' devs lie apart (ROADMAP C).  Against the exact dev
    # over the float64 values the port is within 1e-6 and the reference
    # within 1e-4 (its error here reaches 1.6e-5).
    port, stats = _run(big_int.port, TSQuery, parse_m_subquery, m, BASE, end)
    plain, _ = _run(big_int.plain, TSQuery, parse_m_subquery, m, BASE, end)
    ref, _ = _run(big_int.ref, RefTSQuery, ref_parse, m, BASE, end)
    assert stats.get("deviceCacheHit") == 1.0
    assert _bits(port) == _bits(plain)
    exact = _exact_dev(big_int.port, BASE * 1000, end * 1000)
    for results, rtol in ((port, 1e-6), (ref, 1e-4)):
        for r in results:
            for t, v in r.dps:
                want = exact[(r.tags["dc"], t)]
                assert math.isclose(v, want, rel_tol=rtol), (t, v, want)


# -- G1 against the reference's gather -----------------------------------

def _gather_case(rng):
    p = 500
    ts_buf = np.cumsum(rng.integers(1, 5000, p)).astype(np.int64) \
        + BASE * 1000
    val_buf = rng.normal(0.0, 1e3, p)
    starts = np.array([0, 37, 120, 120, 300, 480, 499, p - 64, 5],
                      np.int64)
    lengths = np.array([10, 0, 64, 1, 0, 20, 1, 64, 0], np.int64)
    return ts_buf, val_buf, starts, lengths


@pytest.mark.parametrize("n", [64, 80])
def test_gather_plain_matches_the_reference(n):
    """Rows of every length, zero-length rows and rows that end at the
    buffer's end; n = 80 leaves every row padded."""
    ts_buf, val_buf, starts, lengths = _gather_case(
        np.random.default_rng(n))
    want = ref_gather_windows(jnp.asarray(ts_buf), jnp.asarray(val_buf),
                              starts, lengths, n)
    got = gather_windows(torch.from_numpy(ts_buf), torch.from_numpy(val_buf),
                         torch.from_numpy(starts), torch.from_numpy(lengths),
                         n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts, val, mask = (x.numpy() for x in got)
    assert (ts[~mask] == PAD_TS).all() and (val[~mask] == 0.0).all()
    assert mask.sum() == lengths.sum()


def test_gather_plain_clamps_like_the_reference():
    ts_buf, val_buf, _, _ = _gather_case(np.random.default_rng(1))
    starts = np.array([490, -3], np.int64)     # runs past either end
    lengths = np.array([30, 5], np.int64)
    want = ref_gather_windows(jnp.asarray(ts_buf), jnp.asarray(val_buf),
                              starts, lengths, 32)
    got = gather_windows_plain(torch.from_numpy(ts_buf),
                               torch.from_numpy(val_buf),
                               torch.from_numpy(starts),
                               torch.from_numpy(lengths), 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gather_checks_its_inputs():
    buf = torch.zeros(4, dtype=torch.int64)
    runs = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        gather_windows(buf, buf, runs, runs, 2)        # int64 values
    with pytest.raises(ValueError):
        gather_windows(buf, buf.double()[:3], runs, runs, 2)
    ts, val, mask = gather_windows(buf[:0], buf[:0].double(), runs, runs, 3)
    assert (ts == PAD_TS).all() and not mask.any() and ts.shape == (2, 3)
