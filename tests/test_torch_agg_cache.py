"""The aggregate cache (storage/agg_cache.py) against the reference's, on
the CPU: the cases of tests/test_agg_cache.py.

Each case runs the same properties (and ``tsd.query.mesh.enable`` off on
the reference) and the same data through both packages.  A query's
answer must agree with the reference's (values at rtol 1e-9, timestamps
and groups exactly), and the two must take the same arm: the same
windows served from blocks and computed (``aggCacheHitWindows``,
``aggCacheComputedWindows``) and the same populated count.  Within the
port the contract is bit identity: cold, warm and recomputed answers are
equal bit for bit, and so are the cache on and off on the same data (K1
and K4 reduce each window's run in row order, whatever precedes it).

Not carried over: ``test_gutting_the_agg_invalidator_fails_lint`` (the
reference's lint scans only opentsdb_tpu/), ``test_mode_policy_epoch_keys
_blocks`` (the port has no kernel modes; blocks are keyed on the
platform), the prometheus family test (slice 8d) and the at-scale speed
test.
"""

import math
import threading

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.tsd.admission import (
    estimate_plan_cost_ms as ref_estimate)
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.storage.agg_cache import (
    _MARK_RING, AggregateCache, _Block)
from opentsdb_tpu_torch.tsd.admission import estimate_plan_cost_ms
from opentsdb_tpu_torch.utils.config import Config

from torch_parity import ATOL, RTOL

BASE = 1_356_998_400
PROPS = {
    "tsd.core.auto_create_metrics": True,
    "tsd.storage.fix_duplicates": True,
    "tsd.query.cache.block_windows": 8,
    "tsd.query.cache.min_repeats": 1,
    # test-size plans sit at the dispatch floor, where the cost model
    # rightly declines to cache: no per-dispatch charge, so the decision
    # is the repeat gate's
    "tsd.query.cache.dispatch_overhead_us": 0,
}
OFF = {"tsd.query.cache.enable": False}
AGG_KEYS = ("aggCacheHitWindows", "aggCacheComputedWindows", "aggCacheHit")
N = 3000
SUM = "sum:60s-sum:sys.i{host=*}"


def feed_float(tsdb, n=N, hosts=("a", "b"), seed=3):
    rng = np.random.default_rng(seed)
    for host in hosts:
        key = tsdb._series_key("sys.f", {"host": host}, create=True)
        ts = (np.arange(n, dtype=np.int64) * 2 + BASE) * 1000
        tsdb.store.add_batch(key, ts, rng.standard_normal(n), False)


def feed_int(tsdb, n=N, hosts=("a", "b"), metric="sys.i"):
    for host in hosts:
        key = tsdb._series_key(metric, {"host": host}, create=True)
        ts = (np.arange(n, dtype=np.int64) * 2 + BASE) * 1000
        vals = (np.arange(n, dtype=np.int64) * 7) % 101
        tsdb.store.add_batch(key, ts, vals, True)


def _run(tsdb, query_cls, parse, m, start, end):
    q = query_cls(start=str(start), end=str(end),
                  queries=[parse(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    out = [r.to_json(ms_resolution=True) for r in runner.run(q)]
    return out, dict(runner.exec_stats)


def run_q(tsdb, m, start=BASE, end=BASE + 2 * N):
    return _run(tsdb, TSQuery, parse_m_subquery, m, start, end)


def _same(got, want):
    assert [(g["tags"], list(g["dps"])) for g in got] \
        == [(w["tags"], list(w["dps"])) for w in want]
    for g, w in zip(got, want):
        for k, b in w["dps"].items():
            a = g["dps"][k]
            if b is None or (isinstance(b, float) and math.isnan(b)):
                assert a is None or math.isnan(a)
            else:
                assert math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL)


class Pair:
    """The reference and the port over the same properties and data; a
    query runs on both, their answers and arms held together."""

    def __init__(self, feed=feed_int, **over):
        props = {**PROPS, **over}
        self.ref = RefTSDB(RefConfig({**props,
                                      "tsd.query.mesh.enable": False}))
        self.port = TSDB(Config(props), device="cpu")
        for t in (self.ref, self.port):
            feed(t)

    def each(self, fn):
        for t in (self.ref, self.port):
            fn(t)

    def query(self, m=SUM, start=BASE, end=BASE + 2 * N):
        want, ref_stats = _run(self.ref, RefTSQuery, ref_parse, m, start,
                               end)
        got, stats = run_q(self.port, m, start, end)
        _same(got, want)
        assert {k: stats.get(k) for k in AGG_KEYS} \
            == {k: ref_stats.get(k) for k in AGG_KEYS}, (stats, ref_stats)
        return got, stats

    def populated(self):
        key = "tsd.query.agg_cache.populated"
        n = self.port.agg_cache.collect_stats()[key]
        assert n == self.ref.agg_cache.collect_stats()[key]
        return n


# -- bit identity ------------------------------------------------------

def test_cold_warm_and_recompute_bitwise_on_floats():
    pair = Pair(feed=feed_float)
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_float(off)
    m = "sum:60s-sum:sys.f{host=*}"
    cold, s_cold = pair.query(m)          # populates (min_repeats=1)
    warm, s_warm = pair.query(m)
    warm2, _ = pair.query(m)
    assert s_cold.get("aggCacheComputedWindows", 0) > 0
    assert s_warm.get("aggCacheHitWindows", 0) > 0
    assert cold == warm == warm2          # float answers, bit for bit
    pair.each(lambda t: t.agg_cache.invalidate())
    recomputed, s_re = pair.query(m)
    assert s_re.get("aggCacheComputedWindows", 0) > 0
    assert recomputed == cold
    # the port's pieces reduce each window as the monolithic launch does
    assert run_q(off, m)[0] == cold


def test_pieces_do_not_depend_on_the_batch_source():
    """A piece's batch from the device cache (its entry warm) and from the
    host build (the cache off) give the same block bits."""
    warm_cache = TSDB(Config({**PROPS, "tsd.query.batch.enable": False}),
                      device="cpu")
    no_cache = TSDB(Config({**PROPS, "tsd.query.device_cache.enable":
                            False}), device="cpu")
    m = "max:60s-p95:sys.f{host=*}"
    for t in (warm_cache, no_cache):
        feed_float(t)
    metric = warm_cache.metrics.get_id("sys.f")
    warm_cache.device_cache.batch_for(
        warm_cache.store, metric,
        warm_cache.store.series_for_metric(metric), BASE * 1000,
        (BASE + 2 * N) * 1000)                          # builds the entry
    hits0 = warm_cache.device_cache.hits
    got, stats = run_q(warm_cache, m)
    assert stats.get("aggCacheComputedWindows", 0) > 0
    assert warm_cache.device_cache.hits > hits0          # pieces gathered
    assert got == run_q(no_cache, m)[0]


@pytest.mark.parametrize("m", [
    "sum:60s-sum:sys.i{host=*}",
    "sum:60s-count:sys.i",
    "max:60s-max:sys.i{host=*}",
    "min:60s-min:sys.i",
    "sum:60s-last:sys.i{host=*}",
    "sum:rate:60s-sum:sys.i{host=*}",
])
def test_enabled_equals_disabled_bitwise_on_ints(m):
    pair = Pair()
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_int(off)
    pair.query(m)                        # populate
    warm, s = pair.query(m)
    assert s.get("aggCacheHitWindows", 0) > 0
    assert warm == run_q(off, m)[0]


@pytest.mark.parametrize("m", [
    "sum:60s-movingAverage3:sys.i{host=*}",
    "max:60s-movingAverage:sys.i",
])
def test_moving_average_downsample_enabled_equals_disabled(m):
    """A movingAverage<N> downsample is never rewritten: a piece's average
    would restart without the N - 1 windows before it.  The port with the
    cache on answers repeats bit for bit as with it off.  The reference
    rewrites it and answers a warm repeat differently (ROADMAP queue C,
    a deliberate difference)."""
    pair = Pair()
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_int(off)
    want = run_q(off, m)[0]
    ref_off = RefTSDB(RefConfig({**PROPS, **OFF,
                                 "tsd.query.mesh.enable": False}))
    feed_int(ref_off)
    for _ in range(3):
        got, stats = run_q(pair.port, m)
        assert got == want
        assert not any(k in stats for k in AGG_KEYS)
        ref_warm, ref_stats = _run(pair.ref, RefTSQuery, ref_parse, m, BASE,
                                   BASE + 2 * N)
    assert pair.port.agg_cache.collect_stats()[
        "tsd.query.agg_cache.populated"] == 0
    assert ref_stats.get("aggCacheHitWindows", 0) > 0
    assert ref_warm != _run(ref_off, RefTSQuery, ref_parse, m, BASE,
                            BASE + 2 * N)[0]


def test_unaligned_and_sliding_ranges():
    """Edge windows recompute a query; interior blocks serve overlapping
    (sliding) ranges, and every answer equals the cache off."""
    pair = Pair()
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_int(off)
    ranges = [(BASE + 7, BASE + 5003), (BASE + 607, BASE + 5603),
              (BASE + 1207, BASE + 5999)]
    pair.query(SUM, *ranges[0])
    for start, end in ranges:
        got, stats = pair.query(SUM, start, end)
        assert got == run_q(off, SUM, start, end)[0], (start, end)
    assert stats.get("aggCacheHitWindows", 0) > 0


# -- invalidation ------------------------------------------------------

def test_acked_write_never_served_stale():
    pair = Pair()
    for _ in range(3):
        pair.query()                     # fully warm
    pair.each(lambda t: t.add_point("sys.i", BASE + 3000, 424242,
                                    {"host": "a"}))
    got, stats = pair.query()
    assert 424242 <= max(v for r in got for v in r["dps"].values())
    # only the dirtied block recomputed: history still serves
    assert stats.get("aggCacheHitWindows", 0) > 0
    assert stats.get("aggCacheComputedWindows", 0) > 0


def test_delete_and_new_series_invalidate():
    pair = Pair()
    for _ in range(2):
        pair.query()

    def grow(t):
        for i in range(0, 2 * N, 10):
            t.add_point("sys.i", BASE + i, 5, {"host": "c"})

    pair.each(grow)                      # a series born after the blocks
    got, _ = pair.query()
    assert {r["tags"]["host"] for r in got} == {"a", "b", "c"}
    pair.each(lambda t: t.store.delete_series(
        t._series_key("sys.i", {"host": "c"}, create=False)))
    got, _ = pair.query()
    assert {r["tags"]["host"] for r in got} == {"a", "b"}


def test_mark_ring_overflow_invalidates_conservatively():
    cache = AggregateCache(Config({}), "cpu")
    store = object()
    entry = _Block(store=store, metric=1, rows={}, val=np.zeros((1, 8)),
                   mask=np.zeros((1, 8), bool), gen=0, lo_ms=0,
                   hi_ms=7999)
    with cache._lock:
        assert cache._valid_locked(entry)
    for i in range(_MARK_RING + 50):
        # distinct ranges far from the entry; a plan snapshot between
        # marks defeats the coalescing
        with cache._lock:
            cache._planned_gen = cache._gen
        cache.invalidate(store=store, metric=1, lo_ms=10_000_000 + i * 10,
                         hi_ms=10_000_000 + i * 10 + 5)
    with cache._lock:
        assert not cache._valid_locked(entry)


def test_marks_coalesce_until_a_plan_snapshots():
    cache = AggregateCache(Config({}), "cpu")
    store = object()
    for i in range(5):
        cache.invalidate(store=store, metric=1, lo_ms=i, hi_ms=i)
    assert cache.invalidations == 1
    assert list(cache._marks[(id(store), 1)]) == [(1, 0, 4)]


# -- policy ------------------------------------------------------------

def test_min_repeats_gates_materialization():
    pair = Pair(**{"tsd.query.cache.min_repeats": 3})
    pair.query()
    pair.query()
    assert pair.populated() == 0
    pair.query()                         # the third sight populates
    assert pair.populated() > 0


def test_dispatch_floor_plans_honestly_refuse():
    pair = Pair(feed=lambda t: feed_int(t, n=300),
                **{"tsd.query.cache.dispatch_overhead_us": 100000})
    for _ in range(3):
        _, stats = pair.query(SUM, BASE, BASE + 600)
    assert "aggCacheHitWindows" not in stats
    assert pair.populated() == 0


def test_a_device_cache_hit_is_priced_as_a_hit():
    """With the metric's entry on the device, the recompute is a hit: no
    host build, one consult over the series.  Each piece a rewrite
    computes pays a consult of its own, so at 64 series the hit stays the
    route, even with every block cached; without the entry the same plan
    populates and replays."""
    props = {**PROPS, "tsd.query.batch.enable": False,
             "tsd.query.cache.dispatch_overhead_us": 150}
    hosts = tuple("h%02d" % i for i in range(64))
    tsdb = TSDB(Config(props), device="cpu")
    off = TSDB(Config({**props, **OFF}), device="cpu")
    for t in (tsdb, off):
        feed_int(t, hosts=hosts)
    want = run_q(off, SUM)[0]

    def run():
        runner = tsdb.new_query_runner()
        q = TSQuery(start=str(BASE), end=str(BASE + 2 * N),
                    queries=[parse_m_subquery(SUM)])
        q.validate()
        assert [r.to_json(ms_resolution=True) for r in runner.run(q)] \
            == want
        return runner.decisions[0], runner.exec_stats

    dc = tsdb.device_cache
    tsdb.device_cache = None
    for reason in ("cold_populate", "reuse"):
        pd, _ = run()
        assert (pd.path, pd.agg_note["reason"]) == ("agg_rewrite", reason)
    tsdb.device_cache = dc
    metric = tsdb.metrics.get_id("sys.i")
    dc.batch_for(tsdb.store, metric, tsdb.store.series_for_metric(metric),
                 BASE * 1000, (BASE + 2 * N) * 1000)       # the entry
    assert dc.holds(tsdb.store, metric)
    for _ in range(2):
        pd, stats = run()
        assert pd.path == "resident"
        assert stats.get("deviceCacheHit") == 1.0
        assert pd.agg_note["reason"] == "recompute_cheaper"
        assert pd.agg_note["predictedFullMs"] \
            < pd.agg_note["predictedRewriteMs"]


def test_eviction_under_byte_budget():
    tsdb = TSDB(Config({**PROPS, "tsd.query.cache.mb": 1}), device="cpu")
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    ts = (np.arange(2000, dtype=np.int64) + BASE) * 1000
    # 64-series x 8-window blocks are ~4.6 KB; 24 metrics of 12 full
    # blocks are ~1.3 MB, past the 1 MB budget
    for g in range(24):
        for t in ((tsdb, off) if g == 0 else (tsdb,)):
            for host in range(64):
                key = t._series_key("evict.m%d" % g, {"h": str(host)},
                                    create=True)
                t.store.add_batch(key, ts, np.arange(2000, dtype=np.int64),
                                  True)
        run_q(tsdb, "sum:20s-sum:evict.m%d{h=*}" % g, BASE, BASE + 2000)
    stats = tsdb.agg_cache.collect_stats()
    assert stats["tsd.query.agg_cache.bytes"] <= 2 ** 20
    assert stats["tsd.query.agg_cache.evictions"] > 0
    m = "sum:20s-sum:evict.m0{h=*}"
    assert run_q(tsdb, m, BASE, BASE + 2000)[0] \
        == run_q(off, m, BASE, BASE + 2000)[0]


def test_device_tier_promotes_hot_blocks():
    pair = Pair(**{"tsd.query.cache.promote_hits": 2})
    results = [pair.query()[0] for _ in range(3)]
    # the maintenance thread's pass, standing in for its tick
    assert pair.port.agg_cache.promote_pending(max_uploads=64) \
        == pair.ref.agg_cache.promote_pending(max_uploads=64) > 0
    stats = pair.port.agg_cache.collect_stats()
    assert stats["tsd.query.agg_cache.device_bytes"] > 0
    got, s = pair.query()
    assert got == results[1] == results[2]
    assert s.get("aggCacheHitWindows", 0) > 0
    # a narrower row set replays a device block through index_select
    narrow, _ = pair.query("sum:60s-sum:sys.i{host=a}")
    assert narrow == [r for r in got if r["tags"]["host"] == "a"]


def test_maintenance_thread_promotes(monkeypatch):
    from opentsdb_tpu_torch.core.maintenance import MaintenanceThread
    monkeypatch.setattr(MaintenanceThread, "TICK_SECONDS", 0.02)
    tsdb = TSDB(Config({**PROPS, "tsd.query.cache.promote_hits": 1}),
                device="cpu")
    feed_int(tsdb)
    for _ in range(2):
        run_q(tsdb, SUM)
    tsdb.start_maintenance()
    try:
        import time
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and tsdb.agg_cache.collect_stats()[
                "tsd.query.agg_cache.device_bytes"] == 0:
            time.sleep(0.02)
    finally:
        tsdb.shutdown()
    assert tsdb.agg_cache.collect_stats()[
        "tsd.query.agg_cache.device_bytes"] > 0


def test_consulted_but_recomputed_plans_never_promote():
    pair = Pair(**{"tsd.query.cache.promote_hits": 1})
    pair.query()                         # populate (a cold serve)

    def refuse(t):
        t.agg_cache.dispatch_overhead_s = 10.0
        t.add_point("sys.i", BASE + 3000, 1, {"host": "a"})

    pair.each(refuse)
    for _ in range(3):
        _, s = pair.query()
    assert "aggCacheHitWindows" not in s
    assert pair.port.agg_cache.promote_pending(max_uploads=64) == 0


def test_admission_estimate_prices_the_rewritten_plan():
    pair = Pair()

    def parsed(query_cls, parse):
        q = query_cls(start=str(BASE), end=str(BASE + 2 * N),
                      queries=[parse(SUM)])
        q.validate()
        return q

    cold = estimate_plan_cost_ms(pair.port, parsed(TSQuery,
                                                   parse_m_subquery))
    ref_cold = ref_estimate(pair.ref, parsed(RefTSQuery, ref_parse))
    pair.query()
    pair.query()
    warm = estimate_plan_cost_ms(pair.port, parsed(TSQuery,
                                                   parse_m_subquery))
    ref_warm = ref_estimate(pair.ref, parsed(RefTSQuery, ref_parse))
    assert cold > 0 and ref_cold > 0
    assert warm < cold and ref_warm < ref_cold


# -- degraded queries --------------------------------------------------

def _coarsened(query_cls, parse, start=BASE):
    q = query_cls(start=str(start), end=str(BASE + 2 * N),
                  queries=[parse(SUM)])
    q.validate()
    sub = q.queries[0]
    sub.downsample_spec.interval_ms *= 2       # the ladder's rung 1
    sub.downsample = "120000ms-sum"
    return q


def test_coarsened_spec_is_its_own_family():
    pair = Pair()
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_int(off)
    for _ in range(3):
        out = [r.to_json() for r in pair.port.new_query_runner().run(
            _coarsened(TSQuery, parse_m_subquery))]
        [r.to_json() for r in pair.ref.new_query_runner().run(
            _coarsened(RefTSQuery, ref_parse))]
    got, stats = pair.query()
    assert got == run_q(off, SUM)[0]
    assert "aggCacheHitWindows" not in stats   # the 60s family's first
    again = [r.to_json() for r in pair.port.new_query_runner().run(
        _coarsened(TSQuery, parse_m_subquery))]
    assert again == out


def test_truncated_run_never_pollutes_the_full_range():
    pair = Pair()
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_int(off)
    for _ in range(3):                   # the ladder's rung 2
        pair.query(SUM, BASE + 3000)
    got, _ = pair.query()
    assert got == run_q(off, SUM)[0]


# -- concurrency -------------------------------------------------------

def test_ingest_vs_cached_query_race():
    """Writers against warm cached queries: once the writes are acked,
    the answer equals a cache-off TSDB that took the same writes."""
    on = TSDB(Config(PROPS), device="cpu")
    off = TSDB(Config({**PROPS, **OFF}), device="cpu")
    feed_int(on, n=2000)
    feed_int(off, n=2000)
    end = BASE + 4000
    for _ in range(2):
        run_q(on, SUM, BASE, end)
    errors = []

    def ingest(host):
        try:
            for i in range(200):
                for t in (on, off):
                    t.add_point("sys.i", BASE + (i * 13) % 4000, i,
                                {"host": host})
        except Exception as e:  # pragma: no cover - fails the test
            errors.append(e)

    def reader():
        try:
            for _ in range(10):
                run_q(on, SUM, BASE, end)
        except Exception as e:  # pragma: no cover - fails the test
            errors.append(e)

    threads = [threading.Thread(target=ingest, args=("a",)),
               threading.Thread(target=ingest, args=("b",)),
               threading.Thread(target=reader),
               threading.Thread(target=reader)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert run_q(on, SUM, BASE, end)[0] == run_q(off, SUM, BASE, end)[0]


# -- the routing verdict -----------------------------------------------

def test_the_agg_arm_is_chosen_where_the_reference_chooses_it():
    """The verdict's path and its fingerprint's aggCache field, with the
    batched arm on in both (the rewrite is priced before it)."""
    pair = Pair(**{"tsd.query.cache.min_repeats": 2})
    paths = []
    for _ in range(3):
        _, ref_stats = _run(pair.ref, RefTSQuery, ref_parse, SUM, BASE,
                            BASE + 2 * N)
        runner = pair.port.new_query_runner()
        q = TSQuery(start=str(BASE), end=str(BASE + 2 * N),
                    queries=[parse_m_subquery(SUM)])
        q.validate()
        runner.run(q)
        assert {k: runner.exec_stats.get(k) for k in AGG_KEYS} \
            == {k: ref_stats.get(k) for k in AGG_KEYS}
        pd = runner.decisions[0]
        paths.append(pd.path)
        if pd.path == "agg_rewrite":
            assert pd.fp_fields["aggCache"]["reason"] in ("reuse",
                                                          "cold_populate")
            assert pd.agg_note["decision"] == "rewrite"
    # the first sight is below min_repeats: neither package rewrites
    assert paths[0] != "agg_rewrite"
    assert paths[1:] == ["agg_rewrite"] * 2
