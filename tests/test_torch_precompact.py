"""B10's int32 form on the CPU: the device cache's re-based gather (G1)
and the int32 forms of K1 and K4, against the reference.

* ``precompact_base`` on fixed, calendar and run-all grids and on either
  side of the 2^31 boundary, as the reference's (ops/downsample.py:498).
* The int32 gather (``gather_windows(..., ts_base)``) equals the
  reference's ``_gather_windows(..., ts_base)`` exactly.
* The int32 plain K1 and K4 agree with the reference's downsample over
  the same int32 batch with ``wargs["ts_base"]`` at rtol 1e-9, and equal
  the port's own int64 form bit for bit.
* The sentinels are the reference's; the batch budget prices 13 bytes a
  slot with a base; a stale base saturates the edges and drops points.
* A grouped query through both TSDBs hits the device cache with the base,
  and its answer equals a miss.
* The wide-dynamic-range case (ROADMAP queue C): K1 and K4 hold exact
  values in both forms where the reference's prefix differences lose
  digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.storage import device_cache as ref_dc
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.storage import device_cache as dc
from opentsdb_tpu_torch.utils.config import Config

from torch_parity import assert_exact, assert_values, sorted_batch, t

T0 = 1_356_998_400_000
BASE = T0 // 1000
MOMENTS = ["sum", "count", "avg", "min", "max", "dev", "squareSum"]
ORDERS = ["first", "last", "diff", "mult", "median", "p95", "ep99r7"]


def test_sentinels_are_the_reference_pair():
    assert tds.I32_PAD_TS == int(jds._I32_PAD) == int(ref_dc.I32_PAD_TS)
    assert tds.I32_BIG == int(jds._I32_BIG)


def _grids():
    limit = 2**31 - 2
    return {
        "fixed": (jds.FixedWindows.for_range(T0, T0 + 3_600_000, 300_000),
                  tds.FixedWindows.for_range(T0, T0 + 3_600_000, 300_000)),
        # (pad_pow2(count) + 1) * interval just under and at 2^31 - 2
        "fixed, under 2^31": (jds.FixedWindows(2, T0, 1023),
                              tds.FixedWindows(2, T0, 1023)),
        "fixed, at 2^31": (jds.FixedWindows(-(-limit // 1025), T0, 1024),
                           tds.FixedWindows(-(-limit // 1025), T0, 1024)),
        # 1001 windows fit, the padded 1024 do not: the reference sizes
        # on its padded count, and so does the port
        "fixed, past 2^31": (jds.FixedWindows(limit // 1024, T0, 1000),
                             tds.FixedWindows(limit // 1024, T0, 1000)),
        "calendar": (jds.EdgeWindows((T0, T0 + 60_000, T0 + 180_000)),
                     tds.EdgeWindows((T0, T0 + 60_000, T0 + 180_000))),
        "all": (jds.AllWindow(T0, T0 + 60_000),
                tds.AllWindow(T0, T0 + 60_000)),
    }


@pytest.mark.parametrize("kind", list(_grids()))
def test_precompact_base_matches_reference(kind):
    ref, port = _grids()[kind]
    first = getattr(ref, "first_window_ms", None)
    want = jds.precompact_base(ref.split()[0], first)
    assert tds.precompact_base(port, first) == want
    compacts = kind.startswith("fixed") \
        and kind not in ("fixed, at 2^31", "fixed, past 2^31")
    assert (want is not None) == compacts


def _gather_case(rng):
    """Packed columns of 6 runs (one empty, one at the buffer's end), and
    starts and lengths over them."""
    lens = rng.integers(0, 40, 6)
    lens[2] = 0
    ts_buf = np.concatenate([np.sort(rng.choice(500_000, k, replace=False))
                             + T0 + 1000 for k in lens]).astype(np.int64)
    val_buf = rng.normal(0, 10, len(ts_buf))
    offsets = np.concatenate([[0], np.cumsum(lens)])
    lo = np.array([rng.integers(0, k + 1) for k in lens])
    starts = (offsets[:-1] + lo).astype(np.int64)
    lengths = (lens - lo).astype(np.int64)
    return ts_buf, val_buf, starts, lengths


@pytest.mark.parametrize("n", [40, 64])
def test_int32_gather_matches_reference(n):
    ts_buf, val_buf, starts, lengths = _gather_case(np.random.default_rng(n))
    base = T0
    want = ref_dc._gather_windows(jnp.asarray(ts_buf), jnp.asarray(val_buf),
                                  starts, lengths, n, ts_base=base)
    got = dc.gather_windows(t(ts_buf), t(val_buf), t(starts), t(lengths), n,
                            base)
    assert got[0].dtype == torch.int32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts, _, mask = (x.numpy() for x in got)
    assert (ts[~mask] == tds.I32_PAD_TS).all()
    # a point earlier than the base clips to 0, as the reference's does
    early = dc.gather_windows(t(ts_buf), t(val_buf), t(starts), t(lengths),
                              n, int(ts_buf.max()))
    assert (early[0].numpy()[early[2].numpy()] == 0).sum() >= mask.sum() - 1


def _int32_batch(seed=5, s=6, n=64):
    ts, val, mask = sorted_batch(np.random.default_rng(seed), s, n)
    ts32 = np.clip(ts - T0, 0, tds.I32_PAD_TS).astype(np.int32)
    return ts, ts32, val, mask


def _reference_i32(ts32, val, mask, func, plan):
    spec, wargs = plan.split()
    wargs = dict(wargs, ts_base=jnp.asarray(T0, jnp.int64))
    wts, out, out_mask = jds.downsample(jnp.asarray(ts32), val, mask, func,
                                        spec, wargs)
    w = plan.count
    return (np.asarray(wts)[:w], np.asarray(out)[:, :w],
            np.asarray(out_mask)[:, :w])


@pytest.mark.parametrize("func", MOMENTS + ORDERS)
def test_int32_downsample_matches_reference_and_int64(func):
    ts, ts32, val, mask = _int32_batch()
    ref_plan = jds.FixedWindows.for_range(T0, T0 + 3_600_000, 300_000)
    plan = tds.FixedWindows.for_range(T0, T0 + 3_600_000, 300_000)
    base = tds.precompact_base(plan, plan.first_window_ms)
    assert base == T0
    edges = plan.window_edges("cpu")
    got = tds.downsample(t(ts32), t(val), t(mask), func, edges,
                         ts_base=base)
    wide = tds.downsample(t(ts), t(val), t(mask), func, edges)
    for a, b in zip(got, wide):        # bit for bit the int64 form
        assert torch.equal(a, b) or torch.allclose(
            a, b, rtol=0, atol=0, equal_nan=True)
    ref = _reference_i32(ts32, val, mask, func, ref_plan)
    assert_exact(got[0].numpy(), ref[0])
    assert_exact(got[2].numpy(), ref[2])
    assert_values(got[1].numpy(), ref[1])


def test_int32_kernels_take_int32_edges_only():
    _, ts32, val, mask = _int32_batch()
    edges = tds.FixedWindows.for_range(T0, T0 + 3_600_000,
                                       300_000).window_edges("cpu")
    with pytest.raises(ValueError):
        tds.window_moments(t(ts32), t(val), t(mask), edges, "sum")
    with pytest.raises(ValueError):
        tds.downsample(t(ts32), t(val), t(mask), "sum", edges)
    stacked = tds.compact_edges(edges, T0).expand(2, -1).contiguous()
    with pytest.raises(ValueError):     # a stacked batch stays int64
        tds.window_order(t(ts32), t(val), t(mask), stacked, "first")


def test_stale_base_saturates_and_drops_points():
    """Edges of a grid 2^32 ms past the base clip at I32_BIG (as the
    reference's _compact_ts clips them): every window is empty, no point
    wraps into one."""
    ts, ts32, val, mask = _int32_batch()
    far = tds.FixedWindows.for_range(T0 + 2**32, T0 + 2**32 + 3_600_000,
                                     300_000)
    edges = far.window_edges("cpu")
    compact = tds.compact_edges(edges, T0)
    ref_plan = jds.FixedWindows.for_range(T0 + 2**32, T0 + 2**32 + 3_600_000,
                                          300_000)
    spec, wargs = ref_plan.split(pad=False)
    _, ref_edges = jds._compact_ts(jnp.asarray(ts32), spec, dict(
        wargs, ts_base=jnp.asarray(T0, jnp.int64)))
    np.testing.assert_array_equal(compact.numpy(), np.asarray(ref_edges))
    assert (compact == tds.I32_BIG).all()
    _, out, out_mask = tds.downsample(t(ts32), t(val), t(mask), "count",
                                      edges, ts_base=T0)
    assert not out_mask.any()
    # an early grid saturates low: its windows hold nothing either
    early = tds.FixedWindows.for_range(T0 - 2**33, T0 - 2**33 + 600_000,
                                       300_000).window_edges("cpu")
    assert (tds.compact_edges(early, T0) == -tds.I32_BIG).all()
    assert not tds.downsample(t(ts32), t(val), t(mask), "count", early,
                              ts_base=T0)[2].any()


def test_batch_budget_prices_13_bytes_a_slot_with_a_base():
    """A batch that fits 13 bytes a slot but not 17 is gathered with a
    base and declined without one (the reference's :192-197)."""
    s, n = 4, 100
    tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True}),
                device="cpu")
    for i in range(s):
        key = tsdb._series_key("bb.m", {"host": "h%d" % i}, create=True)
        tsdb.store.add_batch(key, T0 + np.arange(n, dtype=np.int64) * 1000,
                             np.arange(n, dtype=np.float64), False)
    metric = tsdb.metrics.get_id("bb.m")
    series = tsdb.store.series_for_metric(metric)
    cache = dc.DeviceSeriesCache(1 << 20, device="cpu",
                                 batch_max_bytes=s * n * 13)
    end = T0 + n * 1000
    assert cache.batch_for(tsdb.store, metric, series, T0, end) is None
    batch = cache.batch_for(tsdb.store, metric, series, T0, end,
                            ts_base=T0)
    assert batch is not None and batch[0].dtype == torch.int32
    assert batch[0][0, :3].tolist() == [0, 1000, 2000]


# -- a grouped hit through both TSDBs -----------------------------------

CFG = {"tsd.core.auto_create_metrics": True,
       "tsd.query.batch.enable": False, "tsd.query.cache.enable": False}


def _ingest(tsdb):
    rng = np.random.default_rng(9)
    for h in range(6):
        for i in range(120):
            tsdb.add_point("pc.m", BASE + i * 15 + h, float(
                rng.normal(40, 9)), {"host": "h%d" % h, "dc": "d%d" % (h % 2)})
    return tsdb


def _run(tsdb, query_cls, parse, m):
    q = query_cls(start=str(BASE), end=str(BASE + 1800),
                  queries=[parse(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    return runner.run(q), runner.exec_stats


@pytest.mark.parametrize("m", ["sum:1m-avg:pc.m{dc=*}",
                               "max:5m-p95:pc.m{dc=*}",
                               "min:1m-first:pc.m",
                               "movingAverage3:1m-sum:pc.m{dc=*}"])
def test_grouped_hit_with_a_base_equals_a_miss(m):
    ref = _ingest(RefTSDB(RefConfig({**CFG, "tsd.query.mesh.enable":
                                     False})))
    port = _ingest(TSDB(Config(CFG), device="cpu"))
    plain = _ingest(TSDB(Config({**CFG, "tsd.query.device_cache.enable":
                                 False}), device="cpu"))
    _run(port, TSQuery, parse_m_subquery, m)      # builds the entry
    got, stats = _run(port, TSQuery, parse_m_subquery, m)
    assert stats.get("deviceCacheHit") == 1.0
    assert stats.get("tsCompacted") == 1.0
    miss, miss_stats = _run(plain, TSQuery, parse_m_subquery, m)
    assert "tsCompacted" not in miss_stats
    assert [r.to_json(ms_resolution=True) for r in got] \
        == [r.to_json(ms_resolution=True) for r in miss]
    want, _ = _run(ref, RefTSQuery, ref_parse, m)
    assert [r.tags for r in got] == [r.tags for r in want]
    for a, b in zip(got, want):
        assert [x for x, _ in a.dps] == [x for x, _ in b.dps]
        assert_values([v for _, v in a.dps], [v for _, v in b.dps])


# -- the wide-dynamic-range case (ROADMAP queue C) ----------------------

WIDE = [-1e15, -35.48827592954828, 2.0, 1.25, 0.1]


def _wide_batch():
    """One series: -1e15 in the first 1m window, then one point in each of
    the next four."""
    ts = (T0 + 30_000 + np.arange(5, dtype=np.int64) * 60_000)[None, :]
    return ts, np.array([WIDE]), np.ones((1, 5), bool)


@pytest.mark.parametrize("func,want", [
    ("avg", WIDE),
    ("squareSum", [v * v for v in WIDE]),
    ("median", WIDE),
])
def test_wide_dynamic_range_is_exact_in_both_forms(func, want):
    ts, val, mask = _wide_batch()
    plan = tds.FixedWindows.for_range(T0, T0 + 299_999, 60_000)
    edges = plan.window_edges("cpu")
    ts32 = (ts - T0).astype(np.int32)
    for batch_ts, base in ((ts, None), (ts32, T0)):
        _, out, out_mask = tds.downsample(t(batch_ts), t(val), t(mask),
                                          func, edges, ts_base=base)
        assert out_mask.all()
        assert out[0].tolist() == want


def test_wide_dynamic_range_reference_loses_digits():
    """What the reference's prefix-difference downsample gives on the
    same series (a known behaviour, not a parity target)."""
    ts, val, mask = _wide_batch()
    plan = jds.FixedWindows.for_range(T0, T0 + 299_999, 60_000)
    spec, wargs = plan.split()
    _, avg, _ = jds.downsample(ts, val, mask, "avg", spec, wargs)
    _, sq, _ = jds.downsample(ts, val, mask, "squareSum", spec, wargs)
    avg, sq = np.asarray(avg)[0, :5], np.asarray(sq)[0, :5]
    assert avg[1] == -35.5 and avg[4] == 0.125
    assert (sq[1:] == 0.0).all()
