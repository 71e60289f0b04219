"""Histograms on both packages: the codec, the store's batch assembly, the
H1/H2 kernels' plain versions, and histogram queries end to end.

Inputs are made with numpy from a seed and handed to the JAX reference
(on the CPU) and to opentsdb_tpu_torch (``device="cpu"``, so the kernel
wrappers run their plain versions).  Everything is integer counts and
midpoints picked by index, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.histogram import SimpleHistogram as RefHistogram
from opentsdb_tpu.histogram import kernels as ref_kernels
from opentsdb_tpu.histogram import store as ref_store
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB, load_state
from opentsdb_tpu_torch.histogram import (HistogramCodecManager,
                                          SimpleHistogram)
from opentsdb_tpu_torch.histogram import kernels as hk
from opentsdb_tpu_torch.histogram import store as port_store
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.query.limits import QueryException
from opentsdb_tpu_torch.storage.memstore import SeriesKey
from opentsdb_tpu_torch.utils.config import Config
from torch_parity import (H2_EDGE_CLASSES, H2_EDGE_PS, H2_EDGE_WIDTHS,
                          h2_edge_counts, h2_edge_percs)

BASE = 1_356_998_400
HIST_CONFIG = '{"SimpleHistogramDecoder": 0}'
EDGES = [0, 5, 10, 25, 50, 100, 250]


def _tsdbs(**props):
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.core.histograms.config": HIST_CONFIG, **props}
    return (RefTSDB(RefConfig({**props, "tsd.query.mesh.enable": False})),
            TSDB(Config(props), device="cpu"))


def _random_points(seed, n_series=6, n_pts=40):
    """test_histogram's random fleet: per-series bucket subsets, shared
    and duplicate timestamps, tags host (3 values) and dc (2 values)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_series):
        for i in range(n_pts):
            buckets = {}
            for b in range(len(EDGES) - 1):
                if rng.random() < 0.6:
                    buckets["%d,%d" % (EDGES[b], EDGES[b + 1])] = \
                        int(rng.integers(0, 50))
            if not buckets:
                buckets["0,5"] = 1
            out.append(("rh.m", BASE + (i // 2) * 60, {"buckets": buckets},
                        {"host": "h%d" % (s % 3), "dc": "d%d" % (s % 2)}))
    return out


def _seed_latency(hours=2):
    """test_histogram's latency metric: a histogram every 15 min."""
    return [("svc.latency", BASE + i * 900,
             {"buckets": {"0,10": 30, "10,20": 50, "20,100": 20}},
             {"host": "web01"}) for i in range(hours * 4)]


def _ingest(tsdbs, points):
    for t in tsdbs:
        for metric, ts, dp, tags in points:
            t.add_histogram_point_json(metric, ts, dp, tags)
    return tsdbs


def _answers(tsdbs, m, start=BASE, end=BASE + 7200):
    out = []
    for tsdb, tsq, parse in zip(tsdbs, (RefTSQuery, TSQuery),
                                (ref_parse, parse_m_subquery)):
        q = tsq(start=str(start), end=str(end), queries=[parse(m)])
        q.validate()
        out.append([r.to_json(ms_resolution=True, show_tsuids=True)
                    for r in tsdb.new_query_runner().run(q)])
    return out


# -- codec ---------------------------------------------------------------


def _pair(counts, under=0, over=0):
    out = []
    for cls in (RefHistogram, SimpleHistogram):
        h = cls(0)
        for (lo, hi), c in counts.items():
            h.add_bucket(lo, hi, c)
        h.underflow, h.overflow = under, over
        out.append(h)
    return out


@pytest.mark.parametrize("include_id", [True, False])
def test_binary_and_base64_codec_match_the_reference(include_id):
    ref, port = _pair({(0.0, 1.5): 7, (1.5, 3.0): 1 << 40, (3.0, 9.0): 0},
                      under=3, over=9)
    raw = port.to_bytes(include_id=include_id)
    assert raw == ref.to_bytes(include_id=include_id)
    assert SimpleHistogram.from_bytes(raw, include_id) == port
    assert port.to_base64(include_id) == ref.to_base64(include_id)
    assert SimpleHistogram.from_base64(ref.to_base64(include_id),
                                       include_id) == port


def test_pojo_round_trip_and_percentile_rule_match_the_reference():
    dp = {"buckets": {"0,10": 50, "10,20": 40, "20,30": 10},
          "underflow": 1, "overflow": 2}
    port = SimpleHistogram.from_pojo(dp)
    ref = RefHistogram.from_pojo(dp)
    assert port.to_json() == ref.to_json()
    for p in (0.5, 1, 50, 90, 99, 100, 101):
        assert port.percentile(p) == ref.percentile(p)
    assert SimpleHistogram().percentile(50) == 0.0
    negative = SimpleHistogram.from_pojo({"buckets": {"0,1": -1}})
    with pytest.raises(ValueError, match="negative"):
        negative.to_bytes()


def test_codec_manager():
    mgr = HistogramCodecManager(HIST_CONFIG)
    codec = mgr.get_codec(0)
    h = _pair({(0.0, 1.0): 4})[1]
    assert codec.decode(codec.encode(h, include_id=False),
                        includes_id=False).buckets == h.buckets
    with pytest.raises(ValueError):
        mgr.get_codec(7)
    with pytest.raises(ValueError, match="Unable to find"):
        HistogramCodecManager('{"NoSuchDecoder": 1}')


# -- batch assembly ------------------------------------------------------


@pytest.mark.parametrize("interval_ms", [0, 300_000, 3_600_000])
def test_assemble_columnar_matches_the_reference_cut_to_real_size(
        interval_ms):
    """The port's batch is the reference's without the power-of-two
    padding: the same rows, buckets, bounds and groups; seg addresses the
    unpadded grid and stays int64."""
    ref_tsdb, port_tsdb = _ingest(_tsdbs(), _random_points(5))

    def grouped(tsdb):
        by_host = {}
        for s in tsdb.histogram_store.series_for_metric(
                tsdb.metrics.get_id("rh.m")):
            host = tsdb.resolve_key_tags(s.key)["host"]
            by_host.setdefault(host, []).append(s)
        return [((h,), sorted(by_host[h], key=lambda s: s.key.tags))
                for h in sorted(by_host)]

    ref = ref_store.assemble_columnar(grouped(ref_tsdb), BASE * 1000,
                                      (BASE + 7200) * 1000, interval_ms)
    port = port_store.assemble_columnar(grouped(port_tsdb), BASE * 1000,
                                        (BASE + 7200) * 1000, interval_ms)
    b = ref["n_real_buckets"]
    rows = ref["groups"][-1][2]
    assert (port["n_rows"], port["n_buckets"]) == (rows, b)
    np.testing.assert_array_equal(port["bounds"], ref["bounds"])
    np.testing.assert_array_equal(port["mid"], ref["mid"][:b])
    assert port["seg"].dtype == np.int64
    np.testing.assert_array_equal(port["cnt"], ref["cnt"])
    ref_seg = ref["seg"].astype(np.int64)
    np.testing.assert_array_equal(
        port["seg"], ref_seg // ref["n_buckets"] * b
        + ref_seg % ref["n_buckets"])
    assert len(port["groups"]) == len(ref["groups"])
    for pg, rg in zip(port["groups"], ref["groups"]):
        assert pg[0] == rg[0] and pg[1:3] == rg[1:3] and pg[5] == rg[5]
        np.testing.assert_array_equal(pg[3], rg[3])
        np.testing.assert_array_equal(pg[4], rg[4])


# -- H1 and H2, plain versions against the JAX functions ------------------


def test_accumulate_rows_matches_the_reference():
    rng = np.random.default_rng(1)
    r, b, nnz = 37, 11, 5000
    seg = rng.integers(0, r * b, nnz).astype(np.int64)
    seg[seg // b == 3] += b          # row 3 stays empty
    seg = np.minimum(seg, r * b - 1)
    cnt = rng.integers(0, 1 << 40, nnz).astype(np.int64)
    cnt[::7] = 0
    want = np.asarray(ref_kernels.accumulate_rows(seg, cnt, r, b))
    got = hk.accumulate_rows(torch.from_numpy(seg), torch.from_numpy(cnt),
                             r, b)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[3].any()


def test_accumulate_rows_refuses_negative_counts_and_stray_cells():
    """A negative count is added as the reference's segment sum adds it;
    an entry outside the grid is refused."""
    seg = torch.tensor([0, 5, 5], dtype=torch.int64)
    cnt = torch.tensor([1, -1, -4], dtype=torch.int64)
    want = np.asarray(ref_kernels.accumulate_rows(seg.numpy(), cnt.numpy(),
                                                  2, 3))
    np.testing.assert_array_equal(hk.accumulate_rows(seg, cnt, 2, 3).numpy(),
                                  want)
    with pytest.raises(ValueError, match="outside the grid"):
        hk.accumulate_rows(torch.tensor([0, 6]), torch.tensor([1, 1]), 2, 3)
    with pytest.raises(TypeError):
        hk.accumulate_rows(seg[:2].int(), torch.tensor([1, 1]), 2, 3)
    empty = hk.accumulate_rows(torch.zeros(0, dtype=torch.int64),
                               torch.zeros(0, dtype=torch.int64), 2, 3)
    assert empty.shape == (2, 3) and not empty.any()


def _percentile_case(rng, r=40, b=9):
    counts = rng.integers(0, 30, (r, b)).astype(np.int64)
    counts[rng.random((r, b)) < 0.4] = 0
    counts[0] = 0                                   # no mass
    counts[1] = 0
    counts[1, 4] = 7                                # one bucket
    counts[2] = [5, 5, 0, 0, 5, 5, 0, 0, 0]         # a share of exactly 50
    counts[3, :] = 1 << 46                           # big, even totals
    mid = np.sort(rng.uniform(-50, 500, b))
    return counts, mid


PERCS = [50.0, 90.0, 99.0, 99.9, 100.0, 1.0, 0.5, 101.0, 25.0, 75.0]


@pytest.mark.parametrize("seed", range(3))
def test_percentile_rows_matches_the_reference(seed):
    counts, mid = _percentile_case(np.random.default_rng(seed))
    percs = np.asarray(PERCS)
    want = np.asarray(ref_kernels.percentile_rows(counts, mid, percs))
    got = hk.percentile_rows(torch.from_numpy(counts), torch.from_numpy(mid),
                             torch.from_numpy(percs))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[6:8] == -1.0).all()                 # p outside [1, 100]
    assert (got[:6, 0] == 0.0).all()                # a row with no mass
    assert got[0, 2] == mid[1]                      # the share tie at 50


def test_percentile_100_below_100_share_answers_bucket_zero():
    """For totals of 2^48 and up, total * 100.0 / total can round just
    under 100.0: no bucket reaches p = 100 and both packages answer
    bucket 0's midpoint, as argmax of an all-false row gives."""
    totals = np.random.default_rng(7).integers(1 << 50, 1 << 51, 4000)
    below = totals[totals.astype(np.float64) * 100.0
                   / totals.astype(np.float64) < 100.0]
    assert below.size > 100
    r = 8
    counts = np.zeros((r, 3), np.int64)
    counts[:, 2] = below[:r] - 5
    counts[:, 1] = 5
    mid = np.array([1.0, 2.0, 3.0])
    percs = np.array([100.0, 99.0])
    want = np.asarray(ref_kernels.percentile_rows(counts, mid, percs))
    got = hk.percentile_rows(torch.from_numpy(counts), torch.from_numpy(mid),
                             torch.from_numpy(percs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 1.0).all() and (got[1] == 3.0).all()


@pytest.mark.parametrize("n_p", H2_EDGE_PS)
@pytest.mark.parametrize("cls", H2_EDGE_CLASSES)
@pytest.mark.parametrize("b", H2_EDGE_WIDTHS)
def test_percentile_rows_edge_classes_match_the_reference(b, cls, n_p):
    """H2's edge classes at the widths where its layout changes (a lane
    holds two buckets: segments of 1-16 lanes up to B = 32, a warp a row
    up to 128, two reads past it): negative counts and totals <= 0,
    running sums that wrap past 2^63, totals past 2^48 at p = 100, with
    NaN, 0.5, 100 and 101 among the percentiles."""
    counts, mid = h2_edge_counts(37, b, cls)
    percs = h2_edge_percs(n_p)
    want = np.asarray(ref_kernels.percentile_rows(counts, mid, percs))
    got = hk.percentile_rows(torch.from_numpy(counts), torch.from_numpy(mid),
                             torch.from_numpy(percs)).numpy()
    assert got.shape == (n_p, 37)
    np.testing.assert_array_equal(got, want)
    if n_p > 3:
        assert (got[1:4:2] == -1.0).all()           # NaN and 101
    totals = counts.sum(axis=1)                     # wraps as the cumsum
    if n_p and cls in ("negative", "wrap"):
        assert (totals <= 0).any()
        assert (got[0, totals <= 0] == 0.0).all()   # no mass
    if n_p and cls == "big":
        assert got[0, 0] == mid[0]                  # none reaches 100


def test_percentile_rows_without_buckets():
    got = hk.percentile_rows(torch.zeros((3, 0), dtype=torch.int64),
                             torch.zeros(0, dtype=torch.float64),
                             torch.tensor([50.0, 0.0], dtype=torch.float64))
    assert got.tolist() == [[0.0] * 3, [-1.0] * 3]


# -- queries end to end --------------------------------------------------

LATENCY_CASES = [
    "sum:percentiles[50,99]:svc.latency",
    "sum:1h-sum:percentiles[50]:svc.latency",
    "sum:show-histogram-buckets:svc.latency",
    "sum:5m-sum:percentiles[50,100]:show-histogram-buckets:svc.latency",
]
RANDOM_CASES = [
    "sum:percentiles[50,90,99]:rh.m{host=*}",
    "sum:5m-sum:percentiles[50,90,99]:rh.m{host=*}",
    "sum:1h-sum:percentiles[1,99.9,100]:rh.m{dc=*}",
    "sum:show-histogram-buckets:rh.m{host=*}",
    "sum:percentiles[75]:rh.m{host=h0|h2}{dc=d1}",
    "sum:percentiles[50]:rh.m{host=*,dc=*}",
    "none:percentiles[50]:show-histogram-buckets:rh.m",
    "sum:percentiles[95]:rh.m",
    "sum:explicit_tags:percentiles[95]:rh.m{host=h1,dc=*}",
]


@pytest.mark.parametrize("m", LATENCY_CASES)
def test_latency_queries_match_the_reference(m):
    ref, port = _answers(_ingest(_tsdbs(), _seed_latency()), m)
    assert port == ref and port


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("m", RANDOM_CASES)
def test_random_fleet_queries_match_the_reference(m, seed):
    ref, port = _answers(_ingest(_tsdbs(), _random_points(seed)), m)
    assert port == ref and port


def test_known_answers_and_empty_range():
    tsdbs = _ingest(_tsdbs(), _seed_latency())
    _, port = _answers(tsdbs, "sum:percentiles[50,99]:svc.latency")
    by_metric = {r["metric"]: r["dps"] for r in port}
    assert by_metric["svc.latency_pct_50.0"][str(BASE * 1000)] == 15.0
    assert by_metric["svc.latency_pct_99.0"][str(BASE * 1000)] == 60.0
    ref, port = _answers(tsdbs, "sum:percentiles[50]:svc.latency",
                         BASE + 100_000, BASE + 200_000)
    assert port == ref == []


def test_not_configured_matches_the_reference():
    tsdbs = _tsdbs(**{"tsd.core.histograms.config": ""})
    for t in tsdbs:
        with pytest.raises(ValueError, match="not configured"):
            t.add_histogram_point_json("m", BASE, {"buckets": {"0,1": 1}},
                                       {"h": "a"})
    for tsdb, tsq, parse in zip(tsdbs, (RefTSQuery, TSQuery),
                                (ref_parse, parse_m_subquery)):
        q = tsq(start=str(BASE), end=str(BASE + 60),
                queries=[parse("sum:percentiles[50]:m")])
        q.validate()
        with pytest.raises(ValueError, match="not configured"):
            tsdb.new_query_runner().run(q)


def test_raw_base64_ingest_matches_json_ingest():
    h = _pair({(1.0, 2.0): 10, (2.0, 4.0): 3})[1]
    ref, port = _tsdbs()
    for t in (ref, port):
        t.add_histogram_point_raw("raw.m", BASE, 0,
                                  h.to_base64(include_id=False), {"h": "a"})
        t.add_histogram_point_json("raw.m", BASE + 60,
                                   {"value": h.to_base64(False)},
                                   {"h": "a"})
    a, b = _answers((ref, port), "sum:show-histogram-buckets:raw.m")
    assert a == b and len(b) == 2


def test_grid_guard_refuses_as_the_reference():
    """rows x buckets x 8 B over tsd.query.streaming.state_mb: the same
    413 in both packages (powers of two, where the reference's padding
    changes nothing)."""
    bounds = {"%d,%d" % (i, i + 1): 1 for i in range(64)}
    points = [("big.h", BASE + i, {"buckets": bounds}, {"host": "a"})
              for i in range(4096)]
    tsdbs = _ingest(_tsdbs(**{"tsd.query.streaming.state_mb": 1}), points)
    errors = []
    for tsdb, tsq, parse in zip(tsdbs, (RefTSQuery, TSQuery),
                                (ref_parse, parse_m_subquery)):
        q = tsq(start=str(BASE), end=str(BASE + 5000),
                queries=[parse("sum:percentiles[50]:big.h")])
        q.validate()
        with pytest.raises(Exception) as info:
            tsdb.new_query_runner().run(q)
        errors.append(info.value)
    ref, port = errors
    assert isinstance(port, QueryException) and port.status == ref.status
    assert str(port) == str(ref) and port.details == ref.details
    assert "4096 windows x 64 buckets" in str(port)


def test_negative_count_is_refused_at_query_time():
    """A JSON bucket count below zero is stored (SimpleHistogram.from_pojo
    does not check it in either package).  H1 adds it, as the reference's
    segment sum does, so the query answers as the reference's: alone in
    its row, the negative mass answers 0.0; beside other counts, it takes
    part in the share."""
    points = [("neg.h", BASE, {"buckets": {"0,1": -4}}, {"host": "a"}),
              ("neg.h", BASE + 120, {"buckets": {"0,1": -1, "1,5": 3,
                                                 "5,10": 2}},
               {"host": "a"})]
    tsdbs = _ingest(_tsdbs(), points)
    for m in ("sum:percentiles[50,99]:neg.h",
              "sum:1m-sum:percentiles[10,50,99]:neg.h{host=*}"):
        ref, port = _answers(tsdbs, m, BASE, BASE + 600)
        assert port == ref and port


@pytest.mark.parametrize("m", [
    "sum:percentiles[50,99]:svc.latency",
    "sum:show-histogram-buckets:svc.latency",
    "sum:5m-sum:percentiles[50]:show-histogram-buckets:svc.latency",
])
def test_stray_scatter_entry_fails_the_query(monkeypatch, m):
    """A bucket entry outside the grid, built by hand into the planner's
    batch, fails the histogram query with H1's ValueError before any
    answer, whichever copy (H2's values, the grid, or both) brings the
    deferred flag back; the query without it answers."""
    from opentsdb_tpu_torch.query import planner
    _, port = _ingest(_tsdbs(), _seed_latency())
    q = TSQuery(start=str(BASE), end=str(BASE + 7200),
                queries=[parse_m_subquery(m)])
    q.validate()
    assert port.new_query_runner().run(q)
    assemble = planner.assemble_columnar

    def with_stray(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        cells = batch["n_rows"] * batch["n_buckets"]
        batch["seg"] = np.append(batch["seg"], np.int64(cells))
        batch["cnt"] = np.append(batch["cnt"], np.int64(1))
        return batch

    monkeypatch.setattr(planner, "assemble_columnar", with_stray)
    with pytest.raises(ValueError, match="outside the grid of"):
        port.new_query_runner().run(q)


def test_deferred_accumulate_flags_instead_of_raising():
    """H1's deferred form leaves the stray entry out of the grid and sets
    the flag; `check` raises on it, as the direct form does at the
    call."""
    seg = torch.tensor([0, 5, 6, -1, 2], dtype=torch.int64)
    cnt = torch.tensor([1, 2, 9, 9, -3], dtype=torch.int64)
    acc = hk.accumulate_rows_deferred(seg, cnt, 2, 3)
    assert acc.buffer.shape == (7,) and int(acc.flag[0]) == 1
    np.testing.assert_array_equal(acc.grid.numpy(),
                                  [[1, 0, -3], [0, 0, 2]])
    with pytest.raises(ValueError, match="outside the grid of 6 cells"):
        acc.check(acc.flag[0])
    ok = hk.accumulate_rows_deferred(seg[:2], cnt[:2], 2, 3)
    ok.check(ok.flag[0])
    np.testing.assert_array_equal(ok.grid.numpy(),
                                  hk.accumulate_rows(seg[:2], cnt[:2], 2,
                                                     3).numpy())


def test_phases_are_reported():
    _, port = _ingest(_tsdbs(), _seed_latency())
    q = TSQuery(start=str(BASE), end=str(BASE + 7200),
                queries=[parse_m_subquery("sum:percentiles[50]:svc.latency")])
    q.validate()
    runner = port.new_query_runner()
    runner.run(q)
    for phase in ("build", "h2d", "kernels", "extract"):
        assert runner.exec_stats[phase + "Ms"] >= 0.0


# -- load_state ----------------------------------------------------------


def _histogram_state(tsdb):
    """A reference TSDB's histogram series as load_state takes them."""
    out = []
    for s in tsdb.histogram_store.all_series():
        pts = s.window(0, 2**62)
        out.append((s.key.metric, dict(s.key.tags),
                    np.array([t for t, _ in pts], np.int64),
                    [(np.array(list(h.buckets), np.float64).reshape(-1, 2),
                      np.array(list(h.buckets.values()), np.int64),
                      h.underflow, h.overflow) for _, h in pts]))
    return out


def test_load_state_carries_histograms_across():
    ref_tsdb = RefTSDB(RefConfig({"tsd.core.auto_create_metrics": True,
                                  "tsd.core.histograms.config": HIST_CONFIG,
                                  "tsd.query.mesh.enable": False}))
    _ingest((ref_tsdb,), _random_points(3) + _seed_latency())
    ref_tsdb.add_point("sys.cpu", BASE, 1, {"host": "h0"})
    uid_maps = {kind: ref_tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in ref_tsdb.store.all_series()]
    port = load_state(uid_maps, series, config=Config(
        {"tsd.core.histograms.config": HIST_CONFIG}), device="cpu",
        histograms=_histogram_state(ref_tsdb))
    assert sorted(port.tsuid(s.key)
                  for s in port.histogram_store.all_series()) \
        == sorted(ref_tsdb.tsuid(s.key)
                  for s in ref_tsdb.histogram_store.all_series())
    for m in ("sum:5m-sum:percentiles[50,99]:rh.m{host=*}",
              "sum:show-histogram-buckets:svc.latency"):
        ref, got = _answers((ref_tsdb, port), m)
        assert got == ref and got
    # and the port's own arrays() round-trips through load_state
    again = load_state(uid_maps, [], config=Config(
        {"tsd.core.histograms.config": HIST_CONFIG}), device="cpu",
        histograms=[(s.key.metric, dict(s.key.tags), *s.arrays())
                    for s in port.histogram_store.all_series()])
    a, b = _answers((port, again), "sum:percentiles[90]:rh.m{dc=*}")
    assert a == b and a
    with pytest.raises(ValueError, match="not configured"):
        load_state(uid_maps, [], device="cpu",
                   histograms=_histogram_state(ref_tsdb))


def test_out_of_order_appends_keep_the_columns_exact():
    """columns() extends on in-order appends and rebuilds after an
    out-of-order one; either way it equals a one-shot build."""
    rng = np.random.default_rng(3)
    s1 = port_store.HistogramSeries(SeriesKey.make(1, {}))
    s2 = port_store.HistogramSeries(SeriesKey.make(1, {}))
    ts = 0
    for _ in range(6):
        for _ in range(int(rng.integers(1, 30))):
            ts += int(rng.integers(0, 100)) \
                - (20 if rng.random() < 0.3 else 0)
            h = _pair({(0.0, 1.0): int(rng.integers(0, 9)),
                       (float(rng.integers(1, 4)), 9.0): 2})[1]
            s1.append(max(ts, 0), h)
            s2.append(max(ts, 0), h)
        s1.columns()
    a, b = s1.columns(), s2.columns()
    assert s1.count_in_range(0, ts) == len(s1) == len(a[0])
    assert s1.count_in_range(a[0][3], a[0][5]) \
        == int(np.sum((a[0] >= a[0][3]) & (a[0] <= a[0][5])))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for i in range(len(a[0])):
        ea = sorted((a[4][g], c) for g, c in
                    zip(a[2][a[1][i]:a[1][i + 1]], a[3][a[1][i]:a[1][i + 1]]))
        eb = sorted((b[4][g], c) for g, c in
                    zip(b[2][b[1][i]:b[1][i + 1]], b[3][b[1][i]:b[1][i + 1]]))
        assert ea == eb
