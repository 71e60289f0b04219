"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where there is no CUDA device.
The file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(the repository's conftest imports jax).  Values agree at rtol 1e-9
(torch_parity.RTOL); masks are equal.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu_torch.core import load_state
from opentsdb_tpu_torch.ops import aggregators as tagg
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops import rate as trate
from opentsdb_tpu_torch.ops import streaming as tst
from opentsdb_tpu_torch.ops import union_agg as tua
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.storage import device_cache as tdc

import mult_runs as mr
from torch_parity import (H2_EDGE_CLASSES, H2_EDGE_PS,  # noqa: F401
                          H2_EDGE_WIDTHS, K2_EDGE_WIDTHS, K5_EDGE_LAYOUTS,
                          R_EDGE_LENGTHS, assert_exact, assert_values,
                          cuda_device, h2_edge_counts, h2_edge_percs,
                          h2_edge_rows, k2_edge_grid, k5_edge_groups,
                          r_edge_rows, sorted_batch, t)

pytestmark = pytest.mark.gpu

T0 = 1_356_998_400_000
FUNCS = ["sum", "zimsum", "pfsum", "count", "avg", "min", "mimmin", "max",
         "mimmax", "dev", "squareSum"]
FILLS = ["none", "zero", "nan", "null", "scalar"]
POLICIES = ["lerp", "zim", "max", "min", "prev"]
RATES = [None, (), (True,), (True, 5000), (True, 5000, 40),
         (True, 2**63 - 1, 0, True)]
PLANS = {
    "fixed": tds.FixedWindows.for_range(T0, T0 + 3_600_000, 300_000),
    "edges": tds.EdgeWindows((T0 - 100_000, T0 + 400_000, T0 + 1_300_000,
                              T0 + 1_300_001, T0 + 2_900_000,
                              T0 + 3_000_000)),
    "all": tds.AllWindow(T0 + 200_000, T0 + 3_100_000),
}


def _on(dev, *arrays):
    return [torch.from_numpy(np.asarray(x)).to(dev) for x in arrays]


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("kind", list(PLANS))
def test_window_moments_kernel_matches_plain(cuda_device, kind, int_values):
    batch = sorted_batch(np.random.default_rng(3), 64, 512,
                         int_values=int_values)
    args = _on(cuda_device, *batch)
    edges = PLANS[kind].window_edges(cuda_device)
    for func in FUNCS:
        for fill in FILLS:
            got = tds.window_moments(*args, edges, func, fill, 2.5)
            want = tds.window_moments_plain(*args, edges, func, fill, 2.5)
            assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
            assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def _grid(rng, s, w, holes):
    wts = T0 + np.arange(w, dtype=np.int64) * 60_000
    wts[5] = wts[4]
    v = np.cumsum(rng.normal(10.0, 30.0, (s, w)), axis=1)
    mask = (rng.random((s, w)) >= 0.35) if holes else np.ones((s, w), bool)
    return wts, np.where(mask, v, np.nan), mask


@pytest.mark.parametrize("holes", [True, False])
def test_grid_fill_rate_kernel_matches_plain(cuda_device, holes):
    dv = _on(cuda_device, *_grid(np.random.default_rng(17), 300, 48, holes))
    for policy in POLICIES:
        for rate_args in RATES:
            opts = None if rate_args is None else RateOptions(*rate_args)
            got = tga.grid_fill_rate(*dv, policy, opts)
            want = tga.grid_fill_rate_plain(*dv, policy, opts)
            for a, b in zip(got[1:], want[1:]):
                assert_exact(a.cpu().numpy(), b.cpu().numpy())
            assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def _bits(x):
    return x.view(torch.int64) if x.dtype == torch.float64 else x


@pytest.mark.parametrize("w", K2_EDGE_WIDTHS)
def test_grid_fill_rate_chunk_edges_kernel_matches_plain(cuda_device, w):
    """K2 at the widths where its chunks and segments end (a warp walks
    128 windows a chunk; a row is cut into 1, 2, 4 or 8 segments), on
    rows with no present window, one, only windows in the last chunk or
    the first, and gap runs across every chunk edge: every policy under
    every rate option set, one launch each."""
    dv = _on(cuda_device, *k2_edge_grid(np.random.default_rng(w), 40, w))
    for policy in POLICIES:
        for rate_args in RATES:
            opts = None if rate_args is None else RateOptions(*rate_args)
            kernels.reset_launches()
            got = tga.grid_fill_rate(*dv, policy, opts)
            assert kernels.LAUNCHES["grid_fill_rate"] == 1
            want = tga.grid_fill_rate_plain(*dv, policy, opts)
            for a, b in zip(got[1:], want[1:]):
                assert_exact(a.cpu().numpy(), b.cpu().numpy())
            assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.parametrize("w", [16, 60, 128, 129, 1025])
def test_grid_fill_rate_stacked_rows_are_solo_rows(cuda_device, w):
    """The stacked K2 (each member its own window timestamps) against its
    plain version under every policy and rate option set, and each
    member's rows bit for bit its solo call's."""
    q, rows = 4, 10
    grids = [k2_edge_grid(np.random.default_rng(100 + k), rows, w,
                          t0=1_356_998_400_000 + k * 7_000) for k in range(q)]
    wts, v, m = _on(cuda_device, np.stack([g[0] for g in grids]),
                    np.concatenate([g[1] for g in grids]),
                    np.concatenate([g[2] for g in grids]))
    per = v.shape[0] // q
    for policy in POLICIES:
        for rate_args in RATES:
            opts = None if rate_args is None else RateOptions(*rate_args)
            kernels.reset_launches()
            got = tga.grid_fill_rate(wts, v, m, policy, opts)
            assert kernels.LAUNCHES["grid_fill_rate.stacked"] == 1
            want = tga.grid_fill_rate_plain(wts, v, m, policy, opts)
            for a, b in zip(got[1:], want[1:]):
                assert_exact(a.cpu().numpy(), b.cpu().numpy())
            assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())
            for k in range(q):
                sl = slice(k * per, (k + 1) * per)
                solo = tga.grid_fill_rate(wts[k], v[sl].contiguous(),
                                          m[sl].contiguous(), policy, opts)
                for a, b in zip(got, solo):
                    assert torch.equal(_bits(a[sl]), _bits(b))


def test_group_moments_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(19)
    dv = _on(cuda_device, *_grid(rng, 300, 48, True))
    contrib, participate, present = tga.grid_fill_rate(*dv, "lerp")
    gid = np.sort(rng.integers(0, 40, 300))
    offsets = tga.group_offsets(gid, 64).to(cuda_device)
    for agg in FUNCS:
        got = tga.group_moments(agg, contrib, participate, present, offsets)
        want = tga.group_moments_plain(agg, contrib, participate, present,
                                       offsets)
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def test_group_moments_kernel_skew(cuda_device):
    """A 1.0-magnitude group between 1e15-magnitude groups, on the card."""
    rng = np.random.default_rng(13)
    small = 1.0 + rng.normal(0, 0.1, (4, 24))
    contrib = np.concatenate([1e15 + rng.normal(0, 1e3, (4, 24)), small,
                              1e15 + rng.normal(0, 1e3, (4, 24))])
    ones = np.ones_like(contrib, bool)
    gid = np.repeat(np.arange(3, dtype=np.int64), 4)
    c, o = _on(cuda_device, contrib, ones)
    out, _ = tga.group_moments("sum", c, o, o,
                               tga.group_offsets(gid, 4).to(cuda_device))
    np.testing.assert_allclose(out.cpu().numpy()[1], small.sum(0), rtol=1e-9)


def test_pipeline_launches_each_kernel_once(cuda_device):
    gid = np.array([0, 0, 0, 1, 1, 3, 3, 3], np.int64)
    batch = sorted_batch(np.random.default_rng(21), len(gid), 128)
    spec = tpipe.PipelineSpec("sum", tpipe.DownsampleStep("avg"),
                              RateOptions())
    kernels.reset_launches()
    out = tpipe.run_group_pipeline(spec, *_on(cuda_device, *batch), gid, 4,
                                   PLANS["fixed"].window_edges(cuda_device))
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} \
        == {"window_moments": 1, "grid_fill_rate": 1, "group_moments": 1}
    plain = tpipe.run_group_pipeline(spec, *[t(x) for x in batch], gid, 4,
                                     PLANS["fixed"].window_edges("cpu"))
    assert_exact(out[2].cpu().numpy(), plain[2].numpy())
    assert_values(out[1].cpu().numpy(), plain[1].numpy())


def test_query_on_card_matches_cpu(cuda_device):
    """The same state on the card and on the CPU answers alike, and the
    card's answer went through all three kernels."""
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    rng = np.random.default_rng(8)
    uid_maps = {"metric": {"m": 1}, "tagk": {"host": 1, "g": 2},
                "tagv": {"h%d" % i: i + 1 for i in range(40)}}
    uid_maps["tagv"].update({"g0": 41, "g1": 42, "g2": 43})
    series = []
    for i in range(40):
        ts = np.sort(rng.choice(3_600_000, 500, replace=False)) + T0
        series.append((1, {1: i + 1, 2: 41 + i % 3}, ts,
                       rng.normal(10, 2, 500), np.zeros(500, np.int64),
                       np.zeros(500, bool)))
    answers = []
    for dev in ("cpu", cuda_device):
        tsdb = load_state(uid_maps, series, device=dev)
        q = TSQuery(start="1356998400", end="1357002000",
                    queries=[parse_m_subquery("sum:5m-avg:rate:m{g=*}")])
        q.validate()
        kernels.reset_launches()
        answers.append([r.to_json() for r in tsdb.new_query_runner().run(q)])
    assert all(kernels.LAUNCHES[k] == 1 for k in (
        "window_moments", "grid_fill_rate", "group_moments"))
    assert len(answers[0]) == len(answers[1]) == 3
    for a, b in zip(*answers):
        assert a["tags"] == b["tags"] and list(a["dps"]) == list(b["dps"])
        np.testing.assert_allclose(list(a["dps"].values()),
                                   list(b["dps"].values()), rtol=1e-9)


def _union_batch(seed, int_values):
    """Rows with their valid points as a sorted prefix, in 5 groups of
    uneven size (group 2 empty); rows 6 and 7 share row 5's timestamps;
    int rows sit near 2^53."""
    ts, val, mask = sorted_batch(np.random.default_rng(seed), 24, 300,
                                 int_values=int_values)
    mask = np.arange(300)[None, :] < mask.sum(axis=1, keepdims=True)
    ts[6:8] = ts[5]
    mask[6:8] = mask[5]
    if int_values:
        val[::2] += 2**53
    gid = np.array([0] * 4 + [1] * 9 + [3] * 6 + [4] * 5, np.int64)
    return ts, val, mask, tga.group_offsets(gid, 5)


@pytest.mark.parametrize("int_values", [False, True])
def test_union_kernels_match_plain(cuda_device, int_values):
    ts, val, mask, offsets = _union_batch(5, int_values)
    d_ts, d_val, d_mask, d_off = _on(cuda_device, ts, val, mask, offsets)
    u, uoff = tua.union_merge(d_ts, d_mask, d_off)
    pu, puoff = tua.union_merge_plain(d_ts, d_mask, d_off)
    assert_exact(u.cpu().numpy(), pu.cpu().numpy())
    assert_exact(uoff.cpu().numpy(), puoff.cpu().numpy())
    for func in FUNCS:
        for policy in POLICIES:
            got = tua.union_reduce(d_ts, d_val, d_mask, d_off, u, uoff, func,
                                   policy)
            want = tua.union_reduce_plain(d_ts, d_val, d_mask, d_off, u,
                                          uoff, func, policy)
            if int_values and func != "dev":
                assert_exact(got.cpu().numpy(), want.cpu().numpy())
            else:
                assert_values(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("int_values", [False, True])
def test_point_rate_kernel_matches_plain(cuda_device, int_values):
    ts, val, mask = sorted_batch(np.random.default_rng(9), 40, 700,
                                 int_values=int_values)
    dv = _on(cuda_device, ts, val, mask)
    for rate_args in RATES[1:]:
        opts = RateOptions(*rate_args)
        got = trate.point_rate(*dv, opts)
        want = trate.point_rate_plain(*dv, opts)
        assert_exact(got[0].cpu().numpy(), want[0].cpu().numpy())
        assert_exact(got[2].cpu().numpy(), want[2].cpu().numpy())
        assert_values(got[1].cpu().numpy(), want[1].cpu().numpy())


def test_union_pipeline_launches_each_kernel_once(cuda_device):
    ts, val, mask, offsets = _union_batch(6, False)
    spec = tpipe.PipelineSpec("sum", None, RateOptions(True))
    kernels.reset_launches()
    out = tpipe.run_union_pipeline(spec, *_on(cuda_device, ts, val, mask,
                                              offsets), False)
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} \
        == {"point_rate": 1, "union_merge": 1, "union_reduce": 1}
    plain = tpipe.run_union_pipeline(spec, t(ts), t(val), t(mask), offsets,
                                     False)
    assert_exact(out[0].cpu().numpy(), plain[0].numpy())
    assert_exact(out[2].cpu().numpy(), plain[2].numpy())
    assert_values(out[1].cpu().numpy(), plain[1].numpy())


def test_union_query_on_card_matches_cpu(cuda_device):
    """Queries without a downsample on the card and on the CPU answer
    alike, integer answers as integers."""
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    rng = np.random.default_rng(10)
    uid_maps = {"metric": {"m": 1, "mi": 2}, "tagk": {"host": 1, "g": 2},
                "tagv": {"h%d" % i: i + 1 for i in range(30)}}
    uid_maps["tagv"].update({"g0": 41, "g1": 42, "g2": 43})
    series = []
    for i in range(30):
        ts = np.sort(rng.choice(3_600_000, 400, replace=False)) + T0
        ival = np.cumsum(rng.integers(0, 1000, 400)) + 2**53
        series.append((1, {1: i + 1, 2: 41 + i % 3}, ts,
                       rng.normal(10, 2, 400), np.zeros(400, np.int64),
                       np.zeros(400, bool)))
        series.append((2, {1: i + 1, 2: 41 + i % 3}, ts,
                       ival.astype(np.float64), ival, np.ones(400, bool)))
    for m in ("sum:m{g=*}", "avg:m", "sum:rate{counter}:mi{g=*}",
              "sum:mi{g=*}", "dev:mi"):
        answers = []
        for dev in ("cpu", cuda_device):
            tsdb = load_state(uid_maps, series, device=dev)
            q = TSQuery(start="1356998400", end="1357002000",
                        queries=[parse_m_subquery(m)])
            q.validate()
            answers.append([r.to_json()
                            for r in tsdb.new_query_runner().run(q)])
        assert len(answers[0]) == len(answers[1]) > 0
        for a, b in zip(*answers):
            assert a["tags"] == b["tags"] and list(a["dps"]) == list(b["dps"])
            va, vb = list(a["dps"].values()), list(b["dps"].values())
            assert [type(x) for x in va] == [type(x) for x in vb]
            if m in ("sum:mi{g=*}",):
                assert va == vb
            else:
                np.testing.assert_allclose(va, vb, rtol=1e-9)


# -- slice 3: K4 window_order, K5 group_order, U3 union_order, MA ----------

ORDER_DS = ["first", "last", "diff", "mult", "median", "p999", "p99", "p95",
            "p90", "p75", "p50", "ep999r3", "ep99r3", "ep95r3", "ep90r3",
            "ep75r3", "ep50r3", "ep999r7", "ep99r7", "ep95r7", "ep90r7",
            "ep75r7", "ep50r7"]
ORDER_AGGS = ORDER_DS + ["none"]


# The order kernels are held to their plain versions on the CPU: torch's
# product scatter on the card multiplies in no fixed order (with an
# overflow to inf and a zero in one run the order decides between NaN and
# 0), and its division by a scalar multiplies by the reciprocal, which an
# int-mode percentile's truncation can see.


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("kind", list(PLANS))
def test_window_order_kernel_matches_plain(cuda_device, kind, int_values):
    batch = sorted_batch(np.random.default_rng(4), 64, 512,
                         int_values=int_values)
    args = _on(cuda_device, *batch)
    edges = PLANS[kind].window_edges(cuda_device)
    cpu_edges = PLANS[kind].window_edges("cpu")
    for func in ORDER_DS:
        for fill in FILLS:
            got = tds.window_order(*args, edges, func, fill, 2.5)
            want = tds.window_order_plain(*[t(x) for x in batch], cpu_edges,
                                          func, fill, 2.5)
            assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
            assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def test_group_order_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(20)
    dv = _on(cuda_device, *_grid(rng, 300, 48, True))
    contrib, participate, present = tga.grid_fill_rate(*dv, "lerp")
    gid = np.sort(rng.integers(0, 40, 300))
    gid[gid == 7] = 8                        # group 7 empty
    offsets = tga.group_offsets(gid, 64)
    for agg in ORDER_AGGS:
        got = tga.group_order(agg, contrib, participate, present,
                              offsets.to(cuda_device))
        want = tga.group_order_plain(agg, contrib.cpu(), participate.cpu(),
                                     present.cpu(), offsets)
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def test_group_order_kernel_long_group(cuda_device):
    """One group of 40,000 rows x 2 windows: far longer than a block's
    shared memory could stage, exact all the same."""
    rng = np.random.default_rng(22)
    contrib = np.round(rng.normal(0, 50, (40_000, 2)), 1)
    participate = rng.random((40_000, 2)) < 0.9
    c, p = _on(cuda_device, contrib, participate)
    offsets = torch.tensor([0, 40_000], device=cuda_device)
    for agg in ("median", "ep99r7", "p50", "ep50r3", "first", "mult"):
        got = tga.group_order(agg, c, p, p, offsets)
        want = tga.group_order_plain(agg, t(contrib), t(participate),
                                     t(participate), offsets.cpu())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())
    med = tga.group_order("median", c, p, p, offsets)[0].cpu().numpy()[0]
    for col in range(2):
        vals = np.sort(contrib[participate[:, col], col])
        assert med[col] == vals[len(vals) // 2]


@pytest.mark.parametrize("int_values", [False, True])
def test_union_order_kernel_matches_plain(cuda_device, int_values):
    ts, val, mask, offsets = _union_batch(7, int_values)
    d_ts, d_val, d_mask, d_off = _on(cuda_device, ts, val, mask, offsets)
    u, uoff = tua.union_merge(d_ts, d_mask, d_off)
    for func in ORDER_AGGS:
        for policy in ("lerp", "zim", "prev"):
            got = tua.union_order(d_ts, d_val, d_mask, d_off, u, uoff, func,
                                  policy)
            want = tua.union_order_plain(t(ts), t(val), t(mask), offsets,
                                         u.cpu(), uoff.cpu(), func, policy)
            if int_values:
                assert_exact(got.cpu().numpy(), want.cpu().numpy())
            else:
                assert_values(got.cpu().numpy(), want.cpu().numpy())


def test_union_order_int_median_above_2_53(cuda_device):
    """Longs above 2^53 that share a float64: the median is the exact long,
    on the card as on the CPU."""
    base = 2**60
    ts = np.tile(np.arange(4, dtype=np.int64) * 1000 + T0, (5, 1))
    val = base + np.arange(20, dtype=np.int64).reshape(5, 4) * 3
    mask = np.ones_like(ts, bool)
    d = _on(cuda_device, ts, val, mask, np.array([0, 5], np.int64))
    u, out, _ = tua.union_aggregate(*d, "median", "lerp")
    assert out.dtype == torch.int64
    assert out.cpu().tolist() == [int(np.sort(val[:, j])[2])
                                  for j in range(4)]


@pytest.mark.parametrize("int_values", [False, True])
def test_moving_average_kernel_matches_plain(cuda_device, int_values):
    """Runs of uneven length, one empty, one whose live slots are sparse
    (every 37th), and windows of 1, 5 and longer than a run."""
    rng = np.random.default_rng(30)
    sums = rng.normal(100.0, 40.0, 5_000)
    if int_values:
        sums = (sums * 1e6).astype(np.int64) + 2**55
    live = rng.random(5_000) < 0.8
    live[1000:3000] = np.arange(2000) % 37 == 0
    offsets = np.array([0, 10, 10, 1000, 3000, 5000], np.int64)
    ds_, dl, do = _on(cuda_device, sums, live, offsets)
    for n_window in (1, 5, 300):
        for lv in (dl, None):
            got = tagg.moving_average(ds_, lv, do, n_window)
            want = tagg.moving_average_plain(ds_, lv, do, n_window)
            if int_values:
                assert_exact(got.cpu().numpy(), want.cpu().numpy())
            else:
                assert_values(got.cpu().numpy(), want.cpu().numpy())


def test_order_pipelines_launch_their_kernels(cuda_device):
    gid = np.array([0, 0, 0, 1, 1, 3, 3, 3], np.int64)
    batch = sorted_batch(np.random.default_rng(23), len(gid), 128)
    edges = PLANS["fixed"].window_edges(cuda_device)
    cases = {
        ("p99", "first"): {"window_order": 1, "grid_fill_rate": 1,
                           "group_order": 1},
        ("movingAverage3", "sum"): {"window_moments": 1,
                                    "grid_fill_rate": 1,
                                    "group_moments": 2, "moving_average": 1},
        ("sum", "movingAverage"): {"window_moments": 1, "moving_average": 1,
                                   "grid_fill_rate": 1, "group_moments": 1},
    }
    for (agg, ds_fn), launches in cases.items():
        spec = tpipe.PipelineSpec(agg, tpipe.DownsampleStep(ds_fn))
        kernels.reset_launches()
        out = tpipe.run_group_pipeline(spec, *_on(cuda_device, *batch), gid,
                                       4, edges)
        torch.cuda.synchronize()
        assert {k: n for k, n in kernels.LAUNCHES.items() if n} == launches
        plain = tpipe.run_group_pipeline(spec, *[t(x) for x in batch], gid,
                                         4, PLANS["fixed"].window_edges("cpu"))
        assert_exact(out[2].cpu().numpy(), plain[2].numpy())
        assert_values(out[1].cpu().numpy(), plain[1].numpy())
    ts, val, mask, offsets = _union_batch(8, False)
    for agg, launches in (("median", {"union_merge": 1, "union_order": 1}),
                          ("movingAverage", {"union_merge": 1,
                                             "union_reduce": 2,
                                             "moving_average": 1})):
        kernels.reset_launches()
        out = tpipe.run_union_pipeline(tpipe.PipelineSpec(agg), *_on(
            cuda_device, ts, val, mask, offsets), False)
        torch.cuda.synchronize()
        assert {k: n for k, n in kernels.LAUNCHES.items() if n} == launches
        plain = tpipe.run_union_pipeline(tpipe.PipelineSpec(agg), t(ts),
                                         t(val), t(mask), offsets, False)
        assert_values(out[1].cpu().numpy(), plain[1].numpy())


def test_order_queries_on_card_match_cpu(cuda_device):
    """Order, rank and movingAverage queries on both paths answer on the
    card as on the CPU, integer answers as integers."""
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    rng = np.random.default_rng(11)
    uid_maps = {"metric": {"m": 1, "mi": 2}, "tagk": {"host": 1, "g": 2},
                "tagv": {"h%d" % i: i + 1 for i in range(30)}}
    uid_maps["tagv"].update({"g0": 41, "g1": 42, "g2": 43})
    series = []
    for i in range(30):
        ts = np.sort(rng.choice(3_600_000, 400, replace=False)) + T0
        ival = np.cumsum(rng.integers(0, 1000, 400)) + 2**53
        series.append((1, {1: i + 1, 2: 41 + i % 3}, ts,
                       rng.normal(10, 2, 400), np.zeros(400, np.int64),
                       np.zeros(400, bool)))
        series.append((2, {1: i + 1, 2: 41 + i % 3}, ts,
                       ival.astype(np.float64), ival, np.ones(400, bool)))
    for m in ("p99:5m-avg:m{g=*}", "sum:5m-p95:m{g=*}",
              "last:5m-first:m{g=*}", "movingAverage5:5m-sum:m{g=*}",
              "p99:m{g=*}", "diff:rate:m{g=*}", "median:mi{g=*}",
              "first:mi{g=*}", "ep99r7:mi", "movingAverage5:m{g=*}",
              "movingAverage3:mi{g=*}"):
        answers = []
        for dev in ("cpu", cuda_device):
            tsdb = load_state(uid_maps, series, device=dev)
            q = TSQuery(start="1356998400", end="1357002000",
                        queries=[parse_m_subquery(m)])
            q.validate()
            answers.append([r.to_json()
                            for r in tsdb.new_query_runner().run(q)])
        assert len(answers[0]) == len(answers[1]) > 0, m
        for a, b in zip(*answers):
            assert a["tags"] == b["tags"] and list(a["dps"]) == list(b["dps"])
            va, vb = list(a["dps"].values()), list(b["dps"].values())
            assert [type(x) for x in va] == [type(x) for x in vb], m
            if isinstance(va[0], int):
                assert va == vb, m
            else:
                np.testing.assert_allclose(va, vb, rtol=1e-9, atol=1e-9)


def test_gather_windows_kernel_matches_plain(cuda_device):
    """G1 against its plain version: rows of every length, empty rows, a
    row at the buffer's end, and more rows than grid.y holds (the rows
    past it are walked by a stride)."""
    rng = np.random.default_rng(31)
    p = 100_000
    ts_buf = np.cumsum(rng.integers(1, 5000, p)) + T0
    val_buf = rng.normal(0.0, 1e3, p)
    cases = []
    lengths = rng.integers(0, 2000, 300)
    lengths[::17] = 0
    starts = rng.integers(0, p - 2000, 300)
    starts[7] = p - lengths[7]
    cases.append((starts, lengths, int(lengths.max()) + 5))
    cases.append((rng.integers(0, p - 4, 70_000), rng.integers(0, 4, 70_000),
                  4))
    for starts, lengths, n in cases:
        args = _on(cuda_device, ts_buf, val_buf, starts, lengths)
        kernels.reset_launches()
        got = tdc.gather_windows(*args, n)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["gather_windows"] == 1
        want = tdc.gather_windows_plain(*args, n)
        for a, b in zip(got, want):
            assert_exact(a.cpu().numpy(), b.cpu().numpy())


def test_int32_gather_kernel_matches_plain(cuda_device):
    """G1's int32 form against its plain version: offsets, values and
    masks exact, a base past some points clipping them to 0, and counted
    under gather_windows.i32."""
    rng = np.random.default_rng(33)
    p = 100_000
    ts_buf = np.cumsum(rng.integers(1, 5000, p)) + T0
    val_buf = rng.normal(0.0, 1e3, p)
    lengths = rng.integers(0, 2000, 300)
    lengths[::17] = 0
    starts = rng.integers(0, p - 2000, 300)
    args = _on(cuda_device, ts_buf, val_buf, starts, lengths)
    n = int(lengths.max()) + 5
    for base in (T0, int(ts_buf[p // 2])):
        kernels.reset_launches()
        got = tdc.gather_windows(*args, n, base)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["gather_windows"] == 1
        assert kernels.LAUNCHES["gather_windows.i32"] == 1
        assert got[0].dtype == torch.int32
        want = tdc.gather_windows_plain(*args, n, base)
        for a, b in zip(got, want):
            assert_exact(a.cpu().numpy(), b.cpu().numpy())


ORDER_FUNCS = ["first", "last", "diff", "mult", "median", "p95", "ep99r7"]


@pytest.mark.parametrize("kind", ["moments", "order"])
def test_int32_window_kernels_match_plain_and_int64(cuda_device, kind):
    """K1's and K4's int32 forms against their plain versions (rtol 1e-9,
    masks exact) and bit for bit against their int64 forms on the same
    points."""
    ts, val, mask = sorted_batch(np.random.default_rng(17), 64, 512)
    ts32 = np.clip(ts - T0, 0, tds.I32_PAD_TS).astype(np.int32)
    d_ts, d_ts32, d_val, d_mask = _on(cuda_device, ts, ts32, val, mask)
    edges = PLANS["fixed"].window_edges(cuda_device)
    edges32 = tds.compact_edges(edges, T0)
    fn = tds.window_moments if kind == "moments" else tds.window_order
    plain = tds.window_moments_plain if kind == "moments" \
        else tds.window_order_plain
    for func in (FUNCS if kind == "moments" else ORDER_FUNCS):
        kernels.reset_launches()
        got = fn(d_ts32, d_val, d_mask, edges32, func)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[fn.__name__ + ".i32"] == 1
        want = plain(d_ts32, d_val, d_mask, edges32, func)
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())
        wide = fn(d_ts, d_val, d_mask, edges, func)
        assert torch.equal(got[1], wide[1])
        assert torch.equal(got[0].nan_to_num(7.5), wide[0].nan_to_num(7.5))


@pytest.mark.parametrize("func", ["avg", "squareSum", "median"])
def test_wide_dynamic_range_kernels_are_exact(cuda_device, func):
    """-1e15 in the first 1m window, then one point in each of the next
    four: K1 and K4 give the exact values in both forms."""
    wide = [-1e15, -35.48827592954828, 2.0, 1.25, 0.1]
    want = [v * v for v in wide] if func == "squareSum" else wide
    ts = (T0 + 30_000 + np.arange(5, dtype=np.int64) * 60_000)[None, :]
    edges = tds.FixedWindows.for_range(T0, T0 + 299_999,
                                       60_000).window_edges(cuda_device)
    val, mask = _on(cuda_device, np.array([wide]), np.ones((1, 5), bool))
    for batch_ts, base in ((ts, None), ((ts - T0).astype(np.int32), T0)):
        (d_ts,) = _on(cuda_device, batch_ts)
        _, out, out_mask = tds.downsample(d_ts, val, mask, func, edges,
                                          ts_base=base)
        assert out_mask.all()
        assert out[0].cpu().tolist() == want


def test_warm_query_on_card_matches_cold(cuda_device):
    """A grouped query answers alike cold (the entry built inline, then
    gathered), warm (gathered from the entry) and with the cache off (the
    host batch); only the cached TSDB launches G1, once a query."""
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    from opentsdb_tpu_torch.utils.config import Config
    rng = np.random.default_rng(9)
    uid_maps = {"metric": {"m": 1}, "tagk": {"host": 1, "g": 2},
                "tagv": {"h%d" % i: i + 1 for i in range(40)}}
    uid_maps["tagv"].update({"g0": 41, "g1": 42, "g2": 43})
    series = []
    for i in range(40):
        k = int(rng.integers(300, 600))
        ts = np.sort(rng.choice(3_600_000, k, replace=False)) + T0
        series.append((1, {1: i + 1, 2: 41 + i % 3}, ts,
                       rng.normal(10, 2, k), np.zeros(k, np.int64),
                       np.zeros(k, bool)))
    # a plan this small prices onto the batched route, which skips the
    # device cache, and a repeat may take the aggregate cache's rewrite:
    # the cache's case turns both off
    cached = load_state(uid_maps, series, config=Config(
        {"tsd.query.batch.enable": False,
         "tsd.query.cache.enable": False}), device=cuda_device)
    host = load_state(uid_maps, series, config=Config(
        {"tsd.query.device_cache.enable": False,
         "tsd.query.batch.enable": False,
         "tsd.query.cache.enable": False}), device=cuda_device)
    for m in ("sum:5m-avg:rate:m{g=*}", "p99:5m-median:m{g=*}"):
        q = TSQuery(start="1356998400", end="1357002000",
                    queries=[parse_m_subquery(m)])
        q.validate()
        runs = []
        for tsdb in (cached, cached, host):
            kernels.reset_launches()
            runner = tsdb.new_query_runner()
            res = runner.run(q)
            runs.append((repr([r.to_json() for r in res]),
                         runner.exec_stats.get("deviceCacheHit"),
                         kernels.LAUNCHES["gather_windows"]))
        cold, warm, miss = runs
        assert (cold[1], warm[1], miss[1]) == (1.0, 1.0, None), m
        assert (cold[2], warm[2], miss[2]) == (1, 1, 0), m
        assert cold[0] == warm[0] == miss[0], m
    assert cached.device_cache.builds == 1
    (entry,) = cached.device_cache._entries.values()
    assert entry.ts_dev.device.type == "cuda"
    assert entry.val_dev.device.type == "cuda"


def test_histogram_accumulate_kernel_matches_plain(cuda_device):
    """H1: the int64 grid equals index_add_'s exactly, for spread entries
    and for entries piled onto a few cells; negative counts add; entries
    outside the grid raise."""
    from opentsdb_tpu_torch.histogram import kernels as hk
    rng = np.random.default_rng(21)
    r, b = 300, 32
    for nnz, cells in ((200_000, r * b), (200_000, 40)):
        seg = rng.integers(0, cells, nnz).astype(np.int64)
        cnt = rng.integers(0, 1 << 40, nnz).astype(np.int64)
        cnt[::5] = 0
        args = _on(cuda_device, seg, cnt)
        kernels.reset_launches()
        got = hk.accumulate_rows(*args, r, b)
        assert kernels.LAUNCHES["histogram_accumulate"] == 1
        want = hk.accumulate_rows_plain(*args, r, b)
        assert_exact(got.cpu().numpy(), want.cpu().numpy())
    # a negative count is added, as the reference's segment sum adds it
    neg = _on(cuda_device, np.array([0, 1, 1]), np.array([1, -1, -3]))
    assert_exact(hk.accumulate_rows(*neg, 2, 2).cpu().numpy(),
                 hk.accumulate_rows_plain(*neg, 2, 2).cpu().numpy())
    with pytest.raises(ValueError, match="outside the grid"):
        hk.accumulate_rows(*_on(cuda_device, np.array([0, 4]),
                                np.array([1, 1])), 2, 2)


@pytest.mark.parametrize("layout", ["runs", "cancelling runs", "tail"])
def test_histogram_accumulate_runs_kernel_matches_plain(cuda_device,
                                                        layout):
    """H1 where a lane's entries (32 apart) hit one cell in runs, as a
    coarse downsample's do: the runs' register sums equal index_add_'s
    grid exactly, runs that cancel to zero included, and a ragged last
    tile."""
    from opentsdb_tpu_torch.histogram import kernels as hk
    rng = np.random.default_rng(len(layout))
    b = 32
    nnz = 300_000 if layout != "tail" else 300_000 - 171
    e = np.arange(nnz, dtype=np.int64)
    # 32 buckets a point, 60 points a window, every 4th series a group
    seg = ((e // (b * 60)) % 500) * b + e % b
    cnt = rng.integers(-50, 100, nnz).astype(np.int64)
    if layout == "cancelling runs":
        cnt[b::2 * b] = -cnt[::2 * b][:cnt[b::2 * b].size]
    args = _on(cuda_device, seg, cnt)
    kernels.reset_launches()
    got = hk.accumulate_rows(*args, 500, b)
    assert kernels.LAUNCHES["histogram_accumulate"] == 1
    want = hk.accumulate_rows_plain(*args, 500, b)
    assert_exact(got.cpu().numpy(), want.cpu().numpy())


def test_histogram_accumulate_deferred_flag_on_card(cuda_device):
    """H1's deferred form launches once and does not raise at the call;
    its flag, read with the grid in one copy, raises on a stray entry,
    and the grid holds the other entries.  The query path raises the
    same ValueError before any answer, after one launch."""
    from opentsdb_tpu_torch.histogram import kernels as hk
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    from opentsdb_tpu_torch.query import planner
    from opentsdb_tpu_torch.utils.config import Config
    seg = np.array([0, 3, 7, 2, 3], np.int64)
    cnt = np.array([4, 1, 1, -2, 5], np.int64)
    args = _on(cuda_device, seg, cnt)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="outside the grid of 6 cells"):
        hk.accumulate_rows(*args, 2, 3)
    assert kernels.LAUNCHES["histogram_accumulate"] == 1
    kernels.reset_launches()
    acc = hk.accumulate_rows_deferred(*args, 2, 3)
    assert kernels.LAUNCHES["histogram_accumulate"] == 1
    host = acc.buffer.cpu()
    with pytest.raises(ValueError, match="outside the grid of 6 cells"):
        acc.check(host[-1])
    want = hk.accumulate_rows_deferred_plain(*(torch.from_numpy(x)
                                               for x in (seg, cnt)), 2, 3)
    assert_exact(host.numpy(), want.buffer.numpy())

    uid_maps = {"metric": {"h": 1}, "tagk": {"host": 1},
                "tagv": {"h%d" % i: i + 1 for i in range(4)}}
    bounds = np.array([[2.0 ** k, 2.0 ** (k + 1)] for k in range(8)])
    rng = np.random.default_rng(29)
    ts = T0 + np.arange(60, dtype=np.int64) * 60_000
    histograms = [(1, {1: i + 1}, ts,
                   [(bounds, rng.integers(0, 50, 8).astype(np.int64), 0, 0)
                    for _ in ts]) for i in range(4)]
    tsdb = load_state(uid_maps, [], config=Config({
        "tsd.core.histograms.config": '{"SimpleHistogramDecoder": 0}'}),
        device=cuda_device, histograms=histograms)
    assemble = planner.assemble_columnar

    def with_stray(*a, **k):
        batch = assemble(*a, **k)
        batch["seg"] = np.append(batch["seg"], np.int64(
            batch["n_rows"] * batch["n_buckets"]))
        batch["cnt"] = np.append(batch["cnt"], np.int64(1))
        return batch

    for m in ("sum:percentiles[50,99]:h", "sum:show-histogram-buckets:h"):
        q = TSQuery(start="1356998400", end="1357002000",
                    queries=[parse_m_subquery(m)])
        q.validate()
        assert tsdb.new_query_runner().run(q)
        planner.assemble_columnar = with_stray
        try:
            kernels.reset_launches()
            with pytest.raises(ValueError, match="outside the grid of"):
                tsdb.new_query_runner().run(q)
            assert kernels.LAUNCHES["histogram_accumulate"] == 1
        finally:
            planner.assemble_columnar = assemble


@pytest.mark.parametrize("rows", range(4))
@pytest.mark.parametrize("cls", ["spread"] + H2_EDGE_CLASSES)
@pytest.mark.parametrize("b", sorted(set(H2_EDGE_WIDTHS + [7, 32, 45])))
def test_histogram_percentile_kernel_matches_plain(cuda_device, b, cls,
                                                   rows):
    """H2 against the plain version, exactly, at the widths where its
    layout changes, on torch_parity.h2_edge_rows' row counts: one row,
    1,001 (no multiple of a block's rows) and grids that take 4 and 8
    buckets a lane.  "spread": empty rows, p outside [1, 100], ties, and
    totals near 2^50 whose share of the last bucket rounds under 100 (the
    answer is then bucket 0's midpoint); the edge classes of
    torch_parity.h2_edge_counts under 0, 1 and 70 percentiles."""
    r = h2_edge_rows(b)[rows]
    from opentsdb_tpu_torch.histogram import kernels as hk
    if cls == "spread":
        rng = np.random.default_rng(b)
        counts = rng.integers(0, 40, (r, b)).astype(np.int64)
        counts[rng.random((r, b)) < 0.5] = 0
        counts[:10] = 0
        big = rng.integers(1 << 50, 1 << 51, 200)
        counts[10:210, -1] = big[:len(counts[10:210])]
        mid = np.sort(rng.uniform(0, 1000, b))
        percs_sets = [np.array([50.0, 90.0, 99.0, 99.9, 100.0, 1.0, 0.5,
                                101.0])]
    else:
        counts, mid = h2_edge_counts(r, b, cls)
        percs_sets = [h2_edge_percs(n) for n in H2_EDGE_PS]
    for percs in percs_sets:
        args = _on(cuda_device, counts, mid, percs)
        kernels.reset_launches()
        got = hk.percentile_rows(*args)
        assert kernels.LAUNCHES["histogram_percentile"] == (
            1 if len(percs) else 0)
        want = hk.percentile_rows_plain(*(a.cpu() for a in args))
        assert_exact(got.cpu().numpy(), want.numpy())
    if cls == "spread" and r > 10:
        assert (got[4, 10:210] == float(mid[0])).any()


def test_histogram_query_on_card_matches_cpu(cuda_device):
    """A percentile and show-buckets query answers alike on the card and
    on the CPU (load_state), through one H1 and one H2 launch."""
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    from opentsdb_tpu_torch.utils.config import Config
    rng = np.random.default_rng(23)
    uid_maps = {"metric": {"h": 1}, "tagk": {"host": 1, "g": 2},
                "tagv": {"h%d" % i: i + 1 for i in range(30)}}
    uid_maps["tagv"].update({"g0": 41, "g1": 42, "g2": 43})
    bounds = np.array([[2.0 ** k, 2.0 ** (k + 1)] for k in range(16)])
    histograms = []
    for i in range(30):
        ts = T0 + np.arange(120, dtype=np.int64) * 30_000
        points = [(bounds, rng.integers(0, 100, 16).astype(np.int64), 0, 0)
                  for _ in ts]
        histograms.append((1, {1: i + 1, 2: 41 + i % 3}, ts, points))
    config = {"tsd.core.histograms.config": '{"SimpleHistogramDecoder": 0}'}
    answers = []
    for dev in ("cpu", cuda_device):
        tsdb = load_state(uid_maps, [], config=Config(config), device=dev,
                          histograms=histograms)
        q = TSQuery(start="1356998400", end="1357002000", queries=[
            parse_m_subquery("sum:5m-sum:percentiles[50,99,100]:"
                             "show-histogram-buckets:h{g=*}")])
        q.validate()
        kernels.reset_launches()
        answers.append([r.to_json() for r in tsdb.new_query_runner().run(q)])
    assert kernels.LAUNCHES["histogram_accumulate"] == 1
    assert kernels.LAUNCHES["histogram_percentile"] == 1
    assert answers[0] == answers[1] and len(answers[0]) == 3 * (3 + 16)


# -- the rollup kernels: L1 lane_partials and L2 rollup_avg ----------------


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("interval_ms", [60_000, 900_000])
def test_lane_partials_kernel_matches_plain(cuda_device, interval_ms,
                                            int_values):
    """L1 against its plain version: counts, minima and maxima exactly,
    sums at rtol 1e-9 (exactly on integers), in both of its modes (short
    runs a thread a window at 1m, long runs a warp a window at 15m); and
    on integers each cell equals K1's sum, count, min and max of its
    window bit for bit."""
    from opentsdb_tpu_torch.ops import lanes
    batch = sorted_batch(np.random.default_rng(interval_ms), 64, 2048,
                         int_values=int_values)
    args = _on(cuda_device, *batch)
    edges = tds.FixedWindows.for_range(T0, T0 + 3_600_000,
                                       interval_ms).window_edges(cuda_device)
    kernels.reset_launches()
    got = lanes.lane_partials(*args, edges)
    assert kernels.LAUNCHES["lane_partials"] == 1
    want = lanes.lane_partials_plain(*args, edges)
    if int_values:
        assert_exact(got[0].cpu().numpy(), want[0].cpu().numpy())
    else:
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())
    for g, w in zip(got[1:], want[1:]):
        assert_exact(g.cpu().numpy(), w.cpu().numpy())
    if int_values:
        for agg, part in (("sum", got[0]), ("count", got[1]),
                          ("min", got[2]), ("max", got[3])):
            v, m = tds.window_moments(*args, edges, agg)
            assert_exact(v[m].cpu().numpy(), part.double()[m].cpu().numpy())


@pytest.mark.parametrize("fill", ["none", "zero", "scalar"])
@pytest.mark.parametrize("int_counts", [False, True])
@pytest.mark.parametrize("interval_ms", [300_000, 3_600_000])
def test_rollup_avg_kernel_matches_plain(cuda_device, interval_ms,
                                         int_counts, fill):
    """L2 against its plain version over a sum lane and a count lane with
    their own timestamps, float or int64 counts, in both of its modes:
    masks equal, values at rtol 1e-9."""
    from opentsdb_tpu_torch.ops import lanes
    rng = np.random.default_rng(interval_ms + int_counts)
    ts_s, val_s, mask_s = sorted_batch(rng, 48, 1500)
    ts_c, val_c, mask_c = sorted_batch(rng, 48, 1200, int_values=True)
    val_c = np.abs(val_c) % 9
    if not int_counts:
        val_c = val_c.astype(np.float64)
    args = _on(cuda_device, ts_s, val_s, mask_s, ts_c, val_c, mask_c)
    edges = tds.FixedWindows.for_range(T0, T0 + 3_600_000,
                                       interval_ms).window_edges(cuda_device)
    kernels.reset_launches()
    got = lanes.rollup_avg(*args, edges, fill, -4.0)
    assert kernels.LAUNCHES["rollup_avg"] == 1
    want = lanes.rollup_avg_plain(*args, edges, fill, -4.0)
    assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
    assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def test_rollups_on_card_match_cpu(cuda_device):
    """The rollup job (L1), written-rollup avg reads (L2 and the tail) and
    a lane-served query (blocks built through L1) answer on the card as
    on the CPU: groups and timestamps exactly, values at rtol 1e-9 (the
    group sums of K3 add in another order)."""
    from opentsdb_tpu_torch.core import TSDB
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    from opentsdb_tpu_torch.rollup.job import run_rollup_job
    from opentsdb_tpu_torch.utils.config import Config
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.rollups.enable": True, "tsd.rollup.enable": True,
             "tsd.rollup.intervals": "1m", "tsd.rollup.block_windows": 16}
    vals = np.random.default_rng(8).integers(0, 500, (12, 720))
    queries = ("sum:1h-avg:r.m{g=*}", "sum:10m-avg:r.m{g=*}",
               "sum:2m-sum:rollup_raw:r.m{g=*}")
    answers = []
    for dev in ("cpu", cuda_device):
        tsdb = TSDB(Config(props), device=dev)
        for i in range(12):
            key = tsdb._series_key("r.m", {"host": "h%d" % i,
                                           "g": "g%d" % (i % 3)}, True)
            ts = T0 + np.arange(720, dtype=np.int64) * 10_000
            tsdb.store.add_batch(key, ts, vals[i], True)
        kernels.reset_launches()
        run_rollup_job(tsdb, intervals=["1m", "1h"])

        def run(m):
            q = TSQuery(start=str(T0 // 1000 + 5),
                        end=str(T0 // 1000 + 7195),
                        queries=[parse_m_subquery(m)])
            q.validate()
            runner = tsdb.new_query_runner()
            return [r.to_json() for r in runner.run(q)], runner.exec_stats

        out = [run(m)[0] for m in queries]
        while tsdb.rollup_lanes.refresh(tsdb.store, max_blocks=64):
            pass
        served, stats = run(queries[-1])
        assert stats.get("rollupLane") == 1.0
        out.append(served)
        if dev != "cpu":
            assert kernels.LAUNCHES["lane_partials"] >= 3
            assert kernels.LAUNCHES["rollup_avg"] == 2
        answers.append(out)
    for cpu, card in zip(*answers):
        assert [(r["tags"], list(r["dps"])) for r in card] \
            == [(r["tags"], list(r["dps"])) for r in cpu]
        assert_values([v for r in card for v in r["dps"].values()],
                      [v for r in cpu for v in r["dps"].values()])


# -- the stream kernels (S1 stream_fold, S2 sketch_fold, S3 stream_finish) --


def _stream_pair(dev, batch, windows, chunk, sliced, sketch, lanes=None):
    """The same chunks through an accumulator on the card and one on the
    CPU (the plain versions); returns both."""
    ts, val, mask = batch
    s, n = ts.shape
    ws = None
    if sliced:
        ws = max(int((ts[:, k:k + chunk][mask[:, k:k + chunk]].max()
                      - ts[:, k:k + chunk][mask[:, k:k + chunk]].min())
                     // windows.interval_ms) + 2
                 for k in range(0, n, chunk) if mask[:, k:k + chunk].any())
    accs = [tst.StreamAccumulator.create(s, windows, d, sketch=sketch,
                                         lanes=lanes, window_slice=ws)
            for d in (dev, "cpu")]
    for k in range(0, n, chunk):
        sl = slice(k, k + chunk)
        w0 = None
        if sliced and mask[:, sl].any():
            w0 = int((ts[:, sl][mask[:, sl]].min() - windows.first_window_ms)
                     // windows.interval_ms)
        for acc in accs:
            acc.update(*_on(acc.device, np.ascontiguousarray(ts[:, sl]),
                            np.ascontiguousarray(val[:, sl]).astype(
                                np.float64),
                            np.ascontiguousarray(mask[:, sl])), w0=w0)
    return accs


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("interval_ms", [10_000, 300_000])
def test_stream_fold_kernel_matches_plain(cuda_device, interval_ms, sliced):
    """S1 in both of its modes (a thread a 10 s window, a warp a 5 min
    one), full-grid and sliced, every lane, then S3 for every function
    and fill."""
    batch = sorted_batch(np.random.default_rng(21), 16, 1024)
    windows = tds.FixedWindows.for_range(T0, T0 + 3_600_000, interval_ms)
    card, cpu = _stream_pair(cuda_device, batch, windows, 256, sliced, False)
    assert card.oob_count() == cpu.oob_count() == 0
    for k in cpu.state:
        assert_values(card.state[k].cpu().numpy(), cpu.state[k].numpy())
    for fn in sorted(tst.STREAMABLE_DS):
        for fill in FILLS:
            _, got, gm = card.finish(fn, fill, -1.5)
            _, want, wm = cpu.finish(fn, fill, -1.5)
            assert_exact(gm.cpu().numpy(), wm.numpy())
            assert_values(got.cpu().numpy(), want.numpy())


def test_stream_fold_audits_a_wrong_slice(cuda_device):
    batch = sorted_batch(np.random.default_rng(22), 8, 512)
    windows = tds.FixedWindows.for_range(T0, T0 + 3_600_000, 10_000)
    ts, val, mask = batch
    accs = [tst.StreamAccumulator.create(8, windows, d, window_slice=64)
            for d in (cuda_device, "cpu")]
    for acc in accs:
        acc.update(*_on(acc.device, ts, val, mask), w0=100)
    assert accs[0].oob_count() == accs[1].oob_count() > 0


@pytest.mark.parametrize("chunk", [6000, 300])
@pytest.mark.parametrize("plan", ["fixed", "all"])
def test_sketch_fold_kernel_matches_plain(cuda_device, plan, chunk):
    """S2 over short runs (the shared-memory sort) and a "0all" run of
    4,096 points and more (the radix select), then S3's quantiles."""
    batch = sorted_batch(np.random.default_rng(23), 6, 6000)
    windows = PLANS[plan]
    card, cpu = _stream_pair(cuda_device, batch, windows, chunk, False, True)
    np.testing.assert_allclose(card.state["q"].cpu().numpy(),
                               cpu.state["q"].numpy(), rtol=1e-6, atol=1e-5)
    for fn in ("p95", "median", "ep99r7"):
        _, got, gm = card.finish(fn)
        _, want, wm = cpu.finish(fn)
        assert_exact(gm.cpu().numpy(), wm.numpy())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-5)


def test_streamed_queries_on_card_match_cpu(cuda_device):
    """A lowered point_threshold: the card's streamed answers equal the
    CPU's, S1, S2 and S3 launching on the way."""
    from opentsdb_tpu_torch.core import TSDB
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    from opentsdb_tpu_torch.utils.config import Config

    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.streaming.point_threshold": "100",
             "tsd.query.streaming.chunk_points": "4096"}
    queries = ("sum:10m-avg:s.m{g=*}", "max:1h-dev:s.m{g=*}",
               "sum:1h-p95:s.m{g=*}", "sum:30m-first:s.m")
    answers = []
    for dev in ("cpu", cuda_device):
        tsdb = TSDB(Config(props), device=dev)
        rng = np.random.default_rng(9)
        for i in range(12):
            key = tsdb._series_key("s.m", {"host": "h%d" % i,
                                           "g": "g%d" % (i % 3)}, True)
            ts = T0 + np.arange(3000, dtype=np.int64) * 10_000 + i
            tsdb.store.add_batch(key, ts, rng.normal(5, 2, 3000), False)
        kernels.reset_launches()
        out = []
        for m in queries:
            q = TSQuery(start=str(T0 // 1000), end=str(T0 // 1000 + 30_000),
                        queries=[parse_m_subquery(m)])
            q.validate()
            runner = tsdb.new_query_runner()
            out.append([r.to_json() for r in runner.run(q)])
            assert runner.exec_stats["streamedChunks"] == 3
        if dev != "cpu":
            assert kernels.LAUNCHES["stream_fold"] == 12
            assert kernels.LAUNCHES["sketch_fold"] == 3
            assert kernels.LAUNCHES["stream_finish"] == 4
        answers.append(out)
    for cpu, card in zip(*answers):
        assert [(r["tags"], list(r["dps"])) for r in card] \
            == [(r["tags"], list(r["dps"])) for r in cpu]
        np.testing.assert_allclose(
            [v for r in card for v in r["dps"].values()],
            [v for r in cpu for v in r["dps"].values()], rtol=1e-6)


# -- T1 tile_partials and the tiled route ---------------------------------


def _fold_pair(dev, spec, v, m, gid, g, rows):
    """The tiles of `rows` rows folded by K2 + T1 on `dev`, in the mode of
    the spec's aggregator -> acc."""
    from opentsdb_tpu_torch.ops import tiling
    s, w = v.shape
    wts = torch.arange(w, dtype=torch.int64, device=dev) * 60_000 + T0
    acc = tiling.new_lane_fold(g, w, tiling.lane_mode(spec.aggregator), dev)
    for lo in range(0, s, rows):
        tiling.run_lane_fold(
            spec, acc, wts, *_on(dev, v[lo:lo + rows], m[lo:lo + rows]),
            tga.group_offsets(gid[lo:lo + rows], g).to(dev))
    return acc


def _lane_tiles(rng, s=80, w=700, int_values=False):
    v = (rng.integers(-1000, 1000, (s, w)).astype(np.float64) if int_values
         else rng.normal(50.0, 20.0, (s, w)))
    v[rng.random((s, w)) < 0.03] = np.nan
    m = rng.random((s, w)) > 0.25
    m[5] = False
    gid = np.sort(rng.integers(0, 9, s))
    return v, m, gid


@pytest.mark.parametrize("rate", [None, ()])
@pytest.mark.parametrize("extreme", [False, True])
def test_tile_partials_kernel_matches_plain(cuda_device, extreme, rate):
    """T1 over four tiles against its plain version: counts, presence
    and extremes exact, sums at rtol 1e-9."""
    v, m, gid = _lane_tiles(np.random.default_rng(31))
    spec = tpipe.PipelineSpec("max" if extreme else "sum",
                              rate=None if rate is None
                              else RateOptions(*rate))
    card = _fold_pair(cuda_device, spec, v, m, gid, 9, 20)
    cpu = _fold_pair("cpu", spec, v, m, gid, 9, 20)
    for k in cpu:
        if k == "tot":
            assert_values(card[k].cpu().numpy(), cpu[k].numpy())
        else:
            assert_exact(card[k].cpu().numpy(), cpu[k].numpy())


@pytest.mark.parametrize("agg", ["sum", "count", "avg", "min", "max"])
def test_tile_fold_kernel_equals_group_moments(cuda_device, agg):
    """On integer data the fold of all tiles, finished, is K3 over the
    whole grid bit for bit."""
    from opentsdb_tpu_torch.ops import tiling
    v, m, gid = _lane_tiles(np.random.default_rng(32), int_values=True)
    spec = tpipe.PipelineSpec(agg)
    acc = _fold_pair(cuda_device, spec, v, m, gid, 9, 32)
    out, mask = tiling.finish_lane_fold(acc, agg)
    wts = torch.arange(v.shape[1], dtype=torch.int64,
                       device=cuda_device) * 60_000 + T0
    contrib, part, actual = tiling.tile_contrib(
        spec, wts, *_on(cuda_device, v, m))
    want, want_mask = tga.group_moments(
        agg, contrib, part, actual, tga.group_offsets(gid, 9).to(cuda_device))
    assert_exact(out.cpu().numpy(), want.cpu().numpy())
    assert_exact(mask.cpu().numpy(), want_mask.cpu().numpy())


def test_tiled_queries_on_card_match_cpu(cuda_device):
    """A 1 MB state budget: the card's tiled answers (chunk loop, K2, the
    spill pool, the striped K3/K5/MA replay) equal the CPU's."""
    from opentsdb_tpu_torch.core import TSDB
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    from opentsdb_tpu_torch.utils.config import Config

    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.device_cache.enable": "false",
             "tsd.query.streaming.point_threshold": "100",
             "tsd.query.streaming.chunk_points": "4096",
             "tsd.query.streaming.state_mb": "1"}
    queries = ("sum:10s-avg:s.m{g=*}", "dev:10s-max:rate:s.m{g=*}",
               "p99:10s-sum:s.m{g=*}", "movingAverage5:10s-sum:s.m{g=*}")
    answers = []
    for dev in ("cpu", cuda_device):
        tsdb = TSDB(Config(props), device=dev)
        rng = np.random.default_rng(9)
        for i in range(24):
            key = tsdb._series_key("s.m", {"host": "h%d" % i,
                                           "g": "g%d" % (i % 3)}, True)
            ts = T0 + np.sort(rng.choice(40_000, 400, replace=False)) \
                * 1000
            tsdb.store.add_batch(key, ts, rng.normal(5, 2, 400), False)
        out = []
        for m in queries:
            q = TSQuery(start=str(T0 // 1000), end=str(T0 // 1000 + 40_000),
                        queries=[parse_m_subquery(m)])
            q.validate()
            runner = tsdb.new_query_runner()
            out.append([r.to_json() for r in runner.run(q)])
            assert runner.exec_stats["tiledTiles"] >= 2
        answers.append(out)
    for cpu, card in zip(*answers):
        assert [(r["tags"], list(r["dps"])) for r in card] \
            == [(r["tags"], list(r["dps"])) for r in cpu]
        np.testing.assert_allclose(
            [v for r in card for v in r["dps"].values()],
            [v for r in cpu for v in r["dps"].values()], rtol=1e-9,
            atol=1e-9)


# -- the member-strided K1, K4 and K2 (the dispatch batcher's B14) --------


def _stacked_members(rng, q=5, s=6, n=160, w=12):
    """q members of [s, n] sorted rows, each with its own window edges
    [w+1] (its own range) and group ids."""
    members = []
    for i in range(q):
        base = T0 + i * 7_000_000
        ts = np.sort(base + rng.integers(0, w * 60_000, (s, n)), axis=1)
        val = rng.normal(50, 20, (s, n))
        mask = rng.random((s, n)) > 0.1
        g = 1 + i % 3
        gid = np.sort(np.concatenate([np.arange(g),
                                      rng.integers(0, g, s - g)]))
        edges = base + np.arange(w + 1, dtype=np.int64) * 60_000
        members.append((ts.astype(np.int64), val, mask, gid, g, edges))
    return members


@pytest.mark.parametrize("spec", [
    ("sum", "avg", None), ("max", "max", ()), ("p99", "p95", None),
    ("movingAverage3", "first", ()), ("dev", "movingAverage3", None)])
def test_stacked_pipeline_equals_plain_and_solo(cuda_device, spec):
    """One stacked dispatch of 5 members: each member's slice equals its
    solo dispatch bit for bit and the plain stacked pipeline at rtol
    1e-9; K1 or K4, K2 and K3 or K5 launch once each (MA once where the
    spec has one), counted as stacked."""
    agg, ds_fn, rate = spec
    pspec = tpipe.PipelineSpec(agg, tpipe.DownsampleStep(ds_fn),
                               None if rate is None else RateOptions(*rate))
    members = _stacked_members(np.random.default_rng(31))
    stack = [np.concatenate([m[i] for m in members]) for i in range(3)]
    gid = np.stack([m[3] for m in members])
    groups = [m[4] for m in members]
    edges = np.stack([m[5] for m in members])
    kernels.reset_launches()
    got = tpipe.run_stacked_group_pipeline(
        pspec, *_on(cuda_device, *stack), gid, groups,
        *_on(cuda_device, edges))
    torch.cuda.synchronize()
    fired = {k: n for k, n in kernels.LAUNCHES.items() if n}
    k1 = "window_order" if ds_fn in ("p95", "first") else "window_moments"
    k3 = "group_order" if agg == "p99" else "group_moments"
    assert fired[k1] == fired[k1 + ".stacked"] == 1
    assert fired["grid_fill_rate"] == fired["grid_fill_rate.stacked"] == 1
    assert fired[k3] == (2 if agg == "movingAverage3" else 1)
    assert fired.get("moving_average", 0) == (
        1 if "movingAverage3" in (agg, ds_fn) else 0)
    plain = tpipe.run_stacked_group_pipeline(
        pspec, *[t(x) for x in stack], gid, groups, t(edges))
    for m, mine, ref in zip(members, got, plain):
        solo = tpipe.run_group_pipeline(
            pspec, *_on(cuda_device, *m[:3]), m[3], m[4],
            *_on(cuda_device, m[5]))
        for a, b in zip(mine, solo):
            assert torch.equal(torch.nan_to_num(a, nan=7.25),
                               torch.nan_to_num(b, nan=7.25))
        assert_exact(mine[2].cpu().numpy(), ref[2].numpy())
        assert_values(mine[1].cpu().numpy(), ref[1].numpy())


@pytest.mark.parametrize("rate", [None, ()])
def test_stacked_kernels_match_plain(cuda_device, rate):
    """K1 and K4 over stacked edges [Q, W+1], K2 over stacked window
    timestamps [Q, W], against their plain versions."""
    members = _stacked_members(np.random.default_rng(32), q=4)
    d_ts, d_val, d_mask = _on(cuda_device, *[
        np.concatenate([m[i] for m in members]) for i in range(3)])
    (edges,) = _on(cuda_device, np.stack([m[5] for m in members]))
    for fn in ("sum", "dev", "min", "count"):
        got = tds.window_moments(d_ts, d_val, d_mask, edges, fn, "zero")
        want = tds.window_moments_plain(d_ts, d_val, d_mask, edges, fn,
                                        "zero")
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())
    for fn in ("p95", "median", "first", "mult"):
        got = tds.window_order(d_ts, d_val, d_mask, edges, fn)
        want = tds.window_order_plain(d_ts, d_val, d_mask, edges, fn)
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())
    v, m = tds.window_moments(d_ts, d_val, d_mask, edges, "avg")
    wts = edges[:, :-1].contiguous()
    opts = None if rate is None else RateOptions(*rate)
    for policy in POLICIES:
        got = tga.grid_fill_rate(wts, v, m, policy, opts)
        want = tga.grid_fill_rate_plain(wts, v, m, policy, opts)
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
        assert_exact(got[2].cpu().numpy(), want[2].cpu().numpy())
        assert_values(got[0].cpu().numpy(), want[0].cpu().numpy())


def test_batcher_on_card_stacks_and_matches_solo(cuda_device):
    """Four members through the dispatch batcher's rendezvous on the card:
    one stacked dispatch, each answer the solo pipeline's bit for bit."""
    import threading
    from types import SimpleNamespace
    from opentsdb_tpu_torch.query.batcher import DispatchBatcher
    from opentsdb_tpu_torch.utils.config import Config

    # a TSDB whose admission gate shows other queries in flight, so that
    # the leader holds the bucket open for the others
    tsdb = SimpleNamespace(device=cuda_device, admission_gate=SimpleNamespace(
        demand=lambda: 8))
    batcher = DispatchBatcher(Config({"tsd.query.batch.hold_ms": "5000",
                                      "tsd.query.batch.max_q": "4"}),
                              tsdb=tsdb)
    members = [(m[0], m[1], m[2], np.zeros(6, np.int64), 1, m[5])
               for m in _stacked_members(np.random.default_rng(33), q=4)]
    spec = tpipe.PipelineSpec("sum", tpipe.DownsampleStep("avg"))
    out = [None] * 4

    def run(i):
        m = members[i]
        out[i] = batcher.submit(spec, *m[:4], m[4], m[5])

    pool = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(60)
    assert all(o is not None and o[1]["q"] == 4 for o in out)
    assert batcher.collect_stats()["tsd.query.batch.stacked_dispatches"] \
        == 1.0
    for m, (got, _info) in zip(members, out):
        solo = tpipe.run_group_pipeline(
            spec, *_on(cuda_device, *m[:3]), m[3], 1,
            *_on(cuda_device, m[5]))
        for a, b in zip(got, solo):
            assert np.array_equal(a, b.cpu().numpy(), equal_nan=True)


# -- the device mesh (parallel/): T1's square and centred modes, the
#    sharded pipeline on a virtual and a one-device NCCL mesh


@pytest.mark.parametrize("mode", ["square", "centred"])
def test_tile_partials_modes_kernel_match_plain(cuda_device, mode):
    """T1's square and centred modes against their plain versions:
    counts and presence exact, sums, squares and centred squares at rtol
    1e-9; each launch counted under its mode."""
    from opentsdb_tpu_torch.ops import tiling
    rng = np.random.default_rng(41)
    s, w, g = 300, 130, 7
    contrib = rng.normal(30.0, 12.0, (s, w))
    contrib[rng.random((s, w)) < 0.1] = np.nan
    part = rng.random((s, w)) < 0.85
    present = rng.random((s, w)) < 0.8
    gid = np.sort(rng.integers(0, g, s))
    mean = rng.normal(30.0, 5.0, (g, w))
    off = tga.group_offsets(gid, g)
    extra = {"mean": t(mean)} if mode == "centred" else {}
    want = tiling.new_lane_fold(g, w, mode, "cpu")
    tiling.tile_partials(t(contrib), t(part), t(present), off, want,
                         **extra)
    got = tiling.new_lane_fold(g, w, mode, cuda_device)
    kernels.reset_launches()
    tiling.tile_partials(*_on(cuda_device, contrib, part, present),
                         off.to(cuda_device), got,
                         **{k: v.to(cuda_device) for k, v in extra.items()})
    assert kernels.LAUNCHES["tile_partials." + mode] == 1
    for lane in want:
        if lane in ("cnt", "present"):
            assert_exact(got[lane].cpu().numpy(), want[lane].numpy())
        else:
            assert_values(got[lane].cpu().numpy(), want[lane].numpy())


@pytest.mark.parametrize("shards", [4, 1])
@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "squareSum", "max",
                                 "p95", "first", "movingAverage3"])
def test_sharded_pipeline_on_card_matches_one_device(cuda_device, shards,
                                                     agg):
    """sharded_query_pipeline on four shards of the card (the shared
    combine) and on a one-device NCCL mesh against run_group_pipeline on
    the card: masks exact, values at rtol 1e-9; with one shard, bit for
    bit."""
    from opentsdb_tpu_torch.parallel import (make_mesh, shard_rows,
                                             sharded_query_pipeline)
    mesh = make_mesh(devices=[cuda_device] * shards)
    assert mesh.backend == ("shared" if shards > 1 else "nccl")
    ts, val, mask = sorted_batch(np.random.default_rng(43), 13, 200)
    gid = np.array([0, 0, 0, 1, 1, 3, 3, 3, 3, 4, 4, 4, 4])
    spec = tpipe.PipelineSpec(agg, tpipe.DownsampleStep("avg", "none"),
                              RateOptions() if agg == "max" else None)
    edges = PLANS["fixed"].window_edges(cuda_device)
    got = sharded_query_pipeline(mesh, spec, 5,
                                 shard_rows(mesh, ts, val, mask, gid), edges)
    want = tpipe.run_group_pipeline(spec, *_on(cuda_device, ts, val, mask),
                                    gid, 5, edges)
    assert_exact(got[0].cpu().numpy(), want[0].cpu().numpy())
    assert_exact(got[2].cpu().numpy(), want[2].cpu().numpy())
    if shards == 1:
        assert_exact(got[1].cpu().numpy(), want[1].cpu().numpy())
    else:
        assert_values(got[1].cpu().numpy(), want[1].cpu().numpy())


def test_sharded_rollup_on_card_matches_lane_partials(cuda_device):
    """The (2, 2) virtual mesh's rollup against one L1 over the batch:
    counts and extremes exact, sums at rtol 1e-9."""
    from opentsdb_tpu_torch.ops.lanes import lane_partials
    from opentsdb_tpu_torch.parallel import (make_mesh, shard_series,
                                             sharded_rollup)
    ts, val, mask = sorted_batch(np.random.default_rng(44), 9, 300)
    edges = PLANS["fixed"].window_edges(cuda_device)
    mesh = make_mesh(devices=[cuda_device] * 4, shape=(2, 2))
    parts = sharded_rollup(mesh, shard_series(mesh, ts, val, mask), edges)
    got = [torch.cat([p[q] for p in parts]).cpu().numpy() for q in range(4)]
    want = [x.cpu().numpy() for x in lane_partials(
        *_on(cuda_device, ts, val, mask), edges)]
    for q, (a, b) in enumerate(zip(got, want)):
        if q == 0:
            assert_values(a, b)
        else:
            assert_exact(a, b)


@pytest.mark.parametrize("agg", ["sum", "dev", "p95", "movingAverage3"])
def test_sharded_pipeline_over_distinct_cards(cuda_device, agg):
    """Every visible card a shard, combined through NCCL, against one
    card (skips with fewer than two cards)."""
    from opentsdb_tpu_torch.parallel import (make_mesh, shard_rows,
                                             sharded_query_pipeline)
    from opentsdb_tpu_torch.parallel.distributed import host_major_devices
    cards = host_major_devices()
    if len(cards) < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(devices=cards)
    assert mesh.backend == "nccl"
    ts, val, mask = sorted_batch(np.random.default_rng(45), 13, 200)
    gid = np.array([0, 0, 0, 1, 1, 3, 3, 3, 3, 4, 4, 4, 4])
    spec = tpipe.PipelineSpec(agg, tpipe.DownsampleStep("avg", "none"))
    edges = PLANS["fixed"].window_edges(cards[0])
    got = sharded_query_pipeline(mesh, spec, 5,
                                 shard_rows(mesh, ts, val, mask, gid), edges)
    want = tpipe.run_group_pipeline(spec, *_on(cards[0], ts, val, mask),
                                    gid, 5, edges)
    assert all(x.device == cards[0] for x in got)
    assert_exact(got[2].cpu().numpy(), want[2].cpu().numpy())
    assert_values(got[1].cpu().numpy(), want[1].cpu().numpy())


@pytest.mark.parametrize("long_runs", [False, True])
@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("mode", ["additive", "extreme", "square",
                                  "centred"])
def test_point_group_moments_kernel_matches_plain(cuda_device, mode,
                                                  int_values, long_runs):
    """P1 against its plain version on an interleaved gid (every third row
    of none): counts and extremes exact, sums, squares and centred
    squares at rtol 1e-9, in the warp form (long runs) and the thread
    form; each launch counted under its mode."""
    from opentsdb_tpu_torch.ops import lanes
    rng = np.random.default_rng(45)
    s, n, g = 37, 4096 if long_runs else 600, 5
    ts, val, mask = sorted_batch(rng, s, n, int_values=int_values)
    gid = (np.arange(s) * 3) % (g + 2) - 1     # interleaved, some of none
    # 4 windows of ~1,000 points a row, or 61 of ~10
    plan = tds.FixedWindows.for_range(T0, T0 + 3_600_000,
                                      900_000 if long_runs else 60_000)
    edges = plan.window_edges("cpu")
    w = plan.count
    mean = rng.normal(50.0, 5.0, (g, w)) if mode == "centred" else None
    members, offsets = lanes.group_members(t(gid), g)
    want = lanes.point_group_moments(
        t(ts), t(val), t(mask), edges, members, offsets, mode,
        None if mean is None else t(mean))
    d_members, d_offsets = lanes.group_members(t(gid).to(cuda_device), g)
    assert torch.equal(d_members.cpu(), members)
    kernels.reset_launches()
    got = lanes.point_group_moments(
        *_on(cuda_device, ts, val, mask), edges.to(cuda_device), d_members,
        d_offsets, mode, None if mean is None else t(mean).to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["point_group_moments"] == 1
    assert kernels.LAUNCHES["point_group_moments." + mode] == 1
    for lane in want:
        if lane in ("cnt", "lo", "hi"):
            assert_exact(got[lane].cpu().numpy(), want[lane].numpy())
        else:
            assert_values(got[lane].cpu().numpy(), want[lane].numpy())


@pytest.mark.parametrize("agg", ["sum", "count", "avg", "min", "mimmax",
                                 "dev", "squareSum"])
def test_sharded_group_downsample_on_card_matches_cpu(cuda_device, agg):
    """sharded_group_downsample on a (2, 2) mesh of the card and on a
    one-device NCCL mesh against the plain composition on the CPU: masks
    exact, values at rtol 1e-9."""
    from opentsdb_tpu_torch.parallel import (make_mesh, shard_series,
                                             sharded_group_downsample)
    ts, val, mask = sorted_batch(np.random.default_rng(46), 11, 700)
    gid = np.arange(11) % 3
    edges = PLANS["fixed"].window_edges("cpu")
    cpu = make_mesh(devices=["cpu"])
    want = sharded_group_downsample(cpu, agg, shard_series(cpu, ts, val,
                                                           mask), gid, 3,
                                    edges)
    for mesh in (make_mesh(devices=[cuda_device] * 4, shape=(2, 2)),
                 make_mesh(devices=[cuda_device])):
        got = sharded_group_downsample(
            mesh, agg, shard_series(mesh, ts, val, mask), gid, 3,
            edges.to(cuda_device))
        assert_exact(got[0].cpu().numpy(), want[0].numpy())
        assert_exact(got[2].cpu().numpy(), want[2].numpy())
        assert_values(got[1].cpu().numpy(), want[1].numpy())


@pytest.mark.parametrize("fn", ["avg", "squareSum", "median", "first"])
def test_k1_and_k4_hold_the_wide_range_exact_values(cuda_device, fn):
    """The wide dynamic-range regime (tests/test_torch_dynamic_range.py)
    on the card: K1 and K4 give the exact values after a -1e15 point."""
    later = [-35.48827592954828, 2.0, 1.25, 0.1]
    t0 = 1_356_998_400_000
    ts = torch.tensor([[t0 + 60_000 * k for k in range(5)]],
                      dtype=torch.int64, device=cuda_device)
    val = torch.tensor([[-1e15] + later], dtype=torch.float64,
                       device=cuda_device)
    mask = torch.ones_like(ts, dtype=torch.bool)
    edges = tds.FixedWindows.for_range(t0, t0 + 299_000,
                                       60_000).window_edges(cuda_device)
    kernels.reset_launches()
    _, out, out_mask = tds.downsample(ts, val, mask, fn, edges)
    name = "window_moments" if fn in ("avg", "squareSum") else "window_order"
    assert kernels.LAUNCHES[name] == 1
    assert bool(out_mask.all())
    first = 1e30 if fn == "squareSum" else -1e15
    exact = [v * v for v in later] if fn == "squareSum" else later
    np.testing.assert_array_equal(out[0].cpu().numpy(),
                                  np.array([first] + exact))


# -- the ordered product and the staged runs of K4, K5 and U3; U1's merge ----
# The plain versions run on the CPU copy here: they multiply in the run's
# order there, as the reference does (tests/test_torch_mult_order.py).

def _runs_batch(dev, lengths, seed, int_values=False):
    """One row a run length, a window of 10 min holding the whole run
    (1 ms apart), with holes and NaN values; -> device and CPU batches and
    edges."""
    rng = np.random.default_rng(seed)
    n = max(lengths)
    ts = np.full((len(lengths), n), np.iinfo(np.int64).max, np.int64)
    val = np.zeros((len(lengths), n), np.int64 if int_values else np.float64)
    mask = np.zeros((len(lengths), n), bool)
    for r, k in enumerate(lengths):
        ts[r, :k] = mr.T0 + 1_000 + np.arange(k)
        val[r, :k] = (rng.integers(-1000, 1000, k) if int_values
                      else 1.0 + rng.normal(0.0, 1e-3, k))
        mask[r, :k] = rng.random(k) >= 0.1
    if not int_values:
        val[rng.random(val.shape) < 0.02] = np.nan
    plan = tds.FixedWindows.for_range(mr.T0, mr.T0 + 3 * 600_000 - 1, 600_000)
    return (_on(dev, ts, val, mask), [t(x) for x in (ts, val, mask)],
            plan.window_edges(dev), plan.window_edges("cpu"))


@pytest.mark.parametrize("interleaved", [False, True])
def test_window_order_mult_classes_kernel_matches_plain(cuda_device,
                                                        interleaved):
    """Every class of the ordered product, each run in a window: classes
    exact, finite values at rtol 1e-9, against the plain version and the
    ordered walk."""
    batch = mr.k4_batch(mr.NAMES, interleaved)
    nw = len(mr.NAMES)
    plan = tds.FixedWindows.for_range(mr.T0, mr.T0 + nw * mr.WINDOW_MS - 1,
                                      mr.WINDOW_MS)
    got, got_mask = tds.window_order(*_on(cuda_device, *batch),
                                     plan.window_edges(cuda_device), "mult")
    want, want_mask = tds.window_order_plain(*[t(x) for x in batch],
                                             plan.window_edges("cpu"), "mult")
    assert_exact(got_mask.cpu().numpy(), want_mask.numpy())
    mr.assert_same_product(got.cpu().numpy(), want.numpy())
    mr.assert_same_product(got.cpu().numpy(),
                           [[mr.ordered_product(mr.RUNS[k])
                             for k in mr.NAMES]])


@pytest.mark.parametrize("int_values", [False, True])
def test_window_order_long_runs_kernel_matches_plain(cuda_device,
                                                     int_values):
    """Runs of 200 (a warp's shared stage), 300 and 2,000 (the block's
    stage), 6,000 and 65,536 points (the block's selection in device
    memory, narrowed into shared memory), and the headline's 231 in
    [100, 150), whose product overflows; mult reads every run in place."""
    lengths = [200, 300, 2_000, 6_000, 65_536, 231]
    dev_b, cpu_b, edges, cpu_edges = _runs_batch(cuda_device, lengths, 41,
                                                 int_values)
    if not int_values:
        head = np.array(mr.headline_like(5, 231))
        dev_b[1][5, :231] = torch.from_numpy(head).to(cuda_device)
        cpu_b[1][5, :231] = torch.from_numpy(head)
    for func in ("first", "last", "diff", "mult", "median", "p99", "p50",
                 "ep99r7", "ep50r3", "ep999r3"):
        got = tds.window_order(*dev_b, edges, func)
        want = tds.window_order_plain(*cpu_b, cpu_edges, func)
        assert_exact(got[1].cpu().numpy(), want[1].numpy())
        if func == "mult":
            mr.assert_same_product(got[0].cpu().numpy(), want[0].numpy())
        else:
            assert_values(got[0].cpu().numpy(), want[0].numpy())


def test_window_order_stacked_and_int32_equal_solo_and_int64(cuda_device):
    """Bit for bit, each family (scan, product, selection) on runs of every
    path: a stacked member's cells are its solo cells, the int32 form's
    cells the int64 form's."""
    lengths = [200, 2_000, 6_000, 40]
    dev_b, _, edges, _ = _runs_batch(cuda_device, lengths, 43)
    ts, val, mask = dev_b
    q = 2
    st_ts, st_val, st_mask = (torch.cat([x, x.flip(0)]) for x in dev_b)
    shifted = edges + 60_000
    st_edges = torch.stack([edges, shifted])
    ts32 = torch.where(ts == np.iinfo(np.int64).max, tds.I32_PAD_TS,
                       ts - mr.T0).to(torch.int32)
    edges32 = tds.compact_edges(edges, mr.T0)
    for func in ("first", "diff", "mult", "median", "ep99r7", "p50"):
        solo = tds.window_order(ts, val, mask, edges, func)
        flip = tds.window_order(ts.flip(0).contiguous(),
                                val.flip(0).contiguous(),
                                mask.flip(0).contiguous(), shifted, func)
        stacked = tds.window_order(st_ts, st_val, st_mask, st_edges, func)
        s = len(lengths)
        assert torch.equal(stacked[0][:s].view(torch.int64),
                           solo[0].view(torch.int64)), func
        assert torch.equal(stacked[0][s:q * s].view(torch.int64),
                           flip[0].view(torch.int64)), func
        narrow = tds.window_order(ts32, val, mask, edges32, func)
        assert torch.equal(narrow[0].view(torch.int64),
                           solo[0].view(torch.int64)), func
        assert torch.equal(narrow[1], solo[1])


def test_group_and_union_order_mult_classes_kernels_match_plain(cuda_device):
    """K5 down the columns of two groups, U3 at the slot of a group a run
    (float, then int64 wrap): the same classes as K4's."""
    a = mr.k5_columns(mr.NAMES, False)
    b = mr.k5_columns(mr.NAMES, True)
    contrib = np.concatenate([a[0], b[0]])
    part = np.concatenate([a[1], b[1]])
    gid = np.repeat(np.arange(2, dtype=np.int64), [len(a[0]), len(b[0])])
    offsets = tga.group_offsets(gid, 2)
    c, p = _on(cuda_device, contrib, part)
    got = tga.group_order("mult", c, p, p, offsets.to(cuda_device))
    want = tga.group_order_plain("mult", t(contrib), t(part), t(part),
                                 offsets)
    mr.assert_same_product(got[0].cpu().numpy(), want[0].numpy())
    for interleaved in (False, True):
        batch = mr.u3_groups([mr.RUNS[k] for k in mr.NAMES], interleaved)
        g, m, _ = batch[0].shape
        flat = [x.reshape(g * m, 1) for x in batch]
        offsets = np.arange(g + 1, dtype=np.int64) * m
        _, out, _ = tua.union_aggregate(*_on(cuda_device, *flat, offsets),
                                        "mult", "lerp")
        _, want, _ = tua.union_aggregate(*[t(x) for x in flat], t(offsets),
                                         "mult", "lerp")
        mr.assert_same_product(out.cpu().numpy(), want.numpy())
    runs = [[2**40 + 1, 2**30 + 3, 123_457, -7, 2**62 - 1], [-(2**63), 3],
            [0, 2**62, 5], [9] * 40]
    batch = mr.u3_groups(runs, False, np.int64)
    g, m, _ = batch[0].shape
    flat = [x.reshape(g * m, 1) for x in batch]
    offsets = np.arange(g + 1, dtype=np.int64) * m
    _, out, _ = tua.union_aggregate(*_on(cuda_device, *flat, offsets), "mult",
                                    "lerp")
    _, want, _ = tua.union_aggregate(*[t(x) for x in flat], t(offsets),
                                     "mult", "lerp")
    assert_exact(out.cpu().numpy(), want.numpy())


def test_union_merge_awkward_shapes_kernel_matches_plain(cuda_device):
    """Groups of 1, 2, 3, 5 and 1024 rows, empty and all-masked rows,
    repeats within and across rows, equal rows, rows outside every group;
    then 40 equal rows of 900 points in one group (several tiles, six
    rounds) and a random batch: u and uoff exactly the plain version's."""
    ts, mask, gid, ng = mr.u1_batch()
    rng = np.random.default_rng(12)
    row = np.sort(rng.choice(10**6, 900, replace=False)) + mr.T0
    r_ts, _, r_mask = sorted_batch(rng, 40, 700)
    r_mask = np.arange(700)[None, :] < r_mask.sum(axis=1, keepdims=True)
    r_ts = np.where(r_mask, np.sort(r_ts, axis=1), np.iinfo(np.int64).max)
    cases = [(ts, mask, tga.group_offsets(gid, ng)),
             (np.tile(row, (40, 1)), np.ones((40, 900), bool),
              torch.tensor([0, 40])),
             (r_ts, r_mask, tga.group_offsets(np.sort(rng.integers(0, 6, 40)),
                                              6))]
    for c_ts, c_mask, offsets in cases:
        u, uoff = tua.union_merge(*_on(cuda_device, c_ts, c_mask),
                                  offsets.to(cuda_device))
        pu, puoff = tua.union_merge_plain(t(c_ts), t(c_mask), offsets)
        assert_exact(uoff.cpu().numpy(), puoff.numpy())
        assert_exact(u.cpu().numpy(), pu.numpy())


# -- the grouped fold K3 and T1 share (csrc/group_fold.cuh) -----------------


def _fold_grid(rng, s, w):
    """contrib with NaNs, participate and present at random, [s, w]."""
    contrib = rng.normal(30.0, 12.0, (s, w))
    contrib[rng.random((s, w)) < 0.1] = np.nan
    return contrib, rng.random((s, w)) < 0.85, rng.random((s, w)) < 0.8


def _misaligned(dev, x, skip):
    """x on `dev` as a contiguous view `skip` elements into a buffer, so
    its data pointer is off the 16-byte (f64) or 4-byte (flag) grain."""
    src = torch.from_numpy(np.ascontiguousarray(x))
    buf = torch.empty(src.numel() + skip + 8, dtype=src.dtype, device=dev)
    view = buf[skip:skip + src.numel()].view(src.shape)
    view.copy_(src)
    return view


def _k3_both(dev, contrib, part, present, offsets, skips=(0, 0, 0)):
    """Every moment function by K3 on the card (inputs at the given
    misalignments) and by its plain version on the CPU."""
    args = [_misaligned(dev, x, k) for x, k in zip((contrib, part, present),
                                                  skips)]
    for agg in FUNCS:
        got = tga.group_moments(agg, *args, offsets.to(dev))
        want = tga.group_moments_plain(agg, t(contrib), t(part), t(present),
                                       offsets)
        yield agg, got, want


@pytest.mark.parametrize("skips", [(0, 0, 0), (1, 3, 2)])
@pytest.mark.parametrize("w", [283, 1, 37])
def test_group_moments_deep_group_kernel_matches_plain(cuda_device, w,
                                                       skips):
    """1024 rows as one group (a narrow window tile, the rows staged in
    many chunks), W not a multiple of any tile, aligned and misaligned
    inputs: every moment function equals the plain version (masks
    exactly, values at rtol 1e-9)."""
    contrib, part, present = _fold_grid(np.random.default_rng(51), 1024, w)
    offsets = torch.tensor([0, 1024])
    for agg, got, want in _k3_both(cuda_device, contrib, part, present,
                                   offsets, skips):
        assert_exact(got[1].cpu().numpy(), want[1].numpy())
        assert_values(got[0].cpu().numpy(), want[0].numpy())


def test_group_moments_empty_and_silent_groups(cuda_device):
    """Empty groups (offsets[g] == offsets[g + 1]), a group whose cells
    are all NaN and one whose cells all take no part: count gives 0, the
    other functions NaN, and the mask holds presence alone."""
    rng = np.random.default_rng(52)
    contrib, part, present = _fold_grid(rng, 40, 150)
    gid = np.repeat(np.array([1, 2, 4, 6]), 10)
    contrib[10:20] = np.nan
    part[20:30] = False
    offsets = tga.group_offsets(gid, 9)
    for agg, got, want in _k3_both(cuda_device, contrib, part, present,
                                   offsets):
        out, mask = got[0].cpu().numpy(), got[1].cpu().numpy()
        assert_exact(mask, want[1].numpy())
        assert_values(out, want[0].numpy())
        silent = out[[0, 2, 3, 4, 5, 7, 8]]
        if agg == "count":
            assert (silent == 0).all()
        else:
            assert np.isnan(silent).all()
        assert not mask[[0, 3, 5, 7, 8]].any() and mask[[2, 4]].any()


@pytest.mark.parametrize("rows", [7, 64, 300])
@pytest.mark.parametrize("agg", ["sum", "count", "avg", "min", "max"])
def test_tile_fold_equals_group_moments_on_float_data(cuda_device, agg,
                                                      rows):
    """On float data (NaNs, holes) the fold of all tiles, finished, is K3
    over the whole grid bit for bit, whatever the tile height: tiles of 7
    and 64 rows split groups across tiles."""
    from opentsdb_tpu_torch.ops import tiling
    v, m, gid = _lane_tiles(np.random.default_rng(53), s=600, w=283)
    spec = tpipe.PipelineSpec(agg)
    acc = _fold_pair(cuda_device, spec, v, m, gid, 9, rows)
    out, mask = tiling.finish_lane_fold(acc, agg)
    wts = torch.arange(v.shape[1], dtype=torch.int64,
                       device=cuda_device) * 60_000 + T0
    contrib, part, actual = tiling.tile_contrib(
        spec, wts, *_on(cuda_device, v, m))
    want, want_mask = tga.group_moments(
        agg, contrib, part, actual, tga.group_offsets(gid, 9).to(cuda_device))
    assert_exact(out.cpu().numpy(), want.cpu().numpy())
    assert_exact(mask.cpu().numpy(), want_mask.cpu().numpy())


@pytest.mark.parametrize("rows", [5, 48, 200])
@pytest.mark.parametrize("mode", ["additive", "extreme", "square",
                                  "centred"])
def test_tile_partials_modes_over_split_groups(cuda_device, mode, rows):
    """T1's four modes over tiles of `rows` rows that split groups across
    tiles (misaligned inputs, W = 283): the accumulators equal the plain
    version's (counts, presence and extremes exactly, sums at rtol
    1e-9), and each launch counts under its mode."""
    from opentsdb_tpu_torch.ops import tiling
    rng = np.random.default_rng(54)
    s, w, g = 400, 283, 6
    contrib, part, present = _fold_grid(rng, s, w)
    gid = np.sort(rng.integers(0, g, s))
    mean = rng.normal(30.0, 5.0, (g, w))
    extra = {"mean": mean} if mode == "centred" else {}
    got = tiling.new_lane_fold(g, w, mode, cuda_device)
    want = tiling.new_lane_fold(g, w, mode, "cpu")
    kernels.reset_launches()
    for lo in range(0, s, rows):
        sl = slice(lo, lo + rows)
        off = tga.group_offsets(gid[sl], g)
        tiling.tile_partials(
            *[_misaligned(cuda_device, x[sl], k)
              for x, k in ((contrib, 1), (part, 2), (present, 3))],
            off.to(cuda_device), got,
            **{k: t(x).to(cuda_device) for k, x in extra.items()})
        tiling.tile_partials_plain(t(contrib[sl]), t(part[sl]),
                                   t(present[sl]), off, want,
                                   **{k: t(x) for k, x in extra.items()})
    n = -(-s // rows)
    assert kernels.LAUNCHES["tile_partials"] == n
    if mode in ("square", "centred"):
        assert kernels.LAUNCHES["tile_partials." + mode] == n
    for lane in want:
        if lane in ("cnt", "present", "lo", "hi"):
            assert_exact(got[lane].cpu().numpy(), want[lane].numpy())
        else:
            assert_values(got[lane].cpu().numpy(), want[lane].numpy())


# -- U3 and MA: the team widths, the deep path and the rings ---------------

U3_SIZES = (1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 64, 1024)


def _u3_edge_batch(seed, int_values, n=24):
    """Groups of U3_SIZES members in one batch, each with members that
    hold no point, members whose spans miss the others', timestamps
    repeated within a row, NaN values and ties; int rows near 2^53.  The
    1024-member group's rows hold at most 3 points (its union stays a few
    thousand slots for the plain version)."""
    rng = np.random.default_rng(seed)
    s = sum(U3_SIZES)
    ts = np.full((s, n), np.iinfo(np.int64).max, np.int64)
    val = np.zeros((s, n), np.int64 if int_values else np.float64)
    mask = np.zeros((s, n), bool)
    gid = np.repeat(np.arange(len(U3_SIZES), dtype=np.int64), U3_SIZES)
    for i in range(s):
        deep = U3_SIZES[gid[i]] > 64
        k = 0 if i % 7 == 3 else int(rng.integers(1, (3 if deep else n) + 1))
        base = T0 + (10_000_000 * (i % 11 + 1) if i % 5 == 2 else 0)
        ts[i, :k] = np.sort(rng.choice(2_000 if i % 3 else 300, size=k,
                                       replace=True)) * 37 + base
        mask[i, :k] = True
        if int_values:
            val[i, :k] = rng.integers(-40, 40, k) + 2**53
        else:
            v = np.round(rng.normal(50.0, 20.0, k) / 8.0) * 8.0
            v[rng.random(k) < 0.08] = np.nan
            val[i, :k] = v
    return ts, val, mask, tga.group_offsets(gid, len(U3_SIZES))


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_union_order_edge_groups_kernel_matches_plain(cuda_device, policy,
                                                      int_values):
    """Every order and rank aggregator over groups of 1 to 1024 members in
    one call (teams of 8, 16 and 32 lanes, the deep path past 32)."""
    ts, val, mask, offsets = _u3_edge_batch(41, int_values)
    d_ts, d_val, d_mask, d_off = _on(cuda_device, ts, val, mask, offsets)
    u, uoff = tua.union_merge(d_ts, d_mask, d_off)
    for func in ORDER_AGGS:
        got = tua.union_order(d_ts, d_val, d_mask, d_off, u, uoff, func,
                              policy)
        want = tua.union_order_plain(t(ts), t(val), t(mask), offsets,
                                     u.cpu(), uoff.cpu(), func, policy)
        if int_values:
            assert_exact(got.cpu().numpy(), want.numpy())
        else:
            assert_values(got.cpu().numpy(), want.numpy())


def _ma_edge_cases(int_values):
    """(sums, live, offsets): short runs (a warp each: runs of 3, 0, 40
    dead, 1,700 and 9 slots) and long ones (a block each: 20,000, 0 and
    30,000 slots), one slot in five dead; then the cancellation case
    (-1e15, then small values); int64 sums that wrap."""
    rng = np.random.default_rng(43)
    cases = []
    for offsets in ([0, 3, 3, 43, 1743, 1752], [0, 20_000, 20_000, 50_000]):
        offsets = np.array(offsets, np.int64)
        sums = rng.normal(100.0, 40.0, offsets[-1])
        if int_values:
            sums = (sums * 1e6).astype(np.int64) + 2**62 + 2**61
        live = rng.random(offsets[-1]) >= 0.2
        if offsets[-1] < 2000:
            live[3:43] = False
        cases.append((sums, live, offsets))
    if not int_values:
        sums = np.concatenate([[-1e15], rng.normal(3.0, 1.0, 9_999)])
        cases.append((sums, np.ones(sums.size, bool),
                      np.array([0, 5_000, 10_000], np.int64)))
    return cases


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("n_window", [1, 5, 1000])
def test_moving_average_edge_runs_kernel_matches_plain(cuda_device, n_window,
                                                       int_values):
    """Bit for bit the plain version on the CPU (whose cumsum runs in
    slot order): every live flag set or given, a window past the shared
    ring (1000 > MA_RING_WINDOW), runs shorter than the window."""
    for sums, live, offsets in _ma_edge_cases(int_values):
        for lv in (live, None):
            d = _on(cuda_device, sums, offsets,
                    *([] if lv is None else [lv]))
            got = tagg.moving_average(d[0], None if lv is None else d[2],
                                      d[1], n_window).cpu().numpy()
            want = tagg.moving_average_plain(
                t(sums), None if lv is None else t(lv), t(offsets),
                n_window).numpy()
            assert_exact(got.view(np.int64), want.view(np.int64))


# -- U2 and S2: staged spans, the warp path and the block path -------------

U2_SIZES = (1, 2, 3, 5, 33, 1013, 3, 1, 2)
U2_LONG, U2_REPEAT = 6, 7      # groups: long rows; a row repeating stamps


def _u2_edge_batch(seed, int_values, n=3_000):
    """Groups of U2_SIZES rows in one call: rows with no point among them
    and rows whose spans miss the others'; the 1013-row group's rows hold
    at most 4 points; group U2_LONG's three rows hold 3,000 points each
    (a union of several 2,048-slot tiles) and group U2_REPEAT's row 1,000
    timestamps three times each (a span past a stage); the small groups
    share a tile; every row repeats some timestamps.  int rows near 2^62,
    so that sums and products wrap."""
    rng = np.random.default_rng(seed)
    s = sum(U2_SIZES)
    ts = np.full((s, n), np.iinfo(np.int64).max, np.int64)
    val = np.zeros((s, n), np.int64 if int_values else np.float64)
    mask = np.zeros((s, n), bool)
    gid = np.repeat(np.arange(len(U2_SIZES), dtype=np.int64), U2_SIZES)
    for i in range(s):
        g = gid[i]
        if g == U2_LONG:
            k = n
            t = np.sort(rng.choice(40 * n, size=k, replace=False)) * 7
        elif g == U2_REPEAT:
            k = n
            t = np.repeat(np.arange(n // 3) * 11, 3)
        else:
            k = 0 if i % 7 == 3 else int(rng.integers(
                1, (4 if U2_SIZES[g] > 64 else 40) + 1))
            t = np.sort(rng.choice(300, size=k, replace=True)) * 37
            if i % 5 == 2:
                t = t + 50_000
        ts[i, :k] = t + T0
        mask[i, :k] = True
        if int_values:
            val[i, :k] = rng.integers(-2**40, 2**40, k) + 2**62
        else:
            v = rng.normal(50.0, 20.0, k)
            v[rng.random(k) < 0.05] = np.nan
            val[i, :k] = v
    return ts, val, mask, tga.group_offsets(gid, len(U2_SIZES))


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_union_reduce_edge_groups_kernel_matches_plain(cuda_device, policy,
                                                       int_values):
    """Every moment aggregator over groups of 1 to 1013 members in one
    call: stages of many members, a group over several tiles, a tile of
    several small groups, a member walked in device memory; int mode
    exactly but for dev."""
    ts, val, mask, offsets = _u2_edge_batch(47, int_values)
    d_ts, d_val, d_mask, d_off = _on(cuda_device, ts, val, mask, offsets)
    u, uoff = tua.union_merge(d_ts, d_mask, d_off)
    long_slots = int(uoff[U2_LONG + 1] - uoff[U2_LONG])
    assert long_slots > 4 * 2048
    for func in FUNCS:
        got = tua.union_reduce(d_ts, d_val, d_mask, d_off, u, uoff, func,
                               policy)
        want = tua.union_reduce_plain(t(ts), t(val), t(mask), offsets,
                                      u.cpu(), uoff.cpu(), func, policy)
        if int_values and func != "dev":
            assert_exact(got.cpu().numpy(), want.numpy())
        else:
            assert_values(got.cpu().numpy(), want.numpy())


S2_RUNS = (0, 1, 2, 31, 32, 33, 255, 256, 257, 4096, 4097)


def _s2_edge_chunks(seed):
    """Two [4, n] chunks over windows whose runs hold S2_RUNS points
    each (one window a run, at 1 s a point), with NaN, +inf and -inf
    values and masked slots: row 2 holds no point in the first chunk
    (its cells merge into a count of 0) and row 3 none in the second
    (state cells merged with an empty chunk)."""
    rng = np.random.default_rng(seed)
    n = sum(S2_RUNS)
    edges = T0 + 1000 * np.concatenate([[0], np.cumsum(S2_RUNS)])
    windows = tds.EdgeWindows(tuple(int(e) for e in edges))
    chunks = []
    for k in range(2):
        ts = np.tile(T0 + 1000 * np.arange(n, dtype=np.int64), (4, 1))
        val = np.round(rng.normal(10.0, 5.0, (4, n)), 1)
        cls = rng.random((4, n))
        val[cls < 0.03] = np.nan
        val[(cls >= 0.03) & (cls < 0.05)] = np.inf
        val[(cls >= 0.05) & (cls < 0.07)] = -np.inf
        mask = rng.random((4, n)) >= 0.1
        mask[2 if k == 0 else 3] = False
        chunks.append((ts, val, mask))
    return windows, chunks


def test_sketch_fold_edge_runs_kernel_matches_plain(cuda_device):
    """S2 over runs at the warp path's network sizes and past them (the
    block path's sort from 257 points, its selection past 4,096), NaN and
    infinite values, state cells of count 0: the card's state against
    the CPU's at the sketch's tolerance."""
    windows, chunks = _s2_edge_chunks(53)
    accs = [tst.StreamAccumulator.create(4, windows, d, sketch=True)
            for d in (cuda_device, "cpu")]
    for ts, val, mask in chunks:
        for acc in accs:
            acc.update(*_on(acc.device, ts, val, mask))
        np.testing.assert_allclose(accs[0].state["q"].cpu().numpy(),
                                   accs[1].state["q"].numpy(), rtol=1e-6,
                                   atol=1e-5)
    for fn in ("p95", "median"):
        _, got, gm = accs[0].finish(fn)
        _, want, wm = accs[1].finish(fn)
        assert_exact(gm.cpu().numpy(), wm.numpy())
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-5)


# -- S1 and P1 at the edges of their forms ----------------------------------

S1_RUNS = {"device memory": (0, 1, 31, 32, 33, 4096),
           "staged": (0, 1, 31, 32, 33, 3000)}
S1_EXACT = ("n", "oob", "lo", "hi", "first", "last")


def _fold_card_and_cpu(dev, s, w, lanes, chunks, audit):
    """Each (ts, val, mask, edges, w0) chunk folded by S1 into a state on
    the card and by the plain version into one on the CPU; both states."""
    states = []
    for d in (dev, "cpu"):
        state = tst.zero_state(s, w, d, lanes=lanes, with_oob=True)
        for ts, val, mask, edges, w0 in chunks:
            tst.stream_fold(state, *_on(d, ts, val, mask), edges.to(d), w0,
                            audit)
        states.append(state)
    return states


def _assert_states(card, cpu):
    for k in cpu:
        if k in S1_EXACT:
            assert_exact(card[k].cpu().numpy(), cpu[k].numpy())
        else:
            assert_values(card[k].cpu().numpy(), cpu[k].numpy())


def _s1_run_chunk(seed, runs):
    """A [4, n] chunk over windows whose runs hold `runs` points each (one
    window a run, 1 s a point), NaN values and masked slots, row 2 all
    masked; its EdgeWindows' edges."""
    rng = np.random.default_rng(seed)
    n = sum(runs)
    edges = T0 + 1000 * np.concatenate([[0], np.cumsum(runs)])
    ts = np.tile(T0 + 1000 * np.arange(n, dtype=np.int64), (4, 1))
    val = np.round(rng.normal(10.0, 5.0, (4, n)), 1)
    val[rng.random((4, n)) < 0.03] = np.nan
    mask = rng.random((4, n)) >= 0.1
    mask[2] = False
    return (ts, val, mask), torch.from_numpy(edges.astype(np.int64))


@pytest.mark.parametrize("lanes", ["sum", "all"])
@pytest.mark.parametrize("form", list(S1_RUNS))
def test_stream_fold_edge_runs_kernel_matches_plain(cuda_device, form, lanes):
    """S1 over windows of 0, 1, 31, 32, 33 and 4,096 points (a tile past
    the stage, reduced from device memory) or 3,000 (staged), NaN values
    and masked slots, two chunks merged: every lane, counts and extremes
    exact."""
    runs = S1_RUNS[form]
    (ts, val, mask), edges = _s1_run_chunk(61, runs)
    ln = tst.lanes_for(["sum"]) if lanes == "sum" else None
    audit = (int(edges[0]), int(edges[-1]))
    card, cpu = _fold_card_and_cpu(
        cuda_device, 4, len(runs), ln,
        [(ts, val, mask, edges, 0), (ts, val[::-1].copy(), mask, edges, 0)],
        audit)
    _assert_states(card, cpu)
    assert int(card["oob"]) == int(cpu["oob"]) == 0


def _headline_rows(seed, s, n):
    """[s, 2n] rows at a ~15.5 s cadence from T0 with NaN values and
    masked slots."""
    rng = np.random.default_rng(seed)
    ts = (T0 + np.arange(2 * n, dtype=np.int64) * 15_500)[None, :] \
        + rng.integers(0, 4_000, (s, 2 * n))
    ts.sort(axis=1)
    val = rng.normal(50.0, 10.0, (s, 2 * n))
    val[rng.random((s, 2 * n)) < 0.01] = np.nan
    mask = rng.random((s, 2 * n)) >= 0.02
    return ts, val, mask


@pytest.mark.parametrize("interval_ms", [3_600_000, 10_000])
def test_stream_fold_rows_outside_the_slice_kernel_matches_plain(
        cuda_device, interval_ms):
    """S1 in its warp form (1h windows, a 64-window slice) and its thread
    form (10 s windows, an 8,192-window slice) over two chunks, a row of
    the second whose points all lie before the slice and one whose points
    all lie after it, every lane; then the audit of a wrong slice."""
    s, n = 8, 4096
    ts, val, mask = _headline_rows(62, s, n)
    wc = 64 if interval_ms == 3_600_000 else 8_192
    windows = tds.FixedWindows.for_range(T0, T0 + 300 * 3_600_000,
                                         interval_ms)
    e = windows.window_edges("cpu")
    audit = (T0, T0 + windows.count * interval_ms)
    chunks = []
    for k in range(2):
        c = [np.ascontiguousarray(x[:, k * n:(k + 1) * n])
             for x in (ts, val, mask)]
        w0 = int((c[0].min() - T0) // interval_ms)
        if k == 1:
            c[0][0] = T0 + np.arange(n) * 10              # before the slice
            c[0][1] = audit[1] - 1 - (n - np.arange(n))   # after it
        chunks.append((*c, e[w0:w0 + wc + 1], w0))
    card, cpu = _fold_card_and_cpu(cuda_device, s, windows.count, None,
                                   chunks, audit)
    _assert_states(card, cpu)
    assert int(cpu["oob"]) > 0
    ts1, val1, mask1, _, w0 = chunks[1]
    w0 += 10
    card, cpu = _fold_card_and_cpu(
        cuda_device, s, windows.count, tst.lanes_for(["sum"]),
        [(ts1, val1, mask1, e[w0:w0 + wc + 1], w0)], audit)
    _assert_states(card, cpu)


@pytest.mark.parametrize("interval_ms", [60_000, 600_000])
def test_stream_fold_long_rows_kernel_matches_plain(cuda_device,
                                                    interval_ms):
    """Rows of 20,000 points at ~1.5 s: 1m windows give a row of eight
    64-window tiles, each staged; 10 min windows one tile whose run
    (every point of the row) is past the stage and reduced from device
    memory.  Every lane, a slice that starts inside the row."""
    rng = np.random.default_rng(63)
    s, n = 5, 20_000
    ts = (T0 + np.arange(n, dtype=np.int64) * 1_500)[None, :] \
        + rng.integers(0, 1_000, (s, n))
    val = rng.normal(5.0, 2.0, (s, n))
    mask = rng.random((s, n)) >= 0.05
    windows = tds.FixedWindows.for_range(T0, T0 + 40_000_000, interval_ms)
    e = windows.window_edges("cpu")
    wc = 512 if interval_ms == 60_000 else 52
    audit = (T0, T0 + windows.count * interval_ms)
    for w0 in (0, 3):
        card, cpu = _fold_card_and_cpu(cuda_device, s, windows.count, None,
                                       [(ts, val, mask, e[w0:w0 + wc + 1],
                                         w0)], audit)
        _assert_states(card, cpu)


P1_MODES = ["additive", "extreme", "square", "centred"]


@pytest.mark.parametrize("interval_ms", [80_000, 20_000])
@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("mode", P1_MODES)
def test_point_group_moments_edge_groups_kernel_matches_plain(
        cuda_device, mode, int_values, interval_ms):
    """P1 over 1024 rows: groups of 0 and 1 member beside one of the other
    1023 rows, then all 1024 rows as one group; W = 46 (warp form, not a
    multiple of its 32-window tile) or 181 (thread form); integer values
    near 2^53."""
    from opentsdb_tpu_torch.ops import lanes
    rng = np.random.default_rng(64)
    s, n = 1024, 2048
    ts, val, mask = sorted_batch(rng, s, n, int_values=int_values)
    if int_values:
        val = val + 2**53 - 1000
    plan = tds.FixedWindows.for_range(T0, T0 + 3_600_000, interval_ms)
    edges = plan.window_edges("cpu")
    w = plan.count
    d_args = _on(cuda_device, ts, val, mask)
    for gid, g in ((np.where(np.arange(s) == 5, 1, 2), 3),
                   (np.zeros(s, np.int64), 1)):
        mean = rng.normal(50.0, 5.0, (g, w)) if mode == "centred" else None
        members, offsets = lanes.group_members(t(gid), g)
        want = lanes.point_group_moments(
            t(ts), t(val), t(mask), edges, members, offsets, mode,
            None if mean is None else t(mean))
        got = lanes.point_group_moments(
            *d_args, edges.to(cuda_device), members.to(cuda_device),
            offsets.to(cuda_device), mode,
            None if mean is None else t(mean).to(cuda_device))
        for lane in want:
            if lane in ("cnt", "lo", "hi"):
                assert_exact(got[lane].cpu().numpy(), want[lane].numpy())
            else:
                assert_values(got[lane].cpu().numpy(), want[lane].numpy())


def test_stream_fold_and_point_group_moments_repeat_bit_for_bit(cuda_device):
    """Two launches of S1 (each form) and of P1 (each mode, each form) on
    the same inputs give the same bits."""
    from opentsdb_tpu_torch.ops import lanes
    ts, val, mask = _headline_rows(65, 8, 4096)
    d_ts, d_val, d_mask = _on(cuda_device, ts, val, mask)
    for interval_ms, wc in ((3_600_000, 64), (10_000, 8_192)):
        windows = tds.FixedWindows.for_range(T0, T0 + 300 * 3_600_000,
                                             interval_ms)
        e = windows.window_edges(cuda_device)[:wc + 1]
        folds = []
        for _ in range(2):
            state = tst.zero_state(8, windows.count, cuda_device)
            tst.stream_fold(state, d_ts, d_val, d_mask, e, 0)
            folds.append(state)
        for k in folds[0]:
            assert torch.equal(folds[0][k], folds[1][k]), k
    gid = torch.arange(8, device=cuda_device) % 3
    members, offsets = lanes.group_members(gid, 3)
    for interval_ms in (3_600_000, 60_000):
        plan = tds.FixedWindows.for_range(T0, T0 + 2 * 4096 * 15_500,
                                          interval_ms)
        edges = plan.window_edges(cuda_device)
        mean = torch.full((3, plan.count), 50.0, dtype=torch.float64,
                          device=cuda_device)
        for mode in P1_MODES:
            mu = mean if mode == "centred" else None
            a, b = (lanes.point_group_moments(d_ts, d_val, d_mask, edges,
                                              members, offsets, mode, mu)
                    for _ in range(2))
            for lane in a:
                assert torch.equal(a[lane], b[lane]), (mode, lane)


# -- K5 and R at their routes' and tiles' edges -----------------------------

@pytest.mark.parametrize("layout", list(K5_EDGE_LAYOUTS))
def test_group_order_route_edges_kernel_matches_plain(cuda_device, layout):
    """K5 on every route: groups of 0-33 rows in tiles of 128 windows (a
    thread a cell; the 33-row group staged, every window in one pass),
    groups of 100 and 2,200 rows there (staged, all windows a pass and
    one), staged groups of 33-4,224 rows in tiles of one window (the
    block's select) and 4,225 rows read from device memory; every order
    and rank aggregator."""
    contrib, participate, present, offsets = k5_edge_groups(layout)
    dv = _on(cuda_device, contrib, participate, present, offsets)
    for agg in ORDER_AGGS:
        got = tga.group_order(agg, *dv)
        want = tga.group_order_plain(agg, t(contrib), t(participate),
                                     t(present), t(offsets))
        assert_exact(got[1].cpu().numpy(), want[1].numpy())
        assert_values(got[0].cpu().numpy(), want[0].numpy())


@pytest.mark.parametrize("interleaved", [False, True])
def test_group_order_mult_classes_shallow_kernel_matches_plain(
        cuda_device, interleaved):
    """mult's classes on K5's shallow route (the ordered walk on a
    thread): each class run down one window of a group of at most 12
    rows, masked and NaN cells between its values when interleaved."""
    contrib, part = mr.k5_columns(list(mr.CLASS_RUNS), interleaved)
    assert contrib.shape[0] <= 32
    offsets = np.array([0, contrib.shape[0]], np.int64)
    got = tga.group_order("mult", *_on(cuda_device, contrib, part, part,
                                       offsets))
    want = tga.group_order_plain("mult", t(contrib), t(part), t(part),
                                 t(offsets))
    mr.assert_same_product(got[0].cpu().numpy(), want[0].numpy())
    assert_exact(got[1].cpu().numpy(), want[1].numpy())


@pytest.mark.parametrize("int_values", [False, True])
@pytest.mark.parametrize("n", R_EDGE_LENGTHS)
def test_point_rate_tile_edges_kernel_matches_plain(cuda_device, n,
                                                    int_values):
    """R at its tile edges (one tile of 32-256 threads up to 2,048 points,
    tiles of 1,024 past it): resets at tile edges, a previous valid point
    tiles back, rows with no valid point and with one, values near 2^63;
    every rate option set."""
    ts, val, mask = r_edge_rows(n, int_values)
    dv = _on(cuda_device, ts, val, mask)
    for rate_args in RATES[1:]:
        opts = RateOptions(*rate_args)
        got = trate.point_rate(*dv, opts)
        want = trate.point_rate_plain(t(ts), t(val), t(mask), opts)
        assert_exact(got[0].cpu().numpy(), want[0].numpy())
        assert_exact(got[2].cpu().numpy(), want[2].numpy())
        assert_values(got[1].cpu().numpy(), want[1].numpy())
