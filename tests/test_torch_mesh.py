"""The device mesh (opentsdb_tpu_torch/parallel) against the reference's
sharded forms, on the CPU.

* ``mesh_shape_for`` and ``make_mesh``; the placement rule of the
  collectives (one device for every shard, or a CUDA device each through
  NCCL; a mix refused, NCCL never replaced by the shared combine) and the
  shared-device reduce, gather and broadcast;
* T1's square and centred modes (ops/tiling.py) against a numpy formula,
  and their finish against K3's squareSum and dev (their kernels against
  the plain versions: tests/test_torch_gpu.py);
* ``sharded_query_pipeline`` over 8 ``cpu`` shards against the
  reference's over conftest's 8 virtual devices and against the port's
  single-device ``run_group_pipeline``, for every query of
  tests/test_mesh_query.py's MOMENT_QUERIES and ORDERED_QUERIES plus
  squareSum, a group movingAverage and an int32 ``ts_base`` batch: values
  at rtol 1e-9 (the partials reassociate), masks exact; on integer data
  the moments sum, count, min, max and avg bit for bit;
* ``sharded_rollup`` on a (4, 2) mesh against the reference's;
* ``ShardedStreamAccumulator`` with and without the sliced fold and the
  sketch against the reference's.

The reference pads windows to a power of two and rows to a multiple of
the mesh; only the real rows and windows are compared.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu import parallel as rpar
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.ops import downsample as rds
from opentsdb_tpu.ops import pipeline as rpipe
from opentsdb_tpu.ops.rate import RateOptions as RefRate
from opentsdb_tpu.parallel import sharded as rsh
from opentsdb_tpu_torch import parallel as par
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import downsample as ds
from opentsdb_tpu_torch.ops import group_agg as ga
from opentsdb_tpu_torch.ops import streaming as st
from opentsdb_tpu_torch.ops import tiling
from opentsdb_tpu_torch.ops.lanes import lane_partials
from opentsdb_tpu_torch.ops.pipeline import (DownsampleStep, PipelineSpec,
                                             run_grid_tail,
                                             run_group_pipeline)
from opentsdb_tpu_torch.parallel import collectives as coll
from opentsdb_tpu_torch.parallel import sharded

from test_mesh_query import MOMENT_QUERIES, ORDERED_QUERIES
from torch_parity import PAD_TS, assert_exact, assert_values, sorted_batch, t

T0 = 1_356_998_400_000
SPAN = 600_000
CPU8 = ["cpu"] * 8
EXTRA_QUERIES = ["squareSum:1m-avg:sys.cpu.user{dc=*}",
                 "movingAverage3:1m-sum:sys.cpu.user{dc=*}",
                 "dev:1m-sum-zero:sys.cpu.user{dc=*}"]


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return rpar.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh(devices=CPU8)


# -- the mesh and its collectives -------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_mesh_shape_for_matches_reference(n):
    assert par.mesh_shape_for(n) == rpar.mesh_shape_for(n)


def test_make_mesh_lays_out_series_major():
    m = par.make_mesh(devices=CPU8)
    assert m.shape == (4, 2) and m.size == 8
    assert m.backend == "shared" and m.owner == torch.device("cpu")
    assert m.device_at(3, 1) == m.devices[7]
    assert par.make_mesh(devices=CPU8, shape=(8, 1)).shape == (8, 1)
    assert par.make_mesh(4, devices=CPU8).shape == (2, 2)
    with pytest.raises(ValueError, match="does not cover"):
        par.make_mesh(devices=CPU8, shape=(3, 2))
    with pytest.raises(ValueError):
        par.make_mesh(devices=[])


@pytest.mark.parametrize("devices", [
    ["cpu", "cuda:0"], ["cuda:0", "cuda:0", "cuda:1"],
    ["cpu", "cpu", "cuda:0", "cuda:1"]])
def test_mixed_placement_is_refused(devices, monkeypatch):
    """A mesh mixing a shared device with distinct ones has no backend:
    refused, even where NCCL is there to be had."""
    monkeypatch.setattr(coll, "nccl_module", lambda: _FakeNccl())
    with pytest.raises(ValueError, match="one device or each on a CUDA"):
        par.make_mesh(devices=devices)


def test_distinct_cuda_devices_without_nccl_are_refused(monkeypatch):
    monkeypatch.setattr(coll, "nccl_module", lambda: None)
    with pytest.raises(ValueError, match="NCCL"):
        par.make_mesh(devices=["cuda:0", "cuda:1"])


class _FakeNccl:
    """Stands in for torch.cuda.nccl: records each call, answers 7s."""

    def __init__(self):
        self.calls = []

    def reduce(self, inputs, output=None, root=0, op=0):
        self.calls.append(("reduce", len(inputs), root, op))
        output.fill_(7)


@pytest.mark.parametrize("devices, backend", [
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl"),
    (["cuda:0"], "nccl"),
    (["cuda"] * 4, "shared"),
    (["cpu"], "shared")])
def test_backend_follows_placement_and_nccl_is_never_replaced(
        devices, backend, monkeypatch):
    """Distinct CUDA devices (one included) take NCCL and every reduce goes
    through it, never through the shared combine; repeated devices take
    the shared combine."""
    fake = _FakeNccl()
    monkeypatch.setattr(coll, "nccl_module", lambda: fake)
    m = par.make_mesh(devices=devices)
    assert m.backend == backend
    if backend != "nccl":
        return
    c = m.collectives
    monkeypatch.setattr(c, "_check_placed", lambda *a: None)
    parts = [torch.full((2, 3), float(i)) for i in range(m.size)]
    for op, code in (("sum", 0), ("min", 3), ("max", 2)):
        assert (c.reduce(parts, op) == 7).all()
        assert fake.calls[-1] == ("reduce", m.size, 0, code)
    assert len(fake.calls) == 3


def test_shared_collectives_reduce_in_shard_order():
    c = coll.Collectives([torch.device("cpu")] * 4)
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.normal(size=(3, 5)) * 10.0 ** k)
             for k in range(4)]
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    assert torch.equal(c.reduce(parts, "sum"), want)
    assert torch.equal(c.reduce(parts, "min"),
                       torch.stack(parts).amin(0))
    assert torch.equal(c.reduce(parts, "max"),
                       torch.stack(parts).amax(0))
    assert torch.equal(c.reduce(parts[1:3], "sum", members=[1, 2]),
                       parts[1] + parts[2])
    ints = [torch.arange(6).reshape(2, 3) * k for k in range(4)]
    assert torch.equal(c.reduce(ints, "sum"), torch.arange(6).reshape(2, 3)
                       * 6)
    blocks = [torch.arange(k * 3, dtype=torch.float64).reshape(k, 3)
              for k in (2, 0, 1, 3)]
    assert torch.equal(c.all_gather(blocks), torch.cat(blocks))
    x = torch.ones(4)
    assert all(y is x for y in c.broadcast(x))
    with pytest.raises(ValueError):
        c.reduce(parts, "prod")


def test_shard_bounds_make_no_phantom_rows(mesh):
    assert sharded.shard_bounds(mesh, 12) == [
        (0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 12),
        (12, 12)]
    ts, val, mask = sorted_batch(np.random.default_rng(1), 12, 16)
    rows = sharded.shard_rows(mesh, ts, val, mask, np.zeros(12))
    assert sum(x.shape[0] for x in rows.ts) == 12
    full = torch.from_numpy(ts)
    views = sharded.shard_rows_device(mesh, full, t(val), t(mask),
                                      np.zeros(12))
    assert views.ts[1].data_ptr() == full[2:4].data_ptr()


# -- T1's square and centred modes -------------------------------------------


def _tile(seed=4, s=9, w=7, g=3):
    rng = np.random.default_rng(seed)
    contrib = rng.normal(30.0, 12.0, (s, w))
    contrib[rng.random((s, w)) < 0.1] = np.nan
    part = rng.random((s, w)) < 0.85
    present = rng.random((s, w)) < 0.8
    gid = np.sort(rng.integers(0, g, s))
    gid[gid == 1] = 2            # group 1 has no row
    return contrib, part, present, gid, g


def test_t1_square_and_centred_match_numpy():
    contrib, part, present, gid, g = _tile()
    s, w = contrib.shape
    off = ga.group_offsets(gid, g)
    sq = tiling.new_lane_fold(g, w, "square", "cpu")
    tiling.tile_partials(t(contrib), t(part), t(present), off, sq)
    ok = part & ~np.isnan(contrib)
    x = np.where(ok, contrib, 0.0)
    want_cnt = np.zeros((g, w), np.int64)
    want_tot = np.zeros((g, w))
    want_sq = np.zeros((g, w))
    for r in range(s):
        want_cnt[gid[r]] += ok[r]
        want_tot[gid[r]] += x[r]
        want_sq[gid[r]] += x[r] * x[r]
    assert set(sq) == {"cnt", "present", "sq"}
    assert_exact(sq["cnt"].numpy(), want_cnt)
    assert_values(sq["sq"].numpy(), want_sq)
    mean = want_tot / np.maximum(want_cnt, 1)
    cen = tiling.new_lane_fold(g, w, "centred", "cpu")
    assert set(cen) == {"m2"}
    tiling.tile_partials(t(contrib), t(part), t(present), off, cen,
                         mean=t(mean))
    want_m2 = np.zeros((g, w))
    for r in range(s):
        want_m2[gid[r]] += np.where(ok[r], contrib[r] - mean[gid[r]], 0) ** 2
    assert_values(cen["m2"].numpy(), want_m2)
    # a centred fold needs its mean, and only it takes one
    with pytest.raises(ValueError):
        tiling.tile_partials(t(contrib), t(part), t(present), off, cen)
    with pytest.raises(ValueError):
        tiling.tile_partials(t(contrib), t(part), t(present), off, sq,
                             mean=t(mean))


@pytest.mark.parametrize("agg", ["squareSum", "dev"])
def test_t1_tiles_then_finish_equal_k3(agg):
    """Folding the grid in two tiles (square, or additive then centred
    around the folded mean) and finishing gives K3's squareSum and dev."""
    contrib, part, present, gid, g = _tile(seed=8, s=12)
    w = contrib.shape[1]
    acc = tiling.new_lane_fold(g, w, tiling.lane_mode(agg), "cpu")
    for lo, hi in ((0, 5), (5, 12)):
        tiling.tile_partials(t(contrib[lo:hi]), t(part[lo:hi]),
                             t(present[lo:hi]),
                             ga.group_offsets(gid[lo:hi], g), acc)
    m2 = None
    if agg == "dev":
        mean = acc["tot"] / acc["cnt"].clamp(min=1)
        cen = tiling.new_lane_fold(g, w, "centred", "cpu")
        for lo, hi in ((0, 7), (7, 12)):
            tiling.tile_partials(t(contrib[lo:hi]), t(part[lo:hi]),
                                 t(present[lo:hi]),
                                 ga.group_offsets(gid[lo:hi], g), cen,
                                 mean=mean)
        m2 = cen["m2"]
    out, out_mask = tiling.finish_lane_fold(acc, agg, m2)
    want, want_mask = ga.group_moments(agg, t(contrib), t(part), t(present),
                                       ga.group_offsets(gid, g))
    assert_exact(out_mask.numpy(), want_mask.numpy())
    assert_values(out.numpy(), want.numpy())


# -- sharded_query_pipeline -------------------------------------------------


def _groups(m: str, s: int):
    """gid and group count of a query's group-by over s series, in dc
    order (s / 3 series a dc)."""
    if "{host=*}" in m:
        return np.arange(s, dtype=np.int64), s
    if "{dc=*}" in m:
        return np.repeat(np.arange(3, dtype=np.int64), s // 3), 3
    return np.zeros(s, np.int64), 1


def _validated(parse, query_cls, m: str):
    q = query_cls(start=str(T0 // 1000), end=str((T0 + SPAN) // 1000),
                  queries=[parse(m)])
    q.validate()
    return q.queries[0]


def _specs(m: str):
    sub = _validated(parse_m_subquery, TSQuery, m)
    ref = _validated(ref_parse, RefTSQuery, m)
    d = sub.downsample_spec
    rate = sub.rate_options if sub.rate else None
    port = PipelineSpec(sub.aggregator,
                        DownsampleStep(d.function, d.fill_policy,
                                       d.fill_value), rate)
    rd = ref.downsample_spec
    plan = rds.FixedWindows.for_range(T0, T0 + SPAN, rd.interval_ms)
    spec, wargs = plan.split()
    ref_spec = rpipe.PipelineSpec(
        ref.aggregator, rpipe.DownsampleStep(rd.function, spec,
                                             rd.fill_policy, rd.fill_value),
        None if rate is None else RefRate(**dataclasses.asdict(rate)),
        rows_sorted=True)
    edges = ds.FixedWindows.for_range(T0, T0 + SPAN,
                                      d.interval_ms).window_edges("cpu")
    return port, ref_spec, wargs, edges, plan.count


def _ref_sharded(ref_mesh, ref_spec, wargs, ts, val, mask, gid, g):
    fn = rsh.sharded_query_pipeline(ref_mesh, ref_spec, g)
    args = rsh.shard_rows(ref_mesh, ts, val, mask, gid, pad_gid_value=g)
    return [np.asarray(x) for x in fn(*args, wargs)]


def _batch(seed=7, s=12, int_values=False):
    return sorted_batch(np.random.default_rng(seed), s, 48, t0=T0,
                        span_ms=SPAN, int_values=int_values)


@pytest.mark.parametrize("m", MOMENT_QUERIES + ORDERED_QUERIES
                         + EXTRA_QUERIES)
def test_sharded_pipeline_matches_reference_and_single_device(
        m, mesh, ref_mesh):
    ts, val, mask = _batch()
    gid, g = _groups(m, ts.shape[0])
    port_spec, ref_spec, wargs, edges, w = _specs(m)
    got = par.sharded_query_pipeline(
        mesh, port_spec, g, par.shard_rows(mesh, ts, val, mask, gid), edges)
    one = run_group_pipeline(port_spec, t(ts), t(val), t(mask), gid, g,
                             edges)
    ref = _ref_sharded(ref_mesh, ref_spec, wargs, ts, val, mask, gid, g)
    for a, b in zip(got, one):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert_exact(got[0].numpy(), one[0].numpy())
    assert_exact(got[2].numpy(), one[2].numpy())
    assert_values(got[1].numpy(), one[1].numpy())
    assert_exact(got[0].numpy(), ref[0][:w])
    assert_exact(got[2].numpy(), ref[2][:g, :w])
    assert_values(got[1].numpy(), ref[1][:g, :w], got[2].numpy())


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "avg",
                                 "zimsum", "mimmin", "mimmax"])
@pytest.mark.parametrize("fill", ["none", "zero"])
def test_integer_moments_are_bit_for_bit(agg, fill, mesh):
    """Integer-valued data through a sum downsample: every partial sum is
    exact, so the meshed answer is the single-device one bit for bit."""
    ts, val, mask = _batch(seed=9, int_values=True)
    gid, g = _groups("{dc=*}", ts.shape[0])
    spec = PipelineSpec(agg, DownsampleStep("sum", fill))
    edges = ds.FixedWindows.for_range(T0, T0 + SPAN, 60_000).window_edges(
        "cpu")
    got = par.sharded_query_pipeline(
        mesh, spec, g, par.shard_rows(mesh, ts, val, mask, gid), edges)
    one = run_group_pipeline(spec, t(ts), t(val), t(mask), gid, g, edges)
    for a, b in zip(got, one):
        assert torch.equal(a.nan_to_num(-1.5), b.nan_to_num(-1.5))


def test_int32_ts_base_batch(mesh, ref_mesh):
    """A re-based hit's int32 batch over the mesh: equal to its int64
    form, to the single-device int32 answer and to the reference's."""
    ts, val, mask = _batch(seed=12)
    ts32 = np.clip(ts - T0, 0, ds.I32_PAD_TS).astype(np.int32)
    m = "sum:1m-avg:sys.cpu.user{dc=*}"
    gid, g = _groups(m, ts.shape[0])
    port_spec, ref_spec, wargs, edges, w = _specs(m)
    got = par.sharded_query_pipeline(
        mesh, port_spec, g, par.shard_rows_device(
            mesh, t(ts32), t(val), t(mask), gid), edges, ts_base=T0)
    wide = par.sharded_query_pipeline(
        mesh, port_spec, g, par.shard_rows(mesh, ts, val, mask, gid), edges)
    one = run_group_pipeline(port_spec, t(ts32), t(val), t(mask), gid, g,
                             edges, ts_base=T0)
    for a, b in zip(got, wide):
        assert torch.equal(a.nan_to_num(-1.5), b.nan_to_num(-1.5))
    assert_values(got[1].numpy(), one[1].numpy())
    ref = _ref_sharded(ref_mesh, ref_spec,
                       dict(wargs, ts_base=jnp.asarray(T0, jnp.int64)),
                       ts32, val, mask, gid, g)
    assert_exact(got[2].numpy(), ref[2][:g, :w])
    assert_values(got[1].numpy(), ref[1][:g, :w], got[2].numpy())


def test_sharded_pipeline_on_other_shapes_and_sizes():
    """Any mesh size answers alike, one device included, with more
    shards than rows."""
    ts, val, mask = _batch(seed=13, s=6)
    gid = np.array([0, 0, 1, 1, 1, 2])
    spec = PipelineSpec("avg", DownsampleStep("avg", "zero"))
    edges = ds.FixedWindows.for_range(T0, T0 + SPAN, 60_000).window_edges(
        "cpu")
    one = run_group_pipeline(spec, t(ts), t(val), t(mask), gid, 3, edges)
    for devices in (["cpu"], ["cpu"] * 2, ["cpu"] * 16):
        m = par.make_mesh(devices=devices)
        got = par.sharded_query_pipeline(
            m, spec, 3, par.shard_rows(m, ts, val, mask, gid), edges)
        assert_exact(got[2].numpy(), one[2].numpy())
        assert_values(got[1].numpy(), one[1].numpy())


# -- sharded_rollup ----------------------------------------------------------


def test_sharded_rollup_matches_reference():
    r = np.random.default_rng(7)
    s, n = 14, 90
    ts = T0 + np.cumsum(r.integers(1_000, 30_000, size=(s, n)),
                        axis=1).astype(np.int64)
    val = r.normal(100.0, 25.0, size=(s, n))
    mask = r.random((s, n)) < 0.9
    ref_plan = rds.FixedWindows.for_range(T0, int(ts.max()), 600_000)
    spec, wargs = ref_plan.split()
    ref_mesh = rpar.make_mesh(8, shape=(4, 2))
    fn = rsh.sharded_rollup(ref_mesh, spec)
    args = rsh.shard_series(ref_mesh, ts, val, mask, np.zeros(s, np.int64))
    _, rtot, rcnt, rlo, rhi = (np.asarray(x) for x in fn(*args[:3], wargs))
    m = par.make_mesh(devices=CPU8, shape=(4, 2))
    edges = ds.FixedWindows.for_range(T0, int(ts.max()),
                                      600_000).window_edges("cpu")
    parts = par.sharded_rollup(m, par.shard_series(m, ts, val, mask), edges)
    tot, cnt, lo, hi = (np.concatenate([p[q].numpy() for p in parts])
                        for q in range(4))
    w = ref_plan.count
    assert_exact(cnt, rcnt[:s, :w].astype(np.int32))
    live = cnt > 0
    assert_values(tot[live], rtot[:s, :w][live])
    assert_exact(lo[live], rlo[:s, :w][live])
    assert_exact(hi[live], rhi[:s, :w][live])
    assert (lo[~live] == math.inf).all() and (hi[~live] == -math.inf).all()
    # one block is L1 over the whole batch, cell for cell
    whole = lane_partials(t(ts), t(val), t(mask), edges)
    for a, b in zip(par.sharded_rollup(
            par.make_mesh(devices=["cpu"]),
            par.shard_series(par.make_mesh(devices=["cpu"]), ts, val, mask),
            edges)[0], whole):
        assert torch.equal(a, b)


# -- ShardedStreamAccumulator ------------------------------------------------


def _chunks(ts, val, mask, chunk):
    s, n = ts.shape
    for k in range(0, n, chunk):
        w = min(chunk, n - k)
        cts = np.full((s, chunk), PAD_TS, np.int64)
        cval = np.zeros((s, chunk), np.float64)
        cmask = np.zeros((s, chunk), bool)
        cts[:, :w] = ts[:, k:k + w]
        cval[:, :w] = val[:, k:k + w]
        cmask[:, :w] = mask[:, k:k + w]
        yield cts, cval, cmask


def _widest_chunk(ts, interval, chunk=16):
    """The widest chunk's span in windows, as the planner sizes a slice."""
    out = 1
    for cts, _, _ in _chunks(ts, ts, ts, chunk):
        real = cts[cts != PAD_TS]
        if real.size:
            out = max(out, int((real.max() - real.min()) // interval) + 2)
    return out


@pytest.mark.parametrize("m, sliced, sketch", [
    ("sum:1m-avg:sys.cpu.user{dc=*}", False, False),
    ("dev:1s-max:sys.cpu.user{dc=*}", True, False),
    ("p95:1s-sum:sys.cpu.user{dc=*}", True, False),
    ("sum:rate:1m-count:sys.cpu.user", False, False),
    ("sum:1m-p90:sys.cpu.user{dc=*}", False, True),
    ("max:1s-median:sys.cpu.user{dc=*}", True, True)])
def test_sharded_stream_accumulator_matches_reference(m, sliced, sketch,
                                                      mesh, ref_mesh):
    ts, val, mask = _batch(seed=17)
    s = ts.shape[0]
    gid, g = _groups(m, s)
    port_spec, ref_spec, wargs, edges, w = _specs(m)
    fn = port_spec.downsample.function
    lanes = st.lanes_for([fn])
    interval = parse_m_subquery(m).downsample.split("-")[0]
    interval = 1_000 if interval == "1s" else 60_000
    windows = ds.FixedWindows.for_range(T0, T0 + SPAN, interval)
    ref_windows = rds.FixedWindows.for_range(T0, T0 + SPAN, interval)
    ws = _widest_chunk(ts, interval) if sliced else None
    port = par.ShardedStreamAccumulator(mesh, s, windows, sketch=sketch,
                                        lanes=lanes, window_slice=ws)
    rspec, _ = ref_windows.split()
    ref = rsh.ShardedStreamAccumulator(ref_mesh, s, rspec, wargs,
                                       sketch=sketch, lanes=lanes,
                                       window_slice=ws)
    one = st.StreamAccumulator.create(s, windows, "cpu", sketch=sketch,
                                      lanes=lanes, window_slice=ws)
    assert port.window_slice == ref.window_slice == one.window_slice
    assert (port.window_slice is not None) == sliced
    for cts, cval, cmask in _chunks(ts, val, mask, 16):
        real = cts[cts != PAD_TS]
        w0 = (int((real.min() - T0) // interval) if sliced and real.size
              else None)
        port.update(t(cts), t(cval), t(cmask), w0=w0)
        one.update(t(cts), t(cval), t(cmask), w0=w0)
        ref.update(cts, cval, cmask, w0=w0)
    assert port.oob_count() == ref.oob_count() == one.oob_count() == 0
    got = port.finish_tail(port_spec, gid, g)
    want = run_grid_tail(
        port_spec, *one.finish(fn, port_spec.downsample.fill_policy,
                               port_spec.downsample.fill_value), gid, g)
    rgot = [np.asarray(x) for x in ref.finish_tail(ref_spec, gid, g)]
    assert_exact(got[2].numpy(), want[2].numpy())
    assert_values(got[1].numpy(), want[1].numpy())
    assert_exact(got[2].numpy(), rgot[2][:g, :w])
    tol = dict(rtol=1e-6, atol=1e-6) if sketch else {}
    live = got[2].numpy()
    np.testing.assert_allclose(got[1].numpy()[live],
                               rgot[1][:g, :w][live],
                               **(tol or dict(rtol=1e-9, atol=1e-9)))


def test_sharded_stream_wrong_w0_is_counted_over_the_shards(mesh):
    ts, val, mask = _batch(seed=19)
    s = ts.shape[0]
    windows = ds.FixedWindows.for_range(T0, T0 + SPAN, 1_000)
    args = dict(lanes=st.lanes_for(["sum"]), window_slice=64)
    port = par.ShardedStreamAccumulator(mesh, s, windows, **args)
    one = st.StreamAccumulator.create(s, windows, "cpu", **args)
    assert port.window_slice == one.window_slice == 64
    for cts, cval, cmask in _chunks(ts, val, mask, 16):
        port.update(t(cts), t(cval), t(cmask), w0=300)
        one.update(t(cts), t(cval), t(cmask), w0=300)
    assert port.oob_count() == one.oob_count() > 0
