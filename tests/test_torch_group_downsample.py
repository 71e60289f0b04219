"""P1 point_group_moments and the port's ``sharded_group_downsample``
(opentsdb_tpu_torch/parallel/sharded.py) against the reference's
(opentsdb_tpu/parallel/sharded.py:129), on the CPU.

The port runs on ``make_mesh(devices=["cpu"] * 8)``, the reference on
conftest's 8 virtual devices; the same batch, made with numpy from one
seed, goes to both.  Counts (count's answer and the masks) must match
exactly and every other value at rtol 1e-9 and atol 1e-9 on the real
[:, :W] cells (the reference pads its windows to a power of two).  The
batches hold what the reference's cases do and more: an interleaved gid
(tests/test_parallel.py's arange(S) % G), NaN values, masked points,
points outside the windows, int64 values, (group, window) cells of one
point (dev 0) and fewer series than the mesh has shards (empty blocks).
P1's kernel against its plain version is tests/test_torch_gpu.py's.
"""

import math

import jax
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu import parallel as rpar
from opentsdb_tpu.ops import downsample as rds
from opentsdb_tpu_torch import parallel as par
from opentsdb_tpu_torch.ops import downsample as ds
from opentsdb_tpu_torch.ops import lanes

from torch_parity import ATOL, RTOL, assert_exact, t

T0 = 1_356_998_400_000
INTERVAL = 60_000
G = 4
CPU8 = ["cpu"] * 8
AGGS = sorted(par.SHARDED_AGGS)


def _batch(kind: str):
    """(ts, val, mask, gid, windows) of one case, from numpy seed 7."""
    r = np.random.default_rng(7)
    s, n = {"sparse": (3, 96), "one_point": (8, 24)}.get(kind, (16, 256))
    ts = T0 + np.cumsum(r.integers(1_000, 30_000, size=(s, n)),
                        axis=1).astype(np.int64)
    if kind == "int":
        val = r.integers(-10**6, 10**6, size=(s, n)).astype(np.int64)
    else:
        val = r.normal(100.0, 25.0, size=(s, n))
        val[r.random((s, n)) < 0.05] = np.nan
    mask = r.random((s, n)) < 0.9
    gid = (np.arange(s) % G).astype(np.int64)
    if kind == "one_point":
        # one point a row, every row's group alone in its window
        ts = T0 + np.arange(s, dtype=np.int64)[:, None] * 7 * INTERVAL \
            + np.arange(n, dtype=np.int64)[None, :] * 2 * INTERVAL
        mask = np.zeros((s, n), bool)
        mask[:, 0] = True
        val[:, 0] = np.arange(s, dtype=np.float64)
    # the windows leave the first and the last points of the data out
    lo = int(np.quantile(ts, 0.05))
    hi = int(np.quantile(ts, 0.95))
    return ts, val, mask, gid, (lo, hi)


KINDS = ["floats", "int", "sparse", "one_point"]


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
    return rpar.make_mesh(8)


def _reference(ref_mesh, agg, ts, val, mask, gid, span):
    spec, wargs = rds.FixedWindows.for_range(*span, INTERVAL).split()
    fn = rpar.sharded_group_downsample(ref_mesh, agg, spec, G)
    args = rpar.shard_series(ref_mesh, ts, val, mask, gid)
    return [np.asarray(x) for x in jax.device_get(fn(*args, wargs))]


def _port(agg, ts, val, mask, gid, span, devices=CPU8, shape=None):
    mesh = par.make_mesh(devices=devices, shape=shape)
    edges = ds.FixedWindows.for_range(*span, INTERVAL).window_edges("cpu")
    return par.sharded_group_downsample(
        mesh, agg, par.shard_series(mesh, ts, val, mask), gid, G, edges)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("agg", AGGS)
def test_sharded_group_downsample_matches_reference(ref_mesh, agg, kind):
    ts, val, mask, gid, span = _batch(kind)
    wts, out, out_mask = _port(agg, ts, val, mask, gid, span)
    rwts, rout, rmask = _reference(ref_mesh, agg, ts, val, mask, gid, span)
    w = wts.numel()
    assert w == ds.FixedWindows.for_range(*span, INTERVAL).count
    assert out.shape == out_mask.shape == (G, w)
    assert_exact(wts.numpy(), rwts[:w])
    assert_exact(out_mask.numpy(), rmask[:, :w])
    live = out_mask.numpy()
    assert live.any()
    if kind == "one_point":
        assert not live.all()
    got, want = out.numpy(), rout[:, :w]
    if agg == "count":
        assert_exact(got[live], want[live])
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)
    # every answer, count included, is NaN where no point counted
    assert np.isnan(got[~live]).all() and np.isnan(want[~live]).all()
    if kind == "one_point" and agg == "dev":
        assert (got[live] == 0.0).all()


@pytest.mark.parametrize("agg", ["avg", "dev", "min", "count"])
def test_any_mesh_shape_answers_alike(agg):
    """(8, 1), (4, 2) and (2, 4) meshes and one shard: the same answer
    at rtol 1e-12 (sharding invariance)."""
    ts, val, mask, gid, span = _batch("floats")
    outs = [_port(agg, ts, val, mask, gid, span, shape=shape)
            for shape in [(8, 1), (4, 2), (2, 4)]]
    outs.append(_port(agg, ts, val, mask, gid, span, devices=["cpu"]))
    for _, out, om in outs[1:]:
        assert_exact(om.numpy(), outs[0][2].numpy())
        np.testing.assert_allclose(out.numpy(), outs[0][1].numpy(),
                                   rtol=1e-12, equal_nan=True)


def test_unsupported_aggregator_raises():
    ts, val, mask, gid, span = _batch("sparse")
    assert "p99" not in par.SHARDED_AGGS
    assert len(par.SHARDED_AGGS) == 10
    with pytest.raises(KeyError):
        _port("p99", ts, val, mask, gid, span)


def test_rows_outside_every_group_take_no_part():
    ts, val, mask, gid, span = _batch("floats")
    gid = gid.copy()
    gid[::3] = -1
    gid[1::5] = G
    _, out, om = _port("sum", ts, val, mask, gid, span)
    keep = (gid >= 0) & (gid < G)
    _, want, wm = _port("sum", ts[keep], val[keep], mask[keep], gid[keep],
                        span)
    assert_exact(om.numpy(), wm.numpy())
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12,
                               equal_nan=True)


# -- P1's plain version and its member list ---------------------------------


def test_group_members_is_a_stable_csr():
    gid = t(np.array([2, 0, 2, 5, 1, 0, -1, 2], np.int64))
    members, offsets = lanes.group_members(gid, 3)
    assert offsets.tolist() == [0, 2, 3, 6]
    assert members[:6].tolist() == [1, 5, 4, 0, 2, 7]


@pytest.mark.parametrize("mode", lanes.P1_MODES)
def test_point_group_moments_plain_matches_numpy(mode):
    ts, val, mask, gid, span = _batch("floats")
    windows = ds.FixedWindows.for_range(*span, INTERVAL)
    edges = windows.window_edges("cpu")
    w = windows.count
    members, offsets = lanes.group_members(t(gid), G)
    rng = np.random.default_rng(3)
    mean = rng.normal(100.0, 5.0, (G, w)) if mode == "centred" else None
    got = lanes.point_group_moments(
        t(ts), t(val), t(mask), edges, members, offsets, mode,
        None if mean is None else t(mean))
    assert sorted(got) == sorted(lanes.P1_LANES[mode])
    win = (ts - windows.first_window_ms) // INTERVAL
    for g in range(G):
        for k in range(w):
            sel = mask & (gid[:, None] == g) & (win == k) & ~np.isnan(val)
            x = val[sel]
            if mode == "centred":
                np.testing.assert_allclose(
                    float(got["m2"][g, k]), ((x - mean[g, k]) ** 2).sum(),
                    rtol=1e-12, atol=1e-9)
                continue
            assert int(got["cnt"][g, k]) == x.size
            if mode == "additive":
                np.testing.assert_allclose(float(got["tot"][g, k]), x.sum(),
                                           rtol=1e-12, atol=1e-9)
            elif mode == "square":
                np.testing.assert_allclose(float(got["sq"][g, k]),
                                           (x * x).sum(), rtol=1e-12)
            else:
                assert float(got["lo"][g, k]) == (x.min() if x.size
                                                  else math.inf)
                assert float(got["hi"][g, k]) == (x.max() if x.size
                                                  else -math.inf)


def test_point_group_moments_checks_its_arguments():
    ts, val, mask, gid, span = _batch("sparse")
    edges = ds.FixedWindows.for_range(*span, INTERVAL).window_edges("cpu")
    members, offsets = lanes.group_members(t(gid), G)
    with pytest.raises(ValueError, match="modes"):
        lanes.point_group_moments(t(ts), t(val), t(mask), edges, members,
                                  offsets, "median")
    with pytest.raises(ValueError, match="mean"):
        lanes.point_group_moments(t(ts), t(val), t(mask), edges, members,
                                  offsets, "centred")
    with pytest.raises(ValueError, match="int64"):
        lanes.point_group_moments(t(ts), t(val), t(mask), edges,
                                  members.to(torch.int32), offsets,
                                  "additive")
