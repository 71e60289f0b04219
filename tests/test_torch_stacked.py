"""The stacked grouped pipeline (B14) on both packages, on the CPU.

The reference's run_stacked_group_pipeline (opentsdb_tpu/ops/pipeline.py
:261, the vmap of _group_pipeline over a member axis) against the port's
(ops/pipeline.py, one [Q*S, N] batch with edges [Q, W+1]) for Q = 3
members, each with its own data, its own window start and its own group
count (1, 3 and 1).  The reference pads the windows to a power of two and
every member's groups to one count; the port holds each member's W
windows and G_q groups, so the masked-in entries of the reference's
[Q, G_pad, W_pad] output are compared, and its padding must be masked
out.  Values agree at rtol 1e-9 (torch_parity.RTOL), on integer data the
moment functions bit for bit; timestamps and masks are equal.  A member's
stacked answer is its solo dispatch's bit for bit, on float data.
"""

import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops.rate import RateOptions as JRateOptions
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops.rate import RateOptions

from torch_parity import assert_exact, assert_values, sorted_batch, t

T0 = 1_356_998_400_000
Q, S, N, W = 3, 6, 96, 12
INTERVAL = 60_000
GROUPS = (1, 3, 1)
G_PAD = 4
MOMENT_DS = ("avg", "sum", "max", "first")

# (downsample function, aggregator): every downsample function under sum,
# every aggregator under avg and under p95; each with and without a rate
PAIRS = sorted({(ds, "sum") for ds in ("avg", "sum", "max", "p95", "first",
                                        "movingAverage3")}
               | {(ds, agg) for ds in ("avg", "p95")
                  for agg in ("sum", "max", "p99", "movingAverage3")})


def _members(int_values: bool):
    """Q members: [S, N] sorted rows over their own W windows, gid with
    their own group count, their own first window."""
    rng = np.random.default_rng(7 if int_values else 5)
    out = []
    for q, g in enumerate(GROUPS):
        first = T0 + q * 5_400_000 + q * INTERVAL
        ts, val, mask = sorted_batch(rng, S, N, t0=first,
                                     span_ms=W * INTERVAL,
                                     int_values=int_values)
        gid = np.sort(np.concatenate([np.arange(g),
                                      rng.integers(0, g, S - g)]))
        out.append((ts, val, mask, gid.astype(np.int64), first))
    return out


def _reference(members, ds, agg, rate):
    plans = [jds.FixedWindows(INTERVAL, m[4], W) for m in members]
    splits = [p.split() for p in plans]
    wargs = {k: np.stack([np.asarray(w[k]) for _, w in splits])
             for k in splits[0][1]}
    spec = jpipe.PipelineSpec(
        agg, jpipe.DownsampleStep(ds, splits[0][0], "none", 0.0),
        None if rate is None else JRateOptions(*rate), int_mode=False,
        rows_sorted=True)
    out = jpipe.run_stacked_group_pipeline(
        spec, *(np.stack([m[i] for m in members]) for i in range(4)), G_PAD,
        wargs)
    return [np.asarray(x) for x in out]


def _port_spec(ds, agg, rate):
    return tpipe.PipelineSpec(agg, tpipe.DownsampleStep(ds),
                              None if rate is None else RateOptions(*rate))


def _port(members, spec):
    """The port's stacked pipeline over the members' [Q, S, N] batch."""
    edges = np.stack([m[4] + np.arange(W + 1, dtype=np.int64) * INTERVAL
                      for m in members])
    return tpipe.run_stacked_group_pipeline(
        spec, *(t(np.stack([m[i] for m in members])) for i in range(3)),
        np.stack([m[3] for m in members]), list(GROUPS), t(edges))


@pytest.mark.parametrize("rate", [None, ()], ids=["plain", "rate"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "%s-%s" % p)
def test_stacked_pipeline_matches_reference(pair, rate):
    ds, agg = pair
    members = _members(False)
    ref = _reference(members, ds, agg, rate)
    port = _port(members, _port_spec(ds, agg, rate))
    for q, (wts, out, mask) in enumerate(port):
        g = GROUPS[q]
        assert_exact(wts.numpy(), ref[0][q, :W])
        assert_exact(mask.numpy(), ref[2][q, :g, :W])
        assert not ref[2][q, g:, :W].any()       # the reference's padding
        assert not ref[2][q, :, W:].any()
        assert_values(out.numpy(), ref[1][q, :g, :W], where=mask.numpy())


@pytest.mark.parametrize("rate", [None, ()], ids=["plain", "rate"])
@pytest.mark.parametrize("ds", MOMENT_DS)
@pytest.mark.parametrize("agg", ["sum", "max"])
def test_stacked_integer_data_bit_for_bit(agg, ds, rate):
    """On integer data the moment downsamples and aggregators are exact in
    any order: the port's stacked answer is the reference's bit for bit."""
    members = _members(True)
    ref = _reference(members, ds, agg, rate)
    port = _port(members, _port_spec(ds, agg, rate))
    for q, (_wts, out, mask) in enumerate(port):
        g = GROUPS[q]
        m = mask.numpy()
        assert_exact(m, ref[2][q, :g, :W])
        assert_exact(out.numpy()[m], ref[1][q, :g, :W][m])


@pytest.mark.parametrize("rate", [None, ()], ids=["plain", "rate"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "%s-%s" % p)
def test_stacked_equals_solo_bit_for_bit(pair, rate):
    """A member's stacked answer is its solo dispatch's bit for bit, on
    float data: every kernel runs the same code on each row."""
    members = _members(False)
    spec = _port_spec(*pair, rate)
    for m, (wts, out, mask) in zip(members, _port(members, spec)):
        edges = m[4] + np.arange(W + 1, dtype=np.int64) * INTERVAL
        solo = tpipe.run_group_pipeline(spec, t(m[0]), t(m[1]), t(m[2]),
                                        m[3], int(m[3].max()) + 1, t(edges))
        for a, b in zip((wts, out, mask), solo):
            assert torch.equal(torch.nan_to_num(a, nan=7.25),
                               torch.nan_to_num(b, nan=7.25))


def test_wrappers_refuse_bad_edges_and_member_counts():
    ts, val, mask = (t(x) for x in sorted_batch(np.random.default_rng(1), 6,
                                                32))
    edges = torch.arange(W + 1, dtype=torch.int64) * INTERVAL + T0
    for bad in (edges[None, None, :],               # 3-D
                edges.expand(4, -1).contiguous(),   # 6 rows for 4 members
                edges[:1],                          # no window
                edges.to(torch.float64)):           # not int64
        for fn in (tds.window_moments, tds.window_order):
            with pytest.raises(ValueError):
                fn(ts, val, mask, bad, "sum" if fn is tds.window_moments
                   else "p95")
    v = torch.zeros((6, W), dtype=torch.float64)
    m = torch.ones((6, W), dtype=torch.bool)
    wts = edges[:-1]
    for bad in (wts.expand(4, -1).contiguous(),     # 6 rows for 4 members
                wts[None, :-1],                     # W - 1 timestamps
                wts[None, None, :]):                # 3-D
        with pytest.raises(ValueError):
            tga.grid_fill_rate(bad, v, m, "lerp")
    spec = _port_spec("avg", "sum", None)
    with pytest.raises(ValueError):     # the stacked dispatch takes [Q, W+1]
        tpipe.stacked_group_outputs(spec, ts, val, mask,
                                    np.zeros((1, 6), np.int64), [1], edges)
    with pytest.raises(ValueError):     # a row outside its member's groups
        tpipe.stacked_group_outputs(
            spec, ts, val, mask, np.array([[0, 0, 0], [0, 0, 9]]), [1, 1],
            edges.expand(2, -1).contiguous())


def test_stacked_offsets_concatenate_member_groups():
    gid = np.array([[0, 0, 1, 2], [0, 0, 0, 0], [0, 1, 1, 1]])
    assert tpipe.stacked_offsets(gid, [3, 1, 2]).tolist() \
        == [0, 2, 3, 4, 8, 9, 12]
