"""Kernels K4 (window_order), K5 (group_order), U3 (union_order) and MA
(moving_average) against the JAX package, on the CPU, where the port runs
their plain PyTorch versions.

* K4: every order and rank downsample function on fixed, calendar (edge)
  and run-all grids under every fill policy, on float rows (NaN values,
  holes, an empty row), integer rows and rows full of ties, against
  opentsdb_tpu.ops.downsample.downsample.
* K5: every order and rank aggregator against ordered_group_reduce, with
  a group of one row and an empty group, and the presence mask of
  grid_group_aggregate; and at the kernel's route edges (groups of 0, 1,
  2, 31, 32, 33, 100, 2200, 4224 and 4225 rows under either tile:
  torch_parity.K5_EDGE_LAYOUTS).
* U3: every order and rank aggregator against union_aggregate, float and
  int mode (values above 2^53), and groups of uneven size; groups at the
  kernel's edges (1, 31, 32, 33 and 1013 members) with empty rows,
  disjoint spans, repeated timestamps, NaN values and ties.
* MA: java_moving_average itself, and movingAverage<N> in its three
  positions: the downsample function, the grid aggregator
  (moment_group_reduce) and the union aggregator (union_aggregate); runs
  shorter than the window, empty and all-dead runs, a window past the
  kernel's shared ring, int64 sums that wrap, and the cancellation case
  held to the ordered running sums.

Values agree at rtol 1e-9 (torch_parity.RTOL) with NaN positions equal;
masks, timestamps and int-mode values are exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import aggregators as jagg
from opentsdb_tpu.ops import group_agg as jga
from opentsdb_tpu.ops import union_agg as jua
from opentsdb_tpu.ops.aggregators import Aggregator
from opentsdb_tpu_torch.ops import aggregators as tagg
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops import union_agg as tua
from opentsdb_tpu_torch.ops.aggregators import ORDER_AGGS, PERCENTILE_AGGS

from test_torch_downsample import FILLS, _port, _reference
from test_torch_group_agg import _grid, _ref_k2
from test_torch_union import GROUPS, ROWS, _assert_same, _batch, _run_both
from torch_parity import (K5_EDGE_LAYOUTS, PAD_TS, assert_exact,
                          assert_values, k5_edge_groups, sorted_batch, t)

DS_FUNCS = ["first", "last", "diff", "mult", "median", *PERCENTILE_AGGS]
AGGS = sorted(ORDER_AGGS)
KINDS = ["fixed", "edges", "all"]
MA_NAMES = ["movingAverage", "movingAverage1", "movingAverage3"]
T0 = 1_356_998_400_000


# -- K4: the downsample position -------------------------------------------

def _ds_batch():
    return sorted_batch(np.random.default_rng(7), 6, 64)


@functools.cache
def _ds_reference(func, kind):
    return _reference(*_ds_batch(), func, kind, FILLS)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("func", DS_FUNCS + MA_NAMES)
def test_downsample_order_and_ma_match_reference(func, kind):
    """Every fill policy from one reference downsample (apply_fill
    composition, as test_torch_downsample does)."""
    for fill in FILLS:
        ref = _ds_reference(func, kind)[fill]
        port = _port(*_ds_batch(), func, kind, fill)
        assert_exact(port[0], ref[0])
        assert_exact(port[2], ref[2])
        assert_values(port[1], ref[1])


@pytest.mark.parametrize("func", ["first", "diff", "mult", "median", "p50",
                                  "ep75r3", "ep90r7", "movingAverage2"])
@pytest.mark.parametrize("values", ["int64", "ties"])
def test_downsample_order_int_and_tied_values(func, values):
    rng = np.random.default_rng(12)
    ts, val, mask = sorted_batch(rng, 6, 64, int_values=values == "int64")
    if values == "ties":
        val = np.round(val / 25.0)           # a handful of distinct values
    ref = _reference(ts, val, mask, func, "fixed", ["none"])["none"]
    port = _port(ts, val, mask, func, "fixed", "none")
    assert_exact(port[2], ref[2])
    assert_values(port[1], ref[1])


def test_window_order_refuses_moments_and_none():
    ts, val, mask = _ds_batch()
    edges = tds.AllWindow(0, 2**62).window_edges("cpu")
    for name in ("sum", "none", "movingAverage"):
        with pytest.raises(KeyError):
            tds.window_order(t(ts), t(val), t(mask), edges, name)


# -- K5: the grid position -------------------------------------------------

_ordered = jax.jit(jga.ordered_group_reduce,
                   static_argnames=("agg_name", "num_groups"))
_group_aggregate = jax.jit(jga.grid_group_aggregate,
                           static_argnames=("num_groups", "agg",
                                            "rows_sorted"))
_moment = jax.jit(jga.moment_group_reduce,
                  static_argnames=("agg_name", "num_groups", "rows_sorted"))

# groups 0 (4 rows), 1 (one row), 2 (empty), 3 (5 rows), 4 (2 rows)
GID = np.array([0, 0, 0, 0, 1, 3, 3, 3, 3, 3, 4, 4], np.int64)
NUM_GROUPS = 6      # group 5 is empty too


@functools.cache
def _grid_inputs(rate: bool):
    rng = np.random.default_rng(23)
    wts, v, mask = _grid(rng, len(GID), True)
    contrib, participate, present = _ref_k2(
        wts, v, mask, "prev" if rate else "lerp", () if rate else None)
    # ties across members and a NaN value that participates
    contrib = np.where(np.arange(len(GID))[:, None] % 3 == 0,
                       np.round(contrib / 40.0), contrib)
    contrib[6, 3] = np.nan
    return contrib, participate, present


def _ref_mask(contrib, present):
    _, _, out_mask = _group_aggregate(
        np.zeros(contrib.shape[1], np.int64), contrib, present, GID,
        num_groups=NUM_GROUPS, agg=Aggregator("sum", "lerp", None),
        rows_sorted=True)
    return np.asarray(out_mask)


@pytest.mark.parametrize("rate", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_group_order_matches_reference(agg, rate):
    contrib, participate, present = _grid_inputs(rate)
    ref, _ = _ordered(agg_name=agg, contrib=contrib, participate=participate,
                      gid=GID, num_groups=NUM_GROUPS)
    out, out_mask = tga.group_order(agg, t(contrib), t(participate),
                                    t(present),
                                    tga.group_offsets(GID, NUM_GROUPS))
    assert_values(out.numpy(), np.asarray(ref))
    assert_exact(out_mask.numpy(), _ref_mask(contrib, present))
    assert np.isnan(out.numpy()[[2, 5]]).all()        # the empty groups


def test_group_order_first_follows_row_order():
    contrib = np.array([[5.0, np.nan], [1.0, 2.0], [3.0, 4.0]])
    ok = np.ones_like(contrib, bool)
    offsets = tga.group_offsets(np.zeros(3, np.int64), 1)
    got = {name: tga.group_order(name, t(contrib), t(ok), t(ok), offsets)[0]
           .numpy()[0].tolist() for name in ("first", "last", "diff")}
    assert got == {"first": [5.0, 2.0], "last": [3.0, 4.0],
                   "diff": [-2.0, 2.0]}


K5_EDGE_AGGS = ["first", "last", "diff", "none", "mult", "median", "p99",
                "ep99r3", "ep50r7"]


@pytest.mark.parametrize("agg", K5_EDGE_AGGS)
@pytest.mark.parametrize("layout", list(K5_EDGE_LAYOUTS))
def test_group_order_route_edges_match_reference(layout, agg):
    contrib, participate, present, offsets = k5_edge_groups(layout)
    g = len(offsets) - 1
    gid = np.repeat(np.arange(g, dtype=np.int64), np.diff(offsets))
    ref, _ = _ordered(agg_name=agg, contrib=contrib, participate=participate,
                      gid=gid, num_groups=g)
    _, _, ref_mask = _group_aggregate(
        np.zeros(contrib.shape[1], np.int64), contrib, present, gid,
        num_groups=g, agg=Aggregator("sum", "lerp", None), rows_sorted=True)
    out, out_mask = tga.group_order(agg, t(contrib), t(participate),
                                    t(present), t(offsets))
    assert_values(out.numpy(), np.asarray(ref))
    assert_exact(out_mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("agg", MA_NAMES)
def test_group_moving_average_matches_reference(agg):
    contrib, participate, present = _grid_inputs(False)
    ref, _ = _moment(agg_name=agg, contrib=contrib, participate=participate,
                     gid=GID, num_groups=NUM_GROUPS, rows_sorted=True)
    out, out_mask = tpipe.group_reduce(agg, t(contrib), t(participate),
                                       t(present),
                                       tga.group_offsets(GID, NUM_GROUPS))
    assert_values(out.numpy(), np.asarray(ref))
    assert_exact(out_mask.numpy(), _ref_mask(contrib, present))


# -- U3 and MA: the union position ----------------------------------------

@pytest.mark.parametrize("agg", AGGS + MA_NAMES)
def test_union_order_and_ma_match_reference(agg):
    ts, val, mask = _batch(51)
    policy = jagg.get_agg(agg).interpolation
    _assert_same(*_run_both(ts, val, mask, agg, policy, False), False, agg)


@pytest.mark.parametrize("agg", AGGS + MA_NAMES)
def test_union_order_and_ma_int_mode_match_reference(agg):
    """Values near and above 2^53 (2^60 on one row): the median is the
    exact long, percentiles the truncated float64 ones, mult and diff
    wrap; every int-mode value exact.  The reference runs group by group
    and eagerly, so that each of its operations rounds on its own, as the
    port's (and its kernel's) do: under jit, XLA fuses the percentile's
    a + d * (b - a) into one multiply-add, and near 2^53 the truncation of
    that result can land one long away from the eager answer."""
    ts, val, mask = _batch(52, int_values=True)
    agg_ = jagg.get_agg(agg)
    offsets = tga.group_offsets(np.repeat(np.arange(GROUPS), ROWS), GROUPS)
    pu, pout, puoff = tua.union_aggregate(t(ts), t(val), t(mask), offsets,
                                          agg, agg_.interpolation)
    assert pout.dtype == torch.int64
    for g in range(GROUPS):
        rows = slice(g * ROWS, (g + 1) * ROWS)
        ru, rout, rmask = (np.asarray(x) for x in jua.union_aggregate(
            ts[rows], val[rows], mask[rows], agg_, True))
        assert_exact(pu[puoff[g]:puoff[g + 1]].numpy(), ru[rmask])
        assert_exact(pout[puoff[g]:puoff[g + 1]].numpy(), rout[rmask])


def test_union_order_under_a_rate_policy():
    ts, val, mask = _batch(53)
    for agg in ("diff", "p99", "first"):
        _assert_same(*_run_both(ts, val, mask, agg, "prev", False), False,
                     agg)


def test_union_int_median_is_exact_above_2_53():
    """Longs that share one float64: the median picks the exact long."""
    base = 2**60
    ts = np.array([[1000], [1000], [1000]], np.int64)
    val = np.array([[base + 3], [base + 1], [base + 2]], np.int64)
    mask = np.ones_like(ts, bool)
    offsets = torch.tensor([0, 3])
    _, out, _ = tua.union_aggregate(t(ts), t(val), t(mask), offsets,
                                    "median", "lerp")
    assert out.tolist() == [base + 2]


# -- MA itself -------------------------------------------------------------

@pytest.mark.parametrize("int_mode", [False, True])
@pytest.mark.parametrize("n_window", [1, 3, 5, 50])
def test_java_moving_average_matches_reference(n_window, int_mode):
    rng = np.random.default_rng(n_window)
    sums = rng.normal(100.0, 40.0, (3, 40))
    if int_mode:
        sums = (sums * 1e6).astype(np.int64) + 2**55
    live = rng.random((3, 40)) < 0.7
    ref = np.asarray(jagg.java_moving_average(sums, live, n_window,
                                              int_mode))
    port = tagg.java_moving_average(t(sums), t(live), n_window, int_mode)
    if int_mode:
        assert_exact(port.numpy(), ref)
    else:
        assert_values(port.numpy(), ref)


@pytest.mark.parametrize("int_mode", [False, True])
def test_moving_average_runs(int_mode):
    """moving_average over runs of uneven length (the union position)
    is java_moving_average run by run; state never crosses a run."""
    rng = np.random.default_rng(3)
    sums = rng.normal(10.0, 4.0, 30)
    if int_mode:
        sums = (sums * 1000).astype(np.int64)
    offsets = torch.tensor([0, 4, 4, 17, 30])
    got = tagg.moving_average(t(sums), None, offsets, 3).numpy()
    for a, b in ((0, 4), (4, 17), (17, 30)):
        want = np.asarray(jagg.java_moving_average(
            sums[a:b], np.ones(b - a, bool), 3, int_mode))
        assert_values(got[a:b], want)
    with pytest.raises(ValueError):
        tagg.moving_average(t(sums), None, offsets, 0)


# -- U3 and MA at the kernels' edges ---------------------------------------
# U3 takes a group of at most 32 members by a team of 8, 16 or 32 lanes and
# a deeper one by a whole block; MA keeps a window of up to
# MA_RING_WINDOW running sums in shared memory and a longer one in device
# memory.  The plain versions the CPU runs are held to the reference at
# those edges.

EDGE_SIZES = (1, 31, 32, 33, 1013)
EDGE_N = 3
EDGE_AGGS = ["first", "last", "diff", "none", "mult", "median", "p99",
             "ep99r3", "ep75r7"]


def _edge_groups(seed: int, int_values: bool):
    """Groups of EDGE_SIZES members, rows laid out as the batch builders
    lay them (a sorted prefix, PAD_TS after): rows with no point, rows
    whose spans miss the others', timestamps repeated within a row, NaN
    values and ties; int rows near 2^53."""
    rng = np.random.default_rng(seed)
    s = sum(EDGE_SIZES)
    ts = np.full((s, EDGE_N), PAD_TS, np.int64)
    val = np.zeros((s, EDGE_N), np.int64 if int_values else np.float64)
    mask = np.zeros((s, EDGE_N), bool)
    for i in range(s):
        k = 0 if i % 7 == 3 else int(rng.integers(1, EDGE_N + 1))
        base = T0 + (50_000_000 * (i + 1) if i % 5 == 2 else 0)
        ts[i, :k] = np.sort(rng.choice(60, size=k, replace=True)) * 1000 + base
        mask[i, :k] = True
        if int_values:
            val[i, :k] = rng.integers(-40, 40, k) + 2**53
        else:
            v = np.round(rng.normal(50.0, 20.0, k) / 8.0) * 8.0
            v[rng.random(k) < 0.1] = np.nan
            val[i, :k] = v
    return ts, val, mask, np.repeat(np.arange(len(EDGE_SIZES)), EDGE_SIZES)


@pytest.mark.parametrize("int_mode", [False, True])
@pytest.mark.parametrize("agg", EDGE_AGGS)
def test_union_order_edge_groups_match_reference(agg, int_mode):
    """Every group at once through the port, each group alone (eagerly,
    as test_union_order_and_ma_int_mode_match_reference explains) through
    union_aggregate; int mode exact."""
    ts, val, mask, gid = _edge_groups(61, int_mode)
    agg_ = jagg.get_agg(agg)
    pu, pout, puoff = tua.union_aggregate(
        t(ts), t(val), t(mask), tga.group_offsets(gid, len(EDGE_SIZES)), agg,
        agg_.interpolation)
    for g in range(len(EDGE_SIZES)):
        rows = gid == g
        ru, rout, rmask = (np.asarray(x) for x in jua.union_aggregate(
            ts[rows], val[rows], mask[rows], agg_, int_mode))
        assert_exact(pu[puoff[g]:puoff[g + 1]].numpy(), ru[rmask])
        if int_mode:
            assert_exact(pout[puoff[g]:puoff[g + 1]].numpy(), rout[rmask])
        else:
            assert_values(pout[puoff[g]:puoff[g + 1]].numpy(), rout[rmask])


def _edge_runs(int_mode: bool):
    """Runs of 3 (shorter than most windows), 0, 40 dead, 1,700 and 9
    slots, one in five dead; int64 sums that wrap."""
    rng = np.random.default_rng(71)
    offsets = np.array([0, 3, 3, 43, 1743, 1752], np.int64)
    sums = rng.normal(100.0, 40.0, offsets[-1])
    if int_mode:
        sums = (sums * 1e6).astype(np.int64) + 2**62 + 2**61
    live = rng.random(offsets[-1]) >= 0.2
    live[3:43] = False
    return sums, live, offsets


@pytest.mark.parametrize("int_mode", [False, True])
@pytest.mark.parametrize("n_window", [1, 5, tagg.MA_RING_WINDOW + 32])
def test_moving_average_edge_runs_match_reference(n_window, int_mode):
    sums, live, offsets = _edge_runs(int_mode)
    got = tagg.moving_average(t(sums), t(live), t(offsets), n_window).numpy()
    for a, b in zip(offsets[:-1], offsets[1:]):
        if a == b:
            continue                            # the empty run
        want = np.asarray(jagg.java_moving_average(sums[a:b], live[a:b],
                                                   n_window, int_mode))
        if int_mode:
            assert_exact(got[a:b], want)
        else:
            assert_values(got[a:b], want)
    assert not got[3:43].any()                  # dead slots hold 0


@pytest.mark.parametrize("n_window", [1, 5, tagg.MA_RING_WINDOW + 32])
def test_moving_average_cancellation_is_the_ordered_chain(n_window):
    """-1e15, then small values (ROADMAP queue C): the port's window sums
    are differences of running sums taken in slot order from 0, bit for
    bit; the reference's running sums are taken in another order, and
    both quantise at the large sum's ulp."""
    rng = np.random.default_rng(72)
    sums = np.concatenate([[-1e15], rng.normal(3.0, 1.0, 2000)])
    live = rng.random(sums.size) >= 0.2
    live[0] = True
    got = tagg.moving_average(t(sums), t(live),
                              torch.tensor([0, sums.size]), n_window).numpy()
    pre, want = [0.0], np.zeros(sums.size)
    for i in np.flatnonzero(live):
        k = len(pre) - 1
        if k >= n_window:
            want[i] = (pre[k] - pre[k - n_window]) / n_window
        pre.append(pre[-1] + sums[i])
    assert_exact(got, want)
    ref = np.asarray(jagg.java_moving_average(sums, live, n_window, False))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=64 * np.spacing(1e15) / n_window)


@pytest.mark.parametrize("agg,policy", [("p99", "max"), ("ep99r7", "max"),
                                        ("dev", "lerp")])
def test_union_int_results_past_the_long_range_saturate(agg, policy):
    """A float64 result past the long range (a percentile over
    MAX_IF_MISSING's Long.MAX_VALUE, a dev of values 2^64 apart) is the
    range's end in int mode, as Java's (long) cast, the reference and the
    card give (torch's conversion on the CPU gave Long.MIN_VALUE)."""
    big = np.iinfo(np.int64).max
    if agg == "dev":
        ts = np.array([[1000, 2000], [1000, 2000]], np.int64)
        val = np.array([[-big - 1, 5], [big, 9]], np.int64)
    else:
        ts = np.array([[1000, 3000], [2000, PAD_TS], [1000, 3000]], np.int64)
        val = np.array([[5, 6], [7, 0], [8, 9]], np.int64)
    mask = ts != PAD_TS
    _, pout, _ = tua.union_aggregate(t(ts), t(val), t(mask),
                                     torch.tensor([0, len(ts)]), agg, policy)
    _, rout, rmask = (np.asarray(x) for x in jua.union_aggregate(
        ts, val, mask, Aggregator(agg, policy, jagg.get_agg(agg).reduce),
        True))
    assert_exact(pout.numpy(), rout[rmask])
    assert pout[0 if agg == "dev" else 1] == big
