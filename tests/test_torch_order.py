"""Kernels K4 (window_order), K5 (group_order), U3 (union_order) and MA
(moving_average) against the JAX package, on the CPU, where the port runs
their plain PyTorch versions.

* K4: every order and rank downsample function on fixed, calendar (edge)
  and run-all grids under every fill policy, on float rows (NaN values,
  holes, an empty row), integer rows and rows full of ties, against
  opentsdb_tpu.ops.downsample.downsample.
* K5: every order and rank aggregator against ordered_group_reduce, with
  a group of one row and an empty group, and the presence mask of
  grid_group_aggregate.
* U3: every order and rank aggregator against union_aggregate, float and
  int mode (values above 2^53), and groups of uneven size.
* MA: java_moving_average itself, and movingAverage<N> in its three
  positions: the downsample function, the grid aggregator
  (moment_group_reduce) and the union aggregator (union_aggregate).

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
from torch_parity import assert_exact, assert_values, sorted_batch, t

DS_FUNCS = ["first", "last", "diff", "mult", "median", *PERCENTILE_AGGS]
AGGS = sorted(ORDER_AGGS)
KINDS = ["fixed", "edges", "all"]
MA_NAMES = ["movingAverage", "movingAverage1", "movingAverage3"]


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
