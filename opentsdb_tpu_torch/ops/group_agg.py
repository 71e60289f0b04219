"""Grouped cross-series aggregation on a shared downsample grid: K2, K3, K5.

Port of opentsdb_tpu/ops/group_agg.py (OpenTSDB
TsdbQuery.GroupByAndAggregateCB :981-1114 and AggregationIterator's
missing-point policies :682/:735).  All groups travel in one [S, W] grid
with a group id per row; groups are contiguous row runs (the planner emits
them that way), so the host turns gid into row offsets[G + 1]
(``group_offsets``).

* ``grid_fill_rate`` (K2, csrc/grid_fill_rate.cu): the optional rate, then
  each row's contribution and participation at every window.
* ``group_moments`` (K3, csrc/group_moments.cu): the per-(group, window)
  moment reduce and the presence mask.
* ``group_order`` (K5, csrc/group_order.cu): the per-(group, window) order
  and rank reduces (first, last, diff and none in row order, mult, the
  median, the percentiles) and the presence mask.

Each has its plain PyTorch version beside it (``grid_fill_rate_plain``,
``group_moments_plain``, ``group_order_plain``), which CPU tensors run.
"""

from __future__ import annotations

import numpy as np
import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.downsample import row_boundaries
from opentsdb_tpu_torch.ops.aggregators import (
    MOMENT_AGGS, MOMENT_CODES, ORDER_AGGS, POLICY_CODES, order_args)
from opentsdb_tpu_torch.ops.percentile import (
    column_run_percentile, parse_percentile_name)
from opentsdb_tpu_torch.ops.rate import (
    RateOptions, rate, prev_valid_index, next_valid_index)
from opentsdb_tpu_torch.ops.union_agg import interpolate


def _check_grid(*pairs) -> None:
    for t, dtype in pairs:
        if t.dtype != dtype:
            raise TypeError("expected %s, got %s" % (dtype, t.dtype))


_GROUP_DTYPES = (torch.float64, torch.bool, torch.bool, torch.int64)


def _check_group_inputs(contrib, participate, present, offsets) -> None:
    shape = contrib.shape
    if len(shape) != 2 or participate.shape != shape \
            or present.shape != shape or offsets.dim() != 1 \
            or offsets.numel() < 1:
        raise ValueError("the group reduces take contrib, participate and "
                         "present of one [S, W] shape and offsets[G + 1]")
    if (contrib.dtype, participate.dtype, present.dtype,
            offsets.dtype) != _GROUP_DTYPES:
        _check_grid(*zip((contrib, participate, present, offsets),
                         _GROUP_DTYPES))


def _check_fill(wts, v, m, policy: str) -> int:
    """K2's argument checks; the rows a member (S for a solo grid)."""
    if policy not in POLICY_CODES:
        raise ValueError("Invalid interpolation: " + policy)
    if v.dim() != 2 or m.shape != v.shape or wts.dim() not in (1, 2) \
            or wts.shape[-1] != v.shape[1]:
        raise ValueError("grid_fill_rate takes v[S, W], m[S, W] and wts[W] "
                         "or a stacked grid's wts[Q, W]")
    rows = v.shape[0]
    if wts.dim() == 2:
        if wts.shape[0] < 1 or v.shape[0] % wts.shape[0]:
            raise ValueError("a stacked grid holds S = Q x rows a member: "
                             "%d rows for %d members"
                             % (v.shape[0], wts.shape[0]))
        rows = v.shape[0] // wts.shape[0]
    _check_grid((v, torch.float64), (m, torch.bool), (wts, torch.int64))
    return rows


def _fill_outputs(s: int, w: int, dev):
    """K2's contrib [S, W] f64, participate and present [S, W] bool,
    carved from one allocation, contrib first (8-byte aligned)."""
    cells = s * w
    buf = torch.empty(-(-10 * cells // 8) * 8, dtype=torch.bool, device=dev)
    return (buf.view(torch.float64).as_strided((s, w), (w, 1)),
            buf.as_strided((s, w), (w, 1), 8 * cells),
            buf.as_strided((s, w), (w, 1), 9 * cells))


# shape: wts[W] i64, v[S,W] f64, m[S,W] bool
# shape: -> ([S,W] f64, [S,W] bool, [S,W] bool)
def grid_fill_rate(wts: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                   policy: str, rate_options: RateOptions | None = None):
    """K2 -> (contrib[S, W] f64, participate[S, W] bool, present[S, W] bool).

    With `rate_options`, the grid first becomes per-second rates against
    each row's previous valid window (rate.rate on the grid); `present`
    is then the rate's mask, else `m`.  A window absent from `present`
    contributes the `policy` interpolation between its row's neighbouring
    present windows and participates only between the row's first and last
    present window; non-participating cells hold NaN.  A stacked grid of Q
    members (the dispatch batcher's, B14) passes wts [Q, W], each member's
    window timestamps; row r reads member r // (S // Q)'s.
    """
    rows = _check_fill(wts, v, m, policy)
    if v.device.type == "cpu":
        return grid_fill_rate_plain(wts, v, m, policy, rate_options)
    dev = kernels.require_cuda(wts, v, m)
    s, w = v.shape
    contrib, participate, present = _fill_outputs(s, w, dev)
    if s == 0 or w == 0:
        return contrib, participate, present
    ro = rate_options or RateOptions()
    kernels.launch(
        "grid_fill_rate", dev, kernels.ptr(v), kernels.ptr(m),
        kernels.ptr(wts), s, w, rows, int(rate_options is not None),
        int(ro.counter), int(ro.drop_resets), float(ro.counter_max),
        float(ro.reset_value), POLICY_CODES[policy], kernels.ptr(contrib),
        kernels.ptr(participate), kernels.ptr(present), stacked=rows < s)
    return contrib, participate, present


def grid_fill_rate_plain(wts: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                         policy: str, rate_options: RateOptions | None = None):
    """Plain PyTorch version of K2: rate.rate, then the gap values from
    the previous/next present index of every cell."""
    s, w = v.shape
    row_wts = row_boundaries(wts, s).expand(s, w)
    if rate_options is not None:
        v, m = rate(row_wts, v, m, rate_options)
    prev_i = prev_valid_index(m)
    next_i = next_valid_index(m)
    participate = ((prev_i >= 0) & (next_i < w)) | m
    safe_prev = prev_i.clamp(0, w - 1)
    safe_next = next_i.clamp(0, w - 1)
    interp = interpolate(policy, False, row_wts,
                         torch.gather(row_wts, 1, safe_prev),
                         torch.gather(v, 1, safe_prev),
                         torch.gather(row_wts, 1, safe_next),
                         torch.gather(v, 1, safe_next), v)
    contrib = torch.where(m, v, torch.where(participate, interp, torch.nan))
    return contrib, participate, m


def group_offsets(gid, num_groups: int) -> torch.Tensor:
    """Row offsets[G + 1] (int64, on the CPU) of non-decreasing group ids,
    the host step before K3; raises when gid decreases anywhere.  Rows
    whose gid lies outside [0, G) fall outside every run."""
    g = np.asarray(gid.cpu() if isinstance(gid, torch.Tensor) else gid,
                   dtype=np.int64)
    if g.ndim != 1:
        raise ValueError("gid must be 1-D")
    if g.size and bool(np.any(g[1:] < g[:-1])):
        raise ValueError("gid must be non-decreasing (groups as contiguous "
                         "row runs)")
    return torch.from_numpy(np.searchsorted(
        g, np.arange(num_groups + 1, dtype=np.int64), side="left"))


# shape: contrib[S,W] f64, participate[S,W] bool, present[S,W] bool
# shape: offsets[G+1] i64 -> ([G,W] f64, [G,W] bool)
def group_moments(agg_name: str, contrib: torch.Tensor,
                  participate: torch.Tensor, present: torch.Tensor,
                  offsets: torch.Tensor):
    """K3 -> (out[G, W] f64, out_mask[G, W] bool).

    Group g is rows [offsets[g], offsets[g+1]) (``group_offsets``).  Per
    (group, window): `agg_name` over the participating, non-NaN member
    cells (NaN where none participates, except for count, which gives 0);
    out_mask marks cells where some member is `present`.
    """
    if agg_name not in MOMENT_AGGS:
        raise KeyError("group_moments computes the moments, not %r"
                       % agg_name)
    _check_group_inputs(contrib, participate, present, offsets)
    if contrib.is_cpu:
        return group_moments_plain(agg_name, contrib, participate, present,
                                   offsets)
    dev = kernels.require_cuda(contrib, participate, present, offsets)
    s, w = contrib.shape
    g = offsets.numel() - 1
    out = torch.empty((g, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((g, w), dtype=torch.bool, device=dev)
    if g == 0 or w == 0:
        return out, out_mask
    kernels.launch(
        "group_moments", dev, contrib.data_ptr(), participate.data_ptr(),
        present.data_ptr(), offsets.data_ptr(), s, g, w,
        MOMENT_CODES[agg_name], out.data_ptr(), out_mask.data_ptr())
    return out, out_mask


def group_moments_plain(agg_name: str, contrib: torch.Tensor,
                        participate: torch.Tensor, present: torch.Tensor,
                        offsets: torch.Tensor):
    """Plain PyTorch version of K3: index_add_ / scatter_reduce_ of the
    member rows onto their groups, each group accumulating from zero."""
    dev = contrib.device
    w = contrib.shape[1]
    g = offsets.numel() - 1
    lo, hi = int(offsets[0]), int(offsets[-1])
    sizes = offsets[1:] - offsets[:-1]
    rows = torch.repeat_interleave(torch.arange(g, device=dev), sizes)
    x = contrib[lo:hi]
    ok = participate[lo:hi] & ~torch.isnan(x)
    v2 = torch.where(ok, x, 0.0)

    def gsum(t):
        acc = torch.zeros((g, w), dtype=torch.float64, device=dev)
        return acc.index_add_(0, rows, t)

    cnt = gsum(ok.to(torch.float64))
    safe = cnt.clamp(min=1)
    if agg_name in ("sum", "zimsum", "pfsum"):
        out = gsum(v2)
    elif agg_name == "count":
        out = cnt.clone()
    elif agg_name == "avg":
        out = gsum(v2) / safe
    elif agg_name == "squareSum":
        out = gsum(v2 * v2)
    elif agg_name == "dev":
        mean = gsum(v2) / safe
        centered = torch.where(ok, x - mean[rows], 0.0)
        m2 = gsum(centered * centered)
        out = torch.where(cnt >= 2, torch.sqrt(m2 / (cnt - 1).clamp(min=1)),
                          0.0)
    else:
        is_min = agg_name in ("min", "mimmin")
        ident = torch.inf if is_min else -torch.inf
        acc = torch.full((g, w), ident, dtype=torch.float64, device=dev)
        out = acc.scatter_reduce_(
            0, rows[:, None].expand(-1, w), torch.where(ok, x, ident),
            "amin" if is_min else "amax", include_self=True)
    if agg_name != "count":
        out = torch.where(cnt > 0, out, torch.nan)
    out_mask = gsum(present[lo:hi].to(torch.float64)) > 0
    return out, out_mask


# shape: contrib[S,W] f64, participate[S,W] bool, present[S,W] bool
# shape: offsets[G+1] i64 -> ([G,W] f64, [G,W] bool)
def group_order(agg_name: str, contrib: torch.Tensor,
                participate: torch.Tensor, present: torch.Tensor,
                offsets: torch.Tensor):
    """K5 -> (out[G, W] f64, out_mask[G, W] bool).

    Per (group, window): the order or rank function `agg_name` over the
    participating, non-NaN member cells, first/last/diff/none in row order
    (the order series entered the group); NaN where none participates;
    out_mask marks cells where some member is `present`.
    """
    if agg_name not in ORDER_AGGS:
        raise KeyError("group_order computes the order and rank functions, "
                       "not %r" % agg_name)
    _check_group_inputs(contrib, participate, present, offsets)
    if contrib.device.type == "cpu":
        return group_order_plain(agg_name, contrib, participate, present,
                                 offsets)
    dev = kernels.require_cuda(contrib, participate, present, offsets)
    w = contrib.shape[1]
    g = offsets.numel() - 1
    code, q, est = order_args(agg_name)
    out = torch.empty((g, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((g, w), dtype=torch.bool, device=dev)
    if g == 0 or w == 0:
        return out, out_mask
    kernels.launch(
        "group_order", dev, kernels.ptr(contrib), kernels.ptr(participate),
        kernels.ptr(present), kernels.ptr(offsets), contrib.shape[0], g, w,
        code, q, est, kernels.ptr(out), kernels.ptr(out_mask))
    return out, out_mask


def group_order_plain(agg_name: str, contrib: torch.Tensor,
                      participate: torch.Tensor, present: torch.Tensor,
                      offsets: torch.Tensor):
    """Plain PyTorch version of K5, the reference's algorithm: the first
    and last participating row of each cell by scatter_reduce_, mult by a
    product scatter, median and percentiles over each column sorted by
    (group, value) (two stable sorts) with each cell's run from the
    counts."""
    dev = contrib.device
    w = contrib.shape[1]
    g = offsets.numel() - 1
    lo, hi = int(offsets[0]), int(offsets[-1])
    s = hi - lo
    if s == 0:
        return (torch.full((g, w), torch.nan, dtype=torch.float64,
                           device=dev),
                torch.zeros((g, w), dtype=torch.bool, device=dev))
    sizes = offsets[1:] - offsets[:-1]
    gid = torch.repeat_interleave(torch.arange(g, device=dev), sizes)
    x = contrib[lo:hi]
    ok = participate[lo:hi] & ~torch.isnan(x)
    gidw = gid[:, None].expand(-1, w)
    cnt = torch.zeros((g, w), dtype=torch.int64, device=dev).index_add_(
        0, gid, ok.to(torch.int64))

    def greduce(src, how, ident):
        acc = torch.full((g, w), ident, dtype=src.dtype, device=dev)
        return acc.scatter_reduce_(0, gidw, src, how, include_self=True)

    if agg_name == "mult":
        out = greduce(torch.where(ok, x, 1.0), "prod", 1.0)
    elif agg_name in ("first", "last", "diff", "none"):
        rows = torch.arange(s, device=dev)[:, None].expand(-1, w)
        first_r = greduce(torch.where(ok, rows, s), "amin", s)
        last_r = greduce(torch.where(ok, rows, -1), "amax", -1)
        first = torch.gather(x, 0, first_r.clamp(0, s - 1))
        last = torch.gather(x, 0, last_r.clamp(0, s - 1))
        if agg_name in ("first", "none"):
            out = first
        elif agg_name == "last":
            out = last
        else:
            out = torch.where(cnt >= 2, last - first, 0.0)
    else:
        # each column by (group, value): the values first, then a stable
        # sort by group; cells that take no part go past every group
        by_val = torch.sort(torch.where(ok, x, torch.inf), dim=0,
                            stable=True).indices
        gkey = torch.gather(torch.where(ok, gidw, g), 0, by_val)
        order = torch.gather(by_val, 0, torch.sort(gkey, dim=0,
                                                   stable=True).indices)
        sorted_cols = torch.gather(x, 0, order)
        starts = torch.cumsum(cnt, dim=0) - cnt
        if agg_name == "median":
            idx = (starts + cnt // 2).clamp(0, s - 1)
            out = torch.gather(sorted_cols, 0, idx)
        else:
            q, est = parse_percentile_name(agg_name)
            out = column_run_percentile(sorted_cols, starts, cnt, q, est)
    out = torch.where(cnt > 0, out, torch.nan)
    out_mask = torch.zeros((g, w), dtype=torch.int64, device=dev).index_add_(
        0, gid, present[lo:hi].to(torch.int64)) > 0
    return out, out_mask
