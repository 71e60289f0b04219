"""The query pipelines: grouped (downsample -> rate -> group reduce),
union (rate -> union merge -> union reduce) and the rollup programs.

Port of opentsdb_tpu/ops/pipeline.py: ``run_group_pipeline`` (over
``_group_pipeline``), the composition of ``run_downsample_grid``
(``_downsample_grid``) and ``run_grid_tail`` (``_grid_tail``), and
``run_union_pipeline`` (the union arm of ``_pipeline`` behind
``run_pipeline`` and ``run_union_batch_pipeline``), in the reference's
iterator-chain order
(AggregationIterator.create :253-380: Span -> Downsampler -> RateSpan ->
merge).  On the device the grouped pipeline is K1 window_moments or K4
window_order (by the downsample function's family, with MA after K1 for
movingAverage<N>), K2 grid_fill_rate, and K3 group_moments or K5
group_order (by the aggregator's family, K3 and MA for movingAverage<N>);
the union pipeline is R point_rate (under a rate), U1 union_merge, and U2
union_reduce, U3 union_order or U2 and MA by the aggregator's family.
``run_stacked_group_pipeline`` (the reference's ``_stacked_group_pipeline``,
B14) runs Q members' grouped pipelines in one launch of each kernel: the
members' batches are one [Q*S, N] batch, K1/K4 and K2 read each member's
window edges, and K3/K5 reduce over every member's groups at once.  Both
take every group of a sub query in one [S, N] batch whose groups are
contiguous row runs.  The rollup programs are ``run_lane_partials`` (L1
lane_partials, the rollup lanes' block builder and the rollup job) and
``run_group_rollup_avg_pipeline`` / ``run_rollup_avg_pipeline`` (L2
rollup_avg over a sum lane and a count lane, then the grid tail).  The batch builders run on the host and produce the
[S, N] numpy batch that the caller moves to the device; N is the longest
row's point count, shorter rows are padded at int64 max.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops.aggregators import (
    family, get_agg, ma_window, moving_average_rows, PREV)
from opentsdb_tpu_torch.ops.downsample import (
    FILL_NONE, downsample, window_timestamps)
from opentsdb_tpu_torch.ops.group_agg import (
    grid_fill_rate, group_moments, group_offsets, group_order)
from opentsdb_tpu_torch.ops.lanes import lane_partials, rollup_avg
from opentsdb_tpu_torch.ops.rate import RateOptions, point_rate
from opentsdb_tpu_torch.ops.union_agg import union_aggregate

PAD_TS = np.iinfo(np.int64).max


@dataclass(frozen=True)
class DownsampleStep:
    """Downsample config: function and fill policy (the windows travel as
    the edges passed to run_group_pipeline)."""
    function: str
    fill_policy: str = FILL_NONE
    fill_value: float = 0.0


@dataclass(frozen=True)
class PipelineSpec:
    """Description of one sub query's numeric pipeline."""
    aggregator: str
    downsample: DownsampleStep | None = None
    rate: RateOptions | None = None


def check_ported(spec: PipelineSpec) -> None:
    """Raise KeyError for an aggregator or downsample function outside the
    registry (and for "none" as a downsample function, which the reference
    refuses too): every other pipeline is computed."""
    family(spec.aggregator)
    if spec.downsample is not None:
        function = spec.downsample.function
        if function == "none":
            raise KeyError("No such downsampling function: none")
        family(function)


# shape: contrib[S,W] f64, participate[S,W] bool, present[S,W] bool
# shape: offsets[G+1] i64 -> ([G,W] f64, [G,W] bool)
def group_reduce(agg_name: str, contrib: torch.Tensor,
                 participate: torch.Tensor, present: torch.Tensor,
                 offsets: torch.Tensor):
    """The grouped cross-series reduce by the aggregator's family, as
    grid_group_aggregate picks it (group_agg.py:656-661): K3 for a moment,
    K5 for an order or rank function, and for movingAverage<N> K3's group
    sums and counts, then MA over the windows with data, NaN where none
    (moment_group_reduce :540-551)."""
    kind = family(agg_name)
    if kind == "moment":
        return group_moments(agg_name, contrib, participate, present,
                             offsets)
    if kind == "order":
        return group_order(agg_name, contrib, participate, present, offsets)
    sums, out_mask = group_moments("sum", contrib, participate, present,
                                   offsets)
    count, _ = group_moments("count", contrib, participate, present,
                             offsets)
    live = count > 0
    out = moving_average_rows(sums, live, ma_window(agg_name))
    return torch.where(live, out, torch.nan), out_mask


# shape: ts[S,N] i64|i32, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64
# shape: -> ([W] i64, [S,W] f64, [S,W] bool)
def run_downsample_grid(step: DownsampleStep, ts: torch.Tensor,
                        val: torch.Tensor, mask: torch.Tensor,
                        edges: torch.Tensor, ts_base: int | None = None):
    """The downsample alone -> (wts[W], v[S, W], m[S, W]): K1 or K4 (K1
    and MA for movingAverage<N>) with the fill, as the reference's
    ``_downsample_grid`` (:181) computes it; an int32 `ts` holds offsets
    from `ts_base` (the device cache's re-based hit).  The rollup lanes'
    edge windows and the aggregate cache's pieces come from here."""
    return downsample(ts, val, mask, step.function, edges, step.fill_policy,
                      step.fill_value, ts_base)


# shape: wts[W] i64, v[S,W] f64, m[S,W] bool, gid[S] any
# shape: -> ([W] i64, [G,W] f64, [G,W] bool)
def run_grid_tail(spec: PipelineSpec, wts: torch.Tensor, v: torch.Tensor,
                  m: torch.Tensor, gid, num_groups: int):
    """The tail on a finished [S, W] grid -> (wts[W], out[G, W],
    out_mask[G, W]): gap fill and rate (K2), then the grouped reduce (K3,
    K5, or K3 and MA), as the reference's ``_grid_tail`` (:165) computes
    it.  `gid` (host array or tensor) maps rows to groups and must be
    non-decreasing."""
    check_ported(spec)
    offsets = group_offsets(gid, num_groups).to(v.device)
    return (wts, *_tail(spec, wts, v, m, offsets))


def _tail(spec: PipelineSpec, wts: torch.Tensor, v: torch.Tensor,
          m: torch.Tensor, offsets: torch.Tensor):
    """K2, then the grouped reduce over the row `offsets`[G+1] -> (out[G,
    W], out_mask[G, W]); wts is [W] (solo) or [Q, W] (stacked)."""
    # Rates never LERP across series: a missing rate contributes the
    # previous rate value (AggregationIterator.java:744-752).
    policy = PREV if spec.rate is not None \
        else get_agg(spec.aggregator).interpolation
    contrib, participate, present = grid_fill_rate(wts, v, m, policy,
                                                   spec.rate)
    return group_reduce(spec.aggregator, contrib, participate, present,
                        offsets)


def stacked_offsets(gid, num_groups) -> torch.Tensor:
    """The row offsets[sum(G_q) + 1] (int64, on the CPU) of a stacked
    grid's groups: member q's group_offsets shifted by q*S, each member's
    groups in order after the previous member's.  Every row of a member
    must lie in one of its groups (the planner's gid does), so that the
    members' group runs meet."""
    gid = np.asarray(gid.cpu() if isinstance(gid, torch.Tensor) else gid,
                     dtype=np.int64)
    if gid.ndim != 2 or gid.shape[0] != len(num_groups):
        raise ValueError("a stacked gid is [Q, S] with a group count a "
                         "member")
    q, s = gid.shape
    parts = []
    for i in range(q):
        off = group_offsets(gid[i], int(num_groups[i])).numpy()
        if off[0] != 0 or off[-1] != s:
            raise ValueError("every row of a stacked member must lie in "
                             "one of its groups")
        parts.append(off[:-1] + i * s)
    parts.append(np.array([q * s], np.int64))
    return torch.from_numpy(np.concatenate(parts))


# shape: ts[Q*S,N] i64, val[Q*S,N] f64|i64, mask[Q*S,N] bool, gid[Q,S] any,
# shape: edges[Q,W+1] i64 -> ([Q,W] i64, [sum(G_q),W] f64, [sum(G_q),W] bool)
def stacked_group_outputs(spec: PipelineSpec, ts: torch.Tensor,
                          val: torch.Tensor, mask: torch.Tensor, gid,
                          num_groups, edges: torch.Tensor):
    """Q members' grouped pipelines in one dispatch, their outputs stacked:
    one K1 or K4 (+ MA) over the [Q*S, N] batch with each member's edges,
    one K2 with each member's window timestamps, one K3 or K5 (+ MA) over
    every member's groups.  `ts`, `val`, `mask` may also come as
    [Q, S, N]; `num_groups` holds each member's group count.  Returns
    (wts[Q, W], out[sum(G_q), W], out_mask[sum(G_q), W]), member q's
    groups after member q-1's (``split_members``)."""
    step = _require_downsample(spec, "run_stacked_group_pipeline")
    if edges.dim() != 2:
        raise ValueError("a stacked dispatch takes edges[Q, W+1]")
    if ts.dim() == 3:
        ts, val, mask = (x.reshape(-1, x.shape[-1]) for x in (ts, val, mask))
    offsets = stacked_offsets(gid, num_groups).to(ts.device)
    wts, v, m = run_downsample_grid(step, ts, val, mask, edges)
    return (wts, *_tail(spec, wts, v, m, offsets))


def split_members(outputs, num_groups) -> list:
    """Stacked outputs (tensors or arrays) -> per member (wts[W],
    out[G_q, W], out_mask[G_q, W]), each a view."""
    wts, out, out_mask = outputs
    members = []
    lo = 0
    for i, g in enumerate(num_groups):
        hi = lo + int(g)
        members.append((wts[i], out[lo:hi], out_mask[lo:hi]))
        lo = hi
    return members


# shape: ts[Q*S,N] i64, val[Q*S,N] f64|i64, mask[Q*S,N] bool, gid[Q,S] any,
# shape: edges[Q,W+1] i64 -> Q x ([W] i64, [G_q,W] f64, [G_q,W] bool)
def run_stacked_group_pipeline(spec: PipelineSpec, ts: torch.Tensor,
                               val: torch.Tensor, mask: torch.Tensor, gid,
                               num_groups, edges: torch.Tensor) -> list:
    """Q members' grouped pipelines in one dispatch (the reference's
    ``run_stacked_group_pipeline``, :261): ``stacked_group_outputs`` split
    per member -> Q x (wts[W], out[G_q, W], out_mask[G_q, W]), each bit
    for bit what run_group_pipeline gives the member alone."""
    return split_members(stacked_group_outputs(spec, ts, val, mask, gid,
                                               num_groups, edges),
                         num_groups)


def _require_downsample(spec: PipelineSpec, name: str) -> DownsampleStep:
    check_ported(spec)
    if spec.downsample is None:
        raise ValueError("%s takes a spec with a downsample "
                         "(run_union_pipeline answers the others)" % name)
    return spec.downsample


# shape: ts[S,N] i64|i32, val[S,N] f64|i64, mask[S,N] bool, gid[S] any,
# shape: edges[W+1] i64 -> ([W] i64, [G,W] f64, [G,W] bool)
def run_group_pipeline(spec: PipelineSpec, ts: torch.Tensor,
                       val: torch.Tensor, mask: torch.Tensor, gid,
                       num_groups: int, edges: torch.Tensor,
                       ts_base: int | None = None):
    """Execute the grouped pipeline -> (wts[W], out[G, W], out_mask[G, W]):
    run_downsample_grid, then run_grid_tail.

    `ts`, `val`, `mask` and the window `edges` lie on the device the
    pipeline runs on (`ts` int64 ms, or int32 offsets from `ts_base`);
    `gid` (host array or tensor) maps rows to groups and must be
    non-decreasing (groups as contiguous row runs, as the planner emits
    them).
    """
    step = _require_downsample(spec, "run_group_pipeline")
    wts, v, m = run_downsample_grid(step, ts, val, mask, edges, ts_base)
    return run_grid_tail(spec, wts, v, m, gid, num_groups)


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64
# shape: -> ([S,W] f64, [S,W] i32, [S,W] f64, [S,W] f64)
def run_lane_partials(ts: torch.Tensor, val: torch.Tensor,
                      mask: torch.Tensor, edges: torch.Tensor):
    """One lane-partials dispatch (L1) -> (sum, count, min, max) [S, W]:
    the rollup-lane block builder and the rollup job (the reference's
    ``run_lane_partials``, :190)."""
    return lane_partials(ts, val, mask, edges)


# shape: ts_s[S,Ns] i64, val_s[S,Ns] f64|i64, mask_s[S,Ns] bool,
# shape: ts_c[S,Nc] i64, val_c[S,Nc] f64|i64, mask_c[S,Nc] bool, gid[S] any,
# shape: edges[W+1] i64 -> ([W] i64, [G,W] f64, [G,W] bool)
def run_group_rollup_avg_pipeline(spec: PipelineSpec, ts_s, val_s, mask_s,
                                  ts_c, val_c, mask_c, gid,
                                  num_groups: int, edges: torch.Tensor):
    """The grouped rollup-avg read (the reference's ``_group_rollup_avg``,
    :299) -> (wts[W], out[G, W], out_mask[G, W]): L2 divides each window's
    sum-lane sum by its count-lane sum and fills, then run_grid_tail.
    Row i of the sum batch and of the count batch is the same series."""
    step = _require_downsample(spec, "run_group_rollup_avg_pipeline")
    v, m = rollup_avg(ts_s, val_s, mask_s, ts_c, val_c, mask_c, edges,
                      step.fill_policy, step.fill_value)
    return run_grid_tail(spec, window_timestamps(edges), v, m, gid,
                         num_groups)


# shape: ts_s[S,Ns] i64, val_s[S,Ns] f64|i64, mask_s[S,Ns] bool,
# shape: ts_c[S,Nc] i64, val_c[S,Nc] f64|i64, mask_c[S,Nc] bool,
# shape: edges[W+1] i64 -> ([W] i64, [W] f64, [W] bool)
def run_rollup_avg_pipeline(spec: PipelineSpec, ts_s, val_s, mask_s, ts_c,
                            val_c, mask_c, edges: torch.Tensor):
    """The rollup-avg read of one group (the reference's
    ``_rollup_avg_pipeline``, :109): every row of the batch in one group
    -> (wts[W], out[W], out_mask[W])."""
    gid = torch.zeros(ts_s.shape[0], dtype=torch.int64)
    wts, out, out_mask = run_group_rollup_avg_pipeline(
        spec, ts_s, val_s, mask_s, ts_c, val_c, mask_c, gid, 1, edges)
    return wts, out[0], out_mask[0]


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, offsets[G+1] i64
# shape: -> ([U] i64, [U] f64|i64, [G+1] i64)
def run_union_pipeline(spec: PipelineSpec, ts: torch.Tensor,
                       val: torch.Tensor, mask: torch.Tensor,
                       offsets: torch.Tensor, int_mode: bool):
    """Execute the union pipeline -> (u[U], out[U], uoff[G + 1]): group g's
    answer is out[uoff[g]:uoff[g+1]] at timestamps u[uoff[g]:uoff[g+1]].

    Every row's valid points form a time-sorted prefix (as build_batch
    lays them out) and group g is rows [offsets[g], offsets[g+1]), all on
    the device the pipeline runs on.  `int_mode` (every group of the batch
    all-integer, int64 `val`) keeps Java long arithmetic: the union values
    are int64 without a rate, and a rate takes long differences.
    """
    check_ported(spec)
    if spec.downsample is not None:
        raise ValueError("run_union_pipeline takes a spec without a "
                         "downsample")
    if int_mode and val.dtype != torch.int64:
        raise TypeError("int mode takes int64 values")
    if not int_mode:
        val = val.to(torch.float64)
    policy = get_agg(spec.aggregator).interpolation
    if spec.rate is not None:
        # a missing rate contributes the previous rate, never a LERP
        # (AggregationIterator.java:744-752); rates are float64
        policy = PREV
        ts, val, mask = point_rate(ts, val, mask, spec.rate)
    return union_aggregate(ts, val, mask, offsets, spec.aggregator, policy)


# shape: -> ([S,N] i64, [S,N] f64|i64, [S,N] bool, [] bool)
def build_batch_direct(series_list: list, start_ms: int, end_ms: int,
                       fix_duplicates: bool, min_width: int = 0):
    """Single-copy batch build: size/type from window_stats, then each
    series copies its window straight into its row under its own lock
    (Series.window_into).  Returns numpy (ts[S, N], val[S, N], mask[S, N],
    all_int), N the largest window count (at least `min_width`); `val` is
    exact int64 when every point in range is an integer, else float64.
    Rows are time-sorted and padded at int64 max."""
    stats = [s.window_stats(start_ms, end_ms, fix_duplicates)
             for s in series_list]
    s = len(series_list)
    n = max(max((c for c, _ in stats), default=0), min_width)
    all_int = s > 0 and all(isint for c, isint in stats if c)
    while True:
        ts = np.empty((s, n), dtype=np.int64)
        mask = np.empty((s, n), dtype=bool)
        val = np.empty((s, n), dtype=np.int64 if all_int else np.float64)
        retype = False
        for i, series in enumerate(series_list):
            k, ok_int = series.window_into(start_ms, end_ms,
                                           fix_duplicates, ts[i], val[i],
                                           mask[i], all_int)
            if not ok_int:
                # a float point landed in range between the sizing pass
                # and this row's fill: rebuild as float (at most once)
                retype = True
                break
            ts[i, k:] = PAD_TS
            val[i, k:] = 0
            mask[i, k:] = False
        if not retype:
            return ts, val, mask, all_int
        all_int = False


# shape: -> ([S,N] i64, [S,N] f64|i64, [S,N] bool, [] bool)
def build_batch(windows: list):
    """Pack per-series (ts, fval, ival, is_int) windows into numpy
    arrays (ts[S, N], val[S, N], mask[S, N], all_int), as build_batch_direct
    lays them out."""
    s = len(windows)
    n = max((len(w[0]) for w in windows), default=0)
    all_int = s > 0 and all(bool(np.all(w[3])) for w in windows if len(w[0]))
    ts = np.full((s, n), PAD_TS, dtype=np.int64)
    mask = np.zeros((s, n), dtype=bool)
    val = np.zeros((s, n), dtype=np.int64 if all_int else np.float64)
    for i, (t, fv, iv, _isint) in enumerate(windows):
        k = len(t)
        ts[i, :k] = t
        val[i, :k] = iv if all_int else fv
        mask[i, :k] = True
    return ts, val, mask, all_int
