"""Windowed downsampling of a [series, time] batch: kernels K1 and K4.

Port of opentsdb_tpu/ops/downsample.py (OpenTSDB Downsampler.java
ValuesInInterval :292, interval start as the output timestamp,
epoch-aligned windows; FillingDownsampler.java for the fill policies).
Downsampled values are always float64 (Downsampler.java:257).

The host plans the windows (``FixedWindows``, ``EdgeWindows``,
``AllWindow``) as one int64 edge vector e[W+1] holding exactly the query's
windows: window w spans [e[w], e[w+1]), and its timestamp is e[w].
``downsample`` dispatches by the function's family:

* moments: ``window_moments`` (K1, csrc/window_moments.cu) reduces each
  window's run of the time-sorted row and applies the fill policy;
* order and rank functions: ``window_order`` (K4, csrc/window_order.cu),
  first, last, diff, mult, the median and the percentiles, then the fill;
* movingAverage<N>: K1 ``sum``, then the Java window loop across each
  series' data-bearing windows (aggregators.moving_average, kernel MA),
  then the fill.

``window_moments_plain`` and ``window_order_plain`` are the kernels' plain
PyTorch versions.

Both kernels also take a stacked batch (the dispatch batcher's, B14): Q
members' [S, N] batches as one [Q*S, N] batch with edges [Q, W+1], one row
of window edges a member (each panel has its own range).  Row r reads the
edges of member r // S; a solo call is one member, so a member's cells
equal its solo call's bit for bit.

And both take a batch of int32 timestamp offsets (B10): the device
cache's gather re-bases a hit's timestamps on the query's first window
(``precompact_base``, the reference's :498) when the fixed grid spans
less than 2^31 ms, pads at ``I32_PAD_TS``, and ``downsample`` re-bases the
[W+1] edges alike (``compact_edges``, the reference's ``_compact_ts``,
:515-534).  Both kernels search the rows only at window edges, so the
int32 form finds the same runs and gives the int64 form's cells bit for
bit.  A stacked batch stays int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.aggregators import (
    MOMENT_CODES, ORDER_AGGS, ma_window, moving_average_rows, order_args)
from opentsdb_tpu_torch.ops.percentile import (
    parse_percentile_name, row_run_percentile)

# The int32 form's sentinels, the reference's _I32_PAD and _I32_BIG
# (:256, :261): the pad of a re-based batch, past every re-based edge, and
# the clip of an edge.
I32_PAD_TS = 2**31 - 2
I32_BIG = 2**31 - 2

# Fill policies (FillPolicy.java:22-27).
FILL_NONE = "none"
FILL_ZERO = "zero"
FILL_NAN = "nan"
FILL_NULL = "null"     # NaN internally; serializer emits nulls
FILL_SCALAR = "scalar"


@dataclass(frozen=True)
class FixedWindows:
    """Host plan: epoch-aligned fixed-interval windows over [start, end]."""
    interval_ms: int
    first_window_ms: int
    count: int

    @staticmethod
    def for_range(start_ms: int, end_ms: int, interval_ms: int) -> "FixedWindows":
        first = start_ms - (start_ms % interval_ms)
        last = end_ms - (end_ms % interval_ms)
        count = int((last - first) // interval_ms) + 1
        return FixedWindows(interval_ms, first, count)

    def window_edges(self, device) -> torch.Tensor:
        """The int64 edges[W+1] of the windows, on `device`."""
        edges = self.first_window_ms + np.arange(
            self.count + 1, dtype=np.int64) * self.interval_ms
        return torch.from_numpy(edges).to(device)


@dataclass(frozen=True)
class EdgeWindows:
    """Host plan: calendar windows from precomputed edges[W+1]."""
    edges: tuple  # ints; window w spans [edges[w], edges[w+1])

    @property
    def count(self) -> int:
        return len(self.edges) - 1

    def window_edges(self, device) -> torch.Tensor:
        """The int64 edges[W+1] of the windows, on `device`."""
        return torch.tensor(self.edges, dtype=torch.int64, device=device)


@dataclass(frozen=True)
class AllWindow:
    """Host plan: the "0all" run-all window spanning [query_start, query_end)."""
    query_start_ms: int
    query_end_ms: int

    @property
    def count(self) -> int:
        return 1

    def window_edges(self, device) -> torch.Tensor:
        """The int64 edges[2] of the one window, on `device`."""
        return torch.tensor([self.query_start_ms, self.query_end_ms],
                            dtype=torch.int64, device=device)


def precompact_base(windows, first_window_ms) -> int | None:
    """The int32 base of a batch source (the reference's :498), or None:
    the first window's ms when `windows` is a fixed grid that spans less
    than 2^31 - 2 ms, so that a batch's timestamps can travel as int32
    offsets from it.  The span is (count + 1) * interval over the
    reference's padded window count (the least power of two of at least 8
    not below the count), so that the two packages compact alike.
    Calendar and "0all" grids keep int64."""
    if not isinstance(windows, FixedWindows) or first_window_ms is None:
        return None
    padded = 8
    while padded < windows.count:
        padded *= 2
    if (padded + 1) * windows.interval_ms < 2**31 - 2:
        return int(first_window_ms)
    return None


def compact_edges(edges: torch.Tensor, ts_base: int) -> torch.Tensor:
    """Int64 edges re-based on `ts_base` as int32, clipped to +-I32_BIG
    (the reference's _compact_ts over a pre-compacted batch): an edge of
    another grid saturates and drops points, it never wraps."""
    return (edges - int(ts_base)).clamp(-I32_BIG, I32_BIG).to(torch.int32)


def window_timestamps(edges: torch.Tensor) -> torch.Tensor:
    """Representative (start-of-interval) timestamp per window: [W] of
    edges [W+1], or [Q, W] of a stacked batch's edges [Q, W+1] (a
    contiguous copy: K2 reads it as rows)."""
    return edges[..., :-1].contiguous()


def fill_args(fill_policy: str, fill_value: float) -> tuple[int, float]:
    """(fill_mode, value) as the kernels take them: mode 0 keeps empty
    windows masked (FILL_NONE), mode 1 exposes every window, the empty
    ones holding `value`."""
    if fill_policy == FILL_NONE:
        return 0, float("nan")
    if fill_policy == FILL_ZERO:
        return 1, 0.0
    if fill_policy in (FILL_NAN, FILL_NULL):
        return 1, float("nan")
    if fill_policy == FILL_SCALAR:
        return 1, float(fill_value)
    raise ValueError("Unrecognized fill policy: " + fill_policy)


def check_batch(ts, val, mask, edges, stacked: bool = False) -> int:
    """Check a windowed kernel's inputs; the rows a member.  With `stacked`
    the edges may also be [Q, W+1], one row a member of S // Q rows.  ts
    is int64 ms, or int32 offsets with int32 edges (never stacked)."""
    if ts.dim() != 2 or val.shape != ts.shape or mask.shape != ts.shape:
        raise ValueError("ts, val and mask must share one [S, N] shape")
    if ts.dtype not in (torch.int64, torch.int32) \
            or mask.dtype != torch.bool \
            or val.dtype not in (torch.float64, torch.int64):
        raise TypeError("the windowed kernels take ts int64 or int32, val "
                        "float64 or int64, mask bool")
    dims = (1, 2) if stacked and ts.dtype == torch.int64 else (1,)
    if edges.dim() not in dims or edges.dtype != ts.dtype \
            or edges.shape[-1] < 2:
        raise ValueError("edges must be [W+1]%s with W >= 1, of the "
                         "timestamps' type (int32 offsets take int32 "
                         "edges; a stacked batch is int64)"
                         % (" or [Q, W+1]" if len(dims) == 2 else ""))
    if edges.dim() == 1:
        return ts.shape[0]
    q = edges.shape[0]
    if q < 1 or ts.shape[0] % q:
        raise ValueError("a stacked batch holds S = Q x rows a member: "
                         "%d rows for %d members" % (ts.shape[0], q))
    return ts.shape[0] // q


def row_boundaries(bounds: torch.Tensor, s: int) -> torch.Tensor:
    """A plain version's view of 1-D bounds [K] as they are, or of a
    stacked batch's [Q, K] as each of its s rows' own [s, K] row."""
    if bounds.dim() == 1:
        return bounds
    return bounds.repeat_interleave(s // bounds.shape[0], dim=0)


# shape: ts[S,N] i64|i32, val[S,N] f64|i64, mask[S,N] bool,
# shape: edges[W+1] i64|i32 -> ([S,W] f64, [S,W] bool)
def window_moments(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                   edges: torch.Tensor, agg_name: str,
                   fill_policy: str = FILL_NONE, fill_value: float = 0.0):
    """K1: per-(series, window) `agg_name` over time-sorted rows, then the
    fill policy -> (values[S, W] f64, mask[S, W] bool).

    Slots that are masked or NaN do not participate.  Under FILL_NONE a
    window holding no data is masked out (value NaN); other policies
    expose every window with the fill value in empty ones.  `edges` is
    [W+1], or [Q, W+1] for a stacked batch of Q members (S % Q == 0).
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if agg_name not in MOMENT_CODES:
        raise KeyError("window_moments computes the moments, not %r"
                       % agg_name)
    rows = check_batch(ts, val, mask, edges, stacked=True)
    if ts.device.type == "cpu":
        return window_moments_plain(ts, val, mask, edges, agg_name,
                                    fill_policy, fill_value)
    dev = kernels.require_cuda(ts, val, mask, edges)
    s, n = ts.shape
    w = edges.shape[-1] - 1
    mode, fv = fill_args(fill_policy, fill_value)
    out = torch.empty((s, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, w), dtype=torch.bool, device=dev)
    if s == 0:
        return out, out_mask
    i32 = ts.dtype == torch.int32
    kernels.launch(
        "window_moments", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), s, n, w, rows,
        MOMENT_CODES[agg_name], mode, fv, int(val.dtype == torch.int64),
        int(i32), kernels.ptr(out), kernels.ptr(out_mask), stacked=rows < s,
        i32=i32)
    return out, out_mask


def window_moments_plain(ts: torch.Tensor, val: torch.Tensor,
                         mask: torch.Tensor, edges: torch.Tensor,
                         agg_name: str, fill_policy: str = FILL_NONE,
                         fill_value: float = 0.0):
    """Plain PyTorch version of K1: window ids by searchsorted, then
    per-cell reductions by index_add_ / scatter_reduce_.  Runs on any
    device; the CPU path and the tests use it, and the chip check holds
    the kernel against it."""
    s, n = ts.shape
    w = edges.shape[-1] - 1
    dev = ts.device
    vf = val.to(torch.float64)
    win = torch.searchsorted(row_boundaries(edges, s), ts, right=True) - 1
    ok = mask & ~torch.isnan(vf) & (win >= 0) & (win < w)
    rows = torch.arange(s, dtype=torch.int64, device=dev)[:, None]
    cell = torch.where(ok, rows * w + win, s * w).reshape(-1)
    okf = ok.reshape(-1)
    v0 = torch.where(okf, vf.reshape(-1), 0.0)

    def cellsum(x):
        acc = torch.zeros(s * w + 1, dtype=torch.float64, device=dev)
        return acc.index_add_(0, cell, x)[:-1].reshape(s, w)

    count = cellsum(okf.to(torch.float64))
    safe = count.clamp(min=1)
    if agg_name in ("sum", "zimsum", "pfsum"):
        out = cellsum(v0)
    elif agg_name == "count":
        out = count.clone()
    elif agg_name == "avg":
        out = cellsum(v0) / safe
    elif agg_name == "squareSum":
        out = cellsum(v0 * v0)
    elif agg_name == "dev":
        mean = torch.cat([(cellsum(v0) / safe).reshape(-1),
                          torch.zeros(1, dtype=torch.float64, device=dev)])
        centered = torch.where(okf, vf.reshape(-1) - mean[cell], 0.0)
        m2 = cellsum(centered * centered)
        out = torch.where(count >= 2, torch.sqrt(m2 / (count - 1).clamp(min=1)),
                          0.0)
    elif agg_name in ("min", "mimmin", "max", "mimmax"):
        is_min = agg_name in ("min", "mimmin")
        ident = torch.inf if is_min else -torch.inf
        acc = torch.full((s * w + 1,), ident, dtype=torch.float64, device=dev)
        src = torch.where(okf, vf.reshape(-1), ident)
        out = acc.scatter_reduce_(0, cell, src, "amin" if is_min else "amax",
                                  include_self=True)[:-1].reshape(s, w)
    else:
        raise KeyError("window_moments computes the moments, not %r"
                       % agg_name)
    return apply_fill(out, count > 0, fill_policy, fill_value)


# shape: ts[S,N] i64|i32, val[S,N] f64|i64, mask[S,N] bool,
# shape: edges[W+1] i64|i32 -> ([S,W] f64, [S,W] bool)
def window_order(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                 edges: torch.Tensor, agg_name: str,
                 fill_policy: str = FILL_NONE, fill_value: float = 0.0):
    """K4: per-(series, window) order or rank function `agg_name` (first,
    last, diff, mult, median, a percentile) over time-sorted rows, then
    the fill policy -> (values[S, W] f64, mask[S, W] bool), under the
    masking and fill rules of window_moments, `edges` [W+1] or a stacked
    batch's [Q, W+1] as window_moments takes them.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if agg_name not in ORDER_AGGS or agg_name == "none":
        raise KeyError("No such downsampling function: " + agg_name)
    rows = check_batch(ts, val, mask, edges, stacked=True)
    if ts.device.type == "cpu":
        return window_order_plain(ts, val, mask, edges, agg_name,
                                  fill_policy, fill_value)
    dev = kernels.require_cuda(ts, val, mask, edges)
    s, n = ts.shape
    w = edges.shape[-1] - 1
    mode, fv = fill_args(fill_policy, fill_value)
    code, q, est = order_args(agg_name)
    out = torch.empty((s, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, w), dtype=torch.bool, device=dev)
    if s == 0:
        return out, out_mask
    i32 = ts.dtype == torch.int32
    kernels.launch(
        "window_order", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), s, n, w, rows, code, q, est,
        mode, fv, int(val.dtype == torch.int64), int(i32), kernels.ptr(out),
        kernels.ptr(out_mask), stacked=rows < s, i32=i32)
    return out, out_mask


def window_order_plain(ts: torch.Tensor, val: torch.Tensor,
                       mask: torch.Tensor, edges: torch.Tensor,
                       agg_name: str, fill_policy: str = FILL_NONE,
                       fill_value: float = 0.0):
    """Plain PyTorch version of K4, the reference's algorithm: window ids
    by searchsorted; first/last by the least and greatest position of a
    cell, mult by scatter_reduce_; median and percentiles over each row
    sorted by (window, value) (two stable sorts) with each cell's run
    from the count grid."""
    s, n = ts.shape
    w = edges.shape[-1] - 1
    dev = ts.device
    if n == 0:
        return apply_fill(torch.full((s, w), torch.nan, dtype=torch.float64,
                                     device=dev),
                          torch.zeros((s, w), dtype=torch.bool, device=dev),
                          fill_policy, fill_value)
    vf = val.to(torch.float64)
    win = torch.searchsorted(row_boundaries(edges, s), ts, right=True) - 1
    ok = mask & ~torch.isnan(vf) & (win >= 0) & (win < w)
    rows = torch.arange(s, dtype=torch.int64, device=dev)[:, None]
    cell = torch.where(ok, rows * w + win, s * w).reshape(-1)
    count = torch.zeros(s * w + 1, dtype=torch.int64, device=dev).index_add_(
        0, cell, ok.reshape(-1).to(torch.int64))[:-1].reshape(s, w)
    flat = vf.reshape(-1)

    def cellreduce(src, how, ident):
        acc = torch.full((s * w + 1,), ident, dtype=src.dtype, device=dev)
        return acc.scatter_reduce_(0, cell, src, how,
                                   include_self=True)[:-1].reshape(s, w)

    if agg_name == "mult":
        out = cellreduce(torch.where(ok.reshape(-1), flat, 1.0), "prod", 1.0)
    elif agg_name in ("first", "last", "diff"):
        pos = torch.arange(s * n, dtype=torch.int64, device=dev)
        okf = ok.reshape(-1)
        first_i = cellreduce(torch.where(okf, pos, s * n), "amin", s * n)
        last_i = cellreduce(torch.where(okf, pos, -1), "amax", -1)
        first = flat[first_i.clamp(0, s * n - 1)]
        last = flat[last_i.clamp(0, s * n - 1)]
        if agg_name == "first":
            out = first
        elif agg_name == "last":
            out = last
        else:
            out = torch.where(count >= 2, last - first, 0.0)
    else:
        # each row by (window, value): the values first, then a stable
        # sort by window; slots that take no part go past every window
        by_val = torch.sort(torch.where(ok, vf, torch.inf), dim=1,
                            stable=True).indices
        wkey = torch.gather(torch.where(ok, win, w), 1, by_val)
        order = torch.gather(by_val, 1, torch.sort(wkey, dim=1,
                                                   stable=True).indices)
        sorted_rows = torch.gather(vf, 1, order)
        starts = torch.cumsum(count, dim=1) - count
        if agg_name == "median":
            idx = (starts + count // 2).clamp(0, n - 1)
            out = torch.gather(sorted_rows, 1, idx)
        else:
            q, est = parse_percentile_name(agg_name)
            out = row_run_percentile(sorted_rows, starts, count, q, est)
    return apply_fill(out, count > 0, fill_policy, fill_value)


def apply_fill(out: torch.Tensor, out_mask: torch.Tensor, fill_policy: str,
               fill_value: float):
    """Fill empty windows per FillPolicy (FillingDownsampler semantics).

    `out_mask` marks windows holding data.  Under FILL_NONE empty windows
    stay masked out (NaN); other policies substitute the fill value and
    expose every window.
    """
    mode, fv = fill_args(fill_policy, fill_value)
    out = torch.where(out_mask, out, fv)
    if mode == 0:
        return out, out_mask
    return out, torch.ones_like(out_mask)


# shape: ts[S,N] i64|i32, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64
# shape: -> ([W] i64, [S,W] f64, [S,W] bool); stacked: edges[Q,W+1] i64
# shape: -> ([Q,W] i64, [S,W] f64, [S,W] bool)
def downsample(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
               agg_name: str, edges: torch.Tensor,
               fill_policy: str = FILL_NONE, fill_value: float = 0.0,
               ts_base: int | None = None):
    """Downsample a [S, N] batch over the windows of `edges`[W+1] ->
    (window_ts[W], values[S, W], mask[S, W]), as
    opentsdb_tpu.ops.downsample.downsample does: K1 for a moment, K4 for
    an order or rank function, and for movingAverage<N> K1's window sums
    then MA across each series' data-bearing windows (:1121-1136), the
    fill applied to MA's output over the sums' mask.  An int32 `ts` holds
    offsets from `ts_base`: the kernels search edges re-based alike
    (compact_edges), and the window timestamps stay the int64 edges'."""
    k_edges = edges
    if ts.dtype == torch.int32:
        if ts_base is None:
            raise ValueError("int32 timestamp offsets need their ts_base")
        k_edges = compact_edges(edges, ts_base)
    nw = ma_window(agg_name)
    if nw is not None:
        sums, sum_mask = window_moments(ts, val, mask, k_edges, "sum")
        out = moving_average_rows(sums, sum_mask, nw)
        out, out_mask = apply_fill(out, sum_mask, fill_policy, fill_value)
    elif agg_name in MOMENT_CODES:
        out, out_mask = window_moments(ts, val, mask, k_edges, agg_name,
                                       fill_policy, fill_value)
    else:
        out, out_mask = window_order(ts, val, mask, k_edges, agg_name,
                                     fill_policy, fill_value)
    return window_timestamps(edges), out, out_mask
