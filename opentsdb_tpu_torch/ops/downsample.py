"""Windowed downsampling of a [series, time] batch: kernel K1.

Port of opentsdb_tpu/ops/downsample.py for the moment family (OpenTSDB
Downsampler.java ValuesInInterval :292, interval start as the output
timestamp, epoch-aligned windows; FillingDownsampler.java for the fill
policies).  Downsampled values are always float64 (Downsampler.java:257).

The host plans the windows (``FixedWindows``, ``EdgeWindows``,
``AllWindow``) as one int64 edge vector e[W+1] holding exactly the query's
windows: window w spans [e[w], e[w+1]), and its timestamp is e[w].
``window_moments`` (K1, csrc/window_moments.cu) reduces each window's run
of the time-sorted row and applies the fill policy;
``window_moments_plain`` is its plain PyTorch version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.aggregators import MOMENT_CODES

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


def window_timestamps(edges: torch.Tensor) -> torch.Tensor:
    """Representative (start-of-interval) timestamp per window [W]."""
    return edges[:-1]


def _fill(fill_policy: str, fill_value: float) -> tuple[int, float]:
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


def _check_batch(ts, val, mask, edges) -> None:
    if ts.dim() != 2 or val.shape != ts.shape or mask.shape != ts.shape:
        raise ValueError("ts, val and mask must share one [S, N] shape")
    if ts.dtype != torch.int64 or mask.dtype != torch.bool \
            or val.dtype not in (torch.float64, torch.int64):
        raise TypeError("window_moments takes ts int64, val float64 or "
                        "int64, mask bool")
    if edges.dim() != 1 or edges.dtype != torch.int64 or edges.numel() < 2:
        raise ValueError("edges must be int64 [W+1] with W >= 1")


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64
# shape: -> ([S,W] f64, [S,W] bool)
def window_moments(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                   edges: torch.Tensor, agg_name: str,
                   fill_policy: str = FILL_NONE, fill_value: float = 0.0):
    """K1: per-(series, window) `agg_name` over time-sorted rows, then the
    fill policy -> (values[S, W] f64, mask[S, W] bool).

    Slots that are masked or NaN do not participate.  Under FILL_NONE a
    window holding no data is masked out (value NaN); other policies
    expose every window with the fill value in empty ones.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if agg_name not in MOMENT_CODES:
        raise NotImplementedError(
            "downsample function %r is not ported yet (ROADMAP queue B5)"
            % agg_name)
    _check_batch(ts, val, mask, edges)
    if ts.device.type == "cpu":
        return window_moments_plain(ts, val, mask, edges, agg_name,
                                    fill_policy, fill_value)
    dev = kernels.require_cuda(ts, val, mask, edges)
    s, n = ts.shape
    w = edges.numel() - 1
    mode, fv = _fill(fill_policy, fill_value)
    out = torch.empty((s, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, w), dtype=torch.bool, device=dev)
    if s == 0:
        return out, out_mask
    kernels.launch(
        "window_moments", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), s, n, w,
        MOMENT_CODES[agg_name], mode, fv, int(val.dtype == torch.int64),
        kernels.ptr(out), kernels.ptr(out_mask))
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
    w = edges.numel() - 1
    dev = ts.device
    vf = val.to(torch.float64)
    win = torch.searchsorted(edges, ts, right=True) - 1
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
        raise NotImplementedError(
            "downsample function %r is not ported yet (ROADMAP queue B5)"
            % agg_name)
    return apply_fill(out, count > 0, fill_policy, fill_value)


def apply_fill(out: torch.Tensor, out_mask: torch.Tensor, fill_policy: str,
               fill_value: float):
    """Fill empty windows per FillPolicy (FillingDownsampler semantics).

    `out_mask` marks windows holding data.  Under FILL_NONE empty windows
    stay masked out (NaN); other policies substitute the fill value and
    expose every window.
    """
    mode, fv = _fill(fill_policy, fill_value)
    out = torch.where(out_mask, out, fv)
    if mode == 0:
        return out, out_mask
    return out, torch.ones_like(out_mask)


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64
# shape: -> ([W] i64, [S,W] f64, [S,W] bool)
def downsample(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
               agg_name: str, edges: torch.Tensor,
               fill_policy: str = FILL_NONE, fill_value: float = 0.0):
    """Downsample a [S, N] batch over the windows of `edges`[W+1] ->
    (window_ts[W], values[S, W], mask[S, W]), as
    opentsdb_tpu.ops.downsample.downsample does for the moment family."""
    out, out_mask = window_moments(ts, val, mask, edges, agg_name,
                                   fill_policy, fill_value)
    return window_timestamps(edges), out, out_mask
