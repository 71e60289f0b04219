"""Rate-of-change over sorted rows, with counter rollover handling.

Port of opentsdb_tpu/ops/rate.py (OpenTSDB RateSpan.populateNextRate :121
and RateOptions.java :27): per-second dv/dt between a point and the previous
valid point of its row, counter rollover diff = counter_max - prev + next,
reset_value spike suppression -> 0, drop_resets masks negative diffs.  The
rate sits at the latter point's timestamp and a row's first point yields
none.  Over all-integer rows (``all_int``) the difference is taken in Java
long arithmetic before the divide (RateSpan.java:140-147).

``rate`` is the plain PyTorch form.  On the query path the rate runs in a
kernel: over the downsampled grid inside K2 (ops.group_agg.grid_fill_rate,
csrc/grid_fill_rate.cu), and over raw rows, on the union path, in R
(``point_rate``, csrc/point_rate.cu), which also moves the surviving points
to the front of their row; ``point_rate_plain`` is its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from opentsdb_tpu_torch.ops import kernels

LONG_MAX = 2**63 - 1
PAD_TS = LONG_MAX


@dataclass(frozen=True)
class RateOptions:
    """Counter options (RateOptions.java:27-62).

    Parsing of the "rate{counter[,max[,reset]]}" URI form lives in
    models.tsquery.parse_rate_options.
    """
    counter: bool = False
    counter_max: int = LONG_MAX
    reset_value: int = 0
    drop_resets: bool = False


def prev_valid_index(mask: torch.Tensor) -> torch.Tensor:
    """prev[s, k] = largest j < k with mask[s, j], else -1 (int64)."""
    s, n = mask.shape
    pos = torch.where(mask, torch.arange(n, dtype=torch.int64,
                                         device=mask.device), -1)
    running = torch.cummax(pos, dim=1).values
    return torch.cat([torch.full((s, 1), -1, dtype=torch.int64,
                                 device=mask.device), running[:, :-1]], dim=1)


def next_valid_index(mask: torch.Tensor) -> torch.Tensor:
    """next[s, k] = smallest j > k with mask[s, j], else n (int64)."""
    n = mask.shape[1]
    return n - 1 - prev_valid_index(mask.flip(1)).flip(1)


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool
def rate(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
         options: RateOptions, all_int: bool = False):
    """Rates over a [S, N] sorted batch -> (rate[S, N] f64, mask[S, N]).

    Slot k holds the rate between point k and its previous valid point;
    it is masked off (and NaN) for first points and dropped resets.
    With `all_int` the differences are int64 (wrapping) before the divide.
    """
    n = ts.shape[1]
    prev = prev_valid_index(mask)
    has_prev = prev >= 0
    safe_prev = prev.clamp(0, n - 1)
    prev_ts = torch.gather(ts, 1, safe_prev)

    dt_sec = (ts - prev_ts).to(torch.float64) / 1000.0
    dt_sec = torch.where(dt_sec == 0, torch.inf, dt_sec)
    if all_int:
        vi = val.to(torch.int64)
        prev_i = torch.gather(vi, 1, safe_prev)
        diff = (vi - prev_i).to(torch.float64)
        rolled = (options.counter_max - prev_i + vi).to(torch.float64)
    else:
        vf = val.to(torch.float64)
        prev_val = torch.gather(vf, 1, safe_prev)
        diff = vf - prev_val
        rolled = float(options.counter_max) - prev_val + vf

    out_mask = mask & has_prev
    if options.counter:
        negative = diff < 0
        if options.drop_resets:
            out = diff / dt_sec
            out_mask = out_mask & ~negative
        else:
            roll_rate = rolled / dt_sec
            suppressed = (roll_rate > options.reset_value) \
                if options.reset_value > 0 else torch.zeros_like(negative)
            out = torch.where(negative,
                              torch.where(suppressed, 0.0, roll_rate),
                              diff / dt_sec)
    else:
        out = diff / dt_sec
    out = torch.where(out_mask, out, torch.nan)
    return out, out_mask


def _check_rows(ts, val, mask) -> None:
    if ts.dim() != 2 or val.shape != ts.shape or mask.shape != ts.shape:
        raise ValueError("ts, val and mask must share one [S, N] shape")
    if ts.dtype != torch.int64 or mask.dtype != torch.bool \
            or val.dtype not in (torch.float64, torch.int64):
        raise TypeError("point_rate takes ts int64, val float64 or int64, "
                        "mask bool")


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool
# shape: -> ([S,N] i64, [S,N] f64, [S,N] bool)
def point_rate(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
               options: RateOptions):
    """R: the rate of every row's points, with the points that carry a
    rate moved to the front of their row -> (ts[S, N], rate[S, N] f64,
    mask[S, N]).

    Row k's surviving points (valid, with a previous valid point, not a
    dropped reset) come first, in time order, with their timestamps and
    rates; the rest of the row holds PAD_TS, NaN and False.  int64 `val`
    is all-integer data: its differences are Java long differences.
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_rows(ts, val, mask)
    if ts.device.type == "cpu":
        return point_rate_plain(ts, val, mask, options)
    dev = kernels.require_cuda(ts, val, mask)
    s, n = ts.shape
    out_ts = torch.empty((s, n), dtype=torch.int64, device=dev)
    out_val = torch.empty((s, n), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, n), dtype=torch.bool, device=dev)
    if s == 0 or n == 0:
        return out_ts, out_val, out_mask
    kernels.launch(
        "point_rate", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), s, n, int(val.dtype == torch.int64),
        int(options.counter), int(options.drop_resets),
        int(options.counter_max), int(options.reset_value),
        kernels.ptr(out_ts), kernels.ptr(out_val), kernels.ptr(out_mask))
    return out_ts, out_val, out_mask


def point_rate_plain(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                     options: RateOptions):
    """Plain PyTorch version of R: ``rate``, then a stable per-row sort
    that moves the surviving points to the front (the reference's
    union_agg.compact_rows)."""
    out, out_mask = rate(ts, val, mask, options,
                         all_int=val.dtype == torch.int64)
    key = torch.where(out_mask, ts, PAD_TS)
    order = torch.argsort(key, dim=1, stable=True)
    m = torch.gather(out_mask, 1, order)
    return (torch.where(m, torch.gather(ts, 1, order), PAD_TS),
            torch.where(m, torch.gather(out, 1, order), torch.nan), m)
