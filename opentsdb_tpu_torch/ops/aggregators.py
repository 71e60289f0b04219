"""Aggregator registry, interpolation policies, the masked reduces and the
moving average: kernel MA.

Port of opentsdb_tpu/ops/aggregators.py (OpenTSDB Aggregators.java :38
Interpolation enum, registry :175-203), name for name, so that a query
names the same aggregators in both packages.  On the device the reductions
live in the kernels; ``moment_reduce`` (``_sum`` ... ``_dev``, :41-125) and
``order_reduce`` (``_mult``, ``_first_ordered``, ``_last_ordered``,
``_diff``, ``_median``, ``_none_agg`` :126-175, ``_percentile_agg`` :267)
are the plain PyTorch forms of the reference's masked reduces over the
series axis that the union path's plain versions (ops.union_agg) use and
its kernels are held to.  Every name has a family (``family``): the
moments, the order and rank functions, and the moving averages.

``moving_average`` (MA, csrc/moving_average.cu) is the Java MovingAverage
loop (``java_moving_average`` :177, its plain version) over runs of
evaluation slots, in all three of its positions: after a downsample's
window sums, after the group sums on the grid and after the union sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.percentile import (
    EST_CODES, masked_percentile, parse_percentile_name)

# Interpolation policies (Aggregators.java:38-44).
LERP = "lerp"
ZIM = "zim"     # zero if missing
MAX_IF_MISSING = "max"
MIN_IF_MISSING = "min"
PREV = "prev"

DEFAULT_MA_WINDOW = 5


@dataclass(frozen=True)
class Aggregator:
    """A named aggregation function + its missing-value interpolation policy."""
    name: str
    interpolation: str


def _make_registry() -> dict[str, Aggregator]:
    reg = {
        "sum": LERP, "pfsum": PREV, "min": LERP, "max": LERP, "avg": LERP,
        "median": LERP, "none": ZIM, "mult": LERP, "dev": LERP,
        "diff": LERP, "count": ZIM, "zimsum": ZIM,
        "mimmin": MAX_IF_MISSING, "mimmax": MIN_IF_MISSING, "first": ZIM,
        "last": ZIM, "squareSum": ZIM, "movingAverage": LERP,
    }
    reg.update(dict.fromkeys(PERCENTILE_AGGS, LERP))
    return {name: Aggregator(name, policy) for name, policy in reg.items()}


PERCENTILE_AGGS = tuple(
    name for n in ("999", "99", "95", "90", "75", "50")
    for name in ("p" + n, "ep%sr3" % n, "ep%sr7" % n))
AGGREGATORS: dict[str, Aggregator] = _make_registry()


def ma_window(name: str) -> int | None:
    """`movingAverage` family parse: bare name (DEFAULT_MA_WINDOW points)
    or `movingAverage<N>`; None when `name` is not a moving average."""
    if not name.startswith("movingAverage"):
        return None
    suffix = name[len("movingAverage"):]
    if suffix == "":
        return DEFAULT_MA_WINDOW
    if suffix.isdigit() and int(suffix) > 0:
        return int(suffix)
    return None


def get_agg(name: str) -> Aggregator:
    agg = AGGREGATORS.get(name)
    if agg is None:
        if ma_window(name) is None:
            raise KeyError("No such aggregator: " + name)
        agg = Aggregator(name, LERP)
    return agg


def is_valid_agg(name: str) -> bool:
    """Registry membership including the movingAverage<N> family."""
    return name in AGGREGATORS or ma_window(name) is not None


# The moment family, by the kernels' reduce code (`enum Agg` of
# csrc/window_moments.cu, group_moments.cu and union_reduce.cu): every
# aggregator and downsample function this port computes.
MOMENT_CODES = {
    "sum": 0, "zimsum": 0, "pfsum": 0, "count": 1, "avg": 2,
    "min": 3, "mimmin": 3, "max": 4, "mimmax": 4, "dev": 5, "squareSum": 6,
}
MOMENT_AGGS = frozenset(MOMENT_CODES)

# The order and rank family, by the kernels' `enum Order`
# (csrc/order_stats.cuh): first/last/diff/none in the run's order, the
# product, the upper median and the percentiles (code PERCENTILE, with the
# percentile and its estimator passed beside it).
ORDER_CODES = {"first": 0, "last": 1, "diff": 2, "none": 3, "mult": 4,
               "median": 5}
PERCENTILE = 6
ORDER_AGGS = frozenset(ORDER_CODES) | frozenset(PERCENTILE_AGGS)


def family(name: str) -> str:
    """"moment", "order" (order and rank functions) or "ma" (the
    movingAverage family); KeyError for a name outside the registry."""
    if name in MOMENT_AGGS:
        return "moment"
    if name in ORDER_AGGS:
        return "order"
    if ma_window(name) is not None:
        return "ma"
    raise KeyError("No such aggregator: " + name)


def order_args(name: str) -> tuple[int, float, int]:
    """(code, q, estimator code) of an order or rank function, as the
    kernels K4, K5 and U3 take them."""
    if name in ORDER_CODES:
        return ORDER_CODES[name], 0.0, 0
    q, est = parse_percentile_name(name)
    return PERCENTILE, q, EST_CODES[est]

# The longest movingAverage window whose running sums MA keeps in shared
# memory (csrc/moving_average.cu RING_N); a longer one takes a buffer in
# device memory.
MA_RING_WINDOW = 768

# Interpolation policy -> the kernels' `enum Policy` (csrc/grid_fill_rate.cu,
# union_reduce.cu).
POLICY_CODES = {LERP: 0, ZIM: 1, MAX_IF_MISSING: 2, MIN_IF_MISSING: 3,
                PREV: 4}

I64_MAX = 2**63 - 1
I64_MIN = -2**63
F64_MAX = float(np.finfo(np.float64).max)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as IEEE sqrt is in the reference and
    on the card; torch.sqrt on the CPU can be one ulp off, and an int-mode
    dev truncates the result, so one ulp can be one apart in the answer."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def java_long(x: torch.Tensor) -> torch.Tensor:
    """Java's (long) of float64 values (JLS 5.1.3): truncation toward
    zero, NaN to 0, and the long range's ends past it, as the reference's
    int64 conversion and the card's cvt give; torch's own conversion on
    the CPU turns a value past the range into Long.MIN_VALUE."""
    over = x >= 2.0**63
    under = x < -2.0**63
    out = torch.where(over | under | torch.isnan(x), 0.0, x).to(torch.int64)
    return torch.where(over, I64_MAX, torch.where(under, I64_MIN, out))


# shape: values[S,T] f64|i64, mask[S,T] bool -> [T] f64|i64
def moment_reduce(name: str, values: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Reduce over axis 0 the participating values of a moment aggregator
    (Aggregator.java runDouble/runLong): float values skip NaN and give NaN
    where nothing participates (count gives 0); int64 values keep Java long
    arithmetic, wrapping, with a truncating division for avg
    (Aggregators.java:378) and a truncated stddev for dev (:522)."""
    is_float = values.is_floating_point()
    ok = mask & ~torch.isnan(values) if is_float else mask

    def total(x):
        # in row order, as the reference and the kernels add: cumsum runs
        # along dim 0 one row after another on the CPU and on the card
        return torch.cumsum(x, dim=0)[-1]

    n = ok.sum(dim=0)
    zero = torch.zeros((), dtype=values.dtype)
    if name == "count":
        return n.to(values.dtype)
    if name in ("min", "mimmin", "max", "mimmax"):
        is_min = name in ("min", "mimmin")
        if is_float:
            ident = torch.inf if is_min else -torch.inf
        else:
            ident = I64_MAX if is_min else I64_MIN
        filled = torch.where(ok, values, torch.tensor(ident, dtype=values.dtype))
        out = filled.amin(dim=0) if is_min else filled.amax(dim=0)
    elif name in ("sum", "zimsum", "pfsum", "avg"):
        out = total(torch.where(ok, values, zero))
        if name == "avg":
            if not is_float:
                return torch.div(out, n.clamp(min=1), rounding_mode="trunc")
            out = out / n.clamp(min=1)
    elif name == "squareSum":
        sq = torch.where(ok, values, zero)
        out = total(sq * sq)
    elif name == "dev":
        vf = values.to(torch.float64)
        mean = total(torch.where(ok, vf, 0.0)) / n.clamp(min=1)
        centered = torch.where(ok, vf - mean, 0.0)
        var = total(centered * centered) / (n - 1).clamp(min=1)
        out = torch.where(n >= 2, _sqrt(var), 0.0)
        if not is_float:
            return java_long(out)           # the (long) cast truncates
    else:
        raise KeyError("aggregator %r is not a moment" % name)
    if is_float:
        out = torch.where(n > 0, out, torch.nan)
    return out


# shape: values[S,T] f64|i64, mask[S,T] bool -> [T] f64|i64
def order_reduce(name: str, values: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Reduce over axis 0 the participating values of an order or rank
    function (Aggregators.java First :810, Last, Diff :576-617, Mult,
    Median :397-431, PercentileAgg :657-708): float values skip NaN and
    give NaN where nothing participates; int64 values keep Java long
    arithmetic (mult and diff wrap), the median is the exact long, and a
    percentile is computed over the values as float64 and truncated
    (Aggregators.java:685).  first/last/diff/none take the rows in order,
    and so does mult: with an overflow to inf and a zero in one column the
    order decides between NaN and 0, and prod(dim=0) of a single column
    multiplies in vector lanes, so the product is the last row of a
    cumulative product, which the CPU takes row after row."""
    is_float = values.is_floating_point()
    ok = mask & ~torch.isnan(values) if is_float else mask
    n = ok.sum(dim=0)
    s = values.shape[0]
    if name == "mult":
        ones = torch.ones((), dtype=values.dtype)
        out = torch.cumprod(torch.where(ok, values, ones), dim=0)[-1] \
            if s else torch.ones(values.shape[1:], dtype=values.dtype,
                                 device=values.device)
    elif name in ("first", "last", "diff", "none"):
        oki = ok.to(torch.int8)
        first_i = torch.argmax(oki, dim=0)
        last_i = s - 1 - torch.argmax(oki.flip(0), dim=0)
        first = torch.gather(values, 0, first_i[None])[0]
        last = torch.gather(values, 0, last_i[None])[0]
        if name in ("first", "none"):
            out = first
        elif name == "last":
            out = last
        else:
            out = torch.where(n >= 2, last - first,
                              torch.zeros((), dtype=values.dtype))
    elif name == "median":
        big = torch.inf if is_float else I64_MAX
        srt = torch.sort(torch.where(
            ok, values, torch.tensor(big, dtype=values.dtype)), dim=0).values
        out = torch.gather(srt, 0, (n // 2).clamp(0, s - 1)[None])[0]
    elif name in PERCENTILE_AGGS:
        q, est = parse_percentile_name(name)
        out = masked_percentile(values.to(torch.float64), ok, q, est)
        if not is_float:
            return java_long(out)           # the (long) cast truncates
    else:
        raise KeyError("aggregator %r is not an order or rank function"
                       % name)
    if is_float:
        out = torch.where(n > 0, out, torch.nan)
    return out


# shape: sums[R,T] f64|i64, live[R,T] bool -> [R,T] f64|i64
def java_moving_average(sums: torch.Tensor, live: torch.Tensor,
                        n_window: int, int_mode: bool = False):
    """The MovingAverage evaluation loop along the last axis
    (Aggregators.MovingAverage :709-760): each live slot's result is the
    average of the PRECEDING `n_window` live sums, exclusive of its own, 0
    until that window has filled, Java long division in int mode; dead
    slots neither produce nor consume window state (and hold 0).  The
    window sum is a difference of running sums, as the reference takes
    it."""
    t = sums.shape[-1]
    s2 = sums.reshape(-1, t)
    l2 = live.reshape(-1, t)
    kk = torch.cumsum(l2.to(torch.int64), dim=1)   # live count through t
    zero = torch.zeros((), dtype=s2.dtype)
    d = torch.cumsum(torch.where(l2, s2, zero), dim=1)
    # dm[row, m] = sum of the first m live sums: every column with the
    # same kk carries the same d, so an unconditional scatter is exact
    dm = torch.zeros((s2.shape[0], t + 1), dtype=d.dtype,
                     device=d.device).scatter_(1, kk, d)
    prev = kk - 1                     # live slots before column t
    wsum = (torch.gather(dm, 1, prev.clamp(0, t))
            - torch.gather(dm, 1, (prev - n_window).clamp(0, t)))
    if int_mode and not s2.is_floating_point():
        out = torch.div(wsum, n_window, rounding_mode="trunc")
    else:
        out = wsum.to(torch.float64) / n_window
    out = torch.where(l2 & (prev >= n_window), out,
                      torch.zeros((), dtype=out.dtype))
    return out.reshape(sums.shape)


def _check_runs(sums, live, offsets) -> None:
    if sums.dim() != 1 or sums.dtype not in (torch.float64, torch.int64):
        raise TypeError("moving_average takes flat float64 or int64 sums")
    if live is not None and (live.shape != sums.shape
                             or live.dtype != torch.bool):
        raise ValueError("live must be bool of the sums' shape")
    if offsets.dim() != 1 or offsets.numel() < 1 \
            or offsets.dtype != torch.int64:
        raise ValueError("offsets must be int64 [R + 1]")


# shape: sums[T] f64|i64, live[T] bool|None, offsets[R+1] i64 -> [T]
def moving_average(sums: torch.Tensor, live: torch.Tensor | None,
                   offsets: torch.Tensor, n_window: int) -> torch.Tensor:
    """MA -> out[T]: the Java MovingAverage loop over each run
    [offsets[i], offsets[i+1]) of the flat `sums`, whose `live` slots
    (all, when None) are the evaluations.  int64 sums are int mode.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    _check_runs(sums, live, offsets)
    if n_window < 1:
        raise ValueError("movingAverage needs a window of at least 1")
    if sums.device.type == "cpu":
        return moving_average_plain(sums, live, offsets, n_window)
    dev = kernels.require_cuda(sums, offsets,
                               *([] if live is None else [live]))
    out = torch.empty_like(sums)
    r = offsets.numel() - 1
    if r == 0 or sums.numel() == 0:
        return out
    # the running sums (one entry a slot and one a run) go to device memory
    # only for a window longer than the kernel's shared rings hold
    pre = None
    if n_window > MA_RING_WINDOW:
        pre = torch.empty(sums.numel() + r, dtype=sums.dtype, device=dev)
    kernels.launch(
        "moving_average", dev, kernels.ptr(sums),
        None if live is None else kernels.ptr(live), kernels.ptr(offsets),
        r, n_window, int(sums.dtype == torch.int64), sums.numel(),
        None if pre is None else kernels.ptr(pre), kernels.ptr(out))
    return out


def moving_average_plain(sums: torch.Tensor, live: torch.Tensor | None,
                         offsets: torch.Tensor, n_window: int) -> torch.Tensor:
    """Plain PyTorch version of MA: java_moving_average over each run (in
    one call when the runs are of one length)."""
    int_mode = sums.dtype == torch.int64
    if live is None:
        live = torch.ones_like(sums, dtype=torch.bool)
    out = torch.zeros_like(sums)
    offs = offsets.tolist()
    lengths = {b - a for a, b in zip(offs[:-1], offs[1:])}
    if len(lengths) == 1 and offs[-1] > offs[0]:
        t = lengths.pop()
        a, b = offs[0], offs[-1]
        out[a:b] = java_moving_average(sums[a:b].reshape(-1, t),
                                       live[a:b].reshape(-1, t), n_window,
                                       int_mode).reshape(-1)
        return out
    for a, b in zip(offs[:-1], offs[1:]):
        if b > a:
            out[a:b] = java_moving_average(sums[a:b], live[a:b], n_window,
                                           int_mode)
    return out


# shape: sums[R,T] f64|i64, live[R,T] bool -> [R,T] f64|i64
def moving_average_rows(sums: torch.Tensor, live: torch.Tensor,
                        n_window: int) -> torch.Tensor:
    """MA along each row of a [R, T] grid (the downsample and grid
    positions)."""
    r, t = sums.shape
    offsets = torch.arange(r + 1, dtype=torch.int64,
                           device=sums.device) * t
    return moving_average(sums.contiguous().reshape(-1),
                          live.contiguous().reshape(-1), offsets,
                          n_window).reshape(r, t)


def agg_names() -> list[str]:
    """The /api/aggregators listing: the static registry, sorted."""
    return sorted(AGGREGATORS)
