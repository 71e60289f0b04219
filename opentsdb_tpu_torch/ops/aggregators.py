"""Aggregator registry, interpolation policies and the masked moment reduces.

Port of opentsdb_tpu/ops/aggregators.py (OpenTSDB Aggregators.java :38
Interpolation enum, registry :175-203), name for name, so that a query
names the same aggregators in both packages.  On the device the reductions
live in the kernels; ``moment_reduce`` is the plain PyTorch form of the
reference's masked reduces over the series axis (``_sum`` ... ``_dev``,
:41-125) that the union path's plain version (ops.union_agg) uses and its
kernel is held to.  Only the moment family is computed (MOMENT_AGGS); the
planner refuses the rest.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
    for n in ("999", "99", "95", "90", "75", "50"):
        reg["p" + n] = LERP
        reg["ep%sr3" % n] = LERP
        reg["ep%sr7" % n] = LERP
    return {name: Aggregator(name, policy) for name, policy in reg.items()}


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
            return out.to(torch.int64)      # the (long) cast truncates
    else:
        raise NotImplementedError(
            "aggregator %r is not ported yet (ROADMAP queue B6)" % name)
    if is_float:
        out = torch.where(n > 0, out, torch.nan)
    return out
