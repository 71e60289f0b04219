"""Percentile estimators (LEGACY / R-3 / R-7) over sorted runs.

Port of opentsdb_tpu/ops/percentile.py (Aggregators.PercentileAgg
:657-708, Apache commons-math3 ``Percentile``: LEGACY pos = p*(n+1)/100
with linear interpolation between order statistics; ``ep*r3``/``ep*r7``
the Hyndman-Fan types R-3 and R-7).  These are the plain forms that the
kernels K4, K5 and U3 (csrc/order_stats.cuh ``percentile``) are held to;
one estimator core (``_estimate``) serves the row-run, column-run and
whole-column forms, so the three cannot drift apart.
"""

from __future__ import annotations

import torch

EST_LEGACY = "legacy"
EST_R3 = "r_3"
EST_R7 = "r_7"

# Estimator -> the kernels' `enum Est` (csrc/order_stats.cuh).
EST_CODES = {EST_LEGACY: 0, EST_R3: 1, EST_R7: 2}


def parse_percentile_name(name: str) -> tuple[float, str]:
    """"p99" -> (99.0, legacy); "ep999r3" -> (99.9, r_3); "ep50r7" -> (50.0,
    r_7) (opentsdb_tpu/ops/downsample.py:1295)."""
    est = EST_LEGACY
    digits = name
    if name.startswith("ep"):
        if name.endswith("r3"):
            est = EST_R3
        elif name.endswith("r7"):
            est = EST_R7
        else:
            raise KeyError("No such aggregator: " + name)
        digits = name[2:-2]
    elif name.startswith("p"):
        digits = name[1:]
    if digits == "999":
        return 99.9, est
    q = float(digits)
    if not 0 < q <= 100:
        raise KeyError("Invalid percentile: " + name)
    return q, est


# shape: values[S,T] f64, mask[S,T] bool -> [T] f64
def masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float,
                      estimation: str = EST_LEGACY) -> torch.Tensor:
    """Percentile q of the masked-in values of each column (axis 0); NaN
    for an empty column.  Masked-out slots sort to +inf, so the n valid
    values occupy the first n positions of each sorted column."""
    n = mask.sum(dim=0)
    sorted_vals = torch.sort(torch.where(mask, values, torch.inf),
                             dim=0).values
    starts = torch.zeros((1,) + n.shape, dtype=torch.int64,
                         device=values.device)
    return column_run_percentile(sorted_vals, starts, n[None, :], q,
                                 estimation)[0]


def _estimate(at, n: torch.Tensor, q: float, estimation: str):
    """Shared estimator core: `at(k)` returns the k-th (1-based) order
    statistic of each cell's run, clipped to the run; `n` is the count per
    cell."""
    nf = n.to(torch.float64)
    if estimation == EST_LEGACY:
        pos = q * (nf + 1.0) / 100.0
        fpos = torch.floor(pos)
        d = pos - fpos
        k = fpos.to(torch.int64)
        mid = at(k) + d * (at(k + 1) - at(k))
        out = torch.where(pos < 1.0, at(torch.ones_like(k)),
                          torch.where(pos >= nf, at(n), mid))
    elif estimation == EST_R3:
        h = nf * q / 100.0
        k = torch.clamp(torch.ceil(h - 0.5).to(torch.int64), min=1)
        out = at(torch.minimum(k, n.clamp(min=1)))
    elif estimation == EST_R7:
        h = (nf - 1.0) * q / 100.0 + 1.0
        fh = torch.floor(h)
        k = fh.to(torch.int64)
        out = at(k) + (h - fh) * (at(k + 1) - at(k))
    else:
        raise ValueError("Unknown estimation type: " + estimation)
    return torch.where(n > 0, out, torch.nan)


def _run_at(sorted_runs: torch.Tensor, starts: torch.Tensor,
            n: torch.Tensor, dim: int):
    """at(k) over runs of `sorted_runs` along `dim` starting at `starts`
    with `n` members, the 1-based k clipped to the run."""
    top = sorted_runs.shape[dim] - 1

    def at(one_based_idx):
        idx = starts + torch.minimum((one_based_idx - 1).clamp(min=0),
                                     (n - 1).clamp(min=0))
        return torch.gather(sorted_runs, dim, idx.clamp(0, top))

    return at


# shape: sorted_rows[S,N] f64, starts[S,W] i64, counts[S,W] i64 -> [S,W] f64
def row_run_percentile(sorted_rows: torch.Tensor, starts: torch.Tensor,
                       counts: torch.Tensor, q: float,
                       estimation: str = EST_LEGACY) -> torch.Tensor:
    """Percentile per (series, window) cell of row-sorted runs: window w's
    members occupy columns [starts[s, w], starts[s, w] + counts[s, w])."""
    return _estimate(_run_at(sorted_rows, starts, counts, 1), counts, q,
                     estimation)


# shape: sorted_cols[S,W] f64, starts[G,W] i64, counts[G,W] i64 -> [G,W] f64
def column_run_percentile(sorted_cols: torch.Tensor, starts: torch.Tensor,
                          counts: torch.Tensor, q: float,
                          estimation: str = EST_LEGACY) -> torch.Tensor:
    """Percentile per (group, window) cell of column-sorted runs: group g's
    members occupy rows [starts[g, w], starts[g, w] + counts[g, w])."""
    return _estimate(_run_at(sorted_cols, starts, counts, 0), counts, q,
                     estimation)
