"""Query rejections with an HTTP status, and the device-state grid guard.

A slim port of opentsdb_tpu/query/limits.py (OpenTSDB
QueryException.java): ``QueryException`` carries its status (413 by
default) and a structured ``details`` payload for the error envelope;
``grid_budget`` is the shared ``tsd.query.streaming.state_mb`` guard, of
which the port reads only the histogram bucket grid so far.  The scan
budgets and deadlines are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass


class QueryException(Exception):
    """Query failed mid-flight; carries the HTTP status and an optional
    structured ``details`` payload for the error envelope."""

    def __init__(self, message: str, status: int = 413,
                 details: dict | None = None):
        super().__init__(message)
        self.status = status
        self.details = details


_GRID_MESSAGES = {
    "histogram": (
        "Sorry, this histogram query's bucket grid (%d windows x "
        "%d buckets%s) needs ~%dMB of accelerator memory, over the "
        "%dMB limit (tsd.query.streaming.state_mb). Please use a "
        "coarser downsample interval or decrease your time range."),
}


@dataclass(frozen=True)
class GridBudgetDecision:
    """One grid-vs-budget verdict: the bytes a plan's device-resident
    grid needs against the configured allowance."""
    kind: str           # "histogram"
    grid_bytes: int
    state_mb: int       # configured limit; <= 0 disables the guard
    dim_a: int          # rows
    dim_b: int          # buckets

    @property
    def over(self) -> bool:
        return self.state_mb > 0 and self.grid_bytes > self.state_mb * 2**20

    @property
    def grid_mb(self) -> int:
        return self.grid_bytes // 2**20

    def exception(self) -> QueryException:
        """The structured 413: the reference's budget prose plus a
        machine-readable details payload."""
        return QueryException(
            _GRID_MESSAGES[self.kind]
            % (self.dim_a, self.dim_b, "", self.grid_mb, self.state_mb),
            details={
                "gridMb": self.grid_mb,
                "limitMb": self.state_mb,
                "limitKey": "tsd.query.streaming.state_mb",
                "kind": self.kind,
                "suggestion": "use a coarser downsample interval, "
                              "decrease the time range, or raise "
                              "tsd.query.streaming.state_mb / enable "
                              "tsd.query.spill.enable for tiled "
                              "execution",
            })


def grid_budget(kind: str, state_mb: int, grid_bytes: int, dim_a: int,
                dim_b: int) -> GridBudgetDecision:
    if kind not in _GRID_MESSAGES:
        raise ValueError("unknown grid budget kind: %r" % kind)
    return GridBudgetDecision(kind, int(grid_bytes), int(state_mb),
                              int(dim_a), int(dim_b))
