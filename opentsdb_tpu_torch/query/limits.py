"""Query rejections with an HTTP status, the device-state grid guard, and
the per-metric scan budgets with the query timeout.

Port of opentsdb_tpu/query/limits.py (OpenTSDB QueryException.java,
QueryLimitOverride.java and the enforcement sites of SaltScanner.java):

* ``QueryException`` carries its status (413 by default) and a structured
  ``details`` payload for the error envelope.
* ``grid_budget`` is the shared ``tsd.query.streaming.state_mb`` guard of
  the streaming accumulator, the materialized grid and the histogram
  bucket grid.
* ``QueryLimitOverride`` holds the byte and data-point budgets, with
  regex-keyed overrides from a JSON file (first match wins, hot-reloaded
  on an mtime change, QueryLimitOverride.java:44-52, :92-118, :137,
  :157); ``QueryBudget`` charges one sub query's points against them and
  checks ``tsd.query.timeout`` (SaltScanner.java:559, :580, :596), with
  the reference's 413 messages.

The request-scoped deadline that the reference mints at request arrival
(its ``Deadline`` and ``active_deadline``) comes with admission
control: here a sub query's budget starts its clock when the planner
creates it.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from dataclasses import dataclass

LOG = logging.getLogger(__name__)


class QueryException(Exception):
    """Query failed mid-flight; carries the HTTP status and an optional
    structured ``details`` payload for the error envelope."""

    def __init__(self, message: str, status: int = 413,
                 details: dict | None = None):
        super().__init__(message)
        self.status = status
        self.details = details


class QueryDeadlineExpired(QueryException):
    """The sub query outlived ``tsd.query.timeout``: the reference's 413
    timeout message under a type of its own."""


# SKETCH_K of ops/streaming.py (kept here so that this module imports
# nothing of the kernels)
_SKETCH_K = 64

_GRID_MESSAGES = {
    "streaming": (
        "Sorry, this query's streaming state (%d series x %d windows%s) "
        "needs ~%dMB of accelerator memory per chip, over the %dMB "
        "limit (tsd.query.streaming.state_mb). Please use a coarser "
        "downsample interval or decrease your time range."),
    "grid": (
        "Sorry, this query's downsample grid (%d series x %d windows%s) "
        "needs ~%dMB of accelerator memory per chip, over the %dMB "
        "limit (tsd.query.streaming.state_mb). Please use a coarser "
        "downsample interval or decrease your time range."),
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
    kind: str           # "streaming" | "grid" | "histogram"
    grid_bytes: int
    state_mb: int       # configured limit; <= 0 disables the guard
    dim_a: int          # series (rows for histogram)
    dim_b: int          # windows (buckets for histogram)
    sketch: bool = False

    @property
    def over(self) -> bool:
        return self.state_mb > 0 and self.grid_bytes > self.state_mb * 2**20

    @property
    def grid_mb(self) -> int:
        return self.grid_bytes // 2**20

    def exception(self) -> QueryException:
        """The structured 413: the reference's budget prose plus a
        machine-readable details payload."""
        note = " x %d-point sketches" % _SKETCH_K if self.sketch else ""
        return QueryException(
            _GRID_MESSAGES[self.kind]
            % (self.dim_a, self.dim_b, note, self.grid_mb, self.state_mb),
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
                dim_b: int, sketch: bool = False) -> GridBudgetDecision:
    """The shared guard: every state_mb enforcement site builds its
    decision here from its own byte estimate."""
    if kind not in _GRID_MESSAGES:
        raise ValueError("unknown grid budget kind: %r" % kind)
    return GridBudgetDecision(kind, int(grid_bytes), int(state_mb),
                              int(dim_a), int(dim_b), sketch)


# What an overrides file can raise through json.load and
# LimitOverrideItem: I/O, non-JSON bytes, a missing "regex", an entry
# that is not a mapping, a bad regex.
_LOAD_ERRORS = (OSError, ValueError, KeyError, TypeError, re.error)

# Charged per data point as "bytes fetched from storage": an 8 B
# timestamp and an 8 B value.
BYTES_PER_POINT = 16


@dataclass
class LimitOverrideItem:
    """One override entry (QueryLimitOverrideItem :249-295)."""
    regex: str
    byte_limit: int = 0
    data_points_limit: int = 0

    def __post_init__(self):
        self._pattern = re.compile(self.regex)

    def matches(self, metric: str) -> bool:
        return bool(self._pattern.search(metric))


class QueryLimitOverride:
    """The budget registry with its file hot-reload
    (QueryLimitOverride.java:92-118).

    The overrides file is a JSON array of ``{"regex": ..., "byteLimit":
    N, "dataPointsLimit": N}`` objects; snake_case keys are accepted too.
    It is reloaded at most every ``tsd.query.limits.overrides.interval``
    seconds, and only when its mtime changed.  A file that fails to load
    keeps the last good limits (the defaults at construction), is counted
    in ``reload_errors`` and logged once per distinct error.
    """

    def __init__(self, config):
        self.default_byte_limit = config.get_int(
            "tsd.query.limits.bytes.default")
        self.default_data_points_limit = config.get_int(
            "tsd.query.limits.data_points.default")
        if self.default_byte_limit < 0:
            raise ValueError("The default byte limit cannot be negative")
        if self.default_data_points_limit < 0:
            raise ValueError(
                "The default data points limit cannot be negative")
        self.file_location = config.get_string(
            "tsd.query.limits.overrides.config")
        self.reload_interval = config.get_int(
            "tsd.query.limits.overrides.interval")
        self.overrides: list[LimitOverrideItem] = []
        self._mtime = 0.0
        self._next_check = 0.0
        self.reload_errors = 0
        self._logged_errors: set[str] = set()
        if self.file_location:
            try:
                self._load_from_file()
            except _LOAD_ERRORS as e:
                self._count_reload_error(e, during="construction")

    def _load_from_file(self) -> None:
        try:
            mtime = os.path.getmtime(self.file_location)
        except OSError:
            return
        if mtime == self._mtime:
            return
        with open(self.file_location) as fh:
            raw = json.load(fh)
        items = []
        for entry in raw:
            items.append(LimitOverrideItem(
                regex=entry["regex"],
                byte_limit=int(entry.get("byteLimit",
                                         entry.get("byte_limit", 0))),
                data_points_limit=int(entry.get(
                    "dataPointsLimit", entry.get("data_points_limit", 0)))))
        self.overrides = items
        self._mtime = mtime

    def _count_reload_error(self, exc: Exception,
                            during: str = "reload") -> None:
        self.reload_errors += 1
        key = "%s: %s" % (type(exc).__name__, exc)
        if key not in self._logged_errors:
            self._logged_errors.add(key)
            LOG.error(
                "query limit overrides %s failed on %s (%s); keeping %s",
                during, self.file_location, key,
                "last good config" if self.overrides else "defaults")

    def maybe_reload(self) -> None:
        """The hot-reload check, at most once an interval."""
        if not self.file_location or self.reload_interval <= 0:
            return
        now = time.time()
        if now < self._next_check:
            return
        self._next_check = now + self.reload_interval
        try:
            self._load_from_file()
        except _LOAD_ERRORS as e:
            self._count_reload_error(e)

    def get_byte_limit(self, metric: str) -> int:
        if metric:
            for item in self.overrides:
                if item.matches(metric):
                    return item.byte_limit
        return self.default_byte_limit

    def get_data_points_limit(self, metric: str) -> int:
        if metric:
            for item in self.overrides:
                if item.matches(metric):
                    return item.data_points_limit
        return self.default_data_points_limit


class QueryBudget:
    """The running charge of one sub query (SaltScanner's counters): a
    QueryException with the reference's 413 message past the data-point
    budget (:580) or the byte budget (:596), QueryDeadlineExpired past
    ``tsd.query.timeout`` (:559).  The clock starts when the budget is
    made (the reference's request deadline comes with admission
    control)."""

    def __init__(self, limits: QueryLimitOverride | None, metric: str,
                 timeout_ms: int):
        self.max_data_points = (
            limits.get_data_points_limit(metric) if limits else 0)
        self.max_bytes = limits.get_byte_limit(metric) if limits else 0
        self.timeout_ms = timeout_ms
        self.start = time.monotonic()
        self.data_points = 0

    def charge(self, num_points: int) -> None:
        self.data_points += num_points
        if 0 < self.max_data_points <= self.data_points:
            raise QueryException(
                "Sorry, you have attempted to fetch more than our limit of "
                "%d data points. Please try filtering using more tags or "
                "decrease your time range." % self.max_data_points)
        if self.max_bytes > 0 and \
                self.data_points * BYTES_PER_POINT > self.max_bytes:
            raise QueryException(
                "Sorry, you have attempted to fetch more than our maximum "
                "amount of %dMB from storage. Please try filtering using "
                "more tags or decrease your time range."
                % (self.max_bytes / 1024 / 1024))

    def check_deadline(self) -> None:
        if self.timeout_ms <= 0:
            return
        elapsed_ms = (time.monotonic() - self.start) * 1000.0
        if elapsed_ms > self.timeout_ms:
            raise QueryDeadlineExpired(
                "Sorry, your query timed out. Time limit: %d ms, elapsed: "
                "%d ms. Please try filtering using more tags or decrease "
                "your time range." % (self.timeout_ms, elapsed_ms))
