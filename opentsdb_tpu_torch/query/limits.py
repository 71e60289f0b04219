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
* ``Deadline`` is the request-scoped wall budget and cancellation token
  (the reference's :61): minted once a request by the daemon
  (tsd/rpc_manager.py) from ``tsd.query.timeout`` and the client's
  ``X-TSDB-Deadline-Ms``, made the responder thread's ambient deadline
  (``activate_deadline``, ``active_deadline``), and taken by every
  ``QueryBudget`` of the request, so the timeout clock starts when the
  request arrives.  The server flips its token when the client hangs up
  or a drain runs out of patience; every deadline check observes it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
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


class QueryCancelledException(QueryException):
    """The request's deadline was cancelled mid-flight (the client hung
    up, or the server is draining): 503, the query itself was sound."""

    def __init__(self, message: str):
        super().__init__(message, status=503)


class QueryDeadlineExpired(QueryException):
    """The request outlived its wall budget: the reference's 413 timeout
    message under a type of its own."""


class Deadline:
    """One request's wall budget and cooperative cancellation token (the
    reference's ``Deadline``, :61).  ``timeout_ms`` <= 0 is unbounded, but
    the token still works; ``cancel`` is idempotent and the first reason
    wins; ``check`` raises QueryCancelledException (503) once cancelled,
    else QueryDeadlineExpired (413) once past the budget."""

    def __init__(self, timeout_ms: float = 0.0, clock=time.monotonic):
        self.start = clock()
        self.timeout_ms = float(timeout_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._cancelled = False  # guarded-by: _lock
        self._cancel_reason = ""  # guarded-by: _lock
        self._cancel_event = threading.Event()

    @property
    def bounded(self) -> bool:
        return self.timeout_ms > 0

    def elapsed_ms(self) -> float:
        return (self._clock() - self.start) * 1e3

    def remaining_ms(self) -> float:
        """Milliseconds left: +inf when unbounded, <= 0 once expired."""
        if not self.bounded:
            return math.inf
        return self.timeout_ms - self.elapsed_ms()

    def expired(self) -> bool:
        return self.bounded and self.remaining_ms() <= 0.0

    def cancel(self, reason: str) -> bool:
        """Flip the token; True when this call did the flip."""
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self._cancel_reason = reason
        self._cancel_event.set()
        return True

    def is_cancelled(self) -> bool:
        return self._cancelled

    def wait_cancelled(self, timeout_s: float) -> bool:
        """Sleep up to `timeout_s` (clamped to the remaining budget when
        bounded), waking early when the token flips; whether it did."""
        if timeout_s > 0 and not self._cancelled:
            if self.bounded:
                timeout_s = min(timeout_s,
                                max(self.remaining_ms() / 1e3, 0.0))
            self._cancel_event.wait(timeout_s)
        return self._cancelled

    @property
    def cancel_reason(self) -> str:
        return self._cancel_reason

    def check(self) -> None:
        """Raise if the request should stop now: cancelled (503) or past
        its wall budget (the reference's 413)."""
        if self._cancelled:
            raise QueryCancelledException(
                "Query cancelled: %s" % (self._cancel_reason or "unknown"))
        if self.expired():
            raise QueryDeadlineExpired(
                "Sorry, your query timed out. Time limit: %d ms, elapsed: "
                "%d ms. Please try filtering using more tags or decrease "
                "your time range." % (self.timeout_ms, self.elapsed_ms()))


# the ambient request deadline, one per responder thread (:163-174)
_tls = threading.local()


def activate_deadline(deadline: Deadline) -> None:
    _tls.deadline = deadline


def deactivate_deadline() -> None:
    _tls.deadline = None


def active_deadline() -> Deadline | None:
    """The current request's deadline, or None outside a request (a
    library caller's QueryRunner.run)."""
    return getattr(_tls, "deadline", None)


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
    ``tsd.query.timeout`` (:559).  With the request's `deadline` the clock
    is the request's (it started when the request arrived) and a
    cancelled token stops the query; without one (a library caller) it
    starts when the budget is made."""

    def __init__(self, limits: QueryLimitOverride | None, metric: str,
                 timeout_ms: int, deadline: Deadline | None = None):
        self.max_data_points = (
            limits.get_data_points_limit(metric) if limits else 0)
        self.max_bytes = limits.get_byte_limit(metric) if limits else 0
        self.timeout_ms = timeout_ms
        self.deadline = deadline
        self.start = deadline.start if deadline is not None \
            else time.monotonic()
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
        if self.deadline is not None:
            self.deadline.check()
        if self.timeout_ms <= 0:
            return
        elapsed_ms = (time.monotonic() - self.start) * 1000.0
        if elapsed_ms > self.timeout_ms:
            raise QueryDeadlineExpired(
                "Sorry, your query timed out. Time limit: %d ms, elapsed: "
                "%d ms. Please try filtering using more tags or decrease "
                "your time range." % (self.timeout_ms, elapsed_ms))
