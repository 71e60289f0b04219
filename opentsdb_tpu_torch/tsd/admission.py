"""Admission control for the query path: bounded concurrency, priority
queues, per-tenant fair share, cost-priced shedding and a degradation
ladder.

Port of opentsdb_tpu/tsd/admission.py.  The responder pool
(tsd/server.py) would queue work without bound; this gate sits in front
of every query that dispatches device work (``/api/query``) and bounds
what the daemon admits:

* **Permits.**  At most ``tsd.query.admission.permits`` queries run at
  once; the rest wait in a bounded queue per priority class
  (``X-TSDB-Priority: interactive|batch``, interactive drains first).  A
  full queue, or a wait past ``tsd.query.admission.max_wait_ms``, sheds
  with 503 and ``Retry-After``.
* **Fair share.**  Inside a class the queue drains by weighted deficit
  round robin over clamped tenants (``X-TSDB-Tenant``, ``clamp_tenant``),
  each entry costing its predicted milliseconds; with
  ``tsd.query.tenant.fair_share`` the queue bound applies per tenant, and
  ``tsd.query.tenant.max_inflight`` caps one tenant's permits.
* **Cost-priced shedding.**  With a bounded request deadline
  (``tsd.query.timeout`` or ``X-TSDB-Deadline-Ms``) the plan's predicted
  cost (``estimate_plan_cost_ms``, over ops/costmodel.py's ``cuda``
  table) plus the expected queue wait is held against the deadline's
  remainder; a query that cannot finish in time is refused now (503 and
  ``Retry-After``), or with ``tsd.query.degrade=allow`` first degraded
  (``try_degrade``: the downsample interval coarsened x2..x16, then the
  range cut toward the present), answering a 200 that carries
  ``partialResults``.
* **Cancellation.**  The queue wait observes the request deadline's
  token: a cancelled or expired query leaves the queue without taking a
  permit.  The server flips the token when the client hangs up and when
  a drain runs out of patience (``CancellationHandle``).
* **Preview.**  ``preview`` is the verdict ``admit`` would give, with
  nothing acquired or counted: explain's admission section.

The verdict is an ``admission`` span of the request's trace, the clamped
tenant keys its latency profile, and the time from the parse mark to the
permit is its ``admission_wait`` phase (obs/latattr.py).  A plan the
aggregate cache covers is priced on its uncovered windows only, unless
the device mesh would serve it (the planner never rewrites a meshed
plan, :216-226).

Differences: the reference's prometheus families and flight-recorder
events are slice 8d; the shed, degrade and cancel counts here are
``collect_stats`` tallies; a meshed plan's out-of-core overhead is priced
only when its state is over the budget per chip, as the routing verdict
tiles it (the reference prices the whole state); there are no fault
sites (slice 9).
"""

from __future__ import annotations

import copy
import math
import threading
import time
import zlib
from collections import deque

from opentsdb_tpu_torch.obs import latattr
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.query.limits import (
    Deadline, QueryException, active_deadline)
from opentsdb_tpu_torch.uid import NoSuchUniqueName

# the request headers the gate reads (lower case, as the wire parser
# stores them)
DEADLINE_HEADER = "x-tsdb-deadline-ms"
PRIORITY_HEADER = "x-tsdb-priority"
TENANT_HEADER = "x-tsdb-tenant"

# Priority classes, drain order first to last; an unknown or absent header
# lands in the first.
CLASSES = ("interactive", "batch")

# Queue-wait poll: a cancellation flips a token without notifying the
# gate's condition, so waiters re-check on this cadence.
_WAIT_TICK_S = 0.05


def clamp_tenant(config, raw: str | None) -> str:
    """A client's tenant header clamped to a bounded label table (a copy
    of the reference's obs/flightrec.py clamp_tenant, :67): a registered
    tenant (``tsd.diag.tenants``) keeps its name, anything else hashes
    into one of ``tsd.diag.tenant_buckets`` buckets (0 buckets: "other"),
    an absent header is "default"."""
    raw = (raw or "").strip()
    if not raw:
        return "default"
    registered = config.get_string("tsd.diag.tenants")
    if registered:
        for name in registered.split(","):
            if raw == name.strip():
                return raw
    buckets = config.get_int("tsd.diag.tenant_buckets")
    if buckets <= 0:
        return "other"
    return "tenant-%02x" % (zlib.crc32(raw.encode("utf-8")) % buckets)


class ShedError(QueryException):
    """Admission refused the query: 503 and Retry-After.  The client
    should back off; the same request may succeed later."""

    def __init__(self, message: str, retry_after_s: int = 1):
        super().__init__(message, status=503)
        self.retry_after_s = max(int(retry_after_s), 1)


class CancellationHandle:
    """The server's lever on one in-flight request's deadline.  The
    server makes it before dispatching (it sees the client hang up) and
    rpc_manager binds the request's freshly minted Deadline to it; a
    cancel that lands before the bind is replayed onto the deadline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._deadline: Deadline | None = None  # guarded-by: _lock
        self._pending_reason: str | None = None  # guarded-by: _lock

    def bind(self, deadline: Deadline) -> None:
        with self._lock:
            self._deadline = deadline
            reason = self._pending_reason
        if reason is not None:
            deadline.cancel(reason)

    def cancel(self, reason: str) -> bool:
        """Flip the bound deadline's token (or keep the reason for the
        bind); True when this call did the flip."""
        with self._lock:
            deadline = self._deadline
            if deadline is None:
                if self._pending_reason is not None:
                    return False
                self._pending_reason = reason
                return True
        return deadline.cancel(reason)

    def is_cancelled(self) -> bool:
        with self._lock:
            if self._deadline is None:
                return self._pending_reason is not None
            deadline = self._deadline
        return deadline.is_cancelled()


# --------------------------------------------------------------------- #
# Plan-shape cost estimation                                            #
# --------------------------------------------------------------------- #

# Series sampled a sub query for its point count: the estimate stays
# O(sample * log points) on the pre-admission path.
_COST_SAMPLE_SERIES = 64


def estimate_plan_cost_ms(tsdb, ts_query) -> float:
    """Predicted milliseconds of the parsed plan from the cost model
    (:148): an estimate, never a timer.  Series counts are unfiltered
    (an upper bound), point counts extrapolate from a bounded sample, the
    group count is one (or every series under "none"); a plan the rollup
    lanes cover is priced at their assembly plus the tail, a plan the
    aggregate cache partly covers on the points of its uncovered windows
    (the rewritten plan, :215-235), and a plan past the device budget at
    its tiled overhead besides.  0.0 when nothing is predictable (unknown
    metrics, tsuid sub queries)."""
    from opentsdb_tpu_torch.ops import costmodel as cm
    from opentsdb_tpu_torch.ops.streaming import (is_sketch_ds, lanes_for,
                                                  pad_pow2, SKETCH_K)
    from opentsdb_tpu_torch.ops.tiling import size_tiles

    fix = tsdb.config.fix_duplicates
    mesh = tsdb.query_mesh()
    min_series = tsdb.config.get_int("tsd.query.mesh.min_series")
    total_s = 0.0
    for sub in ts_query.queries:
        if not sub.metric:
            continue
        try:
            metric_uid = tsdb.metrics.get_id(sub.metric)
        except NoSuchUniqueName:
            continue
        s, sample = tsdb.store.series_count_and_sample(
            metric_uid, _COST_SAMPLE_SERIES)
        if not s:
            continue
        # the planner shards such a plan over the mesh
        meshed = mesh is not None and s >= min_series
        n_chips = mesh.size if meshed else 1
        pts = sum(sr.window_count(ts_query.start_time, ts_query.end_time,
                                  fix) for sr in sample)
        points = pts * s / len(sample)
        if points <= 0:
            continue
        ds = sub.downsample_spec
        ds_fn = None
        w = 1
        g = pad_pow2(s if sub.aggregator == "none" else 1)
        if ds is not None and ds.interval_ms > 0 and not ds.run_all:
            ds_fn = ds.function
            w = max(int((ts_query.end_time - ts_query.start_time)
                        // ds.interval_ms) + 1, 1)
            lanes = tsdb.rollup_lanes
            if lanes is not None and not ds.use_calendar:
                cov = lanes.coverage(metric_uid, ds.interval_ms, ds_fn,
                                     ts_query.start_time,
                                     ts_query.end_time)
                if cov >= 1.0:
                    first = ts_query.start_time \
                        - ts_query.start_time % ds.interval_ms
                    picked = lanes.lane_for(ds.interval_ms, first)
                    k = (ds.interval_ms // picked[1]) if picked else 1
                    total_s += cm.predict_lane(s, w, k)
                    total_s += sum(cm.stage_breakdown(
                        s, 8, w, g, ds_fn, bool(sub.rate)).values())
                    continue
            # the rewritten plan, not the original: windows that valid
            # aggregate blocks cover never dispatch.  Only a plan the
            # planner can rewrite (a fixed grid that does not stream, off
            # the mesh) takes the discount, or the gate would under-price
            # the heaviest queries it exists to refuse
            agg = tsdb.agg_cache
            if (agg is not None and not ds.use_calendar
                    and points <= tsdb.config.get_int(
                        "tsd.query.streaming.point_threshold")
                    and not meshed):
                points *= max(1.0 - agg.coverage(
                    tsdb.store, metric_uid, ds.interval_ms, ds.function,
                    ts_query.start_time, ts_query.end_time), 0.0)
                if points < 1:
                    continue
        n = pad_pow2(max(int(math.ceil(points / s)), 1))
        total_s += sum(cm.stage_breakdown(s, n, w, g, ds_fn,
                                          bool(sub.rate)).values())
        # a plan past the device budget is tiled, not refused: price its
        # overhead too, sized as ops/tiling.size_tiles sizes it
        state_mb = tsdb.config.get_int("tsd.query.streaming.state_mb")
        pool = tsdb.spill_pool
        if pool is None or state_mb <= 0 or ds_fn is None:
            continue
        sketch = (is_sketch_ds(ds_fn) and tsdb.config.get_bool(
            "tsd.query.streaming.sketch_percentiles"))
        per_cell = 8 + 8 * len(lanes_for([ds_fn])) \
            + (4 * SKETCH_K if sketch else 0)
        if cm.per_chip(s * w * per_cell, n_chips) > state_mb * 2 ** 20:
            plan = size_tiles(
                s, w, state_mb * 2 ** 20, per_cell, g,
                tsdb.config.get_int("tsd.query.spill.max_tiles"))
            if plan is not None and plan.spill_bytes \
                    <= pool.host_budget + pool.disk_budget:
                total_s += cm.predict_tiled(plan.spill_bytes,
                                            plan.n_stripes)
    return total_s * 1e3


# --------------------------------------------------------------------- #
# Degradation ladder                                                    #
# --------------------------------------------------------------------- #

# Rung 1: coarsen the fixed downsample intervals by these factors.
_COARSEN_FACTORS = (2, 4, 8, 16)
# Rung 2: cut the range toward the present, keeping this share.
_TRUNCATE_KEEP = (0.5, 0.25, 0.125)


def _coarsenable(sub) -> bool:
    ds = sub.downsample_spec
    return (ds is not None and ds.interval_ms > 0
            and not ds.use_calendar and not ds.run_all)


def try_degrade(tsdb, ts_query, budget_ms: float,
                queue_wait_ms: float) -> dict | None:
    """Move ``ts_query`` down the ladder until its predicted cost fits
    ``budget_ms - queue_wait_ms`` (:302); the degradation note for the
    partialResults annotation, or None when the last rung does not fit.
    Each rung coarsens from the original interval, so the note reports
    the factor applied."""
    fits_ms = budget_ms - queue_wait_ms
    coarsen = [sub for sub in ts_query.queries if _coarsenable(sub)]
    originals = {id(sub): sub.downsample_spec.interval_ms
                 for sub in coarsen}
    for factor in _COARSEN_FACTORS:
        if not coarsen:
            break
        for sub in coarsen:
            sub.downsample_spec.interval_ms = originals[id(sub)] * factor
            # the string form stays in step with the parsed spec (a
            # re-validate re-parses it)
            sub.downsample = "%dms-%s" % (
                sub.downsample_spec.interval_ms,
                sub.downsample.split("-", 1)[1])
        if estimate_plan_cost_ms(tsdb, ts_query) <= fits_ms:
            return {"coarsenedIntervalFactor": factor,
                    "coarsenedIntervalMs": max(
                        sub.downsample_spec.interval_ms
                        for sub in coarsen)}
    span_ms = ts_query.end_time - ts_query.start_time
    for keep in _TRUNCATE_KEEP:
        new_start = int(ts_query.end_time - span_ms * keep)
        ts_query.start_time = new_start
        ts_query.start = str(new_start)
        if estimate_plan_cost_ms(tsdb, ts_query) <= fits_ms:
            note = {"truncatedStartMs": new_start,
                    "truncatedKeepFraction": keep}
            if coarsen:
                note["coarsenedIntervalFactor"] = _COARSEN_FACTORS[-1]
            return note
    return None


def partial_annotation(exec_stats: dict) -> dict | None:
    """The trailer a degraded 200 carries (a copy of the reference's
    tsd/cluster.py partial_annotation, :278), None for a full answer.
    The port has no cluster yet (slice 9), so its peer counts are 0."""
    if not exec_stats.get("partialResults"):
        return None
    out = {
        "partialResults": True,
        "clusterPeersFailed": exec_stats.get("clusterPeersFailed", 0),
        "clusterPeers": exec_stats.get("clusterPeers", 0),
    }
    if exec_stats.get("degraded"):
        out["degraded"] = exec_stats["degraded"]
    return out


# --------------------------------------------------------------------- #
# The gate                                                              #
# --------------------------------------------------------------------- #

class Permit:
    """One admitted query's permit: released on exit, exactly once."""

    def __init__(self, gate: "AdmissionGate | None",
                 tenant: str = "default", gate_tenant: str | None = None):
        self._gate = gate
        self._t0 = time.monotonic()
        self.degrade_note: dict | None = None
        # the clamped tenant of the request; the gate's own in-flight
        # bookkeeping releases under the identity it admitted with
        self.tenant = tenant
        self._gate_tenant = gate_tenant or tenant

    def __enter__(self) -> "Permit":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        gate, self._gate = self._gate, None
        if gate is not None:
            gate._release((time.monotonic() - self._t0) * 1e3,
                          self._gate_tenant)


class _Waiter:
    """One queued query: its clamped tenant (the DRR identity), class,
    predicted cost, and the tenant it reports (``public``)."""

    __slots__ = ("tenant", "priority", "cost_ms", "public")

    def __init__(self, tenant: str, priority: str, cost_ms: float,
                 public: str | None = None):
        self.tenant = tenant
        self.priority = priority
        self.cost_ms = max(float(cost_ms), 1.0)
        self.public = public or tenant


class AdmissionGate:
    """Permits and bounded per-priority wait queues drained by weighted
    deficit round robin across clamped tenants (the reference's
    AdmissionGate).  One a TSDB (``tsdb.admission_gate``), shared by every
    responder thread; all state under ``_lock``, waiters parked on a
    condition that they re-check on a short tick.

    Draining order: the priority class first, then inside it the tenant
    whose head entry needs the fewest virtual DRR rounds (each round
    credits every backlogged tenant ``tsd.query.tenant.quantum_ms`` x its
    weight).  With one tenant the drain is the per-class FIFO."""

    def __init__(self, config):
        self.enabled = config.get_bool("tsd.query.admission.enable")
        self.permits = config.get_int("tsd.query.admission.permits")
        self.queue_limit = config.get_int("tsd.query.admission.queue_limit")
        self.max_wait_ms = config.get_int("tsd.query.admission.max_wait_ms")
        self.fair_share = config.get_bool("tsd.query.tenant.fair_share")
        self.quantum_ms = max(
            config.get_int("tsd.query.tenant.quantum_ms"), 1)
        self.tenant_max_inflight = config.get_int(
            "tsd.query.tenant.max_inflight")
        self._weights = self._parse_weights(
            config.get_string("tsd.query.tenant.weights"))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.in_flight = 0  # guarded-by: _lock
        # per class: tenant -> FIFO of _Waiter  # guarded-by: _lock
        self._queues: dict[str, dict[str, deque]] = {c: {} for c in CLASSES}
        # DRR rotation and deficits per class  # guarded-by: _lock
        self._rr: dict[str, deque] = {c: deque() for c in CLASSES}
        self._deficit: dict[str, dict[str, float]] = {c: {} for c in CLASSES}
        self._tenant_inflight: dict[str, int] = {}  # guarded-by: _lock
        # EWMA of permit hold time, the Retry-After basis
        self._ewma_service_ms = 200.0  # guarded-by: _lock
        self.admitted = 0  # guarded-by: _lock
        self.shed = 0  # guarded-by: _lock
        self.degraded = 0  # guarded-by: _lock
        # by reason  # guarded-by: _lock
        self.shed_reasons: dict[str, int] = {}
        self.cancelled: dict[str, int] = {}
        self.tenant_admitted: dict[str, int] = {}  # guarded-by: _lock
        self.tenant_refused: dict[str, int] = {}  # guarded-by: _lock

    @staticmethod
    def _parse_weights(spec: str) -> dict[str, float]:
        """'tenant:weight,...' -> {tenant: weight}; malformed entries are
        skipped."""
        out: dict[str, float] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part or ":" not in part:
                continue
            name, _, w = part.rpartition(":")
            try:
                weight = float(w)
            except ValueError:
                continue
            if name.strip() and weight > 0:
                out[name.strip()] = weight
        return out

    def _weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    # -- accounting -----------------------------------------------------

    def _depth_locked(self) -> int:
        return sum(len(q) for tenants in self._queues.values()
                   for q in tenants.values())

    def demand(self) -> int:
        """Queries holding or waiting for a permit (the dispatch batcher's
        hint that a sibling may be coming)."""
        with self._lock:
            return self.in_flight + self._depth_locked()

    def retry_after_s(self) -> int:
        """Seconds until capacity plausibly frees: the backlog worked off
        at the observed service rate."""
        with self._lock:
            backlog = self._depth_locked() + self.in_flight
            ewma = self._ewma_service_ms
        return max(int(math.ceil(backlog * ewma / max(self.permits, 1)
                                 / 1e3)), 1)

    def queue_wait_estimate_ms(self) -> float:
        """Expected wait before a permit frees for a new arrival."""
        with self._lock:
            if self.in_flight < self.permits and self._depth_locked() == 0:
                return 0.0
            backlog = self._depth_locked() + 1
            ewma = self._ewma_service_ms
        return backlog * ewma / max(self.permits, 1)

    def count_cancelled(self, reason: str) -> None:
        """One query cancelled cooperatively: in the queue, at a client
        hang-up or at a drain's timeout."""
        with self._lock:
            self.cancelled[reason] = self.cancelled.get(reason, 0) + 1

    def count_degraded(self) -> None:
        with self._lock:
            self.degraded += 1

    def _shed(self, reason: str, message: str,
              tenant: str = "default") -> ShedError:
        with self._lock:
            self.shed += 1
            self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
            self.tenant_refused[tenant] = \
                self.tenant_refused.get(tenant, 0) + 1
        return ShedError(message, retry_after_s=self.retry_after_s())

    def collect_stats(self) -> dict:
        """The gate's tallies (the reference's tsd.query.admission.*
        families as plain counts)."""
        with self._lock:
            out = {"tsd.query.admission.inflight": float(self.in_flight),
                   "tsd.query.admission.queued": float(
                       self._depth_locked()),
                   "tsd.query.admission.admitted": float(self.admitted),
                   "tsd.query.admission.shed": float(self.shed),
                   "tsd.query.admission.degraded": float(self.degraded)}
            for reason, n in self.shed_reasons.items():
                out["tsd.query.admission.shed." + reason] = float(n)
            for reason, n in self.cancelled.items():
                out["tsd.query.admission.cancelled." + reason] = float(n)
        return out

    # -- acquire/release ------------------------------------------------

    def _tenant_capped_locked(self, tenant: str) -> bool:
        cap = self.tenant_max_inflight
        return cap > 0 and self._tenant_inflight.get(tenant, 0) >= cap

    def _queue_full_locked(self, tenant: str) -> bool:
        """With fair share the bound is per tenant, else global."""
        if not self.fair_share:
            return self._depth_locked() >= self.queue_limit
        return sum(len(self._queues[cls].get(tenant, ()))
                   for cls in CLASSES) >= self.queue_limit

    def _admit_locked(self, tenant: str, public: str) -> Permit:
        self.in_flight += 1
        self.admitted += 1
        self._tenant_inflight[tenant] = \
            self._tenant_inflight.get(tenant, 0) + 1
        self.tenant_admitted[public] = \
            self.tenant_admitted.get(public, 0) + 1
        return Permit(self, tenant=public, gate_tenant=tenant)

    def acquire(self, deadline: Deadline | None, priority: str,
                tenant: str = "default", cost_ms: float = 1.0) -> Permit:
        """Block until a permit is held, or raise: ShedError (the queue
        full, or waited past max_wait), or the deadline's own exception
        (expired or cancelled while queued, without taking a permit).
        ``cost_ms`` is what the DRR drain charges the tenant."""
        if not self.enabled:
            return Permit(None, tenant=tenant)
        if priority not in self._queues:
            priority = CLASSES[0]
        public = tenant
        if not self.fair_share:
            # every query shares one DRR identity: the per-class FIFO
            tenant = "default"
        waiter = _Waiter(tenant, priority, cost_ms, public=public)
        t0 = time.monotonic()
        with self._lock:
            if (self.in_flight < self.permits
                    and self._depth_locked() == 0
                    and not self._tenant_capped_locked(tenant)):
                return self._admit_locked(tenant, public)
            full = self._queue_full_locked(tenant)
            if not full:
                self._enqueue_locked(waiter)
        if full:
            raise self._shed(
                "queue_full",
                "Sorry, the query admission queue is full (%d waiting, "
                "%d in flight). Please retry later." % (
                    self.queue_limit, self.permits), tenant=public)
        return self._wait_in_queue(deadline, waiter, t0)

    def _enqueue_locked(self, waiter: _Waiter) -> None:
        tenants = self._queues[waiter.priority]
        q = tenants.get(waiter.tenant)
        if q is None:
            q = tenants[waiter.tenant] = deque()
            self._rr[waiter.priority].append(waiter.tenant)
            self._deficit[waiter.priority].setdefault(waiter.tenant, 0.0)
        q.append(waiter)

    def _remove_locked(self, waiter: _Waiter) -> None:
        tenants = self._queues[waiter.priority]
        q = tenants.get(waiter.tenant)
        if q is None:
            return
        try:
            q.remove(waiter)
        except ValueError:
            return
        if not q:
            del tenants[waiter.tenant]
            try:
                self._rr[waiter.priority].remove(waiter.tenant)
            except ValueError:
                pass
            self._deficit[waiter.priority].pop(waiter.tenant, None)

    def _pick_locked(self):
        """The weighted-DRR choice: the first class with eligible work,
        in it the tenant whose head entry needs the fewest virtual rounds
        (arrival order breaks ties).  (waiter, rounds), or (None, 0) when
        every queued tenant is at its cap."""
        for cls in CLASSES:
            tenants = self._queues[cls]
            if not tenants:
                continue
            deficit = self._deficit[cls]
            best = None
            for pos, t in enumerate(self._rr[cls]):
                q = tenants.get(t)
                if not q or self._tenant_capped_locked(t):
                    continue
                qw = self.quantum_ms * self._weight(t)
                need = q[0].cost_ms - deficit.get(t, 0.0)
                rounds = 0 if need <= 0 else int(math.ceil(need / qw))
                if best is None or (rounds, pos) < (best[0], best[1]):
                    best = (rounds, pos, t)
            if best is not None:
                return tenants[best[2]][0], best[0]
        return None, 0

    def _claim_locked(self, waiter: _Waiter, rounds: int) -> Permit:
        """Serve `waiter`: run the virtual rounds (crediting every
        backlogged tenant of its class), charge its cost, admit it."""
        cls = waiter.priority
        deficit = self._deficit[cls]
        if rounds:
            for t in self._rr[cls]:
                if self._queues[cls].get(t):
                    deficit[t] = deficit.get(t, 0.0) \
                        + rounds * self.quantum_ms * self._weight(t)
        deficit[waiter.tenant] = deficit.get(waiter.tenant, 0.0) \
            - waiter.cost_ms
        self._remove_locked(waiter)
        # a claim changes the choice: the next waiter re-evaluates now
        self._cv.notify_all()
        return self._admit_locked(waiter.tenant, waiter.public)

    def _wait_in_queue(self, deadline: Deadline | None, waiter: _Waiter,
                       t0: float) -> Permit:
        while True:
            expired = shed = False
            with self._lock:
                if self.in_flight < self.permits:
                    picked, rounds = self._pick_locked()
                    if picked is waiter:
                        return self._claim_locked(waiter, rounds)
                if deadline is not None and (deadline.is_cancelled()
                                             or deadline.expired()):
                    self._remove_locked(waiter)
                    self._cv.notify_all()
                    expired = True
                elif (time.monotonic() - t0) * 1e3 >= self.max_wait_ms > 0:
                    self._remove_locked(waiter)
                    self._cv.notify_all()
                    shed = True
                else:
                    self._cv.wait(_WAIT_TICK_S)
            if expired:
                if deadline.is_cancelled():
                    self.count_cancelled("queued")
                # the deadline's own 503 or 413: the query leaves without
                # having dispatched
                deadline.check()
                raise QueryException("Sorry, your query's deadline "
                                     "expired while queued.")
            if shed:
                raise self._shed(
                    "max_wait",
                    "Sorry, no query capacity freed within %d ms. "
                    "Please retry later." % self.max_wait_ms,
                    tenant=waiter.public)

    def _release(self, held_ms: float, tenant: str = "default") -> None:
        with self._lock:
            self.in_flight -= 1
            left = self._tenant_inflight.get(tenant, 0) - 1
            if left > 0:
                self._tenant_inflight[tenant] = left
            else:
                self._tenant_inflight.pop(tenant, None)
            self._ewma_service_ms = (0.8 * self._ewma_service_ms
                                     + 0.2 * held_ms)
            self._cv.notify_all()

    def contended(self) -> bool:
        """True when an arrival would queue: the DRR costs matter."""
        with self._lock:
            return (self.in_flight >= self.permits
                    or self._depth_locked() > 0)

    def tenant_snapshot(self) -> dict:
        """The fair-share audit view: per tenant, permits held, queued
        entries, deficit, weight, admitted and refused."""
        with self._lock:
            tenants: set[str] = set(self._tenant_inflight)
            tenants.update(self.tenant_admitted)
            tenants.update(self.tenant_refused)
            for cls in CLASSES:
                tenants.update(self._queues[cls])
            out = {}
            for t in sorted(tenants):
                out[t] = {
                    "inflight": self._tenant_inflight.get(t, 0),
                    "queued": sum(len(self._queues[cls].get(t, ()))
                                  for cls in CLASSES),
                    "deficitMs": {
                        cls: round(self._deficit[cls].get(t, 0.0), 3)
                        for cls in CLASSES if t in self._deficit[cls]},
                    "weight": self._weight(t),
                    "admitted": self.tenant_admitted.get(t, 0),
                    "refused": self.tenant_refused.get(t, 0),
                }
            return {"fairShare": self.fair_share,
                    "quantumMs": self.quantum_ms,
                    "maxInflightPerTenant": self.tenant_max_inflight,
                    "tenants": out}


_GATE_LOCK = threading.Lock()


def gate_for(tsdb) -> AdmissionGate:
    """The TSDB's admission gate (made at first use on a TSDB that has
    none)."""
    gate = getattr(tsdb, "admission_gate", None)
    if gate is None:
        with _GATE_LOCK:
            gate = getattr(tsdb, "admission_gate", None)
            if gate is None:
                gate = AdmissionGate(tsdb.config)
                tsdb.admission_gate = gate
    return gate


# --------------------------------------------------------------------- #
# The front door                                                        #
# --------------------------------------------------------------------- #

def admit(tsdb, ts_query, http_query=None) -> Permit:
    """The admission decision for one parsed, validated query (:837):
    predict, maybe degrade, queue, admit, or raise ShedError (503 and
    Retry-After) or the deadline's own exception.  Returns the held
    Permit; ``permit.degrade_note`` is set when the ladder ran."""
    gate = gate_for(tsdb)
    deadline = active_deadline()
    priority = ""
    tenant_raw = None
    fanout = False
    if http_query is not None:
        priority = (http_query.request.header(PRIORITY_HEADER)
                    or "").strip().lower()
        tenant_raw = http_query.request.header(TENANT_HEADER)
        # a cluster peer's sub-request never degrades: its coordinator
        # merges raw points and would drop the annotation, so it sheds
        fanout = bool(http_query.request.header("x-tsdb-cluster"))
    if priority not in CLASSES:
        priority = CLASSES[0]
    tenant = clamp_tenant(tsdb.config, tenant_raw)
    # the request's latency profile is keyed by the clamped tenant, set
    # before the verdict so that a shed request profiles under it too
    latattr.set_tenant(tenant)
    with obs_trace.stage("admission", priority=priority,
                         tenant=tenant) as span:
        if deadline is not None:
            # a request dead before admission raises its own 413 or 503
            deadline.check()
        note = None
        cost_ms = 1.0
        if (gate.enabled and gate.fair_share
                and not (deadline is not None and deadline.bounded)
                and gate.contended()):
            # the DRR drain needs a real cost while the gate is contended
            cost_ms = estimate_plan_cost_ms(tsdb, ts_query)
        if gate.enabled and deadline is not None and deadline.bounded:
            predicted_ms = estimate_plan_cost_ms(tsdb, ts_query)
            cost_ms = predicted_ms
            queue_ms = gate.queue_wait_estimate_ms()
            remaining_ms = deadline.remaining_ms()
            obs_trace.annotate(span, predicted_ms=round(predicted_ms, 3),
                               queue_wait_estimate_ms=round(queue_ms, 3),
                               remaining_ms=round(remaining_ms, 3))
            if predicted_ms + queue_ms > remaining_ms:
                if _degrade_allowed(tsdb) and not fanout:
                    note = try_degrade(tsdb, ts_query, remaining_ms,
                                       queue_ms)
                if note is None:
                    obs_trace.annotate(span, decision="shed")
                    raise gate._shed(
                        "predicted_cost",
                        "Sorry, this query's predicted cost (%d ms) cannot "
                        "fit in its remaining deadline (%d ms after an "
                        "estimated %d ms queue wait). Please decrease your "
                        "time range or coarsen the downsample interval." % (
                            predicted_ms, remaining_ms, queue_ms),
                        tenant=tenant)
                gate.count_degraded()
        t0 = time.monotonic()
        try:
            permit = gate.acquire(deadline, priority, tenant=tenant,
                                  cost_ms=cost_ms)
        except QueryException:
            latattr.mark("admission_wait")
            raise
        permit.degrade_note = note
        permit.tenant = tenant
        # everything since the parse mark (the estimate, the ladder and
        # the gate's wait) is admission
        latattr.mark("admission_wait")
        obs_trace.annotate(span, decision="degraded" if note else "admitted",
                           wait_ms=round((time.monotonic() - t0) * 1e3, 3))
    return permit


def preview(tsdb, ts_query, deadline_ms: int | None = None) -> dict:
    """The verdict ``admit`` would give this query now, for explain (the
    reference's query/explain.py ``_admission_preview``, :343): the same
    ``estimate_plan_cost_ms`` and queue-wait estimate, against
    `deadline_ms` (a what-if), else the active request deadline, else
    ``tsd.query.timeout``; the degradation ladder runs on a deep copy.
    No permit is taken and no shed or degrade is counted."""
    gate = gate_for(tsdb)
    predicted_ms = estimate_plan_cost_ms(tsdb, ts_query)
    queue_ms = gate.queue_wait_estimate_ms()
    if deadline_ms is not None:
        remaining_ms = float(deadline_ms)
    else:
        deadline = active_deadline()
        if deadline is not None and deadline.bounded:
            remaining_ms = deadline.remaining_ms()
        else:
            remaining_ms = float(tsdb.config.get_int("tsd.query.timeout"))
    bounded = remaining_ms > 0 and math.isfinite(remaining_ms)
    out = {
        "enabled": gate.enabled,
        "predictedMs": round(predicted_ms, 3),
        "queueWaitEstimateMs": round(queue_ms, 3),
        "remainingMs": round(remaining_ms, 3) if bounded else None,
        "verdict": "admit",
    }
    if gate.enabled and bounded and predicted_ms + queue_ms > remaining_ms:
        note = None
        if _degrade_allowed(tsdb):
            note = try_degrade(tsdb, copy.deepcopy(ts_query), remaining_ms,
                               queue_ms)
        if note is None:
            out["verdict"] = "shed"
            out["retryAfterS"] = gate.retry_after_s()
        else:
            out["verdict"] = "degrade"
            out["degraded"] = note
    return out


def _degrade_allowed(tsdb) -> bool:
    return tsdb.config.get_string(
        "tsd.query.degrade").strip().lower() == "allow"
