"""Always-on latency attribution: phase stamps and keyed profiles.

Port of opentsdb_tpu/obs/latattr.py.  Tracing (obs/trace.py) says what
one request did; this module says, for EVERY request, tracing on or off,
where the serving tier's milliseconds go:

* ``PhaseStamps``: a recorder the RPC layer attaches to each HTTP
  request.  Code along the serving path calls ``mark("plan")`` at a
  phase boundary, which gives the time since the previous mark to that
  phase: two perf_counter reads and a dict add.
* ``LatencyAttribution``: folds finished stamps into bounded per-phase
  ``LogHistogram``s keyed by (route, plan fingerprint, clamped tenant),
  with exemplar trace ids, served at ``GET /api/diag/latency``
  (``?since=``, ``?fingerprint=``, ``?tenant=``; tsd/admin_rpcs.py).

The phase set is fixed: every request reports the full ordered tuple
once, unexercised phases zero.  The time between two marks belongs to
the LATER mark's phase, and repeated marks add up (a multi-segment
query's dispatches fold into one "dispatch").  The trailing "flush" mark
in RpcManager.handle_http takes the handler's tail, and the whole of a
route that stamps nothing.  A batched query's rendezvous wait holds the
leader's shared dispatch, so "batch_rendezvous" carries the batching and
the member's own "dispatch" is ~0.

Difference: the reference registers its counters and gauges in the
metrics registry (ROADMAP A, slice 8d); here they are ``collect_stats``
tallies.
"""

from __future__ import annotations

import threading
import time

from opentsdb_tpu_torch.obs.histogram import LogHistogram

# The fixed request phases in serving order.  parse: request decode and
# validation.  admission_wait: the admission gate.  plan: series
# resolution and the plan decision.  batch_rendezvous: the dispatch
# batcher (zero when unbatched).  dispatch: kernel launches and host
# compute.  device_wait: the device results brought to the host.
# serialize: response formatting.  flush: the handler's tail.
PHASES = ("parse", "admission_wait", "plan", "batch_rendezvous",
          "dispatch", "device_wait", "serialize", "flush")

# Where keys past tsd.latattr.max_profiles fold: the table stays bounded
# whatever fingerprints the query mix makes.
OVERFLOW_KEY = ("overflow", "-", "-")


class PhaseStamps:
    """One request's phase recorder, touched only by its handler thread
    (the batcher's rendezvous and the admission wait block that thread)."""

    __slots__ = ("t0", "_prev", "deltas", "phase", "route",
                 "fingerprint", "tenant", "trace_id")

    def __init__(self, trace_id: str | None = None):
        now = time.perf_counter()
        self.t0 = now
        self._prev = now
        self.deltas: dict[str, float] = {}      # phase -> seconds
        self.phase = "recv"                     # the last completed mark
        self.route = "other"
        self.fingerprint: str | None = None     # set by the planner
        self.tenant: str | None = None          # set by admission
        self.trace_id = trace_id

    def mark(self, phase: str) -> None:
        """Give the time since the previous mark to ``phase``."""
        now = time.perf_counter()
        self.deltas[phase] = self.deltas.get(phase, 0.0) + (now - self._prev)
        self._prev = now
        self.phase = phase

    def phase_ms(self) -> dict[str, float]:
        """The full ordered phase set in milliseconds, zero-filled."""
        return {p: self.deltas.get(p, 0.0) * 1e3 for p in PHASES}

    def total_ms(self) -> float:
        return (self._prev - self.t0) * 1e3


# The ambient stamps: one a handler thread.

_tls = threading.local()


def activate(stamps: PhaseStamps) -> None:
    _tls.stamps = stamps


def deactivate() -> None:
    _tls.stamps = None


def active() -> PhaseStamps | None:
    return getattr(_tls, "stamps", None)


def mark(phase: str) -> None:
    """A phase boundary of the ambient request; free outside one."""
    st = getattr(_tls, "stamps", None)
    if st is not None:
        st.mark(phase)


def set_fingerprint(fingerprint: str) -> None:
    st = getattr(_tls, "stamps", None)
    if st is not None and st.fingerprint is None:
        # the first plan decision keys a multi-segment query's profile
        st.fingerprint = fingerprint


def set_tenant(tenant: str) -> None:
    st = getattr(_tls, "stamps", None)
    if st is not None:
        st.tenant = tenant


def phase_in_flight() -> str | None:
    """The ambient request's last completed phase ("recv" before any
    mark; None outside a request)."""
    st = getattr(_tls, "stamps", None)
    return st.phase if st is not None else None


def _finite(value: float) -> float:
    return value if value == value else 0.0      # NaN (empty) -> 0


def _summary(h: LogHistogram) -> dict:
    _counts, count, total = h.snapshot()
    return {"count": count, "totalMs": total,
            "p50Ms": _finite(h.quantile(0.5)),
            "p99Ms": _finite(h.quantile(0.99))}


class _Profile:
    """One (route, fingerprint, tenant) key's streaming summary."""

    __slots__ = ("key", "count", "last_seq", "hists")

    def __init__(self, key: tuple[str, str, str]):
        self.key = key
        self.count = 0
        self.last_seq = 0
        self.hists = {p: LogHistogram() for p in PHASES}

    def to_json(self) -> dict:
        route, fingerprint, tenant = self.key
        exemplars: dict[str, list] = {}
        for p in PHASES:
            tail = [{"traceId": label, "ms": value} for _bound, label, value
                    in self.hists[p].exemplar_entries()]
            if tail:
                # the tail-most exemplars are the diagnostic ones
                exemplars[p] = tail[-3:]
        out = {"route": route, "fingerprint": fingerprint,
               "tenant": tenant, "count": self.count,
               "lastSeq": self.last_seq,
               "phases": {p: _summary(self.hists[p]) for p in PHASES}}
        if exemplars:
            out["exemplars"] = exemplars
        return out


class LatencyAttribution:
    """Folds finished PhaseStamps into bounded keyed profiles and a global
    per-phase summary, and serves both as one JSON report."""

    def __init__(self, config):
        self.max_profiles = max(
            config.get_int("tsd.latattr.max_profiles"), 1)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._profiles: dict[tuple[str, str, str], _Profile] = {}
        self._seq = 0          # guarded-by: _lock
        self._requests = 0     # guarded-by: _lock
        self._overflow = 0     # guarded-by: _lock
        # cumulative milliseconds a phase  # guarded-by: _lock
        self._phase_total_ms = {p: 0.0 for p in PHASES}
        # global per-phase histograms (LogHistogram locks itself)
        self._overall = {p: LogHistogram() for p in PHASES}

    def observe(self, stamps: PhaseStamps) -> None:
        """Fold one finished request (RpcManager.handle_http calls it
        after the trailing flush mark, on the handler thread)."""
        deltas = stamps.phase_ms()
        key = (stamps.route, stamps.fingerprint or "-",
               stamps.tenant or "default")
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._requests += 1
            profile = self._profiles.get(key)
            if profile is None:
                if len(self._profiles) >= self.max_profiles \
                        and key != OVERFLOW_KEY:
                    self._overflow += 1
                    key = OVERFLOW_KEY
                    profile = self._profiles.get(key)
                if profile is None:
                    profile = _Profile(key)
                    self._profiles[key] = profile
            profile.count += 1
            profile.last_seq = seq
            for p in PHASES:
                self._phase_total_ms[p] += deltas[p]
        for p in PHASES:
            profile.hists[p].observe(deltas[p], exemplar=stamps.trace_id)
            self._overall[p].observe(deltas[p])

    def phase_totals(self) -> dict:
        """Cumulative milliseconds a phase and the request count."""
        with self._lock:
            out = dict(self._phase_total_ms)
            out["requests"] = float(self._requests)
            return out

    def report(self, since: int = 0, fingerprint: str | None = None,
               tenant: str | None = None) -> dict:
        """The /api/diag/latency payload: profiles touched after sequence
        number ``since`` whose keys match the filters exactly.  The
        histograms are cumulative since the TSDB started."""
        with self._lock:
            seq = self._seq
            requests = self._requests
            overflow = self._overflow
            profiles = list(self._profiles.values())
        selected = []
        for profile in profiles:
            _route, key_fp, key_tenant = profile.key
            if profile.last_seq <= since:
                continue
            if fingerprint is not None and key_fp != fingerprint:
                continue
            if tenant is not None and key_tenant != tenant:
                continue
            selected.append(profile)
        selected.sort(key=lambda pr: (-pr.count, pr.key))
        return {"seq": seq, "requests": requests,
                "phases": list(PHASES),
                "profileOverflow": overflow,
                "overall": {p: _summary(self._overall[p]) for p in PHASES},
                "profiles": [pr.to_json() for pr in selected]}

    def collect_stats(self) -> dict:
        """The reference's tsd.latattr.* families as tallies."""
        with self._lock:
            out = {"tsd.latattr.requests": float(self._requests),
                   "tsd.latattr.profile_overflow": float(self._overflow),
                   "tsd.latattr.profiles": float(len(self._profiles))}
            for p in PHASES:
                out["tsd.latattr.phase_ms.%s" % p] = self._phase_total_ms[p]
        return out
