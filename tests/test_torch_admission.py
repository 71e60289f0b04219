"""Request deadlines, admission and cooperative cancellation on both
packages, on the CPU: the cases of tests/test_admission.py but its
deadline propagation to cluster peers (the port's cluster is slice 9) and
its /q graph route (not ported; the port answers 404 there).

* The Deadline primitive (a manual clock), the ambient per-thread
  deadline, QueryBudget on the request's clock, CancellationHandle: each
  case on both packages.
* The gate: permits, the queue bound, max_wait, cancellation while queued
  without a permit, priority order; on both packages.  The reference
  counts sheds in its metric registry, the port in the gate's tallies.
* The degradation ladder (a patched cost estimate, as the reference's
  tests patch it).
* End to end through both packages' RpcManager.handle_http: status,
  Retry-After and the body, with elapsed milliseconds masked.
* The port's live server: a client that hangs up while queued leaves
  without a permit; stop() cancels what is in flight at
  tsd.network.drain_timeout_ms.  A slow handler is made by patching the
  query runner (the port has no fault sites until slice 9).

Every wait is bounded; a hung thread fails its test.
"""

import asyncio
import json
import re
import socket
import threading
import time

import pytest

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.obs.registry import REGISTRY
from opentsdb_tpu.query import limits as ref_limits
from opentsdb_tpu.tsd import admission as ref_admission
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.query import limits
from opentsdb_tpu_torch.query import planner as port_planner
from opentsdb_tpu_torch.tsd import admission
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400

class _Pkg:
    """One package's side of a case: its modules and classes."""

    def __init__(self, name, lim, adm, config, tsdb, manager, request,
                 tsquery, parse):
        self.name = name
        self.limits = lim
        self.admission = adm
        self.Config = config
        self.TSDB = tsdb
        self.Manager = manager
        self.Request = request
        self.TSQuery = tsquery
        self.parse = parse


REF = _Pkg("ref", ref_limits, ref_admission, RefConfig, RefTSDB, RefManager,
           RefRequest, RefTSQuery, ref_parse)
PORT = _Pkg("port", limits, admission, Config, TSDB, RpcManager,
            HttpRequest, TSQuery, parse_m_subquery)
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


def counter_value(name: str, **labels) -> float:
    key = tuple(sorted((k, str(v)) for k, v in labels.items()))
    for fam in REGISTRY.families():
        if fam.name == name:
            for label_key, cell in fam.children():
                if label_key == key:
                    return cell.get()
    return 0.0


def shed_count(pkg, gate, reason: str) -> float:
    """Sheds by reason: the reference's registry counter, the port's gate
    tally."""
    if pkg is REF:
        return counter_value("tsd.query.admission.shed", reason=reason)
    return float(gate.shed_reasons.get(reason, 0))


class ManualClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- Deadline ----------------------------------------------------------------

@BOTH
class TestDeadline:
    def test_remaining_and_expiry(self, pkg):
        clock = ManualClock()
        d = pkg.limits.Deadline(500, clock=clock)
        assert d.bounded and d.remaining_ms() == 500
        clock.t += 0.3
        assert d.remaining_ms() == pytest.approx(200)
        assert not d.expired()
        d.check()
        clock.t += 0.3
        assert d.expired()
        with pytest.raises(pkg.limits.QueryException) as ei:
            d.check()
        assert ei.value.status == 413
        assert not isinstance(ei.value, pkg.limits.QueryCancelledException)

    def test_unbounded(self, pkg):
        d = pkg.limits.Deadline(0)
        assert not d.bounded
        assert d.remaining_ms() == float("inf")
        assert not d.expired()
        d.check()

    def test_cancel_idempotent_first_reason_wins(self, pkg):
        d = pkg.limits.Deadline(0)
        assert d.cancel("client disconnected")
        assert not d.cancel("drain")
        assert d.is_cancelled()
        assert d.cancel_reason == "client disconnected"
        with pytest.raises(pkg.limits.QueryCancelledException) as ei:
            d.check()
        assert ei.value.status == 503
        assert "client disconnected" in str(ei.value)

    def test_cancelled_beats_expired(self, pkg):
        clock = ManualClock()
        d = pkg.limits.Deadline(100, clock=clock)
        d.cancel("client disconnected")
        clock.t += 10
        with pytest.raises(pkg.limits.QueryCancelledException):
            d.check()

    def test_wait_cancelled_already_cancelled_returns_at_once(self, pkg):
        d = pkg.limits.Deadline(0)
        d.cancel("client disconnected")
        start = time.monotonic()
        assert d.wait_cancelled(10.0) is True
        assert time.monotonic() - start < 1.0

    def test_wait_cancelled_serves_the_timeout_when_nothing_happens(
            self, pkg):
        d = pkg.limits.Deadline(0)
        start = time.monotonic()
        assert d.wait_cancelled(0.02) is False
        assert time.monotonic() - start >= 0.015

    def test_wait_cancelled_clamps_to_the_remaining_budget(self, pkg):
        d = pkg.limits.Deadline(30)
        start = time.monotonic()
        assert d.wait_cancelled(10.0) is False
        assert time.monotonic() - start < 5.0

    def test_wait_cancelled_wakes_on_cancel_from_another_thread(self, pkg):
        d = pkg.limits.Deadline(0)
        timer = threading.Timer(0.05,
                                lambda: d.cancel("client disconnected"))
        timer.start()
        start = time.monotonic()
        assert d.wait_cancelled(10.0) is True
        assert time.monotonic() - start < 5.0
        timer.join(5)


@BOTH
class TestAmbientDeadline:
    def test_activate_deactivate(self, pkg):
        assert pkg.limits.active_deadline() is None
        d = pkg.limits.Deadline(100)
        pkg.limits.activate_deadline(d)
        try:
            assert pkg.limits.active_deadline() is d
        finally:
            pkg.limits.deactivate_deadline()
        assert pkg.limits.active_deadline() is None

    def test_per_thread_isolation(self, pkg):
        d = pkg.limits.Deadline(100)
        pkg.limits.activate_deadline(d)
        seen = {}

        def other():
            seen["deadline"] = pkg.limits.active_deadline()

        try:
            th = threading.Thread(target=other)
            th.start()
            th.join(5)
        finally:
            pkg.limits.deactivate_deadline()
        assert seen["deadline"] is None


@BOTH
class TestQueryBudgetDerivation:
    def test_budget_shares_request_clock(self, pkg):
        """A budget made from the request deadline expires on the
        request's clock, not a fresh one started by the planner."""
        clock = ManualClock()
        d = pkg.limits.Deadline(1000, clock=clock)
        clock.t += 0.9
        budget = pkg.limits.QueryBudget(None, "m", 0, deadline=d)
        budget.check_deadline()
        clock.t += 0.2
        with pytest.raises(pkg.limits.QueryException):
            budget.check_deadline()

    def test_budget_observes_cancellation(self, pkg):
        d = pkg.limits.Deadline(0)
        budget = pkg.limits.QueryBudget(None, "m", 0, deadline=d)
        budget.check_deadline()
        d.cancel("client disconnected")
        with pytest.raises(pkg.limits.QueryCancelledException):
            budget.check_deadline()

    def test_budget_without_deadline_unchanged(self, pkg):
        budget = pkg.limits.QueryBudget(None, "m", 60_000)
        budget.check_deadline()


@BOTH
class TestCancellationHandle:
    def test_cancel_after_bind_flips(self, pkg):
        h = pkg.admission.CancellationHandle()
        d = pkg.limits.Deadline(0)
        h.bind(d)
        assert h.cancel("client disconnected")
        assert d.is_cancelled() and h.is_cancelled()

    def test_cancel_before_bind_replays(self, pkg):
        h = pkg.admission.CancellationHandle()
        assert h.cancel("client disconnected")
        assert h.is_cancelled()
        d = pkg.limits.Deadline(0)
        h.bind(d)
        assert d.is_cancelled()
        assert d.cancel_reason == "client disconnected"

    def test_second_cancel_is_noop(self, pkg):
        h = pkg.admission.CancellationHandle()
        assert h.cancel("a")
        assert not h.cancel("b")
        d = pkg.limits.Deadline(0)
        h.bind(d)
        assert d.cancel_reason == "a"


# -- the gate ------------------------------------------------------------------

def _gate(pkg, **over):
    props = {"tsd.query.admission.enable": "true",
             "tsd.query.admission.permits": "2",
             "tsd.query.admission.queue_limit": "4",
             "tsd.query.admission.max_wait_ms": "5000"}
    props.update({k: str(v) for k, v in over.items()})
    return pkg.admission.AdmissionGate(pkg.Config(props))


@BOTH
class TestAdmissionGate:
    def test_disabled_gate_is_noop(self, pkg):
        gate = _gate(pkg, **{"tsd.query.admission.enable": "false"})
        with gate.acquire(None, "interactive"):
            assert gate.in_flight == 0

    def test_permits_bound_concurrency(self, pkg):
        gate = _gate(pkg)
        a = gate.acquire(None, "interactive")
        b = gate.acquire(None, "interactive")
        assert gate.in_flight == 2
        admitted = threading.Event()

        def third():
            with gate.acquire(None, "interactive"):
                admitted.set()

        th = threading.Thread(target=third)
        th.start()
        assert not admitted.wait(0.3)
        a.release()
        assert admitted.wait(5)
        th.join(5)
        b.release()
        assert gate.in_flight == 0

    def test_release_is_idempotent(self, pkg):
        gate = _gate(pkg)
        permit = gate.acquire(None, "interactive")
        permit.release()
        permit.release()
        assert gate.in_flight == 0

    def test_queue_full_sheds_503_with_retry_after(self, pkg):
        gate = _gate(pkg, **{"tsd.query.admission.permits": "1",
                             "tsd.query.admission.queue_limit": "0"})
        before = shed_count(pkg, gate, "queue_full")
        with gate.acquire(None, "interactive"):
            with pytest.raises(pkg.admission.ShedError) as ei:
                gate.acquire(None, "interactive")
        assert ei.value.status == 503
        assert ei.value.retry_after_s >= 1
        assert shed_count(pkg, gate, "queue_full") == before + 1

    def test_max_wait_sheds(self, pkg):
        gate = _gate(pkg, **{"tsd.query.admission.permits": "1",
                             "tsd.query.admission.max_wait_ms": "120"})
        before = shed_count(pkg, gate, "max_wait")
        t0 = time.monotonic()
        with gate.acquire(None, "interactive"):
            with pytest.raises(pkg.admission.ShedError):
                gate.acquire(None, "interactive")
        assert time.monotonic() - t0 < 5.0
        assert shed_count(pkg, gate, "max_wait") == before + 1

    def test_cancel_while_queued_releases_without_permit(self, pkg):
        gate = _gate(pkg, **{"tsd.query.admission.permits": "1"})
        d = pkg.limits.Deadline(0)
        outcome = {}

        def queued():
            try:
                gate.acquire(d, "interactive")
            except pkg.limits.QueryException as e:
                outcome["exc"] = e

        with gate.acquire(None, "interactive"):
            admitted_before = gate.admitted
            th = threading.Thread(target=queued)
            th.start()
            deadline = time.time() + 5
            while time.time() < deadline and not gate._depth_locked():
                time.sleep(0.01)
            assert gate._depth_locked() == 1
            d.cancel("client disconnected")
            th.join(5)
        assert isinstance(outcome["exc"], pkg.limits.QueryCancelledException)
        assert gate.admitted == admitted_before
        assert gate._depth_locked() == 0
        assert gate.in_flight == 0

    def test_expired_deadline_while_queued(self, pkg):
        gate = _gate(pkg, **{"tsd.query.admission.permits": "1"})
        clock = ManualClock()
        d = pkg.limits.Deadline(100, clock=clock)
        clock.t += 0.2
        with gate.acquire(None, "interactive"):
            with pytest.raises(pkg.limits.QueryException) as ei:
                gate.acquire(d, "interactive")
        assert ei.value.status == 413
        assert gate.in_flight == 0

    def test_interactive_drains_before_batch(self, pkg):
        gate = _gate(pkg, **{"tsd.query.admission.permits": "1"})
        order = []
        queued = []

        def waiter(cls):
            with gate.acquire(None, cls):
                order.append(cls)

        holder = gate.acquire(None, "interactive")
        for cls in ("batch", "interactive"):
            th = threading.Thread(target=waiter, args=(cls,))
            th.start()
            queued.append(th)
            deadline = time.time() + 5
            while time.time() < deadline \
                    and gate._depth_locked() < len(queued):
                time.sleep(0.01)
            assert gate._depth_locked() == len(queued)
        holder.release()
        for th in queued:
            th.join(5)
        assert order == ["interactive", "batch"]

    def test_unknown_priority_lands_interactive(self, pkg):
        gate = _gate(pkg)
        with gate.acquire(None, "nonsense"):
            assert gate.in_flight == 1


# -- the degradation ladder ------------------------------------------------

def _ts_query(pkg, m: str, span_s: int = 600):
    q = pkg.TSQuery(start=str(BASE), end=str(BASE + span_s),
                    queries=[pkg.parse(m)])
    q.validate()
    return q


@BOTH
class TestDegradationLadder:
    def test_coarsens_downsample_first(self, pkg, monkeypatch):
        q = _ts_query(pkg, "sum:10s-avg:adm.m")
        original_ms = q.queries[0].downsample_spec.interval_ms
        monkeypatch.setattr(
            pkg.admission, "estimate_plan_cost_ms",
            lambda tsdb, tq: 4000.0 * original_ms
            / tq.queries[0].downsample_spec.interval_ms)
        note = pkg.admission.try_degrade(None, q, budget_ms=1000.0,
                                         queue_wait_ms=0.0)
        assert note == {"coarsenedIntervalFactor": 4,
                        "coarsenedIntervalMs": original_ms * 4}
        assert q.queries[0].downsample_spec.interval_ms == original_ms * 4
        assert q.queries[0].downsample == "%dms-avg" % (original_ms * 4)
        q.validate()
        assert q.queries[0].downsample_spec.interval_ms == original_ms * 4

    def test_truncates_range_when_not_coarsenable(self, pkg, monkeypatch):
        q = _ts_query(pkg, "sum:adm.m")
        span = q.end_time - q.start_time
        monkeypatch.setattr(
            pkg.admission, "estimate_plan_cost_ms",
            lambda tsdb, tq: (tq.end_time - tq.start_time) / span * 2000.0)
        note = pkg.admission.try_degrade(None, q, budget_ms=1000.0,
                                         queue_wait_ms=0.0)
        assert note["truncatedKeepFraction"] == 0.5
        assert q.end_time - q.start_time == span // 2
        assert q.start == str(q.start_time)

    def test_returns_none_when_nothing_fits(self, pkg, monkeypatch):
        q = _ts_query(pkg, "sum:adm.m")
        monkeypatch.setattr(pkg.admission, "estimate_plan_cost_ms",
                            lambda tsdb, tq: 1e12)
        assert pkg.admission.try_degrade(None, q, budget_ms=1000.0,
                                         queue_wait_ms=0.0) is None


# -- end to end through both RpcManagers -----------------------------------

def _manager(pkg, **cfg):
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.http.show_stack_trace": False}
    if pkg is REF:
        props["tsd.query.mesh.enable"] = "false"
    props.update({k: str(v) for k, v in cfg.items()})
    tsdb = (pkg.TSDB(pkg.Config(props)) if pkg is REF
            else pkg.TSDB(pkg.Config(props), device="cpu"))
    for k in range(20):
        tsdb.add_point("adm.m", BASE + k * 15, float(k), {"host": "a"})
    return tsdb, pkg.Manager(tsdb)


def _ask(pkg, mgr, uri, headers=None):
    q = mgr.handle_http(pkg.Request(method="GET", uri=uri,
                                    headers=headers or {}))
    body = q.response.body
    text = body.decode() if isinstance(body, (bytes, bytearray)) else body
    payload = json.loads(text)
    if isinstance(payload, dict) and "error" in payload:
        payload["error"]["message"] = re.sub(
            r"\d+ ms", "N ms", payload["error"]["message"])
    return q.response.status, payload, q.response.headers.get("Retry-After")


QUERY_URI = "/api/query?start=%d&end=%d&m=sum:adm.m" % (BASE, BASE + 600)
DS_URI = ("/api/query?start=%d&end=%d&m=sum:10s-avg:adm.m"
          % (BASE, BASE + 600))


def _both_answers(cfg, uri, headers=None, patch=None, monkeypatch=None):
    """(status, payload, Retry-After) from each package, with the same
    config, request and (optionally) cost estimate."""
    got = []
    for pkg in (REF, PORT):
        if patch is not None:
            monkeypatch.setattr(pkg.admission, "estimate_plan_cost_ms",
                                patch)
        tsdb, mgr = _manager(pkg, **cfg)
        got.append(_ask(pkg, mgr, uri, headers))
        tsdb.shutdown()
    return got


class TestEndToEndAdmission:
    def test_full_queue_sheds_503_with_retry_after(self):
        ref, port = _both_answers({"tsd.query.admission.permits": "0",
                                   "tsd.query.admission.queue_limit": "0"},
                                  QUERY_URI)
        assert port == ref
        assert port[0] == 503 and int(port[2]) >= 1
        assert "full" in port[1]["error"]["message"]

    def test_predicted_cost_sheds_when_degrade_denied(self, monkeypatch):
        before = counter_value("tsd.query.admission.shed",
                               reason="predicted_cost")
        ref, port = _both_answers({"tsd.query.timeout": "5000"}, QUERY_URI,
                                  patch=lambda *_: 1e9,
                                  monkeypatch=monkeypatch)
        assert port == ref
        assert port[0] == 503 and port[2] is not None
        assert "predicted cost" in port[1]["error"]["message"]
        assert counter_value("tsd.query.admission.shed",
                             reason="predicted_cost") == before + 1

    def test_degrade_allow_answers_200_partial(self, monkeypatch):
        ref, port = _both_answers(
            {"tsd.query.degrade": "allow"}, DS_URI,
            headers={"x-tsdb-deadline-ms": "5000"},
            patch=lambda _t, tq: (1e9 if tq.queries[0].downsample_spec
                                  .interval_ms < 40_000 else 1.0),
            monkeypatch=monkeypatch)
        assert port == ref
        assert port[0] == 200
        trailer = [e for e in port[1] if e.get("partialResults")]
        assert trailer and trailer[0]["degraded"][
            "coarsenedIntervalFactor"] == 4
        assert [e for e in port[1] if "metric" in e][0]["dps"]

    def test_admitted_query_unaffected(self):
        ref, port = _both_answers({}, QUERY_URI,
                                  headers={"x-tsdb-deadline-ms": "60000"})
        assert port == ref
        assert port[0] == 200 and port[2] is None
        assert not any(e.get("partialResults") for e in port[1])

    def test_permit_outlives_the_handler_until_the_reply_is_written(self):
        """Under the server (a request with ``after_write`` hooks) the
        query keeps its permit after the handler returns, until the
        server runs the hooks once the reply is written; called directly,
        the handler's exit releases it."""
        tsdb, mgr = _manager(PORT)
        gate = tsdb.admission_gate
        request = PORT.Request(method="GET", uri=QUERY_URI)
        request.after_write = []
        q = mgr.handle_http(request)
        assert q.response.status == 200
        assert gate.in_flight == 1 and len(request.after_write) == 1
        for hook in request.after_write:
            hook()
        assert gate.in_flight == 0
        assert _ask(PORT, mgr, QUERY_URI)[0] == 200
        assert gate.in_flight == 0
        tsdb.shutdown()

    def test_fanout_subrequest_sheds_instead_of_degrading(self,
                                                          monkeypatch):
        ref, port = _both_answers(
            {"tsd.query.degrade": "allow"}, DS_URI,
            headers={"x-tsdb-deadline-ms": "5000",
                     "x-tsdb-cluster": "fanout"},
            patch=lambda *_: 1e9, monkeypatch=monkeypatch)
        assert port == ref
        assert port[0] == 503 and port[2] is not None

    @BOTH
    def test_mint_deadline_takes_min_of_config_and_header(self, pkg):
        tsdb, mgr = _manager(pkg, **{"tsd.query.timeout": "10000"})
        req = pkg.Request(method="GET", uri=QUERY_URI,
                          headers={"x-tsdb-deadline-ms": "500"})
        assert mgr._mint_deadline(req).timeout_ms == 500
        req = pkg.Request(method="GET", uri=QUERY_URI, headers={})
        assert mgr._mint_deadline(req).timeout_ms == 10000
        tsdb2, mgr2 = _manager(pkg)
        req = pkg.Request(method="GET", uri=QUERY_URI,
                          headers={"x-tsdb-deadline-ms": "700"})
        assert mgr2._mint_deadline(req).timeout_ms == 700
        req = pkg.Request(method="GET", uri=QUERY_URI,
                          headers={"x-tsdb-deadline-ms": "garbage"})
        assert not mgr2._mint_deadline(req).bounded

    @BOTH
    def test_mint_deadline_rejects_non_finite_header(self, pkg):
        tsdb, mgr = _manager(pkg)
        for bad in ("inf", "Infinity", "1e309", "nan", "-inf"):
            req = pkg.Request(method="GET", uri=QUERY_URI,
                              headers={"x-tsdb-deadline-ms": bad})
            assert not mgr._mint_deadline(req).bounded, bad

    @BOTH
    def test_ambient_deadline_cleared_after_request(self, pkg):
        tsdb, mgr = _manager(pkg)
        _ask(pkg, mgr, QUERY_URI, headers={"x-tsdb-deadline-ms": "60000"})
        assert pkg.limits.active_deadline() is None


# -- the port's live server --------------------------------------------------

def _spawn_server(cfg: dict):
    from opentsdb_tpu_torch.tsd.server import TSDServer
    props = {"tsd.core.auto_create_metrics": True}
    props.update(cfg)
    tsdb = TSDB(Config(props), device="cpu")
    for k in range(20):
        tsdb.add_point("adm.m", BASE + k * 15, float(k), {"host": "a"})
    srv = TSDServer(tsdb, port=0, bind="127.0.0.1", worker_threads=4)
    started = threading.Event()
    stopped = threading.Event()
    holder = {}

    def run():
        async def main():
            await srv.start()
            holder["loop"] = asyncio.get_running_loop()
            started.set()
            await srv.serve_forever()
            # set inside the loop: asyncio.run's teardown joins the
            # default executor, which a wedged handler would hold
            stopped.set()
        asyncio.run(main())
        stopped.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert started.wait(10)
    return srv, holder, stopped


def _http_get(port, path, timeout=30):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _slow_first_run(monkeypatch, seconds: float):
    """The first query run sleeps `seconds` inside its permit, without
    looking at its deadline (a wedged handler)."""
    orig = port_planner.QueryRunner.run
    calls = []

    def run(self, query):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(seconds)
        return orig(self, query)

    monkeypatch.setattr(port_planner.QueryRunner, "run", run)


class TestClientDisconnect:
    def test_disconnected_query_releases_without_dispatching(self,
                                                             monkeypatch):
        """B queues behind A's permit and hangs up: B's token flips and B
        leaves the queue without being admitted; only A runs."""
        _slow_first_run(monkeypatch, 2.5)
        srv, holder, stopped = _spawn_server({
            "tsd.query.admission.permits": "1",
            "tsd.query.admission.max_wait_ms": "30000"})
        gate = srv.tsdb.admission_gate
        a_result = {}

        def client_a():
            a_result["resp"] = _http_get(srv.port, QUERY_URI)

        try:
            ta = threading.Thread(target=client_a)
            ta.start()
            deadline = time.time() + 5
            while time.time() < deadline and gate.in_flight < 1:
                time.sleep(0.01)
            assert gate.in_flight == 1
            sock = socket.create_connection(("127.0.0.1", srv.port),
                                            timeout=10)
            sock.sendall(("GET %s HTTP/1.1\r\nHost: x\r\n\r\n"
                          % QUERY_URI).encode())
            deadline = time.time() + 5
            while time.time() < deadline and not gate._depth_locked():
                time.sleep(0.01)
            assert gate._depth_locked() == 1
            sock.close()
            deadline = time.time() + 5
            while time.time() < deadline and not gate.cancelled.get(
                    "client_disconnect"):
                time.sleep(0.02)
            assert gate.cancelled.get("client_disconnect") == 1
            ta.join(15)
            assert a_result["resp"][0] == 200
            assert gate.admitted == 1
            # A's permit is released once its reply is written, which the
            # client may see a moment before the server's loop goes on
            deadline = time.time() + 5
            while time.time() < deadline and gate.in_flight:
                time.sleep(0.01)
            assert gate.in_flight == 0
        finally:
            holder["loop"].call_soon_threadsafe(srv._shutdown_event.set)
            stopped.wait(15)


class TestBoundedDrain:
    def test_stop_cancels_at_drain_timeout(self, monkeypatch):
        """A wedged responder must not hold shutdown: at
        tsd.network.drain_timeout_ms every in-flight token flips (the
        queued query unwinds) and teardown goes on after the short grace,
        though the wedged handler never looks at its token."""
        from opentsdb_tpu_torch.tsd import server as server_mod
        monkeypatch.setattr(server_mod, "POST_CANCEL_GRACE_S", 1.0)
        _slow_first_run(monkeypatch, 9.0)
        srv, holder, stopped = _spawn_server({
            "tsd.query.admission.permits": "1",
            "tsd.query.admission.max_wait_ms": "0",
            "tsd.network.drain_timeout_ms": "300"})
        gate = srv.tsdb.admission_gate
        results = []

        def client(tag):
            try:
                results.append((tag, _http_get(srv.port, QUERY_URI)))
            except OSError:
                results.append((tag, None))

        ta = threading.Thread(target=client, args=("a",), daemon=True)
        ta.start()
        deadline = time.time() + 5
        while time.time() < deadline and gate.in_flight < 1:
            time.sleep(0.01)
        tb = threading.Thread(target=client, args=("b",), daemon=True)
        tb.start()
        deadline = time.time() + 5
        while time.time() < deadline and not gate._depth_locked():
            time.sleep(0.01)
        assert gate._depth_locked() == 1
        t0 = time.monotonic()
        holder["loop"].call_soon_threadsafe(srv._shutdown_event.set)
        assert stopped.wait(10), "stop() did not come back"
        stop_s = time.monotonic() - t0
        # 0.3 s drain + 1 s grace + the <= 5 s reply-flush wait: under the
        # 9 s wedge
        assert stop_s < 7.5, stop_s
        assert gate.cancelled.get("drain_timeout", 0) >= 1
