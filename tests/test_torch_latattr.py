"""Always-on latency attribution in the port (obs/latattr.py): the cases
of tests/test_latattr.py, with the reference beside the port where both
serve the same routes.

Every HTTP request, tracing on or off, reports the full ordered phase set
once with non-negative deltas, folded into profiles keyed by (route,
plan fingerprint, tenant) and served at /api/diag/latency.  Not carried
over: the reference's 3% overhead pin (a timing bound on a shared CPU is
not a parity check), its flight-recorder cases (ROADMAP A, slice 8d) and
its expression routes (the port answers 501 there, which still folds
one profile).
"""

from __future__ import annotations

import json

import pytest

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.obs.latattr import PHASES as REF_PHASES
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.obs import latattr
from opentsdb_tpu_torch.obs.histogram import LogHistogram
from opentsdb_tpu_torch.obs.latattr import (
    OVERFLOW_KEY, PHASES, LatencyAttribution, PhaseStamps)
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
CFG = {"tsd.core.auto_create_metrics": True}


def _ingest(tsdb):
    for host in ("web01", "web02"):
        for i in range(200):
            tsdb.add_point("la.cpu", BASE + i * 10, float(i),
                           {"host": host})
    return tsdb


@pytest.fixture
def served():
    tsdb = _ingest(TSDB(Config(CFG), device="cpu"))
    return tsdb, RpcManager(tsdb)


def ask(manager, uri, method="GET", body=None, headers=None,
        request_cls=HttpRequest):
    return manager.handle_http(
        request_cls(method=method, uri=uri, body=body,
                    headers=headers or {}),
        remote="127.0.0.1:9").response


def latency_report(manager, qs="", request_cls=HttpRequest):
    response = ask(manager, "/api/diag/latency" + qs,
                   request_cls=request_cls)
    assert response.status == 200
    return json.loads(response.body)


QUERY_URI = ("/api/query?start=%d&end=%d&m=sum:30s-avg:la.cpu{host=*}"
             % (BASE, BASE + 2_000))
EXPLAIN_URI = ("/api/query/explain?start=%d&end=%d&m=sum:la.cpu"
               % (BASE, BASE + 2_000))
PUT_BODY = json.dumps([{"metric": "la.cpu", "timestamp": BASE + 9_000,
                        "value": 1.5, "tags": {"host": "web09"}}]
                      ).encode()


def test_phases_are_the_reference_set():
    assert PHASES == REF_PHASES


def test_marks_accumulate_into_the_later_phase():
    stamps = PhaseStamps()
    stamps.mark("parse")
    stamps.mark("plan")
    stamps.mark("plan")            # multi-segment: deltas add up
    ms = stamps.phase_ms()
    assert list(ms) == list(PHASES)
    assert all(v >= 0.0 for v in ms.values())
    assert ms["dispatch"] == 0.0   # unexercised phases zero-fill
    assert stamps.total_ms() >= sum(ms.values()) - 1e-6


def test_ambient_stamps_follow_the_handler_thread():
    assert latattr.active() is None
    latattr.mark("plan")           # free outside a request
    stamps = PhaseStamps(trace_id="t-1")
    latattr.activate(stamps)
    try:
        assert latattr.phase_in_flight() == "recv"
        latattr.mark("parse")
        assert latattr.phase_in_flight() == "parse"
        latattr.set_tenant("acme")
        latattr.set_fingerprint("pf-1")
        latattr.set_fingerprint("pf-2")   # the first plan wins
    finally:
        latattr.deactivate()
    assert stamps.tenant == "acme"
    assert stamps.fingerprint == "pf-1"
    assert latattr.phase_in_flight() is None


ROUTES = [
    ("GET", QUERY_URI, None, 200),
    ("GET", EXPLAIN_URI, None, 200),
    ("POST", "/api/put", PUT_BODY, 204),
    ("GET", "/api/diag", None, 501),
]


def _check_complete(report, n):
    assert report["requests"] == n
    assert report["phases"] == list(PHASES)
    assert sum(p["count"] for p in report["profiles"]) == n
    for profile in report["profiles"]:
        assert list(profile["phases"]) == list(PHASES), profile
        for phase, summary in profile["phases"].items():
            assert summary["count"] == profile["count"], \
                (profile["route"], phase)
            assert summary["totalMs"] >= 0.0
            assert summary["p99Ms"] >= summary["p50Ms"] >= 0.0


def test_every_route_reports_the_full_phase_set_once(served):
    tsdb, manager = served
    for method, uri, body, status in ROUTES:
        assert ask(manager, uri, method=method, body=body).status == status
    report = latency_report(manager)
    # one fold a request; the report's own fetch folds after its reply
    _check_complete(report, len(ROUTES))
    assert {p["route"] for p in report["profiles"]} \
        == {"api/query", "api/put", "api/diag"}
    assert tsdb.collect_stats()["tsd.latattr.requests"] == len(ROUTES) + 1


def test_the_reference_reports_the_same_profiles():
    """A query and a put through both packages: the same phase set, the
    same routes, tenants and counts."""
    ref = _ingest(RefTSDB(RefConfig({**CFG, "tsd.query.mesh.enable":
                                     False})))
    ref_manager, port_manager = RefManager(ref), RpcManager(
        _ingest(TSDB(Config(CFG), device="cpu")))
    reports = []
    for manager, cls in ((ref_manager, RefRequest),
                         (port_manager, HttpRequest)):
        for method, uri, body, _ in (ROUTES[0], ROUTES[2], ROUTES[0]):
            ask(manager, uri, method=method, body=body, request_cls=cls)
        reports.append(latency_report(manager, request_cls=cls))
    want, got = reports
    _check_complete(got, 3)
    assert got["phases"] == want["phases"]
    assert sorted((p["route"], p["tenant"], p["count"])
                  for p in got["profiles"]) \
        == sorted((p["route"], p["tenant"], p["count"])
                  for p in want["profiles"])


def test_query_phases_land_where_the_work_happened(served):
    tsdb, manager = served
    assert ask(manager, QUERY_URI).status == 200
    report = latency_report(manager)
    (profile,) = [p for p in report["profiles"]
                  if p["route"] == "api/query"]
    assert profile["fingerprint"].startswith("pf-")
    assert profile["tenant"] == "default"
    for phase in ("parse", "plan", "serialize"):
        assert profile["phases"][phase]["totalMs"] > 0.0, phase
    assert sum(v["totalMs"] for v in profile["phases"].values()) > 0.0


def test_tenant_header_keys_the_profile(served):
    tsdb, manager = served
    tsdb.config.override_config("tsd.diag.tenants", "acme")
    assert ask(manager, QUERY_URI,
               headers={"x-tsdb-tenant": "acme"}).status == 200
    report = latency_report(manager, "?tenant=acme")
    assert [p["tenant"] for p in report["profiles"]] == ["acme"]


def test_histograms_populate_with_tracing_off(served):
    tsdb, manager = served
    tsdb.config.override_config("tsd.trace.enable", False)
    assert ask(manager, QUERY_URI).status == 200
    report = latency_report(manager)
    assert report["requests"] == 1
    (profile,) = [p for p in report["profiles"]
                  if p["route"] == "api/query"]
    assert profile["phases"]["plan"]["totalMs"] > 0.0
    assert "exemplars" not in profile


def test_exemplars_link_traced_requests(served):
    tsdb, manager = served
    response = ask(manager, QUERY_URI,
                   headers={"x-tsdb-trace-id": "la-exemplar-1"})
    assert response.status == 200
    report = latency_report(manager)
    (profile,) = [p for p in report["profiles"]
                  if p["route"] == "api/query"]
    traced = {e["traceId"] for tail in profile["exemplars"].values()
              for e in tail}
    assert traced == {"la-exemplar-1"}


def test_since_and_filters(served):
    tsdb, manager = served
    assert ask(manager, QUERY_URI).status == 200
    report = latency_report(manager)
    seq = report["seq"]
    incremental = latency_report(manager, "?since=%d" % seq)
    assert all(p["lastSeq"] > seq for p in incremental["profiles"])
    assert {p["route"] for p in incremental["profiles"]} == {"api/diag"}
    fingerprint = [p["fingerprint"] for p in report["profiles"]
                   if p["fingerprint"] != "-"][0]
    narrowed = latency_report(
        manager, "?fingerprint=%s" % fingerprint)["profiles"]
    assert narrowed and all(p["fingerprint"] == fingerprint
                            for p in narrowed)
    assert latency_report(manager, "?tenant=absent")["profiles"] == []


def test_bad_since_is_a_400(served):
    _tsdb, manager = served
    assert ask(manager, "/api/diag/latency?since=zap").status == 400


def test_disabled_engine_is_a_404(served):
    tsdb, manager = served
    tsdb.latattr = None
    assert ask(manager, "/api/diag/latency").status == 404
    off = TSDB(Config({**CFG, "tsd.latattr.enable": False}), device="cpu")
    assert off.latattr is None
    assert ask(RpcManager(off), "/api/diag/latency").status == 404


@pytest.mark.parametrize("uri", ["/api/diag", "/api/diag/slow",
                                 "/api/diag/health"])
def test_other_diag_routes_answer_501(served, uri):
    _tsdb, manager = served
    response = ask(manager, uri)
    assert response.status == 501
    assert "slice 8d" in json.loads(response.body)["error"]["details"]


def _stamps(route, fingerprint):
    stamps = PhaseStamps()
    stamps.mark("parse")
    stamps.route = route
    stamps.fingerprint = fingerprint
    return stamps


def test_overflow_collapses_into_one_profile():
    engine = LatencyAttribution(Config({"tsd.latattr.max_profiles": 2}))
    for i in range(5):
        engine.observe(_stamps("api/query", "pf-%d" % i))
    report = engine.report()
    assert report["requests"] == 5
    assert report["profileOverflow"] == 3
    keys = {(p["route"], p["fingerprint"], p["tenant"])
            for p in report["profiles"]}
    assert OVERFLOW_KEY in keys
    assert len(keys) == 3          # 2 real and the overflow bucket
    (overflow,) = [p for p in report["profiles"]
                   if p["route"] == OVERFLOW_KEY[0]]
    assert overflow["count"] == 3
    assert engine.collect_stats()["tsd.latattr.profile_overflow"] == 3.0


def test_phase_totals_count_every_phase():
    engine = LatencyAttribution(Config({}))
    engine.observe(_stamps("api/query", "pf-a"))
    totals = engine.phase_totals()
    assert totals["requests"] == 1.0
    assert totals["parse"] >= 0.0
    assert set(totals) == set(PHASES) | {"requests"}


def test_log_histogram_matches_the_reference():
    """The copied LogHistogram buckets and estimates as the reference's."""
    from opentsdb_tpu.obs.histogram import LogHistogram as RefHistogram
    ours, ref = LogHistogram(), RefHistogram()
    for i, v in enumerate([0.0, 0.0004, 0.02, 0.5, 1.0, 3.7, 12.0, 250.0,
                           9e4, 2e8]):
        ours.observe(v, exemplar="x%d" % i)
        ref.observe(v, exemplar="x%d" % i)
    assert ours.snapshot() == ref.snapshot()
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.exemplar_entries() == ref.exemplar_entries()
    with pytest.raises(ValueError):
        ours.observe(float("nan"))
