"""/api/query/explain on the port (opentsdb_tpu_torch/query/explain.py)
against the executed query and against the reference's explain, on the
CPU: the cases of tests/test_explain.py.

Parity: for every routing path (resident, batched, streamed, tiled,
refused with its structured 413, the aggregate cache's rewrite cold then
warm, the rollup lane plain and striped, the mesh) the port's explained
path and fingerprint equal those of the same query then executed through
/api/query (the runner's ``decisions``; the port has no flight recorder
before slice 8d), and the path equals the reference's explained path.
The one logged difference is the host lane, which the port does not have
(ROADMAP queue C): where the reference explains ``host_lane`` the port
explains and runs ``resident``.  The fingerprints of the two packages
differ by design (the port's has no modes and one cost table).

Also: explain runs no pipeline, builds no batch and takes no permit; its
dry-run consults change no state; the what-if grammar (an unknown key,
the refused ``platform``, ``force_*`` and ``calibration=file``, the
assume flags, ``state_mb``, ``deadline_ms``, the POST body) and the
disabled endpoint.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from opentsdb_tpu.core.tsdb import TSDB as RefTSDB
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.parallel import make_mesh
from opentsdb_tpu_torch.query import explain
from opentsdb_tpu_torch.tsd import admission
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
PROPS = {"tsd.core.auto_create_metrics": True,
         "tsd.rollup.interval": "0",
         "tsd.query.batch.enable": "false"}


def _port(mesh=None, **cfg):
    props = dict(PROPS)
    props.update({k: str(v) for k, v in cfg.items()})
    tsdb = TSDB(Config(props), device="cpu", mesh=mesh)
    return tsdb, RpcManager(tsdb)


def _ref(mesh=False, **cfg):
    props = dict(PROPS, **{"tsd.query.mesh.enable": str(mesh).lower(),
                           "tsd.stats.interval": "0"})
    props.update({k: str(v) for k, v in cfg.items()})
    tsdb = RefTSDB(RefConfig(props))
    return tsdb, RefManager(tsdb)


def feed(tsdb, metric, series=2, points=200, cadence_s=15):
    for h in range(series):
        tags = {"host": "h%d" % h}
        for k in range(points):
            tsdb.add_point(metric, BASE + k * cadence_s,
                           float((k * 7 + h) % 101), tags)


def feed_batch(tsdb, metric, series, points, cadence_s):
    for h in range(series):
        key = tsdb._series_key(metric, {"host": "h%d" % h}, create=True)
        ts = (BASE + np.arange(points, dtype=np.int64) * cadence_s) * 1000
        vals = (np.arange(points, dtype=np.int64) * 7 + h) % 101
        tsdb.store.add_batch(key, ts, vals.astype(np.float64), False)


def ask(mgr, uri, method="GET", body=None, headers=None, ref=False):
    cls = RefRequest if ref else HttpRequest
    req = cls(method=method, uri=uri, headers=headers or {}, body=body)
    q = mgr.handle_http(req, remote="127.0.0.1:9")
    raw = q.response.body
    text = raw.decode() if isinstance(raw, (bytes, bytearray)) else raw
    return q.response.status, json.loads(text) if text else None


def explain_seg(mgr, uri, ref=False):
    status, rep = ask(mgr, uri, ref=ref)
    assert status == 200, rep
    return rep, rep["subQueries"][0]["segments"][0]


def _uris(m, start, end):
    q = "start=%d&end=%d&m=%s" % (start, end, m)
    return "/api/query/explain?" + q, "/api/query?" + q


def run_and_capture(tsdb, mgr, uri, headers=None):
    """Execute `uri` through /api/query -> (status, payload, the runner's
    first routing verdict)."""
    runners = []
    make = tsdb.new_query_runner

    def capture():
        runners.append(make())
        return runners[-1]

    tsdb.new_query_runner = capture
    try:
        status, payload = ask(mgr, uri, headers=headers)
    finally:
        del tsdb.new_query_runner
    decisions = runners[-1].decisions if runners else []
    return status, payload, decisions[0] if decisions else None


def assert_parity(tsdb, mgr, m, start, end, expect_path):
    """Explain first, execute second: the explained path and fingerprint
    are the executed verdict's."""
    exp_uri, run_uri = _uris(m, start, end)
    _rep, seg = explain_seg(mgr, exp_uri)
    assert seg["path"] == expect_path, seg
    status, _payload, pd = run_and_capture(tsdb, mgr, run_uri)
    assert status == 200, _payload
    assert pd.path == seg["path"] == expect_path
    assert pd.fingerprint == seg["fingerprint"], (
        "explain-vs-executed drift:\nexplained %s\nexecuted %s"
        % (seg["provenance"], pd.fp_fields))
    assert seg["provenance"] == pd.fp_fields
    return seg


def ref_path(m, start, end, setup, mesh=False, **cfg):
    """The reference's explained path of the same query on the same
    data (`setup` feeds and warms its TSDB)."""
    tsdb, mgr = _ref(mesh=mesh, **cfg)
    try:
        setup(tsdb, mgr)
        _rep, seg = explain_seg(mgr, _uris(m, start, end)[0], ref=True)
        return seg["path"]
    finally:
        tsdb.shutdown()


def _both(setup, m, start, end, expect, ref_expect=None, mesh=False,
          **cfg):
    """Parity on the port, and the reference's explained path."""
    tsdb, mgr = _port(mesh=make_mesh(devices=["cpu"] * 8) if mesh
                      else None, **cfg)
    try:
        setup(tsdb, mgr)
        seg = assert_parity(tsdb, mgr, m, start, end, expect)
    finally:
        tsdb.shutdown()
    assert ref_path(m, start, end, setup, mesh=mesh, **cfg) \
        == (ref_expect or expect)
    return seg


def _warm_lanes(uri):
    def setup(tsdb, mgr):
        status, _ = ask(mgr, uri, ref=isinstance(tsdb, RefTSDB))
        assert status == 200
        for _ in range(60):
            if not tsdb.rollup_lanes.refresh(tsdb.store, max_blocks=256):
                break
    return setup


# -- the parity matrix ------------------------------------------------------


class TestParityMatrix:
    def test_resident(self):
        seg = _both(lambda t, _m: feed(t, "ex.res", points=300),
                    "sum:30s-avg:ex.res", BASE, BASE + 300 * 15,
                    "resident")
        # the inline build predicted warm
        assert seg["provenance"]["deviceCache"] is True
        assert seg["deviceCache"]["warm"] is True
        assert seg["costmodel"]["table"] == "cuda"
        assert seg["costmodel"]["stagesMs"]["downsample"] > 0

    def test_batched(self):
        _both(lambda t, _m: feed(t, "ex.bat", points=100),
              "sum:30s-avg:ex.bat", BASE, BASE + 1500, "batched",
              **{"tsd.query.batch.enable": "true",
                 "tsd.query.batch.amortize_factor": "1e12"})

    def test_host_lane_is_resident_on_the_port(self):
        """The logged difference: no host lane on the port."""
        _both(lambda t, _m: feed(t, "ex.hl", points=100),
              "sum:30s-avg:ex.hl", BASE, BASE + 100 * 15, "resident",
              ref_expect="host_lane",
              **{"tsd.query.device_cache.enable": "false"})

    def test_streamed(self):
        _both(lambda t, _m: feed_batch(t, "ex.str", 2, 2000, 1),
              "sum:30s-avg:ex.str", BASE, BASE + 2000, "streamed",
              **{"tsd.query.streaming.point_threshold": "500",
                 "tsd.query.device_cache.enable": "false"})

    def test_tiled(self):
        seg = _both(lambda t, _m: feed_batch(t, "ex.tl", 4, 4096, 60),
                    "sum:15s-avg:ex.tl", BASE, BASE + 4096 * 60, "tiled",
                    **{"tsd.query.streaming.point_threshold": "500",
                       "tsd.query.streaming.state_mb": "1",
                       "tsd.query.device_cache.enable": "false"})
        assert seg["tiling"]["spillBytes"] > 0
        assert seg["tiling"]["tiles"] >= 2

    def test_refused_structured_413(self):
        cfg = {"tsd.query.streaming.point_threshold": "500",
               "tsd.query.streaming.state_mb": "1",
               "tsd.query.spill.enable": "false",
               "tsd.query.device_cache.enable": "false"}
        tsdb, mgr = _port(**cfg)
        try:
            feed_batch(tsdb, "ex.rf", 4, 4096, 60)
            exp_uri, run_uri = _uris("sum:15s-avg:ex.rf", BASE,
                                     BASE + 4096 * 60)
            _rep, seg = explain_seg(mgr, exp_uri)
            assert seg["path"] == "refused"
            assert seg["refused"]["status"] == 413
            status, payload, pd = run_and_capture(tsdb, mgr, run_uri)
            assert status == 413
            # the explained refusal is the executor's envelope
            assert seg["refused"]["details"] == payload["error"]["details"]
            assert seg["refused"]["message"] == payload["error"]["message"]
            assert pd.path == "refused"
            assert pd.fingerprint == seg["fingerprint"]
        finally:
            tsdb.shutdown()
        assert ref_path("sum:15s-avg:ex.rf", BASE, BASE + 4096 * 60,
                        lambda t, _m: feed_batch(t, "ex.rf", 4, 4096, 60),
                        **cfg) == "refused"

    def test_agg_rewrite_cold_then_warm(self):
        cfg = {"tsd.query.cache.block_windows": 8,
               "tsd.query.cache.min_repeats": 1,
               "tsd.query.cache.dispatch_overhead_us": 0,
               "tsd.query.device_cache.enable": "false"}
        m = "sum:30s-avg:ex.agg"
        tsdb, mgr = _port(**cfg)
        try:
            feed_batch(tsdb, "ex.agg", 2, 3000, 1)
            seg = assert_parity(tsdb, mgr, m, BASE, BASE + 3000,
                                "agg_rewrite")
            assert seg["aggCache"]["reason"] == "cold_populate"
            assert seg["aggCache"]["coverage"] == 0.0
            seg2 = assert_parity(tsdb, mgr, m, BASE, BASE + 3000,
                                 "agg_rewrite")
            assert seg2["aggCache"]["reason"] == "reuse"
            assert seg2["aggCache"]["coverage"] > 0.5
            assert seg2["fingerprint"] != seg["fingerprint"]
        finally:
            tsdb.shutdown()
        assert ref_path(m, BASE, BASE + 3000,
                        lambda t, _m: feed_batch(t, "ex.agg", 2, 3000, 1),
                        **cfg) == "agg_rewrite"

    def test_rollup_lane(self):
        m = "sum:60s-sum:ex.lane"
        start, end = BASE + 60, BASE + 2900 * 15
        run_uri = _uris(m, start, end)[1]

        def setup(tsdb, mgr):
            feed_batch(tsdb, "ex.lane", 2, 3000, 15)
            _warm_lanes(run_uri)(tsdb, mgr)

        seg = _both(setup, m, start, end, "rollup_lane",
                    **{"tsd.rollup.enable": "true",
                       "tsd.rollup.intervals": "1m,1h"})
        assert seg["rollup"]["decision"] == "lane"
        assert seg["rollup"]["coverage"] == 1.0
        assert seg["provenance"]["lane"]["striped"] is False

    def test_rollup_lane_striped(self):
        m = "sum:60s-sum:ex.lane7"
        start, end = BASE + 60, BASE + 10080 * 60
        run_uri = _uris(m, start, end)[1]

        def setup(tsdb, mgr):
            feed_batch(tsdb, "ex.lane7", 8, 10080, 60)
            _warm_lanes(run_uri)(tsdb, mgr)

        seg = _both(setup, m, start, end, "rollup_lane",
                    **{"tsd.rollup.enable": "true",
                       "tsd.rollup.intervals": "1m,1h",
                       "tsd.query.streaming.state_mb": "1",
                       "tsd.query.device_cache.enable": "false"})
        assert seg["provenance"]["lane"]["striped"] is True

    def test_mesh(self):
        seg = _both(lambda t, _m: feed(t, "ex.mesh", series=9, points=120),
                    "sum:30s-avg:ex.mesh{host=*}", BASE, BASE + 120 * 15,
                    "mesh", mesh=True,
                    **{"tsd.query.mesh.min_series": 0})
        assert seg["provenance"]["mesh"] is True
        assert seg["shape"]["meshDevices"] == 8

    def test_degraded_preview_matches_served_degradation(self,
                                                         monkeypatch):
        tsdb, mgr = _port(**{"tsd.query.degrade": "allow"})
        feed(tsdb, "ex.deg", series=2, points=100, cadence_s=10)
        monkeypatch.setattr(
            admission, "estimate_plan_cost_ms",
            lambda tsdb_, tq: (1e9 if tq.queries[0].downsample_spec
                               .interval_ms < 40_000 else 1.0))
        try:
            status, rep = ask(
                mgr, "/api/query/explain?start=%d&end=%d&m=sum:10s-avg:"
                "ex.deg&what_if=deadline_ms=5000" % (BASE, BASE + 600))
            assert status == 200
            adm = rep["admission"]
            assert adm["verdict"] == "degrade"
            assert adm["degraded"]["coarsenedIntervalFactor"] == 4
            status, payload = ask(
                mgr, "/api/query?start=%d&end=%d&m=sum:10s-avg:ex.deg"
                % (BASE, BASE + 600), headers={"x-tsdb-deadline-ms": "5000"})
            assert status == 200
            trailer = next(e for e in payload if isinstance(e, dict)
                           and e.get("partialResults"))
            assert trailer["degraded"]["coarsenedIntervalFactor"] == 4
            # a what-if deadline the ladder cannot meet previews the shed
            monkeypatch.setattr(admission, "estimate_plan_cost_ms",
                                lambda tsdb_, tq: 1e9)
            status, rep = ask(
                mgr, "/api/query/explain?start=%d&end=%d&m=sum:10s-avg:"
                "ex.deg&what_if=deadline_ms=5000" % (BASE, BASE + 600))
            assert rep["admission"]["verdict"] == "shed"
            assert rep["admission"]["retryAfterS"] >= 1
        finally:
            tsdb.shutdown()


# -- no dispatch, no permit, no state ---------------------------------------


class TestNoDispatchNoPermit:
    def test_explain_never_dispatches_or_takes_a_permit(self, monkeypatch):
        tsdb, mgr = _port(**{"tsd.rollup.enable": "true",
                             "tsd.query.streaming.point_threshold": "500"})
        feed(tsdb, "ex.nd", series=2, points=300)
        feed_batch(tsdb, "ex.nd.big", 2, 2000, 1)
        try:
            def boom(*a, **k):
                raise AssertionError("explain dispatched device work")

            from opentsdb_tpu_torch.ops import kernels, streaming
            from opentsdb_tpu_torch.query import planner
            from opentsdb_tpu_torch.storage import device_cache as dc_mod
            for name in ("run_group_pipeline", "run_downsample_grid",
                         "run_grid_tail", "run_union_pipeline",
                         "build_batch", "build_batch_direct", "run_tiled",
                         "stream_grid", "sharded_query_pipeline",
                         "run_group_rollup_avg_pipeline"):
                monkeypatch.setattr(planner, name, boom)
            monkeypatch.setattr(dc_mod, "gather_windows", boom)
            monkeypatch.setattr(kernels, "launch", boom)
            monkeypatch.setattr(streaming.StreamAccumulator, "create", boom)
            gate = admission.gate_for(tsdb)
            admitted0, shed0 = gate.admitted, gate.shed
            dc = tsdb.device_cache
            hits0, misses0, builds0 = dc.hits, dc.misses, dc.builds
            for uri in (
                    "/api/query/explain?start=%d&end=%d"
                    "&m=sum:30s-avg:ex.nd" % (BASE, BASE + 4500),
                    "/api/query/explain?start=%d&end=%d"
                    "&m=sum:30s-avg:ex.nd.big" % (BASE, BASE + 2000),
                    "/api/query/explain?start=%d&end=%d&m=sum:ex.nd"
                    % (BASE, BASE + 4500),
                    "/api/query/explain?start=%d&end=%d"
                    "&m=max:60s-max:ex.nd&what_if=assume_rollup=warm"
                    % (BASE, BASE + 4500)):
                status, rep = ask(mgr, uri)
                assert status == 200, rep
            assert (gate.admitted, gate.shed) == (admitted0, shed0)
            assert gate.in_flight == 0
            assert (dc.hits, dc.misses, dc.builds) == (hits0, misses0,
                                                       builds0)
        finally:
            tsdb.shutdown()

    def test_explain_answers_with_every_permit_taken(self):
        tsdb, mgr = _port(**{"tsd.query.admission.permits": "0"})
        feed(tsdb, "ex.np", series=2, points=100)
        try:
            uri = "start=%d&end=%d&m=sum:30s-avg:ex.np" % (BASE, BASE + 1500)
            status, _ = ask(mgr, "/api/query?" + uri)
            assert status == 503
            status, rep = ask(mgr, "/api/query/explain?" + uri)
            assert status == 200
            assert rep["subQueries"][0]["segments"][0]["path"] == "resident"
        finally:
            tsdb.shutdown()

    def test_dry_run_consults_perturb_no_state(self):
        tsdb, mgr = _port(**{"tsd.rollup.enable": "true",
                             "tsd.query.cache.min_repeats": 2})
        feed(tsdb, "ex.dry", series=2, points=300)
        uri = ("/api/query/explain?start=%d&end=%d&m=sum:60s-sum:ex.dry"
               % (BASE, BASE + 4500))
        try:
            for _ in range(3):
                status, _ = ask(mgr, uri)
                assert status == 200
            assert tsdb.agg_cache._repeats == {}
            assert tsdb.agg_cache.rewrites == 0
            assert tsdb.rollup_lanes._demand == {}
            assert tsdb.rollup_lanes.misses == 0
            assert tsdb.device_cache.builds == 0
            assert len(tsdb.device_cache) == 0
            assert tsdb.tiled_refusals == {}
            # the executed query then records what explain did not
            status, _ = ask(mgr, uri.replace("/explain", ""))
            assert status == 200
            assert tsdb.agg_cache._repeats and tsdb.rollup_lanes._demand
        finally:
            tsdb.shutdown()

    def test_peek_answers_as_batch_for_would(self):
        tsdb, _mgr = _port()
        feed(tsdb, "ex.pk", series=3, points=80)
        try:
            runner = tsdb.new_query_runner()
            metric = tsdb.metrics.get_id("ex.pk")
            series = tsdb.store.series_for_metric(metric)
            cache = tsdb.device_cache
            args = (tsdb.store, metric, series, BASE * 1000,
                    (BASE + 1200) * 1000)
            assert cache.peek(*args) is True          # a cold inline build
            assert cache.peek(*args, build=False) is False
            assert len(cache) == 0 and cache.misses == 0
            assert cache.batch_for(*args) is not None
            assert cache.peek(*args) is True
            tsdb.add_point("ex.pk", BASE + 5, 1.0, {"host": "h0"})
            assert cache.peek(*args) is False          # stale
            assert cache.batch_for(*args) is None
            del runner
        finally:
            tsdb.shutdown()


# -- the what-if grammar and the endpoint ------------------------------------


class TestWhatIf:
    def _mgr(self):
        tsdb, mgr = _port()
        feed(tsdb, "ex.wi", series=2, points=300)
        return tsdb, mgr, ("/api/query/explain?start=%d&end=%d"
                           "&m=sum:30s-avg:ex.wi" % (BASE, BASE + 4500))

    @pytest.mark.parametrize("what_if, words", [
        ("bogus=1", "bogus"),
        ("platform=gpu", "platform must be cuda"),
        ("platform=cpu", "platform must be cuda"),
        ("platform=tpu", "platform must be cuda"),
        ("force_scan=flat", "force_scan"),
        ("force_group=matmul", "no kernel modes"),
        ("calibration=file", "calibration=file is not ported"),
        ("calibration=bogus", "calibration must be"),
        ("assume_rollup=lukewarm", "assume_rollup must be"),
        ("state_mb=-1", ">= 0"),
        ("deadline_ms=soon", "integer"),
        ("novalue", "key=value")])
    def test_refused_what_ifs_are_400_with_their_reason(self, what_if,
                                                        words):
        tsdb, mgr, uri = self._mgr()
        try:
            status, payload = ask(mgr, uri + "&what_if=" + what_if)
            assert status == 400, payload
            assert words in payload["error"]["message"]
        finally:
            tsdb.shutdown()

    def test_accepted_costmodel_what_ifs_keep_the_verdict(self):
        tsdb, mgr, uri = self._mgr()
        try:
            _, base = explain_seg(mgr, uri)
            for extra in ("&what_if=calibration=default",
                          "&what_if=calibration=auto",
                          "&what_if=platform=cuda"):
                rep, seg = explain_seg(mgr, uri + extra)
                assert seg["path"] == base["path"]
                assert seg["costmodel"]["predictedMs"] \
                    == base["costmodel"]["predictedMs"]
            rep, seg = explain_seg(mgr, uri + "&what_if=calibration=default")
            assert rep["whatIf"] == {"calibration": "default"}
            assert seg["fingerprint"] == base["fingerprint"]
            assert "costmodelWhatIf" not in seg
        finally:
            tsdb.shutdown()

    def test_assume_flags_flip_the_routing(self):
        tsdb, mgr, uri = self._mgr()
        try:
            _, seg = explain_seg(mgr, uri)
            assert seg["path"] == "resident"
            _, warm = explain_seg(mgr, uri + "&what_if=assume_agg_cache=warm")
            assert warm["path"] == "agg_rewrite"
            assert warm["aggCache"]["reason"] == "what_if_warm"
            _, cold = explain_seg(
                mgr, uri + "&what_if=assume_device_cache=cold")
            assert cold["provenance"]["deviceCache"] is False
            assert cold["path"] == "resident"
        finally:
            tsdb.shutdown()

    def test_assume_rollup_warm_flips_before_any_lane_exists(self):
        tsdb, mgr = _port(**{"tsd.rollup.enable": "true"})
        feed(tsdb, "ex.rw", series=2, points=300)
        uri = ("/api/query/explain?start=%d&end=%d&m=sum:60s-sum:ex.rw"
               % (BASE + 60, BASE + 4200))
        try:
            _, live = explain_seg(mgr, uri)
            assert live["path"] == "resident"
            assert live["rollup"]["reason"] == "cold"
            _, warm = explain_seg(mgr, uri + "&what_if=assume_rollup=warm")
            assert warm["path"] == "rollup_lane"
            assert warm["rollup"]["reason"] == "what_if_warm"
            _, off = explain_seg(mgr, uri + "&what_if=assume_rollup=warm"
                                 "&what_if=rollup_mb=0")
            assert off["path"] == "resident"
            assert off["rollup"]["reason"] == "what_if_cold"
        finally:
            tsdb.shutdown()

    def test_state_mb_what_if_previews_the_413(self):
        tsdb, mgr = _port(**{"tsd.query.streaming.point_threshold": "500",
                             "tsd.query.spill.enable": "false",
                             "tsd.query.device_cache.enable": "false"})
        feed_batch(tsdb, "ex.smb", 4, 4096, 60)
        uri = ("/api/query/explain?start=%d&end=%d&m=sum:15s-avg:ex.smb"
               % (BASE, BASE + 4096 * 60))
        try:
            _, live = explain_seg(mgr, uri)
            assert live["path"] == "streamed"
            _, tight = explain_seg(mgr, uri + "&what_if=state_mb=1")
            assert tight["path"] == "refused"
            assert tight["refused"]["details"]["limitMb"] == 1
            assert tight["budget"]["over"] is True
        finally:
            tsdb.shutdown()

    def test_disabled_explain_is_404(self):
        tsdb, mgr = _port(**{"tsd.explain.enable": "false"})
        try:
            status, _ = ask(mgr, "/api/query/explain?start=%d&m=sum:x"
                            % BASE)
            assert status == 404
        finally:
            tsdb.shutdown()

    def test_post_body_what_if(self):
        tsdb, mgr = _port()
        feed(tsdb, "ex.post", series=1, points=50)
        try:
            body = json.dumps({
                "start": BASE, "end": BASE + 750,
                "queries": [{"aggregator": "sum", "metric": "ex.post",
                             "downsample": "30s-avg"}],
                "whatIf": {"assume_agg_cache": "warm"},
            }).encode()
            status, rep = ask(mgr, "/api/query/explain", method="POST",
                              body=body,
                              headers={"content-type": "application/json"})
            assert status == 200
            assert rep["whatIf"] == {"assume_agg_cache": "warm"}
            assert rep["cluster"] is None
            assert rep["subQueries"][0]["segments"][0]["path"] \
                == "agg_rewrite"
        finally:
            tsdb.shutdown()

    def test_union_and_histogram_sub_queries_are_noted(self):
        tsdb, mgr = _port()
        feed(tsdb, "ex.un", series=2, points=40)
        try:
            status, rep = ask(mgr, "/api/query/explain?start=%d&end=%d"
                              "&m=sum:ex.un" % (BASE, BASE + 600))
            assert status == 200
            assert rep["subQueries"][0]["segments"][0]["path"] == "union"
        finally:
            tsdb.shutdown()

    def test_parse_what_if_round_trips(self):
        wi = explain.parse_what_if({"assume_rollup": "WARM",
                                    "state_mb": "12", "deadline_ms": "40"})
        assert wi.active
        assert wi.to_json() == {"assume_rollup": "warm", "state_mb": 12,
                                "deadline_ms": 40}
        assert not explain.parse_what_if({}).active
