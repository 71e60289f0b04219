"""Mesh-served /api/query on the port against the reference's meshed TSDB.

A port TSDB with ``mesh=make_mesh(devices=["cpu"] * 8)`` and the
reference's TSDB over conftest's 8 virtual CPU devices, both with
``tsd.query.mesh.min_series`` 0, hold tests/test_mesh_query.py's fixture
(12 hosts in 3 dcs).  Every query of its MOMENT_QUERIES and
ORDERED_QUERIES, plus squareSum, a group movingAverage, a wide group-by
and the none aggregator, answers as the reference's meshed TSDB within
1e-9 (its assert_equivalent) and as the port's single-device TSDB: as a
materialized batch with the cache off, as a device-cache hit re-laid over
the shards, streamed, and over HTTP on a socket.  Beside them: the
routing verdict's ``mesh`` path and fingerprint field against the
reference's, fewer than ``min_series`` series staying off the mesh, the
rollup job over a mesh writing the reference's cells, and the refusals
(a mixed-placement mesh, a mesh away from the TSDB's device,
``tsd.network.distributed.*``).
"""

import json
import urllib.parse
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.query import plandecision as ref_pdn
from opentsdb_tpu.rollup.job import run_rollup_job as ref_rollup_job
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.parallel import make_mesh
from opentsdb_tpu_torch.query import plandecision as pdn
from opentsdb_tpu_torch.rollup.job import run_rollup_job
from opentsdb_tpu_torch.utils.config import Config

from test_mesh_query import (MOMENT_QUERIES, ORDERED_QUERIES, START,
                             _ingest, _mk_tsdb, assert_equivalent)
from test_torch_plandecision import (BASE_CTX, REF_ONLY_CTX, _Consults,
                                     _tsdb)
from test_torch_tsd import _Serving

EXTRA_QUERIES = ["squareSum:1m-avg:sys.cpu.user{dc=*}",
                 "movingAverage3:1m-sum:sys.cpu.user{dc=*}",
                 "avg:1m-avg:sys.cpu.user{host=*}",
                 "none:1m-avg:sys.cpu.user{host=literal_or(web01)}",
                 "dev:1m-sum:rate:sys.cpu.user{dc=*}"]
ALL_QUERIES = MOMENT_QUERIES + ORDERED_QUERIES + EXTRA_QUERIES
PROPS = {"tsd.core.auto_create_metrics": True,
         "tsd.query.mesh.min_series": 0,
         "tsd.http.show_stack_trace": False}


def _port(mesh=True, **over):
    tsdb = TSDB(Config(dict(PROPS, **over)), device="cpu",
                mesh=make_mesh(devices=["cpu"] * 8) if mesh else None)
    _ingest(tsdb)
    return tsdb


def _run(tsdb, m, start=START, end=START + 600):
    q = TSQuery(start=str(start), end=str(end),
                queries=[parse_m_subquery(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    return [r.to_json() for r in runner.run(q)], runner


@pytest.fixture(scope="module")
def trio():
    """The port meshed (cache on), the port on one device, and the
    reference meshed."""
    ref = _mk_tsdb(True)
    _ingest(ref)
    assert ref.query_mesh() is not None
    return _port(), _port(mesh=False), ref


@pytest.fixture(scope="module")
def ref_answers(trio):
    """The reference's meshed answer to each query, computed once."""
    ref = trio[2]
    return {m: _ref_run(ref, m) for m in ALL_QUERIES}


def _ref_run(ref, m):
    from opentsdb_tpu.models import TSQuery as RefTSQuery
    from opentsdb_tpu.models import parse_m_subquery as ref_parse
    q = RefTSQuery(start=str(START), end=str(START + 600),
                   queries=[ref_parse(m)])
    q.validate()
    return [r.to_json() for r in ref.new_query_runner().run(q)]


@pytest.mark.parametrize("m", ALL_QUERIES)
def test_meshed_port_matches_reference_and_single_device(trio, ref_answers,
                                                         m):
    """Twice: the first run builds the cache entry inline (the host
    batch), the second is a device-cache hit re-laid over the shards."""
    meshed, single, _ = trio
    for attempt in range(2):
        got, runner = _run(meshed, m)
        assert runner.exec_stats["meshDevices"] == 8.0
        assert [d.path for d in runner.decisions] == ["mesh"]
        assert_equivalent(got, ref_answers[m])
        assert_equivalent(got, _run(single, m)[0])
    assert runner.exec_stats.get("deviceCacheHit") == 1.0


def test_cache_off_mesh_serves_the_host_batch(trio, ref_answers):
    meshed_nocache = _port(**{"tsd.query.device_cache.enable": False})
    for m in ("avg:1m-avg:sys.cpu.user{dc=*}",
              "count:1m-avg-zero:sys.cpu.user{dc=*}",
              "p99:rate:1m-avg:sys.cpu.user{dc=*}"):
        got, runner = _run(meshed_nocache, m)
        assert "deviceCacheHit" not in runner.exec_stats
        assert runner.exec_stats["meshDevices"] == 8.0
        assert_equivalent(got, ref_answers.get(m) or _ref_run(trio[2], m))


def test_integer_data_equals_single_device_bit_for_bit():
    """Integer points through a sum downsample: every partial is exact,
    so sum, count, min, max and avg over the mesh are the single-device
    answers bit for bit, on the host batch and on a cache hit."""
    def ingest(tsdb):
        rng = np.random.default_rng(3)
        for h in range(12):
            tags = {"host": "h%02d" % h, "dc": "dc%d" % (h % 3)}
            for k in range(40):
                tsdb.add_point("ints", START + k * 10 + h % 3,
                               int(rng.integers(-500, 500)), tags)

    meshed = TSDB(Config(PROPS), device="cpu",
                  mesh=make_mesh(devices=["cpu"] * 8))
    single = TSDB(Config(PROPS), device="cpu")
    ingest(meshed)
    ingest(single)
    for agg in ("sum", "count", "min", "max", "avg"):
        m = "%s:1m-sum:ints{dc=*}" % agg
        want, _ = _run(single, m)
        for _ in range(2):
            got, _ = _run(meshed, m)
            assert json.dumps(got, sort_keys=True) == json.dumps(
                want, sort_keys=True)


@pytest.fixture(scope="module")
def streamed_port():
    """A meshed port TSDB whose every grouped query streams."""
    return _port(**{"tsd.query.streaming.point_threshold": 10,
                    "tsd.query.streaming.chunk_points": 64,
                    "tsd.query.device_cache.enable": False})


@pytest.mark.parametrize("m", ALL_QUERIES)
def test_streamed_mesh_matches_reference(streamed_port, ref_answers, m):
    """Past a lowered point threshold a cache miss streams, each shard
    folding its rows; the answers equal the reference's meshed ones."""
    got, runner = _run(streamed_port, m)
    assert runner.exec_stats["streamedChunks"] >= 1
    assert runner.exec_stats["meshDevices"] == 8.0
    assert [d.path for d in runner.decisions] == ["streamed"]
    assert runner.decisions[0].fp_fields["mesh"] is True
    assert_equivalent(got, ref_answers[m])


@pytest.fixture(scope="module")
def http_port():
    """The port's daemon on a socket over a meshed TSDB."""
    with _Serving(_port()) as server:
        yield server


@pytest.mark.parametrize("m", ALL_QUERIES)
def test_http_query_served_from_the_mesh(trio, http_port, m):
    """GET /api/query on a socket of the port's daemon over a meshed TSDB
    against the reference's handler on its meshed TSDB."""
    uri = "/api/query?start=%d&end=%d&m=%s" % (
        START, START + 600, urllib.parse.quote(m, safe=":-=*,()|"))
    q = RefManager(trio[2]).handle_http(
        RefRequest(method="GET", uri=uri, body=b"", headers={}),
        remote="127.0.0.1:55")
    assert q.response.status == 200
    want = json.loads(q.response.body)
    with urllib.request.urlopen("http://127.0.0.1:%d%s"
                                % (http_port.port, uri), timeout=30) as r:
        assert r.status == 200
        got = json.loads(r.read())
    assert got
    assert_equivalent(got, want)


def test_fewer_than_min_series_stay_off_the_mesh():
    tsdb = _port(**{"tsd.query.mesh.min_series": 8,
                    "tsd.query.batch.enable": False})
    _, runner = _run(tsdb, "sum:1m-avg:sys.cpu.user{host=literal_or("
                     "web01|web02|web03)}")
    assert "meshDevices" not in runner.exec_stats
    assert runner.decisions[0].path == "resident"
    assert runner.decisions[0].fp_fields["mesh"] is False
    _, runner = _run(tsdb, "sum:1m-avg:sys.cpu.user")
    assert runner.decisions[0].path == "mesh"
    off = _port(**{"tsd.query.mesh.enable": False})
    assert off.query_mesh() is None
    assert TSDB(Config(PROPS), device="cpu").query_mesh() is None


# the meshed arms of the routing matrix: (context overrides, subsystems,
# consult answers, path)
MESH_MATRIX = {
    "mesh": (dict(), {}, {}, "mesh"),
    "mesh, cache hit": (dict(), {"cache": True}, {"cache": True}, "mesh"),
    "mesh skips lanes, agg and batching": (
        dict(batch_ok=True, batch_factor=1e12),
        {"lanes": True, "agg": True, "cache": True},
        {"lane": True, "agg": True}, "mesh"),
    "mesh streams": (dict(total_points=9_000_000), {"cache": True}, {},
                     "streamed"),
    "mesh, rollup_avg": (dict(seg_kind="rollup_avg", stream_ok=False,
                              store_is_raw=False), {}, {}, "rollup_avg"),
    "mesh budget per chip": (dict(s=4096, wp=16384, state_mb=1024,
                                  groups=8, g_pad=8), {}, {}, "mesh"),
    "mesh over its per-chip budget": (
        dict(s=4096, wp=131072, state_mb=1024, groups=8, g_pad=8),
        {}, {"tiled": True}, "tiled"),
}


@pytest.mark.parametrize("name", list(MESH_MATRIX))
def test_plan_decision_mesh_arm_matches_reference(name):
    over, parts, answers, want = MESH_MATRIX[name]
    fields = dict(BASE_CTX, **over)
    decisions, calls = [], []
    for ref, mod in ((True, ref_pdn), (False, pdn)):
        consults = _Consults(answers, ref)
        if ref:
            ctx = mod.RouteContext(**dict(fields, **dict(
                REF_ONLY_CTX, use_mesh=True, n_chips=8)))
        else:
            ctx = mod.RouteContext(**fields, use_mesh=True, n_chips=8)
        decisions.append(mod.plan_decision(_tsdb(ref, parts), ctx,
                                           consults))
        calls.append(consults.calls)
    ref, port = decisions
    assert ref.path == port.path == want
    strip = lambda f: {k: v for k, v in f.items()  # noqa: E731
                       if k not in ("modes", "calibration")}
    assert strip(port.fp_fields) == strip(ref.fp_fields)
    assert port.fp_fields["mesh"] is True
    assert calls[1] == calls[0]


def test_executed_mesh_verdict_matches_the_reference(trio):
    """The executed verdict's path and fingerprint `mesh` field, and the
    reference's plan event for the same query."""
    meshed, _, ref = trio
    m = "max:1m-min:sys.cpu.user{dc=*}"
    _, runner = _run(meshed, m)
    pd = runner.decisions[0]
    seq = ref.flightrec.latest_seq()
    _ref_run(ref, m)
    plans = [e for e in ref.flightrec.events(since=seq)
             if e.get("kind") == "plan"]
    assert plans and plans[-1]["path"] == pd.path == "mesh"
    assert pd.fp_fields["mesh"] is True


def test_rollup_job_over_a_mesh_writes_the_reference_cells():
    """The job over a (4, 2) mesh writes the reference's cells (its mesh
    over the 8 virtual devices), and over one device what it writes
    without a mesh."""
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.rollups.enable": True, "tsd.query.mesh.enable": True}
    ref = RefTSDB(RefConfig(props))
    meshed = TSDB(Config(props), device="cpu")
    one = TSDB(Config(props), device="cpu")
    for tsdb in (ref, meshed, one):
        _ingest(tsdb, n_hosts=10, n_points=400)
    assert ref_rollup_job(ref, intervals=["1m"]) == run_rollup_job(
        meshed, intervals=["1m"], mesh=make_mesh(devices=["cpu"] * 8,
                                                 shape=(4, 2)))
    assert run_rollup_job(one, intervals=["1m"]) == run_rollup_job(
        one, intervals=["1m"], mesh=make_mesh(devices=["cpu"]))
    for lane in ("sum", "count", "min", "max"):
        got = {meshed.tsuid(x.key): x.arrays()
               for x in meshed.rollup_store.lane("1m", lane).all_series()}
        want = {ref.tsuid(x.key): x.arrays()
                for x in ref.rollup_store.lane("1m", lane).all_series()}
        assert sorted(got) == sorted(want) and len(got) == 10
        for key, (ts, fval, _ival, isint) in want.items():
            np.testing.assert_array_equal(got[key][0], ts)
            np.testing.assert_allclose(got[key][1], fval, rtol=1e-9,
                                       atol=1e-9)
            np.testing.assert_array_equal(got[key][3], isint)


def test_refusals():
    with pytest.raises(ValueError, match="one device or each on a CUDA"):
        make_mesh(devices=["cpu"] * 3 + ["cuda:0"])
    with pytest.raises(ValueError, match="owner"):
        TSDB(Config(PROPS), device="cpu",
             mesh=SimpleNamespace(owner=torch.device("cuda", 0)))
    for key, value in (("tsd.network.distributed.coordinator", "c0:1234"),
                       ("tsd.network.distributed.num_processes", 4),
                       ("tsd.network.distributed.process_id", 1)):
        with pytest.raises(ValueError,
                           match=r"ROADMAP A, slice 9 \(the cluster\)"):
            TSDB(Config({key: value}), device="cpu")
    TSDB(Config({"tsd.network.distributed.coordinator": "",
                 "tsd.network.distributed.num_processes": 0}), device="cpu")


def test_admission_keeps_a_meshed_plan_at_full_price():
    """The aggregate cache's discount applies only to a plan the planner
    can rewrite: a meshed plan (never rewritten) keeps its full price,
    as in the reference (tsd/admission.py:216-226)."""
    from opentsdb_tpu_torch.tsd.admission import estimate_plan_cost_ms

    class Covered:
        def coverage(self, *args):
            return 1.0

    q = TSQuery(start=str(START), end=str(START + 600),
                queries=[parse_m_subquery("sum:1m-avg:sys.cpu.user{dc=*}")])
    q.validate()
    costs = {}
    for meshed in (False, True):
        tsdb = _port(mesh=meshed)
        tsdb.agg_cache = Covered()
        costs[meshed] = estimate_plan_cost_ms(tsdb, q)
    assert costs[False] == 0.0 < costs[True]
