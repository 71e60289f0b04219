"""Request spans in the port (obs/trace.py): the span tree, the ambient
trace, device_wait, and the stages the planner and the RPC layer open.

The reference's trace is held where the two can be compared: the span
API (stage, annotate, begin/end, finish) behaves alike, and a grouped
query traced through each package's RpcManager shows the reference's
stage names (admission, scan, pipeline with its fingerprint, extract,
serialize) in ``showStats``.
"""

from __future__ import annotations

import json
import threading

import pytest
import torch

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.obs import trace as ref_trace
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.tsd.http import HttpRequest
from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400


def _shape(span: dict) -> tuple:
    """A span tree's names and tags, without its times."""
    return (span["name"], tuple(sorted(span.get("tags", {}).items())),
            tuple(_shape(c) for c in span.get("spans", ())))


def _drive(mod):
    tr = mod.Trace("http", trace_id="t-1")
    mod.activate(tr)
    try:
        with mod.stage("scan", kind="raw") as sp:
            mod.annotate(sp, series=4)
            with mod.stage("inner"):
                pass
        psp = mod.begin("pipeline", aggregator="sum")
        mod.annotate(psp, fingerprint="pf-x")
        mod.end(psp)
        left_open = mod.begin("tiled")     # an error path leaves it open
        assert left_open is not None
    finally:
        mod.deactivate()
        tr.finish()
    return tr


def test_span_api_builds_the_reference_tree():
    ours, ref = _drive(obs_trace), _drive(ref_trace)
    assert _shape(ours.to_json()) == _shape(ref.to_json())
    assert ours.to_json()["traceId"] == "t-1"
    # finish() closed the span an error path left open
    assert all(c["wallMs"] >= 0.0 for c in ours.to_json()["spans"])
    assert ours.root.children[-1].wall_ms is not None


def test_untraced_calls_cost_nothing_and_return_none():
    assert obs_trace.active() is None
    with obs_trace.stage("scan") as sp:
        assert sp is None
    assert obs_trace.begin("pipeline") is None
    obs_trace.end(None)
    obs_trace.annotate(None, a=1)
    assert obs_trace.device_wait(None, torch.zeros(2)) == 0.0


def test_device_wait_times_cuda_outputs_only():
    tr = obs_trace.Trace("http")
    obs_trace.activate(tr)
    try:
        sp = obs_trace.begin("pipeline")
        # CPU tensors and host arrays: nothing to wait for
        assert obs_trace.device_wait(sp, (torch.ones(3), None)) == 0.0
        assert sp.device_ms == 0.0
        off = obs_trace.Trace("http", device_time=False)
        obs_trace.activate(off)
        assert obs_trace.device_wait(off.root, torch.ones(3)) == 0.0
    finally:
        obs_trace.deactivate()


def test_ambient_trace_is_per_thread():
    tr = obs_trace.Trace("http")
    obs_trace.activate(tr)
    seen = []
    th = threading.Thread(target=lambda: seen.append(obs_trace.active()))
    th.start()
    th.join()
    obs_trace.deactivate()
    assert seen == [None]


def _ingest(tsdb):
    for host in ("a", "b", "c"):
        for i in range(60):
            tsdb.add_point("tr.m", BASE + i * 10, float(i),
                           {"host": host})
    return tsdb


CFG = {"tsd.core.auto_create_metrics": True,
       "tsd.query.batch.enable": False}
URI = ("/api/query?start=%d&end=%d&m=sum:1m-avg:tr.m{host=*}&show_stats"
       % (BASE, BASE + 600))


def _names(span: dict) -> list:
    out = [span["name"]]
    for child in span.get("spans", ()):
        out.extend(_names(child))
    return out


@pytest.mark.parametrize("enable", [True, False])
def test_show_stats_carries_the_span_tree(enable):
    ref = RefManager(_ingest(RefTSDB(RefConfig({
        **CFG, "tsd.query.mesh.enable": False,
        "tsd.trace.enable": enable}))))
    port = RpcManager(_ingest(TSDB(Config({**CFG,
                                           "tsd.trace.enable": enable}),
                                   device="cpu")))
    summaries = []
    for manager, cls in ((ref, RefRequest), (port, HttpRequest)):
        response = manager.handle_http(cls(method="GET", uri=URI, body=b"",
                                           headers={}))
        assert response.response.status == 200
        body = json.loads(response.response.body)
        summaries.append(body[-1]["statsSummary"])
    want, got = summaries
    assert ("trace" in got) == ("trace" in want) == enable
    if not enable:
        return
    names = _names(got["trace"])
    for stage in ("http", "admission", "scan", "pipeline", "extract",
                  "serialize"):
        assert stage in names and stage in _names(want["trace"]), stage
    tags = _find(got["trace"], "pipeline")["tags"]
    assert tags["fingerprint"].startswith("pf-")
    assert tags["aggregator"] == "sum"


def _find(span: dict, name: str) -> dict:
    if span["name"] == name:
        return span
    for child in span.get("spans", ()):
        found = _find(child, name)
        if found is not None:
            return found
    return None
