"""The dispatch batcher and the gate's fair share on both packages, on the
CPU: the mesh-free, mode-free cases of tests/test_batcher.py.

* Stacked = solo bit for bit per member on integer data, through the real
  rendezvous at Q = 4, and equal to the reference's batched answer; Q = 1
  runs the solo pipeline without holding.
* Bucket keying: shape and dtype split buckets (the port's key has no
  mode-policy epoch: it has no kernel modes).
* One member's deadline leaves the bucket without poisoning its siblings,
  the leader's included.
* Weighted deficit round robin in both packages' admission gates.
* Routing: a compute-bound plan declines the batched arm in both packages
  (each on its own cost table: the port's plan is sized from the
  ``cuda`` table, the reference's is its own test's), and batching off
  restores the unbatched route (the reference's host lane; the port has
  none, so its plan is resident).

Every wait is bounded with join(timeout); a hung thread fails the test.
"""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.ops.downsample import FixedWindows as RefFixedWindows
from opentsdb_tpu.ops.downsample import mode_policy_epoch
from opentsdb_tpu.ops.pipeline import DownsampleStep as RefStep
from opentsdb_tpu.ops.pipeline import PipelineSpec as RefSpec
from opentsdb_tpu.ops.rate import RateOptions as RefRate
from opentsdb_tpu.query.batcher import DispatchBatcher as RefBatcher
from opentsdb_tpu.tsd.admission import AdmissionGate as RefGate
from opentsdb_tpu.tsd.admission import ShedError as RefShed
from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops.pipeline import (DownsampleStep, PipelineSpec,
                                             run_group_pipeline)
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.ops.streaming import pad_pow2
from opentsdb_tpu_torch.query.batcher import DispatchBatcher, bucket_key
from opentsdb_tpu_torch.query.limits import Deadline, QueryException
from opentsdb_tpu_torch.tsd.admission import AdmissionGate, ShedError
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400_000
JOIN_S = 60


# -- the rendezvous --------------------------------------------------------

def make_batcher(hold_ms=100, max_q=16, demand=8, ref=False):
    """A batcher whose TSDB's gate shows `demand` queries in flight (the
    leader holds its bucket only then)."""
    props = {"tsd.query.batch.enable": "true",
             "tsd.query.batch.hold_ms": str(hold_ms),
             "tsd.query.batch.max_q": str(max_q)}
    if ref:
        gate = SimpleNamespace(_lock=threading.Lock(), in_flight=demand,
                               _depth_locked=lambda: 0)
        return RefBatcher(RefConfig(props),
                          tsdb=SimpleNamespace(_admission_gate=gate))
    gate = SimpleNamespace(demand=lambda: demand)
    return DispatchBatcher(Config(props), tsdb=SimpleNamespace(
        admission_gate=gate, device=torch.device("cpu")))


def member_operands(rng, s, n, w, groups=1, int_vals=True):
    ts = np.sort(rng.integers(0, w * 1000, (s, n))).astype(np.int64)
    if int_vals:
        val = rng.integers(-50, 50, (s, n)).astype(np.float64)
    else:
        val = rng.standard_normal((s, n))
    mask = np.ones((s, n), bool)
    gid = np.sort(rng.integers(0, groups, s)).astype(np.int64)
    return ts, val, mask, gid


def specs(ds_fn, rate, w):
    wspec, wargs = RefFixedWindows(1000, 0, w).split()
    ref = RefSpec(aggregator="sum",
                  downsample=RefStep(ds_fn, wspec, "none", 0.0),
                  rate=RefRate() if rate else None, int_mode=False,
                  rows_sorted=True)
    port = PipelineSpec("sum", DownsampleStep(ds_fn),
                        RateOptions() if rate else None)
    edges = np.arange(w + 1, dtype=np.int64) * 1000
    return ref, wargs, port, edges


def submit_concurrently(submit, members, deadlines=None):
    """Drive the members through the rendezvous from one thread each;
    ([result | exception per member], infos)."""
    results = [None] * len(members)
    infos = [None] * len(members)

    def worker(i):
        dl = deadlines[i] if deadlines else None
        try:
            out, info = submit(members[i], dl)
            results[i] = tuple(np.asarray(x) for x in out)
            infos[i] = info
        except Exception as e:              # noqa: BLE001 - test capture
            results[i] = e

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(members))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads), "a member hung"
    return results, infos


def port_submit(batcher, spec, groups, edges):
    return lambda m, dl: batcher.submit(spec, m[0], m[1], m[2], m[3],
                                        groups, edges, dl)


def port_solo(spec, m, groups, edges):
    return tuple(x.numpy() for x in run_group_pipeline(
        spec, *(torch.from_numpy(x) for x in m[:3]), m[3], groups,
        torch.from_numpy(edges)))


class TestStackedBitwise:

    @pytest.mark.parametrize("ds_fn,rate,groups", [
        ("avg", False, 1),
        ("sum", False, 1),
        ("max", False, 1),
        ("count", False, 1),
        ("avg", True, 1),
        ("avg", False, 4),
    ])
    def test_family_bitwise(self, ds_fn, rate, groups):
        """Stacked = solo bit for bit per member, and equal to the
        reference's batched answer (its padded W cut to the query's)."""
        rng = np.random.default_rng(42)
        s, n, w = 4, 256, 12
        ref_spec, wargs, spec, edges = specs(ds_fn, rate, w)
        members = [member_operands(rng, s, n, w, groups=groups)
                   for _ in range(4)]
        # the bucket seals at its 4th member: no thread can miss the hold
        results, infos = submit_concurrently(
            port_submit(make_batcher(hold_ms=5000, max_q=4), spec, groups,
                        edges), members)
        assert all(i and i["q"] == 4 and i["stacked"] for i in infos), infos
        ref_batcher = make_batcher(hold_ms=5000, max_q=4, ref=True)
        epoch = mode_policy_epoch()
        ref_results, ref_infos = submit_concurrently(
            lambda m, dl: ref_batcher.submit(ref_spec, m[0], m[1], m[2],
                                             m[3], groups, wargs, False,
                                             epoch, dl), members)
        assert all(i["q"] == 4 for i in ref_infos)
        for m, got, ref in zip(members, results, ref_results):
            assert not isinstance(got, Exception), got
            for a, b in zip(got, port_solo(spec, m, groups, edges)):
                assert a.dtype == b.dtype
                assert np.array_equal(a, b, equal_nan=True)
            wts, out, mask = got
            assert np.array_equal(wts, ref[0][:w])
            assert np.array_equal(mask, ref[2][:, :w])
            assert np.array_equal(out[mask], ref[1][:, :w][mask])

    def test_q1_runs_the_solo_pipeline(self):
        rng = np.random.default_rng(1)
        _r, _w, spec, edges = specs("avg", False, 16)
        m = member_operands(rng, 2, 128, 16)
        batcher = make_batcher(demand=1)        # uncontended: no hold
        t0 = time.monotonic()
        out, info = batcher.submit(spec, m[0], m[1], m[2], m[3], 1, edges)
        assert info == {"q": 1, "stacked": False, "waitMs": info["waitMs"]}
        assert time.monotonic() - t0 < 5.0
        for a, b in zip(out, port_solo(spec, m, 1, edges)):
            assert np.array_equal(a, b, equal_nan=True)
        assert batcher.collect_stats()[
            "tsd.query.batch.solo_dispatches"] == 1.0


    def test_stress_every_member_gets_its_own_answer(self):
        """32 threads (more than the cores) submit 4 rounds each over 2
        bucket keys with a 1 ms hold and a short switch interval: every
        member gets its solo answer and every submit is counted once."""
        import sys
        rng = np.random.default_rng(9)
        _r, _w, spec, edges = specs("sum", False, 8)
        members = [member_operands(rng, 2 + i % 2, 64, 8)
                   for i in range(32)]
        solos = [port_solo(spec, m, 1, edges) for m in members]
        batcher = make_batcher(hold_ms=1, max_q=5)
        wrong = []
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def worker(i):
                for _ in range(4):
                    out, _info = batcher.submit(spec, *members[i][:4], 1,
                                                edges)
                    if not all(np.array_equal(a, b, equal_nan=True)
                               for a, b in zip(out, solos[i])):
                        wrong.append(i)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(JOIN_S)
            assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(interval)
        assert not wrong
        stats = batcher.collect_stats()
        assert stats["tsd.query.batch.stacked_members"] \
            + stats["tsd.query.batch.solo_dispatches"] == 128
        assert stats["tsd.query.batch.keys"] == 2.0


class TestBucketKeying:
    def test_shape_and_dtype_split_buckets(self):
        _r, _w, spec, edges = specs("avg", False, 16)
        rng = np.random.default_rng(3)
        a = member_operands(rng, 2, 128, 16)
        b = member_operands(rng, 4, 128, 16)          # another S
        c = (a[0], a[1].astype(np.int64), a[2], a[3])  # another dtype
        keys = {bucket_key(spec, 1, m[0], m[1], m[3], edges)
                for m in (a, b, c)}
        assert len(keys) == 3
        # the same shapes and dtypes share one key, whatever the data
        d = member_operands(rng, 2, 128, 16)
        assert bucket_key(spec, 1, a[0], a[1], a[3], edges) \
            == bucket_key(spec, 1, d[0], d[1], d[3], edges + 5)

    def test_dispatch_counts(self):
        rng = np.random.default_rng(4)
        _r, _w, spec, edges = specs("avg", False, 16)
        members = [member_operands(rng, 2, 128, 16) for _ in range(3)]
        batcher = make_batcher(hold_ms=5000, max_q=3)
        _res, infos = submit_concurrently(
            port_submit(batcher, spec, 1, edges), members)
        assert all(i["q"] == 3 for i in infos)
        stats = batcher.collect_stats()
        assert stats["tsd.query.batch.stacked_dispatches"] == 1.0
        assert stats["tsd.query.batch.stacked_members"] == 3.0

    def test_dispatch_time_tallies(self):
        """Each dispatch adds its host wall, its thread's CPU time and its
        copy-back wall; the CPU time and the copy-back lie within the
        wall, and the wall within the members' waits."""
        rng = np.random.default_rng(4)
        _r, _w, spec, edges = specs("avg", False, 16)
        members = [member_operands(rng, 2, 128, 16) for _ in range(3)]
        batcher = make_batcher(hold_ms=5000, max_q=3)
        submit_concurrently(port_submit(batcher, spec, 1, edges), members)
        batcher.submit(spec, *members[0][:4], 1, edges)   # Q = 1
        stats = batcher.collect_stats()
        wall = stats["tsd.query.batch.dispatch_ms"]
        assert 0.0 < stats["tsd.query.batch.copy_back_ms"] <= wall
        assert 0.0 < stats["tsd.query.batch.dispatch_cpu_ms"] <= wall + 1.0
        assert wall <= stats["tsd.query.batch.wait_ms"]


class TestDeadlines:
    def test_expired_member_leaves_without_poisoning_siblings(self):
        rng = np.random.default_rng(5)
        _r, _w, spec, edges = specs("avg", False, 16)
        members = [member_operands(rng, 2, 128, 16) for _ in range(3)]
        dead = Deadline(timeout_ms=0.0001)
        time.sleep(0.01)
        assert dead.expired()
        results, infos = submit_concurrently(
            port_submit(make_batcher(hold_ms=200), spec, 1, edges), members,
            deadlines=[None, dead, None])
        assert isinstance(results[1], QueryException)
        for i in (0, 2):
            assert not isinstance(results[i], Exception), results[i]
            assert infos[i]["q"] == 2           # the dead member dropped
            for a, b in zip(results[i], port_solo(spec, members[i], 1,
                                                  edges)):
                assert np.array_equal(a, b, equal_nan=True)

    def test_expired_leader_is_dropped_and_still_serves_followers(self):
        """The expired member submits first and leads: it dispatches for
        its live followers, then raises its own 413."""
        rng = np.random.default_rng(6)
        _r, _w, spec, edges = specs("avg", False, 16)
        members = [member_operands(rng, 2, 128, 16) for _ in range(3)]
        dead = Deadline(timeout_ms=0.0001)
        time.sleep(0.01)
        batcher = make_batcher(hold_ms=500)
        submit = port_submit(batcher, spec, 1, edges)
        results = [None] * 3

        def worker(i, dl):
            try:
                out, _info = submit(members[i], dl)
                results[i] = tuple(np.asarray(x) for x in out)
            except Exception as e:          # noqa: BLE001 - test capture
                results[i] = e

        t0 = threading.Thread(target=worker, args=(0, dead))
        t0.start()
        for _ in range(500):
            with batcher._lock:
                if batcher._buckets:
                    break
            time.sleep(0.002)
        with batcher._lock:
            assert batcher._buckets, "the leader never opened a bucket"
        rest = [threading.Thread(target=worker, args=(i, None))
                for i in (1, 2)]
        for th in rest:
            th.start()
        for th in [t0] + rest:
            th.join(JOIN_S)
        assert isinstance(results[0], QueryException)
        assert results[0].status == 413
        for i in (1, 2):
            assert not isinstance(results[i], Exception), results[i]
            for a, b in zip(results[i], port_solo(spec, members[i], 1,
                                                  edges)):
                assert np.array_equal(a, b, equal_nan=True)


# -- fair share (weighted DRR), both packages' gates -----------------------

PACKAGES = {"ref": (RefGate, RefConfig, RefShed),
            "port": (AdmissionGate, Config, ShedError)}


def make_gate(pkg, **over):
    gate_cls, config_cls, _ = PACKAGES[pkg]
    props = {"tsd.query.admission.permits": "1",
             "tsd.query.admission.queue_limit": "64",
             "tsd.query.admission.max_wait_ms": "0"}
    props.update({k: str(v) for k, v in over.items()})
    return gate_cls(config_cls(props))


def drain_order(gate, plan, cost_ms=50.0):
    """Enqueue (tenant, n) entries behind a held permit, release, and
    observe the drain order."""
    order = []
    lock = threading.Lock()
    blocker = gate.acquire(None, "interactive")

    def worker(tenant):
        p = gate.acquire(None, "interactive", tenant=tenant,
                         cost_ms=cost_ms)
        with lock:
            order.append(tenant)
        time.sleep(0.002)
        p.release()

    threads = []
    for tenant, n in plan:
        for _ in range(n):
            th = threading.Thread(target=worker, args=(tenant,))
            th.start()
            threads.append(th)
            time.sleep(0.005)
    time.sleep(0.2)
    blocker.release()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    return order


@pytest.mark.parametrize("pkg", list(PACKAGES))
class TestFairShare:
    def test_weighted_drain_ratio(self, pkg):
        gate = make_gate(pkg, **{"tsd.query.tenant.weights": "a:2,b:1"})
        order = drain_order(gate, [("a", 9), ("b", 9)])
        assert order[:9].count("a") >= 5, order
        assert set(order) == {"a", "b"} and len(order) == 18

    def test_single_tenant_reduces_to_fifo(self, pkg):
        gate = make_gate(pkg)
        order = []
        lock = threading.Lock()
        blocker = gate.acquire(None, "interactive")

        def worker(i):
            p = gate.acquire(None, "interactive", cost_ms=10.0)
            with lock:
                order.append(i)
            p.release()

        threads = []
        for i in range(8):
            th = threading.Thread(target=worker, args=(i,))
            th.start()
            threads.append(th)
            time.sleep(0.01)
        time.sleep(0.1)
        blocker.release()
        for th in threads:
            th.join(30)
        assert order == list(range(8))

    def test_per_tenant_inflight_cap(self, pkg):
        shed = PACKAGES[pkg][2]
        gate = make_gate(pkg, **{"tsd.query.admission.permits": "4",
                                 "tsd.query.tenant.max_inflight": "1",
                                 "tsd.query.admission.max_wait_ms": "200"})
        p1 = gate.acquire(None, "interactive", tenant="a")
        with pytest.raises(shed):
            gate.acquire(None, "interactive", tenant="a")
        p2 = gate.acquire(None, "interactive", tenant="b")
        p2.release()
        p1.release()
        gate.acquire(None, "interactive", tenant="a").release()

    def test_per_tenant_queue_bound_sheds_storm_not_victim(self, pkg):
        shed = PACKAGES[pkg][2]
        gate = make_gate(pkg, **{"tsd.query.admission.queue_limit": "2",
                                 "tsd.query.admission.max_wait_ms": "0"})
        blocker = gate.acquire(None, "interactive")
        storm = []
        for _ in range(2):
            th = threading.Thread(
                target=lambda: gate.acquire(None, "interactive",
                                            tenant="storm").release())
            th.start()
            storm.append(th)
        time.sleep(0.2)
        with pytest.raises(shed):
            gate.acquire(None, "interactive", tenant="storm")
        got = []
        th = threading.Thread(target=lambda: got.append(gate.acquire(
            None, "interactive", tenant="victim")))
        th.start()
        time.sleep(0.1)
        blocker.release()
        th.join(30)
        for w in storm:
            w.join(30)
        assert got and got[0] is not None
        got[0].release()
        snap = gate.tenant_snapshot()
        assert snap["tenants"]["storm"]["refused"] == 1
        assert snap["tenants"]["victim"]["refused"] == 0
        assert snap["tenants"]["victim"]["admitted"] == 1

    def test_fair_share_off_collapses_identities(self, pkg):
        gate = make_gate(pkg, **{"tsd.query.tenant.fair_share": "false"})
        p = gate.acquire(None, "interactive", tenant="alice")
        assert p.tenant == "alice"
        assert gate._tenant_inflight == {"default": 1}
        p.release()
        assert gate._tenant_inflight == {}

    def test_snapshot_shape(self, pkg):
        gate = make_gate(pkg, **{"tsd.query.tenant.weights": "a:3"})
        p = gate.acquire(None, "interactive", tenant="a")
        snap = gate.tenant_snapshot()
        assert snap["fairShare"] is True
        assert snap["tenants"]["a"]["weight"] == 3.0
        assert snap["tenants"]["a"]["inflight"] == 1
        p.release()


# -- routing ---------------------------------------------------------------

def _ref_manager(**cfg):
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.mesh.enable": "false",
             "tsd.rollup.interval": "0", "tsd.stats.interval": "0",
             "tsd.query.device_cache.enable": "false"}
    props.update({k: str(v) for k, v in cfg.items()})
    tsdb = RefTSDB(RefConfig(props))
    return tsdb, RefManager(tsdb)


def _ref_explain_path(mgr, q):
    req = RefRequest(method="GET", uri="/api/query/explain?" + q, headers={})
    resp = mgr.handle_http(req, remote="127.0.0.1:9").response
    body = resp.body.decode() if isinstance(resp.body, (bytes, bytearray)) \
        else resp.body
    assert resp.status == 200, body
    return json.loads(body)["subQueries"][0]["segments"][0]["path"]


def _port_tsdb(**cfg):
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.device_cache.enable": "false"}
    props.update({k: str(v) for k, v in cfg.items()})
    return TSDB(Config(props), device="cpu")


def _feed(tsdb, metric, series, points, cadence_s, store=None):
    for h in range(series):
        key = tsdb._series_key(metric, {"host": "h%d" % h}, True)
        ts = BASE + np.arange(points, dtype=np.int64) * cadence_s * 1000
        tsdb.store.add_batch(key, ts, ((np.arange(points) * 7 + h) % 101)
                             .astype(np.float64), False)


def _port_path(tsdb, m, start_s, end_s):
    q = TSQuery(start=str(start_s), end=str(end_s),
                queries=[parse_m_subquery(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    runner.run(q)
    return runner.decisions[0].path, runner.exec_stats


class TestBatchedRouting:
    def test_compute_bound_plan_declines_to_dispatch_now(self):
        """The coalesce line is priced, not a static batch size: a plan
        whose compute and stacked cells exceed amortize_factor x the
        stacked-dispatch floor keeps the unbatched route, in each package
        on its own cost table.  The reference runs its own test's shape;
        the port's shape is sized from the cuda table so that its cells
        alone cost twice the line."""
        tsdb, mgr = _ref_manager()
        for h in range(2):
            for k in range(6000):
                tsdb.add_point("bt.big", BASE // 1000 + k,
                               float((k * 7 + h) % 101), {"host": "h%d" % h})
        q = "start=%d&end=%d&m=sum:2s-avg:bt.big" % (BASE // 1000,
                                                     BASE // 1000 + 6000)
        assert _ref_explain_path(mgr, q) in ("host_lane", "resident")
        tsdb.shutdown()

        line = 4.0 * cm.CUDA_COSTS["stacked_dispatch"]
        points = pad_pow2(int(2 * line / cm.CUDA_COSTS["stacked_cell"] / 2))
        port = _port_tsdb()
        _feed(port, "bt.big", 2, points, 1)
        path, stats = _port_path(port, "sum:2s-avg:bt.big", BASE // 1000,
                                 BASE // 1000 + points - 1)
        assert path == "resident" and "batched" not in stats
        # and the same verdict straight from the cost model
        assert not cm.coalesce_worthwhile(0.0, 2, points, 1, 1, 4.0)

    def test_small_plan_is_batched_and_disabled_config_restores_routing(
            self):
        """A small plan takes the batched route in both packages; with
        tsd.query.batch.enable=false the reference takes its host lane
        and the port, which has none, its resident route."""
        for enable, ref_want, port_want in ((True, "batched", "batched"),
                                            (False, "host_lane",
                                             "resident")):
            tsdb, mgr = _ref_manager(**{"tsd.query.batch.enable":
                                        str(enable).lower()})
            for h in range(2):
                for k in range(100):
                    tsdb.add_point("bt.off", BASE // 1000 + k * 15,
                                   float((k * 7 + h) % 101),
                                   {"host": "h%d" % h})
            q = "start=%d&end=%d&m=sum:30s-avg:bt.off" % (
                BASE // 1000, BASE // 1000 + 100 * 15)
            assert _ref_explain_path(mgr, q) == ref_want
            tsdb.shutdown()
            port = _port_tsdb(**{"tsd.query.batch.enable":
                                 str(enable).lower()})
            _feed(port, "bt.off", 2, 100, 15)
            path, stats = _port_path(port, "sum:30s-avg:bt.off",
                                     BASE // 1000, BASE // 1000 + 1500)
            assert path == port_want
            assert stats.get("batched") == (1.0 if enable else None)
            assert (port.dispatch_batcher is not None) == enable
