"""Out-of-core tiled execution (ops/tiling.py, storage/spill.py, the
planner's tiled arm) against the reference's, on the CPU.

The mesh-free cases of tests/test_tiling.py, each on the same data in both
packages (the port with ``device="cpu"``, where K2, K3, K5, S1-S3 and T1
run their plain versions):

* a group-by whose state is over ``tsd.query.streaming.state_mb`` is
  served tiled and equals a resident run (bitwise on integer data, and
  bitwise on floats where the chunking is the same), and the reference's
  answer; with the spill pool off it gets the reference's 413;
* the budget's edges: just under streams, just over tiles, 0 disables;
* the spill pool's tiers, demotion, refusals and a failed disk write.

Beside them: T1's plain version against the reference's ``_lane_fold``
and against K3 over the whole grid; each query's tiles and stripes
against the reference's; a failed disk write mid-query (the 503, the pool
left empty, the next query served); and movingAverage<N> as the
cross-series aggregator, where the port gives the resident answer and the
reference's tiled run restarts its moving average at every stripe.
Reference TSDBs run with the mesh off.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.ops.downsample import pad_pow2 as ref_pad_pow2
from opentsdb_tpu.ops import tiling as rtiling
from opentsdb_tpu.ops.pipeline import PipelineSpec as RefSpec
from opentsdb_tpu.ops.rate import RateOptions as RefRate
from opentsdb_tpu.query import limits as ref_limits
from opentsdb_tpu.query.plandecision import \
    acc_cell_bytes as ref_acc_cell_bytes
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops import group_agg as ga
from opentsdb_tpu_torch.ops import tiling
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.query import limits
from opentsdb_tpu_torch.storage import spill
from opentsdb_tpu_torch.utils.config import Config

from torch_parity import assert_exact, assert_values

BASE_S = 1_356_998_400
SPAN_S = 40_960          # 4,097 windows at 10 s


def _props(state_mb, spill_on="true", extra=None):
    return {"tsd.core.auto_create_metrics": True,
            "tsd.query.device_cache.enable": "false",
            "tsd.query.streaming.point_threshold": "10",
            "tsd.query.streaming.chunk_points": "20000",
            "tsd.query.spill.enable": spill_on,
            "tsd.query.streaming.state_mb": str(state_mb), **(extra or {})}


def _feed(t, hosts=24, pts=60, float_vals=False, seed=7):
    rng = np.random.default_rng(seed)
    for h in range(hosts):
        times = np.sort(rng.choice(SPAN_S, size=pts, replace=False))
        for i, ts in enumerate(times):
            v = (float(i) * 0.37 + h * 0.13 if float_vals
                 else float((i * 7 + h * 13) % 101))
            t.add_point("til.m", BASE_S + int(ts), v,
                        {"h": "h%d" % h, "g": "g%d" % (h % 4)})
    return t


def _port(state_mb, spill_on="true", extra=None, **feed):
    return _feed(TSDB(Config(_props(state_mb, spill_on, extra)),
                      device="cpu"), **feed)


def _ref(state_mb, spill_on="true", extra=None, **feed):
    return _feed(RefTSDB(RefConfig({**_props(state_mb, spill_on, extra),
                                    "tsd.query.mesh.enable": "false",
                                    "tsd.query.cache.enable": "false"})),
                 **feed)


def _run(tsdb, m, start=BASE_S, end=BASE_S + SPAN_S):
    ref = isinstance(tsdb, RefTSDB)
    q = (RefTSQuery if ref else TSQuery)(
        start=str(start), end=str(end),
        queries=[(ref_parse if ref else parse_m_subquery)(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    return [r.to_json() for r in runner.run(q)], dict(runner.exec_stats)


def _close(got, want, rtol=1e-9, atol=1e-9):
    assert [(g["tags"], sorted(g["dps"])) for g in got] \
        == [(w["tags"], sorted(w["dps"])) for w in want]
    for g, w in zip(got, want):
        keys = sorted(w["dps"])
        np.testing.assert_allclose([g["dps"][k] for k in keys],
                                   [w["dps"][k] for k in keys], rtol=rtol,
                                   atol=atol)


class TestTiledExecution:
    """Over-budget plans answer through tiling and match a resident run
    of the same plan and the reference."""

    def test_over_limit_groupby_answers_and_matches_resident_bitwise(self):
        # 24 series x 4,097 windows x 16 B of sum lanes (8,192 padded):
        # over 1 MB, so tiled in both packages
        m = "sum:10s-sum:til.m{g=*}"
        got, st = _run(_port(1), m)
        resident, rst = _run(_port(6144), m)
        want, ref_st = _run(_ref(1), m)
        assert st.get("tiledExecution") == ref_st.get("tiledExecution") \
            == 1.0
        assert st["spillBytes"] > 0
        assert "tiledExecution" not in rst
        assert len(got) == 4
        # integer-valued data: f64 sums are exact in any order
        assert got == resident == want

    @pytest.mark.parametrize("m", [
        "sum:rate:10s-sum:til.m{g=*}",   # a rate across stripe bounds
        "avg:10s-dev:til.m{g=*}",        # Chan-merged lanes, LERP holes
        "max:10s-max:til.m{g=*}",        # extreme lanes
    ])
    def test_modes_match_resident_within_float_contract(self, m):
        """Tiles chunk otherwise than the resident stream (n_chunk
        follows the row count), which moves the streamed folds' last
        digits; the tiling adds nothing (see the equal-chunking case)."""
        got, st = _run(_port(1, float_vals=True), m)
        resident, _ = _run(_port(6144, float_vals=True), m)
        want, ref_st = _run(_ref(1, float_vals=True), m)
        assert st.get("tiledExecution") == ref_st.get("tiledExecution") \
            == 1.0
        _close(got, resident, rtol=1e-12, atol=1e-12)
        _close(got, want)

    @pytest.mark.parametrize("m", [
        "sum:rate:10s-sum:til.m{g=*}",
        "avg:10s-avg:til.m{g=*}",
    ])
    def test_equal_chunking_is_bitwise_on_floats(self, m):
        """chunk_points 1,000 puts the 24-row resident stream and the
        9-row tiles at the 1,024-point chunk floor: the tiled run is the
        resident one bit for bit, rate, interpolation and the striped
        group reduce included."""
        extra = {"tsd.query.streaming.chunk_points": "1000"}
        got, st = _run(_port(1, extra=extra, float_vals=True), m)
        resident, _ = _run(_port(6144, extra=extra, float_vals=True), m)
        want, _ = _run(_ref(1, extra=extra, float_vals=True), m)
        assert st.get("tiledExecution") == 1.0
        assert got == resident
        _close(got, want)

    def test_refused_structured_413_when_spill_disabled(self):
        m = "sum:10s-sum:til.m{g=*}"
        got = []
        for tsdb, exc in ((_ref(1, spill_on="false"),
                           ref_limits.QueryException),
                          (_port(1, spill_on="false"),
                           limits.QueryException)):
            with pytest.raises(exc) as info:
                _run(tsdb, m)
            got.append((info.value.status, str(info.value),
                        info.value.details))
        assert got[0] == got[1]
        status, _, details = got[1]
        assert status == 413
        assert details["limitKey"] == "tsd.query.streaming.state_mb"
        assert details["limitMb"] == 1 and details["gridMb"] >= 1
        assert "spill" in details["suggestion"]

    def test_tiling_decision_in_exec_stats_and_over_http(self):
        """The port has no span tree yet (slice 8): the decision shows in
        exec_stats and the collect_stats tallies, and the HTTP answer
        equals the reference's."""
        from opentsdb_tpu.tsd.http import HttpRequest as RefRequest
        from opentsdb_tpu.tsd.rpc_manager import RpcManager as RefManager
        from opentsdb_tpu_torch.tsd.http import HttpRequest
        from opentsdb_tpu_torch.tsd.rpc_manager import RpcManager
        uri = "/api/query?start=%d&end=%d&m=sum:10s-sum:til.m{g=*}" \
            % (BASE_S, BASE_S + SPAN_S)
        port = _port(1)
        r = RpcManager(port).handle_http(HttpRequest(
            method="GET", uri=uri, headers={}, body=b""),
            remote="127.0.0.1:50").response
        rr = RefManager(_ref(1)).handle_http(RefRequest(
            method="GET", uri=uri, headers={}, body=b""),
            remote="127.0.0.1:50").response
        assert r.status == rr.status == 200
        assert r.body == rr.body
        _, st = _run(port, "sum:10s-sum:til.m{g=*}")
        assert st["tiledTiles"] >= 2 and st["spillBytes"] > 0
        stats = port.collect_stats()
        assert stats["tsd.query.spill.spills.host"] > 0
        assert stats["tsd.query.spill.entries.host"] == 0

    def test_spill_write_fault_surfaces_as_retryable_and_heals(
            self, monkeypatch):
        """host_mb 0 sends every stripe to disk; one failed disk write is
        the reference's 503, the query's entries are released, and the
        next attempt is served and matches."""
        t = _port(1, extra={"tsd.query.spill.host_mb": "0"})
        real = spill.SpillPool._write_array
        calls = []

        def failing(path, a):
            calls.append(path)
            if len(calls) == 1:
                raise OSError(28, "No space left on device")
            real(path, a)

        monkeypatch.setattr(spill.SpillPool, "_write_array",
                            staticmethod(failing))
        pool = t.spill_pool
        with pytest.raises(limits.QueryException) as exc:
            _run(t, "avg:10s-avg:til.m{g=*}")
        assert exc.value.status == 503
        assert "failed to write" in str(exc.value)
        st = pool.stats()
        assert st == {"host_bytes": 0, "disk_bytes": 0, "host_entries": 0,
                      "disk_entries": 0}
        a, sa = _run(t, "avg:10s-avg:til.m{g=*}")
        assert sa.get("tiledExecution") == 1.0
        assert t.collect_stats()["tsd.query.spill.write_errors"] == 1.0
        assert t.collect_stats()["tsd.query.spill.evictions"] > 0
        b, _ = _run(_port(6144), "avg:10s-avg:til.m{g=*}")
        assert a == b
        t.shutdown()
        assert pool.stats()["disk_entries"] == 0


class TestStateBudgetTransitions:
    """state_mb at its edges: just under streams, just over tiles, 0
    disables the guard."""

    def test_just_under_streams_just_over_tiles_zero_disables(self):
        # the streaming estimate: 24 series x 8,192 windows (4,097
        # padded) x 16 B = 3 MB
        m = "sum:10s-sum:til.m{g=*}"
        under, st_under = _run(_port(4), m)
        over, st_over = _run(_port(1), m)
        zero, st_zero = _run(_port(0), m)
        ref_over, ref_st = _run(_ref(1), m)
        _, ref_st_under = _run(_ref(4), m)
        assert st_over.get("tiledExecution") == 1.0
        assert "tiledExecution" not in st_under
        assert "tiledExecution" not in ref_st_under
        assert "tiledExecution" not in st_zero
        assert st_zero.get("streamedChunks", 0) >= 1
        assert st_over["tiledTiles"] == ref_st["tiledTiles"]
        assert under == over == zero == ref_over

    def test_all_three_guard_sites_share_the_structured_shape(self):
        for kind in ("streaming", "grid", "histogram"):
            gbd = limits.grid_budget(kind, 4, 5 * 2**20, 100, 1000)
            ref = ref_limits.grid_budget(kind, 4, 5 * 2**20, 100, 1000)
            assert gbd.over and ref.over
            exc, ref_exc = gbd.exception(), ref.exception()
            assert (exc.status, str(exc), exc.details) \
                == (ref_exc.status, str(ref_exc), ref_exc.details)
            assert exc.details["kind"] == kind
            assert exc.details["gridMb"] == 5
        assert not limits.grid_budget("grid", 0, 10**12, 1, 1).over
        with pytest.raises(ValueError):
            limits.grid_budget("nope", 1, 1, 1, 1)


class TestSpillPool:
    def _pool(self, tmp_path, host=2**20, disk=8 * 2**20):
        return spill.SpillPool(host, disk, directory=str(tmp_path / "spill"))

    def test_host_roundtrip_and_column_slices(self, tmp_path):
        pool = self._pool(tmp_path)
        v = np.arange(64, dtype=np.float64).reshape(4, 16)
        m = v % 3 == 0
        key = pool.put((v, m))
        gv, gm = pool.get(key)
        assert_exact(gv, v)
        assert_exact(gm, m)
        sv, sm = pool.get(key, 4, 12)
        assert_exact(sv, v[:, 4:12])
        assert_exact(sm, m[:, 4:12])
        pool.free(key)
        assert pool.stats()["host_entries"] == 0
        with pytest.raises(KeyError):
            pool.get(key)
        pool.close()

    def test_overflow_demotes_newest_to_disk_and_reads_back(self, tmp_path):
        """Newest first: the stripe-major replay reads the oldest entries
        first, so they stay in RAM."""
        pool = self._pool(tmp_path, host=3000, disk=10 * 2**20)
        a = np.full((4, 64), 1.5)          # 2,048 B
        b = np.full((4, 64), 2.5)
        ka = pool.put((a,))
        kb = pool.put((b,))                # over 3,000 B: b demotes
        st = pool.stats()
        assert st["disk_entries"] == 1 and st["host_entries"] == 1
        assert_exact(pool.get(ka)[0], a)
        assert_exact(pool.get(kb)[0], b)
        assert_exact(pool.get(kb, 8, 16)[0], b[:, 8:16])
        assert pool.stats()["host_entries"] == 1
        assert pool.collect_stats()["tsd.query.spill.reads"] == 2.0
        pool.close()
        assert pool.stats() == {"host_bytes": 0, "disk_bytes": 0,
                                "host_entries": 0, "disk_entries": 0}
        assert not list((tmp_path / "spill").glob("*.npy"))

    def test_capacity_refusal_and_bounded_bytes(self, tmp_path):
        pool = self._pool(tmp_path, host=2048, disk=4096)
        with pytest.raises(spill.SpillCapacityError):
            pool.put((np.zeros(4096, np.float64),))   # 32 KB > both
        keys = [pool.put((np.zeros(128, np.float64),)) for _ in range(6)]
        st = pool.stats()
        assert st["host_bytes"] <= 2048
        assert st["disk_bytes"] <= 4096
        pool.release(keys)
        pool.close()

    def test_disk_full_fault_raises_and_keeps_pool_consistent(
            self, tmp_path, monkeypatch):
        pool = self._pool(tmp_path, host=2048, disk=4096)
        k0 = pool.put((np.zeros(128, np.float64),))   # 1,024 B resident
        real = spill.SpillPool._write_array

        def full(path, a):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(spill.SpillPool, "_write_array",
                            staticmethod(full))
        with pytest.raises(spill.SpillWriteError):
            pool.put((np.zeros(256, np.float64),))    # forces a demotion
        monkeypatch.setattr(spill.SpillPool, "_write_array",
                            staticmethod(real))
        # k0 survived the failed demotion and still serves
        assert pool.get(k0)[0].shape == (128,)
        st = pool.stats()
        assert st["host_entries"] == 1 and st["disk_bytes"] == 0
        k2 = pool.put((np.zeros(256, np.float64),))
        assert pool.get(k2)[0].shape == (256,)
        pool.close()

    def test_private_directory_removed_at_shutdown(self):
        t = TSDB(Config({"tsd.query.spill.host_mb": 0}), device="cpu")
        pool = t.spill_pool
        pool.put((np.zeros(16),))
        directory = pool._dir
        assert directory is not None and len(os.listdir(directory)) == 1
        t.shutdown()
        assert not os.path.exists(directory)


# -- T1 tile_partials against the reference's _lane_fold ----------------------


def _lane_grid(rng, s=12, w=40, int_values=False):
    wts = np.arange(w, dtype=np.int64) * 60_000 + 1_356_998_400_000
    if int_values:
        v = rng.integers(-50, 50, (s, w)).astype(np.float64)
    else:
        v = rng.normal(50.0, 20.0, (s, w))
    m = rng.random((s, w)) > 0.3
    m[3] = False                      # a row with no value at all
    v[rng.random((s, w)) < 0.03] = np.nan
    gid = np.sort(rng.integers(0, 5, s))
    gid[gid == 2] = 1                 # group 2 has no member
    return wts, v, m, gid


@pytest.mark.parametrize("rate", [False, True])
@pytest.mark.parametrize("agg, extreme", [("sum", False), ("max", True)])
def test_tile_partials_plain_matches_reference_lane_fold(agg, extreme, rate):
    """One tile: K2 then T1's plain version against the reference's
    _lane_fold: counts, presence and extremes exact, sums at 1e-9."""
    wts, v, m, gid = _lane_grid(np.random.default_rng(11))
    g = 5
    ref = rtiling.run_lane_fold(
        RefSpec(aggregator=agg, rate=RefRate() if rate else None), g,
        extreme, wts, v, m, gid)
    acc = tiling.new_lane_fold(g, v.shape[1], tiling.lane_mode(agg), "cpu")
    tiling.run_lane_fold(PipelineSpec(agg, rate=RateOptions() if rate
                                      else None), acc,
                         torch.from_numpy(wts), torch.from_numpy(v),
                         torch.from_numpy(m), ga.group_offsets(gid, g))
    if extreme:
        lo, hi, cnt, present = (np.asarray(x) for x in ref)
        assert_exact(acc["lo"].numpy(), lo)
        assert_exact(acc["hi"].numpy(), hi)
    else:
        tot, cnt, present = (np.asarray(x) for x in ref)
        assert_values(acc["tot"].numpy(), tot)
    assert_exact(acc["cnt"].numpy(), cnt.astype(np.int64))
    assert_exact(acc["present"].numpy(), present.astype(np.int64))


@pytest.mark.parametrize("bad", ["contrib", "participate", "offsets",
                                 "cnt", "tot", "hi"])
def test_tile_partials_checks_dtypes(bad):
    """T1's wrapper refuses a grid or accumulator of the wrong type before
    any launch: the kernel reads raw f64, bool and int64 pointers."""
    wts, v, m, gid = _lane_grid(np.random.default_rng(3))
    extreme = bad == "hi"
    args = {"contrib": torch.from_numpy(v),
            "participate": torch.from_numpy(m),
            "present": torch.from_numpy(m),
            "offsets": ga.group_offsets(gid, 5)}
    acc = tiling.new_lane_fold(5, v.shape[1],
                               "extreme" if extreme else "additive", "cpu")
    if bad in args:
        wrong = {"contrib": torch.float32, "participate": torch.uint8,
                 "offsets": torch.int32}[bad]
        args[bad] = args[bad].to(wrong)
    else:
        wrong = torch.int32 if bad == "cnt" else torch.float32
        acc[bad] = acc[bad].to(wrong)
    with pytest.raises(ValueError, match="tile_partials takes"):
        tiling.tile_partials(args["contrib"], args["participate"],
                             args["present"], args["offsets"], acc)


@pytest.mark.parametrize("agg", ["sum", "count", "avg", "min", "max"])
def test_tile_fold_equals_group_reduce_over_the_whole_grid(agg):
    """Tiles of 5 rows folded by T1 and finished equal K3 over the whole
    grid bit for bit (integer data), the mask included."""
    wts, v, m, gid = _lane_grid(np.random.default_rng(5), s=17,
                                int_values=True)
    g = 5
    spec = PipelineSpec(agg)
    tw, tv, tm = (torch.from_numpy(x) for x in (wts, v, m))
    acc = tiling.new_lane_fold(g, v.shape[1], tiling.lane_mode(agg), "cpu")
    for lo in range(0, 17, 5):
        tiling.run_lane_fold(spec, acc, tw, tv[lo:lo + 5], tm[lo:lo + 5],
                             ga.group_offsets(gid[lo:lo + 5], g))
    out, mask = tiling.finish_lane_fold(acc, agg)
    contrib, part, actual = tiling.tile_contrib(spec, tw, tv, tm)
    want, want_mask = ga.group_moments(agg, contrib, part, actual,
                                       ga.group_offsets(gid, g))
    assert_exact(out.numpy(), want.numpy())
    assert_exact(mask.numpy(), want_mask.numpy())


def test_lane_foldable_and_sizing_are_the_reference_s():
    assert tiling.LANE_FOLDABLE == rtiling.LANE_FOLDABLE
    for args in [(24, 8192, 2**20, 16, 8, 1024, 2),
                 (1024, 32768, 256 * 2**20, 26, 128, 1024, 17),
                 (1024, 32768, 6144 * 2**20, 264, 128, 1024, 17),
                 (5, 64, 100, 16, 8, 0, 1), (2000, 512, 2**20, 16, 8, 4, 1)]:
        # the reference's last argument (chunks a tile) only prices its
        # dispatches, which the port's plan does not carry
        got, want = tiling.size_tiles(*args[:6]), rtiling.size_tiles(*args)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.astuple(got) == (
                want.tile_rows, want.n_tiles, want.stripe_w, want.n_stripes,
                want.spill_bytes)
    feats = cm.features_tiled(3 * 2**30, 5)
    assert feats == {"spill_write_mb": 3072.0, "spill_read_mb": 3072.0,
                     "tile_dispatch": 5.0}
    assert cm.predict_tiled(3 * 2**30, 5) == sum(
        u * cm.CUDA_COSTS[t] for t, u in feats.items())


@pytest.mark.parametrize("m, interval_s, ds_fn, state_mb", [
    ("sum:10s-sum:til.m{g=*}", 10, "sum", 1),
    ("p99:10s-avg:til.m{g=*}", 10, "avg", 1),
    ("sum:5s-count:til.m{g=*}", 5, "count", 1),
    ("dev:10s-max:rate:til.m{g=*}", 10, "max", 2),
])
def test_tiles_and_stripes_equal_the_reference_s(m, interval_s, ds_fn,
                                                 state_mb):
    got, st = _run(_port(state_mb), m)
    want, ref_st = _run(_ref(state_mb), m)
    assert st["tiledTiles"] == ref_st["tiledTiles"] >= 2
    # the reference reports its stripes on its span: its sizing at its
    # padded window and group counts
    w = SPAN_S // interval_s + 1
    plan = rtiling.size_tiles(24, ref_pad_pow2(w), state_mb * 2**20,
                              ref_acc_cell_bytes(ds_fn, False),
                              ref_pad_pow2(4), 1024)
    assert st["tiledStripesPlanned"] == plan.n_stripes
    # the stripes run cover the real windows only
    assert st["tiledStripes"] == -(-w // plan.stripe_w) <= plan.n_stripes
    assert st["tiledTiles"] == plan.n_tiles
    assert st["tiledPredictedMs"] == pytest.approx(1e3 * cm.predict_tiled(
        st["spillBytes"], st["tiledStripes"]))
    _close(got, want)


def test_moving_average_tiled_equals_the_resident_answer():
    """movingAverage5 as the cross-series aggregator: the port's tiled
    answer is the resident one (K3's sums stitched, MA once over the
    width), while the reference's tiled run restarts the average at each
    stripe and so differs from its own resident answer."""
    m = "movingAverage5:10s-sum:til.m{g=*}"
    got, st = _run(_port(1, float_vals=True), m)
    resident, _ = _run(_port(6144, float_vals=True), m)
    ref_res, _ = _run(_ref(6144, float_vals=True), m)
    ref_tiled, ref_st = _run(_ref(1, float_vals=True), m)
    assert st.get("tiledExecution") == ref_st.get("tiledExecution") == 1.0
    assert got == resident
    _close(got, ref_res)
    with pytest.raises(AssertionError):
        _close(ref_tiled, ref_res)
