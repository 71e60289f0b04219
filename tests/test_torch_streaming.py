"""The streamed route (ops/streaming.py, the planner's streamed arm)
against the reference's, on the CPU.

The cases of tests/test_streaming.py that need no mesh, each on the same
seeded numpy inputs through both packages (the port with ``device="cpu"``,
where S1, S2 and S3 run their plain versions):

* the accumulator: chunked equals one-shot for every function of
  STREAMABLE_DS, sliced equals full, a wrong w0 is counted, the lanes
  restrict the state; values at rtol 1e-9 (torch_parity.RTOL);
* the sketch: the port's grid equals the reference's at float32
  tolerance after one merge and after several, both within the
  documented drift bound of the exact quantile; +inf and -inf values
  come through merges as the reference's do;
* the planner: a query over a lowered point_threshold streams and
  answers like the reference's streamed query and like the port's own
  materialized one; the sketch hazard routes to the exact path; the
  state budget's 413 carries the reference's payload; a cold metric
  streams and queues its cache build.

The reference pads its window grid to a power of two; only the query's
windows are compared.  Its TSDBs run with the mesh off (conftest's 8
virtual CPU devices).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.ops import downsample as rds
from opentsdb_tpu.ops import streaming as rst
from opentsdb_tpu.query import limits as ref_limits
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import downsample as ds
from opentsdb_tpu_torch.ops import streaming as st
from opentsdb_tpu_torch.query.limits import QueryException
from opentsdb_tpu_torch.utils.config import Config

from torch_parity import assert_exact, assert_values

START = 1_356_998_400_000
BASE = START // 1000
PAD = np.iinfo(np.int64).max
K = st.SKETCH_K
SKETCH_RTOL = 1e-6      # the sketch is float32 in both packages


def _sorted_batch(rng, s=4, n=96, span=900_000, width=128):
    ts = np.full((s, width), PAD, np.int64)
    val = np.zeros((s, width), np.float64)
    mask = np.zeros((s, width), bool)
    for i in range(s):
        k = int(rng.integers(n // 2, n))
        ts[i, :k] = START + np.sort(rng.choice(span, size=k, replace=False))
        v = rng.normal(50.0, 20.0, k)
        v[rng.random(k) < 0.04] = np.nan
        val[i, :k] = v
        mask[i, :k] = True
    return ts, val, mask


def _chunks(ts, val, mask, chunk):
    """[S, chunk] pieces of the batch, padded as the planner pads them."""
    s, n = ts.shape
    for k in range(0, n, chunk):
        w = min(chunk, n - k)
        cts = np.full((s, chunk), PAD, np.int64)
        cval = np.zeros((s, chunk), np.float64)
        cmask = np.zeros((s, chunk), bool)
        cts[:, :w] = ts[:, k:k + w]
        cval[:, :w] = val[:, k:k + w]
        cmask[:, :w] = mask[:, k:k + w]
        yield cts, cval, cmask


def _window_slice(ts, windows, chunk):
    """The widest chunk's span in windows, as the planner knows it."""
    out = 1
    for cts, _, _ in _chunks(ts, ts, ts, chunk):
        real = cts[cts != PAD]
        if real.size:
            out = max(out, int((real.max() - real.min())
                               // windows.interval_ms) + 2)
    return out


def _w0(cts, windows):
    real = cts[cts != PAD]
    return 0 if not real.size else int(
        (real.min() - windows.first_window_ms) // windows.interval_ms)


def _stream_both(ts, val, mask, start, end, interval, chunk=17,
                 sliced=False, sketch=False, lanes=None, w0_offset=0):
    """The same chunks through the reference's and the port's
    accumulators -> (reference acc, port acc, window count)."""
    ref_w = rds.FixedWindows.for_range(start, end, interval)
    port_w = ds.FixedWindows.for_range(start, end, interval)
    spec, wargs = ref_w.split()
    s = ts.shape[0]
    ws = _window_slice(ts, port_w, chunk) if sliced else None
    ref = rst.StreamAccumulator.create(s, spec, wargs, sketch=sketch,
                                       lanes=lanes, window_slice=ws)
    port = st.StreamAccumulator.create(s, port_w, "cpu", sketch=sketch,
                                       lanes=lanes, window_slice=ws)
    for cts, cval, cmask in _chunks(ts, val, mask, chunk):
        w0 = _w0(cts, port_w) + w0_offset if sliced else None
        ref.update(jnp.asarray(cts), jnp.asarray(cval), jnp.asarray(cmask),
                   w0=w0)
        port.update(torch.from_numpy(cts), torch.from_numpy(cval),
                    torch.from_numpy(cmask), w0=w0)
    return ref, port, port_w.count


def _finished(acc, fn, w, fill="none", ref=False):
    wts, out, mask = acc.finish(fn, fill) if ref else acc.finish(fn, fill)
    return (np.asarray(wts)[:w], np.asarray(out)[:, :w],
            np.asarray(mask)[:, :w])


# -- the accumulator ---------------------------------------------------------


@pytest.mark.parametrize("ds_fn", sorted(st.STREAMABLE_DS))
def test_chunked_equals_one_shot(ds_fn):
    """Chunks of 17 through the port's accumulator against the
    reference's one-shot downsample and its own chunked accumulator."""
    ts, val, mask = _sorted_batch(np.random.default_rng(11))
    ref_acc, port_acc, w = _stream_both(ts, val, mask, START,
                                        START + 900_000, 60_000)
    windows = rds.FixedWindows.for_range(START, START + 900_000, 60_000)
    spec, wargs = windows.split()
    _, want, wmask = rds.downsample(ts, val, mask, ds_fn, spec, wargs, "none")
    want, wmask = np.asarray(want)[:, :w], np.asarray(wmask)[:, :w]
    wts, got, gmask = _finished(port_acc, ds_fn, w)
    rts, rgot, rmask = _finished(ref_acc, ds_fn, w, ref=True)
    assert_exact(gmask, wmask)
    assert_exact(gmask, rmask)
    assert_exact(wts, rts)
    assert_values(got, want, gmask)
    assert_values(got, rgot, gmask)


@pytest.mark.parametrize("fill", ["zero", "nan", "scalar"])
def test_fill_policy_applies_at_finish(fill):
    ts, val, mask = _sorted_batch(np.random.default_rng(12), s=2)
    ref_acc, port_acc, w = _stream_both(ts, val, mask, START,
                                        START + 1_800_000, 60_000)
    _, got, gmask = _finished(port_acc, "avg", w, fill)
    _, want, wmask = _finished(ref_acc, "avg", w, fill, ref=True)
    assert_exact(gmask, wmask)
    assert_values(got, want)


def test_single_chunk_equals_full():
    ts, val, mask = _sorted_batch(np.random.default_rng(13))
    _, port_acc, w = _stream_both(ts, val, mask, START, START + 900_000,
                                  120_000, chunk=ts.shape[1])
    windows = ds.FixedWindows.for_range(START, START + 900_000, 120_000)
    _, want, wmask = ds.downsample(torch.from_numpy(ts),
                                   torch.from_numpy(val),
                                   torch.from_numpy(mask), "dev",
                                   windows.window_edges("cpu"))
    _, got, gmask = _finished(port_acc, "dev", w)
    assert_exact(gmask, wmask.numpy())
    np.testing.assert_allclose(got[gmask], want.numpy()[gmask], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("ds_fn", sorted(st.STREAMABLE_DS))
def test_sliced_equals_full_stream(ds_fn):
    """900 s of data on 10 s windows: each chunk folds into its slice;
    the grid equals the port's full-grid fold and the reference's sliced
    one."""
    ts, val, mask = _sorted_batch(np.random.default_rng(29))
    ref_acc, port_acc, w = _stream_both(ts, val, mask, START,
                                        START + 900_000, 10_000,
                                        sliced=True)
    _, full, w2 = _stream_both(ts, val, mask, START, START + 900_000, 10_000)
    assert port_acc.window_slice is not None
    assert port_acc.window_slice == ref_acc.window_slice
    assert port_acc.oob_count() == ref_acc.oob_count() == 0
    _, got, gmask = _finished(port_acc, ds_fn, w)
    _, want, wmask = _finished(full, ds_fn, w2)
    _, rgot, rmask = _finished(ref_acc, ds_fn, w, ref=True)
    assert_exact(gmask, wmask)
    assert_exact(gmask, rmask)
    np.testing.assert_allclose(got[gmask], want[wmask], rtol=1e-12,
                               atol=1e-12)
    assert_values(got, rgot, gmask)


def test_sliced_sketch_matches_full():
    ts, val, mask = _sorted_batch(np.random.default_rng(31), s=3)
    ref_acc, port_acc, w = _stream_both(ts, val, mask, START,
                                        START + 900_000, 10_000,
                                        sliced=True, sketch=True)
    _, full, _ = _stream_both(ts, val, mask, START, START + 900_000, 10_000,
                              sketch=True)
    assert port_acc.oob_count() == 0
    _, got, gmask = _finished(port_acc, "p90", w)
    _, want, wmask = _finished(full, "p90", w)
    _, rgot, _ = _finished(ref_acc, "p90", w, ref=True)
    assert_exact(gmask, wmask)
    np.testing.assert_allclose(got[gmask], want[gmask], rtol=SKETCH_RTOL,
                               atol=SKETCH_RTOL)
    np.testing.assert_allclose(got[gmask], rgot[gmask], rtol=SKETCH_RTOL,
                               atol=SKETCH_RTOL)


@pytest.mark.parametrize("offset", [20, 40])
def test_wrong_w0_is_audited_not_silent(offset):
    """Slices shifted off their chunks: the port counts exactly the valid
    points they miss, the reference counts some too (its padded grid
    clips the shifted slices elsewhere, so the counts differ)."""
    ts, val, mask = _sorted_batch(np.random.default_rng(37), s=2)
    ref_acc, port_acc, w = _stream_both(ts, val, mask, START,
                                        START + 900_000, 10_000,
                                        sliced=True, w0_offset=offset,
                                        lanes=st.lanes_for(["sum"]))
    windows = ds.FixedWindows.for_range(START, START + 900_000, 10_000)
    wc = port_acc.window_slice
    missed = 0
    for cts, cval, cmask in _chunks(ts, val, mask, 17):
        w0 = min(max(_w0(cts, windows) + offset, 0), w - wc)
        win = (cts - START) // 10_000
        ok = cmask & ~np.isnan(cval) & (cts != PAD) & (win < w)
        missed += int((ok & ((win < w0) | (win >= w0 + wc))).sum())
    assert port_acc.oob_count() == missed > 0
    assert ref_acc.oob_count() > 0


def test_slice_as_wide_as_grid_falls_back():
    ts, val, mask = _sorted_batch(np.random.default_rng(41), s=2)
    windows = ds.FixedWindows.for_range(START, START + 900_000, 300_000)
    acc = st.StreamAccumulator.create(2, windows, "cpu", window_slice=10_000)
    assert acc.window_slice is None
    acc.update(torch.from_numpy(ts), torch.from_numpy(val),
               torch.from_numpy(mask), w0=0)
    assert acc.oob_count() == 0
    _, out, omask = acc.finish("sum")
    _, want, wm = ds.downsample(torch.from_numpy(ts), torch.from_numpy(val),
                                torch.from_numpy(mask), "sum",
                                windows.window_edges("cpu"))
    assert_exact(omask.numpy(), wm.numpy())
    np.testing.assert_allclose(out.numpy()[omask.numpy()],
                               want.numpy()[wm.numpy()], rtol=1e-12)


@pytest.mark.parametrize("fns", [["sum"], ["avg", "count"], ["dev"],
                                 ["min", "max"], ["first", "last", "diff"],
                                 ["mult"]])
def test_minimal_lanes_answers_match_full(fns):
    rng = np.random.default_rng(51)
    s, n = 4, 512
    ts = (np.sort(rng.integers(0, 3_000_000, (s, n)), axis=1)
          + START).astype(np.int64)
    val = rng.normal(10, 3, (s, n))
    mask = rng.random((s, n)) > 0.1
    _, full, w = _stream_both(ts, val, mask, START, START + 3_000_000,
                              60_000, chunk=128)
    ref_slim, slim, _ = _stream_both(ts, val, mask, START, START + 3_000_000,
                                     60_000, chunk=128,
                                     lanes=st.lanes_for(fns))
    assert set(slim.state) == {"n"} | set(st.lanes_for(fns))
    for fn in fns:
        _, of, mf = _finished(full, fn, w)
        _, os_, ms = _finished(slim, fn, w)
        _, ro, _ = _finished(ref_slim, fn, w, ref=True)
        assert_exact(mf, ms)
        np.testing.assert_allclose(os_[mf], of[mf], rtol=1e-12, atol=1e-12)
        assert_values(os_, ro, mf)


def test_missing_lane_raises_clearly():
    windows = ds.FixedWindows.for_range(0, 3_000_000, 60_000)
    acc = st.StreamAccumulator.create(2, windows, "cpu",
                                      lanes=st.lanes_for(["sum"]))
    with pytest.raises(KeyError, match="lacks lane"):
        acc.finish("max")
    with pytest.raises(KeyError, match="does not stream"):
        acc.finish("p99")


def test_every_wide_grid_chunk_folds_like_the_narrow_path():
    """10 ms windows over the span (W ~ 40x a chunk's points, the shape
    the reference's segment form serves): the port's one S1 answers as
    the one-shot downsample does."""
    rng = np.random.default_rng(71)
    s, n_chunk, chunks = 3, 64, 4
    span = 200_000
    ts = np.sort(rng.choice(span, size=(s, n_chunk * chunks), replace=False),
                 axis=1).astype(np.int64)
    val = rng.normal(50, 20, (s, n_chunk * chunks))
    val[rng.random(val.shape) < 0.04] = np.nan
    mask = rng.random(val.shape) < 0.95
    lanes = st.lanes_for(["sum", "min", "max", "count", "dev"])
    ref_acc, port_acc, w = _stream_both(ts, val, mask, 0, span, 70,
                                        chunk=n_chunk, lanes=lanes)
    windows = ds.FixedWindows.for_range(0, span, 70)
    for fn in ("sum", "min", "max", "count", "dev", "avg"):
        _, got, gm = _finished(port_acc, fn, w)
        _, want, wm = ds.downsample(torch.from_numpy(ts),
                                    torch.from_numpy(val),
                                    torch.from_numpy(mask), fn,
                                    windows.window_edges("cpu"))
        _, rgot, _ = _finished(ref_acc, fn, w, ref=True)
        assert_exact(gm, wm.numpy())
        assert_values(got, want.numpy(), gm)
        assert_values(got, rgot, gm)


# -- the sketch -------------------------------------------------------------


def _exact_window_percentile(vals, q):
    sv = np.sort(vals)
    fr = np.clip(q / 100.0 * len(sv) - 0.5, 0, len(sv) - 1)
    lo = int(np.floor(fr))
    hi = min(lo + 1, len(sv) - 1)
    return sv[lo] + (fr - lo) * (sv[hi] - sv[lo])


@pytest.mark.parametrize("chunk", [4096, 512])
def test_sketch_grid_matches_reference_and_exact(chunk):
    """1 merge (one chunk) and 8: the port's [S, W, K] grid equals the
    reference's at float32 tolerance, and p90, median and p99 stay within
    3 percentiles of the exact ones."""
    rng = np.random.default_rng(31)
    s, n = 3, 4096
    span = 4 * 3_600_000
    ts = (np.sort(rng.integers(0, span, (s, n)), axis=1)
          + START).astype(np.int64)
    val = rng.normal(100, 25, (s, n))
    mask = np.ones((s, n), bool)
    ref_acc, port_acc, w = _stream_both(ts, val, mask, START, START + span,
                                        3_600_000, chunk=chunk, sketch=True)
    np.testing.assert_allclose(port_acc.state["q"].numpy(),
                               np.asarray(ref_acc.state["q"])[:, :w],
                               rtol=SKETCH_RTOL, atol=1e-4)
    for name, q in [("p90", 90.0), ("median", 50.0), ("p99", 99.0)]:
        wts, out, _ = _finished(port_acc, name, w)
        _, rout, _ = _finished(ref_acc, name, w, ref=True)
        np.testing.assert_allclose(out, rout, rtol=SKETCH_RTOL)
        for i in range(s):
            for j in range(w):
                sel = (ts[i] >= wts[j]) & (ts[i] < wts[j] + 3_600_000)
                if sel.sum() < 50:
                    continue
                lo_b = _exact_window_percentile(val[i][sel], max(q - 3, 0))
                hi_b = _exact_window_percentile(val[i][sel], min(q + 3, 100))
                assert lo_b - 1e-9 <= out[i, j] <= hi_b + 1e-9


def test_many_merges_drift_bounded():
    """64 merges into one cell: the port's summary equals the
    reference's, and the p90 stays within 2 rank-percent of exact."""
    rng = np.random.default_rng(41)
    q = torch.zeros((1, K), dtype=torch.float32)
    rq = jnp.zeros((1, K), jnp.float32)
    n = torch.zeros(1, dtype=torch.int64)
    everything = []
    for _ in range(64):
        vals = np.sort(rng.normal(100, 25, 256))
        everything.append(vals)
        grid = st.rank_grid_plain(torch.from_numpy(vals)[None, :],
                                  torch.tensor([[0]]), torch.tensor([[256]]))
        rgrid = rst._rank_grid(jnp.asarray(vals)[None, :], jnp.asarray([[0]]),
                               jnp.asarray([[256]]))
        rq = rst._merge_sketch(rq, jnp.asarray(n.numpy()),
                               rgrid[0].astype(jnp.float32),
                               jnp.asarray([256]))
        q = st.merge_sketch_plain(q, n, grid[0].to(torch.float32),
                                  torch.tensor([256]))
        n = n + 256
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=SKETCH_RTOL)
    allv = np.concatenate(everything)
    est = float(st.sketch_quantile_plain(q, n, 90.0)[0])
    assert np.percentile(allv, 88) <= est <= np.percentile(allv, 92)


@pytest.mark.parametrize("extra", [[np.inf], [-np.inf], [np.inf, np.inf],
                                   [-np.inf, np.inf]])
def test_inf_data_values_survive_merges(extra):
    """Infinite data values through a merge from empty and two empty
    merges after: the port's summary equals the reference's, infinities
    and NaNs in the same places (two equal infinite neighbours
    interpolate to inf - inf in both); a lone +inf stays the grid's last
    point."""
    vals = np.sort(np.concatenate([np.arange(100.0), extra]))
    c = len(vals)
    grid = st.rank_grid_plain(torch.from_numpy(vals)[None, :],
                              torch.tensor([[0]]), torch.tensor([[c]]))[0]
    rgrid = rst._rank_grid(jnp.asarray(vals)[None, :], jnp.asarray([[0]]),
                           jnp.asarray([[c]]))[0]
    q = st.merge_sketch_plain(torch.zeros((1, K), dtype=torch.float32),
                              torch.tensor([0]), grid.to(torch.float32),
                              torch.tensor([c]))
    rq = rst._merge_sketch(jnp.zeros((1, K), jnp.float32), jnp.asarray([0]),
                           rgrid.astype(jnp.float32), jnp.asarray([c]))
    for _ in range(2):
        q = st.merge_sketch_plain(q, torch.tensor([c]),
                                  torch.zeros((1, K), dtype=torch.float32),
                                  torch.tensor([0]))
        rq = rst._merge_sketch(rq, jnp.asarray([c]),
                               jnp.zeros((1, K), jnp.float32),
                               jnp.asarray([0]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    if extra == [np.inf]:       # the reference's own case
        assert np.isinf(q.numpy()[0, -1])
    est = float(st.sketch_quantile_plain(q, torch.tensor([c]), 50.0)[0])
    assert abs(est - 50.0) < 3.0


def _warp_scan_ranks(wt):
    """The midpoint ranks as csrc/sketch_fold.cu's merge computes them:
    lane l's four weights (positions 4l..4l+3) summed in order, a
    Hillis-Steele scan of the 32 lane sums, then each position's running
    weight less half its own."""
    lanes = wt.reshape(32, 4)
    part = np.zeros_like(lanes)
    run = np.zeros(32)
    for r in range(4):
        run = run + lanes[:, r]
        part[:, r] = run
    incl = run.copy()
    d = 1
    while d < 32:
        incl = np.concatenate([incl[:d], incl[d:] + incl[:-d]])
        d *= 2
    before = np.concatenate([[0.0], incl[:-1]])
    return ((before[:, None] + part) - 0.5 * lanes).reshape(-1)


def _tree_ranks(wt):
    """The running weights by a pairwise tree (an up-sweep of sums of
    adjacent blocks, then each prefix from the tree's blocks)."""
    levels = [wt]
    while levels[-1].size > 1:
        levels.append(levels[-1][0::2] + levels[-1][1::2])
    incl = np.zeros_like(wt)
    for i in range(wt.size):
        acc, pos, k = 0.0, i + 1, 0
        while pos:
            if pos & 1:
                acc = acc + levels[k][pos - 1]
            pos >>= 1
            k += 1
        incl[i] = acc
    return incl - 0.5 * wt


@pytest.mark.parametrize("bits", [10, 20, 30, 40])
def test_sketch_midpoint_ranks_are_order_free(bits):
    """S2's merge weighs each point n / K; every running weight is then a
    multiple of 1/K below 2^46, exact in float64, so a warp scan or a
    pairwise tree gives the serial walk's midpoint ranks (and
    merge_sketch_plain's cumsum) bit for bit, counts up to 2^bits."""
    rng = np.random.default_rng(bits)
    for trial in range(200):
        n1, n2 = (int(x) for x in rng.integers(0, 2 ** bits, 2))
        if trial % 10 == 0:
            n1 = 0
        elif trial % 10 == 1:
            n2 = 0
        side = rng.permutation(np.repeat([0, 1], K))
        wt = np.where(side == 0, float(n1) / K, float(n2) / K)
        serial = np.zeros(2 * K)
        run = 0.0
        for i in range(2 * K):
            run = run + wt[i]
            serial[i] = run - 0.5 * wt[i]
        plain = (torch.cumsum(torch.from_numpy(wt), 0)
                 - 0.5 * torch.from_numpy(wt)).numpy()
        for got in (_warp_scan_ranks(wt), _tree_ranks(wt), plain):
            np.testing.assert_array_equal(got.view(np.int64),
                                          serial.view(np.int64))


def _merge_keys(v32):
    """csrc/sketch_fold.cu merge_key of float32 values, the point's index
    in the low 7 bits: order_stats.cuh key_of of the value widened to
    float64, -0.0 keyed as +0.0, a NaN of either sign as the top key."""
    wide = np.where(v32 == 0, 0.0, v32.astype(np.float64))
    b = wide.view(np.uint64)
    neg = (b >> np.uint64(63)) == 1
    key = np.where(neg, ~b, b | np.uint64(1 << 63))
    low = key & np.uint64(0x1FFFFFFF)
    finite = ~np.isnan(v32)
    assert np.all((low[finite] == 0) | (low[finite] == np.uint64(0x1FFFFFFF)))
    key = np.where(np.isnan(v32), ~np.uint64(0), key)
    return (key & ~np.uint64(127)) | np.arange(v32.size, dtype=np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_merge_keys_sort_as_the_stable_argsort(seed):
    """S2's merge sorts 128 float32 points by unique 64-bit keys: the
    value's order-preserving key with the point's index in the 7 low bits
    (0 in every widened float32, all 1 for a negative one), -0.0 as +0.0
    and NaN of either sign last.  Their order is merge_sketch_plain's
    stable sort (and the reference's argsort): equal values by index,
    NaN, infinities and signed zeros included."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45,
                     -1e-45, 3.4e38, -3.4e38, 1.5, -1.5, 2.0],
                    np.float32)
    for _ in range(50):
        v = np.where(rng.random(2 * K) < 0.5,
                     rng.choice(pool, 2 * K),
                     rng.normal(0, 1e3, 2 * K).astype(np.float32))
        v = v.astype(np.float32)
        unique = _merge_keys(v)
        assert np.unique(unique).size == 2 * K
        want = torch.sort(torch.from_numpy(v), stable=True).indices
        np.testing.assert_array_equal(np.argsort(unique), want.numpy())


def _adversarial_drift(n_chunks: int, per_chunk: int = 256) -> float:
    """Every chunk folds into the one "0all" cell, as an ascending run of
    values disjoint from the others: the worst case for the summary."""
    n = n_chunks * per_chunk
    windows = ds.AllWindow(0, n * 1000)
    acc = st.StreamAccumulator.create(1, windows, "cpu", sketch=True,
                                      lanes=st.lanes_for(["p50"]))
    for c in range(n_chunks):
        vals = np.arange(c * per_chunk, (c + 1) * per_chunk, dtype=np.float64)
        acc.update(torch.from_numpy((vals * 1000).astype(np.int64)[None, :]),
                   torch.from_numpy(vals[None, :]),
                   torch.ones((1, per_chunk), dtype=torch.bool))
    worst = 0.0
    for pct in (10.0, 25.0, 50.0, 75.0, 90.0):
        _, out, mask = acc.finish("p%g" % pct if pct != 50.0 else "median")
        assert bool(mask.all())
        est = float(out.reshape(-1)[0])
        worst = max(worst, abs(est - pct / 100.0 * (n - 1)) / n)
    return worst


@pytest.mark.parametrize("n_chunks", [1, 4, 16])
def test_adversarial_chunking_stays_within_documented_bound(n_chunks):
    bound = 0.5 / K if n_chunks == 1 else 1.25 * n_chunks / (2.0 * K) + 1e-3
    assert _adversarial_drift(n_chunks) <= bound


# -- the planner ---------------------------------------------------------------


def _tsdbs(threshold, chunk_points=64, **over):
    """(reference, port) TSDBs with the streaming keys."""
    props = {"tsd.core.auto_create_metrics": True,
             "tsd.query.streaming.point_threshold": str(threshold),
             "tsd.query.streaming.chunk_points": str(chunk_points), **over}
    return (RefTSDB(RefConfig({**props, "tsd.query.mesh.enable": False})),
            TSDB(Config(props), device="cpu"))


def _run(tsdb, m, start=BASE, end=BASE + 36_000):
    ref = isinstance(tsdb, RefTSDB)
    q = (RefTSQuery if ref else TSQuery)(
        start=str(start), end=str(end),
        queries=[(ref_parse if ref else parse_m_subquery)(m)])
    q.validate()
    runner = tsdb.new_query_runner()
    return [r.to_json() for r in runner.run(q)], runner.exec_stats


def _ingest(tsdbs, points=3000, seed=5, metric="sys.s", step=11):
    for tsdb in tsdbs:
        rng = np.random.default_rng(seed)
        for h in range(3):
            for k in range(points):
                tsdb.add_point(metric, BASE + k * step + h,
                               float(rng.normal(10, 3)), {"host": "h%d" % h})


def _same(got, want, rtol=1e-9):
    assert [(g["metric"], g["tags"], sorted(g["dps"])) for g in got] \
        == [(w["metric"], w["tags"], sorted(w["dps"])) for w in want]
    for g, w in zip(got, want):
        keys = sorted(w["dps"])
        np.testing.assert_allclose([g["dps"][k] for k in keys],
                                   [w["dps"][k] for k in keys], rtol=rtol,
                                   atol=1e-9)


@pytest.mark.parametrize("m", [
    "sum:2m-avg:sys.s{host=*}",
    "avg:5m-sum:sys.s",
    "max:2m-dev:sys.s{host=*}",
    "sum:rate:2m-avg:sys.s",
    "min:10m-squareSum:sys.s{host=*}",
    "sum:1m-first:sys.s{host=*}",
    "sum:15m-diff:sys.s",
    "sum:1h-min:sys.s",
    "sum:1h-count:sys.s{host=*}",
])
def test_streamed_equals_materialized(m):
    """3 series x 3,000 points, chunks of 1,024 (3 a series): the port's
    streamed answer against the reference's streamed answer and the
    port's materialized one."""
    ref, port = _tsdbs(threshold=10)
    _, plain = _tsdbs(threshold=10**9)
    _ingest([ref, port, plain])
    got, stats = _run(port, m)
    want, ref_stats = _run(ref, m)
    mat, mat_stats = _run(plain, m)
    assert stats["streamedChunks"] == ref_stats["streamedChunks"] == 3
    assert "streamedChunks" not in mat_stats
    _same(got, want)
    _same(got, mat)


def test_streamed_percentile_close_to_materialized():
    """sum:10m-p90 streams through the sketch in both packages: the
    port's answer equals the reference's at float32 tolerance and is
    within 8% of the exact materialized p90."""
    ref, port = _tsdbs(threshold=10, chunk_points=256)
    _, plain = _tsdbs(threshold=10**9, chunk_points=256)
    _ingest([ref, port, plain], points=1200, seed=33, metric="sys.px",
            step=6)
    m = "sum:10m-p90:sys.px{host=*}"
    got, stats = _run(port, m, end=BASE + 7200)
    want, _ = _run(ref, m, end=BASE + 7200)
    exact, _ = _run(plain, m, end=BASE + 7200)
    assert stats["streamedChunks"] == 2
    _same(got, want, rtol=SKETCH_RTOL)
    for g, w in zip(got, exact):
        for key, wv in w["dps"].items():
            assert abs(g["dps"][key] - wv) <= 0.08 * max(abs(wv), 1.0)


@pytest.mark.parametrize("over, hazard", [
    ({}, True),
    ({"tsd.query.streaming.sketch_max_merges": "0"}, False),
])
def test_hazard_shape_auto_routes_exact(over, hazard):
    """One window over everything (every chunk merges into one cell, ~6
    merges > 4): both packages take the exact path and answer exactly;
    with sketch_max_merges 0 both sketch, within the C/(2K) rank bound."""
    n_pts = 6000
    data = np.random.default_rng(77).normal(40, 12, n_pts)
    props = {"tsd.query.device_cache.enable": "false", **over}
    ref, port = _tsdbs(threshold=10, chunk_points=512, **props)
    _, exact_t = _tsdbs(threshold=10**9, chunk_points=512, **{
        "tsd.query.streaming.sketch_percentiles": "false"})
    for t in (ref, port, exact_t):
        for k in range(n_pts):
            t.add_point("hz.m", BASE + k, float(data[k]), {"h": "a"})
    m = "sum:0all-p50:hz.m"
    got, stats = _run(port, m, BASE - 1, BASE + n_pts + 1)
    want, ref_stats = _run(ref, m, BASE - 1, BASE + n_pts + 1)
    exact, _ = _run(exact_t, m, BASE - 1, BASE + n_pts + 1)
    assert stats.get("sketchHazardExact") == ref_stats.get(
        "sketchHazardExact") == (1.0 if hazard else None)
    if hazard:
        assert got[0]["dps"] == exact[0]["dps"]
        _same(got, want)
    else:
        _same(got, want, rtol=SKETCH_RTOL)
        value = list(got[0]["dps"].values())[0]
        rank = np.searchsorted(np.sort(data), value) / n_pts
        assert abs(rank - 0.5) <= -(-n_pts // 1024) / (2 * K) + 1 / K


def test_hazard_estimate_is_skew_exact():
    """12,000 points inside one minute, then 200 across a week of 60 s
    windows: the boundary count sees the ~12 merges of the dense cell in
    both packages."""
    ref, port = _tsdbs(threshold=10, chunk_points=512, **{
        "tsd.query.device_cache.enable": "false"})
    for t in (ref, port):
        rng = np.random.default_rng(13)
        for k in range(12_000):
            t.add_point("sk2.m", BASE * 1000 + k * 5, float(rng.normal()),
                        {"h": "a"})
        week = 7 * 86_400
        for k in range(200):
            t.add_point("sk2.m", BASE + 120 + k * (week // 200),
                        float(rng.normal()), {"h": "a"})
    m = "sum:60s-p90:sk2.m"
    got, stats = _run(port, m, BASE - 1, BASE + 7 * 86_400)
    want, ref_stats = _run(ref, m, BASE - 1, BASE + 7 * 86_400)
    assert stats.get("sketchHazardExact") == ref_stats.get(
        "sketchHazardExact") == 1.0
    _same(got, want)


@pytest.mark.parametrize("m, state_mb, span, series", [
    ("sum:10s-avg:big.m", 1, 40_000_000, 1),
    ("p99:60s-p99:sk.m", 10, 400_000, 8),
])
def test_oversized_streaming_state_refused_alike(m, state_mb, span, series):
    """The streaming state over tsd.query.streaming.state_mb: the same
    413, message and details, in both packages (the reference with its
    tiled execution off, which the port does not have yet)."""
    ref, port = _tsdbs(threshold=10, **{
        "tsd.query.device_cache.enable": "false",
        "tsd.query.spill.enable": "false",
        "tsd.query.streaming.state_mb": str(state_mb)})
    metric = m.rsplit(":", 1)[1]
    for t in (ref, port):
        for h in range(series):
            for i in range(40 if series > 1 else 200):
                n = 40 if series > 1 else 200
                t.add_point(metric, BASE + i * (span // n) + h, float(i),
                            {"h": "h%d" % h})
    got = []
    for t, exc in ((ref, ref_limits.QueryException),
                   (port, QueryException)):
        with pytest.raises(exc) as info:
            _run(t, m, BASE, BASE + span)
        got.append((info.value.status, str(info.value),
                    info.value.details))
    assert got[0] == got[1]
    assert "accelerator memory" in got[1][1]


def test_cold_metric_streams_then_the_cache_serves():
    """Over the threshold a cold metric streams and queues its cache
    build (no inline build); after refresh() the same query hits, with
    the streamed answer; the reference does the same."""
    ref, port = _tsdbs(threshold=10)
    _ingest([ref, port], points=500)
    m = "sum:2m-avg:sys.s{host=*}"
    res, s1 = _run(port, m)
    rres, rs1 = _run(ref, m)
    assert s1["streamedChunks"] > 0 and "deviceCacheHit" not in s1
    assert "deviceCacheHit" not in rs1
    assert port.device_cache.builds == ref.device_cache.builds == 0
    assert port.device_cache.refresh() == 1
    assert ref.device_cache.refresh(ref.store) == 1
    res2, s2 = _run(port, m)
    rres2, rs2 = _run(ref, m)
    assert s2.get("deviceCacheHit") == rs2.get("deviceCacheHit") == 1.0
    assert "streamedChunks" not in s2
    assert json.dumps(res2, sort_keys=True) == json.dumps(res, sort_keys=True)
    _same(res2, rres2)
    _same(res, rres)


def test_chunk_cursor_reads_each_point_once():
    """window_chunk's timestamp cursor: chunks of 7 over a series that
    takes an out-of-order write between reads return every point that
    was there when the scan began exactly once, in time order."""
    _, port = _tsdbs(threshold=10)
    for k in range(50):
        port.add_point("cur.m", BASE + 2 * k, float(k), {"h": "a"})
    series = port.store.all_series()[0]
    seen, cursor = [], None
    ts_row, val_row = np.empty(7, np.int64), np.empty(7)
    while True:
        t, v = series.window_chunk(START, START + 200_000, cursor, 7, True,
                                   ts_row, val_row)
        if not len(t):
            break
        seen.extend(t.tolist())
        cursor = int(t[-1])
        if len(seen) == 14:
            port.add_point("cur.m", BASE + 1, 99.0, {"h": "a"})  # behind
    assert seen == [START + 2000 * k for k in range(50)]
    now = sorted(seen + [START + 1000])
    assert series.window_stride_timestamps(START, START + 200_000,
                                           7).tolist() == now[::7]
