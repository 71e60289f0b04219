#!/usr/bin/env python3
"""Chip check of opentsdb_tpu_torch: build the CUDA kernels, hold each
against its plain PyTorch version on the card, then answer queries end to
end through the port's TSDB: grouped downsample queries and queries
without a downsample (the union path).

    python3 chip_smoke.py

Needs one CUDA card (exits 2 without one) and the repository around it.
The shape is the repository's headline query batch (bench.py): 1024
series in 100 tag groups, 65,536 points each at a ~15.5 s cadence (~11.8
days), 1h windows.  Phases:

1. build: nvcc compiles opentsdb_tpu_torch/csrc/*.cu for sm_90a, one
   process per source, all at once (ops/kernels.py).
2. kernels: K1 window_moments, K2 grid_fill_rate and K3 group_moments on
   the headline batch, each case against the plain version on the same
   inputs: values within rtol 1e-9 (plus atol 1e-9 for exact zeros),
   masks exact.  Times are the median of 7 CUDA-event timed runs.
3. end to end, grouped: a TSDB on the card ingests the batch through
   MemStore.add_batch and answers three grouped queries; the count query
   must count every point written, and each answer on a filtered query
   must match a TSDB on the CPU holding the same state (load_state).
   Kernel launch counts are reset before this phase and read after it.
4. union kernels: U1 union_merge and U2 union_reduce (a) on the headline
   batch as it is, under all eleven aggregators; (b) on all 1024 rows as
   one group over the last 6 h (the fan-in of `sum:metric` over a fleet);
   (c) on an integer copy of 64 rows in 8 groups near 2^53 (int mode,
   exact but for dev, a truncated float); R point_rate (d) on the headline
   batch under every rate option set, float and all-integer.
5. end to end, union: the same TSDB plus an integer metric `mi` (64
   series x 65,536 points in 8 groups) answers five queries without a
   downsample over the last 6 h of the range (the union path emits a point
   per distinct timestamp, so the full range would be ~6.7e7 points of
   Python extraction a query); each filtered answer must match the CPU
   copy.  Launch counts are reset before this phase and read after it.

Prints a line per case (worst absolute and relative error, and the worst
error as a share of its limit), the `kernels` JSON line, the card's name
and power limit, and last the result line.  Any failed check exits 1 before
the result line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

S = 1024              # series
N = 65_536            # points per series
GROUPS = 100
START = 1_356_998_400_000
STEP_MS = 15_500      # mean cadence; jitter below keeps rows strictly sorted
INTERVAL_MS = 3_600_000
END = START + N * STEP_MS + 5_000
RTOL = 1e-9
ATOL = 1e-9
HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
F64_FLOPS = 34e12         # H100 SXM float64 rate outside the tensor cores
FUNCS = ["sum", "zimsum", "pfsum", "count", "avg", "min", "mimmin", "max",
         "mimmax", "dev", "squareSum"]
FILLS = ["none", "zero", "nan", "scalar"]
POLICIES = ["lerp", "zim", "max", "min", "prev"]
RATE_SETS = {"none": None, "rate": (), "counter": (True,),
             "counter_max": (True, 250_000),
             "counter_max_reset": (True, 250_000, 10),
             "drop_resets": (True, 2**63 - 1, 0, True)}
REPLACES = {
    "window_moments": "opentsdb_tpu/ops/downsample.py:1108",
    "grid_fill_rate": "opentsdb_tpu/ops/group_agg.py:354",
    "group_moments": "opentsdb_tpu/ops/group_agg.py:420",
    "union_merge": "opentsdb_tpu/ops/union_agg.py:65",
    "union_reduce": "opentsdb_tpu/ops/union_agg.py:143",
    "point_rate": "opentsdb_tpu/ops/rate.py:58",
}
SIX_HOURS_MS = 6 * 3_600_000
INT_ROWS, INT_GROUPS = 64, 8   # the integer metric `mi`


class Checks:
    """Collects comparison failures and per-kernel worst errors: absolute,
    relative (over cells whose reference is not 0) and as a share of the
    case's limit ATOL + RTOL * |want| (at most 1 passes).  A NaN where the
    other side holds a number counts as an infinite error."""

    def __init__(self):
        self.failures: list[str] = []
        self.worst: dict[str, dict[str, float]] = {}

    def _note(self, kernel: str, **errs) -> None:
        worst = self.worst.setdefault(kernel, dict.fromkeys(errs, 0.0))
        for key, x in errs.items():
            worst[key] = max(worst[key], math.inf if math.isnan(x) else x)

    def values(self, kernel: str, case: str, got, want) -> None:
        got = got.double().cpu()
        want = want.double().cpu()
        both_nan = torch.isnan(got) & torch.isnan(want)
        diff = torch.where(both_nan, 0.0, (got - want).abs())
        # inf == inf is a match (empty extremes never leave the kernel,
        # but MAX/MIN_IF_MISSING put f64 max in K2's output)
        diff = torch.where(got == want, 0.0, diff)
        abs_err = float(diff.max()) if diff.numel() else 0.0
        nz = want.abs() > 0
        rel_err = float((diff[nz] / want.abs()[nz]).max()) if nz.any() else 0.0
        limit = ATOL + RTOL * want.abs().nan_to_num(0.0)
        to_limit = float((diff / limit).max()) if diff.numel() else 0.0
        ok = bool((diff <= limit).all())
        self._note(kernel, abs=abs_err, rel=rel_err, to_limit=to_limit)
        print("%-15s %-44s max_abs=%.3e max_rel=%.3e of_limit=%.3e %s"
              % (kernel, case, abs_err, rel_err, to_limit,
                 "ok" if ok else "FAIL"))
        if not ok:
            self.failures.append("%s %s: values differ (max_abs %.3e)"
                                 % (kernel, case, abs_err))

    def exact(self, kernel: str, case: str, got, want,
              what: str = "masks") -> None:
        """Equal tensors: a difference counts as an infinite error."""
        same = torch.equal(got.cpu(), want.cpu())
        err = 0.0 if same else math.inf
        self._note(kernel, abs=err, rel=err, to_limit=err)
        if not same:
            self.failures.append("%s %s: %s differ" % (kernel, case, what))
            print("%-15s %-44s %s FAIL" % (kernel, case, what))


def time_ms(fn, reps: int = 7) -> float:
    """Median of `reps` CUDA-event timed runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / F64_FLOPS) * 1e3


def headline_batch():
    """bench.py's closed-form batch: absolute int64 ms timestamps, float64
    values, every slot present; gid in contiguous group runs."""
    rows = np.arange(S, dtype=np.int64)[:, None]
    cols = np.arange(N, dtype=np.int64)[None, :]
    h = (rows * 2_654_435_761 + cols * 40_503) & 0x7FFFFFFF
    ts = START + cols * STEP_MS + h % 5_000
    val = 100.0 + (h % 1_000).astype(np.float64) * 0.05
    gid = (np.arange(S, dtype=np.int64) * GROUPS) // S
    return ts, val, gid, h


def kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops.rate import RateOptions
    from opentsdb_tpu_torch.utils import datetime_util as DT

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    # the checks also cover masked slots and NaN values
    d_h = torch.from_numpy(h).to(dev)
    c_mask = d_mask & (d_h % 97 != 0)
    c_val = torch.where(d_h % 211 == 0, torch.nan, d_val)
    del d_h
    grids = {
        "fixed": ds.FixedWindows.for_range(START, END, INTERVAL_MS),
        "calendar": ds.EdgeWindows(tuple(DT.calendar_window_edges(
            START, END, 1, "h", "Asia/Kathmandu"))),
        "all": ds.AllWindow(START, END),
    }
    for kind, plan in grids.items():
        edges = plan.window_edges(dev)
        for func in FUNCS:
            for fill in FILLS:
                got = ds.window_moments(d_ts, c_val, c_mask, edges, func,
                                        fill, -1.5)
                want = ds.window_moments_plain(d_ts, c_val, c_mask, edges,
                                               func, fill, -1.5)
                case = "%s %s fill=%s" % (kind, func, fill)
                checks.exact("window_moments", case, got[1], want[1])
                checks.values("window_moments", case, got[0], want[0])
    edges = grids["fixed"].window_edges(dev)
    int_val = (torch.from_numpy(h % 1_000)).to(dev)
    got = ds.window_moments(d_ts, int_val, c_mask, edges, "sum")
    want = ds.window_moments_plain(d_ts, int_val, c_mask, edges, "sum")
    checks.exact("window_moments", "fixed sum int64 values", got[1], want[1])
    checks.values("window_moments", "fixed sum int64 values", got[0],
                  want[0])
    del int_val, c_val, c_mask

    # the main path's K1 call: sum:1h-avg on the clean batch.  Its bound
    # reads val and mask once (9 B a point) but ts only where an edge
    # falls: one 8-byte lookup per edge and row, never a pass over ts.
    w = edges.numel() - 1
    # the library yardstick: torch.segment_reduce over the same window
    # runs, their lengths from the plain edge search outside the timed
    # call (every point of the batch lies inside the windows)
    pos = torch.searchsorted(d_ts, edges.expand(S, -1).contiguous())
    lengths = (pos[:, 1:] - pos[:, :-1]).reshape(-1)
    flat = d_val.reshape(-1)
    if int(lengths.sum()) != S * N:
        checks.failures.append("segment_reduce lengths miss points")
    seg = {red: time_ms(lambda red=red: torch.segment_reduce(
        flat, red, lengths=lengths)) for red in ("sum", "max", "mean")}
    print("time segment_reduce sum %.4f ms  max %.4f ms  mean %.4f ms "
          "(K1 library, %d runs)" % (seg["sum"], seg["max"], seg["mean"],
                                     lengths.numel()))
    del pos, lengths, flat
    k1 = {
        "ms": time_ms(lambda: ds.window_moments(d_ts, d_val, d_mask, edges,
                                                "avg")),
        "plain_ms": time_ms(lambda: ds.window_moments_plain(
            d_ts, d_val, d_mask, edges, "avg")),
        "bound_ms": bound_ms(S * N * (8 + 1) + S * (w + 1) * 8
                             + (w + 1) * 8 + S * w * (8 + 1), 2.0 * S * N),
        "library_ms": seg["mean"],
    }
    v, m = ds.window_moments(d_ts, d_val, d_mask, edges, "avg")
    wts = edges[:w]
    del d_ts, d_val, d_mask

    # K2 on the [S, W] grid, with holes punched in and without
    hole = (torch.arange(S * w, device=dev).reshape(S, w) * 7919) % 13 == 0
    grids2 = {"holes": (torch.where(hole, torch.nan, v), m & ~hole),
              "no holes": (v.nan_to_num(0.0), torch.ones_like(m))}
    for gname, (gv, gm) in grids2.items():
        for policy in POLICIES:
            for rname, rargs in RATE_SETS.items():
                opts = None if rargs is None else RateOptions(*rargs)
                got = ga.grid_fill_rate(wts, gv, gm, policy, opts)
                want = ga.grid_fill_rate_plain(wts, gv, gm, policy, opts)
                case = "%s policy=%s rate=%s" % (gname, policy, rname)
                checks.exact("grid_fill_rate", case, got[1], want[1])
                checks.exact("grid_fill_rate", case, got[2], want[2])
                checks.values("grid_fill_rate", case, got[0], want[0])
    k2 = {
        "ms": time_ms(lambda: ga.grid_fill_rate(wts, v, m, "lerp")),
        "plain_ms": time_ms(lambda: ga.grid_fill_rate_plain(wts, v, m,
                                                            "lerp")),
        "bound_ms": bound_ms(S * w * (8 + 1) + w * 8 + S * w * (8 + 1 + 1),
                             4.0 * S * w),
        "library_ms": None,
    }

    # K3 over the main path's contributions, and the skew case
    contrib, part, present = ga.grid_fill_rate(wts, v, m, "lerp")
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    for agg in FUNCS:
        got = ga.group_moments(agg, contrib, part, present, offsets)
        want = ga.group_moments_plain(agg, contrib, part, present, offsets)
        checks.exact("group_moments", agg, got[1], want[1])
        checks.values("group_moments", agg, got[0], want[0])
    rng = np.random.default_rng(0)
    scale = np.where(gid % 2 == 0, 1e15, 1.0)[:, None]
    skew_np = scale * (1.0 + rng.normal(0, 1e-3, (S, w)))
    skew = torch.from_numpy(skew_np).to(dev)
    ones = torch.ones((S, w), dtype=torch.bool, device=dev)
    for agg in ("sum", "avg", "dev", "squareSum"):
        got = ga.group_moments(agg, skew, ones, ones, offsets)
        want = ga.group_moments_plain(agg, skew, ones, ones, offsets)
        checks.values("group_moments", "skew 1e15/1.0 " + agg, got[0],
                      want[0])
    small = gid % 2 == 1
    exact_sum = np.zeros((GROUPS, w))
    np.add.at(exact_sum, gid[small], skew_np[small])
    small_groups = torch.from_numpy(np.unique(gid[small]))
    got = ga.group_moments("sum", skew, ones, ones, offsets)[0].cpu()
    checks.values("group_moments", "skew 1.0 groups vs numpy",
                  got[small_groups],
                  torch.from_numpy(exact_sum)[small_groups])
    d_gid = torch.from_numpy(gid).to(dev)
    k3 = {
        "ms": time_ms(lambda: ga.group_moments("sum", contrib, part, present,
                                               offsets)),
        "plain_ms": time_ms(lambda: ga.group_moments_plain(
            "sum", contrib, part, present, offsets)),
        "bound_ms": bound_ms(S * w * (8 + 1 + 1) + (GROUPS + 1) * 8
                             + GROUPS * w * (8 + 1), 2.0 * S * w),
        "library_ms": time_ms(lambda: torch.zeros(
            (GROUPS, w), dtype=torch.float64, device=dev).index_add_(
                0, d_gid, contrib)),
    }
    times = {"window_moments": k1, "grid_fill_rate": k2, "group_moments": k3}
    print_times(times)
    return times


def print_times(times: dict) -> None:
    for name, t in times.items():
        print("time %-15s kernel %.4f ms  plain %.4f ms  bound %.4f ms (%s)  "
              "library %s" % (name, t["ms"], t["plain_ms"], t["bound_ms"],
                              t.get("bound_by", "bytes"),
                              "%.4f ms" % t["library_ms"]
                              if t["library_ms"] is not None else "none"))


def _query(m: str, start: int = START):
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    q = TSQuery(start=str(start), end=str(END), queries=[parse_m_subquery(m)])
    q.validate()
    return q


def e2e_phase(dev, ts, val, checks: Checks):
    from opentsdb_tpu_torch.core import TSDB, load_state
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.query.planner import PHASES
    from opentsdb_tpu_torch.storage.memstore import SeriesKey
    from opentsdb_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True}), device=dev)
    metric = tsdb.metrics.get_or_create_id("m")
    k_host = tsdb.tag_names.get_or_create_id("host")
    k_group = tsdb.tag_names.get_or_create_id("group")
    for i in range(S):
        key = SeriesKey.make(metric, {
            k_host: tsdb.tag_values.get_or_create_id("h%04d" % i),
            k_group: tsdb.tag_values.get_or_create_id(
                "g%03d" % (i * GROUPS // S))})
        tsdb.store.add_batch(key, ts[i], val[i], False)
    ingest_s = time.perf_counter() - t0
    points = tsdb.store.total_datapoints
    print("e2e ingest %.3f s, %d series, %d points" % (ingest_s, S, points))
    if points != S * N:
        checks.failures.append("ingest stored %d points" % points)

    queries = ["sum:1h-avg:m{group=*}", "sum:1h-count:m{group=*}",
               "sum:1h-max:rate:m{group=*}"]
    subset = "{group=g000|g001|g002|g003}"
    kernels.reset_launches()
    answers, filtered = {}, {}
    for m in queries:
        runner = tsdb.new_query_runner()
        runner.run(_query(m))                    # warm-up
        walls, splits = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            res = runner.run(_query(m))
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(runner.exec_stats))
        answers[m] = res
        wall = statistics.median(walls)
        split = {p: statistics.median(s[p + "Ms"] for s in splits)
                 for p in PHASES}
        print("e2e %-30s wall %.1f ms (median of 5) | build %.1f h2d %.1f "
              "kernels %.1f extract %.1f ms | kernel share %.4f | %.3e "
              "points/s | %d results"
              % (m, wall, split["build"], split["h2d"], split["kernels"],
                 split["extract"], split["kernels"] / wall,
                 points / (wall / 1e3), len(res)))
        filtered[m] = tsdb.new_query_runner().run(
            _query(m.replace("{group=*}", subset)))
    launches = dict(kernels.LAUNCHES)
    print("e2e launches %s" % json.dumps(launches))
    for name in ("window_moments", "grid_fill_rate", "group_moments"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the main "
                                   "path" % name)

    for m, res in answers.items():
        if len(res) != GROUPS:
            checks.failures.append("%s: %d results" % (m, len(res)))
        vals = np.array([v for r in res for _, v in r.dps], np.float64)
        if vals.size == 0 or not np.isfinite(vals).all():
            checks.failures.append("%s: empty or non-finite values" % m)
    total = sum(v for r in answers["sum:1h-count:m{group=*}"]
                for _, v in r.dps)
    print("e2e count total %d (written %d)" % (total, S * N))
    if total != S * N:
        checks.failures.append("count query totals %d, not %d"
                               % (total, S * N))

    # the same state on the CPU, through load_state, on the filtered query
    uid_maps = {kind: tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    wanted = {tsdb.tag_values.get_id("g%03d" % g) for g in range(4)}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in tsdb.store.all_series()
              if dict(s.key.tags)[k_group] in wanted]
    cpu = load_state(uid_maps, series, device="cpu")
    for m in queries:
        fm = m.replace("{group=*}", subset)
        want = cpu.new_query_runner().run(_query(fm))
        got = filtered[m]
        same = [(a.tags, [t for t, _ in a.dps]) for a in got] \
            == [(b.tags, [t for t, _ in b.dps]) for b in want]
        if not same:
            checks.failures.append("%s: card and CPU differ in groups or "
                                   "timestamps" % fm)
            continue
        checks.values("e2e", fm,
                      torch.tensor([v for a in got for _, v in a.dps]),
                      torch.tensor([v for b in want for _, v in b.dps]))
    return tsdb, launches


def _last_hours(ts: np.ndarray, val: np.ndarray, start: int):
    """Each row's points at or after `start`, as a prefix padded at
    int64 max: (ts, val, mask)."""
    keep = ts >= start
    n = int(keep.sum(axis=1).max())
    out_ts = np.full((ts.shape[0], n), np.iinfo(np.int64).max, np.int64)
    out_val = np.zeros((ts.shape[0], n), val.dtype)
    counts = keep.sum(axis=1)
    for r in range(ts.shape[0]):
        out_ts[r, :counts[r]] = ts[r][keep[r]]
        out_val[r, :counts[r]] = val[r][keep[r]]
    return out_ts, out_val, np.arange(n)[None, :] < counts[:, None]


def _union_cases(name, d_ts, d_val, d_mask, offsets,
                 checks: Checks, exact_ints: bool):
    """U1, then U2 under every aggregator (each with its own
    interpolation policy), each against its plain version; returns
    (u, uoff) of the kernel."""
    from opentsdb_tpu_torch.ops import union_agg as ua
    from opentsdb_tpu_torch.ops.aggregators import get_agg

    u, uoff = ua.union_merge(d_ts, d_mask, offsets)
    pu, puoff = ua.union_merge_plain(d_ts, d_mask, offsets)
    checks.exact("union_merge", name + " u", u, pu, "timestamps")
    checks.exact("union_merge", name + " uoff", uoff, puoff, "offsets")
    print("%-15s %-44s U=%d %s" % ("union_merge", name, u.numel(),
                                   "ok" if torch.equal(u, pu) else "FAIL"))
    for agg in FUNCS:
        policy = get_agg(agg).interpolation
        got = ua.union_reduce(d_ts, d_val, d_mask, offsets, u, uoff, agg,
                              policy)
        want = ua.union_reduce_plain(d_ts, d_val, d_mask, offsets, u, uoff,
                                     agg, policy)
        case = "%s %s policy=%s" % (name, agg, policy)
        if exact_ints and agg != "dev":
            checks.exact("union_reduce", case, got, want, "int64 values")
            print("%-15s %-44s exact %s" % (
                "union_reduce", case,
                "ok" if torch.equal(got, want) else "FAIL"))
        else:
            checks.values("union_reduce", case, got, want)
    return u, uoff


def union_kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import rate as rt
    from opentsdb_tpu_torch.ops import union_agg as ua

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    offsets = ga.group_offsets(gid, GROUPS).to(dev)

    # (a) the headline batch as it is: ~6.55e5 union slots a group
    u, uoff = _union_cases("(a) headline", d_ts, d_val, d_mask,
                           offsets, checks, False)
    n_slots = u.numel()
    s_g = S / GROUPS
    keys = torch.from_numpy(gid).to(dev)[:, None] * (1 << 42) + d_ts
    u1 = {
        "ms": time_ms(lambda: ua.union_merge(d_ts, d_mask, offsets)),
        "plain_ms": time_ms(lambda: ua.union_merge_plain(d_ts, d_mask,
                                                         offsets), 3),
        # each timestamp read once, each union slot written once
        "bound_ms": bound_ms(S * N * 8 + n_slots * 8, 0.0),
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.unique(keys)),
    }
    del keys
    u2_ops = n_slots * s_g   # one f64 add a member and slot at least
    u2 = {
        "ms": time_ms(lambda: ua.union_reduce(d_ts, d_val, d_mask, offsets,
                                              u, uoff, "sum", "lerp")),
        "plain_ms": time_ms(lambda: ua.union_reduce_plain(
            d_ts, d_val, d_mask, offsets, u, uoff, "sum", "lerp"), 3),
        "bound_ms": bound_ms(S * N * 17 + n_slots * 16 + (GROUPS + 1) * 16,
                             u2_ops),
        "bound_by": "bytes" if S * N * 17 + n_slots * 16
        > u2_ops / F64_FLOPS * HBM_BYTES_S else "operations",
        "library_ms": None,
    }
    del u, uoff

    # (b) all 1024 rows as one group over the last 6 h
    b_ts, b_val, b_mask = _last_hours(ts, val, END - SIX_HOURS_MS)
    bd = [torch.from_numpy(x).to(dev) for x in (b_ts, b_val, b_mask)]
    one = torch.tensor([0, S], dtype=torch.int64, device=dev)
    u, uoff = _union_cases("(b) ungrouped 6h", *bd, one, checks,
                           False)
    pairs = u.numel() * S
    b_ms = time_ms(lambda: ua.union_reduce(*bd, one, u, uoff, "sum",
                                           "lerp"))
    m_ms = time_ms(lambda: ua.union_merge(bd[0], bd[2], one))
    print("time (b) ungrouped 6h: %d rows x %d points, U=%d, %.3e "
          "member-slot pairs | union_merge %.4f ms, union_reduce sum %.4f ms"
          " (ops bound %.4f ms)" % (S, b_ts.shape[1], u.numel(), pairs,
                                    m_ms, b_ms, bound_ms(0.0, pairs)))
    del bd, u, uoff

    # (c) an integer copy of 64 rows in 8 groups, values near 2^53
    c_val = (h[:INT_ROWS] % 1_000).astype(np.int64) + 2**53 - 500
    c_gid = (np.arange(INT_ROWS, dtype=np.int64) * INT_GROUPS) // INT_ROWS
    _union_cases("(c) int64 near 2^53",
                 d_ts[:INT_ROWS], torch.from_numpy(c_val).to(dev),
                 d_mask[:INT_ROWS],
                 ga.group_offsets(c_gid, INT_GROUPS).to(dev), checks, True)

    # (d) R on the headline batch under every rate option set
    i_val = torch.from_numpy(h % 1_000 + 2**53).to(dev)
    for vname, v in (("float", d_val), ("all_int", i_val)):
        for rname, rargs in RATE_SETS.items():
            if rargs is None:
                continue
            opts = rt.RateOptions(*rargs)
            got = rt.point_rate(d_ts, v, d_mask, opts)
            want = rt.point_rate_plain(d_ts, v, d_mask, opts)
            case = "(d) %s rate=%s" % (vname, rname)
            checks.exact("point_rate", case, got[0], want[0], "timestamps")
            checks.exact("point_rate", case, got[2], want[2])
            checks.values("point_rate", case, got[1], want[1])
    del i_val
    opts = rt.RateOptions()
    r = {
        "ms": time_ms(lambda: rt.point_rate(d_ts, d_val, d_mask, opts)),
        "plain_ms": time_ms(lambda: rt.point_rate_plain(d_ts, d_val, d_mask,
                                                        opts)),
        "bound_ms": bound_ms(S * N * 17 * 2, 3.0 * S * N),
        "bound_by": "bytes",
        "library_ms": None,
    }
    times = {"union_merge": u1, "union_reduce": u2, "point_rate": r}
    print_times(times)
    return times


def union_e2e_phase(dev, tsdb, ts, h, checks: Checks) -> dict:
    from opentsdb_tpu_torch.core import load_state
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.query.planner import PHASES
    from opentsdb_tpu_torch.storage.memstore import SeriesKey

    metric = tsdb.metrics.get_or_create_id("mi")
    k_host = tsdb.tag_names.get_id("host")
    k_group = tsdb.tag_names.get_id("group")
    # counters climbing from 2^53
    ival = np.cumsum(h[:INT_ROWS] % 1_000, axis=1) + 2**53
    for i in range(INT_ROWS):
        key = SeriesKey.make(metric, {
            k_host: tsdb.tag_values.get_or_create_id("h%04d" % i),
            k_group: tsdb.tag_values.get_or_create_id(
                "g%03d" % (i * INT_GROUPS // INT_ROWS))})
        tsdb.store.add_batch(key, ts[i], ival[i], True)

    start = END - SIX_HOURS_MS
    queries = {"sum:m{group=*}": GROUPS, "avg:m": 1,
               "sum:rate:m{group=*}": GROUPS,
               "sum:rate{counter}:mi{group=*}": INT_GROUPS,
               "sum:mi{group=*}": INT_GROUPS}
    subset = "{group=g000|g001|g002|g003}"
    kernels.reset_launches()
    answers, filtered = {}, {}
    for m in queries:
        runner = tsdb.new_query_runner()
        runner.run(_query(m, start))             # warm-up
        walls, splits = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            res = runner.run(_query(m, start))
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(runner.exec_stats))
        answers[m] = res
        wall = statistics.median(walls)
        split = {p: statistics.median(s[p + "Ms"] for s in splits)
                 for p in PHASES}
        points = splits[-1]["pointsScanned"]
        print("e2e %-30s wall %.1f ms (median of 5) | build %.1f h2d %.1f "
              "kernels %.1f extract %.1f ms | kernel share %.4f | %d points "
              "in, %.3e points/s | %d results, %d points out"
              % (m, wall, split["build"], split["h2d"], split["kernels"],
                 split["extract"], split["kernels"] / wall, points,
                 points / (wall / 1e3), len(res),
                 sum(len(r.dps) for r in res)))
        filtered[m] = tsdb.new_query_runner().run(_query(
            m.replace("{group=*}", "") + subset, start))
    launches = dict(kernels.LAUNCHES)
    print("e2e union launches %s" % json.dumps(launches))
    for name in ("union_merge", "union_reduce", "point_rate"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the union "
                                   "path" % name)

    for m, res in answers.items():
        if len(res) != queries[m]:
            checks.failures.append("%s: %d results" % (m, len(res)))
        vals = np.array([v for r in res for _, v in r.dps], np.float64)
        if vals.size == 0 or not np.isfinite(vals).all():
            checks.failures.append("%s: empty or non-finite values" % m)
    if not all(isinstance(v, int) for r in answers["sum:mi{group=*}"]
               for _, v in r.dps):
        checks.failures.append("sum:mi{group=*}: values are not integers")

    uid_maps = {kind: tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    wanted = {tsdb.tag_values.get_id("g%03d" % g) for g in range(4)}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in tsdb.store.all_series()
              if dict(s.key.tags)[k_group] in wanted]
    cpu = load_state(uid_maps, series, device="cpu")
    for m in queries:
        fm = m.replace("{group=*}", "") + subset
        want = cpu.new_query_runner().run(_query(fm, start))
        got = filtered[m]
        same = [(a.tags, [t for t, _ in a.dps]) for a in got] \
            == [(b.tags, [t for t, _ in b.dps]) for b in want]
        if not same:
            checks.failures.append("%s: card and CPU differ in groups or "
                                   "timestamps" % fm)
            continue
        gv = [v for a in got for _, v in a.dps]
        wv = [v for b in want for _, v in b.dps]
        if m == "sum:mi{group=*}":
            checks.exact("e2e union", fm, torch.tensor(gv), torch.tensor(wv),
                         "int64 values")
            print("%-15s %-44s exact %s" % ("e2e union", fm,
                                            "ok" if gv == wv else "FAIL"))
        else:
            checks.values("e2e union", fm, torch.tensor(gv),
                          torch.tensor(wv))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "opentsdb_tpu_torch")):
        print("chip_smoke: opentsdb_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from opentsdb_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    kernels.load_all()
    print("kernel build %.2f s" % (time.perf_counter() - t0))

    dev = torch.device("cuda")
    checks = Checks()
    ts, val, gid, h = headline_batch()
    times = kernel_phase(dev, ts, val, gid, h, checks)
    torch.cuda.empty_cache()
    tsdb, launches = e2e_phase(dev, ts, val, checks)
    torch.cuda.empty_cache()
    times.update(union_kernel_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    union_launches = union_e2e_phase(dev, tsdb, ts, h, checks)

    # Each kernel's launches on its own path's e2e phase (counts reset
    # just before each).
    for name in ("union_merge", "union_reduce", "point_rate"):
        launches[name] = union_launches[name]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "opentsdb_tpu_torch/csrc/%s.cu" % name,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": checks.worst[name]["abs"],
         "max_rel_err": checks.worst[name]["rel"],
         "max_err_of_limit": checks.worst[name]["to_limit"],
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
         "library_ms": t["library_ms"]}
        for name, t in times.items()]}))
    if checks.failures:
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
