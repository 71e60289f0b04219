"""Offline rollup builder: raw store -> the sum, count, min and max lanes
of each rollup interval, over the device mesh.

Port of opentsdb_tpu/rollup/job.py, the batch form of feeding
TSDB.addAggregatePoint from an external rollup pipeline (OpenTSDB
src/core/TSDB.java:1359-1457).  L1 lane_partials computes the sum, count,
min and max of each (series, window) cell of a batch of at most
``batch_series`` series.  On a mesh (the one given, else the TSDB's query
mesh) the batch is cut into (series, time) blocks (parallel/sharded.py
``shard_series``), L1 runs on each block and the blocks combine over the
time axis (``sharded_rollup``, the reference's psum / pmin / pmax); with
no mesh, L1 runs once on the whole batch on the TSDB's device.  The four
lanes are written as the reference writes them (job.py:72-88): a cell
with no point in range writes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from opentsdb_tpu_torch.ops.downsample import FixedWindows
from opentsdb_tpu_torch.ops.pipeline import (build_batch_direct,
                                             run_lane_partials)
from opentsdb_tpu_torch.parallel import shard_series, sharded_rollup


def _data_range(all_series) -> tuple[int, int] | None:
    lo = hi = None
    for s in all_series:
        ts = s.arrays()[0]
        if len(ts):
            lo = int(ts.min()) if lo is None else min(lo, int(ts.min()))
            hi = int(ts.max()) if hi is None else max(hi, int(ts.max()))
    return None if lo is None else (lo, hi)


def run_rollup_job(tsdb, intervals: list[str] | None = None,
                   start_ms: int | None = None, end_ms: int | None = None,
                   mesh=None, batch_series: int = 1024) -> dict[str, int]:
    """Roll every raw series up into the given intervals (every configured
    interval but the default one when None) over [start_ms, end_ms] (the
    data's range when None) on `mesh` (the TSDB's query mesh when None;
    with neither, on the TSDB's device alone); returns the cells written
    per interval.

    Writes the sum, count, min and max lanes of each interval, so that any
    lane-served downsample function, and avg from sum and count, can be
    answered from rollups."""
    if tsdb.rollup_store is None:
        raise RuntimeError("Rollups are not enabled")
    if intervals is None:
        intervals = [ri.interval for ri in tsdb.rollup_config.intervals
                     if not ri.default_interval]
    all_series = tsdb.store.all_series()
    if start_ms is None or end_ms is None:
        found = _data_range(all_series)
        if found is None:
            return {i: 0 for i in intervals}
        start_ms = found[0] if start_ms is None else start_ms
        end_ms = found[1] if end_ms is None else end_ms

    if mesh is None:
        mesh = tsdb.query_mesh()
    dev = tsdb.device if mesh is None else mesh.owner
    lanes = tsdb.rollup_store
    written: dict[str, int] = {}
    for interval in intervals:
        ri = tsdb.rollup_config.get_rollup_interval(interval)
        plan = FixedWindows.for_range(start_ms, end_ms, ri.interval_ms)
        edges = plan.window_edges(dev)
        wts = edges[:-1].cpu().numpy()
        count = 0
        for base in range(0, len(all_series), batch_series):
            chunk = all_series[base:base + batch_series]
            ts, val, mask, _ = build_batch_direct(chunk, start_ms, end_ms,
                                                  True)
            if mesh is None:
                tot, cnt, lo, hi = (x.cpu().numpy() for x in
                                    run_lane_partials(*(
                                        torch.from_numpy(x).to(dev)
                                        for x in (ts, val, mask)), edges))
            else:
                parts = sharded_rollup(
                    mesh, shard_series(mesh, ts, val, mask), edges)
                tot, cnt, lo, hi = (np.concatenate([p[q].cpu().numpy()
                                                    for p in parts])
                                    for q in range(4))
            for i, series in enumerate(chunk):
                has = cnt[i] > 0
                if not has.any():
                    continue
                w = wts[has]
                key = series.key
                lanes.lane(interval, "sum").add_batch(key, w, tot[i][has],
                                                      False)
                lanes.lane(interval, "count").add_batch(
                    key, w, cnt[i][has].astype(np.int64), True)
                lanes.lane(interval, "min").add_batch(key, w, lo[i][has],
                                                      False)
                lanes.lane(interval, "max").add_batch(key, w, hi[i][has],
                                                      False)
                count += int(has.sum())
        written[interval] = count
    return written
