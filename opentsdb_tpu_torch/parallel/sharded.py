"""Sharded grouped queries, sharded streamed queries and the sharded
rollup job over a mesh of shards.

Port of opentsdb_tpu/parallel/sharded.py (B15), the scatter/gather of
SaltScanner (SaltScanner.java:269) behind TsdbQuery.GroupByAndAggregateCB
(:981-1114): each salt bucket scanned concurrently becomes a row shard
owned by one device, and the TreeMap merge of per-bucket results becomes
the mesh's collectives (parallel/collectives.py).

* **Layout.**  ``shard_rows`` (a host batch) and ``shard_rows_device`` (a
  device-cache hit's batch, int64 or int32 offsets from its ``ts_base``)
  split the real rows into contiguous blocks of ceil(S / n) rows, one a
  shard; trailing shards are shorter or empty.  No phantom
  row is made, so the reference's pad-row hazard (its out-of-range pad
  gid, :315-346, :535-551) cannot arise, and each shard's gid slice stays
  non-decreasing.  On a shared device the shards are views of the batch;
  on distinct devices, copies.  ``shard_series`` cuts (series, time)
  blocks for the rollup job.
* **The grouped tail** (``sharded_grid_tail``, the reference's
  ``_local_grid_tail``, :223): K2 on each shard's [S_k, W] grid; for a
  moment aggregator T1 (csrc/tile_partials.cu) folds the shard's rows
  into [G, W] partial moments, in row order from zero; the partials are
  summed (min, max) over the mesh to the owner and finished there with
  K3's arithmetic; dev takes a second, centred T1 pass around the
  combined mean, squareSum T1's square lane, movingAverage<N> runs MA on
  the combined sums.  An order or rank aggregator gathers the shards'
  (contrib, participate, present) grids to the owner in global row
  order and runs K5 there, so first, last and the ranks keep the series
  order.  ``sharded_query_pipeline`` (:278) runs K1 or K4 on each shard
  first.
* **Streamed** (``ShardedStreamAccumulator``, :443): one StreamAccumulator
  (S1, S2) a shard over its row block, no collective until the finish
  (S3 a shard, then the tail); the sliced fold's out-of-slice audit is
  summed over the shards.
* **Rollup** (``sharded_rollup``, :167): L1 on each (series, time) block,
  then sum, sum, min and max over the time axis to each series shard's
  first device.

* **Group downsample** (``sharded_group_downsample``, :129): raw points
  straight to [G, W] group-window moments for any gid (not sorted, not
  contiguous), P1 (csrc/point_group_moments.cu) on each (series, time)
  block, the partial lanes summed (min, max) to the owner; dev takes a
  second, centred P1 pass around the combined mean.  Its caller is the
  driver entry (tools/dryrun.py), as the reference's is
  __graft_entry__.py.

Results live on the owner (shard 0's device), where the reference
replicates them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops.aggregators import (family, ma_window,
                                                moving_average_rows)
from opentsdb_tpu_torch.ops.downsample import FILL_NONE, window_timestamps
from opentsdb_tpu_torch.ops.group_agg import group_offsets, group_order
from opentsdb_tpu_torch.ops.lanes import (group_members, new_group_moments,
                                          point_group_moments)
from opentsdb_tpu_torch.ops.pipeline import (_require_downsample,
                                             check_ported,
                                             run_downsample_grid,
                                             run_lane_partials)
from opentsdb_tpu_torch.ops.streaming import StreamAccumulator
from opentsdb_tpu_torch.ops.tiling import (finish_lane_fold, lane_mode,
                                           new_lane_fold, tile_contrib,
                                           tile_partials)

# The aggregators whose answer combines from partial moments over the mesh
# (the reference's :43): sharded_group_downsample answers these.
SHARDED_AGGS = frozenset({
    "sum", "zimsum", "count", "avg", "min", "mimmin", "max", "mimmax",
    "dev", "squareSum"})


def shard_bounds(mesh, s: int) -> list[tuple[int, int]]:
    """Each shard's row range [lo, hi) of an S-row batch, in shard order:
    blocks of ceil(S / n) rows (the reference's padded block; the port
    pads nothing and the trailing blocks are shorter)."""
    blk = -(-s // mesh.size)
    return [(min(i * blk, s), min((i + 1) * blk, s))
            for i in range(mesh.size)]


@dataclass
class RowShards:
    """A [S, N] batch split into contiguous row blocks, one a shard, each
    on its shard's device; `gid` (host, [S]) maps the batch's rows to
    groups."""
    bounds: list
    ts: list
    val: list
    mask: list
    gid: np.ndarray


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, gid[S] any
def shard_rows(mesh, ts: np.ndarray, val: np.ndarray, mask: np.ndarray,
               gid) -> RowShards:
    """A host batch split over the mesh's rows, each block uploaded to its
    shard's device."""
    return shard_rows_device(mesh, *(torch.from_numpy(x)
                                     for x in (ts, val, mask)), gid)


# shape: ts[S,N] i64|i32, val[S,N] f64|i64, mask[S,N] bool, gid[S] any
def shard_rows_device(mesh, ts: torch.Tensor, val: torch.Tensor,
                      mask: torch.Tensor, gid) -> RowShards:
    """A batch (a device-cache hit, int64 or int32 offsets, or a host
    build) re-laid over the mesh's rows: views where a block already
    lies on its shard's device, copies elsewhere.  No row is added, so
    the int32 pad sentinel never appears outside the gathered rows."""
    bounds = shard_bounds(mesh, ts.shape[0])
    parts = [[x[lo:hi].to(dev, non_blocking=True)
              for (lo, hi), dev in zip(bounds, mesh.devices)]
             for x in (ts, val, mask)]
    return RowShards(bounds, *parts, np.asarray(gid, np.int64))


# shape: edges[W+1] i64 -> ([W] i64, [G,W] f64, [G,W] bool)
def sharded_query_pipeline(mesh, spec, num_groups: int, shards: RowShards,
                           edges: torch.Tensor, ts_base: int | None = None):
    """The grouped pipeline over row shards -> (wts[W], out[G, W],
    out_mask[G, W]) on the owner: K1 or K4 (with MA for movingAverage<N>)
    on each shard's block (int32 offsets from `ts_base` on a re-based
    hit), then ``sharded_grid_tail``.  Equal to run_group_pipeline's
    single-device answer within reassociation (bit for bit where the sums
    are exact)."""
    step = _require_downsample(spec, "sharded_query_pipeline")
    edges_at = mesh.collectives.broadcast(edges.to(mesh.owner))
    grids = [run_downsample_grid(step, *batch, e, ts_base)
             for *batch, e in zip(shards.ts, shards.val, shards.mask,
                                  edges_at)]
    return sharded_grid_tail(mesh, spec, num_groups, grids, shards.gid,
                             shards.bounds)


# how each lane of T1's partial moments combines over the mesh
_COMBINE = {"cnt": "sum", "present": "sum", "tot": "sum", "sq": "sum",
            "m2": "sum", "lo": "min", "hi": "max"}


def _combine(mesh, accs: list) -> dict:
    """Each lane of the shards' partial moments reduced over the mesh to
    the owner: sums added, extremes taken."""
    return {lane: mesh.collectives.reduce([a[lane] for a in accs],
                                          _COMBINE[lane])
            for lane in accs[0]}


# shape: grids: a shard's ([W] i64, [S_k,W] f64, [S_k,W] bool), gid[S] any
# shape: -> ([W] i64, [G,W] f64, [G,W] bool)
def sharded_grid_tail(mesh, spec, num_groups: int, grids: list, gid,
                      bounds: list):
    """The grouped tail over row-sharded [S_k, W] grids (the reference's
    ``_local_grid_tail``) -> (wts[W], out[G, W], out_mask[G, W]) on the
    owner.  Shard k holds rows `bounds`[k] of the batch whose rows `gid`
    (non-decreasing) maps to groups."""
    check_ported(spec)
    coll = mesh.collectives
    gid = np.asarray(gid, np.int64)
    agg = spec.aggregator
    kind = family(agg)
    wts = grids[0][0].to(mesh.owner)
    w = wts.shape[-1]
    contribs = [tile_contrib(spec, *grid) for grid in grids]
    if kind == "order":
        # gather-to-owner on the reduced grid, global row order kept
        c_all, p_all, pr_all = (coll.all_gather([c[i] for c in contribs])
                                for i in range(3))
        offsets = group_offsets(gid, num_groups).to(mesh.owner)
        out, out_mask = group_order(agg, c_all, p_all, pr_all, offsets)
        return wts, out, out_mask
    mode = lane_mode(agg)
    offsets = [group_offsets(gid[lo:hi], num_groups).to(dev)
               for (lo, hi), dev in zip(bounds, mesh.devices)]
    accs = []
    for contrib, off, dev in zip(contribs, offsets, mesh.devices):
        acc = new_lane_fold(num_groups, w, mode, dev)
        tile_partials(*contrib, off, acc)
        accs.append(acc)
    combined = _combine(mesh, accs)
    m2 = None
    if agg == "dev":
        # the second, centred pass around the combined mean
        mean = combined["tot"] / combined["cnt"].clamp(min=1).to(
            torch.float64)
        means = coll.broadcast(mean)
        parts = []
        for contrib, off, dev, mu in zip(contribs, offsets, mesh.devices,
                                         means):
            acc = new_lane_fold(num_groups, w, "centred", dev)
            tile_partials(*contrib, off, acc, mean=mu)
            parts.append(acc["m2"])
        m2 = coll.reduce(parts, "sum")
    if kind == "ma":
        live = combined["cnt"] > 0
        out = moving_average_rows(combined["tot"], live, ma_window(agg))
        return (wts, torch.where(live, out, math.nan),
                combined["present"] > 0)
    out, out_mask = finish_lane_fold(combined, agg, m2)
    return wts, out, out_mask


class ShardedStreamAccumulator:
    """Row-sharded streaming state: one StreamAccumulator a shard over
    its row block (the reference's :443), fed [S, n] chunks::

        acc = ShardedStreamAccumulator(mesh, num_series, windows)
        for ts, val, mask in chunks:          # on the owner's device
            acc.update(ts, val, mask)
        wts, out, out_mask = acc.finish_tail(spec, gid, num_groups)

    Each chunk's row block folds on its shard's device (S2 then S1), with
    no collective; the finish runs S3 a shard and ``sharded_grid_tail``.
    `sketch`, `lanes` and `window_slice` are StreamAccumulator.create's."""

    def __init__(self, mesh, num_series: int, windows, sketch: bool = False,
                 lanes: frozenset | None = None,
                 window_slice: int | None = None):
        self.mesh = mesh
        self.bounds = shard_bounds(mesh, num_series)
        self.shards = [
            StreamAccumulator.create(hi - lo, windows, dev, sketch=sketch,
                                     lanes=lanes, window_slice=window_slice)
            for (lo, hi), dev in zip(self.bounds, mesh.devices)]

    @property
    def window_slice(self) -> int | None:
        return self.shards[0].window_slice

    def update(self, ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
               w0: int | None = None) -> None:
        """Fold one [num_series, n] chunk: each shard its row block (a
        view on a shared device, a copy to a distinct one)."""
        for (lo, hi), acc, dev in zip(self.bounds, self.shards,
                                      self.mesh.devices):
            acc.update(*(x[lo:hi].to(dev, non_blocking=True)
                         for x in (ts, val, mask)), w0=w0)

    def oob_count(self) -> int:
        """Valid points the shards' sliced folds missed, summed; 0 in
        correct use.  Synchronises with the devices."""
        return sum(acc.oob_count() for acc in self.shards)

    def finish(self, ds_function: str, fill_policy: str = FILL_NONE,
               fill_value: float = 0.0) -> list:
        """Each shard's downsample grid (wts[W], v[S_k, W], m[S_k, W]),
        S3 a shard, on its device."""
        return [acc.finish(ds_function, fill_policy, fill_value)
                for acc in self.shards]

    def finish_tail(self, spec, gid, num_groups: int):
        """(wts[W], out[G, W], out_mask[G, W]) of the query on the owner."""
        step = _require_downsample(spec, "finish_tail")
        grids = self.finish(step.function, step.fill_policy, step.fill_value)
        return sharded_grid_tail(self.mesh, spec, num_groups, grids, gid,
                                 self.bounds)


@dataclass
class SeriesTimeShards:
    """A [S, N] batch cut into (series, time) blocks: blocks[i][j] is
    (ts, val, mask) of rows row_bounds[i] and columns col_bounds[j], on
    the mesh's device (i, j)."""
    row_bounds: list
    col_bounds: list
    blocks: list


def _cut(n: int, parts: int) -> list[tuple[int, int]]:
    blk = -(-n // parts) if n else 0
    return [(min(i * blk, n), min((i + 1) * blk, n)) for i in range(parts)]


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool
def shard_series(mesh, ts: np.ndarray, val: np.ndarray,
                 mask: np.ndarray) -> SeriesTimeShards:
    """A host batch cut over the mesh: rows over the series axis, columns
    (time-sorted points, so every block's rows stay sorted) over the time
    axis, each block uploaded to its device.  Trailing blocks are shorter
    or empty; nothing is padded."""
    n_s, n_t = mesh.shape
    rows = _cut(ts.shape[0], n_s)
    cols = _cut(ts.shape[1], n_t)
    blocks = [[tuple(torch.from_numpy(np.ascontiguousarray(
        x[r0:r1, c0:c1])).to(mesh.device_at(i, j), non_blocking=True)
        for x in (ts, val, mask))
        for j, (c0, c1) in enumerate(cols)]
        for i, (r0, r1) in enumerate(rows)]
    return SeriesTimeShards(rows, cols, blocks)


def _identity_partials(s: int, w: int, device):
    """L1's partials of cells no point reached: (0, 0, +inf, -inf)."""
    return (torch.zeros((s, w), dtype=torch.float64, device=device),
            torch.zeros((s, w), dtype=torch.int32, device=device),
            torch.full((s, w), math.inf, dtype=torch.float64, device=device),
            torch.full((s, w), -math.inf, dtype=torch.float64,
                       device=device))


# shape: edges[W+1] i64 -> per series shard ([S_i,W] f64, [S_i,W] i32,
# shape: [S_i,W] f64, [S_i,W] f64)
def sharded_rollup(mesh, shards: SeriesTimeShards,
                   edges: torch.Tensor) -> list:
    """The sharded rollup pass (the reference's :167): L1 on each
    (series, time) block, then the sums and counts added and the extremes
    taken over the time axis -> per series shard (sum, count, min, max)
    [S_i, W] on its first device (an empty shard gives [0, W] lanes)."""
    n_t = mesh.shape[1]
    w = edges.numel() - 1
    edges_at = mesh.collectives.broadcast(edges.to(mesh.owner))
    out = []
    for i, (r0, r1) in enumerate(shards.row_bounds):
        first = mesh.device_at(i, 0)
        if r1 == r0:
            out.append(_identity_partials(0, w, first))
            continue
        parts = []
        for j, (c0, c1) in enumerate(shards.col_bounds):
            dev = mesh.device_at(i, j)
            if c1 == c0:
                parts.append(_identity_partials(r1 - r0, w, dev))
            else:
                parts.append(run_lane_partials(*shards.blocks[i][j],
                                               edges_at[i * n_t + j]))
        members = [i * n_t + j for j in range(n_t)]
        out.append(tuple(
            mesh.collectives.reduce([p[q] for p in parts], op, members)
            for q, op in enumerate(("sum", "sum", "min", "max"))))
    return out



# shape: gid[S] any, edges[W+1] i64 -> ([W] i64, [G,W] f64, [G,W] bool)
def sharded_group_downsample(mesh, agg_name: str, shards: SeriesTimeShards,
                             gid, num_groups: int, edges: torch.Tensor):
    """Raw points to group-window aggregates over the mesh (the
    reference's :129) -> (wts[W], out[G, W], out_mask[G, W]) on the
    owner.  Row r of the batch that `shards` cuts (``shard_series``)
    belongs to group gid[r] (host, [S], any order; rows outside [0, G)
    to none); each (series, time) block runs P1 on its device over the
    block's rows, and the partial lanes combine over the mesh (counts
    and sums added, extremes taken); dev runs a second, centred P1 pass
    around the combined mean, broadcast to every block, and sums its
    m2.  The finish is the reference's ``_finish``: count is the count
    as f64, avg tot / max(cnt, 1), dev sqrt(m2 / (cnt - 1)) where cnt >=
    2 else 0, and every answer, count included, is NaN where no point
    counted (out_mask = cnt > 0).  An aggregator outside SHARDED_AGGS
    raises KeyError."""
    if agg_name not in SHARDED_AGGS:
        raise KeyError("Aggregator %r has no cross-chip decomposition"
                       % agg_name)
    coll = mesh.collectives
    gid = np.asarray(gid, np.int64)
    w = edges.numel() - 1
    edges_at = coll.broadcast(edges.to(mesh.owner))
    n_t = mesh.shape[1]
    # (block, its device, its edges, its members and offsets), flat in
    # the mesh's order; None for a block that holds no point
    blocks = []
    for i, (r0, r1) in enumerate(shards.row_bounds):
        groups = {}
        for j, (c0, c1) in enumerate(shards.col_bounds):
            dev = mesh.device_at(i, j)
            if r1 == r0 or c1 == c0:
                blocks.append((None, dev, None, None))
                continue
            if dev not in groups:
                groups[dev] = group_members(
                    torch.from_numpy(gid[r0:r1]).to(dev), num_groups)
            blocks.append((shards.blocks[i][j], dev, edges_at[i * n_t + j],
                           groups[dev]))

    def pass_over(mode: str, means=None) -> dict:
        parts = []
        for k, (block, dev, e, members) in enumerate(blocks):
            if block is None:
                parts.append(new_group_moments(num_groups, w, mode, dev))
            else:
                parts.append(point_group_moments(
                    *block, e, *members, mode,
                    None if means is None else means[k]))
        return _combine(mesh, parts)

    mode = lane_mode(agg_name)
    combined = pass_over(mode)
    m2 = None
    if agg_name == "dev":
        mean = combined["tot"] / combined["cnt"].clamp(min=1).to(
            torch.float64)
        m2 = pass_over("centred", coll.broadcast(mean))["m2"]
    # finish_lane_fold's mask reads the count of present members; here
    # a cell is present where a point counted
    out, out_mask = finish_lane_fold(
        dict(combined, present=combined["cnt"]), agg_name, m2)
    out = torch.where(out_mask, out, math.nan)
    return window_timestamps(edges_at[0]), out, out_mask
