"""Rollup lanes: maintenance-built multi-resolution pre-aggregation.

Port of opentsdb_tpu/storage/rollup.py (``RollupLanes``).  The written
rollups (rollup/) hold what an external pipeline or the rollup job
computed; these lanes are built by the maintenance thread from the
memstore itself, so a long-range dashboard query stops re-reducing the
raw points on every load.

One lane block is ``tsd.rollup.block_windows`` consecutive cells of one
(metric, lane interval), aligned to the absolute lane grid (block b covers
cells [b*B, (b+1)*B)), holding the mergeable partials of every (series,
cell): sum, count, min and max, built by L1 lane_partials
(ops/pipeline.run_lane_partials).  The four are closed under coarsening,
so a fixed-interval downsample whose interval is a multiple of a lane and
whose function is lane-derivable (sum, zimsum, count, avg, min, mimmin,
max, mimmax) answers exactly from the lane: sums re-reduce by sum, counts
by sum, extremes by min or max, avg as the sum of sums over the sum of
counts, the same float64 division K1 performs on the same operands.  On
integer data a lane-served grid is K1's bit for bit.  Other functions,
other intervals and calendar grids take the exact path.

Placement (``refresh``): every eligible consult records its demand, priced
by the cost model (ops/costmodel.py: the stage breakdown of the exact
plan against the lane-served one), and each maintenance pass builds
targets greedily by saving per byte under ``tsd.rollup.mb``; LRU eviction
enforces the budget at insert.

Invalidation: the memstore calls ``note_mutation`` after every write lands
(write-then-mark, storage/memstore.py).  A ring of (generation, range)
marks per metric fails every block that a newer mark overlaps, so an acked
write is never served stale: the planner takes the exact path until a
maintenance pass rebuilds the block.  The ring is bounded; its overflow
raises the metric's floor generation, which fails older blocks.

A plan whose [S, W] grid is over ``tsd.query.streaming.state_mb`` is
served striped (``LanePlan.striped``, sized by
query/plandecision.size_lane_stripes): the planner derives the whole
grid on the host (``derive_grid``), then folds it tile by tile on the
device or replays it through the spill pool (ops/tiling.py).

Deliberate differences from the reference: a block holds exactly
``tsd.rollup.block_windows`` cells (no power-of-two rounding); blocks live
on the host, as the reference's do; there are no prometheus counters and
no flight recorder, the tallies stay in ``collect_stats``.  ``plan``
has the reference's dry run (``observe=False``), for explain.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops.costmodel import LANE_CELL_BYTES
from opentsdb_tpu_torch.ops.downsample import (
    FILL_NAN, FILL_NONE, FILL_NULL, FILL_SCALAR, FILL_ZERO, FixedWindows)
from opentsdb_tpu_torch.ops.pipeline import (build_batch_direct,
                                             run_lane_partials)
from opentsdb_tpu_torch.utils import datetime_util as DT

LOG = logging.getLogger(__name__)

# bound on the (generation, range) dirty marks kept per metric; overflow
# raises the floor generation
_MARK_RING = 512

# bound on tracked demand candidates (stalest first out)
_DEMAND_MAX = 1024

# bound on the lane blocks one plan, coverage or refresh walk may visit:
# a request-shaped range must never drive an unbounded loop
_MAX_BLOCK_WALK = 65536

# Downsample functions a lane answers exactly (zimsum reduces as sum,
# mimmin and mimmax as min and max).
DERIVABLE_DS = frozenset(
    {"sum", "zimsum", "count", "avg", "min", "mimmin", "max", "mimmax"})


@dataclass
class _LaneBlock:
    """One built block: [S, B] mergeable partials per cell."""
    metric: int
    lane_ms: int
    rows: dict               # Series object -> row index (by identity)
    sums: np.ndarray         # [S, B] float64 (0.0 in empty cells)
    counts: np.ndarray       # [S, B] int32 (0 in empty cells)
    mins: np.ndarray         # [S, B] float64 (+inf in empty cells)
    maxs: np.ndarray         # [S, B] float64 (-inf in empty cells)
    gen: int                 # build generation (mark-ring validation)
    lo_ms: int               # covered range [lo_ms, hi_ms] inclusive
    hi_ms: int
    nbytes: int = 0


@dataclass
class LanePlan:
    """A lane-served decomposition of one segment, for the planner."""
    k: int                   # lane cells a query window
    wf_lo: int               # first and last full window of the grid
    wf_hi: int
    n_cells: int             # interior cells assembled
    # (block, rows[S] int64, c0, c1, dst_off): each block's own row
    # vector (blocks built at different times may order rows otherwise)
    # and the cell slice it contributes
    segments: list = field(default_factory=list)
    striped: bool = False    # over the device budget: served striped
    tile_plan: object = None  # its ops.tiling.TilePlan when striped
    lane: str = ""           # the lane's label ("1m", "1h", ...)


class RollupLanes:
    """The maintenance-built lane store and its plan API."""

    def __init__(self, config, device):
        self.config = config
        self.device = device
        labels = [t.strip() for t in config.get_string(
            "tsd.rollup.intervals").split(",") if t.strip()]
        # (label, lane_ms), coarsest first: the widest lane that divides a
        # query's interval serves it with the fewest cells
        self.lanes: list[tuple[str, int]] = sorted(
            ((lb, DT.parse_duration(lb)) for lb in labels),
            key=lambda p: -p[1])
        if not self.lanes:
            raise ValueError("tsd.rollup.intervals must name at least "
                             "one lane interval")
        self.block_windows = max(config.get_int("tsd.rollup.block_windows"),
                                 1)
        self.max_bytes = config.get_int("tsd.rollup.mb") * 2 ** 20
        self.refresh_blocks = max(
            config.get_int("tsd.rollup.refresh_blocks"), 1)
        self.delay_ms = max(config.get_int("tsd.rollup.delay_ms"), 0)
        self.fix_duplicates = config.fix_duplicates
        self._lock = threading.Lock()
        # (metric, lane_ms, block) -> _LaneBlock; dict order is LRU
        # recency (move to the end on a consult)
        self._blocks: dict[tuple, _LaneBlock] = {}  # guarded-by: _lock
        # metric -> deque[(gen, lo_ms, hi_ms)] dirty marks
        self._marks: dict[int, deque] = {}  # guarded-by: _lock
        # metric -> floor generation (mark-ring overflow)
        self._floor: dict[int, int] = {}  # guarded-by: _lock
        self._gen = 0  # guarded-by: _lock
        # the newest generation a plan or build snapshotted: marks coalesce
        # only past it
        self._planned_gen = 0  # guarded-by: _lock
        # until the first build reads store data, note_mutation returns
        # without the lock (written under _lock, read without it)
        self._armed = False  # guarded-by: _lock
        # (metric, lane_ms) -> demand {n, saving_s, lo, hi, series, tick}
        self._demand: dict[tuple, dict] = {}  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        # tallies for collect_stats  # guarded-by: _lock
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.build_errors = 0
        self.evictions = 0
        self.invalidations = 0
        self.served_windows = 0

    # -- invalidation ----------------------------------------------------

    def note_mutation(self, metric: int, lo_ms: int | None,
                      hi_ms: int | None) -> None:
        """The memstore's mutation listener, called after a write lands:
        routes to ``invalidate``."""
        if not self._armed:
            # no build has read store data, so nothing built can be
            # stale: sound because refresh arms the flag under the lock
            # before its first store read, and this read follows the
            # caller's write
            return
        self.invalidate(metric=metric, lo_ms=lo_ms, hi_ms=hi_ms)

    def invalidate(self, metric: int | None = None,
                   lo_ms: int | None = None,
                   hi_ms: int | None = None) -> None:
        """With a metric: a dirty mark over [lo_ms, hi_ms] (None bounds are
        open): the blocks it overlaps fail validation from now on.
        Without one: drop every block."""
        with self._lock:
            if metric is None:
                self.invalidations += 1
                self._blocks = {}
                self._marks.clear()
                self._floor.clear()
                self._bytes = 0
                self._gen += 1
                return
            lo = -2 ** 62 if lo_ms is None else int(lo_ms)
            hi = 2 ** 62 if hi_ms is None else int(hi_ms)
            ring = self._marks.get(metric)
            if ring is None:
                ring = self._marks[metric] = deque(maxlen=_MARK_RING)
            if ring and ring[-1][0] > self._planned_gen:
                # no plan or build snapshotted since the last mark: widen
                # it instead of adding one (per-point ingest)
                g, plo, phi = ring[-1]
                ring[-1] = (g, min(plo, lo), max(phi, hi))
                return
            self.invalidations += 1
            self._gen += 1
            if len(ring) == _MARK_RING:
                self._floor[metric] = max(self._floor.get(metric, 0),
                                          ring[0][0])
            ring.append((self._gen, lo, hi))

    def _valid_locked(self, entry: _LaneBlock) -> bool:
        if entry.gen < self._floor.get(entry.metric, 0):
            return False
        for gen, lo, hi in reversed(self._marks.get(entry.metric, ())):
            if gen <= entry.gen:
                break
            if lo <= entry.hi_ms and hi >= entry.lo_ms:
                return False
        return True

    # -- lane selection --------------------------------------------------

    def lane_for(self, interval_ms: int,
                 first_window_ms: int) -> tuple[str, int] | None:
        """The coarsest lane able to serve a fixed grid: its span divides
        both the interval and the grid's origin."""
        if interval_ms <= 0:
            return None
        for label, lane_ms in self.lanes:
            if interval_ms % lane_ms == 0 \
                    and first_window_ms % lane_ms == 0:
                return label, lane_ms
        return None

    @staticmethod
    def derivable(ds_fn: str | None) -> bool:
        return ds_fn in DERIVABLE_DS

    @staticmethod
    def _full_windows(windows: FixedWindows, start_ms: int,
                      end_ms: int) -> tuple[int, int]:
        """(first, last) full window of the grid: the edge windows hold
        part of their points' range and are computed from raw points."""
        interval = windows.interval_ms
        first = windows.first_window_ms
        w = windows.count
        wf_lo = 0 if start_ms <= first else 1
        last_start = first + (w - 1) * interval
        wf_hi = w - 1 if last_start + interval - 1 <= end_ms else w - 2
        return wf_lo, wf_hi

    # -- planning --------------------------------------------------------

    def plan(self, metric: int, series_list, windows: FixedWindows,
             start_ms: int, end_ms: int, ds_fn: str, n_max: int,
             groups: int, has_rate: bool, total_points: int = 0,
             observe: bool = True, note: dict | None = None):
        """The lane-serve verdict on one fixed-grid segment: a LanePlan, or
        None for the exact path (a function no lane derives, an interval
        or origin no lane divides, no full window, or blocks missing or
        stale).  Every consult that a lane could serve records a demand
        observation priced by the cost model, which ``refresh`` ranks.

        ``observe=False`` is explain's dry run (query/explain.py, the
        reference's :341-344): the same verdict from the same state, with
        nothing recorded: no demand, no LRU bump, no miss, no
        ``_planned_gen`` advance, and stale or incomplete blocks left for
        the real pass to reap.  `note`, when given, receives the
        decision as the reference reports it (decision, reason, lane,
        coverage, the predictions; cells and blocks when served)."""
        decision = {} if note is None else note
        decision.update(decision="fallback", reason="", lane="",
                        coverage=0.0)
        if not self.derivable(ds_fn):
            decision["reason"] = "not_derivable"
            return None
        interval = windows.interval_ms
        first = windows.first_window_ms
        picked = self.lane_for(interval, first)
        if picked is None:
            decision["reason"] = "no_lane_divides"
            return None
        label, lane_ms = picked
        k = interval // lane_ms
        decision["lane"] = label
        wf_lo, wf_hi = self._full_windows(windows, start_ms, end_ms)
        if wf_hi < wf_lo:
            decision["reason"] = "no_full_windows"
            return None
        c_lo = (first + wf_lo * interval) // lane_ms
        c_hi = (first + (wf_hi + 1) * interval) // lane_ms - 1
        n_cells = c_hi - c_lo + 1
        bw = self.block_windows
        b_lo, b_hi = c_lo // bw, c_hi // bw
        if b_hi - b_lo + 1 > _MAX_BLOCK_WALK:
            decision["reason"] = "too_many_blocks"
            return None

        # what the lane saves against the exact plan
        s = len(series_list)
        full = cm.stage_breakdown(s, n_max, windows.count, groups, ds_fn,
                                  has_rate)
        pred_full = sum(full.values()) + cm.predict_host_build(total_points)
        pred_lane = sum(full.values()) - full["downsample"] \
            + cm.predict_lane(s, wf_hi - wf_lo + 1, k)
        saving = max(pred_full - pred_lane, 0.0)
        decision["predictedLaneMs"] = round(pred_lane * 1e3, 3)
        decision["predictedFullMs"] = round(pred_full * 1e3, 3)

        # under the lock: the generation snapshot, validity and the LRU
        # bump; blocks are immutable once stored, so the row work runs
        # outside it
        candidates: list = []
        missing = 0
        with self._lock:
            if observe:
                self._planned_gen = max(self._planned_gen, self._gen)
                self._note_demand_locked(metric, lane_ms, s, start_ms,
                                         end_ms, saving)
            for b in range(b_lo, b_hi + 1):
                key = (metric, lane_ms, b)
                entry = self._blocks.get(key)
                if entry is None or not self._valid_locked(entry):
                    if entry is not None and observe:
                        self._drop_locked(key)
                    missing += 1
                    continue
                if observe:
                    self._blocks.pop(key)
                    self._blocks[key] = entry
                candidates.append((key, entry, b))
        segments: list = []
        incomplete: list = []
        for key, entry, b in candidates:
            if not all(srs in entry.rows for srs in series_list):
                # a series appeared since the build: rebuild it
                incomplete.append(key)
                missing += 1
                continue
            rows = np.fromiter((entry.rows[srs] for srs in series_list),
                               np.int64, count=s)
            lo_cell = max(c_lo, b * bw)
            hi_cell = min(c_hi, (b + 1) * bw - 1)
            segments.append((entry, rows, lo_cell - b * bw,
                             hi_cell - b * bw + 1, lo_cell - c_lo))
        if missing:
            decision["reason"] = "cold"
            decision["coverage"] = round(
                1.0 - missing / (b_hi - b_lo + 1), 4)
            if observe:
                with self._lock:
                    for key in incomplete:
                        self._drop_locked(key)
                    self.misses += 1
            return None
        decision.update(decision="lane", reason="served", coverage=1.0,
                        cells=n_cells, blocks=len(segments))
        return LanePlan(k=k, wf_lo=wf_lo, wf_hi=wf_hi, n_cells=n_cells,
                        segments=segments, lane=label)

    def note_served(self, plan: LanePlan) -> None:
        """The planner served this plan: count the hit."""
        with self._lock:
            self.hits += 1
            self.served_windows += plan.wf_hi - plan.wf_lo + 1

    def note_striping_fallback(self) -> None:
        """A plan over the device budget that striping could not serve
        took the exact path: count a miss, not a hit."""
        with self._lock:
            self.misses += 1

    def _note_demand_locked(self, metric: int, lane_ms: int, s: int,
                            lo_ms: int, hi_ms: int,
                            saving_s: float) -> None:
        key = (metric, lane_ms)
        self._tick += 1
        rec = self._demand.pop(key, None)
        if rec is None:
            rec = {"n": 0, "saving_s": 0.0, "lo": lo_ms, "hi": hi_ms,
                   "series": s}
        rec["n"] += 1
        rec["saving_s"] += saving_s
        rec["lo"] = min(rec["lo"], lo_ms)
        rec["hi"] = max(rec["hi"], hi_ms)
        rec["series"] = max(rec["series"], s)
        rec["tick"] = self._tick
        self._demand[key] = rec     # to the end: stalest first out
        while len(self._demand) > _DEMAND_MAX:
            self._demand.pop(next(iter(self._demand)))

    # -- serving: grid derivation ----------------------------------------

    def derive_grid(self, plan: LanePlan, ds_fn: str, fill_policy: str,
                    fill_value: float) -> tuple[np.ndarray, np.ndarray]:
        """The interior [rows, windows] downsample grid from the plan's
        lane cells, on the host, outside any lock (blocks are immutable
        once stored).  Window w re-reduces its k cells with the function's
        mergeable form; on integer data every value is K1's bit for bit
        (integer sums are exact in any order, extremes are selections, and
        avg divides the same two operands)."""
        s = len(plan.segments[0][1])
        k = plan.k
        nc = plan.n_cells
        need_min = ds_fn in ("min", "mimmin")
        need_max = ds_fn in ("max", "mimmax")
        sums = np.empty((s, nc), np.float64)
        counts = np.empty((s, nc), np.int64)
        ext = np.empty((s, nc), np.float64) if need_min or need_max \
            else None
        for entry, rows, c0, c1, off in plan.segments:
            sums[:, off:off + c1 - c0] = entry.sums[rows, c0:c1]
            counts[:, off:off + c1 - c0] = entry.counts[rows, c0:c1]
            if need_min:
                ext[:, off:off + c1 - c0] = entry.mins[rows, c0:c1]
            elif need_max:
                ext[:, off:off + c1 - c0] = entry.maxs[rows, c0:c1]
        nw = nc // k
        cnt_w = counts.reshape(s, nw, k).sum(axis=2)
        mask = cnt_w > 0
        if ds_fn in ("sum", "zimsum"):
            vals = sums.reshape(s, nw, k).sum(axis=2)
        elif ds_fn == "count":
            vals = cnt_w.astype(np.float64)
        elif ds_fn == "avg":
            vals = sums.reshape(s, nw, k).sum(axis=2) / np.maximum(cnt_w, 1)
        elif need_min:
            vals = ext.reshape(s, nw, k).min(axis=2)
        elif need_max:
            vals = ext.reshape(s, nw, k).max(axis=2)
        else:
            raise ValueError("not lane-derivable: %s" % ds_fn)
        # the fill over interior windows, as apply_fill fills them
        if fill_policy == FILL_NONE:
            return np.where(mask, vals, np.nan), mask
        if fill_policy == FILL_ZERO:
            fill = 0.0
        elif fill_policy in (FILL_NAN, FILL_NULL):
            fill = np.nan
        elif fill_policy == FILL_SCALAR:
            fill = float(fill_value)
        else:
            raise ValueError("Unrecognized fill policy: " + fill_policy)
        return np.where(mask, vals, fill), np.ones_like(mask)

    def coverage(self, metric: int, interval_ms: int, ds_fn: str,
                 start_ms: int, end_ms: int) -> float:
        """The share of a fixed-grid plan's full windows that valid blocks
        cover (the series-set check aside)."""
        if not self.derivable(ds_fn) or interval_ms <= 0:
            return 0.0
        windows = FixedWindows.for_range(start_ms, end_ms, interval_ms)
        picked = self.lane_for(interval_ms, windows.first_window_ms)
        if picked is None:
            return 0.0
        label, lane_ms = picked
        wf_lo, wf_hi = self._full_windows(windows, start_ms, end_ms)
        if wf_hi < wf_lo:
            return 0.0
        first = windows.first_window_ms
        c_lo = (first + wf_lo * interval_ms) // lane_ms
        c_hi = (first + (wf_hi + 1) * interval_ms) // lane_ms - 1
        bw = self.block_windows
        total = min(c_hi // bw - c_lo // bw + 1, _MAX_BLOCK_WALK)
        good = 0
        with self._lock:
            for i in range(total):
                entry = self._blocks.get((metric, lane_ms, c_lo // bw + i))
                if entry is not None and self._valid_locked(entry):
                    good += 1
        return good / max(total, 1)

    # -- maintenance: selection and block builds -------------------------

    def refresh(self, store, max_blocks: int | None = None,
                now_ms: int | None = None) -> int:
        """One maintenance pass: select (metric, lane) targets by saving
        per byte under ``tsd.rollup.mb``, then (re)build up to
        `max_blocks` missing or invalid blocks over their demanded ranges.
        Returns the blocks built."""
        if max_blocks is None:
            max_blocks = self.refresh_blocks
        if now_ms is None:
            now_ms = DT.current_time_millis()
        with self._lock:
            demand = list(self._demand.items())
        # greedy saving per byte under the byte budget; a target that
        # cannot fit whole is never part-built (it would never serve)
        scored = []
        for key, rec in demand:
            cells = max((rec["hi"] - rec["lo"]) // key[1] + 1, 1)
            bytes_est = rec["series"] * cells * LANE_CELL_BYTES
            scored.append((rec["saving_s"] / bytes_est, bytes_est, key,
                           rec))
        scored.sort(key=lambda t: -t[0])
        remaining = self.max_bytes
        selected = []
        for _score, bytes_est, key, rec in scored:
            if bytes_est <= remaining:
                selected.append((key, rec))
                remaining -= bytes_est
        built = 0
        bw = self.block_windows
        for (metric, lane_ms), rec in selected:
            series_list = sorted(store.series_for_metric(metric),
                                 key=lambda srs: srs.key.tags)
            if not series_list:
                continue
            span = bw * lane_ms
            b0 = rec["lo"] // span
            n_scan = min(rec["hi"] // span - b0 + 1, _MAX_BLOCK_WALK)
            for b in range(b0, b0 + n_scan):
                if built >= max_blocks:
                    return built
                if self.delay_ms and (b + 1) * span - 1 \
                        > now_ms - self.delay_ms:
                    # the head still being written: skip it this pass
                    continue
                key = (metric, lane_ms, b)
                with self._lock:
                    entry = self._blocks.get(key)
                    if entry is not None and self._valid_locked(entry) \
                            and all(srs in entry.rows
                                    for srs in series_list):
                        continue
                try:
                    if self._build_block(metric, lane_ms, b, series_list):
                        built += 1
                except Exception:
                    with self._lock:
                        self.build_errors += 1
                    LOG.exception("lane block build failed: %r", key)
        return built

    def _build_block(self, metric: int, lane_ms: int, b: int,
                     series_list) -> bool:
        """Build one [S, B] partials block from the raw store through L1,
        the series axis in tiles that fit ``tsd.query.streaming.state_mb``
        on the device, each tile's partials copied straight into the
        block's host arrays."""
        bw = self.block_windows
        span = bw * lane_ms
        lo, hi = b * span, (b + 1) * span - 1
        s = len(series_list)
        with self._lock:
            gen0 = self._gen
            self._planned_gen = max(self._planned_gen, gen0)
            # arm the ingest-side marks before reading store data
            self._armed = True
        fix = self.fix_duplicates
        n_max = max((srs.window_count(lo, hi, fix) for srs in series_list),
                    default=0)
        budget = self.config.get_int("tsd.query.streaming.state_mb") \
            * 2 ** 20
        # a row's device bytes: its batch (ts 8 + val 8 + mask 1 a point)
        # and its four partial lanes
        per_row = max(n_max, 1) * 17 + bw * LANE_CELL_BYTES
        tile_rows = s if budget <= 0 else min(max(budget // per_row, 1), s)
        sums = np.empty((s, bw), np.float64)
        cnts = np.empty((s, bw), np.int32)
        mins = np.empty((s, bw), np.float64)
        maxs = np.empty((s, bw), np.float64)
        dev = self.device
        edges = FixedWindows(lane_ms, lo, bw).window_edges(dev)
        for t_lo in range(0, s, tile_rows):
            t_hi = min(t_lo + tile_rows, s)
            ts, val, mask, _ = build_batch_direct(series_list[t_lo:t_hi],
                                                  lo, hi, fix)
            parts = run_lane_partials(torch.from_numpy(ts).to(dev),
                                      torch.from_numpy(val).to(dev),
                                      torch.from_numpy(mask).to(dev), edges)
            for dst, part in zip((sums, cnts, mins, maxs), parts):
                dst[t_lo:t_hi] = part.cpu().numpy()
        entry = _LaneBlock(
            metric=metric, lane_ms=lane_ms,
            rows={srs: i for i, srs in enumerate(series_list)},
            sums=sums, counts=cnts, mins=mins, maxs=maxs, gen=gen0,
            lo_ms=lo, hi_ms=hi, nbytes=s * bw * LANE_CELL_BYTES)
        with self._lock:
            if not self._valid_locked(entry):
                # a write landed in range during the build: the next pass
                # rebuilds from the data after it
                return False
            if entry.nbytes > self.max_bytes:
                return False
            self._evict_for_locked(entry.nbytes)
            key = (metric, lane_ms, b)
            self._drop_locked(key)
            self._blocks[key] = entry
            self._bytes += entry.nbytes
            self.builds += 1
        return True

    # -- eviction --------------------------------------------------------

    def _drop_locked(self, key: tuple) -> None:
        entry = self._blocks.pop(key, None)
        if entry is not None:
            self._bytes -= entry.nbytes

    def _evict_for_locked(self, incoming: int) -> None:
        while self._blocks and self._bytes + incoming > self.max_bytes:
            self._drop_locked(next(iter(self._blocks)))
            self.evictions += 1

    # -- stats -----------------------------------------------------------

    def collect_stats(self) -> dict:
        with self._lock:
            return {
                "tsd.query.rollup.hits": float(self.hits),
                "tsd.query.rollup.misses": float(self.misses),
                "tsd.query.rollup.builds": float(self.builds),
                "tsd.query.rollup.build_errors": float(self.build_errors),
                "tsd.query.rollup.blocks": float(len(self._blocks)),
                "tsd.query.rollup.bytes": float(self._bytes),
                "tsd.query.rollup.evictions": float(self.evictions),
                "tsd.query.rollup.invalidations": float(self.invalidations),
                "tsd.query.rollup.served_windows": float(
                    self.served_windows),
                "tsd.query.rollup.demand_entries": float(len(self._demand)),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)
