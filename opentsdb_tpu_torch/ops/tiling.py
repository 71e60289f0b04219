"""Out-of-core tiled execution: series tiles, the spill pool and a
window-striped replay, with T1 tile_partials for the striped lane fold.

Port of opentsdb_tpu/ops/tiling.py.  A grouped plan whose device state
is over ``tsd.query.streaming.state_mb`` is executed instead of refused:

1. **Series tiles.**  The series axis splits into tiles whose [S_tile, W]
   state fits the budget (``size_tiles``).  Each tile's finished
   downsample grid comes from its caller (``tile_grid_fn``): a
   device-cache hit (G1, then K1 or K4) or the streamed chunk loop
   (ops/streaming.stream_grid: S1, S2 and S3) for raw data, lane cells
   for a rollup-lane serve.
2. **Row-local contributions, then spill.**  Rate and gap fill are
   row-local, so K2 (``tile_contrib``) runs per tile on the full width.
   The tile's (contrib, participate, actual) grids go to the host and
   into the spill pool (storage/spill.py), cut into window stripes.
3. **Window-striped replay.**  The cross-series reduce is window-local:
   for each stripe the tiles' pieces are read back, copied to the device
   as one [S, stripe] grid and reduced by K3 or K5 (``group_reduce``,
   ``present`` = the actual mask, the reference's ``_group_presence``).
   movingAverage<N> runs over windows, not within them: its stripes give
   K3's group sums and counts, stitched across the width, and MA runs
   once over the whole [G, W] grid, so the answer is the resident one
   (the reference restarts its moving average at every stripe).

Plans are sized on the reference's padded window and group counts
(``pad_pow2``), so both packages split into the same tiles and stripes
and refuse the same plans; execution runs on the real window count, so a
stripe past the last window is empty and skipped.

The striped lane serve folds the aggregators of ``LANE_FOLDABLE``
instead of replaying them: ``run_lane_fold`` runs K2 on a tile, then T1
(csrc/tile_partials.cu) adds the tile's rows into [G, W] partial moments
held on the device, which ``finish_lane_fold`` turns into
moment_group_reduce's answer.  T1's square and centred modes (squareSum's
sum of squares, dev's second pass around a given mean) serve the mesh's
per-shard partials (parallel/sharded.py).

Deliberate differences: refusals are tallies on the TSDB
(``tiled_refusals``), not prometheus counters; no admission or explain
pricing of tiled plans: ``run_tiled`` reports the cost model's
prediction of its overhead (``predictedMs``) beside the measured split;
the reference's host-dense lane fold (numpy reduceat) is not ported, as
T1's device fold gives the same answers and is the faster on the card.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.aggregators import (PREV, get_agg, ma_window,
                                                moving_average_rows)
from opentsdb_tpu_torch.ops.group_agg import (grid_fill_rate, group_moments,
                                              group_offsets)
from opentsdb_tpu_torch.ops.pipeline import group_reduce

# Per-cell bytes for plan sizing.  A spill entry holds contrib (f64),
# participate and the actual mask (bool) per (series, window) cell; a
# tile's device working set holds the accumulator state and the
# finished and contribution grids; an assembled stripe holds the three
# spilled lanes for every series plus the [G, stripe] output.
SPILL_CELL_BYTES = 10
TILE_WORK_CELL_BYTES = 26
STRIPE_CELL_BYTES = 24

# Cross-series aggregators whose group reduce folds tile by tile into
# [G, W] partial moments: sum and count for the additive ones, min or
# max and count for the extremes.  The others (dev's two passes, the
# order and rank functions) take the spill pool's stripe replay.
LANE_FOLDABLE = frozenset({"sum", "zimsum", "count", "avg",
                           "min", "mimmin", "max", "mimmax"})
_EXTREME = frozenset({"min", "mimmin", "max", "mimmax"})
# T1's modes, in the order of its `enum Mode`, and each one's lanes.
FOLD_MODES = ("additive", "extreme", "square", "centred")
FOLD_LANES = {"additive": ("cnt", "present", "tot"),
              "extreme": ("cnt", "present", "lo", "hi"),
              "square": ("cnt", "present", "sq"),
              "centred": ("m2",)}
_LANE_SLOTS = {"additive": (0, 1, 2), "extreme": (0, 1, 3, 4),
               "square": (0, 1, 5), "centred": (5,)}
# T1's inputs' dtypes (contrib, participate, present, offsets) and its
# lanes', by mode
_FOLD_DTYPES = {mode: (torch.float64, torch.bool, torch.bool, torch.int64,
                       *(torch.int64 if k in ("cnt", "present")
                         else torch.float64 for k in keys))
                for mode, keys in FOLD_LANES.items()}


@dataclass(frozen=True)
class TilePlan:
    """A sized tiled execution: how the series and window axes split."""
    tile_rows: int       # series a tile (the last may hold fewer)
    n_tiles: int
    stripe_w: int        # windows a replay stripe
    n_stripes: int
    spill_bytes: int     # the partial grids' bytes through the pool


def size_tiles(s: int, w: int, budget_bytes: int, acc_cell_bytes: int,
               g_pad: int, max_tiles: int) -> TilePlan | None:
    """Split [s, w] so that every device-resident piece fits
    ``budget_bytes``; None when no split can (one row's [1, w] state or a
    one-window stripe over every series is still over the budget, or the
    split needs more than ``max_tiles`` tiles)."""
    if s < 1 or w < 1 or budget_bytes <= 0:
        return None
    per_row = w * max(acc_cell_bytes, TILE_WORK_CELL_BYTES)
    tile_rows = budget_bytes // per_row
    if tile_rows < 1:
        return None
    tile_rows = min(int(tile_rows), s)
    n_tiles = -(-s // tile_rows)
    if max_tiles > 0 and n_tiles > max_tiles:
        return None
    stripe_w = budget_bytes // ((s + g_pad) * STRIPE_CELL_BYTES)
    if stripe_w < 1:
        return None
    if stripe_w >= w:
        stripe_w = w
    else:
        stripe_w = 1 << max(int(stripe_w).bit_length() - 1, 0)
    n_stripes = -(-w // stripe_w)
    spill_bytes = s * w * SPILL_CELL_BYTES
    return TilePlan(tile_rows, n_tiles, stripe_w, n_stripes, spill_bytes)


def count_refusal(tsdb, reason: str) -> None:
    """One over-budget plan the tiled path could not serve (still a 413),
    tallied by reason in ``tsdb.tiled_refusals``."""
    with tsdb._stats_lock:
        tsdb.tiled_refusals[reason] = tsdb.tiled_refusals.get(reason, 0) + 1


def plan_tiled(tsdb, *, s: int, w: int, g_pad: int, acc_cell_bytes: int,
               state_mb: int | None = None,
               observe: bool = True) -> TilePlan | None:
    """Size a tiled execution of an over-budget [s, w] plan (w and g_pad
    padded as the reference pads them); None, with the reason tallied,
    when the pool is off, no split fits, or the partial grids exceed the
    pool's budgets.  `state_mb` replaces the configured budget (explain's
    what-if); with ``observe=False`` (explain's dry run) no refusal is
    tallied."""
    def refuse(reason: str) -> None:
        if observe:
            count_refusal(tsdb, reason)

    pool = tsdb.spill_pool
    if pool is None:
        refuse("disabled")
        return None
    config = tsdb.config
    if state_mb is None:
        state_mb = config.get_int("tsd.query.streaming.state_mb")
    plan = size_tiles(s, w, state_mb * 2 ** 20, acc_cell_bytes, g_pad,
                      config.get_int("tsd.query.spill.max_tiles"))
    if plan is None:
        refuse("no_fit")
        return None
    # one stripe entry of slack: demotion moves whole entries, so up to
    # one entry of disk room can go unused at the boundary
    entry_bytes = plan.tile_rows * plan.stripe_w * SPILL_CELL_BYTES
    if plan.spill_bytes + entry_bytes > pool.host_budget + pool.disk_budget:
        refuse("pool_budget")
        return None
    return plan


# -- per-tile kernels ------------------------------------------------------


# shape: wts[W] i64, v[S,W] f64, m[S,W] bool
# shape: -> ([S,W] f64, [S,W] bool, [S,W] bool)
def tile_contrib(spec, wts: torch.Tensor, v: torch.Tensor, m: torch.Tensor):
    """K2 on one tile's finished grid -> (contrib, participate, actual):
    the rate when the spec has one (a missing rate takes the previous
    one), then the gap fill, as run_grid_tail computes them before its
    group reduce (the reference's ``_tile_contrib``)."""
    policy = PREV if spec.rate is not None \
        else get_agg(spec.aggregator).interpolation
    return grid_fill_rate(wts, v, m, policy, spec.rate)


def new_lane_fold(num_groups: int, w: int, mode: str, device) -> dict:
    """Zeroed [G, W] partial moments for T1 in `mode` (FOLD_MODES): cnt
    and present (int64) with tot (additive), lo and hi (extreme) or sq
    (square); m2 alone (centred, dev's second pass)."""
    if mode not in FOLD_MODES:
        raise ValueError("a lane fold is one of %s, not %r"
                         % (", ".join(FOLD_MODES), mode))

    def full(value, dtype):
        return torch.full((num_groups, w), value, dtype=dtype, device=device)

    if mode == "centred":
        return {"m2": full(0.0, torch.float64)}
    acc = {"cnt": full(0, torch.int64), "present": full(0, torch.int64)}
    if mode == "extreme":
        acc["lo"] = full(math.inf, torch.float64)
        acc["hi"] = full(-math.inf, torch.float64)
    elif mode == "square":
        acc["sq"] = full(0.0, torch.float64)
    else:
        acc["tot"] = full(0.0, torch.float64)
    return acc


def fold_mode(acc: dict) -> str:
    """The T1 mode of a new_lane_fold accumulator, by its lanes."""
    if "m2" in acc:
        return "centred"
    if "lo" in acc:
        return "extreme"
    return "square" if "sq" in acc else "additive"


# shape: contrib[S,W] f64, participate[S,W] bool, present[S,W] bool,
# shape: offsets[G+1] i64, mean[G,W] f64|None -> None (acc [G,W] in place)
def tile_partials(contrib: torch.Tensor, participate: torch.Tensor,
                  present: torch.Tensor, offsets: torch.Tensor,
                  acc: dict, mean: torch.Tensor | None = None) -> None:
    """T1: add one tile's rows into the partial moments `acc`
    (new_lane_fold) in place, in the accumulator's mode.  Group g is rows
    [offsets[g], offsets[g+1]) of the tile.  Per (group, window), over
    the participating non-NaN cells: cnt counts them, tot adds them, lo
    and hi take their extremes, sq adds their squares, m2 their squared
    distances from the cell's `mean` (the centred mode, which takes it);
    present counts the cells that hold a real value."""
    s, w = contrib.shape
    g = offsets.numel() - 1
    mode = fold_mode(acc)
    lanes = [acc[k] for k in FOLD_LANES[mode]]
    if participate.shape != (s, w) or present.shape != (s, w) \
            or any(x.shape != (g, w) for x in lanes) \
            or (mode == "centred") != (mean is not None) \
            or (mean is not None and mean.shape != (g, w)):
        raise ValueError("tile_partials takes [S, W] grids, offsets[G + 1] "
                         "and [G, W] accumulators, and a [G, W] mean in "
                         "the centred mode only")
    if (contrib.dtype, participate.dtype, present.dtype, offsets.dtype,
            *(x.dtype for x in lanes)) != _FOLD_DTYPES[mode] \
            or (mean is not None and mean.dtype != torch.float64):
        raise ValueError("tile_partials takes contrib f64, participate and "
                         "present bool, offsets int64, cnt and present "
                         "int64 and the other lanes and the mean f64")
    if contrib.is_cpu:
        tile_partials_plain(contrib, participate, present, offsets, acc,
                            mean)
        return
    extra = [] if mean is None else [mean]
    dev = kernels.require_cuda(contrib, participate, present, offsets,
                               *lanes, *extra)
    if g == 0 or w == 0:
        return
    # the C entry's six lane pointers (cnt, present, tot, lo, hi, sq or
    # m2), null where the mode has no such lane
    at = [None] * 6
    for i, x in zip(_LANE_SLOTS[mode], lanes):
        at[i] = x.data_ptr()
    kernels.launch(
        "tile_partials", dev, contrib.data_ptr(), participate.data_ptr(),
        present.data_ptr(), offsets.data_ptr(),
        None if mean is None else mean.data_ptr(), s, g, w,
        FOLD_MODES.index(mode), *at, mode=mode)


def tile_partials_plain(contrib, participate, present, offsets,
                        acc: dict, mean: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of T1: index_add_ and scatter_reduce_ of the
    tile's member rows onto the accumulators."""
    dev = contrib.device
    g = offsets.numel() - 1
    lo_row, hi_row = int(offsets[0]), int(offsets[-1])
    sizes = (offsets[1:] - offsets[:-1]).to(dev)
    rows = torch.repeat_interleave(torch.arange(g, device=dev), sizes)
    x = contrib[lo_row:hi_row]
    ok = participate[lo_row:hi_row] & ~torch.isnan(x)
    if "m2" in acc:
        c = torch.where(ok, x - mean[rows], 0.0)
        acc["m2"].index_add_(0, rows, c * c)
        return
    acc["cnt"].index_add_(0, rows, ok.to(torch.int64))
    acc["present"].index_add_(0, rows,
                              present[lo_row:hi_row].to(torch.int64))
    if "lo" in acc:
        idx = rows[:, None].expand(-1, x.shape[1])
        acc["lo"].scatter_reduce_(0, idx, torch.where(ok, x, math.inf),
                                  "amin", include_self=True)
        acc["hi"].scatter_reduce_(0, idx, torch.where(ok, x, -math.inf),
                                  "amax", include_self=True)
        return
    v = torch.where(ok, x, 0.0)
    if "sq" in acc:
        acc["sq"].index_add_(0, rows, v * v)
    else:
        acc["tot"].index_add_(0, rows, v)


# shape: wts[W] i64, v[S,W] f64, m[S,W] bool, offsets[G+1] i64 -> None
def run_lane_fold(spec, acc: dict, wts: torch.Tensor, v: torch.Tensor,
                  m: torch.Tensor, offsets: torch.Tensor) -> None:
    """One tile of the striped lane fold: K2 on its finished grid, then
    T1 into `acc` (the reference's ``run_lane_fold``, :281)."""
    contrib, participate, actual = tile_contrib(spec, wts, v, m)
    tile_partials(contrib, participate, actual, offsets, acc)


def finish_lane_fold(acc: dict, agg_name: str, m2: torch.Tensor | None = None):
    """(out[G, W] f64, out_mask[G, W] bool) from folded partial moments:
    moment_group_reduce's arithmetic and K3's finish (avg is tot /
    max(cnt, 1); squareSum the sum of squares; dev sqrt(m2 / (cnt - 1))
    from the centred pass's `m2` where cnt >= 2, else 0; every answer but
    count is NaN where cnt is 0), the mask where some member held a real
    value."""
    cnt = acc["cnt"]
    if agg_name in ("min", "mimmin"):
        out = acc["lo"]
    elif agg_name in ("max", "mimmax"):
        out = acc["hi"]
    elif agg_name == "count":
        out = cnt.to(torch.float64)
    elif agg_name == "avg":
        out = acc["tot"] / cnt.clamp(min=1).to(torch.float64)
    elif agg_name == "squareSum":
        out = acc["sq"]
    elif agg_name == "dev":
        out = torch.where(cnt >= 2, torch.sqrt(
            m2 / (cnt - 1).clamp(min=1).to(torch.float64)), 0.0)
    else:
        out = acc["tot"]
    if agg_name != "count":
        out = torch.where(cnt > 0, out, math.nan)
    return out, acc["present"] > 0


def lane_mode(agg_name: str) -> str:
    """The T1 mode whose lanes finish `agg_name` (dev: its first pass)."""
    if agg_name in _EXTREME:
        return "extreme"
    return "square" if agg_name == "squareSum" else "additive"


# -- the executor -----------------------------------------------------------


def _spill_failure(exc, s: int, w: int, plan: TilePlan):
    """The query-level answer to a pool failure: the reference's 503 for a
    failed disk write, its 413 otherwise (:438-448)."""
    from opentsdb_tpu_torch.query.limits import QueryException
    from opentsdb_tpu_torch.storage.spill import SpillWriteError
    if isinstance(exc, SpillWriteError):
        return QueryException(
            "Sorry, the spill pool backing this tiled query failed to "
            "write (%s); please retry." % exc, status=503)
    return QueryException(
        "Sorry, this query's partial aggregates (%d series x %d windows, "
        "~%dMB) exceed the spill pool budget (tsd.query.spill.*): %s"
        % (s, w, plan.spill_bytes // 2 ** 20, exc))


def run_tiled(tsdb, spec, num_series: int, gid, num_groups: int, w: int,
              plan: TilePlan, budget, tile_grid_fn):
    """Execute an over-budget grouped plan tiled -> ((wts[W], out[G, W],
    out_mask[G, W]) on the TSDB's device, stats).

    ``tile_grid_fn(row_lo, row_hi) -> ((wts[W], v[rows, W], m[rows, W]),
    chunks)`` gives a tile's finished downsample grid on the device.
    Every pooled key is released on every exit path; a pool failure
    becomes the reference's 503 or 413, never a resident run.  The
    deadline is checked before every tile and every stripe.  `stats`
    holds the tiles and stripes run (and the stripes planned on the
    padded W, the count the reference reports), the bytes through the
    pool, the cost model's prediction of the overhead (``predictedMs``:
    pool writes, pool reads and stripe replays) and the host-clock split
    (tile grids, K2 and the copy to the host, pool writes, pool reads,
    stripe replays)."""
    from opentsdb_tpu_torch.storage.spill import SpillError

    pool = tsdb.spill_pool
    dev = tsdb.device
    cuda = dev.type == "cuda"
    g = np.asarray(gid, np.int64)
    offsets = group_offsets(g, num_groups).to(dev)
    tiles = [(lo, min(lo + plan.tile_rows, num_series))
             for lo in range(0, num_series, plan.tile_rows)]
    stripes = [(lo, min(lo + plan.stripe_w, w))
               for lo in range(0, w, plan.stripe_w)]
    predicted_ms = cm.predict_tiled(num_series * w * SPILL_CELL_BYTES,
                                    len(stripes)) * 1e3
    split = {"tileGridMs": 0.0, "tileContribMs": 0.0, "spillWriteMs": 0.0,
             "spillReadMs": 0.0, "replayMs": 0.0}

    def tick(key, t0):
        if cuda:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        split[key] += (now - t0) * 1e3
        return now

    keys: list = []
    grid_keys: list[list] = []
    wts = None
    spilled = 0
    chunks = 0
    ma = ma_window(spec.aggregator)
    try:
        for lo, hi in tiles:
            budget.check_deadline()
            t0 = time.perf_counter()
            (t_wts, v, m), n_chunks = tile_grid_fn(lo, hi)
            chunks += n_chunks
            t0 = tick("tileGridMs", t0)
            contrib, participate, actual = tile_contrib(spec, t_wts, v, m)
            if wts is None:
                wts = t_wts
            del v, m
            host = [x.cpu().numpy() for x in (contrib, participate, actual)]
            del contrib, participate, actual
            t0 = tick("tileContribMs", t0)
            row = []
            for w0, w1 in stripes:
                entry = tuple(a[:, w0:w1] for a in host)
                try:
                    key = pool.put(entry)
                except SpillError as e:
                    raise _spill_failure(e, num_series, w, plan) from e
                keys.append(key)
                row.append(key)
                spilled += sum(a.nbytes for a in entry)
            grid_keys.append(row)
            del host
            tick("spillWriteMs", t0)
        out = torch.empty((num_groups, w), dtype=torch.float64, device=dev)
        out_mask = torch.empty((num_groups, w), dtype=torch.bool, device=dev)
        count = torch.empty_like(out) if ma is not None else None
        for s_i, (w0, w1) in enumerate(stripes):
            budget.check_deadline()
            t0 = time.perf_counter()
            n = w1 - w0
            grids = [torch.empty((num_series, n), dtype=dt, pin_memory=cuda)
                     for dt in (torch.float64, torch.bool, torch.bool)]
            views = [x.numpy() for x in grids]
            for t_i, (lo, hi) in enumerate(tiles):
                key = grid_keys[t_i][s_i]
                for dst, part in zip(views, pool.get(key)):
                    dst[lo:hi] = part
                pool.free(key)
            t0 = tick("spillReadMs", t0)
            V, P, A = (x.to(dev) for x in grids)
            if ma is not None:
                out[:, w0:w1], out_mask[:, w0:w1] = group_moments(
                    "sum", V, P, A, offsets)
                count[:, w0:w1], _ = group_moments("count", V, P, A, offsets)
            else:
                out[:, w0:w1], out_mask[:, w0:w1] = group_reduce(
                    spec.aggregator, V, P, A, offsets)
            del V, P, A, grids, views
            tick("replayMs", t0)
        if ma is not None:
            # the moving average over the whole width, as group_reduce
            # takes it on a resident grid
            t0 = time.perf_counter()
            live = count > 0
            out = torch.where(live, moving_average_rows(out, live, ma),
                              math.nan)
            tick("replayMs", t0)
    finally:
        pool.release(keys)
    stats = {"tiles": len(tiles), "stripes": len(stripes),
             "stripesPlanned": plan.n_stripes, "spillBytes": int(spilled),
             "chunks": int(chunks), "predictedMs": predicted_ms, **split}
    return (wts, out, out_mask), stats
