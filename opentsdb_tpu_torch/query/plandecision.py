"""The device-state budget verdicts of a grouped plan: resident, tiled,
striped or refused.

The part of opentsdb_tpu/query/plandecision.py that out-of-core execution
needs (the rest of the module, with the batcher, the host lane and the
explain engine, is ROADMAP slice 8):

* ``acc_cell_bytes`` (:117): streaming-state bytes a (series, window) cell.
* ``grid_budget_for`` and ``streaming_budget_for``: the materialized
  grid's and the streaming state's decisions; a plan is held to the
  streaming budget when it streams, else to the grid budget (:255-259).
* ``over_budget_plan`` (:287-300): a plan over its budget is tiled
  (ops/tiling.plan_tiled) when its function streams, else tallied as
  ``not_streamable``; None means the structured 413.
* ``size_lane_stripes`` (:152): the striped serve of a rollup-lane plan
  whose grid is over the budget.

Sizes are the reference's padded window and group counts (``pad_pow2``),
so the two packages route and refuse alike.
"""

from __future__ import annotations

from opentsdb_tpu_torch.ops import tiling
from opentsdb_tpu_torch.ops.streaming import SKETCH_K, lanes_for
from opentsdb_tpu_torch.query.limits import GridBudgetDecision, grid_budget

# bytes a cell of an [S, W] grid holds on the device through the tail
# (values, contributions, masks)
GRID_CELL_BYTES = 24


def acc_cell_bytes(ds_fn: str | None, sketchable: bool) -> int:
    """Streaming accumulator bytes a (series, window) cell: the count, the
    function's moment lanes and the sketch."""
    return 8 + 8 * len(lanes_for([ds_fn])) \
        + (4 * SKETCH_K if sketchable else 0)


def grid_budget_for(state_mb: int, s: int, wp: int,
                    seg_kind: str) -> GridBudgetDecision:
    """The materialized grid's decision: three grid lanes live through a
    dispatch, and a rollup-avg read carries a second grid, its count
    lane's."""
    lanes = 2 if seg_kind == "rollup_avg" else 1
    return grid_budget("grid", state_mb, s * wp * GRID_CELL_BYTES * lanes,
                       s, wp)


def streaming_budget_for(state_mb: int, s: int, wp: int, ds_fn: str | None,
                         sketchable: bool) -> GridBudgetDecision:
    """The streaming accumulator's decision."""
    return grid_budget("streaming", state_mb,
                       s * wp * acc_cell_bytes(ds_fn, sketchable), s, wp,
                       sketch=sketchable)


def over_budget_plan(tsdb, *, stream_ok: bool, s: int, wp: int, g_pad: int,
                     ds_fn: str | None, sketchable: bool):
    """The tiled plan of a plan over its budget, or None for the
    structured 413 (the reason tallied): a function that does not stream
    cannot be tiled."""
    if not stream_ok:
        tiling.count_refusal(tsdb, "not_streamable")
        return None
    return tiling.plan_tiled(tsdb, s=s, w=wp, g_pad=g_pad,
                             acc_cell_bytes=acc_cell_bytes(ds_fn, sketchable))


def size_lane_stripes(tsdb, plan, s: int, wp: int, g_pad: int,
                      state_mb: int, aggregator: str):
    """Mark a rollup-lane plan whose [S, W] grid is over the budget
    striped, with its tile split; None when it cannot be served so (no
    tile split fits, or an aggregator that needs the spill pool's replay
    finds the pool off or too small), and the caller takes the exact
    path.  The aggregators of tiling.LANE_FOLDABLE fold tile by tile into
    [G, W] partial moments when those fit the budget and need no pool."""
    tp = tiling.size_tiles(s, wp, state_mb * 2 ** 20, 9, g_pad,
                           tsdb.config.get_int("tsd.query.spill.max_tiles"))
    if tp is None:
        return None
    fold_ok = (aggregator in tiling.LANE_FOLDABLE
               and 5 * g_pad * wp * 8 <= state_mb * 2 ** 20)
    if not fold_ok:
        pool = tsdb.spill_pool
        if pool is None:
            return None
        entry_bytes = tp.tile_rows * tp.stripe_w * tiling.SPILL_CELL_BYTES
        if tp.spill_bytes + entry_bytes > pool.host_budget + pool.disk_budget:
            return None
    plan.striped = True
    plan.tile_plan = tp
    return plan
