"""plan_decision(): a grouped segment's routing verdict as one pure
function, and the device-state budget verdicts it rests on.

Port of opentsdb_tpu/query/plandecision.py.  ``plan_decision`` (:239)
takes a ``RouteContext`` snapshot of the segment and a consults provider
(the planner's ``_ExecConsults``; the explain engine's read-only twin
comes with it, slice 8c) and returns a ``PlanDecision``: its path, in the
reference's order of arms (rollup lane, then tiled or refused over the
budget, the aggregate cache's rewrite, batched, the device cache,
streamed, rollup_avg, mesh, resident), and a fingerprint over the
discrete routing facts (``_finish``, ``_fingerprint``).  A segment of at
least ``tsd.query.mesh.min_series`` series on a TSDB with a device mesh
(``RouteContext.use_mesh``) keeps the rollup lanes, the aggregate cache
and the batched arm off and takes the ``mesh`` path, or streams over the
mesh; its budgets are per chip (:128-147).  The aggregate cache
(storage/agg_cache.py) is consulted before the batched arm is priced
(:311-324): a warm rewrite skips the batch build and the gather too; a
movingAverage<N> downsample is not consulted, since its pieces would
each restart the average (the reference consults it, and answers a
repeat differently with the cache on).  A
device-cache consult passes the context's ``ts_base``, so a hit's batch
comes as int32 offsets.  Differences: there is no host lane (every plan
is answered on the card), so the context carries none and the
fingerprint's ``hostSmall`` is always false; the port has one kernel per
function and no modes, so the fingerprint has no ``modes`` field and its
``calibration`` reads "default".

The budget verdicts:

* ``acc_cell_bytes`` (:117): streaming-state bytes a (series, window) cell.
* ``grid_budget_for`` and ``streaming_budget_for``: the materialized
  grid's and the streaming state's decisions, per chip under the mesh
  (costmodel.per_chip); a plan is held to the streaming budget when it
  streams, else to the grid budget (:255-259).
* ``size_lane_stripes`` (:152): the striped serve of a rollup-lane plan
  whose grid is over the budget.

Sizes are the reference's padded window and group counts (``pad_pow2``),
so the two packages route and refuse alike.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops import tiling
from opentsdb_tpu_torch.ops.aggregators import ma_window
from opentsdb_tpu_torch.ops.streaming import SKETCH_K, lanes_for, pad_pow2
from opentsdb_tpu_torch.query.limits import GridBudgetDecision, grid_budget

# bytes a cell of an [S, W] grid holds on the device through the tail
# (values, contributions, masks)
GRID_CELL_BYTES = 24

@dataclass(frozen=True)
class RouteContext:
    """Everything the routing verdict depends on, snapshotted once a
    segment (the reference's RouteContext, :61)."""
    seg_kind: str            # "raw" | "rollup" | "rollup_avg"
    ds_fn: str | None
    aggregator: str
    has_rate: bool
    s: int                   # series rows in the dispatch
    n_max: int               # the longest row's point count
    wp: int                  # padded window count (pad_pow2(W))
    groups: int              # group-by buckets kept
    g_pad: int               # padded group count
    total_points: int
    sketchable: bool
    stream_ok: bool
    windows_fixed: bool
    store_is_raw: bool
    has_store: bool
    platform: str            # the device type the plan runs on
    state_mb: int
    point_threshold: int
    batch_ok: bool = False
    batch_factor: float = 0.0
    # the int32 base of a device-cache hit (ops.downsample.precompact_base)
    ts_base: int | None = None
    # the segment runs over the device mesh, of n_chips devices
    use_mesh: bool = False
    n_chips: int = 1


@dataclass
class PlanDecision:
    """One grouped segment's complete routing verdict."""
    path: str
    would_stream: bool
    lane_plan: object = None
    tiled_plan: object = None
    agg_plan: object = None          # the aggregate cache's RewritePlan
    agg_note: dict | None = None     # its decision, consulted or not
    cached: object = None            # the device cache's batch, or None
    refusal: GridBudgetDecision | None = None
    n_pad: int = 0
    g_dec: int = 0
    fp_fields: dict = field(default_factory=dict)
    fingerprint: str = ""


def acc_cell_bytes(ds_fn: str | None, sketchable: bool) -> int:
    """Streaming accumulator bytes a (series, window) cell: the count, the
    function's moment lanes and the sketch."""
    return 8 + 8 * len(lanes_for([ds_fn])) \
        + (4 * SKETCH_K if sketchable else 0)


def grid_budget_for(state_mb: int, s: int, wp: int, seg_kind: str,
                    n_chips: int = 1) -> GridBudgetDecision:
    """The materialized grid's decision: three grid lanes live through a
    dispatch, per chip when the mesh shards the rows, and a rollup-avg
    read (never sharded) carries a second grid, its count lane's."""
    lanes = 2 if seg_kind == "rollup_avg" else 1
    chips = 1 if seg_kind == "rollup_avg" else n_chips
    return grid_budget("grid", state_mb, cm.per_chip(
        s * wp * GRID_CELL_BYTES * lanes, chips), s, wp)


def streaming_budget_for(state_mb: int, s: int, wp: int, ds_fn: str | None,
                         sketchable: bool,
                         n_chips: int = 1) -> GridBudgetDecision:
    """The streaming accumulator's decision, per chip under the mesh."""
    return grid_budget("streaming", state_mb, cm.per_chip(
        s * wp * acc_cell_bytes(ds_fn, sketchable), n_chips), s, wp,
        sketch=sketchable)


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


def _fingerprint(fields: dict) -> str:
    """Stable hash over the discrete routing facts (:186): canonical JSON,
    the first 16 hex digits of its sha256."""
    blob = json.dumps(fields, sort_keys=True, separators=(",", ":"))
    return "pf-" + hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _finish(pd: PlanDecision, ctx: RouteContext) -> PlanDecision:
    """The fingerprint of a decision, refused or served (:194): ``mesh``
    is the context's use of the mesh, whatever the path, as in the
    reference.  The port has no host lane, no modes and one cost table:
    ``hostSmall`` is false, there is no ``modes`` field, and the
    ``calibration`` is "default"."""
    fields = {
        "path": pd.path,
        "seg": ctx.seg_kind,
        "ds": ctx.ds_fn,
        "agg": ctx.aggregator,
        "rate": ctx.has_rate,
        "platform": ctx.platform,
        "s": ctx.s, "n": pd.n_pad, "w": ctx.wp,
        "g": pd.g_dec, "gPad": ctx.g_pad,
        "stream": pd.would_stream,
        "mesh": ctx.use_mesh,
        "hostSmall": False,
        "deviceCache": bool(pd.cached),
        "calibration": "default",
    }
    if pd.lane_plan is not None:
        fields["lane"] = {"lane": pd.lane_plan.lane,
                          "k": pd.lane_plan.k,
                          "striped": bool(pd.lane_plan.striped)}
    if pd.path == "agg_rewrite" and pd.agg_note is not None:
        fields["aggCache"] = {
            "reason": pd.agg_note.get("reason"),
            "cached": pd.agg_note.get("cachedWindows"),
            "computed": pd.agg_note.get("computedWindows")}
    if pd.tiled_plan is not None:
        fields["tiled"] = {"tiles": pd.tiled_plan.n_tiles,
                           "rows": pd.tiled_plan.tile_rows,
                           "stripes": pd.tiled_plan.n_stripes,
                           "stripeW": pd.tiled_plan.stripe_w}
    if pd.refusal is not None:
        fields["refused"] = {"kind": pd.refusal.kind,
                             "limitMb": pd.refusal.state_mb}
    pd.fp_fields = fields
    pd.fingerprint = _fingerprint(fields)
    return pd


def plan_decision(tsdb, ctx: RouteContext, consults) -> PlanDecision:
    """THE routing verdict for one grouped segment (:239).

    ``consults`` provides the stateful hooks: ``rollup_plan()`` (a lane
    plan or None), ``tiled_plan(acc_cell)``, ``agg_plan(platform)`` (a
    rewrite plan or None, and its decision), ``device_batch(build,
    ts_base)``, and the accounting callbacks ``note_lane_served(plan)``,
    ``note_lane_fallback()`` and ``tiled_refusal(reason)``.  Eligibility,
    the order of the consults, the budget guards and the path live here.
    """
    would_stream = (ctx.stream_ok
                    and ctx.total_points > ctx.point_threshold)
    grid_gbd = grid_budget_for(ctx.state_mb, ctx.s, ctx.wp, ctx.seg_kind,
                               ctx.n_chips)
    gbd = (streaming_budget_for(ctx.state_mb, ctx.s, ctx.wp, ctx.ds_fn,
                                ctx.sketchable, ctx.n_chips)
           if would_stream else grid_gbd)

    # the rollup lanes first: a plan over the budget is striped, or takes
    # the exact path counted a miss; a meshed plan never reads them
    lane_plan = None
    if (getattr(tsdb, "rollup_lanes", None) is not None
            and ctx.seg_kind == "raw" and ctx.store_is_raw
            and not ctx.use_mesh and ctx.s > 0 and ctx.windows_fixed):
        lane_plan = consults.rollup_plan()
        if lane_plan is not None:
            lane_gbd = grid_budget("grid", ctx.state_mb,
                                   ctx.s * ctx.wp * GRID_CELL_BYTES, ctx.s,
                                   ctx.wp)
            if lane_gbd.over:
                lane_plan = size_lane_stripes(
                    tsdb, lane_plan, ctx.s, ctx.wp, ctx.g_pad, ctx.state_mb,
                    ctx.aggregator)
                if lane_plan is None:
                    consults.note_lane_fallback()
            if lane_plan is not None:
                consults.note_lane_served(lane_plan)

    # over the budget: a tiled execution, or the structured 413
    tiled_plan = None
    if gbd.over and lane_plan is None:
        if not ctx.stream_ok:
            consults.tiled_refusal("not_streamable")
        else:
            tiled_plan = consults.tiled_plan(
                acc_cell_bytes(ctx.ds_fn, ctx.sketchable))
        if tiled_plan is None:
            pd = PlanDecision(
                path="refused", would_stream=would_stream, refusal=gbd,
                n_pad=pad_pow2(max(ctx.n_max, 1)),
                g_dec=pad_pow2(max(ctx.groups, 1)))
            return _finish(pd, ctx)

    # the partial-aggregate rewrite (storage/agg_cache.py), before the
    # batched arm and the device cache: a warm rewrite skips the batch
    # build and the gather.  A movingAverage<N> downsample is never
    # rewritten: a piece's average would restart without the N - 1
    # windows before it (the reference consults it, and differs); nor is
    # a meshed plan
    agg_plan = agg_note = None
    if (tiled_plan is None and lane_plan is None
            and getattr(tsdb, "agg_cache", None) is not None
            and not would_stream and not ctx.use_mesh
            and ctx.seg_kind == "raw"
            and ctx.store_is_raw and ctx.windows_fixed
            and ma_window(ctx.ds_fn or "") is None):
        agg_plan, agg_note = consults.agg_plan(ctx.platform)

    n_pad = pad_pow2(max(ctx.n_max, 1))
    g_dec = pad_pow2(max(ctx.groups, 1))

    # fused multi-query dispatch (query/batcher.py), priced before the
    # device cache's consult: a dispatch-bound plan goes through the
    # batcher, which stacks concurrent compatible plans into one launch
    # of each kernel; a compute-bound plan dispatches now; a meshed plan
    # is never batched
    batched = False
    if (tiled_plan is None and lane_plan is None and agg_plan is None
            and ctx.batch_ok and not would_stream and not ctx.use_mesh
            and ctx.seg_kind == "raw" and ctx.has_store
            and ctx.ds_fn is not None):
        compute_s = sum(cm.stage_breakdown(
            ctx.s, n_pad, ctx.wp, g_dec, ctx.ds_fn, ctx.has_rate).values())
        batched = cm.coalesce_worthwhile(compute_s, ctx.s, n_pad, ctx.wp,
                                         g_dec, ctx.batch_factor)

    # the device series cache: a streamed plan queues a cold entry's build
    # instead of building it inline, and a hit must not divert a streamed
    # plan onto a grid over the budget; batched plans skip the consult
    cached = None
    if (tiled_plan is None and lane_plan is None and agg_plan is None
            and not batched
            and getattr(tsdb, "device_cache", None) is not None
            and ctx.has_store and ctx.seg_kind in ("raw", "rollup")):
        cached = consults.device_batch(build=not would_stream,
                                       ts_base=ctx.ts_base)
        if cached is not None and would_stream and grid_gbd.over:
            cached = None

    if lane_plan is not None:
        path = "rollup_lane"
    elif tiled_plan is not None:
        path = "tiled"
    elif agg_plan is not None:
        path = "agg_rewrite"
    elif batched:
        path = "batched"
    elif cached is None and would_stream:
        path = "streamed"
    elif ctx.seg_kind == "rollup_avg":
        path = "rollup_avg"
    elif ctx.use_mesh:
        path = "mesh"
    else:
        path = "resident"
    pd = PlanDecision(
        path=path, would_stream=would_stream, lane_plan=lane_plan,
        tiled_plan=tiled_plan, agg_plan=agg_plan, agg_note=agg_note,
        cached=cached, n_pad=n_pad, g_dec=g_dec)
    return _finish(pd, ctx)
