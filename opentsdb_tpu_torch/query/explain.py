"""/api/query/explain: a query's routing verdict without running it.

Port of opentsdb_tpu/query/explain.py.  Explain takes the whole
/api/query request (plus what-if overrides) and returns the decision tree
the executor would follow: the admission preview against the deadline
(tsd/admission.py ``preview``), and per grouped segment the path and
fingerprint, the rollup-lane, aggregate-cache and device-cache consults,
the device budget and any tiling, the structured 413 of a refused plan,
and the cost model's pricing of the dispatch.  It launches no kernel,
builds no batch and takes no admission permit; it stays bounded by the
request's deadline and scan budget, charged as the executor charges them.

The verdict is the executor's own: explain builds the segment's
``RouteContext`` with the planner's ``route_context`` and calls the same
``plan_decision`` (query/plandecision.py), fed by ``_ExplainConsults``,
whose arms are read-only: ``RollupLanes.plan(observe=False)``,
``AggCache.plan(observe=False)``, ``plan_tiled(observe=False)`` and
``DeviceSeriesCache.peek``.  So the path and fingerprint explain reports
are those the executor stamps (``runner.decisions``) when the same query
then runs on the same state.

What-ifs, ``what_if=key=value`` (repeatable) in a GET or a ``whatIf``
object in a POST body:

* ``assume_rollup``, ``assume_agg_cache``, ``assume_device_cache``:
  ``cold`` or ``warm`` (``live``, the default, consults the state);
* ``state_mb``: the device budget (tsd.query.streaming.state_mb);
* ``rollup_mb``: 0 turns the lanes off for the verdict;
* ``deadline_ms``: the admission preview's budget;
* ``calibration``: ``auto`` and ``default`` give the same answer (the
  port prices on one table, ``cuda``).

Deliberate differences (ROADMAP queue C): ``platform`` other than
``cuda`` and every ``force_*`` what-if answer 400, as the port prices one
platform and has one kernel a function with no modes to force;
``calibration=file`` answers 400 until calibration is ported (after
slice 8d); ``costmodel`` is the dispatch's stage pricing
(ops/costmodel.py ``stage_breakdown`` on the ``cuda`` table), not
per-axis mode candidates; no flight-recorder ``plan`` event is written
(slice 8d), so the executed side of a parity check is
``runner.decisions``; ``cluster`` is null until slice 9c.
"""

from __future__ import annotations

from dataclasses import dataclass

from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops.tiling import plan_tiled
from opentsdb_tpu_torch.query import plandecision as pdn
from opentsdb_tpu_torch.query.limits import QueryException
from opentsdb_tpu_torch.query.planner import route_context
from opentsdb_tpu_torch.tsd import admission

_ASSUME = ("live", "cold", "warm")
_CALIBRATIONS = ("auto", "default")


class WhatIfError(ValueError):
    """A what-if the grammar refuses (400 at the endpoint)."""


@dataclass
class WhatIf:
    """Parsed what-if overrides; the defaults explain the live state."""
    assume_rollup: str = "live"
    assume_agg_cache: str = "live"
    assume_device_cache: str = "live"
    state_mb: int | None = None
    rollup_mb: int | None = None
    platform: str | None = None
    calibration: str = "auto"
    deadline_ms: int | None = None

    @property
    def active(self) -> bool:
        return bool(self.to_json())

    def to_json(self) -> dict:
        out: dict = {}
        for key, live in (("assume_rollup", "live"),
                          ("assume_agg_cache", "live"),
                          ("assume_device_cache", "live"),
                          ("calibration", "auto")):
            value = getattr(self, key)
            if value != live:
                out[key] = value
        for key in ("state_mb", "rollup_mb", "platform", "deadline_ms"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        return out


def parse_what_if(raw: dict) -> WhatIf:
    """The what-if grammar above; raises WhatIfError on an unknown key, a
    value outside the grammar, or a what-if the port refuses."""
    wi = WhatIf()
    for key, value in (raw or {}).items():
        value = str(value).strip().lower()
        if key in ("assume_rollup", "assume_agg_cache",
                   "assume_device_cache"):
            if value not in _ASSUME:
                raise WhatIfError("%s must be one of %s"
                                  % (key, "|".join(_ASSUME)))
            setattr(wi, key, value)
        elif key in ("state_mb", "rollup_mb", "deadline_ms"):
            try:
                parsed = int(value)
            except ValueError:
                raise WhatIfError("%s must be an integer" % key)
            if parsed < 0:
                raise WhatIfError("%s must be >= 0" % key)
            setattr(wi, key, parsed)
        elif key == "platform":
            if value != "cuda":
                raise WhatIfError(
                    "platform must be cuda: this port prices one "
                    "platform, the card (no %s cost table)" % value)
            wi.platform = value
        elif key == "calibration":
            if value == "file":
                raise WhatIfError(
                    "calibration=file is not ported yet: the port prices "
                    "on its one measured table (ROADMAP A, calibration "
                    "after slice 8d)")
            if value not in _CALIBRATIONS:
                raise WhatIfError("calibration must be one of %s"
                                  % "|".join(_CALIBRATIONS))
            wi.calibration = value
        elif key.startswith("force_"):
            raise WhatIfError(
                "%s is refused: the port has one kernel a function and no "
                "kernel modes to force" % key)
        else:
            raise WhatIfError("unknown what-if key: %r" % key)
    return wi


@dataclass
class _WhatIfLanePlan:
    """A hypothetical full lane hit (assume_rollup=warm): what the
    striping sizer and the fingerprint read of a LanePlan."""
    lane: str
    k: int
    striped: bool = False
    tile_plan: object = None


class _ExplainConsults:
    """plan_decision's consults, read-only: the dry runs of the lanes,
    the aggregate cache and the tiled sizer, the device cache's peek, and
    no accounting (the executor's twin is the planner's _ExecConsults).
    ``lane_note`` keeps the lane consult's decision for the report."""

    def __init__(self, tsdb, ctx, what_if: WhatIf, seg, spec, windows,
                 store, series_list):
        self.tsdb = tsdb
        self.ctx = ctx
        self.what_if = what_if
        self.seg = seg
        self.spec = spec
        self.windows = windows
        self.store = store
        self.series_list = series_list
        self.lane_note = None

    def _metric(self) -> int:
        return self.series_list[0].key.metric

    def rollup_plan(self):
        wi = self.what_if
        ctx = self.ctx
        assume = "cold" if wi.rollup_mb == 0 else wi.assume_rollup
        note = {"decision": "fallback", "reason": "", "lane": "",
                "coverage": 0.0}
        self.lane_note = note
        if assume == "cold":
            note["reason"] = "what_if_cold"
            return None
        lanes = self.tsdb.rollup_lanes
        if assume == "warm":
            # a full lane hit, where a lane could serve at all
            note["whatIf"] = "warm"
            if not lanes.derivable(ctx.ds_fn):
                note["reason"] = "not_derivable"
                return None
            interval = self.windows.interval_ms
            picked = lanes.lane_for(interval, self.windows.first_window_ms)
            if picked is None:
                note["reason"] = "no_lane_divides"
                return None
            label, lane_ms = picked
            note.update(decision="lane", reason="what_if_warm", lane=label,
                        coverage=1.0)
            return _WhatIfLanePlan(lane=label, k=interval // lane_ms)
        return lanes.plan(
            self._metric(), self.series_list, self.windows,
            self.seg.start_ms, self.seg.end_ms, ctx.ds_fn, ctx.n_max,
            ctx.groups, ctx.has_rate, total_points=ctx.total_points,
            observe=False, note=note)

    def note_lane_served(self, plan) -> None:
        pass

    def note_lane_fallback(self) -> None:
        pass

    def tiled_refusal(self, reason: str) -> None:
        pass

    def tiled_plan(self, acc_cell: int):
        ctx = self.ctx
        return plan_tiled(self.tsdb, s=ctx.s, w=ctx.wp, g_pad=ctx.g_pad,
                          acc_cell_bytes=acc_cell, state_mb=ctx.state_mb,
                          observe=False)

    def _holds(self) -> bool:
        """Whether the device cache holds the metric, as assumed."""
        assume = self.what_if.assume_device_cache
        if assume != "live":
            return assume == "warm"
        cache = self.tsdb.device_cache
        return (cache is not None and self.store is self.tsdb.store
                and cache.holds(self.store, self._metric()))

    def agg_plan(self, platform: str):
        assume = self.what_if.assume_agg_cache
        w = self.windows.count
        if assume == "cold":
            return None, {"decision": "recompute", "reason": "what_if_cold",
                          "coverage": 0.0, "cachedWindows": 0,
                          "computedWindows": w}
        if assume == "warm":
            return object(), {"decision": "rewrite",
                              "reason": "what_if_warm", "coverage": 1.0,
                              "cachedWindows": w, "computedWindows": 0}
        ctx = self.ctx
        step = self.spec.downsample
        return self.tsdb.agg_cache.plan(
            self.store, self._metric(), self.series_list, self.windows,
            self.seg.start_ms, self.seg.end_ms, ctx.ds_fn, step.fill_policy,
            step.fill_value, platform, ctx.s, ctx.n_max, ctx.g_pad,
            ctx.has_rate, total_points=ctx.total_points,
            full_hit=self._holds(), observe=False)

    def device_batch(self, build: bool, ts_base: int | None = None):
        """True where the executor's consult would gather, else None."""
        tsdb = self.tsdb
        if self.store is not tsdb.store:
            return None
        assume = self.what_if.assume_device_cache
        if assume != "live":
            return True if assume == "warm" else None
        warm = tsdb.device_cache.peek(
            self.store, self._metric(), self.series_list,
            self.seg.start_ms, self.seg.end_ms, build=build,
            ts_base=ts_base)
        return True if warm else None


def explain_query(tsdb, ts_query, what_if: WhatIf) -> dict:
    """The decision tree of one parsed, validated TSQuery: no kernel, no
    batch, no permit; bounded by the request's deadline and each sub
    query's scan budget, charged as the executor charges them."""
    runner = tsdb.new_query_runner()
    out = {
        "whatIf": what_if.to_json(),
        "admission": admission.preview(tsdb, ts_query, what_if.deadline_ms),
        "cluster": None,
        "subQueries": [],
    }
    for sub in ts_query.queries:
        out["subQueries"].append(_explain_sub(tsdb, runner, ts_query, sub,
                                              what_if))
    return out


def _explain_sub(tsdb, runner, query, sub, what_if: WhatIf) -> dict:
    report: dict = {"index": sub.index, "metric": sub.metric or None,
                    "aggregator": sub.aggregator, "segments": []}
    if sub.percentiles or sub.show_histogram_buckets:
        report["note"] = ("histogram plans are one bucket-scatter "
                          "dispatch and are not routed through "
                          "plan_decision")
        return report
    try:
        budget = runner._new_budget(sub)
        segments = runner._plan_segments(query, sub)
    except QueryException as e:
        report["refused"] = _refusal_json(e)
        return report
    for seg in segments:
        try:
            report["segments"].append(_explain_segment(
                tsdb, runner, query, sub, seg, what_if, budget))
        except QueryException as e:
            # the budget or deadline refusal the executor would raise,
            # reported (the explain answer itself is a 200)
            report["segments"].append({
                "kind": seg.kind, "startMs": seg.start_ms,
                "endMs": seg.end_ms, "path": "refused",
                "refused": _refusal_json(e)})
            break
    return report


def _refusal_json(e: QueryException) -> dict:
    out = {"status": getattr(e, "status", 413), "message": str(e)}
    details = getattr(e, "details", None)
    if details:
        out["details"] = details
    return out


def _explain_segment(tsdb, runner, query, sub, seg, what_if: WhatIf,
                     budget) -> dict:
    # the executor's series resolution and grouping (_run_segment), read
    # only
    store = seg.lane
    if seg.kind == "raw":
        store = tsdb.store
        if sub.pre_aggregate and tsdb.rollup_store is not None:
            pre = tsdb.rollup_store.peek_lane("", sub.aggregator, True)
            store = pre if pre is not None else store
    series_tags = runner._resolve_series(sub, store)
    groups = runner._group(series_tags, sub)
    base = {"kind": seg.kind, "startMs": seg.start_ms, "endMs": seg.end_ms,
            "series": len(series_tags), "groups": len(groups)}
    if sub.downsample_spec is None:
        base.update(path="union",
                    note="union plans dispatch per integer mode and are "
                         "not routed through plan_decision")
        return base
    fix = tsdb.config.fix_duplicates
    kept = []
    for group_key in sorted(groups, key=lambda k: tuple(map(str, k))):
        members = groups[group_key]
        counts = [s.window_count(seg.start_ms, seg.end_ms, fix)
                  for s, _ in members]
        if sum(counts):
            budget.charge(sum(counts))
            kept.append((group_key, members, counts))
    if not kept:
        base.update(path="empty", note="no datapoints in range")
        return base
    budget.check_deadline()
    windows = runner._windows_for(sub, query)
    spec = runner._spec_for(sub, seg.ds_function)
    ds_fn = spec.downsample.function
    series_list = [s for _, members, _ in kept for s, _t in members]
    sketchable, hazard = runner._sketch_eligible(seg, ds_fn, windows, kept,
                                                 len(series_list), fix)
    ctx = route_context(tsdb, seg, spec, windows, kept, store, sketchable,
                        state_mb=what_if.state_mb, platform=what_if.platform)
    consults = _ExplainConsults(tsdb, ctx, what_if, seg, spec, windows,
                                store, series_list)
    pd = pdn.plan_decision(tsdb, ctx, consults)
    gbd = (pdn.streaming_budget_for(ctx.state_mb, ctx.s, ctx.wp, ctx.ds_fn,
                                    ctx.sketchable, ctx.n_chips)
           if pd.would_stream else
           pdn.grid_budget_for(ctx.state_mb, ctx.s, ctx.wp, ctx.seg_kind,
                               ctx.n_chips))
    base.update(
        path=pd.path, fingerprint=pd.fingerprint, provenance=pd.fp_fields,
        shape={"series": ctx.s, "pointsMax": ctx.n_max, "nPad": pd.n_pad,
               "windows": ctx.wp, "groups": ctx.groups, "gPad": ctx.g_pad,
               "totalPoints": ctx.total_points, "platform": ctx.platform,
               "meshDevices": ctx.n_chips if ctx.use_mesh else 0},
        budget={"kind": gbd.kind, "gridMb": gbd.grid_mb,
                "limitMb": gbd.state_mb, "over": gbd.over,
                "wouldStream": pd.would_stream},
        deviceCache={"warm": bool(pd.cached)},
        sketch={"sketchable": sketchable, "hazardFallback": hazard})
    note = consults.lane_note
    if note is not None:
        if note.get("decision") == "lane" and pd.lane_plan is None:
            note = dict(note, decision="fallback",
                        reason="striping_unavailable")
        base["rollup"] = note
    if pd.agg_note is not None:
        base["aggCache"] = pd.agg_note
    if pd.tiled_plan is not None:
        tp = pd.tiled_plan
        base["tiling"] = {
            "tiles": tp.n_tiles, "tileRows": tp.tile_rows,
            "stripes": tp.n_stripes, "stripeWindows": tp.stripe_w,
            "spillBytes": tp.spill_bytes,
            "predictedOverheadMs": round(cm.predict_tiled(
                tp.spill_bytes, tp.n_stripes) * 1e3, 3)}
    if pd.refusal is not None:
        base["refused"] = _refusal_json(pd.refusal.exception())
    base["costmodel"] = _costmodel(tsdb, ctx, pd)
    return base


def _costmodel(tsdb, ctx, pd) -> dict:
    """The dispatch priced by stage on the cuda table (ops/costmodel.py
    ``stage_breakdown``): the port's counterpart of the reference's
    per-axis reports; with ``tsd.explain.include_candidates`` each stage's
    milliseconds, else the total only."""
    stages = cm.stage_breakdown(ctx.s, pd.n_pad, ctx.wp, pd.g_dec,
                                ctx.ds_fn, ctx.has_rate)
    out = {"table": "cuda", "calibration": "default",
           "predictedMs": round(sum(stages.values()) * 1e3, 4)}
    if tsdb.config.get_bool("tsd.explain.include_candidates"):
        out["stagesMs"] = {stage: round(sec * 1e3, 4)
                           for stage, sec in stages.items()}
    return out
