"""Query planner/executor: TSQuery -> series selection -> kernels -> results.

Port of the plain dispatch of opentsdb_tpu/query/planner.py (OpenTSDB
TsdbQuery.java: UID resolution :490, tag-filter evaluation and group-by
discovery :675, GroupByAndAggregateCB :981-1114; SpanGroup.computeTags
:348), for both of its arms: a sub query with a downsample goes through
the grouped pipeline (ops.pipeline.run_group_pipeline, the reference's
_run_segment_grouped), one without through the union pipeline
(ops.pipeline.run_union_pipeline, the reference's _run_segment_union).
Every group-by bucket of a sub query travels in one [S, N] batch whose
groups are contiguous row runs; the batch is built on the host, moved to
the device once and reduced there.  The grouped arm first asks the device
series cache (storage/device_cache.py) for the batch, as the reference's
plan decision does (query/plandecision.py:366-378): on a hit the batch is
gathered on the device from columns already there, and nothing is built
or copied on the host.  The union arm builds one batch for its
all-integer groups and one for the rest, since a group's int mode (Java
long arithmetic) follows its own members.

A sub query first picks its data sources (``_plan_segments``, the
reference's TsdbQuery.transformDownSamplerToRollupQuery :1733 with
ROLLUP_USAGE and SplitRollupQuery): with written rollups enabled, a fixed
downsample whose interval a configured rollup interval divides reads that
interval's lane (``rollup``), an avg reads its sum and count lanes through
L2 (``rollup_avg``), and with ``tsd.rollups.split_query.enable`` the
lane serves up to its SLA boundary and the raw store the rest, the two
answers stitched per group.  On the raw store the grouped arm consults
the maintenance-built rollup lanes (storage/rollup.py) before the device
cache: a plan they cover takes its full windows from lane cells, its edge
windows from the raw points, then the grid tail.

A grouped plan over ``tsd.query.streaming.point_threshold`` points whose
downsample function streams takes, on a device-cache miss, the streamed
route (``_stream_grouped``, the reference's :1228): bounded chunks folded
on the device (ops/streaming.py, S1-S3), never the [S, N] batch.  A plan
whose device state is over ``tsd.query.streaming.state_mb`` (the
streaming state when it streams, else the materialized grid;
query/plandecision.py) takes the tiled route (``_run_tiled``, the
reference's :514-558): series tiles through the spill pool and a
window-striped replay (ops/tiling.py); a rollup-lane plan over it is
served striped.  A fixed-grid plan on the raw store first asks the
aggregate cache (storage/agg_cache.py, ``_run_agg_rewrite``, the
reference's :824-949): its cached blocks of downsample cells are
replayed, only the uncovered pieces are computed (K1 or K4 over exactly
their windows' points), and the grid tail (K2, then K3 or K5) runs on the
assembled grid.  A small
plan that the cost model prices as dispatch-bound takes the batched route
(``_run_batched``, the reference's :564-590): its batch goes to the
dispatch batcher (query/batcher.py), which stacks concurrent compatible
plans into one launch of each kernel.  A device-cache hit on a fixed grid
that spans less than 2^31 ms gathers its timestamps as int32 offsets from
the first window (``precompact_base``; G1's, K1's and K4's int32 forms).
A segment of at least ``tsd.query.mesh.min_series`` series on a TSDB
with a device mesh (``TSDB.query_mesh``) runs over it (the mesh arm, the
reference's :625-641): its rows split over the mesh's shards (a device
cache hit's batch re-laid over them), each shard's K1 or K4, K2 and T1
partials combined over the mesh (parallel/sharded.py); a streamed one
folds each shard's rows on its device.  One pure function,
query/plandecision.py ``plan_decision``, picks among these routes, fed by
``_ExecConsults``.  Each sub query's points are
charged to its scan budget (query/limits.py ``QueryBudget``, on the
request's deadline inside the daemon) before any batch or chunk is
built.

Every aggregator and downsample function of the registry is answered
(moments, order and rank functions, movingAverage<N>), with or without a
rate.  A histogram sub query (percentiles or show-histogram-buckets, the
reference's _run_histogram_sub, TsdbQuery.isHistogramQuery :806-812)
scatters every group's bucket entries onto one [rows, B] grid on the
device (H1) and picks the percentiles there (H2).

Inside a traced request a segment's series resolution is a ``scan``
span, each dispatch a ``pipeline`` span (its fingerprint and aggregate
cache decision as tags, its device wait as device time) and the host
extraction an ``extract`` span (obs/trace.py); the request's phase stamps
(obs/latattr.py) mark ``plan`` after the routing verdict, ``dispatch``
after the launches and ``device_wait`` after the results reach the host,
where the reference marks them (:508-509, :651, :696).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from opentsdb_tpu_torch.histogram.kernels import (accumulate_rows_deferred,
                                                  percentile_rows)
from opentsdb_tpu_torch.histogram.store import assemble_columnar
from opentsdb_tpu_torch.models.tsquery import TSQuery, TSSubQuery
from opentsdb_tpu_torch.obs import latattr
from opentsdb_tpu_torch.obs import trace as obs_trace
from opentsdb_tpu_torch.ops.downsample import (
    FixedWindows, EdgeWindows, AllWindow, precompact_base,
    window_timestamps)
from opentsdb_tpu_torch.ops.group_agg import group_offsets
from opentsdb_tpu_torch.ops.pipeline import (
    PipelineSpec, DownsampleStep, build_batch, build_batch_direct,
    check_ported, run_downsample_grid, run_grid_tail, run_group_pipeline,
    run_group_rollup_avg_pipeline, run_union_pipeline)
from opentsdb_tpu_torch.ops.streaming import (
    STREAMABLE_DS, is_sketch_ds, pad_pow2, stream_grid)
from opentsdb_tpu_torch.ops.tiling import (
    LANE_FOLDABLE, count_refusal, finish_lane_fold, lane_mode,
    new_lane_fold, plan_tiled, run_lane_fold, run_tiled)
from opentsdb_tpu_torch.parallel.sharded import (
    shard_bounds, shard_rows_device, sharded_grid_tail,
    sharded_query_pipeline)
from opentsdb_tpu_torch.query import plandecision as pdn
from opentsdb_tpu_torch.query.limits import (QueryBudget, active_deadline,
                                             grid_budget)
from opentsdb_tpu_torch.rollup.config import (NoSuchRollupForInterval,
                                              RollupQuery)
from opentsdb_tpu_torch.storage.memstore import Series
from opentsdb_tpu_torch.uid import NoSuchUniqueName
from opentsdb_tpu_torch.utils import datetime_util as DT

_NO_MATCH = object()  # sentinel: a literal filter can never match

# Downsample function -> (written rollup lane, function over its cells):
# counts re-reduce by sum, sums and extremes by themselves (a rollup
# table holds one aggregator's cells per lane, RollupUtils qualifiers).
_ROLLUP_LANES = {
    "sum": ("sum", "sum"),
    "zimsum": ("sum", "zimsum"),
    "count": ("count", "sum"),
    "min": ("min", "min"),
    "mimmin": ("min", "mimmin"),
    "max": ("max", "max"),
    "mimmax": ("max", "mimmax"),
}

# Host-clock phases of one dispatch; exec_stats carries each as
# "<phase>Ms" summed over the run's dispatches.  "gather" is the grouped
# arm's device-cache consult: validation and, on a hit, the gather (a cold
# entry built inline lands there too).  "stream" is the streamed route's
# scan: chunks packed on the host, copied and folded, overlapped (its
# split: streamPackMs on the host clock, streamH2dMs and streamFoldMs
# from CUDA events).
PHASES = ("build", "gather", "h2d", "stream", "kernels", "extract")


def compute_tags(tag_maps: list[dict]) -> tuple[dict, list]:
    """SpanGroup.computeTags (:348): keys holding one distinct value across
    all maps stay tags, conflicting keys become aggregate tags."""
    tag_set: dict[str, str] = {}
    discards: set[str] = set()
    for tags in tag_maps:
        for k, v in tags.items():
            if k in discards:
                continue
            if k not in tag_set:
                tag_set[k] = v
            elif tag_set[k] != v:
                discards.add(k)
                tag_set.pop(k)
    return tag_set, sorted(discards)


@dataclass
class Segment:
    """One data source over a slice of a sub query's range (the
    reference's Segment, SplitRollupQuery.java reduced to data): a rollup
    lane serves [start, boundary) within its SLA, the raw store the
    blackout tail.  kind: "raw", "rollup" or "rollup_avg"."""
    kind: str
    start_ms: int
    end_ms: int
    lane: object = None        # MemStore: the rollup lane (sum lane of avg)
    count_lane: object = None  # MemStore: the count lane of rollup_avg
    ds_function: str | None = None   # the function over the lane's cells
    rollup_query: RollupQuery | None = None


@dataclass
class QueryResult:
    """One output object of /api/query (HttpJsonSerializer.java:742-815)."""
    metric: str
    tags: dict[str, str]
    aggregate_tags: list[str]
    tsuids: list[str]
    dps: list[tuple[int, object]]  # (ts_ms, value) value int or float or NaN
    annotations: list = field(default_factory=list)
    global_annotations: list = field(default_factory=list)
    index: int = 0

    def to_json(self, ms_resolution: bool = False, show_tsuids: bool = False,
                fill_policy: str = "none", show_query: bool = False,
                sub_query: TSSubQuery | None = None,
                no_annotations: bool = False,
                global_annotations: bool = False) -> dict:
        dps = {}
        for ts_ms, value in self.dps:
            key = str(ts_ms if ms_resolution else ts_ms // 1000)
            if isinstance(value, float) and value != value:  # NaN
                dps[key] = None if fill_policy == "null" else float("nan")
            else:
                dps[key] = value
        out = {
            "metric": self.metric,
            "tags": self.tags,
            "aggregateTags": self.aggregate_tags,
        }
        if show_query and sub_query is not None:
            out["query"] = sub_query.to_json()
        if show_tsuids:
            out["tsuids"] = sorted(self.tsuids)
        if not no_annotations and self.annotations:
            out["annotations"] = [a.to_json() for a in self.annotations]
        if global_annotations and self.global_annotations:
            out["globalAnnotations"] = [a.to_json()
                                        for a in self.global_annotations]
        out["dps"] = dps
        return out


class _PhaseClock:
    """Host-clock phase split of one dispatch.  On a CUDA device each
    boundary synchronises, so a phase holds its own device work.  Every
    phase of PHASES is reported, 0 where the dispatch has none."""

    def __init__(self, device: torch.device, stats: dict):
        self._cuda = device.type == "cuda"
        self._stats = stats
        for phase in PHASES:
            stats.setdefault(phase + "Ms", 0.0)
        self._t = time.perf_counter()

    def mark(self, phase: str) -> None:
        if self._cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        key = phase + "Ms"
        self._stats[key] = self._stats.get(key, 0.0) + (now - self._t) * 1e3
        self._t = now


class QueryRunner:
    """Executes TSQueries against a TSDB on the TSDB's device."""

    def __init__(self, tsdb):
        self.tsdb = tsdb
        # numeric execution telemetry of the last run(): points and series
        # scanned, and the per-phase host milliseconds of PHASES
        self.exec_stats: dict[str, float] = {}
        # the routing verdict (plandecision.PlanDecision) of each grouped
        # segment of the last run(), in order
        self.decisions: list = []

    def _bump(self, key: str, value: float) -> None:
        self.exec_stats[key] = self.exec_stats.get(key, 0.0) + value

    # -- series selection ------------------------------------------------

    def _resolve_series(self, sub: TSSubQuery,
                        store) -> list[tuple[Series, dict]]:
        """All series of `store` matching the sub query, with resolved tag
        maps."""
        tsdb = self.tsdb
        if sub.tsuids:
            wanted = {t.upper() for t in sub.tsuids}
            out = []
            for series in store.all_series():
                if tsdb.tsuid(series.key) in wanted:
                    out.append((series, tsdb.resolve_key_tags(series.key)))
            return out

        metric_uid = tsdb.metrics.get_id(sub.metric)
        candidates = store.series_for_metric(metric_uid)
        uid_constraints = self._literal_uid_constraints(sub.filters)
        if uid_constraints is _NO_MATCH:
            return []
        out = []
        filter_tagks = {f.tagk for f in sub.filters}
        for series in candidates:
            if uid_constraints:
                key_tags = dict(series.key.tags)
                if any(key_tags.get(ku) not in vuids
                       for ku, vuids in uid_constraints):
                    continue
            tags = tsdb.resolve_key_tags(series.key)
            if sub.explicit_tags and set(tags) != filter_tagks:
                continue
            if all(f.match(tags) for f in sub.filters):
                out.append((series, tags))
        return out

    def _literal_uid_constraints(self, filters):
        """Compile literal filters to (tagk_uid, tagv_uid_set) pre-filters
        (TsdbQuery.createAndSetFilter :1683).  Returns _NO_MATCH when a
        constraint cannot match anything."""
        tsdb = self.tsdb
        out = []
        for f in filters:
            values = f.literal_values()
            if values is None:
                continue
            try:
                ku = tsdb.tag_names.get_id(f.tagk)
            except NoSuchUniqueName:
                return _NO_MATCH
            vuids = set()
            for v in values:
                try:
                    vuids.add(tsdb.tag_values.get_id(v))
                except NoSuchUniqueName:
                    pass
            if not vuids:
                return _NO_MATCH
            out.append((ku, vuids))
        return out

    @staticmethod
    def _group(series_tags: list[tuple[Series, dict]], sub: TSSubQuery):
        """Group-by bucketing (TsdbQuery.GroupByAndAggregateCB :981)."""
        group_tagks = sub.group_by_tags()
        if sub.aggregator == "none":
            return {("__series__", i): [st]
                    for i, st in enumerate(series_tags)}
        if not group_tagks:
            return {(): series_tags} if series_tags else {}
        groups: dict[tuple, list] = {}
        for series, tags in series_tags:
            key_vals = tuple(tags.get(k) for k in group_tagks)
            if any(v is None for v in key_vals):
                continue  # series lacks a group-by tag -> excluded
            groups.setdefault(key_vals, []).append((series, tags))
        return groups

    # -- execution -------------------------------------------------------

    @staticmethod
    def _windows_for(sub: TSSubQuery, query: TSQuery):
        spec = sub.downsample_spec
        if spec.run_all:
            return AllWindow(query.start_time, query.end_time)
        if spec.use_calendar:
            edges = DT.calendar_window_edges(
                query.start_time, query.end_time, spec.calendar_interval,
                spec.calendar_unit, spec.timezone)
            return EdgeWindows(tuple(edges))
        return FixedWindows.for_range(query.start_time, query.end_time,
                                      spec.interval_ms)

    # -- rollup source selection (TsdbQuery.transformDownSamplerToRollupQuery
    #    :1733, ROLLUP_USAGE :197, SplitRollupQuery) -----------------------

    def _rollup_candidates(self, sub: TSSubQuery):
        """Rollup intervals able to serve this sub query, best first, and
        the usage mode."""
        tsdb = self.tsdb
        ds = sub.downsample_spec
        usage = (sub.rollup_usage or "ROLLUP_NOFALLBACK").upper()
        if (tsdb.rollup_store is None or ds is None or ds.run_all
                or ds.use_calendar or ds.interval_ms <= 0
                or usage == "ROLLUP_RAW" or sub.tsuids):
            return [], usage
        if ds.function != "avg" and ds.function not in _ROLLUP_LANES:
            return [], usage
        try:
            matches = tsdb.rollup_config.get_best_matches_ms(ds.interval_ms)
        except (NoSuchRollupForInterval, ValueError):
            return [], usage
        matches = [m for m in matches if not m.default_interval]
        if usage == "ROLLUP_NOFALLBACK":
            matches = matches[:1]
        return matches, usage

    def _segment_for_interval(self, sub: TSSubQuery, interval,
                              start_ms: int, end_ms: int) -> Segment | None:
        """A rollup Segment over [start, end] if the lanes hold data of
        the metric."""
        tsdb = self.tsdb
        ds = sub.downsample_spec
        try:
            metric_uid = tsdb.metrics.get_id(sub.metric)
        except NoSuchUniqueName:
            return None
        pre = sub.pre_aggregate
        lanes = tsdb.rollup_store
        if ds.function == "avg":
            sum_lane = lanes.peek_lane(interval.interval, "sum", pre)
            cnt_lane = lanes.peek_lane(interval.interval, "count", pre)
            if (sum_lane is None or cnt_lane is None
                    or not sum_lane.series_for_metric(metric_uid)
                    or not cnt_lane.series_for_metric(metric_uid)):
                return None
            rq = RollupQuery(interval, "avg", ds.interval_ms, sub.aggregator)
            return Segment("rollup_avg", start_ms, end_ms, lane=sum_lane,
                           count_lane=cnt_lane, ds_function="sum",
                           rollup_query=rq)
        lane_agg, ds_fn = _ROLLUP_LANES[ds.function]
        lane = lanes.peek_lane(interval.interval, lane_agg, pre)
        if lane is None or not lane.series_for_metric(metric_uid):
            return None
        rq = RollupQuery(interval, ds.function, ds.interval_ms,
                         sub.aggregator)
        return Segment("rollup", start_ms, end_ms, lane=lane,
                       ds_function=ds_fn, rollup_query=rq)

    def _plan_segments(self, query: TSQuery,
                       sub: TSSubQuery) -> list[Segment]:
        """The data sources of a sub query: the raw store, a rollup lane,
        or with tsd.rollups.split_query.enable a rollup lane up to its SLA
        boundary and the raw store after it.  ROLLUP_NOFALLBACK and
        ROLLUP_FALLBACK over empty lanes answer nothing, never a silent
        raw scan (ROLLUP_USAGE :197-201)."""
        start_ms, end_ms = query.start_time, query.end_time
        raw = Segment("raw", start_ms, end_ms)
        candidates, usage = self._rollup_candidates(sub)
        chosen = None
        for interval in candidates:
            chosen = self._segment_for_interval(sub, interval, start_ms,
                                                end_ms)
            if chosen is not None:
                break
        if chosen is None:
            if not candidates or usage == "ROLLUP_FALLBACK_RAW":
                return [raw]
            return []
        rq = chosen.rollup_query
        if (self.tsdb.config.get_bool("tsd.rollups.split_query.enable")
                and rq.rollup_interval.delay_sla_ms > 0):
            boundary = rq.last_guaranteed_ms(DT.current_time_millis())
            # aligned down to the downsample grid: no window spans sources
            boundary -= boundary % sub.downsample_spec.interval_ms
            if boundary <= start_ms:
                return [raw]            # the whole range is blacked out
            if boundary <= end_ms:
                chosen.end_ms = boundary - 1
                return [chosen, Segment("raw", boundary, end_ms)]
        return [chosen]

    def _assemble_result(self, query: TSQuery, sub: TSSubQuery, members,
                         dps, global_notes) -> QueryResult:
        tsdb = self.tsdb
        group_tags, agg_tags = compute_tags([tags for _, tags in members])
        tsuids = [tsdb.tsuid(s.key) for s, _ in members]
        annotations = []
        if not query.no_annotations:
            for t in tsuids:
                annotations.extend(tsdb.store.get_annotations(
                    t, query.start_time, query.end_time))
        return QueryResult(
            metric=sub.metric or (
                tsdb.metrics.get_name(members[0][0].key.metric)
                if members else ""),
            tags=group_tags,
            aggregate_tags=agg_tags,
            tsuids=tsuids,
            dps=dps,
            annotations=annotations,
            global_annotations=global_notes,
            index=sub.index,
        )

    def _spec_for(self, sub: TSSubQuery,
                  ds_function: str | None = None) -> PipelineSpec:
        """The sub query's pipeline; `ds_function` replaces its downsample
        function (a rollup lane's function over its cells)."""
        ds = sub.downsample_spec
        return PipelineSpec(
            aggregator=sub.aggregator,
            downsample=None if ds is None else DownsampleStep(
                ds_function or ds.function, ds.fill_policy, ds.fill_value),
            rate=sub.rate_options if sub.rate else None)

    def _run_grouped(self, query: TSQuery, sub: TSSubQuery, seg: Segment,
                     groups, global_notes: list, store,
                     budget: QueryBudget) -> dict[tuple, QueryResult]:
        """All group-by buckets of a segment through the grouped pipeline,
        by the route of one routing verdict (query/plandecision.py
        ``plan_decision``, the reference's :488-506): the rollup lanes,
        tiled or refused over the device budget, batched (a dispatch-bound
        plan through the dispatch batcher), the device cache (a hit
        gathers the batch on the device), streamed past
        ``tsd.query.streaming.point_threshold`` points, the rollup-avg
        arm, or the [S, N] batch built on the host."""
        tsdb = self.tsdb
        start_ms, end_ms = seg.start_ms, seg.end_ms
        fix = tsdb.config.fix_duplicates
        clock = _PhaseClock(tsdb.device, self.exec_stats)
        # counts first (no copy): the budget and the route must not pull
        # the range into host memory
        kept = []  # (group_key, members, per-member point counts)
        for group_key in sorted(groups, key=lambda k: tuple(map(str, k))):
            members = groups[group_key]
            counts = [s.window_count(start_ms, end_ms, fix)
                      for s, _ in members]
            # no datapoints in range -> no SpanGroup at all
            # (TsdbQuery.findSpans -> empty group map)
            if sum(counts):
                budget.charge(sum(counts))
                kept.append((group_key, members, counts))
        if not kept:
            return {}
        budget.check_deadline()
        points = sum(sum(c) for _, _, c in kept)
        n_max = max(max(c) for _, _, c in kept)
        series_list = [s for _, members, _ in kept for s, _t in members]
        gid = np.concatenate([np.full(len(members), i, np.int64)
                              for i, (_, members, _) in enumerate(kept)])
        self._bump("pointsScanned", float(points))
        self._bump("seriesScanned", float(len(series_list)))

        dev = tsdb.device
        spec = self._spec_for(sub, seg.ds_function)
        ds_fn = spec.downsample.function
        # one span over the route and the dispatch; begin/end, not a
        # with-block: an exception leaves it open until the trace ends
        psp = obs_trace.begin("pipeline", aggregator=sub.aggregator,
                              downsample=ds_fn)
        windows = self._windows_for(sub, query)
        sketchable, hazard = self._sketch_eligible(seg, ds_fn, windows, kept,
                                                   len(series_list), fix)
        if hazard:
            self.exec_stats["sketchHazardExact"] = 1.0
        clock.mark("build")

        ctx = route_context(tsdb, seg, spec, windows, kept, store,
                            sketchable)
        mesh = tsdb.query_mesh()
        use_mesh = ctx.use_mesh
        pd = pdn.plan_decision(tsdb, ctx, _ExecConsults(
            self, ctx, spec, seg, windows, store, series_list, clock))
        self.decisions.append(pd)
        if pd.agg_note is not None:
            obs_trace.annotate(psp, agg_cache=pd.agg_note)
        obs_trace.annotate(psp, fingerprint=pd.fingerprint)
        # the scan, the batch shaping and the verdict are "plan"; the
        # first segment's fingerprint keys the request's profile
        latattr.mark("plan")
        latattr.set_fingerprint(pd.fingerprint)
        if pd.path == "refused":
            self.exec_stats["tiledRefused"] = 1.0
            raise pd.refusal.exception()
        if pd.path == "rollup_lane":
            self.exec_stats["rollupLane"] = 1.0
            if pd.lane_plan.striped:
                self.exec_stats["rollupLaneStriped"] = 1.0
            out_ts, out_val, out_mask = self._run_lane_serve(
                spec, seg, pd.lane_plan, series_list, gid, len(kept),
                windows, budget, clock)
        elif pd.path == "tiled":
            out_ts, out_val, out_mask = self._run_tiled(
                spec, seg, series_list, gid, len(kept), windows, sketchable,
                pd.tiled_plan, budget, store, clock)
        elif pd.path == "agg_rewrite":
            out_ts, out_val, out_mask = self._run_agg_rewrite(
                spec, pd.agg_plan, series_list, gid, len(kept), windows,
                budget, clock)
        elif pd.path == "batched":
            out_ts, out_val, out_mask = self._run_batched(
                spec, seg, series_list, gid, len(kept), windows, pd.n_pad,
                budget, clock)
        elif pd.path == "rollup_avg":
            ts, val, mask, _ = build_batch_direct(series_list, start_ms,
                                                  end_ms, fix)
            empty = (np.empty(0, np.int64), np.empty(0, np.float64),
                     np.empty(0, np.int64), np.empty(0, bool))
            count_rows = []
            for s in series_list:
                cs = seg.count_lane.get_series(s.key)
                count_rows.append(empty if cs is None
                                  else cs.window(start_ms, end_ms, fix))
            tc, vc, mc, _ = build_batch(count_rows)
            clock.mark("build")
            batches = [torch.from_numpy(x).to(dev)
                       for x in (ts, val, mask, tc, vc, mc)]
            edges = windows.window_edges(dev)
            clock.mark("h2d")
            out_ts, out_val, out_mask = run_group_rollup_avg_pipeline(
                spec, *batches, gid, len(kept), edges)
            clock.mark("kernels")
        elif pd.path == "streamed":
            if use_mesh:
                self.exec_stats["meshDevices"] = float(mesh.size)
            out_ts, out_val, out_mask = self._stream_grouped(
                spec, seg, series_list, n_max, gid, len(kept), windows,
                sketchable, clock, mesh if use_mesh else None)
        else:
            # resident or mesh: the device cache's batch, or the host build
            ts_base = None
            if pd.cached is not None:
                self.exec_stats["deviceCacheHit"] = 1.0
                if pd.cached[0].dtype == torch.int32:
                    # gathered as int32 offsets: only the [W+1] edges are
                    # re-based, inside the downsample
                    ts_base = ctx.ts_base
                    self.exec_stats["tsCompacted"] = 1.0
            on_mesh = pd.path == "mesh"
            batch = self._device_batch(series_list, start_ms, end_ms,
                                       pd.cached, clock,
                                       mesh if on_mesh else None, gid)
            edges = windows.window_edges(mesh.owner if on_mesh else dev)
            clock.mark("h2d")
            if on_mesh:
                # the reference's :625-641: the answer lands on the owner
                self.exec_stats["meshDevices"] = float(mesh.size)
                out_ts, out_val, out_mask = sharded_query_pipeline(
                    mesh, spec, len(kept), batch, edges, ts_base)
            else:
                out_ts, out_val, out_mask = run_group_pipeline(
                    spec, *batch, gid, len(kept), edges, ts_base)
            clock.mark("kernels")
        latattr.mark("dispatch")
        obs_trace.device_wait(psp, (out_ts, out_val, out_mask))
        obs_trace.end(psp)

        with obs_trace.stage("extract"):
            out_ts, out_val, out_mask = (
                x if isinstance(x, np.ndarray) else x.cpu().numpy()
                for x in (out_ts, out_val, out_mask))
            latattr.mark("device_wait")
            results: dict[tuple, QueryResult] = {}
            for i, (group_key, members, _) in enumerate(kept):
                dps = extract_dps(out_ts, out_val[i], out_mask[i], start_ms,
                                  end_ms, False,
                                  keep_nans=sub.fill_policy != "none")
                results[tuple(map(str, group_key))] = self._assemble_result(
                    query, sub, members, dps, global_notes)
        clock.mark("extract")
        return results

    def _device_batch(self, series_list, lo_ms: int, hi_ms: int, cached,
                      clock: "_PhaseClock", mesh=None, gid=None):
        """The (ts, val, mask) batch of [lo_ms, hi_ms] on the device: the
        device cache's gather when it answered (`cached`), else the host
        build, uploaded; with a `mesh`, its rows split over the mesh's
        shards (RowShards, a hit's batch re-laid: views on a shared
        device) and each block uploaded to its shard's device."""
        if cached is None:
            ts, val, mask, _ = build_batch_direct(
                series_list, lo_ms, hi_ms, self.tsdb.config.fix_duplicates)
            clock.mark("build")
            cached = tuple(torch.from_numpy(x) for x in (ts, val, mask))
            if mesh is None:
                return tuple(x.to(self.tsdb.device) for x in cached)
        if mesh is None:
            return cached
        return shard_rows_device(mesh, *cached, gid)

    def _run_agg_rewrite(self, spec: PipelineSpec, plan, series_list, gid,
                         num_groups: int, windows: FixedWindows, budget,
                         clock: "_PhaseClock"):
        """A partial-aggregate rewrite (storage/agg_cache.py, the
        reference's :824-949).  Cached blocks replay their [S, B] grids
        (narrowed to this query's rows when the block holds others: a
        device-tier block by index_select on the card); each uncovered
        piece runs K1 or K4 over exactly its windows' points, from the
        device cache's batch (int64, no inline build) or the host build,
        the same launch a cold run makes, so a warm answer is bit for bit
        a cold one; a freshly computed full block is stored back.  The
        assembled [S, W] grid then runs the grid tail (K2, then K3 or K5)."""
        tsdb = self.tsdb
        dev = tsdb.device
        s = len(series_list)
        identity = np.arange(s, dtype=np.int64)
        vs, ms = [], []
        for piece in plan.pieces:
            if piece.cached is not None:
                v, m = piece.cached
                rows = piece.rows
                if v.shape[0] != s or not np.array_equal(rows, identity):
                    if piece.tier == "agg_device":
                        r = torch.from_numpy(rows).to(v.device)
                        v, m = v.index_select(0, r), m.index_select(0, r)
                    else:
                        v, m = v[rows], m[rows]
                if piece.tier == "agg_host":
                    v = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    m = torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                vs.append(v)
                ms.append(m)
                self._bump("aggCacheHitWindows", float(piece.count))
                continue
            budget.check_deadline()
            cached = None
            if tsdb.device_cache is not None:
                cached = tsdb.device_cache.batch_for(
                    plan.store, plan.metric, series_list, piece.fetch_lo,
                    piece.fetch_hi, build=False)
                clock.mark("gather")
            batch = self._device_batch(series_list, piece.fetch_lo,
                                       piece.fetch_hi, cached, clock)
            edges = FixedWindows(plan.interval_ms, piece.first_ms,
                                 piece.count).window_edges(dev)
            _wts, v, m = run_downsample_grid(spec.downsample, *batch, edges)
            self._bump("aggCacheComputedWindows", float(piece.count))
            if piece.block is not None:
                tsdb.agg_cache.store_block(plan, piece, series_list,
                                           v.cpu().numpy(), m.cpu().numpy())
            vs.append(v)
            ms.append(m)
        wts = window_timestamps(windows.window_edges(dev))
        out = run_grid_tail(spec, wts, torch.cat(vs, dim=1),
                            torch.cat(ms, dim=1), gid, num_groups)
        clock.mark("kernels")
        if plan.cached_windows:
            self.exec_stats["aggCacheHit"] = 1.0
        return out

    def _run_batched(self, spec: PipelineSpec, seg: Segment, series_list,
                     gid, num_groups: int, windows, n_pad: int, budget,
                     clock: "_PhaseClock"):
        """The batched route (the reference's :564-590): the [S, N] batch
        built on the host at the padded width pad_pow2(N) (the batcher's
        bucket key holds the operand shape, so unpadded panels would
        rarely share a bucket), then handed to the dispatch batcher under
        the request's deadline, which stacks it with concurrent
        compatible plans into one launch of each kernel."""
        tsdb = self.tsdb
        budget.check_deadline()
        ts, val, mask, _ = build_batch_direct(
            series_list, seg.start_ms, seg.end_ms,
            tsdb.config.fix_duplicates, min_width=n_pad)
        edges = windows.window_edges(torch.device("cpu")).numpy()
        clock.mark("build")
        out, info = tsdb.dispatch_batcher.submit(
            spec, ts, val, mask, gid, num_groups, edges,
            deadline=active_deadline())
        clock.mark("kernels")
        self.exec_stats["batched"] = 1.0
        if info["stacked"]:
            self.exec_stats["batchedStacked"] = 1.0
            self._bump("batchedQ", float(info["q"]))
        return out

    def _sketch_eligible(self, seg: Segment, ds_fn: str, windows, kept,
                         n_rows: int, fix: bool) -> tuple[bool, bool]:
        """(sketchable, hazard) for one grouped segment (the reference's
        planner.py:955-995).  A cell drifts about merges / (2K) of its
        population in rank; when the densest cell would take more chunk
        merges than ``tsd.query.streaming.sketch_max_merges`` (a window
        much wider than a chunk, "0all" over a long range) the plan takes
        the exact path.  The estimate is exact under skew: per series, the
        windows of the chunk boundaries (every n_chunk-th point) are
        counted, and a cell's merges are its window's boundary count + 1."""
        tsdb = self.tsdb
        sketchable = (is_sketch_ds(ds_fn) and tsdb.config.get_bool(
            "tsd.query.streaming.sketch_percentiles"))
        if not sketchable:
            return False, False
        max_merges = tsdb.config.get_int(
            "tsd.query.streaming.sketch_max_merges")
        if max_merges <= 0:
            return True, False
        chunk_points = max(tsdb.config.get_int(
            "tsd.query.streaming.chunk_points"), 1)
        n_chunk = pad_pow2(max(1024, chunk_points // max(n_rows, 1)))
        worst = 0
        for _, members, counts in kept:
            for (s, _t), c in zip(members, counts):
                if c <= n_chunk:
                    continue        # a single chunk: no merge at all
                tsb = s.window_stride_timestamps(
                    seg.start_ms, seg.end_ms, n_chunk, fix)
                wids = self._host_window_ids(windows, tsb)
                if len(wids):
                    worst = max(worst, int(np.max(
                        np.unique(wids, return_counts=True)[1])))
        if worst + 1 > max_merges:
            return False, True
        return True, False

    @staticmethod
    def _host_window_ids(windows, tsb) -> np.ndarray:
        """The window of each timestamp, on the host, for every plan."""
        if isinstance(windows, FixedWindows):
            return (np.asarray(tsb, np.int64)
                    - windows.first_window_ms) // windows.interval_ms
        if isinstance(windows, EdgeWindows):
            return np.searchsorted(np.asarray(windows.edges, np.int64),
                                   tsb, "right") - 1
        return np.zeros(len(tsb), np.int64)    # AllWindow: one cell

    def _stream_grouped(self, spec: PipelineSpec, seg: Segment, series_list,
                        max_len: int, gid, num_groups: int, windows,
                        sketch: bool, clock: "_PhaseClock", mesh=None):
        """The streamed route (the reference's ``_stream_grouped``,
        :1228): the chunk loop of ops.streaming.stream_grid (bounded
        [S, n_chunk] chunks copied out of the store into pinned buffers,
        copied to the device while the previous chunk folds, folded by S2
        and S1 and finished by S3), then the grid tail.  The [S, N] batch
        is never built; the host holds two chunks.  Like the reference's
        scan over live rows, the pass has no snapshot isolation: a write
        landing mid-query may or may not be seen (SaltScanner.java:269).
        With `mesh` (the reference's :1254-1310) each row shard's block of
        a chunk folds on its shard's device and the tail is the mesh's
        (parallel/sharded.py ShardedStreamAccumulator)."""
        grid, _ = self._stream_grid(spec, seg, series_list, windows, sketch,
                                    max_len, mesh)
        clock.mark("stream")
        if mesh is not None:
            out = sharded_grid_tail(mesh, spec, num_groups, grid, gid,
                                    shard_bounds(mesh, len(series_list)))
        else:
            out = run_grid_tail(spec, *grid, gid, num_groups)
        clock.mark("kernels")
        return out

    def _stream_grid(self, spec: PipelineSpec, seg: Segment, series_list,
                     windows, sketch: bool, max_len: int | None = None,
                     mesh=None):
        """The finished [S, W] grid of `series_list` through the chunk
        loop (each row shard's, with `mesh`), its chunk count and split
        added to exec_stats."""
        tsdb = self.tsdb
        grid, info = stream_grid(
            series_list, seg.start_ms, seg.end_ms,
            tsdb.config.fix_duplicates, windows, tsdb.device, spec.downsample,
            sketch, tsdb.config.get_int("tsd.query.streaming.chunk_points"),
            max_len, mesh)
        self._bump("streamedChunks", float(info["chunks"]))
        self._bump("streamHostBytes", float(info["hostBytes"]))
        self._bump("streamPackMs", info["packMs"])
        self._bump("streamH2dMs", info["h2dMs"])
        self._bump("streamFoldMs", info["foldMs"])
        return grid, info["chunks"]

    def _run_tiled(self, spec: PipelineSpec, seg: Segment, series_list, gid,
                   num_groups: int, windows, sketch: bool, plan, budget,
                   store, clock: "_PhaseClock"):
        """An over-budget plan through series tiles, the spill pool and the
        window-striped replay (ops/tiling.run_tiled, the reference's tiled
        arm, :514-558).  A tile's grid is the device cache's when it holds
        the tile's rows (G1, then K1 or K4), else the chunk loop's (the
        reference's ``_stream_tile``, tiling.py:292)."""
        tsdb = self.tsdb
        dev = tsdb.device
        step = spec.downsample
        cache = tsdb.device_cache if store is tsdb.store else None

        def tile_grid(lo: int, hi: int):
            tile = series_list[lo:hi]
            if cache is not None:
                batch = cache.batch_for(store, tile[0].key.metric, tile,
                                        seg.start_ms, seg.end_ms,
                                        build=False)
                if batch is not None:
                    self._bump("tiledCacheHits", 1.0)
                    return run_downsample_grid(
                        step, *batch, windows.window_edges(dev)), 1
            return self._stream_grid(spec, seg, tile, windows, sketch)

        out, stats = run_tiled(tsdb, spec, len(series_list), gid, num_groups,
                               windows.count, plan, budget, tile_grid)
        clock.mark("stream")
        self.exec_stats["tiledExecution"] = 1.0
        self._bump("tiledTiles", float(stats["tiles"]))
        self._bump("tiledStripes", float(stats["stripes"]))
        self._bump("tiledStripesPlanned", float(stats["stripesPlanned"]))
        self._bump("tiledPredictedMs", stats["predictedMs"])
        self._bump("spillBytes", float(stats["spillBytes"]))
        for key in ("tileGridMs", "tileContribMs", "spillWriteMs",
                    "spillReadMs", "replayMs"):
            self._bump(key, stats[key])
        return out

    def _lane_grid(self, spec: PipelineSpec, seg: Segment, plan,
                   series_list, windows: FixedWindows):
        """The lane-served [S, W] downsample grid on the host: the full
        interior windows from the lane cells (RollupLanes.derive_grid),
        the two or fewer edge windows, which hold part of their range,
        from the raw points through run_downsample_grid, as the exact
        path computes them."""
        tsdb = self.tsdb
        dev = tsdb.device
        fix = tsdb.config.fix_duplicates
        step = spec.downsample
        interval = windows.interval_ms
        first = windows.first_window_ms
        w = windows.count
        s = len(series_list)
        iv, im = tsdb.rollup_lanes.derive_grid(plan, step.function,
                                               step.fill_policy,
                                               step.fill_value)
        v = np.empty((s, w), np.float64)
        m = np.empty((s, w), bool)
        v[:, plan.wf_lo:plan.wf_hi + 1] = iv
        m[:, plan.wf_lo:plan.wf_hi + 1] = im
        edge_windows = []
        if plan.wf_lo > 0:
            edge_windows.append((0, seg.start_ms,
                                 min(first + interval - 1, seg.end_ms)))
        if plan.wf_hi < w - 1:
            edge_windows.append((w - 1, first + (w - 1) * interval,
                                 seg.end_ms))
        for w_i, lo_ms, hi_ms in edge_windows:
            batch = build_batch_direct(series_list, lo_ms, hi_ms, fix)[:3]
            edge = FixedWindows(interval, first + w_i * interval,
                                1).window_edges(dev)
            _, ev, em = run_downsample_grid(
                step, *(torch.from_numpy(x).to(dev) for x in batch), edge)
            v[:, w_i] = ev[:, 0].cpu().numpy()
            m[:, w_i] = em[:, 0].cpu().numpy()
        return v, m

    def _run_lane_serve(self, spec: PipelineSpec, seg: Segment, plan,
                        series_list, gid, num_groups: int,
                        windows: FixedWindows, budget, clock: "_PhaseClock"):
        """Serve a lane-derivable plan (the reference's _run_lane_serve,
        :996): the [S, W] grid from the lanes (``_lane_grid``), then the
        grid tail on the device.  A striped plan's grid never goes to the
        device whole; it takes one of two of the reference's modes
        (:1173-1226):

        * device fold: a foldable aggregator (tiling.LANE_FOLDABLE):
          tiles of ``fold_rows`` rows go through K2 and T1 into [G, W]
          partial moments held on the device;
        * pool replay: dev and the order and rank aggregators take the
          spill pool's window-striped replay (tiling.run_tiled) over the
          grid's row tiles.

        The reference's third mode, a numpy reduceat fold on the host for
        a dense rate-free grid (:1127-1172), is left out: the device fold
        gives the same answers and is the faster on the card."""
        tsdb = self.tsdb
        dev = tsdb.device
        wts = windows.window_edges(dev)[:-1]
        budget.check_deadline()
        v, m = self._lane_grid(spec, seg, plan, series_list, windows)
        clock.mark("build")
        if not plan.striped:
            d_v = torch.from_numpy(v).to(dev)
            d_m = torch.from_numpy(m).to(dev)
            clock.mark("h2d")
            out = run_grid_tail(spec, wts, d_v, d_m, gid, num_groups)
            clock.mark("kernels")
            return out
        agg = spec.aggregator
        s, w = v.shape
        gid = np.asarray(gid, np.int64)
        # the device fold holds a tile's grid and the [G, W] partials: its
        # tiles are what the budget leaves after the partials
        budget_bytes = tsdb.config.get_int(
            "tsd.query.streaming.state_mb") * 2 ** 20
        g_pad = pad_pow2(num_groups)
        wp = pad_pow2(w)
        fold_rows = (budget_bytes - 3 * g_pad * wp * 8) // (wp * 19)
        if agg in LANE_FOLDABLE and fold_rows >= 1:
            acc = new_lane_fold(num_groups, w, lane_mode(agg), dev)
            fold_rows = min(int(fold_rows), s)
            for t_lo in range(0, s, fold_rows):
                t_hi = min(t_lo + fold_rows, s)
                budget.check_deadline()
                run_lane_fold(spec, acc, wts,
                              torch.from_numpy(v[t_lo:t_hi]).to(dev),
                              torch.from_numpy(m[t_lo:t_hi]).to(dev),
                              group_offsets(gid[t_lo:t_hi],
                                            num_groups).to(dev))
            out_val, out_mask = finish_lane_fold(acc, agg)
            self.exec_stats["rollupFoldDevice"] = 1.0
            clock.mark("kernels")
            return wts, out_val, out_mask

        def tile_grid(lo: int, hi: int):
            return (wts, torch.from_numpy(v[lo:hi]).to(dev),
                    torch.from_numpy(m[lo:hi]).to(dev)), 1

        out, stats = run_tiled(tsdb, spec, s, gid, num_groups, w,
                               plan.tile_plan, budget, tile_grid)
        self.exec_stats["rollupFoldReplay"] = 1.0
        self._bump("spillBytes", float(stats["spillBytes"]))
        clock.mark("kernels")
        return out

    def _run_union(self, query: TSQuery, sub: TSSubQuery, seg: Segment,
                   groups, global_notes: list,
                   budget: QueryBudget) -> dict[tuple, QueryResult]:
        """All group-by buckets through the union pipeline: the integer
        groups in one batch, the others in another.  Each group's points
        are charged to the budget, and the deadline checked, before any
        batch is built (the reference's planner.py:1483-1495)."""
        tsdb = self.tsdb
        start_ms, end_ms = seg.start_ms, seg.end_ms
        fix = tsdb.config.fix_duplicates
        clock = _PhaseClock(tsdb.device, self.exec_stats)
        parts: dict[bool, list] = {False: [], True: []}
        for group_key in sorted(groups, key=lambda k: tuple(map(str, k))):
            members = groups[group_key]
            stats = [s.window_stats(start_ms, end_ms, fix)
                     for s, _ in members]
            n = sum(c for c, _ in stats)
            if n:        # no datapoints in range -> no SpanGroup at all
                budget.charge(n)
                budget.check_deadline()
                all_int = all(isint for c, isint in stats if c)
                parts[all_int].append((group_key, members))
                self._bump("pointsScanned", float(n))
        results: dict[tuple, QueryResult] = {}
        for kept in parts.values():
            if kept:
                self._union_batch(query, sub, seg, kept, clock,
                                  global_notes, results)
        return results

    def _union_batch(self, query: TSQuery, sub: TSSubQuery, seg: Segment,
                     kept, clock: "_PhaseClock", global_notes: list,
                     results: dict) -> None:
        """One batch of groups through R (under a rate), U1 and U2."""
        tsdb = self.tsdb
        start_ms, end_ms = seg.start_ms, seg.end_ms
        series_list = [s for _, members in kept for s, _t in members]
        gid = np.concatenate([np.full(len(members), i, np.int64)
                              for i, (_, members) in enumerate(kept)])
        ts, val, mask, int_mode = build_batch_direct(
            series_list, start_ms, end_ms, tsdb.config.fix_duplicates)
        self._bump("seriesScanned", float(len(series_list)))
        clock.mark("build")

        dev = tsdb.device
        d_ts = torch.from_numpy(ts).to(dev)
        d_val = torch.from_numpy(val).to(dev)
        d_mask = torch.from_numpy(mask).to(dev)
        offsets = group_offsets(gid, len(kept)).to(dev)
        clock.mark("h2d")

        psp = obs_trace.begin("pipeline", aggregator=sub.aggregator,
                              downsample=None)
        u, out, uoff = run_union_pipeline(self._spec_for(sub), d_ts, d_val,
                                          d_mask, offsets, int_mode)
        clock.mark("kernels")
        obs_trace.device_wait(psp, (u, out, uoff))
        obs_trace.end(psp)

        u = u.cpu().numpy()
        out = out.cpu().numpy()
        uoff = uoff.cpu().numpy()
        for i, (group_key, members) in enumerate(kept):
            lo, hi = uoff[i], uoff[i + 1]
            dps = extract_dps(u[lo:hi], out[lo:hi], np.ones(hi - lo, bool),
                              start_ms, end_ms, int_mode and not sub.rate,
                              keep_nans=sub.fill_policy != "none")
            results[tuple(map(str, group_key))] = self._assemble_result(
                query, sub, members, dps, global_notes)
        clock.mark("extract")

    def _run_histogram_sub(self, query: TSQuery, sub: TSSubQuery,
                           budget: QueryBudget) -> list[QueryResult]:
        """A percentile or show-buckets sub query: every group's points
        charged to the budget (the reference's planner.py:1533-1534), then
        every group's bucket entries in one batch, H1 onto the [rows, B]
        grid, and H2 for all percentiles at once."""
        tsdb = self.tsdb
        if tsdb.histogram_store is None:
            raise ValueError("histograms are not configured "
                             "(tsd.core.histograms.config)")
        clock = _PhaseClock(tsdb.device, self.exec_stats)
        metric_uid = tsdb.metrics.get_id(sub.metric)
        filter_tagks = {f.tagk for f in sub.filters}
        matched = []
        for series in tsdb.histogram_store.series_for_metric(metric_uid):
            tags = tsdb.resolve_key_tags(series.key)
            if sub.explicit_tags and set(tags) != filter_tagks:
                continue
            if all(f.match(tags) for f in sub.filters):
                matched.append((series, tags))
        groups = self._group(matched, sub)
        interval_ms = (sub.downsample_spec.interval_ms
                       if sub.downsample_spec is not None else 0)
        ordered = [(gk, [s for s, _ in groups[gk]]) for gk in
                   sorted(groups, key=lambda k: tuple(map(str, k)))]
        results: list[QueryResult] = []
        total_points = 0
        for _, members in ordered:
            pts = sum(s.count_in_range(query.start_time, query.end_time)
                      for s in members)
            if pts:
                budget.charge(pts)
                budget.check_deadline()
            total_points += pts
        if not total_points:
            return results
        batch = assemble_columnar(ordered, query.start_time, query.end_time,
                                  interval_ms)
        if batch is None:
            return results
        r, b = batch["n_rows"], batch["n_buckets"]
        gbd = grid_budget(
            "histogram", tsdb.config.get_int("tsd.query.streaming.state_mb"),
            r * b * 8, r, b)
        if gbd.over:
            raise gbd.exception()
        clock.mark("build")

        dev = tsdb.device
        percs = [float(p) for p in (sub.percentiles or [])]
        seg = torch.from_numpy(batch["seg"]).to(dev)
        cnt = torch.from_numpy(batch["cnt"]).to(dev)
        mid = torch.from_numpy(batch["mid"]).to(dev)
        d_percs = torch.tensor(percs, dtype=torch.float64, device=dev)
        clock.mark("h2d")

        acc = accumulate_rows_deferred(seg, cnt, r, b)
        pvals = percentile_rows(acc.grid, mid, d_percs) if percs else None
        clock.mark("kernels")

        # H1's stray-entry flag comes back with the copy the answer needs
        # (after the grid, or after H2's values), before any answer
        counts_all = None
        if sub.show_histogram_buckets:
            host = acc.buffer.cpu().numpy()
            acc.check(host[-1])
            counts_all = host[:-1].reshape(r, b)
            if pvals is not None:
                pvals = pvals.cpu().numpy()
        elif pvals is not None:
            host = torch.cat((pvals.reshape(-1),
                              acc.flag.view(torch.float64))).cpu().numpy()
            acc.check(host[-1:].view(np.int64)[0])
            pvals = host[:-1].reshape(pvals.shape)
        else:
            acc.check(acc.flag.item())
        for group_key, row_lo, row_hi, ts, used, _pts in batch["groups"]:
            members = groups[group_key]
            group_tags, agg_tags = compute_tags([t for _, t in members])
            tsuids = [tsdb.tsuid(s.key) for s, _ in members]
            ts_list = ts.tolist()
            for i, p in enumerate(sub.percentiles or []):
                # metric_pct_<p> naming per the DataPoints adaptor
                # (HistogramDataPointsToDataPointsAdaptor.java:42-44)
                results.append(QueryResult(
                    metric="%s_pct_%s" % (sub.metric, float(p)),
                    tags=dict(group_tags),
                    aggregate_tags=list(agg_tags),
                    tsuids=list(tsuids),
                    dps=list(zip(ts_list, pvals[i, row_lo:row_hi].tolist())),
                    index=sub.index))
            if sub.show_histogram_buckets:
                for bucket in used.tolist():
                    lo, hi = batch["bounds"][bucket]
                    results.append(QueryResult(
                        metric="%s_bucket_%g_%g" % (sub.metric, lo, hi),
                        tags=dict(group_tags),
                        aggregate_tags=list(agg_tags),
                        tsuids=list(tsuids),
                        dps=list(zip(ts_list, counts_all[
                            row_lo:row_hi, bucket].tolist())),
                        index=sub.index))
        clock.mark("extract")
        return results

    def _run_segment(self, query: TSQuery, sub: TSSubQuery, seg: Segment,
                     global_notes: list,
                     budget: QueryBudget) -> dict[tuple, QueryResult]:
        """One segment: its store's matching series, grouped, through the
        grouped or the union arm.  A raw segment of a pre-aggregate query
        reads the pre-aggregate lane of its aggregator when one exists
        (the reference's planner.py:331-333)."""
        tsdb = self.tsdb
        store = seg.lane
        if seg.kind == "raw":
            store = tsdb.store
            if sub.pre_aggregate and tsdb.rollup_store is not None:
                pre = tsdb.rollup_store.peek_lane("", sub.aggregator, True)
                store = pre if pre is not None else store
        with obs_trace.stage("scan", kind=seg.kind) as sp:
            series_tags = self._resolve_series(sub, store)
            groups = self._group(series_tags, sub)
            obs_trace.annotate(sp, series=len(series_tags),
                               groups=len(groups))
        if sub.downsample_spec is not None:
            return self._run_grouped(query, sub, seg, groups, global_notes,
                                     store, budget)
        return self._run_union(query, sub, seg, groups, global_notes, budget)

    def _new_budget(self, sub: TSSubQuery) -> QueryBudget:
        """The scan budget and timeout of one sub query
        (QueryLimitOverride), the overrides file reloaded first when its
        interval has passed; inside a request its clock is the request
        deadline's (limits.active_deadline)."""
        tsdb = self.tsdb
        limits = tsdb.query_limits
        limits.maybe_reload()
        return QueryBudget(limits, sub.metric or "",
                           tsdb.config.get_int("tsd.query.timeout"),
                           deadline=active_deadline())

    def run_sub(self, query: TSQuery, sub: TSSubQuery) -> list[QueryResult]:
        budget = self._new_budget(sub)
        if sub.percentiles or sub.show_histogram_buckets:
            return self._run_histogram_sub(query, sub, budget)
        check_ported(self._spec_for(sub))
        global_notes = (self.tsdb.store.get_annotations(
            "", query.start_time, query.end_time)
            if query.global_annotations else [])
        merged: dict[tuple, QueryResult] = {}
        for seg in self._plan_segments(query, sub):
            for gk, qr in self._run_segment(query, sub, seg, global_notes,
                                            budget).items():
                cur = merged.get(gk)
                if cur is None:
                    merged[gk] = qr
                    continue
                # the split stitch (SplitRollupSpanGroup, the reference's
                # planner.py:1626-1644): segments are disjoint in time, so
                # concatenating in segment order keeps the points sorted
                cur.dps = cur.dps + qr.dps
                cur.tsuids.extend([t for t in qr.tsuids
                                   if t not in cur.tsuids])
                seen_notes = {id(a) for a in cur.annotations}
                cur.annotations.extend(
                    a for a in qr.annotations if id(a) not in seen_notes)
                cur.tags = {k: v for k, v in cur.tags.items()
                            if qr.tags.get(k) == v}
                cur.aggregate_tags = sorted(
                    set(cur.aggregate_tags) | set(qr.aggregate_tags))
        return [merged[k] for k in sorted(merged)]

    def run(self, query: TSQuery) -> list[QueryResult]:
        self.exec_stats = {}
        self.decisions = []
        out = []
        for sub in query.queries:
            out.extend(self.run_sub(query, sub))
        return out


def route_context(tsdb, seg: Segment, spec: PipelineSpec, windows, kept,
                  store, sketchable: bool, state_mb: int | None = None,
                  platform: str | None = None) -> pdn.RouteContext:
    """The routing verdict's snapshot of one grouped segment (the
    reference's RouteContext), as the executor and explain
    (query/explain.py) both build it, so that both get one verdict.
    `kept` holds (group key, members, point counts) of the groups with
    points; `state_mb` and `platform` replace the configured budget and
    the TSDB's device type (explain's what-ifs).  Sized as the reference
    sizes it: its padded window and group counts, so that the two route
    and refuse the same plans.  The device mesh serves a segment of at
    least ``tsd.query.mesh.min_series`` series (the reference's
    :453-459)."""
    config = tsdb.config
    s = sum(len(members) for _, members, _ in kept)
    ds_fn = spec.downsample.function
    mesh = tsdb.query_mesh()
    use_mesh = mesh is not None \
        and s >= config.get_int("tsd.query.mesh.min_series")
    batcher = tsdb.dispatch_batcher
    return pdn.RouteContext(
        seg_kind=seg.kind, ds_fn=ds_fn, aggregator=spec.aggregator,
        has_rate=spec.rate is not None, s=s,
        n_max=int(max(max(c) for _, _, c in kept)),
        wp=pad_pow2(windows.count), groups=len(kept),
        g_pad=pad_pow2(len(kept)),
        total_points=int(sum(sum(c) for _, _, c in kept)),
        sketchable=sketchable,
        stream_ok=seg.kind != "rollup_avg" and (ds_fn in STREAMABLE_DS
                                                or sketchable),
        windows_fixed=isinstance(windows, FixedWindows),
        store_is_raw=store is tsdb.store, has_store=store is not None,
        platform=platform or tsdb.device.type,
        state_mb=(config.get_int("tsd.query.streaming.state_mb")
                  if state_mb is None else state_mb),
        point_threshold=config.get_int("tsd.query.streaming.point_threshold"),
        batch_ok=batcher is not None and batcher.enabled,
        batch_factor=config.get_float("tsd.query.batch.amortize_factor"),
        ts_base=precompact_base(windows,
                                getattr(windows, "first_window_ms", None)),
        use_mesh=use_mesh, n_chips=mesh.size if use_mesh else 1)


def extract_dps(out_ts: np.ndarray, out_val: np.ndarray, out_mask: np.ndarray,
                start_ms: int, end_ms: int, int_mode: bool,
                keep_nans: bool = False) -> list[tuple[int, object]]:
    """Device output -> (ts_ms, python value) pairs trimmed to the query range.

    The serializer-level trim mirrors HttpJsonSerializer (:848-852): points
    outside [start, end] are dropped.  NaNs survive only under fill policies
    that emit them.
    """
    ts = out_ts.ravel()
    val = out_val.ravel()
    mask = out_mask.ravel()
    keep = mask & (ts >= start_ms) & (ts <= end_ms)
    if not keep_nans:
        with np.errstate(invalid="ignore"):
            keep = keep & ~np.isnan(val.astype(np.float64))
    ts = ts[keep]
    val = val[keep]
    if not (int_mode and not np.issubdtype(val.dtype, np.floating)):
        val = val.astype(np.float64)
    return list(zip(ts.tolist(), val.tolist()))


class _ExecConsults:
    """plan_decision()'s consults for the executor (the reference's
    planner.py:1655): each hook does the real, stateful work (lane demand
    recording, tiled sizing with its refusal tallies, the device gather);
    the routing logic lives in query/plandecision.py."""

    def __init__(self, runner: QueryRunner, ctx, spec: PipelineSpec,
                 seg: Segment, windows, store, series_list,
                 clock: _PhaseClock):
        self.tsdb = runner.tsdb
        self.ctx = ctx
        self.spec = spec
        self.seg = seg
        self.windows = windows
        self.store = store
        self.series_list = series_list
        self.clock = clock

    def rollup_plan(self):
        ctx = self.ctx
        return self.tsdb.rollup_lanes.plan(
            self.series_list[0].key.metric, self.series_list, self.windows,
            self.seg.start_ms, self.seg.end_ms, ctx.ds_fn, ctx.n_max,
            ctx.groups, ctx.has_rate, total_points=ctx.total_points)

    def note_lane_served(self, plan) -> None:
        self.tsdb.rollup_lanes.note_served(plan)

    def note_lane_fallback(self) -> None:
        self.tsdb.rollup_lanes.note_striping_fallback()

    def tiled_refusal(self, reason: str) -> None:
        count_refusal(self.tsdb, reason)

    def tiled_plan(self, acc_cell: int):
        ctx = self.ctx
        return plan_tiled(self.tsdb, s=ctx.s, w=ctx.wp, g_pad=ctx.g_pad,
                          acc_cell_bytes=acc_cell)

    def agg_plan(self, platform: str):
        """The aggregate cache's rewrite plan and decision (the
        reference's :1704-1710)."""
        ctx = self.ctx
        tsdb = self.tsdb
        step = self.spec.downsample
        metric = self.series_list[0].key.metric
        # a recompute from the device cache is a hit, and is priced so
        full_hit = (tsdb.device_cache is not None and self.store is tsdb.store
                    and tsdb.device_cache.holds(self.store, metric))
        return tsdb.agg_cache.plan(
            self.store, metric, self.series_list, self.windows,
            self.seg.start_ms, self.seg.end_ms, ctx.ds_fn, step.fill_policy,
            step.fill_value, platform, ctx.s, ctx.n_max, ctx.g_pad,
            ctx.has_rate, total_points=ctx.total_points, full_hit=full_hit)

    def device_batch(self, build: bool, ts_base: int | None = None):
        """The device cache's batch, or None; with `ts_base` its
        timestamps as int32 offsets (the reference's :1712-1716).  The
        cache holds the raw store's columns only: a rollup lane or
        pre-aggregate store is never looked up."""
        tsdb = self.tsdb
        if self.store is not tsdb.store:
            return None
        cached = tsdb.device_cache.batch_for(
            tsdb.store, self.series_list[0].key.metric, self.series_list,
            self.seg.start_ms, self.seg.end_ms, build=build,
            ts_base=ts_base)
        self.clock.mark("gather")
        return cached
