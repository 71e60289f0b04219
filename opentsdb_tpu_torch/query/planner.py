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

Every aggregator and downsample function of the registry is answered
(moments, order and rank functions, movingAverage<N>), with or without a
rate.  A histogram sub query (percentiles or show-histogram-buckets, the
reference's _run_histogram_sub, TsdbQuery.isHistogramQuery :806-812)
scatters every group's bucket entries onto one [rows, B] grid on the
device (H1) and picks the percentiles there (H2).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from opentsdb_tpu_torch.histogram.kernels import (accumulate_rows,
                                                  percentile_rows)
from opentsdb_tpu_torch.histogram.store import assemble_columnar
from opentsdb_tpu_torch.models.tsquery import TSQuery, TSSubQuery
from opentsdb_tpu_torch.ops.downsample import (
    FixedWindows, EdgeWindows, AllWindow)
from opentsdb_tpu_torch.ops.group_agg import group_offsets
from opentsdb_tpu_torch.ops.pipeline import (
    PipelineSpec, DownsampleStep, build_batch_direct, check_ported,
    run_group_pipeline, run_union_pipeline)
from opentsdb_tpu_torch.query.limits import grid_budget
from opentsdb_tpu_torch.storage.memstore import Series
from opentsdb_tpu_torch.uid import NoSuchUniqueName
from opentsdb_tpu_torch.utils import datetime_util as DT

_NO_MATCH = object()  # sentinel: a literal filter can never match

# Host-clock phases of one dispatch; exec_stats carries each as
# "<phase>Ms" summed over the run's dispatches.  "gather" is the grouped
# arm's device-cache consult: validation and, on a hit, the gather (a cold
# entry built inline lands there too).
PHASES = ("build", "gather", "h2d", "kernels", "extract")


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

    def _bump(self, key: str, value: float) -> None:
        self.exec_stats[key] = self.exec_stats.get(key, 0.0) + value

    # -- series selection ------------------------------------------------

    def _resolve_series(self, sub: TSSubQuery) -> list[tuple[Series, dict]]:
        """All series matching the sub query, with resolved tag maps."""
        tsdb = self.tsdb
        store = tsdb.store
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

    def _spec_for(self, sub: TSSubQuery) -> PipelineSpec:
        ds = sub.downsample_spec
        return PipelineSpec(
            aggregator=sub.aggregator,
            downsample=None if ds is None else DownsampleStep(
                ds.function, ds.fill_policy, ds.fill_value),
            rate=sub.rate_options if sub.rate else None)

    def _run_grouped(self, query: TSQuery, sub: TSSubQuery, groups,
                     global_notes: list) -> dict[tuple, QueryResult]:
        """All group-by buckets in ONE batch through the grouped pipeline,
        the batch gathered from the device cache on a hit and built on the
        host otherwise."""
        tsdb = self.tsdb
        start_ms, end_ms = query.start_time, query.end_time
        fix = tsdb.config.fix_duplicates
        clock = _PhaseClock(tsdb.device, self.exec_stats)
        kept = []  # (group_key, members)
        points = 0
        for group_key in sorted(groups, key=lambda k: tuple(map(str, k))):
            members = groups[group_key]
            n = sum(s.window_count(start_ms, end_ms, fix) for s, _ in members)
            # no datapoints in range -> no SpanGroup at all
            # (TsdbQuery.findSpans -> empty group map)
            if n:
                kept.append((group_key, members))
                points += n
        if not kept:
            return {}
        series_list = [s for _, members in kept for s, _t in members]
        gid = np.concatenate([np.full(len(members), i, np.int64)
                              for i, (_, members) in enumerate(kept)])
        self._bump("pointsScanned", float(points))
        self._bump("seriesScanned", float(len(series_list)))
        clock.mark("build")

        dev = tsdb.device
        cached = None
        if tsdb.device_cache is not None:
            # a cold entry builds inline: the port has no streaming path
            # that would make that the dearer choice
            cached = tsdb.device_cache.batch_for(
                tsdb.store, series_list[0].key.metric, series_list, start_ms,
                end_ms)
            clock.mark("gather")
        if cached is not None:
            self.exec_stats["deviceCacheHit"] = 1.0
            d_ts, d_val, d_mask = cached
        else:
            ts, val, mask, _ = build_batch_direct(series_list, start_ms,
                                                  end_ms, fix)
            clock.mark("build")
            d_ts = torch.from_numpy(ts).to(dev)
            d_val = torch.from_numpy(val).to(dev)
            d_mask = torch.from_numpy(mask).to(dev)
        edges = self._windows_for(sub, query).window_edges(dev)
        clock.mark("h2d")

        out_ts, out_val, out_mask = run_group_pipeline(
            self._spec_for(sub), d_ts, d_val, d_mask, gid, len(kept), edges)
        clock.mark("kernels")

        out_ts = out_ts.cpu().numpy()
        out_val = out_val.cpu().numpy()
        out_mask = out_mask.cpu().numpy()
        results: dict[tuple, QueryResult] = {}
        for i, (group_key, members) in enumerate(kept):
            dps = extract_dps(out_ts, out_val[i], out_mask[i], start_ms,
                              end_ms, False,
                              keep_nans=sub.fill_policy != "none")
            results[tuple(map(str, group_key))] = self._assemble_result(
                query, sub, members, dps, global_notes)
        clock.mark("extract")
        return results

    def _run_union(self, query: TSQuery, sub: TSSubQuery, groups,
                   global_notes: list) -> dict[tuple, QueryResult]:
        """All group-by buckets through the union pipeline: the integer
        groups in one batch, the others in another."""
        tsdb = self.tsdb
        start_ms, end_ms = query.start_time, query.end_time
        fix = tsdb.config.fix_duplicates
        clock = _PhaseClock(tsdb.device, self.exec_stats)
        parts: dict[bool, list] = {False: [], True: []}
        for group_key in sorted(groups, key=lambda k: tuple(map(str, k))):
            members = groups[group_key]
            stats = [s.window_stats(start_ms, end_ms, fix)
                     for s, _ in members]
            n = sum(c for c, _ in stats)
            if n:        # no datapoints in range -> no SpanGroup at all
                all_int = all(isint for c, isint in stats if c)
                parts[all_int].append((group_key, members))
                self._bump("pointsScanned", float(n))
        results: dict[tuple, QueryResult] = {}
        for kept in parts.values():
            if kept:
                self._union_batch(query, sub, kept, clock, global_notes,
                                  results)
        return results

    def _union_batch(self, query: TSQuery, sub: TSSubQuery, kept,
                     clock: "_PhaseClock", global_notes: list,
                     results: dict) -> None:
        """One batch of groups through R (under a rate), U1 and U2."""
        tsdb = self.tsdb
        start_ms, end_ms = query.start_time, query.end_time
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

        u, out, uoff = run_union_pipeline(self._spec_for(sub), d_ts, d_val,
                                          d_mask, offsets, int_mode)
        clock.mark("kernels")

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

    def _run_histogram_sub(self, query: TSQuery,
                           sub: TSSubQuery) -> list[QueryResult]:
        """A percentile or show-buckets sub query: every group's bucket
        entries in one batch, H1 onto the [rows, B] grid, then H2 for
        all percentiles at once."""
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

        grid = accumulate_rows(seg, cnt, r, b)
        pvals = percentile_rows(grid, mid, d_percs) if percs else None
        clock.mark("kernels")

        counts_all = (grid.cpu().numpy() if sub.show_histogram_buckets
                      else None)
        pvals = None if pvals is None else pvals.cpu().numpy()
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

    def run_sub(self, query: TSQuery, sub: TSSubQuery) -> list[QueryResult]:
        if sub.percentiles or sub.show_histogram_buckets:
            return self._run_histogram_sub(query, sub)
        check_ported(self._spec_for(sub))
        global_notes = (self.tsdb.store.get_annotations(
            "", query.start_time, query.end_time)
            if query.global_annotations else [])
        series_tags = self._resolve_series(sub)
        groups = self._group(series_tags, sub)
        run = self._run_grouped if sub.downsample_spec is not None \
            else self._run_union
        merged = run(query, sub, groups, global_notes)
        return [merged[k] for k in sorted(merged)]

    def run(self, query: TSQuery) -> list[QueryResult]:
        self.exec_stats = {}
        out = []
        for sub in query.queries:
            out.extend(self.run_sub(query, sub))
        return out


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
