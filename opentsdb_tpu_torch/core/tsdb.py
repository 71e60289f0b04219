"""TSDB facade: write path, UID dictionaries, query entry — on one device
or a mesh of devices.

A slim port of opentsdb_tpu/core/tsdb.py (OpenTSDB TSDB.java :87 — the
three UID dictionaries :297-302, ``addPoint`` :1051-1136 with timestamp/tag
validation :1313, and the second/millisecond timestamp heuristic).  The
store lives on the host; queries run on ``device``, which is ``cuda``
unless the caller passes another (device.resolve_device).  Two caches:
the device series cache (storage/device_cache.py), refreshed by the
maintenance thread that ``start_maintenance`` starts, and the aggregate
cache of downsample blocks (storage/agg_cache.py, ``tsd.query.cache.*``),
told of every write through the store's mutation listener, whose hot
blocks the same thread mirrors on the device; latency attribution
(obs/latattr.py, ``tsd.latattr.enable``) behind /api/diag/latency; the
spill pool behind
out-of-core tiled execution (``tsd.query.spill.*``, storage/spill.py),
closed by ``shutdown``.  With ``tsd.rollups.enable`` the TSDB takes
written rollups (``add_aggregate_point``, TSDB.java:1359-1457)
into its RollupStore; with ``tsd.rollup.enable`` the maintenance thread
builds rollup lanes (storage/rollup.py) that hear of every write through
the store's mutation listener.  Grouped queries of at least
``tsd.query.mesh.min_series`` series, and the rollup job, run over the
device mesh (``query_mesh``, parallel/) when there is one.  The admission
gate (tsd/admission.py)
bounds the queries the daemon runs at once, and the dispatch batcher
(query/batcher.py, ``tsd.query.batch.enable``) stacks concurrent small
grouped queries into one launch of each kernel.  No WAL, no replication,
no plugins.

``load_state`` builds a TSDB from another TSDB's UID dictionaries and
series columns, so the two hold the same data under the same UIDs.
"""

from __future__ import annotations

import base64
import math
import threading

import numpy as np

from opentsdb_tpu_torch.device import resolve_device
from opentsdb_tpu_torch.histogram import (HistogramCodecManager,
                                          HistogramStore, SimpleHistogram)
from opentsdb_tpu_torch.obs.latattr import LatencyAttribution
from opentsdb_tpu_torch.ops.aggregators import AGGREGATORS
from opentsdb_tpu_torch.parallel.mesh import normalize_device
from opentsdb_tpu_torch.query.limits import QueryLimitOverride
from opentsdb_tpu_torch.rollup import RollupConfig, RollupStore
from opentsdb_tpu_torch.storage.agg_cache import AggregateCache
from opentsdb_tpu_torch.storage.device_cache import DeviceSeriesCache
from opentsdb_tpu_torch.storage.memstore import (
    MemStore, SeriesKey, MAX_NUM_TAGS)
from opentsdb_tpu_torch.storage.rollup import RollupLanes
from opentsdb_tpu_torch.storage.spill import SpillPool
from opentsdb_tpu_torch.uid import UniqueId, UniqueIdType
from opentsdb_tpu_torch.utils.config import Config, refuse_unported

SECOND_MASK = 0xFFFFFFFF00000000  # Const.java:19 — set bits mean milliseconds
_UNSET = object()


def normalize_timestamp_ms(timestamp: int | float) -> int:
    """Seconds-or-milliseconds heuristic (TSDB.addPointInternal).

    Values below 2^32 are treated as Unix seconds, larger as milliseconds.
    """
    ts = int(timestamp)
    if ts < 0:
        raise ValueError(
            "The timestamp must be positive and within the extent of a "
            "64-bit integer: %s" % timestamp)
    if ts & SECOND_MASK:
        return ts
    return ts * 1000


def parse_value(value) -> tuple[bool, int | float]:
    """Classify a put value as integer or float (Tags.parseLong / fixFloat).

    Strings follow the telnet `put` rules: "42" is an integer, "42.0" and
    "4e2" are floats.  NaN/Infinity are rejected like the reference.
    """
    if isinstance(value, bool):
        raise ValueError("Invalid value: %r" % value)
    if isinstance(value, int):
        return True, value
    if isinstance(value, float):
        if math.isnan(value) or math.isinf(value):
            raise ValueError("Invalid value: %r" % value)
        return False, value
    text = str(value).strip()
    if not text:
        raise ValueError("Empty value")
    try:
        return True, int(text)
    except ValueError:
        pass
    try:
        out = float(text)
    except ValueError:
        raise ValueError("Invalid value: %r" % value)
    if math.isnan(out) or math.isinf(out):
        raise ValueError("Invalid value: %r" % value)
    return False, out


class TSDB:
    """The top-level handle: storage + UID dictionaries + write/query APIs."""

    def __init__(self, config: Config | None = None, device=None,
                 mesh=None):
        self.config = config or Config()
        refuse_unported(self.config)
        self.device = resolve_device(device)
        # an explicit device mesh (parallel/mesh.py) whose owner is this
        # device; without one, query_mesh builds the default
        if mesh is not None and normalize_device(mesh.owner) \
                != normalize_device(self.device):
            raise ValueError("the mesh's owner %s is not the TSDB's device "
                             "%s" % (mesh.owner, self.device))
        self._mesh = mesh
        self._default_mesh = _UNSET
        self.metrics = UniqueId(
            UniqueIdType.METRIC,
            width=self.config.get_int("tsd.storage.uid.width.metric"),
            random_ids=self.config.get_bool("tsd.core.uid.random_metrics"))
        self.tag_names = UniqueId(
            UniqueIdType.TAGK,
            width=self.config.get_int("tsd.storage.uid.width.tagk"))
        self.tag_values = UniqueId(
            UniqueIdType.TAGV,
            width=self.config.get_int("tsd.storage.uid.width.tagv"))
        self.store = MemStore(salt_buckets=self.config.salt_buckets,
                              fix_duplicates=self.config.fix_duplicates)
        # created as the reference does at core/tsdb.py:76-85
        self.device_cache = (
            DeviceSeriesCache(
                self.config.get_int("tsd.query.device_cache.mb") * 2**20,
                self.config.get_int(
                    "tsd.query.device_cache.build_max_points"),
                fix_duplicates=self.config.fix_duplicates,
                batch_max_bytes=self.config.get_int(
                    "tsd.query.device_cache.batch_mb") * 2**20,
                device=self.device)
            if self.config.get_bool("tsd.query.device_cache.enable")
            else None)
        # the partial-aggregate block cache (reference core/tsdb.py:86-100):
        # the store marks the affected (metric, range) dirty after each
        # write lands.  The listener reads the attribute at each write, so
        # a cache attached or detached later is told, or not, from then on
        self.agg_cache = (
            AggregateCache(self.config, self.device)
            if self.config.get_bool("tsd.query.cache.enable") else None)
        self.store.add_mutation_listener(self._note_agg_mutation)
        # always-on latency attribution (reference core/tsdb.py:151-161)
        self.latattr = (LatencyAttribution(self.config)
                        if self.config.get_bool("tsd.latattr.enable")
                        else None)
        # built from the config as the reference does at core/tsdb.py:182-187
        self.histogram_manager = HistogramCodecManager.from_config(
            self.config)
        self.histogram_store = (HistogramStore()
                                if self.histogram_manager else None)
        # written rollups, as the reference builds them at
        # core/tsdb.py:171-181
        self.rollup_config = RollupConfig.from_config(self.config)
        self.rollup_store = (
            RollupStore(self.rollup_config, self.config.salt_buckets)
            if self.rollup_config is not None else None)
        self.agg_tag_key = self.config.get_string("tsd.rollups.agg_tag_key")
        self.raw_agg_tag_value = self.config.get_string(
            "tsd.rollups.raw_agg_tag_value")
        self.tag_raw_data = self.config.get_bool("tsd.rollups.tag_raw")
        self.rollups_block_derived = self.config.get_bool(
            "tsd.rollups.block_derived")
        # maintenance-built rollup lanes, told of every write after it
        # lands (reference core/tsdb.py:114-128)
        self.rollup_lanes = (RollupLanes(self.config, self.device)
                             if self.config.get_bool("tsd.rollup.enable")
                             else None)
        if self.rollup_lanes is not None:
            self.store.add_mutation_listener(self.rollup_lanes.note_mutation)
        # the bounded partial-aggregate spill pool behind tiled execution
        # (reference core/tsdb.py:102-113), closed at shutdown
        self.spill_pool = (
            SpillPool(
                self.config.get_int("tsd.query.spill.host_mb") * 2**20,
                self.config.get_int("tsd.query.spill.disk_mb") * 2**20,
                directory=self.config.get_string("tsd.query.spill.dir")
                or None)
            if self.config.get_bool("tsd.query.spill.enable") else None)
        # admission control (tsd/admission.py) and fused multi-query
        # dispatch (query/batcher.py; reference core/tsdb.py:162-170)
        from opentsdb_tpu_torch.query.batcher import DispatchBatcher
        from opentsdb_tpu_torch.tsd.admission import AdmissionGate
        self.admission_gate = AdmissionGate(self.config)
        self.dispatch_batcher = (
            DispatchBatcher(self.config, tsdb=self)
            if self.config.get_bool("tsd.query.batch.enable") else None)
        self.mode = self.config.get_string("tsd.mode")  # rw / ro / wo
        self._stats_lock = threading.Lock()
        self.datapoints_added = 0  # guarded-by: _stats_lock
        # over-budget plans the tiled path refused, by reason
        self.tiled_refusals: dict[str, int] = {}  # guarded-by: _stats_lock
        self.maintenance = None
        self._query_limits = None

    # -- write path ------------------------------------------------------ #

    def check_timestamp_and_tags(self, metric: str, timestamp: int | float,
                                 value, tags: dict[str, str]) -> None:
        """Validation rules of TSDB.checkTimestampAndTags (:1313)."""
        if not tags:
            raise ValueError(
                "Need at least one tag (metric=%s, ts=%s)" % (metric, timestamp))
        if len(tags) > MAX_NUM_TAGS:
            raise ValueError(
                "Too many tags: %d maximum allowed: %d" %
                (len(tags), MAX_NUM_TAGS))
        if int(timestamp) < 0:
            raise ValueError("Invalid timestamp: %s" % timestamp)

    def _note_agg_mutation(self, metric: int, lo_ms, hi_ms) -> None:
        cache = self.agg_cache
        if cache is not None:
            cache.note_mutation(metric, lo_ms, hi_ms, store=self.store)

    def _check_writable(self) -> None:
        """The read-only gate, applied after validation as the reference
        does, so a malformed point reports the same error in every mode."""
        if self.mode == "ro":
            raise RuntimeError("TSD is in read-only mode, writes rejected")

    def _count_added(self, n: int) -> None:
        with self._stats_lock:
            self.datapoints_added += n

    def add_point(self, metric: str, timestamp: int | float, value,
                  tags: dict[str, str]) -> None:
        """Store one datapoint; value may be int, float, or numeric string."""
        is_int, num = parse_value(value)
        self.check_timestamp_and_tags(metric, timestamp, num, tags)
        self._check_writable()
        key = self._series_key(metric, self._raw_tags(tags), create=True)
        self.store.add_point(key, normalize_timestamp_ms(timestamp), num,
                             is_int)
        self._count_added(1)

    def _raw_tags(self, tags: dict[str, str]) -> dict[str, str]:
        """tsd.rollups.tag_raw: raw series carry the aggregate tag, so
        that they coexist with pre-aggregates (TSDB.addPointInternal
        :1471-1480)."""
        if self.rollup_store is not None and self.tag_raw_data:
            return {**tags, self.agg_tag_key: self.raw_agg_tag_value}
        return tags

    def add_points_bulk(self, dps: list[dict]
                        ) -> tuple[int, list[tuple[int, Exception]]]:
        """Bulk ingest of /api/put style dicts: points validate one by one,
        then group by series, each series taking one columnar append.
        Returns (success_count, [(index, exception), ...])."""
        errors: list[tuple[int, Exception]] = []
        groups: dict = {}   # key -> (ts_ms, float, exact int, is_int)
        key_cache: dict = {}
        for i, dp in enumerate(dps):
            try:
                for fld in ("metric", "timestamp", "value", "tags"):
                    if fld not in dp or dp[fld] in (None, "", {}):
                        raise ValueError("Missing required field: %s" % fld)
                metric, tags = dp["metric"], dict(dp["tags"])
                is_int, num = parse_value(dp["value"])
                if is_int and not (-(1 << 63) <= num < (1 << 63)):
                    raise ValueError("Invalid value, out of long range: %r"
                                     % dp["value"])
                self.check_timestamp_and_tags(metric, dp["timestamp"], num,
                                              tags)
                self._check_writable()
                ts_ms = normalize_timestamp_ms(dp["timestamp"])
                tags = self._raw_tags(tags)
                ck = (metric, tuple(sorted(tags.items())))
                key = key_cache.get(ck)
                if key is None:
                    key = key_cache[ck] = self._series_key(metric, tags,
                                                           create=True)
                bucket = groups.setdefault(key, ([], [], [], []))
                bucket[0].append(ts_ms)
                bucket[1].append(float(num))
                bucket[2].append(int(num) if is_int else 0)
                bucket[3].append(is_int)
            except (ValueError, TypeError, LookupError, RuntimeError) as e:
                errors.append((i, e))
        success = 0
        for key, (tss, fvals, ivals, isints) in groups.items():
            self.store.add_batch(key, np.asarray(tss, np.int64),
                                 np.asarray(fvals, np.float64),
                                 np.asarray(isints, bool),
                                 ival=np.asarray(ivals, np.int64))
            success += len(tss)
        self._count_added(success)
        return success, errors

    # -- rollup write path (TSDB.addAggregatePoint :1359-1457) ----------- #

    def add_aggregate_point(self, metric: str, timestamp: int | float, value,
                            tags: dict[str, str], is_groupby: bool,
                            interval: str | None,
                            rollup_aggregator: str | None,
                            groupby_aggregator: str | None = None) -> None:
        """Store one rolled-up and/or pre-aggregated point
        (TSDB.addAggregatePointInternal).  With `interval` the value goes
        to that interval's lane of `rollup_aggregator`; with `is_groupby`
        it goes to a pre-aggregate lane and the aggregate tag
        (tsd.rollups.agg_tag_key) is set to the upper-cased group-by
        aggregator."""
        if self.rollup_store is None:
            raise RuntimeError("Rollups are not enabled "
                               "(tsd.rollups.enable=false)")
        is_int, num = parse_value(value)
        if interval:
            # raises NoSuchRollupForInterval for an unconfigured interval
            self.rollup_config.get_rollup_interval(interval)
            if not rollup_aggregator:
                raise ValueError("Missing rollup aggregator for interval %s"
                                 % interval)
            if (self.rollups_block_derived
                    and rollup_aggregator.upper() in ("AVG", "DEV")):
                # tsd.rollups.block_derived (TSDB.java:1562-1569)
                raise ValueError(
                    "Derived rollup aggregations are not allowed: %s"
                    % rollup_aggregator)
            self.rollup_config.get_id_for_aggregator(rollup_aggregator)
        elif not is_groupby:
            raise ValueError(
                "Either an interval or the groupby flag is required")
        tags = dict(tags)
        if is_groupby:
            if not groupby_aggregator:
                raise ValueError("Missing group-by aggregator")
            if groupby_aggregator.lower() not in AGGREGATORS:
                raise ValueError("Invalid group by aggregator: %s"
                                 % groupby_aggregator)
            if (self.rollups_block_derived
                    and groupby_aggregator.upper() in ("AVG", "DEV")):
                # TSDB.java:1543-1550
                raise ValueError(
                    "Derived group by aggregations are not allowed: %s"
                    % groupby_aggregator)
            tags[self.agg_tag_key] = groupby_aggregator.upper()
        self.check_timestamp_and_tags(metric, timestamp, num, tags)
        self._check_writable()
        key = self._series_key(metric, tags, create=True)
        lane_agg = rollup_aggregator if interval else groupby_aggregator
        self.rollup_store.add_point(
            key, interval or "", lane_agg.lower(),
            normalize_timestamp_ms(timestamp), num, is_int,
            pre_agg=is_groupby)
        self._count_added(1)

    # -- histogram write path (TSDB.addHistogramPoint :1171) ------------- #

    def _require_histograms(self) -> None:
        if self.histogram_manager is None:
            raise ValueError("histograms are not configured "
                             "(tsd.core.histograms.config)")

    def add_histogram_point_raw(self, metric: str, timestamp: int | float,
                                codec_id: int, payload: str,
                                tags: dict[str, str]) -> None:
        """Base64 binary histogram ingest (telnet `histogram`,
        HistogramPojo.getBytes)."""
        self._require_histograms()
        codec = self.histogram_manager.get_codec(codec_id)
        hist = codec.decode(base64.b64decode(payload), includes_id=False)
        self._store_histogram(metric, timestamp, hist, tags)

    def add_histogram_point_json(self, metric: str, timestamp: int | float,
                                 dp: dict, tags: dict[str, str]) -> None:
        """JSON histogram ingest (POST /api/histogram, HistogramPojo):
        either base64 `value` or explicit `buckets` {"lo,hi": count}."""
        self._require_histograms()
        codec_id = int(dp.get("id", 0))
        self.histogram_manager.get_codec(codec_id)  # validate the id
        if dp.get("value"):
            hist = SimpleHistogram.from_base64(str(dp["value"]),
                                               include_id=False)
            hist.id = codec_id
        elif "buckets" in dp:
            # Empty bucket maps are valid: the mass may sit entirely in
            # underflow/overflow.
            hist = SimpleHistogram.from_pojo(dp, codec_id)
        else:
            raise ValueError("Missing histogram value or buckets")
        self._store_histogram(metric, timestamp, hist, tags)

    def _store_histogram(self, metric: str, timestamp: int | float, hist,
                         tags: dict[str, str]) -> None:
        self.check_timestamp_and_tags(metric, timestamp, None, tags)
        self._check_writable()
        ts_ms = normalize_timestamp_ms(timestamp)
        key = self._series_key(metric, tags, create=True)
        self.histogram_store.add_point(key, ts_ms, hist)
        self._count_added(1)

    def _series_key(self, metric: str, tags: dict[str, str],
                    create: bool) -> SeriesKey:
        if create:
            if self.config.auto_metric:
                metric_uid = self.metrics.get_or_create_id(metric)
            else:
                metric_uid = self.metrics.get_id(metric)
            auto_tagk = self.config.get_bool("tsd.core.auto_create_tagks")
            auto_tagv = self.config.get_bool("tsd.core.auto_create_tagvs")
            uid_tags = {}
            for k, v in tags.items():
                ku = (self.tag_names.get_or_create_id(k) if auto_tagk
                      else self.tag_names.get_id(k))
                vu = (self.tag_values.get_or_create_id(v) if auto_tagv
                      else self.tag_values.get_id(v))
                uid_tags[ku] = vu
        else:
            metric_uid = self.metrics.get_id(metric)
            uid_tags = {self.tag_names.get_id(k): self.tag_values.get_id(v)
                        for k, v in tags.items()}
        return SeriesKey.make(metric_uid, uid_tags)

    # -- read helpers ---------------------------------------------------- #

    def resolve_key_tags(self, key: SeriesKey) -> dict[str, str]:
        """UID tag pairs -> {tagk_name: tagv_name}."""
        return {self.tag_names.get_name(k): self.tag_values.get_name(v)
                for k, v in key.tags}

    def tsuid(self, key: SeriesKey) -> str:
        """Hex TSUID honoring the configured UID byte widths."""
        return key.tsuid(self.metrics.width, self.tag_names.width,
                         self.tag_values.width)

    def collect_stats(self) -> dict:
        """The stored point count and the tallies of the device cache, the
        aggregate cache, the rollup lanes, the spill pool, the dispatch
        batcher, the admission gate and latency attribution, where they are
        on (a slim TSDB.collectStats, reference core/tsdb.py:1056)."""
        out: dict = {"tsd.storage.datapoints": self.store.total_datapoints,
                     "tsd.datapoints.added": self.datapoints_added}
        if self.device_cache is not None:
            out.update(self.device_cache.collect_stats())
        if self.agg_cache is not None:
            out.update(self.agg_cache.collect_stats())
        if self.latattr is not None:
            out.update(self.latattr.collect_stats())
        if self.rollup_lanes is not None:
            out.update(self.rollup_lanes.collect_stats())
        if self.maintenance is not None:
            out.update(self.maintenance.collect_stats())
        if self.spill_pool is not None:
            out.update(self.spill_pool.collect_stats())
        if self.dispatch_batcher is not None:
            out.update(self.dispatch_batcher.collect_stats())
        out.update(self.admission_gate.collect_stats())
        with self._stats_lock:
            for reason, n in self.tiled_refusals.items():
                out["tsd.query.spill.refusals." + reason] = float(n)
        return out

    # -- maintenance ----------------------------------------------------- #

    def start_maintenance(self):
        """Start the background maintenance thread, which rebuilds stale
        device-cache entries and mirrors hot aggregate blocks on the
        device every MaintenanceThread.TICK_SECONDS and builds rollup lanes
        every ``tsd.rollup.interval`` seconds.  A
        long-lived TSDB that takes writes starts it, as the reference's
        daemon does (tools/tsd_main.py:126); a bare TSDB stays free of
        threads.  Returns the thread."""
        if self.maintenance is None:
            from opentsdb_tpu_torch.core.maintenance import MaintenanceThread
            self.maintenance = MaintenanceThread(self)
            self.maintenance.start()
        return self.maintenance

    def shutdown(self) -> None:
        """Stop the maintenance thread, if one runs, and close the spill
        pool: its entries and its private temp directory go."""
        if self.maintenance is not None:
            self.maintenance.stop()
            self.maintenance = None
        if self.spill_pool is not None:
            self.spill_pool.close()

    @property
    def query_limits(self) -> QueryLimitOverride:
        """The scan-budget registry (QueryLimitOverride.java), built at
        first use from the config, as the reference's facade builds it."""
        if self._query_limits is None:
            self._query_limits = QueryLimitOverride(self.config)
        return self._query_limits

    def new_query_runner(self):
        from opentsdb_tpu_torch.query.planner import QueryRunner
        return QueryRunner(self)

    def query_mesh(self):
        """The device mesh serving grouped queries and the rollup job, or
        None (the reference's :947-965): None with
        ``tsd.query.mesh.enable`` off; the mesh given to the TSDB, if any;
        else one over every visible CUDA device with this TSDB's first
        (None with fewer than two, and on the CPU).  The reference takes
        its mesh from the visible devices only; its tests get a mesh on
        one host from virtual devices, the port's from ``mesh=``."""
        if not self.config.get_bool("tsd.query.mesh.enable"):
            return None
        if self._mesh is not None:
            return self._mesh
        if self._default_mesh is _UNSET:
            from opentsdb_tpu_torch.parallel import make_mesh
            from opentsdb_tpu_torch.parallel.distributed import (
                host_major_devices)
            own = normalize_device(self.device)
            devices = ([d for d in host_major_devices() if d == own]
                       + [d for d in host_major_devices() if d != own]
                       if own.type == "cuda" else [])
            self._default_mesh = (make_mesh(devices=devices)
                                  if len(devices) > 1 else None)
        return self._default_mesh

    # -- UID admin ------------------------------------------------------- #

    def uid_table(self, kind: str) -> UniqueId:
        t = UniqueIdType.from_string(kind)
        return {UniqueIdType.METRIC: self.metrics,
                UniqueIdType.TAGK: self.tag_names,
                UniqueIdType.TAGV: self.tag_values}[t]


def load_state(uid_maps: dict, series, config: Config | None = None,
               device=None, histograms=(), mesh=None) -> TSDB:
    """A TSDB holding the given state under the same UIDs.

    `uid_maps` is {kind: {name: uid}} for the kinds "metric", "tagk" and
    "tagv"; `series` yields (metric_uid, {tagk_uid: tagv_uid}, ts, fval,
    ival, isint) with the four numpy columns of one series (as
    Series.arrays() gives them); `histograms` yields (metric_uid,
    {tagk_uid: tagv_uid}, ts, points) with each point as (bounds[k, 2],
    counts[k], underflow, overflow) (as HistogramSeries.arrays() gives
    them), and needs `config` to configure histograms.  TSUIDs of the new
    TSDB match the source's.
    """
    tsdb = TSDB(config, device=device, mesh=mesh)
    for kind, mapping in uid_maps.items():
        tsdb.uid_table(kind).restore(mapping)

    def key_of(metric_uid, tags) -> SeriesKey:
        for kind, uid in [("metric", metric_uid), *(
                ("tagk", k) for k in tags), *(("tagv", v)
                                              for v in tags.values())]:
            tsdb.uid_table(kind).get_name(uid)   # raises on an unknown UID
        return SeriesKey.make(int(metric_uid),
                              {int(k): int(v) for k, v in tags.items()})

    for metric_uid, tags, ts, fval, ival, isint in series:
        tsdb.store.get_or_create_series(key_of(metric_uid, tags)) \
            .restore_arrays(
                np.asarray(ts, np.int64), np.asarray(fval, np.float64),
                np.asarray(ival, np.int64), np.asarray(isint, bool))
    for metric_uid, tags, ts, points in histograms:
        tsdb._require_histograms()
        tsdb.histogram_store.get_or_create_series(
            key_of(metric_uid, tags)).restore_arrays(ts, points)
    return tsdb

