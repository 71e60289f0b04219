"""Columnar rollup storage: one MemStore per (interval, aggregator) lane.

Port of opentsdb_tpu/rollup/store.py.  The reference's rollup tables
tsdb-rollup-<interval> key cells by the raw row key with "agg:offset"
qualifiers (RollupUtils.buildRollupQualifier, RollupUtils.java:120-178),
beside pre-aggregate "-agg" tables.  Here each (interval, aggregator,
pre-aggregate) triple is its own MemStore keyed by the same SeriesKey, so
a query for `1h sum` reads one store and an avg read pairs the sum and
count lanes (Downsampler.java:155-210).  Interval-less pre-aggregates
(TSDB.addAggregatePointInternal with is_groupby) live under the raw
interval "".
"""

from __future__ import annotations

import threading

from opentsdb_tpu_torch.rollup.config import RollupConfig
from opentsdb_tpu_torch.storage.memstore import MemStore, SeriesKey


class RollupStore:
    """All rollup and pre-aggregate lanes of one TSDB."""

    def __init__(self, config: RollupConfig, salt_buckets: int = 20):
        self.config = config
        self.salt_buckets = salt_buckets
        # (interval, aggregator, pre_agg) -> lane  # guarded-by: _lock
        self._lanes: dict[tuple[str, str, bool], MemStore] = {}
        self._lock = threading.Lock()

    def lane(self, interval: str, aggregator: str,
             pre_agg: bool = False) -> MemStore:
        """The MemStore holding `aggregator` cells of `interval` rollups,
        made on first use."""
        aggregator = aggregator.lower()
        # Temporal rollup lanes must map to a configured aggregation id
        # (the qualifier codec); pre-aggregate lanes take any group-by
        # aggregator of the registry (TSDB.java:1536-1542).
        if not pre_agg and aggregator not in self.config.aggregation_ids:
            raise ValueError("No ID for aggregator: %s" % aggregator)
        key = (interval, aggregator, pre_agg)
        with self._lock:
            store = self._lanes.get(key)
            if store is None:
                store = MemStore(salt_buckets=self.salt_buckets)
                self._lanes[key] = store
            return store

    def peek_lane(self, interval: str, aggregator: str,
                  pre_agg: bool = False) -> MemStore | None:
        with self._lock:
            return self._lanes.get((interval, aggregator.lower(), pre_agg))

    def add_point(self, key: SeriesKey, interval: str, aggregator: str,
                  ts_ms: int, value, is_int: bool,
                  pre_agg: bool = False) -> None:
        self.lane(interval, aggregator, pre_agg).add_point(
            key, ts_ms, value, is_int)

    def lanes(self) -> list[tuple[str, str, bool]]:
        with self._lock:
            return sorted(self._lanes)
