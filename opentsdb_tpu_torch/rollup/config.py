"""Rollup interval registry and query-time rollup state.

The port's own copy of opentsdb_tpu/rollup/config.py (OpenTSDB
src/rollup/RollupConfig.java :60: forward/reverse interval maps, the
aggregation-ID registry, the best-match interval search :165-201;
RollupInterval.java :32: interval string, span, table names, the
default-interval flag, the SLA lag :331; RollupQuery.java :26: the
sampling-rate comparison :186 and the blackout window check :206).  The
default table of ``RollupConfig.from_config`` is the reference's 1m/1h/1d.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from opentsdb_tpu_torch.utils import datetime_util as DT

DEFAULT_AGGREGATION_IDS = {"sum": 0, "count": 1, "min": 2, "max": 3}


class NoSuchRollupForInterval(ValueError):
    """No rollup configured for the interval (NoSuchRollupForIntervalException)."""

    def __init__(self, interval: str):
        super().__init__("No rollup interval configured for '%s'" % interval)


class NoSuchRollupForTable(ValueError):
    """No rollup configured for the table (NoSuchRollupForTableException)."""

    def __init__(self, table: str):
        super().__init__("No rollup configured for table '%s'" % table)


@dataclass(frozen=True)
class RollupInterval:
    """One configured rollup granularity (RollupInterval.java:32).

    `table` / `pre_agg_table` keep the reference's two-table split: temporal
    rollups vs group-by pre-aggregates (getTemporalTable :260 /
    getGroupbyTable :271).  `row_span` survives as documentation of layout
    only — the columnar store has no row width.
    """
    interval: str                 # e.g. "1h"
    table: str                    # temporal rollup table name
    pre_agg_table: str            # group-by (pre-agg) table name
    row_span: str = "1d"
    default_interval: bool = False  # true = the raw tsdb table
    delay_sla_ms: int = 0         # getMaximumLag analog, ms of lag allowed

    @property
    def interval_ms(self) -> int:
        return DT.parse_duration(self.interval)

    @property
    def interval_seconds(self) -> int:
        return self.interval_ms // 1000

    @property
    def unit(self) -> str:
        return DT.get_duration_units(self.interval)

    @property
    def unit_multiplier(self) -> int:
        return DT.get_duration_interval(self.interval)

    @staticmethod
    def from_json(obj: dict) -> "RollupInterval":
        return RollupInterval(
            interval=obj["interval"],
            table=obj.get("table", "tsdb-rollup-%s" % obj["interval"]),
            pre_agg_table=obj.get(
                "preAggregationTable",
                obj.get("pre_agg_table", "tsdb-rollup-agg-%s" % obj["interval"])),
            row_span=obj.get("rowSpan", obj.get("row_span", "1d")),
            default_interval=bool(obj.get("defaultInterval",
                                          obj.get("default_interval", False))),
            delay_sla_ms=int(obj.get("delaySla",
                                     obj.get("delay_sla_ms", 0))))

    def to_json(self) -> dict:
        return {
            "interval": self.interval,
            "table": self.table,
            "preAggregationTable": self.pre_agg_table,
            "rowSpan": self.row_span,
            "defaultInterval": self.default_interval,
            "delaySla": self.delay_sla_ms,
        }


@dataclass
class RollupConfig:
    """Registry of rollup intervals + the aggregator-ID map (RollupConfig.java:60)."""
    intervals: list[RollupInterval] = field(default_factory=list)
    aggregation_ids: dict[str, int] = field(
        default_factory=lambda: dict(DEFAULT_AGGREGATION_IDS))

    def __post_init__(self):
        self._forward: dict[str, RollupInterval] = {}
        self._by_table: dict[str, RollupInterval] = {}
        for ri in self.intervals:
            if ri.interval in self._forward:
                raise ValueError("Duplicate rollup interval: %s" % ri.interval)
            self._forward[ri.interval] = ri
            self._by_table[ri.table] = ri
            self._by_table[ri.pre_agg_table] = ri
        ids = set()
        for name, agg_id in self.aggregation_ids.items():
            if agg_id in ids:
                raise ValueError("Duplicate aggregation id: %d" % agg_id)
            if not 0 <= agg_id <= 127:
                raise ValueError("Aggregation id out of range: %d" % agg_id)
            ids.add(agg_id)

    # -- lookups (RollupConfig.getRollupInterval :140/:165) --

    def get_rollup_interval(self, interval: str) -> RollupInterval:
        if not interval:
            raise ValueError("Interval cannot be null or empty")
        ri = self._forward.get(interval)
        if ri is None:
            raise NoSuchRollupForInterval(interval)
        return ri

    def get_best_matches_ms(self, interval_ms: int) -> list[RollupInterval]:
        """All intervals evenly dividing the request, widest first.

        Mirrors getRollupInterval(long,String) :165-201: an exact match plus
        every coarser-compatible fallback, reverse-ordered so [0] is the best
        table to try and the rest back it up on empty results.  Millisecond
        math so sub-second downsample intervals never select a table whose
        cells straddle the window edges.
        """
        if interval_ms <= 0:
            raise ValueError("Interval must be positive")
        out = []
        for ri in self._forward.values():
            ms = ri.interval_ms
            if ms > 0 and interval_ms % ms == 0:
                out.append(ri)
        if not out:
            raise NoSuchRollupForInterval("%dms" % interval_ms)
        out.sort(key=lambda r: r.interval_ms, reverse=True)
        return out

    def get_best_matches(self, interval_seconds: int) -> list[RollupInterval]:
        """Seconds-granularity wrapper (the reference API's unit)."""
        return self.get_best_matches_ms(interval_seconds * 1000)

    def get_rollup_interval_for_table(self, table: str) -> RollupInterval:
        ri = self._by_table.get(table)
        if ri is None:
            raise NoSuchRollupForTable(table)
        return ri

    # -- aggregator ids (RollupConfig.getIdForAggregator :279) --

    def get_id_for_aggregator(self, aggregator: str) -> int:
        try:
            return self.aggregation_ids[aggregator.lower()]
        except KeyError:
            raise ValueError("No ID for aggregator: %s" % aggregator)

    def get_aggregator_for_id(self, agg_id: int) -> str:
        for name, i in self.aggregation_ids.items():
            if i == agg_id:
                return name
        raise ValueError("No aggregator mapped to ID: %d" % agg_id)

    # -- construction --

    @staticmethod
    def from_json(text_or_obj) -> "RollupConfig":
        obj = (json.loads(text_or_obj) if isinstance(text_or_obj, str)
               else text_or_obj)
        intervals = [RollupInterval.from_json(i)
                     for i in obj.get("intervals", [])]
        agg_ids = {k.lower(): int(v)
                   for k, v in obj.get("aggregationIds",
                                       DEFAULT_AGGREGATION_IDS).items()}
        return RollupConfig(intervals=intervals, aggregation_ids=agg_ids)

    @staticmethod
    def from_config(config) -> "RollupConfig | None":
        """Load from tsd.rollups.config (a path or inline JSON), if enabled."""
        if not config.get_bool("tsd.rollups.enable"):
            return None
        raw = config.get_string("tsd.rollups.config")
        if not raw:
            return RollupConfig(intervals=[
                RollupInterval("1m", "tsdb-rollup-1m", "tsdb-rollup-agg-1m",
                               row_span="1h"),
                RollupInterval("1h", "tsdb-rollup-1h", "tsdb-rollup-agg-1h",
                               row_span="1d"),
                RollupInterval("1d", "tsdb-rollup-1d", "tsdb-rollup-agg-1d",
                               row_span="1n"),
            ])
        if raw.lstrip().startswith("{"):
            return RollupConfig.from_json(raw)
        with open(raw) as fh:
            return RollupConfig.from_json(fh.read())

    def to_json(self) -> dict:
        return {"aggregationIds": dict(self.aggregation_ids),
                "intervals": [i.to_json() for i in self.intervals]}


@dataclass
class RollupQuery:
    """Query-time rollup selection (RollupQuery.java:26)."""
    rollup_interval: RollupInterval
    rollup_agg: str               # function applied inside the rollup cells
    sample_interval_ms: int       # the user's downsample interval
    group_by: str = "sum"         # cross-series aggregator

    def is_lower_sampling_rate(self) -> bool:
        """True when the rollup cells are finer than the requested interval
        (RollupQuery.isLowerSamplingRate :186) — a downsample pass is still
        needed on top of the rollup data."""
        return self.rollup_interval.interval_ms < self.sample_interval_ms

    def last_guaranteed_ms(self, now_ms: int) -> int:
        """Latest timestamp the rollup table is SLA-guaranteed to cover."""
        return now_ms - self.rollup_interval.delay_sla_ms

    def is_in_blackout(self, ts_ms: int, now_ms: int) -> bool:
        """RollupQuery.isInBlackoutPeriod (:206)."""
        if self.rollup_interval.delay_sla_ms <= 0:
            return False
        return ts_ms > self.last_guaranteed_ms(now_ms)
