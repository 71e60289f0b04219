"""Written rollups: the interval table, the lanes and the rollup job.

Port of opentsdb_tpu/rollup/ (OpenTSDB src/rollup/: RollupConfig.java,
RollupInterval.java, RollupQuery.java; RollupUtils.java's qualifier codec
is replaced by one columnar store per (interval, aggregator) lane).
"""

from opentsdb_tpu_torch.rollup.config import (
    RollupInterval, RollupConfig, RollupQuery,
    NoSuchRollupForInterval, NoSuchRollupForTable)
from opentsdb_tpu_torch.rollup.store import RollupStore

__all__ = ["RollupInterval", "RollupConfig", "RollupQuery", "RollupStore",
           "NoSuchRollupForInterval", "NoSuchRollupForTable"]
