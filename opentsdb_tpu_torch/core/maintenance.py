"""Background maintenance: the device series cache's refresh cadence.

A slim port of opentsdb_tpu/core/maintenance.py (``MaintenanceThread``, a
daemon thread ticking every ``TICK_SECONDS``).  Of the reference's passes
only ``_maybe_refresh_device_cache`` (:122-136) has a subsystem in the
port: a query on a metric whose entry went stale misses to the host path
and queues the metric, and this thread pays the snapshot and upload, so
that a metric taking writes regains hits without a request ever waiting
on a rebuild.  The compaction, WAL, snapshot, self-report, autotune,
rollup and health passes wait for their subsystems.
"""

from __future__ import annotations

import logging
import threading

LOG = logging.getLogger(__name__)


class MaintenanceThread(threading.Thread):
    """One daemon thread driving the port's periodic upkeep."""

    TICK_SECONDS = 0.5

    def __init__(self, tsdb):
        super().__init__(name="TSDB-maintenance", daemon=True)
        self.tsdb = tsdb
        self._stop_event = threading.Event()
        self.device_cache_refreshes = 0

    def run(self) -> None:
        while not self._stop_event.wait(self.TICK_SECONDS):
            try:
                self._maybe_refresh_device_cache()
            except Exception:
                LOG.exception("maintenance pass failed")

    def stop(self) -> None:
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout=5.0)

    def _maybe_refresh_device_cache(self) -> None:
        """Rebuild the device-cache entries that queries found stale."""
        cache = self.tsdb.device_cache
        if cache is not None:
            self.device_cache_refreshes += cache.refresh()

    def collect_stats(self) -> dict[str, float]:
        return {"tsd.maintenance.device_cache_refreshes":
                float(self.device_cache_refreshes)}
