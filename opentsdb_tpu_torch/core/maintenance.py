"""Background maintenance: the device series cache's refresh cadence, the
aggregate cache's promotions and the rollup lanes' builds.

A slim port of opentsdb_tpu/core/maintenance.py (``MaintenanceThread``, a
daemon thread ticking every ``TICK_SECONDS``).  Of the reference's passes
two have a subsystem in the port.  ``_maybe_refresh_device_cache``
(:122-136): a query on a metric whose entry went stale misses to the host
path and queues the metric, and this thread pays the snapshot and upload,
so that a metric taking writes regains hits without a request ever
waiting on a rebuild; the same pass uploads the aggregate cache's hot
blocks to its device tier (storage/agg_cache.py ``promote_pending``).
``_maybe_rollup`` (:162-175): every
``tsd.rollup.interval`` seconds one rollup-lane pass (storage/rollup.py
``refresh``: selection under the byte budget, then up to
``tsd.rollup.refresh_blocks`` block builds).  The compaction, WAL,
snapshot, self-report, autotune and health passes wait for their
subsystems.
"""

from __future__ import annotations

import logging
import threading
import time

LOG = logging.getLogger(__name__)


class MaintenanceThread(threading.Thread):
    """One daemon thread driving the port's periodic upkeep."""

    TICK_SECONDS = 0.5

    def __init__(self, tsdb):
        super().__init__(name="TSDB-maintenance", daemon=True)
        self.tsdb = tsdb
        self._stop_event = threading.Event()
        self.rollup_interval = tsdb.config.get_int("tsd.rollup.interval")
        self._next_rollup = time.monotonic() + max(self.rollup_interval, 1)
        self.device_cache_refreshes = 0
        self.rollup_passes = 0
        self.rollup_blocks_built = 0

    def run(self) -> None:
        while not self._stop_event.wait(self.TICK_SECONDS):
            try:
                self._maybe_refresh_device_cache()
                self._maybe_rollup(time.monotonic())
            except Exception:
                LOG.exception("maintenance pass failed")

    def stop(self) -> None:
        self._stop_event.set()
        if self.is_alive():
            self.join(timeout=5.0)

    def _maybe_refresh_device_cache(self) -> None:
        """Rebuild the device-cache entries that queries found stale, and
        mirror the aggregate blocks queued for the device tier (the
        reference's :135): both uploads are paid here, off the query
        path."""
        cache = self.tsdb.device_cache
        if cache is not None:
            self.device_cache_refreshes += cache.refresh()
        agg = self.tsdb.agg_cache
        if agg is not None:
            agg.promote_pending()

    def _maybe_rollup(self, now: float) -> None:
        """The tsd.rollup.interval cadence: one rollup-lane pass
        (0 disables it; lanes then build only through refresh())."""
        lanes = self.tsdb.rollup_lanes
        if lanes is None or self.rollup_interval <= 0 \
                or now < self._next_rollup:
            return
        self._next_rollup = now + self.rollup_interval
        built = lanes.refresh(self.tsdb.store)
        self.rollup_passes += 1
        self.rollup_blocks_built += built

    def collect_stats(self) -> dict[str, float]:
        return {"tsd.maintenance.device_cache_refreshes":
                float(self.device_cache_refreshes),
                "tsd.maintenance.rollup_passes": float(self.rollup_passes),
                "tsd.maintenance.rollup_blocks_built":
                float(self.rollup_blocks_built)}
