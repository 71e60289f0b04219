"""Bounded partial-aggregate spill pool: a host-RAM ring with disk overflow.

Port of opentsdb_tpu/storage/spill.py (numpy only, as the reference's).
The out-of-core tiled executor (ops/tiling.py) finishes one series tile
at a time and parks each tile's [S_tile, W] partial grids here until the
window-striped replay reads them back.  Two byte-budgeted tiers:

  host tier   numpy arrays in an insertion-ordered ring, budgeted by
              ``tsd.query.spill.host_mb``.  New entries land here; when
              the ring overflows, the NEWEST entries demote to disk.
              Entries are written tile-major and replayed stripe-major,
              so the oldest surviving entry is among the next to be read
              and the newest is read last: the replay starts from RAM
              and takes its disk reads at the tail.
  disk tier   one ``.npy`` file per array under ``tsd.query.spill.dir``
              (a private temp directory when unset, removed by
              ``close``), budgeted by ``tsd.query.spill.disk_mb``.  Reads
              memory-map, so a window stripe's column slice reads about
              its own bytes.

Capacity is a refusal, not an out-of-memory: ``put`` raises
``SpillCapacityError`` when an entry cannot fit after demoting all it
can, and ``SpillWriteError`` when a disk write fails.  The executor turns
either into the query's 413 or 503 and releases what the query pooled; a
failed spill never wedges the pool for later queries.

Deliberate differences from the reference: no ``spill.write`` fault site
(utils/faults.py is ported with durability; tests make a write fail by
patching ``SpillPool._write_array``), and the counters and gauges are
tallies read by ``collect_stats`` rather than prometheus metrics.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading

import numpy as np

LOG = logging.getLogger(__name__)


class SpillError(Exception):
    """The spill pool could not hold or produce an entry."""


class SpillCapacityError(SpillError):
    """An entry exceeds what the pool's host and disk budgets can hold."""


class SpillWriteError(SpillError):
    """The disk tier failed mid-write (disk full, an I/O error)."""


def open_spill_file(path: str, mode: str = "wb"):
    """Open one disk-tier file; the caller closes it or hands it on."""
    return open(path, mode)


class SpillPool:
    """Byte-budgeted two-tier store of numpy array tuples.

    Thread-safe.  The accounting and the ring and file tables live under
    one lock; disk writes run outside it on the demoting thread, and the
    entry stays readable from RAM (and is not demoted again) until its
    files are complete, so a concurrent ``get`` never falls between the
    tiers or reads a half-written file."""

    def __init__(self, host_budget_bytes: int, disk_budget_bytes: int,
                 directory: str | None = None):
        self._lock = threading.Lock()
        self.host_budget = max(int(host_budget_bytes), 0)
        self.disk_budget = max(int(disk_budget_bytes), 0)
        self._configured_dir = directory or None
        self._dir: str | None = None       # guarded-by: _lock
        self._own_dir = False              # guarded-by: _lock
        self._next_key = 0                 # guarded-by: _lock
        # key -> tuple of arrays, oldest first (dict insertion order)
        self._host: dict[int, tuple] = {}  # guarded-by: _lock
        # key -> the entry's file paths, one an array
        self._files: dict[int, list] = {}  # guarded-by: _lock
        self._bytes: dict[int, int] = {}   # guarded-by: _lock
        # keys mid-demotion: still readable from RAM, not demoted again
        self._demoting: set[int] = set()   # guarded-by: _lock
        self.host_bytes = 0                # guarded-by: _lock
        self.disk_bytes = 0                # guarded-by: _lock
        self._closed = False               # guarded-by: _lock
        # tallies for collect_stats  # guarded-by: _lock
        self.spills = {"host": 0, "disk": 0}
        self.evictions = 0
        self.reads = 0
        self.invalidations = 0
        self.write_errors = 0

    # -- tiers ------------------------------------------------------------

    def _ensure_dir_locked(self) -> str:
        if self._dir is None:
            if self._configured_dir:
                os.makedirs(self._configured_dir, exist_ok=True)
                self._dir = self._configured_dir
            else:
                self._dir = tempfile.mkdtemp(prefix="tsdb_spill_")
                self._own_dir = True
        return self._dir

    @staticmethod
    def _write_array(path: str, a: np.ndarray) -> None:
        """Write one array of an entry to the disk tier."""
        fh = open_spill_file(path)
        try:
            np.save(fh, a)
        finally:
            fh.close()

    def _write_entry(self, directory: str, key: int, arrays: tuple) -> list:
        """Write one entry's arrays to the disk tier -> their paths.  On an
        OS error its partial files are removed and SpillWriteError
        raised."""
        paths = []
        try:
            for i, a in enumerate(arrays):
                path = os.path.join(directory, "spill_%d_%d.npy" % (key, i))
                self._write_array(path, a)
                paths.append(path)
        except OSError as e:
            for p in paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            with self._lock:
                self.write_errors += 1
            raise SpillWriteError("spill write failed: %s" % e) from e
        return paths

    def _demote_one(self) -> bool:
        """Move the NEWEST demotable host entry to disk; False when none
        can move.  The entry stays readable from RAM until its files are
        complete."""
        with self._lock:
            key = next((k for k in reversed(self._host)
                        if k not in self._demoting), None)
            if key is None:
                return False
            arrays = self._host[key]
            nbytes = self._bytes[key]
            if self.disk_budget <= 0 \
                    or self.disk_bytes + nbytes > self.disk_budget:
                return False
            directory = self._ensure_dir_locked()
            self.disk_bytes += nbytes          # reserved before the write
            self._demoting.add(key)
        try:
            paths = self._write_entry(directory, key, arrays)
        except SpillWriteError:
            with self._lock:
                self.disk_bytes -= nbytes
                self._demoting.discard(key)
            raise
        with self._lock:
            self._demoting.discard(key)
            if self._host.pop(key, None) is None:
                # freed meanwhile: the files are garbage now
                self.disk_bytes -= nbytes
                stale = paths
            else:
                self.host_bytes -= nbytes
                self._files[key] = paths
                self.evictions += 1
                self.spills["disk"] += 1
                stale = ()
        for p in stale:
            try:
                os.unlink(p)
            except OSError:
                pass
        return True

    # -- the API ----------------------------------------------------------

    def put(self, arrays: tuple) -> int:
        """Pool one entry (a tuple of numpy arrays) -> its key.  It lands
        in the host ring, and newer entries demote to disk until the ring
        fits its budget.  Raises SpillCapacityError when the budgets
        cannot hold it and SpillWriteError when the disk tier fails."""
        arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        nbytes = int(sum(a.nbytes for a in arrays))
        with self._lock:
            if self._closed:
                raise SpillError("spill pool is closed")
            if nbytes > max(self.host_budget, self.disk_budget):
                raise SpillCapacityError(
                    "spill entry of %d bytes exceeds every tier budget "
                    "(host %d, disk %d)" % (nbytes, self.host_budget,
                                            self.disk_budget))
            key = self._next_key
            self._next_key += 1
            self._host[key] = arrays
            self._bytes[key] = nbytes
            self.host_bytes += nbytes
            self.spills["host"] += 1
        while True:
            with self._lock:
                over = self.host_bytes > self.host_budget
            if not over:
                return key
            try:
                demoted = self._demote_one()
            except SpillWriteError:
                # the caller gets no key for this entry, so it must not
                # stay pooled
                self.free(key)
                raise
            if not demoted:
                self.free(key)
                raise SpillCapacityError(
                    "spill pool over budget: host %d/%d disk %d/%d bytes"
                    % (self.host_bytes, self.host_budget, self.disk_bytes,
                       self.disk_budget))

    def get(self, key: int, col_lo: int | None = None,
            col_hi: int | None = None) -> tuple:
        """An entry's arrays, or with col_lo/col_hi the [:, col_lo:col_hi]
        slice of each 2-D array (a window stripe).  A disk-tier entry is
        memory-mapped, so a slice reads about its own bytes."""
        with self._lock:
            arrays = self._host.get(key)
            paths = self._files.get(key)
            if arrays is None and paths is not None:
                self.reads += 1
        if arrays is None and paths is None:
            raise KeyError("no spill entry %d" % key)
        out = []
        if arrays is not None:
            for a in arrays:
                if col_lo is not None and a.ndim == 2:
                    a = a[:, col_lo:col_hi]
                out.append(a)
            return tuple(out)
        for p in paths:
            a = np.load(p, mmap_mode="r")
            if col_lo is not None and a.ndim == 2:
                a = a[:, col_lo:col_hi]
            out.append(np.ascontiguousarray(a))
        return tuple(out)

    def free(self, key: int) -> None:
        """Release one entry from both tiers; idempotent."""
        with self._lock:
            arrays = self._host.pop(key, None)
            paths = self._files.pop(key, None)
            nbytes = self._bytes.pop(key, 0)
            if arrays is not None:
                self.host_bytes -= nbytes
            elif paths is not None:
                self.disk_bytes -= nbytes
            if arrays is not None or paths is not None:
                self.invalidations += 1
        for p in paths or ():
            try:
                os.unlink(p)
            except OSError:
                pass

    def release(self, keys) -> None:
        """Free a batch of keys (a query's cleanup)."""
        for key in keys:
            self.free(key)

    def stats(self) -> dict:
        with self._lock:
            return {"host_bytes": self.host_bytes,
                    "disk_bytes": self.disk_bytes,
                    "host_entries": len(self._host),
                    "disk_entries": len(self._files)}

    def collect_stats(self) -> dict:
        """The reference's tsd.query.spill.* gauges and counters as
        tallies."""
        with self._lock:
            return {
                "tsd.query.spill.bytes.host": float(self.host_bytes),
                "tsd.query.spill.bytes.disk": float(self.disk_bytes),
                "tsd.query.spill.entries.host": float(len(self._host)),
                "tsd.query.spill.entries.disk": float(len(self._files)),
                "tsd.query.spill.spills.host": float(self.spills["host"]),
                "tsd.query.spill.spills.disk": float(self.spills["disk"]),
                "tsd.query.spill.evictions": float(self.evictions),
                "tsd.query.spill.reads": float(self.reads),
                "tsd.query.spill.invalidations": float(self.invalidations),
                "tsd.query.spill.write_errors": float(self.write_errors),
            }

    def close(self) -> None:
        """Drop every entry and the private temp directory."""
        with self._lock:
            self._closed = True
            keys = list(self._host) + list(self._files)
        self.release(keys)
        with self._lock:
            own_dir = self._own_dir and self._dir
            directory, self._dir = self._dir, None
            self._own_dir = False
        if own_dir:
            try:
                os.rmdir(directory)
            except OSError:
                pass
