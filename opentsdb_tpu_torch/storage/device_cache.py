"""Device series cache: each hot metric's columns held on the device.

Port of opentsdb_tpu/storage/device_cache.py (``DeviceSeriesCache``, the
analog of the HBase BlockCache that made repeated scans of hot rows
memory-speed).  The store lives in host memory and the card across a PCIe
link, so a repeated grouped query would otherwise build and copy the same
[S, N] batch every time.  The cache copies each metric's columns to the
device once; a later query gathers its batch there with one launch of G1
(``gather_windows``, csrc/gather_windows.cu), and only the per-series
start and length vectors cross the link.

* One entry per (store, metric): every series' normalized (ts, val)
  columns concatenated into two 1-D device buffers, plus host row offsets.
* Consistency is by content version (``Series.version``): ``snapshot``
  takes (data, version) under one lock hold, and at query time
  ``window_bounds`` takes (lo, hi, version) under one lock hold.  A series
  that is not the snapshotted object, or whose version moved, makes the
  request a miss: the caller takes its host path and the entry waits
  for ``refresh``, which the maintenance thread (core/maintenance.py)
  calls off the query path.
* Byte-budgeted LRU (``tsd.query.device_cache.mb``); a metric larger than
  the budget or than ``build_max_points`` is never cached, and a gather
  whose [S, N] batch would exceed ``batch_mb`` declines.

Only the float lane is cached, as in the reference: the downsample
kernels convert every value to float64, so a hit gives the answer a miss
gives.

With a ``ts_base`` (the planner's ``precompact_base`` of a fixed grid
that spans less than 2^31 ms) the gather writes the batch's timestamps as
int32 offsets from the base, the pads at ``I32_PAD_TS`` (G1's int32 form,
the reference's :443-483), and K1 and K4 read them in their int32 forms:
13 bytes a slot instead of 17, and the batch budget prices it so.

Differences from the reference: the buffers hold exactly the metric's
points (no power-of-two padding, 16 B a point) and a batch's N is the
longest requested run, the N that ops.pipeline.build_batch_direct gives;
the prometheus counters (slice 8d) are not ported.  ``peek`` answers
explain's "warm or cold" without touching anything.  A query that streams (the planner's streamed route) does not
build a cold entry inline: it queues the build for ``refresh``, as the
reference does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.downsample import I32_PAD_TS
from opentsdb_tpu_torch.ops.pipeline import PAD_TS

_BYTES_PER_POINT = 16    # int64 ts + float64 val
# ts + val + mask of a gathered batch slot: 8 + 8 + 1, or 4 + 8 + 1 with
# int32 offsets; the budget must not decline a batch the smaller layout
# fits
_BATCH_BYTES_PER_POINT = 17
_BATCH_BYTES_PER_POINT_I32 = 13
_MAX_REBUILDS = 4    # stale entries one refresh pass rebuilds


@dataclass
class _Entry:
    store: object      # the MemStore snapshotted; entries are keyed by
    #                    (id(store), metric), and this strong reference
    #                    keeps id(store) stable
    metric: int
    row: dict          # SeriesKey -> row index
    series_objs: list  # row -> the Series object snapshotted: a deleted and
    #                    recreated series has an equal key and a restarted
    #                    version, and must not validate
    versions: list     # row -> version at snapshot
    offsets: np.ndarray  # [S + 1] int64 start offsets into the buffers
    ts_dev: torch.Tensor   # [P] int64 on the device
    val_dev: torch.Tensor  # [P] float64 on the device
    nbytes: int = 0
    tick: int = 0      # LRU clock


class DeviceSeriesCache:
    """Byte-budgeted, version-validated device cache of metric columns."""

    def __init__(self, max_bytes: int, build_max_points: int = 200_000_000,
                 *, device, fix_duplicates: bool = True,
                 batch_max_bytes: int = 6 << 30):
        self.max_bytes = int(max_bytes)
        self.build_max_points = int(build_max_points)
        # the gather expands the packed buffers to an [S, N] batch, which
        # row-length skew can make much larger than the entry
        self.batch_max_bytes = int(batch_max_bytes)
        # snapshots and consults read with the store's own duplicate
        # policy: with fix_duplicates off a build over duplicate data fails
        # and leaves the duplicate in place for fsck
        self.fix_duplicates = bool(fix_duplicates)
        # the buffers' device; a CPU cache gathers with the plain version
        self.device = torch.device(device)
        self._entries: dict[tuple, _Entry] = {}  # guarded-by: _lock
        # key -> the store to rebuild it from  # guarded-by: _lock
        self._stale: dict[tuple, object] = {}
        self._building: set[tuple] = set()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._tick = 0  # guarded-by: _lock
        # guarded-by: _lock
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- query path ------------------------------------------------------

    def batch_for(self, store, metric: int, series_list, start_ms: int,
                  end_ms: int, build: bool = True,
                  ts_base: int | None = None):
        """Device (ts[S, N], val[S, N], mask[S, N]) of the series' windows
        in [start_ms, end_ms], or None on a miss (stale, a series the entry
        does not hold, unresolved duplicates, over budget, or a cold entry
        that another query is building): the caller then takes its host
        path.  A cold entry is built inline, or with `build=False` queued
        for ``refresh`` and counted a miss: the streamed route passes it,
        since its chunks overlap copies with the folds and a blocking
        upload of the whole metric first would cost more.  With `ts_base`
        the timestamps come as int32 offsets from it (gather_windows)."""
        ekey = (id(store), metric)
        with self._lock:
            entry = self._entries.get(ekey)
        if entry is None:
            if not build:
                with self._lock:
                    self._stale[ekey] = store
                self._count("misses")
                return None
            entry = self._build(store, metric)
            if entry is None:
                self._count("misses")
                return None
        s = len(series_list)
        starts = np.empty(s, np.int64)
        lengths = np.empty(s, np.int64)
        for i, series in enumerate(series_list):
            row = entry.row.get(series.key)
            if row is None or entry.series_objs[row] is not series:
                # born after the snapshot, or deleted and recreated under
                # the same key: the snapshot is invalid either way
                self._mark_stale(ekey, entry)
                self._count("misses")
                return None
            try:
                lo, hi, version = series.window_bounds(
                    start_ms, end_ms, self.fix_duplicates)
            except ValueError:
                self._count("misses")
                return None     # unresolved duplicates: the host path raises
            if version != entry.versions[row]:
                self._mark_stale(ekey, entry)
                self._count("misses")
                return None
            starts[i] = entry.offsets[row] + lo
            lengths[i] = hi - lo
        n = int(lengths.max(initial=0))
        per_point = (_BATCH_BYTES_PER_POINT if ts_base is None
                     else _BATCH_BYTES_PER_POINT_I32)
        if s * n * per_point > self.batch_max_bytes:
            self._count("misses")
            return None
        with self._lock:
            self._tick += 1
            entry.tick = self._tick
            self.hits += 1
        # starts and lengths travel in one copy
        runs = torch.from_numpy(np.stack([starts, lengths])).to(self.device)
        return gather_windows(entry.ts_dev, entry.val_dev, runs[0], runs[1],
                              n, ts_base)

    def peek(self, store, metric: int, series_list, start_ms: int,
             end_ms: int, build: bool = True,
             ts_base: int | None = None) -> bool:
        """Whether ``batch_for`` would answer this request with a device
        batch, as of now, read-only (the reference's :208): no build, no
        gather, no staleness mark, no queued build, no hit or miss, no
        LRU touch.  Explain's arm of the routing verdict.  A cold entry
        with `build` is predicted from the inline build's preconditions
        (no build running, the metric's point and byte budgets) without
        a snapshot; duplicates are found by the same ``window_bounds``
        probe ``batch_for`` makes."""
        ekey = (id(store), metric)
        with self._lock:
            entry = self._entries.get(ekey)
            building = ekey in self._building
        if entry is None:
            if not build or building:
                return False
            series_objs = store.series_for_metric(metric)
            total = sum(len(s) for s in series_objs)
            if not series_objs or total > self.build_max_points \
                    or total * _BYTES_PER_POINT > self.max_bytes:
                return False
            rows = {s.key: s for s in series_objs}
            resolve = rows.get
        else:
            def resolve(key):
                row = entry.row.get(key)
                return None if row is None else entry.series_objs[row]
        n = 0
        for series in series_list:
            if resolve(series.key) is not series:
                return False
            try:
                lo, hi, version = series.window_bounds(
                    start_ms, end_ms, self.fix_duplicates)
            except ValueError:
                return False
            if entry is not None \
                    and version != entry.versions[entry.row[series.key]]:
                return False
            n = max(n, hi - lo)
        per_point = (_BATCH_BYTES_PER_POINT if ts_base is None
                     else _BATCH_BYTES_PER_POINT_I32)
        return len(series_list) * n * per_point <= self.batch_max_bytes

    def holds(self, store, metric: int) -> bool:
        """Whether the metric's entry is on the device and not queued for
        a rebuild: a consult would gather rather than build (the
        aggregate cache prices its plans by it).  Series versions are
        checked by ``batch_for`` alone."""
        ekey = (id(store), metric)
        with self._lock:
            return ekey in self._entries and ekey not in self._stale

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def _mark_stale(self, ekey: tuple, entry: _Entry) -> None:
        with self._lock:
            self._stale[ekey] = entry.store

    # -- build / refresh -------------------------------------------------

    def _build(self, store, metric: int):
        """Snapshot every series of `metric` into device buffers.  At most
        one build per (store, metric) runs at a time: a concurrent query on
        the same cold metric misses at once instead of paying the snapshot
        and upload again, and a query that saw no entry just before another
        one's build landed takes that entry."""
        ekey = (id(store), metric)
        with self._lock:
            entry = self._entries.get(ekey)
            if entry is not None:
                return entry
            if ekey in self._building:
                return None
            self._building.add(ekey)
        try:
            return self._build_guarded(store, metric)
        finally:
            with self._lock:
                self._building.discard(ekey)

    def _build_guarded(self, store, metric: int):
        series_list = store.series_for_metric(metric)
        if not series_list:
            return None
        total = sum(len(s) for s in series_list)
        if total > self.build_max_points \
                or total * _BYTES_PER_POINT > self.max_bytes:
            return None
        # each series' columns go straight from the store's buffers to
        # the device inside its snapshot's lock hold, then one device-side
        # concatenation packs them: no host copy of the metric is made
        parts_ts, parts_val, versions, row = [], [], [], {}
        offsets = np.zeros(len(series_list) + 1, np.int64)
        try:
            for i, series in enumerate(series_list):
                ts, val, version = series.snapshot(self.fix_duplicates,
                                                   self._upload)
                parts_ts.append(ts)
                parts_val.append(val)
                versions.append(version)
                row[series.key] = i
                offsets[i + 1] = offsets[i] + len(ts)
        except ValueError:
            return None     # duplicate data waiting for fsck: not cached
        ts_dev, val_dev = torch.cat(parts_ts), torch.cat(parts_val)
        del parts_ts, parts_val
        entry = _Entry(store=store, metric=metric, row=row,
                       series_objs=series_list, versions=versions,
                       offsets=offsets, ts_dev=ts_dev, val_dev=val_dev,
                       nbytes=int(offsets[-1]) * _BYTES_PER_POINT)
        ekey = (id(store), metric)
        with self._lock:
            self._evict_for_locked(entry.nbytes)
            self._tick += 1
            entry.tick = self._tick
            self._entries[ekey] = entry
            self._stale.pop(ekey, None)
            self.builds += 1
        return entry

    def _upload(self, column: np.ndarray) -> torch.Tensor:
        """A copy of `column` on the cache's device (a pageable copy to a
        card returns once the data has left the host buffer)."""
        return torch.from_numpy(column).to(self.device, copy=True)

    def _evict_for_locked(self, incoming_bytes: int) -> None:
        used = sum(e.nbytes for e in self._entries.values())
        while self._entries and used + incoming_bytes > self.max_bytes:
            victim = min(self._entries.values(), key=lambda e: e.tick)
            self._entries.pop((id(victim.store), victim.metric))
            used -= victim.nbytes
            self.evictions += 1

    def refresh(self) -> int:
        """Rebuild up to _MAX_REBUILDS stale entries, each from the store
        it was read from; returns how many were rebuilt.  The maintenance
        thread's pass: it pays the snapshot and upload, so a query only
        ever meets a hit or a miss."""
        with self._lock:
            pending = list(self._stale.items())[:_MAX_REBUILDS]
            for ekey, _ in pending:
                self._stale.pop(ekey, None)
                self._entries.pop(ekey, None)
        done = 0
        for (_, metric), st in pending:
            if self._build(st, metric) is not None:
                done += 1
        return done

    def invalidate(self, metric: int | None = None) -> None:
        """Drop one metric's entries, or every entry."""
        with self._lock:
            if metric is None:
                self._entries.clear()
                self._stale.clear()
            else:
                for ekey in [k for k in self._entries if k[1] == metric]:
                    self._entries.pop(ekey, None)
                for ekey in [k for k in self._stale if k[1] == metric]:
                    self._stale.pop(ekey, None)

    def collect_stats(self) -> dict:
        return {
            "tsd.query.device_cache.hits": float(self.hits),
            "tsd.query.device_cache.misses": float(self.misses),
            "tsd.query.device_cache.builds": float(self.builds),
            "tsd.query.device_cache.evictions": float(self.evictions),
            "tsd.query.device_cache.entries": float(len(self)),
            "tsd.query.device_cache.bytes": float(self.bytes_used),
        }


# shape: ts_buf[P] i64, val_buf[P] f64, starts[S] i64, lengths[S] i64
# shape: -> ([S,N] i64|i32, [S,N] f64, [S,N] bool)
def gather_windows(ts_buf: torch.Tensor, val_buf: torch.Tensor,
                   starts: torch.Tensor, lengths: torch.Tensor, n: int,
                   ts_base: int | None = None):
    """G1 -> (ts[S, N], val[S, N], mask[S, N]): row i holds the buffers'
    points [starts[i], starts[i] + lengths[i]) as a prefix, the rest
    PAD_TS and 0.0 with the mask off.  Buffer indexes are clamped to
    [0, P - 1], as the reference clamps them.  With `ts_base`, ts is int32
    offsets clip(ts - ts_base, 0, I32_PAD_TS) and the pads I32_PAD_TS.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_gather(ts_buf, val_buf, starts, lengths, n)
    if ts_buf.device.type == "cpu":
        return gather_windows_plain(ts_buf, val_buf, starts, lengths, n,
                                    ts_base)
    dev = kernels.require_cuda(ts_buf, val_buf, starts, lengths)
    s, p = starts.numel(), ts_buf.numel()
    if p == 0:
        return _pads(s, n, dev, ts_base)
    i32 = ts_base is not None
    out_ts = torch.empty((s, n), dtype=torch.int32 if i32 else torch.int64,
                         device=dev)
    out_val = torch.empty((s, n), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, n), dtype=torch.bool, device=dev)
    if s == 0 or n == 0:
        return out_ts, out_val, out_mask
    kernels.launch(
        "gather_windows", dev, kernels.ptr(ts_buf), kernels.ptr(val_buf), p,
        kernels.ptr(starts), kernels.ptr(lengths), s, n,
        int(ts_base) if i32 else 0, int(i32), kernels.ptr(out_ts),
        kernels.ptr(out_val), kernels.ptr(out_mask), i32=i32)
    return out_ts, out_val, out_mask


def gather_windows_plain(ts_buf: torch.Tensor, val_buf: torch.Tensor,
                         starts: torch.Tensor, lengths: torch.Tensor, n: int,
                         ts_base: int | None = None):
    """Plain PyTorch version of G1, the reference's algorithm: an [S, N]
    index grid, clamped, gathered, and masked to each row's length; with
    `ts_base` the timestamps re-based, clipped and cast to int32."""
    s, p = starts.numel(), ts_buf.numel()
    dev = ts_buf.device
    if p == 0:
        return _pads(s, n, dev, ts_base)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    idx = (starts[:, None] + j[None, :]).clamp(0, p - 1)
    mask = j[None, :] < lengths[:, None]
    if ts_base is None:
        ts = torch.where(mask, ts_buf[idx], PAD_TS)
    else:
        off = (ts_buf[idx] - int(ts_base)).clamp(0, I32_PAD_TS)
        ts = torch.where(mask, off, I32_PAD_TS).to(torch.int32)
    val = torch.where(mask, val_buf[idx], 0.0)
    return ts, val, mask


def _pads(s: int, n: int, dev, ts_base: int | None = None):
    if ts_base is None:
        ts = torch.full((s, n), PAD_TS, dtype=torch.int64, device=dev)
    else:
        ts = torch.full((s, n), I32_PAD_TS, dtype=torch.int32, device=dev)
    return (ts, torch.zeros((s, n), dtype=torch.float64, device=dev),
            torch.zeros((s, n), dtype=torch.bool, device=dev))


def _check_gather(ts_buf, val_buf, starts, lengths, n) -> None:
    if ts_buf.dim() != 1 or val_buf.shape != ts_buf.shape \
            or starts.dim() != 1 or lengths.shape != starts.shape or n < 0:
        raise ValueError("gather_windows takes buffers [P], starts and "
                         "lengths [S] and N >= 0")
    if ts_buf.dtype != torch.int64 or val_buf.dtype != torch.float64 \
            or starts.dtype != torch.int64 or lengths.dtype != torch.int64:
        raise TypeError("gather_windows takes ts_buf int64, val_buf float64, "
                        "starts and lengths int64")
