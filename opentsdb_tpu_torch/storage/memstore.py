"""Columnar in-memory series store: the port's copy of the write and
read surface of opentsdb_tpu's storage/memstore.py.

Series are identified by (metric_uid, sorted (tagk, tagv) uid pairs) and
hold int64 ms timestamps, float64 values, exact int64 values and an
int-ness bitmask in growable numpy buffers.  Out-of-order and duplicate
points are normalized lazily at read time (sort + last-write-wins dedup),
as the reference does.  The store lives on the host: a query copies its
window into one padded [S, N] batch and moves that to the device
(ops/pipeline.build_batch_direct), unless the device series cache
(storage/device_cache.py) holds the metric's columns already, or the
query streams and reads its window chunk by chunk (``window_chunk``).
Each
series carries a content version that every visible mutation bumps; the
cache validates its snapshots by it; the rollup lanes hear of every
write through the store's mutation listeners.  No WAL and no
persistence.
"""

from __future__ import annotations

import itertools
import threading
import zlib
from dataclasses import dataclass

import numpy as np

MAX_NUM_TAGS = 8        # Const.java:28


@dataclass(frozen=True)
class SeriesKey:
    """Logical identity of one time series: metric UID + sorted tag UID pairs."""
    metric: int
    tags: tuple[tuple[int, int], ...]  # sorted (tagk_uid, tagv_uid)

    @staticmethod
    def make(metric: int, tags: dict[int, int]) -> "SeriesKey":
        return SeriesKey(metric, tuple(sorted(tags.items())))

    def tsuid(self, metric_width: int = 3, tagk_width: int = 3,
              tagv_width: int = 3) -> str:
        """Hex TSUID: metric + tagk/tagv pairs (UniqueId.getTSUIDFromKey)."""
        out = [self.metric.to_bytes(metric_width, "big").hex()]
        for k, v in self.tags:
            out.append(k.to_bytes(tagk_width, "big").hex())
            out.append(v.to_bytes(tagv_width, "big").hex())
        return "".join(out).upper()

    def salt(self, buckets: int = 20) -> int:
        """Deterministic shard id, the salt-bucket equivalent (RowKey.java:141)."""
        h = zlib.crc32(repr((self.metric, self.tags)).encode())
        return h % buckets


class Series:
    """One series' columnar data: growable timestamp/value/int-ness arrays.

    Values live in parallel float64 + int64 buffers: the int64 side keeps
    Java-long exactness above 2^53 for integer points (the reference stores
    VLE-encoded longs, Internal.vleEncodeLong :963); the float side feeds the
    float64 query pipeline without a per-query cast.
    """

    __slots__ = ("key", "_ts", "_val", "_ival", "_isint", "_n", "_sorted",
                 "_lock", "shard", "_version")

    INITIAL_CAPACITY = 64

    def __init__(self, key: SeriesKey, shard: int = 0):
        self.key = key
        self.shard = shard
        # guarded-by: _lock
        self._ts = np.empty(self.INITIAL_CAPACITY, dtype=np.int64)
        self._val = np.empty(self.INITIAL_CAPACITY, dtype=np.float64)  # guarded-by: _lock
        self._ival = np.zeros(self.INITIAL_CAPACITY, dtype=np.int64)  # guarded-by: _lock
        self._isint = np.empty(self.INITIAL_CAPACITY, dtype=bool)  # guarded-by: _lock
        self._n = 0  # guarded-by: _lock
        self._sorted = True  # guarded-by: _lock
        self._lock = threading.Lock()
        # Monotone content version: bumped by every mutation that changes
        # visible data (appends, restore, dedup, deletes).  The device
        # series cache snapshots (data, version) together and treats a
        # later mismatch as staleness (storage/device_cache.py).
        self._version = 0  # guarded-by: _lock

    def __len__(self) -> int:
        return self._n

    @property
    def version(self) -> int:
        return self._version

    def _grow_locked(self, need: int) -> None:
        new_cap = max(need, len(self._ts) * 2, self.INITIAL_CAPACITY)
        self._ts = np.resize(self._ts, new_cap)
        self._val = np.resize(self._val, new_cap)
        self._ival = np.resize(self._ival, new_cap)
        self._isint = np.resize(self._isint, new_cap)

    def append(self, ts_ms: int, value, is_int: bool) -> None:
        with self._lock:
            if self._n == len(self._ts):
                self._grow_locked(self._n + 1)
            if self._sorted and self._n and ts_ms <= self._ts[self._n - 1]:
                self._sorted = False
            self._ts[self._n] = ts_ms
            self._val[self._n] = float(value)
            self._ival[self._n] = int(value) if is_int else 0
            self._isint[self._n] = is_int
            self._n += 1
            self._version += 1

    def append_batch(self, ts_ms: np.ndarray, values: np.ndarray,
                     is_int: np.ndarray | bool,
                     ival: np.ndarray | None = None) -> None:
        """Bulk ingest (TextImporter-style); arrays must be 1-D, same length.

        Pass `ival` (exact int64 values where is_int) for mixed batches
        whose integer points exceed 2^53 — a float64 `values` round-trip
        would lose them (Java-long exactness, Internal.vleEncodeLong :963).
        """
        m = len(ts_ms)
        if m == 0:
            return
        values = np.asarray(values)
        if np.isscalar(is_int) or isinstance(is_int, bool):
            isint = np.full(m, bool(is_int))
        else:
            isint = np.asarray(is_int, dtype=bool)
        if ival is not None:
            ival = np.asarray(ival, dtype=np.int64)
        elif np.issubdtype(values.dtype, np.integer):
            ival = values
        else:
            # Float-typed arrays may still carry integer points; the int
            # column must hold their exact values wherever isint is set.
            ival = np.where(isint, values.astype(np.int64), 0)
        # pure input-only work stays outside the lock — and outside the
        # write transition: a raise here must not interleave the column
        # writes below (failure_atomicity's all-writes-after-fallible)
        incoming_sorted = bool(m == 1 or bool(np.all(np.diff(ts_ms) > 0)))
        with self._lock:
            need = self._n + m
            if need > len(self._ts):
                self._grow_locked(need)
            self._ts[self._n:need] = ts_ms
            self._val[self._n:need] = values
            self._ival[self._n:need] = ival
            self._isint[self._n:need] = isint
            if self._sorted and (not incoming_sorted or
                                 (self._n and ts_ms[0] <= self._ts[self._n - 1])):
                self._sorted = False
            self._n = need
            self._version += 1

    def normalize(self, fix_duplicates: bool = True) -> None:
        """Sort by timestamp, resolving duplicates last-write-wins; with
        fix_duplicates off, duplicate timestamps raise ValueError."""
        with self._lock:
            self._normalize_locked(fix_duplicates)

    # effects: canonicalize
    def _normalize_locked(self, fix_duplicates: bool) -> None:
        # _sorted means strictly increasing (append flags <=-ties as dirty),
        # so a sorted series has no duplicates either — nothing to do.
        if self._sorted:
            return
        n = self._n
        # stable sort keeps insertion order within equal timestamps, so the
        # last write for a timestamp is the last element of its run.
        order = np.argsort(self._ts[:n], kind="stable")
        self._ts[:n] = self._ts[:n][order]
        self._val[:n] = self._val[:n][order]
        self._ival[:n] = self._ival[:n][order]
        self._isint[:n] = self._isint[:n][order]
        # Dedup BEFORE declaring the series clean: with fix_duplicates off
        # _dedup_sorted_locked raises, and the series must stay dirty so later reads
        # keep raising and fsck can still see + repair the duplicate.
        self._dedup_sorted_locked(fix_duplicates)
        self._sorted = True

    def _dedup_sorted_locked(self, fix_duplicates: bool) -> None:
        n = self._n
        if n < 2:
            return
        ts = self._ts[:n]
        dup = ts[1:] == ts[:-1]
        if not dup.any():
            return
        if not fix_duplicates:
            idx = int(np.argmax(dup))
            raise ValueError(
                "Duplicate timestamp %d in series %s (set "
                "tsd.storage.fix_duplicates=true to resolve)"
                % (int(ts[idx]), self.key))
        # sized by the series' own resident point count, not by any
        # request field  # tsdblint: disable=taint-unsanitized-alloc
        keep = np.ones(n, dtype=bool)
        keep[:-1] = ~dup  # keep the LAST point of each duplicate run
        m = int(keep.sum())
        self._ts[:m] = ts[keep]
        self._val[:m] = self._val[:n][keep]
        self._ival[:m] = self._ival[:n][keep]
        self._isint[:m] = self._isint[:n][keep]
        self._n = m
        self._version += 1

    def window(self, start_ms: int, end_ms: int, fix_duplicates: bool = True
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Return copies of (ts, float_vals, int_vals, is_int) for
        start_ms <= ts <= end_ms.

        Copies, not views: a later read's normalization sorts the buffers
        in place.  Normalization and the binary search happen under one
        lock hold so a concurrent out-of-order append cannot invalidate the
        sort mid-read.
        """
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            return (self._ts[lo:hi].copy(), self._val[lo:hi].copy(),
                    self._ival[lo:hi].copy(), self._isint[lo:hi].copy())

    def _window_bounds_locked(self, start_ms: int, end_ms: int,
                              fix_duplicates: bool) -> tuple[int, int]:
        """(lo, hi) buffer indexes of [start_ms, end_ms] — callers hold
        the lock.  The single definition of the window bound semantics
        shared by window(), window_count(), window_chunk() and
        delete_range()."""
        self._normalize_locked(fix_duplicates)
        n = self._n
        lo = int(np.searchsorted(self._ts[:n], start_ms, side="left"))
        hi = int(np.searchsorted(self._ts[:n], end_ms, side="right"))
        return lo, hi

    def window_bounds(self, start_ms: int, end_ms: int,
                      fix_duplicates: bool = True) -> tuple[int, int, int]:
        """(lo, hi, version) for [start_ms, end_ms] under one lock hold:
        the version says that (lo, hi) index exactly the content a
        snapshot of that version holds."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            return lo, hi, self._version

    def snapshot(self, fix_duplicates: bool = True, copy=np.copy
                 ) -> tuple[object, object, int]:
        """Normalized (ts, float_vals, version) copies under one lock
        hold; any later mutation bumps the version.  `copy` makes each
        column's copy from a view of the live buffer, inside the hold:
        numpy copies by default, the device cache its upload."""
        with self._lock:
            self._normalize_locked(fix_duplicates)
            n = self._n
            return (copy(self._ts[:n]), copy(self._val[:n]),
                    self._version)

    def window_count(self, start_ms: int, end_ms: int,
                     fix_duplicates: bool = True) -> int:
        """Points in [start_ms, end_ms] without materializing them
        (budget charging / streaming-path planning)."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            return hi - lo

    def window_stats(self, start_ms: int, end_ms: int,
                     fix_duplicates: bool = True) -> tuple[int, bool]:
        """(point count, every value integer-typed) for the range,
        without materializing it — the batch builder sizes and types the
        padded arrays from this before the single-copy fill
        (window_into)."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            return hi - lo, bool(np.all(self._isint[lo:hi]))

    def window_into(self, start_ms: int, end_ms: int, fix_duplicates: bool,
                    ts_row: np.ndarray, val_row: np.ndarray,
                    mask_row: np.ndarray, want_int: bool
                    ) -> tuple[int, bool]:
        """Copy this series' window STRAIGHT into pre-allocated batch row
        slices under one lock hold — the fused form of window() +
        build_batch's per-row pack, eliminating the intermediate copies
        (a 1M-point query pays ~25MB of window() copies it immediately
        repacks).  Returns (points written, int-contract held): the range
        can both grow AND change type between the caller's sizing pass
        and this one (no snapshot isolation, like the reference's scanner
        over live rows) — the count clamps to the row width, and when
        `want_int` but a float point has appeared in range, NOTHING is
        copied and ok_int=False tells the caller to rebuild its batch as
        float (reading _ival for a float point would silently yield 0).
        Tail padding is the CALLER's job."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            k = min(hi - lo, len(ts_row))
            if want_int and not bool(np.all(self._isint[lo:lo + k])):
                return 0, False
            ts_row[:k] = self._ts[lo:lo + k]
            src = self._ival if want_int else self._val
            val_row[:k] = src[lo:lo + k]
            mask_row[:k] = True
            return k, True

    def window_stride_timestamps(self, start_ms: int, end_ms: int,
                                 stride: int, fix_duplicates: bool = True
                                 ) -> np.ndarray:
        """Every stride-th timestamp in [start_ms, end_ms]: the streaming
        chunk boundaries, which the planner's sketch-hazard estimate reads
        (O(points / stride); the window is never materialized)."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            return self._ts[lo:hi:max(stride, 1)].copy()

    def window_chunk(self, start_ms: int, end_ms: int,
                     after_ts: int | None, limit: int, fix_duplicates: bool,
                     ts_out: np.ndarray, val_out: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Copy up to `limit` window points with timestamp > `after_ts`
        (None: from the window's start) into the rows `ts_out` and
        `val_out` -> views of their filled prefixes (ts, float_vals): the
        streaming scan's cursor read, one copy from the store to the
        chunk's buffer.

        The cursor is a timestamp, not an index: an out-of-order write or
        a normalization's dedup shifts buffer positions between calls,
        and an index cursor could read a point twice or skip one.  Each
        point that existed when the scan began is returned at most once;
        a point landing behind the cursor mid-query is a new write, which
        the scan need not see (SaltScanner.java:269)."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            if after_ts is not None:
                lo = max(lo, int(np.searchsorted(self._ts[:self._n],
                                                 after_ts, side="right")))
            k = max(min(lo + max(limit, 0), hi) - lo, 0)
            ts_out[:k] = self._ts[lo:lo + k]
            val_out[:k] = self._val[lo:lo + k]
            return ts_out[:k], val_out[:k]

    def restore_arrays(self, ts: np.ndarray, val: np.ndarray,
                       ival: np.ndarray, isint: np.ndarray) -> None:
        """Load snapshot columns verbatim (persistence restore path).

        Replaces the series contents; the float and int columns are taken
        exactly as stored so no int<->float round trip occurs.
        """
        n = len(ts)
        # sortedness depends only on the incoming column: compute it
        # before the lock so the locked section is pure writes
        sorted_flag = bool(n <= 1 or bool(np.all(np.diff(ts) > 0)))
        with self._lock:
            if n > len(self._ts):
                self._grow_locked(n)
            self._ts[:n] = ts
            self._val[:n] = val
            self._ival[:n] = ival
            self._isint[:n] = isint
            self._n = n
            self._sorted = sorted_flag
            self._version += 1

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Copies of the full (ts, float_vals, int_vals, is_int) columns."""
        with self._lock:
            n = self._n
            return (self._ts[:n].copy(), self._val[:n].copy(),
                    self._ival[:n].copy(), self._isint[:n].copy())

    def delete_range(self, start_ms: int, end_ms: int,
                     fix_duplicates: bool = True) -> int:
        """Remove the points with start_ms <= ts <= end_ms; returns how
        many were removed."""
        with self._lock:
            lo, hi = self._window_bounds_locked(start_ms, end_ms,
                                                fix_duplicates)
            n = self._n
            removed = hi - lo
            if removed <= 0:
                return 0
            keep = n - hi
            self._ts[lo:lo + keep] = self._ts[hi:n]
            self._val[lo:lo + keep] = self._val[hi:n]
            self._ival[lo:lo + keep] = self._ival[hi:n]
            self._isint[lo:lo + keep] = self._isint[hi:n]
            self._n = n - removed
            self._version += 1
            return removed


@dataclass
class Annotation:
    """A note attached to a timespan, per-TSUID or global (meta/Annotation.java)."""
    start_time: int
    end_time: int = 0
    tsuid: str = ""
    description: str = ""
    notes: str = ""
    custom: dict[str, str] | None = None

    def to_json(self) -> dict:
        out = {
            "tsuid": self.tsuid,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "description": self.description,
            "notes": self.notes,
            "custom": self.custom,
        }
        if not self.tsuid:
            out.pop("tsuid")
        return out


class MemStore:
    """The series store: keyed columnar series + per-metric index."""

    def __init__(self, salt_buckets: int = 20, fix_duplicates: bool = True):
        self.salt_buckets = salt_buckets
        self.fix_duplicates = fix_duplicates
        self._series: dict[SeriesKey, Series] = {}  # guarded-by: _lock
        self._by_metric: dict[int, set[SeriesKey]] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        # tsuid-keyed and global ("") annotation lists  # guarded-by: _lock
        self._annotations: dict[str, list[Annotation]] = {}
        # data-mutation listeners, (metric, lo_ms, hi_ms) per write: the
        # rollup lanes' invalidation hook (storage/rollup.py).  Notified
        # AFTER the write lands (write-then-mark): by the time a write is
        # acked its mark exists, so an artifact built from a read before
        # the write fails its generation check and no acked write is
        # served stale.  A mark before the write would let a read between
        # the mark and the write carry the mark's generation.
        self._mutation_listeners: list = []  # guarded-by: _lock

    # -- write path --

    def add_mutation_listener(self, fn) -> None:
        """Register fn(metric_uid, lo_ms | None, hi_ms | None), called
        after every data mutation lands (None bounds: the whole
        metric)."""
        with self._lock:
            self._mutation_listeners.append(fn)

    def notify_mutation(self, metric: int, lo_ms: int | None,
                        hi_ms: int | None) -> None:
        """Tell the listeners that (metric, [lo_ms, hi_ms]) has changed;
        call after the mutation lands.  Also the entry for a caller that
        mutates a Series directly (Series.delete_range)."""
        with self._lock:
            listeners = tuple(self._mutation_listeners)
        for fn in listeners:
            fn(metric, lo_ms, hi_ms)

    def get_or_create_series(self, key: SeriesKey) -> Series:
        with self._lock:
            return self._get_or_create_series_locked(key)

    def _get_or_create_series_locked(self, key: SeriesKey) -> Series:
        series = self._series.get(key)
        if series is None:
            series = Series(key, shard=key.salt(self.salt_buckets))
            self._series[key] = series
            self._by_metric.setdefault(key.metric, set()).add(key)
        return series

    def add_point(self, key: SeriesKey, ts_ms: int, value: float,
                  is_int: bool) -> None:
        self.get_or_create_series(key).append(ts_ms, value, is_int)
        self.notify_mutation(key.metric, ts_ms, ts_ms)

    def add_batch(self, key: SeriesKey, ts_ms: np.ndarray, values: np.ndarray,
                  is_int: np.ndarray | bool,
                  ival: np.ndarray | None = None) -> None:
        self.get_or_create_series(key).append_batch(ts_ms, values, is_int,
                                                    ival)
        if len(ts_ms):
            self.notify_mutation(key.metric, int(np.min(ts_ms)),
                                 int(np.max(ts_ms)))

    # -- read path --

    def series_for_metric(self, metric: int) -> list[Series]:
        with self._lock:
            keys = self._by_metric.get(metric, set())
            return [self._series[k] for k in keys]

    def series_count_and_sample(self, metric: int,
                                limit: int) -> tuple[int, list[Series]]:
        """A metric's series count and at most `limit` of its series,
        without building the whole list (the admission gate's cost
        estimate runs on every arrival)."""
        with self._lock:
            keys = self._by_metric.get(metric, set())
            return len(keys), [self._series[k]
                               for k in itertools.islice(keys, limit)]

    def get_series(self, key: SeriesKey) -> Series | None:
        with self._lock:
            return self._series.get(key)

    def all_series(self) -> list[Series]:
        with self._lock:
            return list(self._series.values())

    def delete_series(self, key: SeriesKey) -> bool:
        """Drop a series and its data; a series later made under the same
        key is a new object whose version starts again from 0."""
        with self._lock:
            series = self._series.pop(key, None)
            if series is None:
                return False
            keys = self._by_metric.get(key.metric)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    self._by_metric.pop(key.metric, None)
        self.notify_mutation(key.metric, None, None)
        return True

    # -- annotations --

    def add_annotation(self, note: Annotation) -> None:
        with self._lock:
            self._annotations.setdefault(note.tsuid, []).append(note)

    def get_annotations(self, tsuid: str, start_ms: int, end_ms: int
                        ) -> list[Annotation]:
        with self._lock:
            out = [note for note in self._annotations.get(tsuid, [])
                   if start_ms <= note.start_time <= end_ms]
        out.sort(key=lambda a: a.start_time)
        return out

    # -- stats --

    @property
    def total_datapoints(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._series.values())
