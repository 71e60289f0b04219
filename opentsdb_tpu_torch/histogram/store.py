"""Columnar histogram storage and the all-groups batch of a histogram query.

Port of opentsdb_tpu/histogram/store.py (OpenTSDB HistogramSpan.java,
HistogramSpanGroup.java:67, HistogramDownsampler.java,
HistogramAggregationIterator.java): per-series histogram sequences with an
incremental columnar image, and ``assemble_columnar``, which flattens every
group of a query into one scatter batch for the H1 and H2 kernels
(histogram/kernels.py).

Two deliberate differences from the reference's ``assemble_columnar``:
no power-of-two padding of rows or buckets (the port compiles nothing per
shape), so ``n_rows`` counts the data-bearing rows, ``n_buckets`` the real
bucket vocabulary and ``mid`` has ``n_buckets`` entries; and ``seg`` stays
int64 (the reference narrows it to int32 for the TPU).  The reference's
numpy oracle (``merge_group``, ``downsample_counts``, ``percentiles_of``)
is not copied: the tests use it from the reference.
"""

from __future__ import annotations

import threading

import numpy as np

from opentsdb_tpu_torch.histogram.simple import SimpleHistogram
from opentsdb_tpu_torch.storage.memstore import SeriesKey


class HistogramSeries:
    """One series' histogram points: parallel (ts, histogram) lists.

    `columns()` maintains a columnar CSR image (ts[N] + per-point bucket
    id/count runs over a per-series bucket vocabulary), built once per
    write burst, so that batch assembly is array work only.
    """

    def __init__(self, key: SeriesKey):
        self.key = key
        # guarded-by: _lock
        self._ts: list[int] = []
        self._hists: list[SimpleHistogram] = []  # guarded-by: _lock
        self._sorted = True  # guarded-by: _lock
        self._lock = threading.Lock()
        # (ts[N], indptr[N+1], bids[nnz], cnts[nnz])
        self._cols = None  # guarded-by: _lock
        self._vocab: list[tuple[float, float]] = []   # local id -> bounds

    def append(self, ts_ms: int, hist: SimpleHistogram) -> None:
        with self._lock:
            if self._ts and ts_ms < self._ts[-1]:
                self._sorted = False
                self._cols = None    # the re-sort shuffles everything
            self._ts.append(ts_ms)
            self._hists.append(hist)

    def _normalize_locked(self) -> None:
        if not self._sorted:
            order = np.argsort(np.asarray(self._ts, dtype=np.int64),
                               kind="stable")
            self._ts = [self._ts[i] for i in order]
            self._hists = [self._hists[i] for i in order]
            self._sorted = True
            self._cols = None

    def count_in_range(self, start_ms: int, end_ms: int) -> int:
        """Points in [start_ms, end_ms] without materializing anything."""
        with self._lock:
            self._normalize_locked()
            ts = np.asarray(self._ts, np.int64)
            return int(np.searchsorted(ts, end_ms, "right")
                       - np.searchsorted(ts, start_ms, "left"))

    def columns(self):
        """(ts[N], indptr[N+1], bids[nnz], cnts[nnz], vocab): stable
        arrays (rebuilt, never mutated) safe to use outside the lock.

        In-order appends extend the previous image (the per-bucket walk
        covers only the new points); out-of-order appends re-sort and
        rebuild.
        """
        with self._lock:
            self._normalize_locked()
            start = 0
            old = self._cols
            if old is not None and len(old[1]) - 1 == len(self._hists):
                return old + (list(self._vocab),)
            if old is not None:
                start = len(old[1]) - 1
            vocab_idx = {b: i for i, b in enumerate(self._vocab)}
            indptr = np.zeros(len(self._hists) - start + 1, np.int64)
            base = int(old[1][-1]) if old is not None else 0
            indptr[0] = base
            bids: list[int] = []
            cnts: list[int] = []
            for i, h in enumerate(self._hists[start:]):
                for b, c in h.buckets.items():
                    gi = vocab_idx.get(b)
                    if gi is None:
                        gi = vocab_idx[b] = len(self._vocab)
                        self._vocab.append(b)
                    bids.append(gi)
                    cnts.append(c)
                indptr[i + 1] = base + len(bids)
            new_ts = np.asarray(self._ts[start:], np.int64)
            new_bids = np.asarray(bids, np.int64)
            new_cnts = np.asarray(cnts, np.int64)
            if old is None:
                self._cols = (new_ts, indptr, new_bids, new_cnts)
            else:
                self._cols = (np.concatenate([old[0], new_ts]),
                              np.concatenate([old[1], indptr[1:]]),
                              np.concatenate([old[2], new_bids]),
                              np.concatenate([old[3], new_cnts]))
            return self._cols + (list(self._vocab),)

    def arrays(self):
        """(ts[N] int64, points): each point as (bounds[k, 2] float64,
        counts[k] int64, underflow, overflow), in timestamp order; what
        ``restore_arrays`` takes back."""
        with self._lock:
            self._normalize_locked()
            points = []
            for h in self._hists:
                bounds = list(h.buckets)
                points.append((np.asarray(bounds, np.float64).reshape(-1, 2),
                               np.asarray([h.buckets[b] for b in bounds],
                                          np.int64),
                               h.underflow, h.overflow))
            return np.asarray(self._ts, np.int64), points

    def restore_arrays(self, ts, points) -> None:
        """Append the points ``arrays`` gives (any order), as codec 0's."""
        for t, (bounds, counts, underflow, overflow) in zip(
                np.asarray(ts, np.int64).tolist(), points):
            h = SimpleHistogram(0)
            for (lo, hi), c in zip(np.asarray(bounds, np.float64).tolist(),
                                   np.asarray(counts, np.int64).tolist()):
                h.buckets[(lo, hi)] = c
            h.underflow = int(underflow)
            h.overflow = int(overflow)
            self.append(t, h)

    def __len__(self) -> int:
        return len(self._ts)


class HistogramStore:
    """All histogram series, keyed like the scalar MemStore."""

    def __init__(self):
        # guarded-by: _lock
        self._series: dict[SeriesKey, HistogramSeries] = {}
        self._by_metric: dict[int, set[SeriesKey]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def get_or_create_series(self, key: SeriesKey) -> HistogramSeries:
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = HistogramSeries(key)
                self._series[key] = series
                self._by_metric.setdefault(key.metric, set()).add(key)
            return series

    def add_point(self, key: SeriesKey, ts_ms: int,
                  hist: SimpleHistogram) -> None:
        self.get_or_create_series(key).append(ts_ms, hist)

    def series_for_metric(self, metric: int) -> list[HistogramSeries]:
        with self._lock:
            return [self._series[k]
                    for k in self._by_metric.get(metric, ())]

    def all_series(self) -> list[HistogramSeries]:
        with self._lock:
            return list(self._series.values())

    @property
    def num_series(self) -> int:
        with self._lock:
            return len(self._series)


def assemble_columnar(groups_members, start_ms: int, end_ms: int,
                      interval_ms: int):
    """Flatten every group's histogram points into one batch.

    `groups_members`: ordered [(group_key, [HistogramSeries, ...]), ...].
    Returns None when no group has data in range, else a dict with
      seg[nnz] int64, cnt[nnz] int64   flat (row * n_buckets + bucket)
                                       scatter entries
      n_rows, n_buckets                the data-bearing rows and the real
                                       bucket vocabulary
      bounds[B, 2], mid[B]             bound-sorted global vocabulary
      groups: [(group_key, row_lo, row_hi, ts[T_g], used[Ug], points)]
    Rows are each group's data-bearing windows (unique timestamps, or
    epoch-aligned edges when downsampling) stacked in group order, so one
    [rows, B] grid serves any group count.
    """
    # pass 1: slices + global bound-sorted bucket vocabulary
    vocab: dict[tuple[float, float], int] = {}
    sliced = []     # (group_key, [(series_cols, lo, hi)])
    for group_key, members in groups_members:
        cuts = []
        for s in members:
            ts, indptr, bids, cnts, svocab = s.columns()
            lo = int(np.searchsorted(ts, start_ms, "left"))
            hi = int(np.searchsorted(ts, end_ms, "right"))
            if hi > lo:
                cuts.append(((ts, indptr, bids, cnts, svocab), lo, hi))
                for b in svocab:
                    vocab.setdefault(b, 0)
        if cuts:
            sliced.append((group_key, cuts))
    if not sliced:
        return None
    bounds_sorted = sorted(vocab)
    for i, b in enumerate(bounds_sorted):
        vocab[b] = i
    n_b = len(bounds_sorted)

    # pass 2: per-group rows + flat scatter entries
    seg_parts, cnt_parts, groups = [], [], []
    row_base = 0
    for group_key, cuts in sliced:
        keys_parts = []
        for (ts, indptr, bids, cnts, svocab), lo, hi in cuts:
            w = ts[lo:hi]
            keys_parts.append(w - w % interval_ms if interval_ms > 0 else w)
        edges = np.unique(np.concatenate(keys_parts))
        used_parts = []
        points = 0
        for part_keys, ((ts, indptr, bids, cnts, svocab), lo, hi) \
                in zip(keys_parts, cuts):
            points += hi - lo
            rows = np.searchsorted(edges, part_keys)
            e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
            entry_pt = np.repeat(np.arange(hi - lo),
                                 np.diff(indptr[lo:hi + 1]))
            gmap = np.asarray([vocab[b] for b in svocab], np.int64)
            entry_bid = gmap[bids[e_lo:e_hi]]
            seg_parts.append((row_base + rows[entry_pt]) * n_b + entry_bid)
            cnt_parts.append(cnts[e_lo:e_hi])
            used_parts.append(entry_bid)
        groups.append((group_key, row_base, row_base + len(edges), edges,
                       np.unique(np.concatenate(used_parts)), points))
        row_base += len(edges)

    bounds = np.asarray(bounds_sorted, np.float64).reshape(-1, 2)
    return {
        "seg": np.concatenate(seg_parts).astype(np.int64, copy=False),
        "cnt": np.concatenate(cnt_parts).astype(np.int64, copy=False),
        "n_rows": row_base,
        "n_buckets": n_b,
        "bounds": bounds,
        "mid": (bounds[:, 0] + bounds[:, 1]) / 2.0,
        "groups": groups,
    }
