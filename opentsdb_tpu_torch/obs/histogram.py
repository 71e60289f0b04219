"""Log-bucketed latency histogram, quantile-estimating.

A copy of opentsdb_tpu/obs/histogram.py's ``LogHistogram``, the summary
behind the latency-attribution profiles (obs/latattr.py).  Geometric
bucket bounds ``lo * growth**i`` answer a rank query within one bucket's
growth factor.  The reference's ``merge`` and its Prometheus
``cumulative`` exposition serve the metrics registry (ROADMAP A, slice
8d) and are not copied.
"""

from __future__ import annotations

import math
import threading

# 1 microsecond to ~84 seconds in ms units at 2**(1/4) growth: a
# quantile is within a factor ~1.19 of a sample at its rank.
DEFAULT_LO = 1e-3
DEFAULT_GROWTH = 2 ** 0.25
DEFAULT_BUCKETS = 96


class LogHistogram:
    """Thread-safe log-bucketed histogram.

    Bucket 0 holds values <= ``lo``; bucket i (1..buckets-1) holds
    (lo*growth**(i-1), lo*growth**i]; the last slot is the +Inf overflow.
    """

    __slots__ = ("lo", "growth", "buckets", "_log_growth", "_lock",
                 "counts", "count", "total", "exemplars")

    def __init__(self, lo: float = DEFAULT_LO,
                 growth: float = DEFAULT_GROWTH,
                 buckets: int = DEFAULT_BUCKETS):
        if lo <= 0 or growth <= 1.0 or buckets < 1:
            raise ValueError("invalid histogram layout: lo=%r growth=%r "
                             "buckets=%r" % (lo, growth, buckets))
        self.lo = float(lo)
        self.growth = float(growth)
        self.buckets = int(buckets)
        self._log_growth = math.log(self.growth)
        self._lock = threading.Lock()
        self.counts = [0] * (self.buckets + 1)  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self.total = 0.0  # guarded-by: _lock
        # the last exemplar a fine bucket: {index: (label, value)}
        # guarded-by: _lock
        self.exemplars: dict[int, tuple[str, float]] = {}

    def _index(self, value: float) -> int:
        if value <= self.lo:
            return 0
        idx = int(math.ceil(math.log(value / self.lo) / self._log_growth
                            - 1e-9))
        return min(max(idx, 1), self.buckets)

    def bound(self, index: int) -> float:
        """Upper bound of bucket `index` (inf for the overflow slot)."""
        if index >= self.buckets:
            return math.inf
        return self.lo * self.growth ** index

    def observe(self, value: float, exemplar: str | None = None) -> None:
        if value != value or value < 0:        # NaN or negative
            raise ValueError("invalid observation: %r" % value)
        idx = self._index(value)
        with self._lock:
            self.counts[idx] += 1
            self.count += 1
            self.total += value
            if exemplar is not None:
                self.exemplars[idx] = (exemplar, value)

    def snapshot(self) -> tuple[list[int], int, float]:
        with self._lock:
            return list(self.counts), self.count, self.total

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 < q <= 1), interpolated geometrically
        inside its bucket; NaN when empty; the overflow bucket answers its
        lower bound."""
        if not 0.0 < q <= 1.0:
            raise ValueError("invalid quantile: %r" % q)
        counts, count, _total = self.snapshot()
        if count == 0:
            return math.nan
        rank = max(int(math.ceil(q * count)), 1)
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i == 0:
                    return self.lo
                if i >= self.buckets:
                    return self.lo * self.growth ** (self.buckets - 1)
                lower = self.lo * self.growth ** (i - 1)
                return lower * self.growth ** ((rank - seen) / c)
            seen += c
        return self.lo * self.growth ** (self.buckets - 1)

    def exemplar_entries(self, max_buckets: int = 24
                         ) -> list[tuple[float, str, float]]:
        """[(coarse_upper_bound, label, value)] over aligned runs of
        buckets (at most `max_buckets`); within a run the highest bucket's
        exemplar wins."""
        with self._lock:
            snap = dict(self.exemplars)
        if not snap:
            return []
        step = max(-(-self.buckets // max(max_buckets - 1, 1)), 1)
        out: list[tuple[float, str, float]] = []
        for lo_i in range(0, self.buckets, step):
            hi_i = min(lo_i + step, self.buckets)
            best = None
            for i in range(lo_i, hi_i):
                if i in snap:
                    best = snap[i]
            if best is not None:
                out.append((self.bound(hi_i - 1), best[0], best[1]))
        if self.buckets in snap:
            label, value = snap[self.buckets]
            out.append((math.inf, label, value))
        return out
