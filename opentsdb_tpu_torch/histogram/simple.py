"""SimpleHistogram: explicit-bucket histogram + binary codec.

A copy of opentsdb_tpu/histogram/simple.py (OpenTSDB
src/core/SimpleHistogram.java): sorted (lower, upper) float buckets with
int64 counts plus underflow/overflow;
binary layout `[id?][short nbuckets][float lo][float hi][varlong count]...
[varlong under][varlong over]` (histogram() :~57-80, Kryo positive-varint
longs); percentile(p) returns the MIDPOINT of the first bucket whose
cumulative share reaches p (:~118-148 — not interpolated; the interpolating
variant is commented out in the reference too).
"""

from __future__ import annotations

import base64
import struct


def write_varlong(value: int) -> bytes:
    """Kryo writeLong(v, optimizePositive=true): little-endian 7-bit groups,
    high bit = continuation."""
    if value < 0:
        raise ValueError("negative count: %d" % value)
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def read_varlong(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


class SimpleHistogram:
    """Explicit-bucket histogram with the reference's aggregation rules."""

    def __init__(self, hist_id: int = 0):
        self.id = hist_id
        self.buckets: dict[tuple[float, float], int] = {}
        self.underflow = 0
        self.overflow = 0

    def add_bucket(self, lo: float, hi: float, count: int) -> None:
        if lo is None or hi is None:
            return
        self.buckets[(float(lo), float(hi))] = int(count or 0)

    def aggregate(self, other: "SimpleHistogram") -> None:
        """Merge counts; identical bounds accumulate (SimpleHistogram
        aggregation via HistogramAggregation.SUM)."""
        for bounds, count in other.buckets.items():
            self.buckets[bounds] = self.buckets.get(bounds, 0) + count
        self.underflow += other.underflow
        self.overflow += other.overflow

    def bucket_sum(self) -> int:
        return sum(self.buckets.values())

    def percentile(self, perc: float) -> float:
        """Midpoint of the first bucket reaching the cumulative share."""
        if perc < 1.0 or perc > 100.0:
            return -1.0
        total = self.bucket_sum()
        if total == 0:
            return 0.0
        running = 0
        for (lo, hi) in sorted(self.buckets):
            running += self.buckets[(lo, hi)]
            if running * 100.0 / total >= perc:
                return (lo + hi) / 2.0
        return 0.0

    def percentiles(self, percs: list[float]) -> list[float]:
        return [self.percentile(p) for p in percs]

    # -- binary codec --

    def to_bytes(self, include_id: bool = True) -> bytes:
        out = bytearray()
        if include_id:
            out.append(self.id & 0xFF)
        out += struct.pack(">h", len(self.buckets))
        for (lo, hi) in sorted(self.buckets):
            out += struct.pack(">f", lo)
            out += struct.pack(">f", hi)
            out += write_varlong(self.buckets[(lo, hi)])
        out += write_varlong(self.underflow)
        out += write_varlong(self.overflow)
        return bytes(out)

    @classmethod
    def from_bytes(cls, raw: bytes, include_id: bool = True
                   ) -> "SimpleHistogram":
        if len(raw) < 6:
            raise ValueError("Byte array shorter than 6 bytes")
        pos = 0
        hist_id = 0
        if include_id:
            hist_id = raw[0]
            pos = 1
        out = cls(hist_id)
        (n,) = struct.unpack_from(">h", raw, pos)
        pos += 2
        for _ in range(n):
            (lo,) = struct.unpack_from(">f", raw, pos)
            (hi,) = struct.unpack_from(">f", raw, pos + 4)
            pos += 8
            count, pos = read_varlong(raw, pos)
            out.buckets[(lo, hi)] = count
        out.underflow, pos = read_varlong(raw, pos)
        out.overflow, pos = read_varlong(raw, pos)
        return out

    def to_base64(self, include_id: bool = True) -> str:
        return base64.b64encode(self.to_bytes(include_id)).decode()

    @classmethod
    def from_base64(cls, encoded: str, include_id: bool = True
                    ) -> "SimpleHistogram":
        return cls.from_bytes(base64.b64decode(encoded), include_id)

    # -- JSON (HistogramPojo: buckets keyed "lo,hi") --

    @classmethod
    def from_pojo(cls, dp: dict, hist_id: int = 0) -> "SimpleHistogram":
        out = cls(int(dp.get("id", hist_id)))
        for key, count in (dp.get("buckets") or {}).items():
            lo, hi = key.split(",")
            out.add_bucket(float(lo), float(hi), int(count))
        out.underflow = int(dp.get("underflow", 0))
        out.overflow = int(dp.get("overflow", 0))
        return out

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "buckets": {"%g,%g" % b: c
                        for b, c in sorted(self.buckets.items())},
            "underflow": self.underflow,
            "overflow": self.overflow,
        }

    def __eq__(self, other) -> bool:
        return (isinstance(other, SimpleHistogram)
                and self.buckets == other.buckets
                and self.underflow == other.underflow
                and self.overflow == other.overflow)

    def __repr__(self) -> str:
        return "SimpleHistogram(id=%d, %d buckets, sum=%d)" % (
            self.id, len(self.buckets), self.bucket_sum())
