"""Histograms: the SimpleHistogram codec, the histogram store and the
H1/H2 kernels of a percentile or show-buckets query.

Port of opentsdb_tpu/histogram/ (OpenTSDB src/core/SimpleHistogram.java,
HistogramCodecManager.java and the HistogramSpan read stack).
"""

from opentsdb_tpu_torch.histogram.simple import SimpleHistogram
from opentsdb_tpu_torch.histogram.codec import HistogramCodecManager
from opentsdb_tpu_torch.histogram.store import HistogramStore

__all__ = ["SimpleHistogram", "HistogramCodecManager", "HistogramStore"]
