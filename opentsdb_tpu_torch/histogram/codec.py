"""Histogram codec registry from tsd.core.histograms.config.

A copy of opentsdb_tpu/histogram/codec.py (OpenTSDB
src/core/HistogramCodecManager.java :36-71): the config value is JSON
(inline or a .json file path) mapping decoder names to IDs, e.g.
{"net.opentsdb.core.SimpleHistogramDecoder": 0}.
IDs must be unique in [0, 255].  Here decoder names resolve to codec classes
by simple name, and only SimpleHistogramDecoder ships.
"""

from __future__ import annotations

import json

from opentsdb_tpu_torch.histogram.simple import SimpleHistogram


class SimpleHistogramDecoder:
    """Codec for SimpleHistogram payloads."""

    def __init__(self, codec_id: int):
        self.id = codec_id

    def decode(self, raw: bytes, includes_id: bool = False
               ) -> SimpleHistogram:
        out = SimpleHistogram.from_bytes(raw, include_id=includes_id)
        out.id = self.id
        return out

    def encode(self, histogram: SimpleHistogram,
               include_id: bool = True) -> bytes:
        return histogram.to_bytes(include_id=include_id)


_KNOWN_DECODERS = {
    "SimpleHistogramDecoder": SimpleHistogramDecoder,
}


class HistogramCodecManager:
    def __init__(self, config_text: str):
        if not config_text:
            raise ValueError(
                "Histogram support requires 'tsd.core.histograms.config'")
        if config_text.strip().endswith(".json"):
            with open(config_text.strip()) as fh:
                mapping = json.load(fh)
        else:
            mapping = json.loads(config_text)
        self.codecs: dict[int, object] = {}
        for name, codec_id in mapping.items():
            codec_id = int(codec_id)
            if not 0 <= codec_id <= 255:
                raise ValueError(
                    "ID for decoder '%s' must be between 0 and 255" % name)
            if codec_id in self.codecs:
                raise ValueError(
                    "Duplicate histogram decoder ID: %d" % codec_id)
            simple_name = name.rsplit(".", 1)[-1]
            cls = _KNOWN_DECODERS.get(simple_name)
            if cls is None:
                raise ValueError(
                    "Unable to find a decoder named '%s'" % name)
            self.codecs[codec_id] = cls(codec_id)

    def get_codec(self, codec_id: int):
        codec = self.codecs.get(codec_id)
        if codec is None:
            raise ValueError("No histogram codec with ID: %d" % codec_id)
        return codec

    @staticmethod
    def from_config(config) -> "HistogramCodecManager | None":
        raw = config.get_string("tsd.core.histograms.config")
        if not raw:
            return None
        return HistogramCodecManager(raw)
