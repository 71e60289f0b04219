"""Flat ``tsd.*`` properties configuration with typed getters.

A slim copy of opentsdb_tpu's utils/config.py (OpenTSDB
src/utils/Config.java): the same ``Config`` accessors and the same key
names and defaults, declared only for the keys this package reads.  A
properties dict may carry other keys; they are stored and ignored.
"""

from __future__ import annotations

from typing import Any

# Every key the port reads, with the reference's default (as the untyped
# properties string).
DEFAULTS: dict[str, str] = {
    # the daemon (tsd/, tools/tsd_main.py)
    "tsd.mode": "rw",
    "tsd.network.bind": "0.0.0.0",
    "tsd.network.port": "",
    "tsd.network.keep_alive_timeout": "300",
    "tsd.core.connections.limit": "0",
    "tsd.core.enable_api": "true",
    "tsd.http.show_stack_trace": "true",
    "tsd.http.query.allow_delete": "false",
    # histograms (histogram/, the planner's histogram arm)
    "tsd.core.histograms.config": "",
    "tsd.query.streaming.state_mb": "6144",
    "tsd.core.auto_create_metrics": "false",
    "tsd.core.auto_create_tagks": "true",
    "tsd.core.auto_create_tagvs": "true",
    "tsd.core.uid.random_metrics": "false",
    # the device series cache (storage/device_cache.py)
    "tsd.query.device_cache.enable": "true",
    "tsd.query.device_cache.mb": "4096",
    "tsd.query.device_cache.build_max_points": "200000000",
    "tsd.query.device_cache.batch_mb": "6144",
    "tsd.storage.fix_duplicates": "false",
    "tsd.storage.salt.buckets": "20",
    "tsd.storage.uid.width.metric": "3",
    "tsd.storage.uid.width.tagk": "3",
    "tsd.storage.uid.width.tagv": "3",
}


class Config:
    """Typed accessor over a flat key->string map."""

    def __init__(self, properties: dict[str, Any] | None = None):
        self._map: dict[str, str] = dict(DEFAULTS)
        if properties:
            for k, v in properties.items():
                self._map[k] = self._stringify(v)

    @staticmethod
    def _stringify(value: Any) -> str:
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)

    def load_file(self, path: str) -> None:
        """Java properties lines (`key = value`; `#` and `!` comment)."""
        with open(path, "r") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#") or line.startswith("!"):
                    continue
                if "=" not in line:
                    continue
                key, _, value = line.partition("=")
                self._map[key.strip()] = value.strip()

    def override_config(self, key: str, value: Any) -> None:
        self._map[key] = self._stringify(value)

    def get_string(self, key: str) -> str:
        if key not in self._map:
            raise KeyError(key)
        return self._map[key]

    def get_int(self, key: str) -> int:
        return int(self.get_string(key))

    def get_bool(self, key: str) -> bool:
        value = self.get_string(key).strip().lower()
        return value in ("1", "true", "yes")

    @property
    def auto_metric(self) -> bool:
        return self.get_bool("tsd.core.auto_create_metrics")

    @property
    def fix_duplicates(self) -> bool:
        return self.get_bool("tsd.storage.fix_duplicates")

    @property
    def salt_buckets(self) -> int:
        return self.get_int("tsd.storage.salt.buckets")
