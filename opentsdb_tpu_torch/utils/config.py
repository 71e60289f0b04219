"""Flat ``tsd.*`` properties configuration with typed getters.

A slim copy of opentsdb_tpu's utils/config.py (OpenTSDB
src/utils/Config.java): the same ``Config`` accessors and the same key
names and defaults, declared only for the keys this package reads.  A
properties dict may carry other keys.  Those of a reference subsystem
that the port does not have yet, and that would change an answer or
durability (``UNPORTED``), are refused with a non-default value by
``refuse_unported``, which the TSDB and the daemon call: the error names
the ROADMAP item that ports them.  Every other key is stored and ignored:
the reference's TPU strategy keys (the kernel modes,
``tsd.query.host_lane.max_points``: the port answers every plan on the
card) change no answer.  The aggregate cache's ``tsd.query.cache.*``
keys (storage/agg_cache.py), request tracing's ``tsd.trace.*``, latency
attribution's ``tsd.latattr.*`` and the device mesh's
``tsd.query.mesh.*`` (parallel/, core/tsdb.py ``query_mesh``) are read,
with the reference's defaults.
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
    "tsd.network.drain_timeout_ms": "30000",
    # admission control and the request deadline (tsd/admission.py)
    "tsd.query.admission.enable": "true",
    "tsd.query.admission.permits": "8",
    "tsd.query.admission.queue_limit": "64",
    "tsd.query.admission.max_wait_ms": "5000",
    "tsd.query.tenant.fair_share": "true",
    "tsd.query.tenant.weights": "",
    "tsd.query.tenant.quantum_ms": "50",
    "tsd.query.tenant.max_inflight": "0",
    "tsd.query.degrade": "error",
    "tsd.diag.tenants": "",
    "tsd.diag.tenant_buckets": "16",
    # /api/query/explain (query/explain.py)
    "tsd.explain.enable": "true",
    "tsd.explain.include_candidates": "true",
    # fused multi-query dispatch (query/batcher.py)
    "tsd.query.batch.enable": "true",
    "tsd.query.batch.hold_ms": "2",
    "tsd.query.batch.max_q": "16",
    "tsd.query.batch.max_mb": "64",
    "tsd.query.batch.amortize_factor": "4.0",
    # histograms (histogram/, the planner's histogram arm)
    "tsd.core.histograms.config": "",
    # the streamed grouped route (query/planner.py, ops/streaming.py) and
    # the device-state grid guard every path honours
    "tsd.query.streaming.state_mb": "6144",
    "tsd.query.streaming.point_threshold": "8000000",
    "tsd.query.streaming.chunk_points": "4000000",
    "tsd.query.streaming.sketch_percentiles": "true",
    "tsd.query.streaming.sketch_max_merges": "4",
    # out-of-core tiled execution (ops/tiling.py, storage/spill.py)
    "tsd.query.spill.enable": "true",
    "tsd.query.spill.host_mb": "1024",
    "tsd.query.spill.disk_mb": "16384",
    "tsd.query.spill.dir": "",
    "tsd.query.spill.max_tiles": "1024",
    # scan budgets and the timeout (query/limits.py)
    "tsd.query.timeout": "0",
    "tsd.query.limits.bytes.default": "0",
    "tsd.query.limits.bytes.allow_override": "false",
    "tsd.query.limits.data_points.default": "0",
    "tsd.query.limits.data_points.allow_override": "false",
    "tsd.query.limits.overrides.config": "",
    "tsd.query.limits.overrides.interval": "60000",
    "tsd.core.auto_create_metrics": "false",
    "tsd.core.auto_create_tagks": "true",
    "tsd.core.auto_create_tagvs": "true",
    "tsd.core.uid.random_metrics": "false",
    # request spans (obs/trace.py) and latency attribution
    # (obs/latattr.py, /api/diag/latency)
    "tsd.trace.enable": "true",
    "tsd.trace.device_time": "true",
    "tsd.latattr.enable": "true",
    "tsd.latattr.max_profiles": "256",
    # the device mesh (parallel/, core/tsdb.py query_mesh)
    "tsd.query.mesh.enable": "true",
    "tsd.query.mesh.min_series": "8",
    # the aggregate cache (storage/agg_cache.py)
    "tsd.query.cache.enable": "true",
    "tsd.query.cache.mb": "256",
    "tsd.query.cache.device_mb": "64",
    "tsd.query.cache.block_windows": "32",
    "tsd.query.cache.min_repeats": "2",
    "tsd.query.cache.promote_hits": "2",
    "tsd.query.cache.amortize_horizon": "32",
    "tsd.query.cache.dispatch_overhead_us": "150",
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
    # written rollups (rollup/, the planner's segment arm)
    "tsd.rollups.enable": "false",
    "tsd.rollups.config": "",
    "tsd.rollups.tag_raw": "false",
    "tsd.rollups.agg_tag_key": "_aggregate",
    "tsd.rollups.raw_agg_tag_value": "RAW",
    "tsd.rollups.block_derived": "true",
    "tsd.rollups.split_query.enable": "false",
    # maintenance-built rollup lanes (storage/rollup.py)
    "tsd.rollup.enable": "false",
    "tsd.rollup.intervals": "1m,1h,1d",
    "tsd.rollup.mb": "256",
    "tsd.rollup.block_windows": "64",
    "tsd.rollup.interval": "5",
    "tsd.rollup.refresh_blocks": "32",
    "tsd.rollup.delay_ms": "0",
}

# Reference keys of subsystems the port does not have yet, each of which
# changes an answer or durability when it leaves its default: key ->
# (the reference's default, the ROADMAP item that ports it).  A key that
# ends in "." names every key under it; those not listed here have no
# default the port knows and are refused whenever they are set.
_SLICE9_DURABILITY = "A, slice 9 (durability, with replication)"
_SLICE9_CLUSTER = "A, slice 9 (the cluster)"
UNPORTED: dict[str, tuple[str, str]] = {
    "tsd.storage.directory": ("", _SLICE9_DURABILITY),
    "tsd.network.cluster.": ("", _SLICE9_CLUSTER),
    "tsd.network.cluster.peers": ("", _SLICE9_CLUSTER),
    "tsd.network.cluster.self": ("", _SLICE9_CLUSTER),
    "tsd.network.cluster.shard.enable": ("false", _SLICE9_CLUSTER),
    # a mesh over several hosts (the reference's jax.distributed); the
    # port's mesh spans the CUDA devices of one process
    "tsd.network.distributed.coordinator": ("", _SLICE9_CLUSTER),
    "tsd.network.distributed.num_processes": ("0", _SLICE9_CLUSTER),
    "tsd.network.distributed.process_id": ("", _SLICE9_CLUSTER),
}


def _same(value: str, default: str) -> bool:
    """A properties value equal to the default as the reference reads it:
    booleans by truth, integers by value, strings stripped."""
    value = value.strip()
    if value == default:
        return True
    if default in ("true", "false"):
        return (value.lower() in ("1", "true", "yes")) == (default == "true")
    try:
        return int(value) == int(default)
    except ValueError:
        return False


def refuse_unported(config: "Config") -> None:
    """Raise ValueError for the first key of UNPORTED that `config` sets
    away from the reference's default, naming its ROADMAP item."""
    for key in sorted(config.keys()):
        entry = UNPORTED.get(key)
        if entry is None:
            prefix = next((p for p in UNPORTED
                           if p.endswith(".") and key.startswith(p)), None)
            if prefix is None:
                continue
            entry = UNPORTED[prefix]
        default, item = entry
        if not _same(config.get_string(key), default):
            raise ValueError(
                "%s is not supported by opentsdb_tpu_torch yet: its "
                "subsystem is ported by ROADMAP %s" % (key, item))


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

    def keys(self) -> list[str]:
        return list(self._map)

    def get_string(self, key: str) -> str:
        if key not in self._map:
            raise KeyError(key)
        return self._map[key]

    def get_int(self, key: str) -> int:
        return int(self.get_string(key))

    def get_float(self, key: str) -> float:
        return float(self.get_string(key))

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
