"""The devices a default query mesh covers.

Port of the single-host half of opentsdb_tpu/parallel/distributed.py.
The reference joins several TSD processes into one JAX runtime
(``jax.distributed.initialize`` under ``tsd.network.distributed.*``) so
that its mesh spans hosts.  The port's mesh spans the CUDA devices of one
process; multi-host is not ported: a non-default
``tsd.network.distributed.coordinator``, ``num_processes`` or
``process_id`` is refused when the TSDB starts (utils/config.py
``UNPORTED``, ROADMAP A, slice 9 (the cluster)).
"""

from __future__ import annotations

import torch


def host_major_devices() -> list[torch.device]:
    """Every visible CUDA device of this host, by index: the order
    make_mesh lays on the series axis (the reference orders by process
    index, then device id; one process holds them all here)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
