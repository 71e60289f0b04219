"""The device mesh of the sharded query and rollup paths.

Port of opentsdb_tpu/parallel/mesh.py.  A mesh is a (series, time) grid
of devices:

* ``series``: data-parallel over time series (the salt-bucket analog,
  SaltScanner.java:269: one concurrent scanner per hash bucket becomes
  one device per series shard);
* ``time``: sequence-parallel over the time axis for long series (the
  3600 s row-chunking analog, Const.java:95), used by the rollup job.

Shards combine through the mesh's collectives (parallel/collectives.py):
every shard on a CUDA device of its own takes NCCL, every shard on one
device (the CPU tests' eight ``cpu`` entries, the one-card chip check's
``cuda:0`` entries) reduces on that device; any other placement is
refused when the mesh is built.  The owner, where results land, is
shard 0's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

AXIS_SERIES = "series"
AXIS_TIME = "time"


def mesh_shape_for(n_devices: int) -> tuple[int, int]:
    """Pick a (series, time) grid for n devices, series-major.

    Series parallelism is the cheaper axis (no halo/overlap concerns), so
    it gets the larger factor: 8 -> (4, 2), 4 -> (2, 2), 2 -> (2, 1),
    1 -> (1, 1)."""
    if n_devices < 1:
        raise ValueError("need at least one device")
    time = 1
    series = n_devices
    while series % 2 == 0 and series > 2 * time:
        series //= 2
        time *= 2
    return series, time


def normalize_device(device) -> torch.device:
    """A torch.device with its index: a bare ``cuda`` is ``cuda:0``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (series, time) grid of devices, flat in series-major order, with
    its collectives (one backend, fixed when the mesh is built)."""
    devices: tuple[torch.device, ...]
    shape: tuple[int, int]
    collectives: object

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def owner(self) -> torch.device:
        """Shard 0's device, where combined results land."""
        return self.devices[0]

    @property
    def backend(self) -> str:
        return self.collectives.backend

    def device_at(self, i: int, j: int) -> torch.device:
        """The device of series shard i, time shard j."""
        return self.devices[i * self.shape[1] + j]


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """A (series, time) mesh over the first `n_devices` of `devices`
    (every visible CUDA device, host-major, by default).  Devices may
    repeat: eight ``cpu`` entries are the tests' virtual mesh.  Raises
    when the placement has no collective backend (collectives.py)."""
    from opentsdb_tpu_torch.parallel.collectives import Collectives
    from opentsdb_tpu_torch.parallel.distributed import host_major_devices

    if devices is None:
        devices = host_major_devices()
    devices = [normalize_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        shape = mesh_shape_for(n)
    if shape[0] * shape[1] != n or n < 1:
        raise ValueError("mesh shape %r does not cover %d devices"
                         % (shape, n))
    return Mesh(tuple(devices), tuple(shape), Collectives(devices))
