"""The device mesh: sharded grouped queries, sharded streamed queries, the
sharded rollup job and the sharded group downsample (port of
opentsdb_tpu/parallel)."""

from opentsdb_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_SERIES, AXIS_TIME, Mesh, make_mesh, mesh_shape_for)
from opentsdb_tpu_torch.parallel.sharded import (  # noqa: F401
    SHARDED_AGGS, ShardedStreamAccumulator, shard_bounds, shard_rows,
    shard_rows_device, shard_series, sharded_grid_tail,
    sharded_group_downsample, sharded_query_pipeline, sharded_rollup)
