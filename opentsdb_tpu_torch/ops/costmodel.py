"""Predicted seconds of the port's grouped query stages, of the rollup
lanes, for lane placement, and of a tiled plan's overhead.

Port of the terms of opentsdb_tpu/ops/costmodel.py and
obs/jaxprof.stage_breakdown (:286) that the rollup lanes read
(storage/rollup.py): ``stage_breakdown`` prices a grouped dispatch by
stage (downsample, rate, groupby, aggregate), ``predict_lane`` (:638) the
host assembly of a lane-served grid and ``predict_lane_build`` (:651) a
lane block build.  The lanes rank their demand by the saving per byte
that these predictions give.  ``predict_cache_gather``, a port term,
prices a device-cache hit's consult: the aggregate cache prices a plan
the device cache would answer by it.  ``predict_tiled`` (:608) prices what a
tiled execution (ops/tiling.py) adds: the spill pool's round trip and the
stripe replays.  ``coalesce_worthwhile`` (:682) is the batched arm's
verdict (query/plandecision.py): a plan whose predicted compute and
stack/unpack traffic stay within ``tsd.query.batch.amortize_factor`` x the
stacked-dispatch floor is dispatch-bound and goes through the dispatch
batcher.  ``per_chip`` is the share of a plan's rows, bytes or cells that
one device of the mesh holds: the routing verdict's budgets and
admission's out-of-core pricing read it under the mesh.  The reference's mode-selection half has no counterpart: the
port has one kernel per function.

The one table, ``CUDA_COSTS``, holds constants measured on an NVIDIA
H100 80GB HBM3 at 700 W by ``chip_smoke.py`` (it prints them as the
``costmodel cuda`` line; PERF.md names the run).  The reference's tpu and
cpu tables are not carried over.
"""

from __future__ import annotations

from opentsdb_tpu_torch.ops.aggregators import family

# bytes per lane cell: sum f64 + count i32 + min f64 + max f64
LANE_CELL_BYTES = 28

# seconds a unit: chip_smoke.py's `costmodel cuda` line on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md, PR 6, run 1)
CUDA_COSTS: dict[str, float] = {
    # a kernel launch through its wrapper, on the host clock
    "launch": 3.0439964999970924e-05,
    # K1 per raw point at the headline batch (1024 x 65,536, 1h)
    "downsample_point": 5.994319707269824e-12,
    # K4 per raw point (mult at the same batch)
    "order_point": 3.478622545571852e-11,
    # what a rate adds to K2, per [S, W] cell
    "rate_cell": 2.1090990593887263e-10,
    # K2 per [S, W] cell
    "group_cell": 7.950529898763651e-10,
    # K3 per [G, W] output cell
    "aggregate_cell": 1.5298940583589643e-09,
    # the host batch build of a grouped miss, per raw point
    "host_build_point": 2.9250691682103608e-09,
    # a device-cache consult that hits, per series: the host walk that
    # checks each series' version and bounds, and G1 (the gather phase
    # of phase 17 (b)'s int64 hits over 1024 series, PERF.md names the
    # run)
    "cache_gather_series": 1.0449218750000001e-05,
    # derive_grid and the edge windows' batches on the host, per MB
    # of lane cells read
    "lane_assemble_mb": 0.00409800212417827,
    # one lane block build (host batch, L1, copy back), per
    # (series, cell)
    "lane_build_cell": 1.551000023935337e-06,
    # a tiled plan's pool writes (K2's grids copied to the host and put)
    # and pool reads (stripes assembled on the host), per MB, and one
    # stripe replay (its copy to the card and its reduce): phase 15 of
    # chip_smoke.py on the same card (PERF.md names the run)
    "spill_write_mb": 0.0005706923990043238,
    "spill_read_mb": 0.0002072213020310592,
    "tile_dispatch": 0.0020319061666687808,
    # one stacked dispatch of the dispatch batcher (the host stack, one
    # upload, one K1 or K4, K2 and K3 or K5, the download), its floor and
    # per member cell (s * n + g * w): the host walls of 16 members of
    # phase 16's two panel shapes, on the same card (PERF.md names the
    # run)
    "stacked_dispatch": 0.0007323887140812703,
    "stacked_cell": 4.931113691491309e-09,
}


def features_tiled(spill_bytes: int, n_stripes: int) -> dict[str, float]:
    """Unit counts of what a tiled plan adds to the resident one (the
    reference's features_tiled, :589): the partial grids' MB written to
    and read from the pool, and the stripes replayed.  The reference
    counts every launch a tiled plan adds; the port's constant is
    measured per stripe replay, so the feature counts stripes."""
    mb = spill_bytes / 2.0 ** 20
    return {"spill_write_mb": mb, "spill_read_mb": mb,
            "tile_dispatch": float(n_stripes)}


def per_chip(amount: int, n_chips: int) -> int:
    """One chip's share of `amount` (rows, cells or bytes) when a mesh of
    `n_chips` devices shards the rows (the reference's ``// n_chips``,
    plandecision.py:128-147)."""
    return amount // max(n_chips, 1)


def predict_tiled(spill_bytes: int, n_stripes: int) -> float:
    """Predicted seconds a tiled execution adds to its plan's compute:
    the dot product of features_tiled with the cuda table."""
    feats = features_tiled(spill_bytes, n_stripes)
    return sum(u * CUDA_COSTS[term] for term, u in feats.items())


def stage_breakdown(s: int, n: int, w: int, g: int,
                    ds_function: str | None,
                    has_rate: bool) -> dict[str, float]:
    """Predicted seconds per stage of one grouped dispatch over s series
    of at most n points, w windows and g groups: K1 or K4 (downsample),
    what a rate adds to K2, K2 (groupby) and K3 (aggregate)."""
    c = CUDA_COSTS
    s, n, w, g = (max(int(x), 1) for x in (s, n, w, g))
    per_point = c["order_point"] \
        if ds_function is not None and family(ds_function) == "order" \
        else c["downsample_point"]
    out = {"downsample": c["launch"] + s * n * per_point}
    if has_rate:
        out["rate"] = s * w * c["rate_cell"]
    out["groupby"] = 2 * c["launch"] + s * w * c["group_cell"]
    out["aggregate"] = g * w * c["aggregate_cell"]
    return out


def predict_host_build(points: int) -> float:
    """Predicted seconds of the host batch build of `points` raw points:
    what a lane-served plan never pays."""
    return max(int(points), 0) * CUDA_COSTS["host_build_point"]


def predict_cache_gather(s: int) -> float:
    """Predicted seconds of a device-cache consult over s series that
    hits: what a hit pays instead of the host build."""
    return max(int(s), 0) * CUDA_COSTS["cache_gather_series"]


def predict_lane(s: int, w: int, k: int) -> float:
    """Predicted seconds of the lane-serve assembly (derive_grid) of an
    [s, w] grid at k lane cells a window: it reads s * w * k cells."""
    mb = s * w * max(k, 1) * LANE_CELL_BYTES / 2.0 ** 20
    return mb * CUDA_COSTS["lane_assemble_mb"]


def predict_lane_build(s: int, cells: int) -> float:
    """Predicted seconds of one lane block build over s series x `cells`
    lane cells."""
    return s * max(cells, 1) * CUDA_COSTS["lane_build_cell"]


def features_stacked(q: int, s: int, n: int, w: int,
                     g: int) -> dict[str, float]:
    """Unit counts of what batching adds to Q members' own compute (the
    reference's features_stacked, :655): one stacked-dispatch floor and
    the members' stacked cells, each member's [S, N] batch in and its
    [G, W] answer out."""
    return {"stacked_dispatch": 1.0,
            "stacked_cell": float(q * (s * n + g * w))}


def predict_stacked(q: int, s: int, n: int, w: int, g: int) -> float:
    """Predicted seconds of a stacked dispatch's overhead."""
    feats = features_stacked(q, s, n, w, g)
    return sum(u * CUDA_COSTS[term] for term, u in feats.items())


def coalesce_worthwhile(compute_s: float, s: int, n: int, w: int, g: int,
                        factor: float) -> bool:
    """The coalesce-or-dispatch-now verdict on one plan (:682): it is
    dispatch-bound, worth stacking, when its predicted compute plus its
    own stack/unpack cells stay within `factor` x the stacked-dispatch
    floor that a shared launch amortizes."""
    c = CUDA_COSTS
    member_s = float(s * n + g * w) * c["stacked_cell"]
    return compute_s + member_s <= factor * c["stacked_dispatch"]
