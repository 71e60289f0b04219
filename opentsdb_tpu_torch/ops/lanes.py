"""The rollup kernels, L1 lane_partials and L2 rollup_avg, and P1
point_group_moments.

Port of the device half of opentsdb_tpu/ops/pipeline.py's rollup
programs:

* ``lane_partials`` (L1, csrc/lane_partials.cu) is ``_lane_partials``
  (:190): the sum, count, min and max of every (series, window) cell of a
  time-sorted [S, N] batch, the mergeable partials that the rollup lanes
  (storage/rollup.py) hold and that the rollup job (rollup/job.py)
  writes.  Empty cells hold the identities (0, 0, +inf, -inf).
* ``rollup_avg`` (L2, csrc/rollup_avg.cu) is the quotient half of
  ``_rollup_avg_pipeline`` (:109) and ``_group_rollup_avg`` (:299): each
  window's sum over a sum lane divided by its sum over a count lane, then
  the fill policy.

* ``point_group_moments`` (P1, csrc/point_group_moments.cu) is the
  device half of opentsdb_tpu/parallel/sharded.py's
  ``sharded_group_downsample`` (:129, with ``_group_moments`` :52 and the
  segment reductions of ``_finish`` :86): a time-sorted [S, N] batch of
  raw points straight to [G, W] group-window moments, the rows of a group
  anywhere in the batch (``group_members`` lists them), in one of T1's
  modes (additive, extreme, square, centred).

All take the windows as the int64 edge vector e[W+1] that K1 takes
(ops/downsample.py), and each has its plain PyTorch version beside it
(``lane_partials_plain``, ``rollup_avg_plain``,
``point_group_moments_plain``), which CPU tensors run.
"""

from __future__ import annotations

import math

import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.downsample import (
    FILL_NONE, apply_fill, check_batch, fill_args, window_moments_plain)


def _cells(ts, val, mask, edges):
    """(cell[S*N] int64 with S*W for points outside every window or taking
    no part, ok[S*N], values[S*N] f64, s, w) as K1's plain version
    forms them."""
    s, _n = ts.shape
    w = edges.numel() - 1
    vf = val.to(torch.float64)
    win = torch.searchsorted(edges, ts, right=True) - 1
    ok = mask & ~torch.isnan(vf) & (win >= 0) & (win < w)
    rows = torch.arange(s, dtype=torch.int64, device=ts.device)[:, None]
    cell = torch.where(ok, rows * w + win, s * w).reshape(-1)
    return cell, ok.reshape(-1), vf.reshape(-1), s, w


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64
# shape: -> ([S,W] f64, [S,W] i32, [S,W] f64, [S,W] f64)
def lane_partials(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                  edges: torch.Tensor):
    """L1 -> (sums[S, W] f64, counts[S, W] int32, mins[S, W] f64,
    maxs[S, W] f64) of every (series, window) cell; masked slots and NaN
    values take no part.  CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    check_batch(ts, val, mask, edges)
    if ts.device.type == "cpu":
        return lane_partials_plain(ts, val, mask, edges)
    dev = kernels.require_cuda(ts, val, mask, edges)
    s, n = ts.shape
    w = edges.numel() - 1
    sums = torch.empty((s, w), dtype=torch.float64, device=dev)
    counts = torch.empty((s, w), dtype=torch.int32, device=dev)
    mins = torch.empty((s, w), dtype=torch.float64, device=dev)
    maxs = torch.empty((s, w), dtype=torch.float64, device=dev)
    if s == 0:
        return sums, counts, mins, maxs
    kernels.launch(
        "lane_partials", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), s, n, w,
        int(val.dtype == torch.int64), kernels.ptr(sums),
        kernels.ptr(counts), kernels.ptr(mins), kernels.ptr(maxs))
    return sums, counts, mins, maxs


def lane_partials_plain(ts: torch.Tensor, val: torch.Tensor,
                        mask: torch.Tensor, edges: torch.Tensor):
    """Plain PyTorch version of L1, the reference's algorithm: window ids
    by searchsorted, index_add_ for the sums and counts, scatter_reduce_
    for the extremes."""
    check_batch(ts, val, mask, edges)
    cell, ok, flat, s, w = _cells(ts, val, mask, edges)
    dev = ts.device

    def reduce(src, how, ident, dtype):
        acc = torch.full((s * w + 1,), ident, dtype=dtype, device=dev)
        if how == "sum":
            acc.index_add_(0, cell, src)
        else:
            acc.scatter_reduce_(0, cell, src, how, include_self=True)
        return acc[:-1].reshape(s, w)

    sums = reduce(torch.where(ok, flat, 0.0), "sum", 0.0, torch.float64)
    counts = reduce(ok.to(torch.int32), "sum", 0, torch.int32)
    mins = reduce(torch.where(ok, flat, torch.inf), "amin", torch.inf,
                  torch.float64)
    maxs = reduce(torch.where(ok, flat, -torch.inf), "amax", -torch.inf,
                  torch.float64)
    return sums, counts, mins, maxs


def _check_lanes(ts_s, val_s, mask_s, ts_c, val_c, mask_c, edges) -> None:
    check_batch(ts_s, val_s, mask_s, edges)
    check_batch(ts_c, val_c, mask_c, edges)
    if ts_s.shape[0] != ts_c.shape[0]:
        raise ValueError("the sum and count lanes must hold the same "
                         "series, got %d and %d rows"
                         % (ts_s.shape[0], ts_c.shape[0]))


# shape: ts_s[S,Ns] i64, val_s[S,Ns] f64|i64, mask_s[S,Ns] bool
# shape: ts_c[S,Nc] i64, val_c[S,Nc] f64|i64, mask_c[S,Nc] bool
# shape: edges[W+1] i64 -> ([S,W] f64, [S,W] bool)
def rollup_avg(ts_s: torch.Tensor, val_s: torch.Tensor,
               mask_s: torch.Tensor, ts_c: torch.Tensor,
               val_c: torch.Tensor, mask_c: torch.Tensor,
               edges: torch.Tensor, fill_policy: str = FILL_NONE,
               fill_value: float = 0.0):
    """L2 -> (values[S, W] f64, mask[S, W] bool): per (series, window) the
    sum lane's windowed sum over the count lane's, where both hold data
    and the count is above 0; then the fill policy over the other
    windows.  Row i of the sum batch and of the count batch is the same
    series; each batch is time-sorted with its own timestamps.  CPU
    tensors run the plain version; CUDA tensors launch the kernel."""
    _check_lanes(ts_s, val_s, mask_s, ts_c, val_c, mask_c, edges)
    if ts_s.device.type == "cpu":
        return rollup_avg_plain(ts_s, val_s, mask_s, ts_c, val_c, mask_c,
                                edges, fill_policy, fill_value)
    dev = kernels.require_cuda(ts_s, val_s, mask_s, ts_c, val_c, mask_c,
                               edges)
    s = ts_s.shape[0]
    w = edges.numel() - 1
    mode, fv = fill_args(fill_policy, fill_value)
    out = torch.empty((s, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, w), dtype=torch.bool, device=dev)
    if s == 0:
        return out, out_mask
    kernels.launch(
        "rollup_avg", dev, kernels.ptr(ts_s), kernels.ptr(val_s),
        kernels.ptr(mask_s), ts_s.shape[1], kernels.ptr(ts_c),
        kernels.ptr(val_c), kernels.ptr(mask_c), ts_c.shape[1],
        kernels.ptr(edges), s, w, mode, fv,
        int(val_s.dtype == torch.int64), int(val_c.dtype == torch.int64),
        kernels.ptr(out), kernels.ptr(out_mask))
    return out, out_mask


def rollup_avg_plain(ts_s: torch.Tensor, val_s: torch.Tensor,
                     mask_s: torch.Tensor, ts_c: torch.Tensor,
                     val_c: torch.Tensor, mask_c: torch.Tensor,
                     edges: torch.Tensor, fill_policy: str = FILL_NONE,
                     fill_value: float = 0.0):
    """Plain PyTorch version of L2, the reference's composition: K1's
    plain windowed sum of each lane, the quotient where both hold data and
    the count is above 0, then apply_fill."""
    _check_lanes(ts_s, val_s, mask_s, ts_c, val_c, mask_c, edges)
    sums, msum = window_moments_plain(ts_s, val_s, mask_s, edges, "sum")
    cnts, mcnt = window_moments_plain(ts_c, val_c, mask_c, edges, "sum")
    ok = msum & mcnt & (cnts > 0)
    v = torch.where(ok, sums / torch.where(ok, cnts, 1.0), torch.nan)
    return apply_fill(v, ok, fill_policy, fill_value)


# P1's modes (T1's, in its order) and the [G, W] lanes each writes
P1_MODES = ("additive", "extreme", "square", "centred")
P1_LANES = {"additive": ("cnt", "tot"), "extreme": ("cnt", "lo", "hi"),
            "square": ("cnt", "sq"), "centred": ("m2",)}
_P1_IDENTITY = {"cnt": 0, "tot": 0.0, "lo": math.inf, "hi": -math.inf,
                "sq": 0.0, "m2": 0.0}


def new_group_moments(num_groups: int, w: int, mode: str, device) -> dict:
    """P1's [G, W] lanes of `mode` holding the identities of cells no
    point reached: cnt 0 (int64), tot, sq and m2 0, lo +inf, hi -inf."""
    if mode not in P1_LANES:
        raise ValueError("P1 modes are %s, not %r"
                         % (", ".join(P1_MODES), mode))
    return {lane: torch.full(
        (num_groups, w), _P1_IDENTITY[lane],
        dtype=torch.int64 if lane == "cnt" else torch.float64,
        device=device) for lane in P1_LANES[mode]}


# shape: gid[S] i64 -> ([M] i64, [G+1] i64)
def group_members(gid: torch.Tensor, num_groups: int):
    """The stable member list of each group, on gid's device with no
    host sync: (members[M], offsets[G + 1]) int64, group g's rows being
    members[offsets[g]:offsets[g + 1]] in row order.  gid may be in any
    order; rows whose gid lies outside [0, G) belong to no group."""
    if gid.dim() != 1:
        raise ValueError("gid must be 1-D")
    gid = gid.to(torch.int64)
    key = torch.where((gid >= 0) & (gid < num_groups), gid, num_groups)
    ordered, members = torch.sort(key, stable=True)
    offsets = torch.searchsorted(ordered, torch.arange(
        num_groups + 1, dtype=torch.int64, device=gid.device))
    return members.contiguous(), offsets.contiguous()


def _check_members(ts, members, offsets, mode, mean, w) -> int:
    g = offsets.numel() - 1
    if mode not in P1_LANES:
        raise ValueError("P1 modes are %s, not %r"
                         % (", ".join(P1_MODES), mode))
    if members.dim() != 1 or offsets.dim() != 1 or g < 0 \
            or members.dtype != torch.int64 \
            or offsets.dtype != torch.int64:
        raise ValueError("members[M] and offsets[G + 1] are 1-D int64 "
                         "(group_members)")
    if ts.dtype != torch.int64:
        raise TypeError("P1 takes int64 timestamps")
    if (mode == "centred") != (mean is not None) \
            or (mean is not None and (mean.shape != (g, w)
                                      or mean.dtype != torch.float64)):
        raise ValueError("P1 takes a [G, W] f64 mean in the centred mode "
                         "only")
    return g


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, edges[W+1] i64,
# shape: members[M] i64, offsets[G+1] i64, mean[G,W] f64|None
# shape: -> {lane: [G,W]}
def point_group_moments(ts: torch.Tensor, val: torch.Tensor,
                        mask: torch.Tensor, edges: torch.Tensor,
                        members: torch.Tensor, offsets: torch.Tensor,
                        mode: str, mean: torch.Tensor | None = None) -> dict:
    """P1 -> the [G, W] lanes of `mode` (P1_LANES): per (group, window),
    over the member rows' points whose mask is set, that fall inside the
    windows and whose value (as f64) is not NaN: cnt counts them, tot adds
    them, lo and hi take their extremes, sq adds their squares, m2 their
    squared distances from the cell's `mean` (the centred mode, which
    takes it).  Group g is rows members[offsets[g]:offsets[g + 1]]
    (``group_members``); rows are time-sorted, as every batch of the
    store is.  CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    check_batch(ts, val, mask, edges)
    w = edges.numel() - 1
    g = _check_members(ts, members, offsets, mode, mean, w)
    if ts.device.type == "cpu":
        return point_group_moments_plain(ts, val, mask, edges, members,
                                         offsets, mode, mean)
    extra = [] if mean is None else [mean]
    dev = kernels.require_cuda(ts, val, mask, edges, members, offsets,
                               *extra)
    out = {lane: torch.empty((g, w), dtype=torch.int64 if lane == "cnt"
                             else torch.float64, device=dev)
           for lane in P1_LANES[mode]}
    if g == 0:
        return out

    def lane(key):
        return kernels.ptr(out[key]) if key in out else None

    kernels.launch(
        "point_group_moments", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), kernels.ptr(members),
        kernels.ptr(offsets), None if mean is None else kernels.ptr(mean),
        ts.shape[1], g, w, int(val.dtype == torch.int64),
        P1_MODES.index(mode), lane("cnt"), lane("tot"), lane("lo"),
        lane("hi"), lane("m2" if mode == "centred" else "sq"), mode=mode)
    return out


def point_group_moments_plain(ts: torch.Tensor, val: torch.Tensor,
                              mask: torch.Tensor, edges: torch.Tensor,
                              members: torch.Tensor, offsets: torch.Tensor,
                              mode: str,
                              mean: torch.Tensor | None = None) -> dict:
    """Plain PyTorch version of P1, the reference's algorithm: window ids
    by searchsorted, each point's cell (group x W + window), index_add_
    for the counts and sums, scatter_reduce_ for the extremes."""
    check_batch(ts, val, mask, edges)
    w = edges.numel() - 1
    g = _check_members(ts, members, offsets, mode, mean, w)
    dev = ts.device
    s = ts.shape[0]
    # each row's group, G for rows of none
    sizes = offsets[1:] - offsets[:-1]
    row_group = torch.full((s,), g, dtype=torch.int64, device=dev)
    row_group[members[:int(offsets[-1])]] = torch.repeat_interleave(
        torch.arange(g, dtype=torch.int64, device=dev), sizes)
    vf = val.to(torch.float64)
    win = torch.searchsorted(edges, ts, right=True) - 1
    ok = mask & ~torch.isnan(vf) & (win >= 0) & (win < w) \
        & (row_group < g)[:, None]
    cell = torch.where(ok, row_group[:, None] * w + win, g * w).reshape(-1)
    ok = ok.reshape(-1)
    flat = vf.reshape(-1)
    out = new_group_moments(g, w, mode, dev)
    if mode == "centred":
        mu = torch.cat([mean.reshape(-1), mean.new_zeros(1)])[cell]
        c = torch.where(ok, flat - mu, 0.0)
        src = {"m2": c * c}
    else:
        x = torch.where(ok, flat, 0.0)
        src = {"cnt": ok.to(torch.int64), "tot": x, "sq": x * x,
               "lo": torch.where(ok, flat, math.inf),
               "hi": torch.where(ok, flat, -math.inf)}
    for lane, acc in out.items():
        full = torch.cat([acc.reshape(-1), acc.new_full(
            (1,), _P1_IDENTITY[lane])])
        if lane in ("lo", "hi"):
            full.scatter_reduce_(0, cell, src[lane],
                                 "amin" if lane == "lo" else "amax",
                                 include_self=True)
        else:
            full.index_add_(0, cell, src[lane])
        out[lane] = full[:-1].reshape(g, w)
    return out
