"""Cross-series aggregation at the union of timestamps: kernels U1, U2, U3.

Port of opentsdb_tpu/ops/union_agg.py (OpenTSDB AggregationIterator.java:
one aggregated value at every timestamp any member series holds, next()
:514, with the members missing a point contributing the value of the
aggregator's interpolation policy, nextLongValue :682 / nextDoubleValue
:735; a series participates only between its first and last point,
:411-465, :521-526).

All groups of a sub query travel in one [S, N] batch whose groups are
contiguous row runs, rows [offsets[g], offsets[g+1]) (group_agg.
group_offsets).  Every row's valid points form a time-sorted prefix
(mask[s, :count] True, the rest False), as the batch builders and R
(rate.point_rate) lay them out.

* ``union_merge`` (U1, csrc/union_merge.cu): per group, the sorted unique
  union of its members' timestamps, all groups in one flat u[U] with group
  offsets uoff[G + 1].
* ``union_reduce`` (U2, csrc/union_reduce.cu): per group and union slot,
  each member's exact or interpolated value, reduced over the members by a
  moment function.
* ``union_order`` (U3, csrc/union_order.cu): the same contributions
  (csrc/union_contrib.cuh, shared with U2), reduced by an order or rank
  function, first/last/diff/none in row order.

Unlike the reference, whose union has S*N slots with masked duplicates
between them, u holds only the union's slots, every one a real timestamp
of some member, so no output mask is needed.  ``union_merge_plain``,
``union_reduce_plain`` and ``union_order_plain`` are the plain PyTorch
versions; the last two keep the reference's tiling of the union axis
(_UNION_TILE_CELLS) so that their [members, slots] contribution matrix fits
in memory (the kernels form no such matrix).
"""

from __future__ import annotations

import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.aggregators import (
    LERP, ZIM, MAX_IF_MISSING, MIN_IF_MISSING, PREV, F64_MAX, I64_MAX,
    I64_MIN, MOMENT_CODES, ORDER_AGGS, POLICY_CODES, family, ma_window,
    moment_reduce, moving_average, order_args, order_reduce)
from opentsdb_tpu_torch.ops.rate import PAD_TS

# Cells of [members, slots] a tile of the plain versions materialises
# (the reference's ceiling, union_agg.py:123).
_UNION_TILE_CELLS = 1 << 24
# Merged slots a block of U1's merge rounds and compaction owns
# (csrc/union_merge.cu TILE; the kernel refuses a scratch buffer sized for
# another).
_MERGE_TILE = 2304


def interpolate(policy: str, int_mode: bool, x, x0, y0, x1, y1, exemplar):
    """A missing point's substitute at timestamps x, per policy: LERP
    between (x0, y0) and (x1, y1) (a truncating long division over
    max(dx, 1) in int mode), ZIM 0, MAX/MIN the type's sentinels (+-f64
    max, not inf; int64 max/min in int mode), PREV y0."""
    if policy == LERP:
        if int_mode:
            dx = (x1 - x0).clamp(min=1)
            return y0 + torch.div((x - x0) * (y1 - y0), dx,
                                  rounding_mode="trunc")
        dx = (x1 - x0).to(torch.float64)
        dx = torch.where(dx == 0, 1.0, dx)
        return y0 + (x - x0).to(torch.float64) * (y1 - y0) / dx
    if policy == ZIM:
        return torch.zeros_like(exemplar)
    if policy == MAX_IF_MISSING:
        return torch.full_like(exemplar, I64_MAX if int_mode else F64_MAX)
    if policy == MIN_IF_MISSING:
        return torch.full_like(exemplar, I64_MIN if int_mode else -F64_MAX)
    if policy == PREV:
        return y0
    raise ValueError("Invalid interpolation: " + policy)


def _check_rows(ts, mask, offsets) -> None:
    if ts.dim() != 2 or mask.shape != ts.shape:
        raise ValueError("ts and mask must share one [S, N] shape")
    if ts.dtype != torch.int64 or mask.dtype != torch.bool:
        raise TypeError("union kernels take ts int64 and mask bool")
    if offsets.dim() != 1 or offsets.numel() < 1 \
            or offsets.dtype != torch.int64:
        raise ValueError("offsets must be int64 [G + 1]")


# shape: ts[S,N] i64, mask[S,N] bool, offsets[G+1] i64
# shape: -> ([U] i64, [G+1] i64)
def union_merge(ts: torch.Tensor, mask: torch.Tensor, offsets: torch.Tensor):
    """U1 -> (u[U], uoff[G + 1]): group g's union timestamps, ascending
    and unique, are u[uoff[g]:uoff[g+1]].

    CPU tensors run the plain version.  CUDA tensors launch the kernel: it
    merges each group's rows pairwise over ceil(log2 S_g) rounds of the
    largest group (one read of the offsets), ping-ponging between the
    merged sequence and u itself, so its scratch is S*N int64 of merged
    timestamps and S*N bytes of run-start flags (0.61 GB at 1024 x 65,536
    points), as the all-pairs ranking it replaced took.  U is read back to
    size u (one synchronisation).
    """
    _check_rows(ts, mask, offsets)
    if ts.device.type == "cpu":
        return union_merge_plain(ts, mask, offsets)
    dev = kernels.require_cuda(ts, mask, offsets)
    s, n = ts.shape
    g = offsets.numel() - 1
    cap = s * n
    u = torch.empty(cap, dtype=torch.int64, device=dev)
    uoff = torch.zeros(g + 1, dtype=torch.int64, device=dev)
    if cap == 0 or g == 0:
        return u[:0], uoff
    rows = int((offsets[1:] - offsets[:-1]).max())
    rounds = max(1, (rows - 1).bit_length())
    # scratch: the merged sequence and its run-start flags, then the row
    # point offsets[S + 1], the tile counts and each tile boundary's
    # partition (six words)
    merged = torch.empty(cap, dtype=torch.int64, device=dev)
    first = torch.empty(cap, dtype=torch.uint8, device=dev)
    tiles = -(-cap // _MERGE_TILE) + 1
    scans = torch.empty(s + 1 + 7 * tiles, dtype=torch.int64, device=dev)
    kernels.launch(
        "union_merge", dev, kernels.ptr(ts), kernels.ptr(mask),
        kernels.ptr(offsets), s, n, g, rounds, kernels.ptr(merged),
        kernels.ptr(first), kernels.ptr(scans), scans.numel(),
        kernels.ptr(u), kernels.ptr(uoff))
    return u[:int(uoff[g])], uoff


def union_merge_plain(ts: torch.Tensor, mask: torch.Tensor,
                      offsets: torch.Tensor):
    """Plain PyTorch version of U1: torch.unique over each group's valid
    timestamps."""
    g = offsets.numel() - 1
    offs = offsets.tolist()
    parts = [torch.unique(ts[offs[i]:offs[i + 1]][mask[offs[i]:offs[i + 1]]])
             for i in range(g)]
    sizes = torch.tensor([0] + [p.numel() for p in parts], dtype=torch.int64)
    u = torch.cat(parts) if parts else ts.new_empty(0)
    return u, torch.cumsum(sizes, 0).to(ts.device)


def _check_union_inputs(ts, val, mask, offsets, u, uoff, policy) -> None:
    if policy not in POLICY_CODES:
        raise ValueError("Invalid interpolation: " + policy)
    _check_rows(ts, mask, offsets)
    if val.shape != ts.shape or val.dtype not in (torch.float64, torch.int64):
        raise TypeError("the union reduces take val float64 or int64 of "
                        "ts's shape")
    if u.dim() != 1 or u.dtype != torch.int64 or uoff.dtype != torch.int64 \
            or uoff.shape != offsets.shape:
        raise ValueError("the union reduces take u[U] and uoff[G + 1], "
                         "int64")


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, offsets[G+1] i64
# shape: u[U] i64, uoff[G+1] i64 -> [U] f64|i64
def union_reduce(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                 offsets: torch.Tensor, u: torch.Tensor, uoff: torch.Tensor,
                 agg_name: str, policy: str) -> torch.Tensor:
    """U2 -> out[U]: at every union slot of group g, `agg_name` over the
    group's members that participate there (the slot lies within the
    member's first and last timestamp), each contributing its value at the
    slot or, lacking one, the `policy` interpolation.

    float64 `val` skips NaN contributions and gives NaN where none
    participates (count gives 0).  int64 `val` is int mode: Java long
    arithmetic throughout and an int64 result.  CPU tensors run the plain
    version; CUDA tensors launch the kernel.
    """
    if agg_name not in MOMENT_CODES:
        raise KeyError("union_reduce computes the moments, not %r"
                       % agg_name)
    _check_union_inputs(ts, val, mask, offsets, u, uoff, policy)
    if ts.device.type == "cpu":
        return union_reduce_plain(ts, val, mask, offsets, u, uoff, agg_name,
                                  policy)
    dev = kernels.require_cuda(ts, val, mask, offsets, u, uoff)
    s, n = ts.shape
    out = torch.empty(u.numel(), dtype=val.dtype, device=dev)
    if u.numel() == 0:
        return out
    # each row's valid points, first and last timestamps
    rows = torch.empty(3 * s, dtype=torch.int64, device=dev)
    kernels.launch(
        "union_reduce", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(offsets), kernels.ptr(u),
        kernels.ptr(uoff), s, n, offsets.numel() - 1, u.numel(),
        MOMENT_CODES[agg_name], POLICY_CODES[policy],
        int(val.dtype == torch.int64), kernels.ptr(rows), kernels.ptr(out))
    return out


def union_reduce_plain(ts: torch.Tensor, val: torch.Tensor,
                       mask: torch.Tensor, offsets: torch.Tensor,
                       u: torch.Tensor, uoff: torch.Tensor, agg_name: str,
                       policy: str) -> torch.Tensor:
    """Plain PyTorch version of U2: _union_plain with moment_reduce."""
    return _union_plain(ts, val, mask, offsets, u, uoff, policy,
                        lambda c, p: moment_reduce(agg_name, c, p))


def _union_plain(ts, val, mask, offsets, u, uoff, policy,
                 reduce) -> torch.Tensor:
    """The reference's algorithm group by group: each member's
    searchsorted position of every slot, its bracketing points, the
    interpolation, then `reduce`(contrib, participate) over the members, in
    tiles of at most _UNION_TILE_CELLS [members, slots] cells."""
    int_mode = val.dtype == torch.int64
    n = ts.shape[1]
    offs, uoffs = offsets.tolist(), uoff.tolist()
    out = torch.empty(u.numel(), dtype=val.dtype, device=u.device)
    for g in range(len(offs) - 1):
        r0, r1 = offs[g], offs[g + 1]
        if uoffs[g] == uoffs[g + 1]:
            continue       # a group without points has no union slots
        t_g, v_g, m_g = ts[r0:r1], val[r0:r1], mask[r0:r1]
        padded = torch.where(m_g, t_g, PAD_TS)
        count = m_g.sum(dim=1, keepdim=True)
        first = padded[:, :1]
        last = torch.gather(t_g, 1, (count - 1).clamp(min=0))
        tile = max(_UNION_TILE_CELLS // (r1 - r0), 1)
        for k0 in range(uoffs[g], uoffs[g + 1], tile):
            k1 = min(k0 + tile, uoffs[g + 1])
            x = u[k0:k1].expand(r1 - r0, k1 - k0).contiguous()
            idx = torch.searchsorted(padded, x, side="left")
            idx_c = idx.clamp(max=n - 1)
            prev_i = (idx - 1).clamp(0, n - 1)
            x1 = torch.gather(t_g, 1, idx_c)
            y1 = torch.gather(v_g, 1, idx_c)
            exact = (idx < count) & (x1 == x)
            interp = interpolate(policy, int_mode, x,
                                 torch.gather(t_g, 1, prev_i),
                                 torch.gather(v_g, 1, prev_i), x1, y1, y1)
            contrib = torch.where(exact, y1, interp)
            in_range = (count > 0) & (x >= first) & (x <= last)
            out[k0:k1] = reduce(contrib, in_range)
    return out


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, offsets[G+1] i64
# shape: u[U] i64, uoff[G+1] i64 -> [U] f64|i64
def union_order(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                offsets: torch.Tensor, u: torch.Tensor, uoff: torch.Tensor,
                agg_name: str, policy: str) -> torch.Tensor:
    """U3 -> out[U]: at every union slot of group g, the order or rank
    function `agg_name` over the group's participating members in row
    order, each contributing as in union_reduce.

    float64 `val` skips NaN contributions and gives NaN where none
    participates.  int64 `val` is int mode: mult and diff wrap, the median
    is the exact long and a percentile is the truncated float64 one.  CPU
    tensors run the plain version; CUDA tensors launch the kernel: one
    pass over the whole union, every group's contributions reduced where
    they are made, with no scratch beyond the rows' point counts and no
    synchronisation.
    """
    if agg_name not in ORDER_AGGS:
        raise KeyError("union_order computes the order and rank functions, "
                       "not %r" % agg_name)
    _check_union_inputs(ts, val, mask, offsets, u, uoff, policy)
    if ts.device.type == "cpu":
        return union_order_plain(ts, val, mask, offsets, u, uoff, agg_name,
                                 policy)
    dev = kernels.require_cuda(ts, val, mask, offsets, u, uoff)
    s, n = ts.shape
    out = torch.empty(u.numel(), dtype=val.dtype, device=dev)
    if u.numel() == 0:
        return out
    counts = torch.empty(s, dtype=torch.int64, device=dev)
    code, q, est = order_args(agg_name)
    kernels.launch(
        "union_order", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(offsets), kernels.ptr(u),
        kernels.ptr(uoff), s, n, offsets.numel() - 1, u.numel(), code, q,
        est, POLICY_CODES[policy], int(val.dtype == torch.int64),
        kernels.ptr(counts), kernels.ptr(out))
    return out


def union_order_plain(ts: torch.Tensor, val: torch.Tensor,
                      mask: torch.Tensor, offsets: torch.Tensor,
                      u: torch.Tensor, uoff: torch.Tensor, agg_name: str,
                      policy: str) -> torch.Tensor:
    """Plain PyTorch version of U3: _union_plain with order_reduce."""
    return _union_plain(ts, val, mask, offsets, u, uoff, policy,
                        lambda c, p: order_reduce(agg_name, c, p))


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, offsets[G+1] i64
# shape: u[U] i64, uoff[G+1] i64 -> [U] f64|i64
def union_moving_average(ts: torch.Tensor, val: torch.Tensor,
                         mask: torch.Tensor, offsets: torch.Tensor,
                         u: torch.Tensor, uoff: torch.Tensor, n_window: int,
                         policy: str) -> torch.Tensor:
    """movingAverage<N> at the union slots (union_agg.py:179-207): U2's
    cross-series sum at every slot (0 where no member takes part, as the
    reference sums), then MA over each group's run of slots, every slot an
    evaluation; the window state never crosses a group."""
    sums = union_reduce(ts, val, mask, offsets, u, uoff, "sum", policy)
    if sums.is_floating_point():
        # U2 gives NaN where nothing participates; the reference's sum of
        # no contributions is 0
        count = union_reduce(ts, val, mask, offsets, u, uoff, "count",
                             policy)
        sums = torch.where(count == 0, 0.0, sums)
    return moving_average(sums, None, uoff, n_window)


# shape: ts[S,N] i64, val[S,N] f64|i64, mask[S,N] bool, offsets[G+1] i64
# shape: -> ([U] i64, [U] f64|i64, [G+1] i64)
def union_aggregate(ts: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
                    offsets: torch.Tensor, agg_name: str, policy: str):
    """U1, then U2 for a moment, U3 for an order or rank function, U2 and
    MA for movingAverage<N> -> (u[U], out[U], uoff[G + 1]), as
    opentsdb_tpu.ops.union_agg.union_aggregate computes for each group."""
    u, uoff = union_merge(ts, mask, offsets)
    kind = family(agg_name)
    if kind == "moment":
        out = union_reduce(ts, val, mask, offsets, u, uoff, agg_name, policy)
    elif kind == "order":
        out = union_order(ts, val, mask, offsets, u, uoff, agg_name, policy)
    else:
        out = union_moving_average(ts, val, mask, offsets, u, uoff,
                                   ma_window(agg_name), policy)
    return u, out, uoff
