"""Chunked (streamed) execution: kernels S1 stream_fold, S2 sketch_fold and
S3 stream_finish, and the accumulator they fold into.

Port of opentsdb_tpu/ops/streaming.py.  A grouped query too large to
materialize as one [S, N] batch is cut along time into bounded [S, n]
chunks (each series' own chunks time-ordered, as the store's scan
returns them, SaltScanner.java:463-740); each chunk's per-(series,
window) moments are merged into state held on the device, and the
finished [S, W] grid goes through the grouped tail (ops/pipeline.py
``run_grid_tail``).  Every downsample function of ``STREAMABLE_DS``
merges exactly:

* count and sum add; min and max take the extreme;
* dev and squareSum carry (n, total, m2) with the Chan et al. merge of
  the centered sum of squares (m2 of a chunk is two-pass: the window
  mean, then the centered sum);
* first sticks and last overwrites, since chunks arrive in time order;
  diff is last - first; mult multiplies.

Rank functions (median, p*, ep*r3, ep*r7) stream through a mergeable
summary: each chunk's exact SKETCH_K-point equi-rank grid of a cell is
merged with the cell's grid by weighted re-interpolation.  One merge
moves a quantile's rank by at most 1/(2K) of the cell's population, so
a cell fed by C chunks drifts at most about C/(2K) in rank; the planner
routes a query whose cells would take more than
``tsd.query.streaming.sketch_max_merges`` merges to the exact path.  The
ep*r3 and ep*r7 estimators collapse to the summary's interpolation, a
difference below its rank error.

A chunk of a time-ordered stream touches a contiguous run of windows, so
an accumulator made with a ``window_slice`` folds each chunk into the
state's columns [w0, w0 + wc) only, O(S * wc) a chunk whatever the grid's
width; valid points that fall outside the declared slice are counted
(``oob_count``), never dropped in silence.

On the device the fold is S2 (the sketch, when the state holds one) then
S1 (the moment lanes and the count), and the finish is S3; each has its
plain PyTorch version beside it (``stream_fold_plain``,
``sketch_fold_plain``, ``stream_finish_plain``), which CPU tensors run.
The windows travel as the int64 edge vector e[W+1] that K1 takes
(ops/downsample.py); a slice's edges are e[w0 : w0 + wc + 1].
"""

from __future__ import annotations

import ctypes
import math
import time
from dataclasses import dataclass

import torch

from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops.downsample import (
    FILL_NONE, FixedWindows, apply_fill, fill_args, window_timestamps)
from opentsdb_tpu_torch.ops.percentile import parse_percentile_name

# Summary points of a (series, window) quantile sketch.
SKETCH_K = 64

# The state lanes each downsample function's finish needs besides the
# count "n", which every state holds (it carries the output mask).
LANES_FOR = {
    "sum": {"total"}, "zimsum": {"total"}, "pfsum": {"total"},
    "count": set(), "avg": {"total"},
    "squareSum": {"total", "m2"}, "dev": {"total", "m2"},
    "min": {"lo"}, "mimmin": {"lo"}, "max": {"hi"}, "mimmax": {"hi"},
    "first": {"first"}, "last": {"last"}, "diff": {"first", "last"},
    "mult": {"prod"},
}
# Downsample functions whose window moments merge exactly.
STREAMABLE_DS = frozenset(LANES_FOR)
# The moment lanes in the order the kernels take them.
LANE_ORDER = ("total", "m2", "lo", "hi", "first", "last", "prod")
_ALL_LANES = frozenset(LANE_ORDER)
# A lane's value in a cell no point has reached: the merge's identity.
_EMPTY = {"total": 0.0, "m2": 0.0, "lo": math.inf, "hi": -math.inf,
          "first": 0.0, "last": 0.0, "prod": 1.0}

# Finish function -> S3's code (csrc/stream_finish.cu `enum Finish`).
FINISH_CODES = {
    "sum": 0, "zimsum": 0, "pfsum": 0, "count": 1, "avg": 2,
    "squareSum": 3, "dev": 4, "min": 5, "mimmin": 5, "max": 6,
    "mimmax": 6, "first": 7, "last": 8, "diff": 9, "mult": 10,
}
_FINISH_QUANTILE = 11


def pad_pow2(n: int, floor: int = 8) -> int:
    """The least power of two (at least `floor`) not below n: the
    reference's padded sizes (its chunk widths and its padded window
    counts, which its state budgets read)."""
    out = floor
    while out < n:
        out *= 2
    return out


def lanes_for(ds_functions) -> frozenset:
    """The moment lanes needed to finish every function of `ds_functions`.
    A rank function needs none (its state is the sketch); an unknown
    function takes every lane."""
    out: set = set()
    for fn in ds_functions:
        if is_sketch_ds(fn):
            continue
        out |= LANES_FOR.get(fn, _ALL_LANES)
    if "m2" in out:
        out.add("total")        # the centered pass needs the mean
    return frozenset(out)


def is_sketch_ds(name: str) -> bool:
    """Rank downsample functions, which stream through the sketch: median,
    p*, ep*r3, ep*r7."""
    if name == "median":
        return True
    if name.startswith(("p", "ep")) and name != "pfsum":
        try:
            parse_percentile_name(name)
            return True
        except (KeyError, ValueError):
            return False
    return False


def quantize_window_slice(window_slice, windows) -> int | None:
    """The slice width for a requested chunk span in windows, rounded up
    to a multiple of a power of two an eighth of its size; None where a
    slice cannot help (a grid that is not fixed, or a slice as wide as
    the grid)."""
    if window_slice is None or not isinstance(windows, FixedWindows):
        return None
    ws = max(int(window_slice), 1)
    bucket = 1 << max(6, ws.bit_length() - 3)
    wc = min(-(-ws // bucket) * bucket, windows.count)
    return None if wc >= windows.count else wc


def zero_state(s: int, w: int, device, sketch: bool = False,
               lanes: frozenset | None = None,
               with_oob: bool = False) -> dict:
    """An empty state of `lanes` (None: every lane) over [S, W] cells on
    `device`: "n" int64, each lane float64 at its identity, with `sketch`
    the summary "q" float32 [S, W, SKETCH_K], with `with_oob` the audit
    counter "oob" (int64, one element)."""
    lanes = _ALL_LANES if lanes is None else frozenset(lanes)
    if lanes - _ALL_LANES:
        raise ValueError("unknown state lanes: %s"
                         % sorted(lanes - _ALL_LANES))
    if "m2" in lanes and "total" not in lanes:
        raise ValueError("the m2 lane requires the total lane (use "
                         "lanes_for())")
    dev = torch.device(device)
    state = {"n": torch.zeros((s, w), dtype=torch.int64, device=dev)}
    for name in LANE_ORDER:
        if name in lanes:
            state[name] = torch.full((s, w), _EMPTY[name],
                                     dtype=torch.float64, device=dev)
    if sketch:
        state["q"] = torch.zeros((s, w, SKETCH_K), dtype=torch.float32,
                                 device=dev)
    if with_oob:
        state["oob"] = torch.zeros(1, dtype=torch.int64, device=dev)
    return state


def _check_chunk(state: dict, ts, val, mask, edges, w0: int) -> None:
    """Validate a chunk and its slice [w0, w0 + wc) against the state."""
    if ts.dim() != 2 or val.shape != ts.shape or mask.shape != ts.shape:
        raise ValueError("ts, val and mask must share one [S, n] shape")
    if ts.dtype != torch.int64 or val.dtype != torch.float64 \
            or mask.dtype != torch.bool:
        raise TypeError("a chunk is ts int64, val float64, mask bool")
    if edges.dim() != 1 or edges.dtype != torch.int64 or edges.numel() < 2:
        raise ValueError("edges must be int64 [wc+1] with wc >= 1")
    s, w = state["n"].shape
    wc = edges.numel() - 1
    if ts.shape[0] != s:
        raise ValueError("the chunk has %d rows, the state %d"
                         % (ts.shape[0], s))
    if not 0 <= w0 <= w - wc:
        raise ValueError("slice [%d, %d) outside the state's %d windows"
                         % (w0, w0 + wc, w))


def _cells(ts, val, mask, edges):
    """(window [S, n], ok [S, n], cell [S*n] with S*wc for points that
    take no part, s, wc): each point's window and cell as K1's plain
    version forms them; masked slots and NaN values take no part."""
    s, _n = ts.shape
    wc = edges.numel() - 1
    win = torch.searchsorted(edges, ts, right=True) - 1
    ok = mask & ~torch.isnan(val) & (win >= 0) & (win < wc)
    rows = torch.arange(s, dtype=torch.int64, device=ts.device)[:, None]
    cell = torch.where(ok, rows * wc + win, s * wc).reshape(-1)
    return win, ok, cell, s, wc


# -- S1: the moment lanes --------------------------------------------------


def chunk_moments_plain(ts, val, mask, edges, lanes) -> dict:
    """One chunk's moments per (series, window) cell of `edges` ->
    {"n": int64 [S, wc], lane: float64 [S, wc] for each of `lanes`}, the
    reference's ``_chunk_moments`` (:246) and ``_segment_chunk_moments``
    (:154), which give one answer.  A cell no point reaches holds each
    lane's identity."""
    _win, ok, cell, s, wc = _cells(ts, val, mask, edges)
    vf, okf = val.reshape(-1), ok.reshape(-1)
    dev = ts.device

    def cellsum(x):
        acc = torch.zeros(s * wc + 1, dtype=x.dtype, device=dev)
        return acc.index_add_(0, cell, x)[:-1].reshape(s, wc)

    def cellreduce(src, how, ident):
        acc = torch.full((s * wc + 1,), ident, dtype=src.dtype, device=dev)
        return acc.scatter_reduce_(0, cell, src, how,
                                   include_self=True)[:-1].reshape(s, wc)

    cnt = cellsum(okf.to(torch.int64))
    out = {"n": cnt}
    if "total" in lanes:
        tot = cellsum(torch.where(okf, vf, 0.0))
        out["total"] = tot
        if "m2" in lanes:
            mean = torch.cat([(tot / cnt.clamp(min=1)).reshape(-1),
                              torch.zeros(1, dtype=torch.float64,
                                          device=dev)])
            centered = torch.where(okf, vf - mean[cell], 0.0)
            out["m2"] = cellsum(centered * centered)
    if "lo" in lanes:
        out["lo"] = cellreduce(torch.where(okf, vf, math.inf), "amin",
                               math.inf)
    if "hi" in lanes:
        out["hi"] = cellreduce(torch.where(okf, vf, -math.inf), "amax",
                               -math.inf)
    if lanes & {"first", "last"}:
        top = vf.numel()
        pos = torch.arange(top, dtype=torch.int64, device=dev)
        if "first" in lanes:
            i = cellreduce(torch.where(okf, pos, top), "amin", top)
            out["first"] = torch.where(cnt > 0, vf[i.clamp(0, top - 1)],
                                       0.0)
        if "last" in lanes:
            i = cellreduce(torch.where(okf, pos, -1), "amax", -1)
            out["last"] = torch.where(cnt > 0, vf[i.clamp(0, top - 1)], 0.0)
    if "prod" in lanes:
        out["prod"] = cellreduce(torch.where(okf, vf, 1.0), "prod", 1.0)
    return out


def merge_moments_plain(state: dict, chunk: dict) -> dict:
    """The associative merge of two moment sets, lane by lane (the
    reference's ``_merge``, :462; Chan et al. for m2).  A cell the chunk
    does not reach keeps the state's values."""
    n1, n2 = state["n"], chunk["n"]
    had, got = n1 > 0, n2 > 0
    merged = {"n": n1 + n2}
    if "total" in state:
        t1, t2 = state["total"], chunk["total"]
        merged["total"] = t1 + t2
        if "m2" in state:
            nf1, nf2 = n1.to(torch.float64), n2.to(torch.float64)
            safe_n = (n1 + n2).clamp(min=1).to(torch.float64)
            mean1 = t1 / nf1.clamp(min=1.0)
            mean2 = t2 / nf2.clamp(min=1.0)
            delta = torch.where(had & got, mean2 - mean1, 0.0)
            merged["m2"] = (state["m2"] + chunk["m2"]
                            + delta * delta * nf1 * nf2 / safe_n)
    if "lo" in state:
        merged["lo"] = torch.minimum(state["lo"], chunk["lo"])
    if "hi" in state:
        merged["hi"] = torch.maximum(state["hi"], chunk["hi"])
    # chunks arrive in time order: first sticks, last overwrites
    if "first" in state:
        merged["first"] = torch.where(had | ~got, state["first"],
                                      chunk["first"])
    if "last" in state:
        merged["last"] = torch.where(got, chunk["last"], state["last"])
    if "prod" in state:
        merged["prod"] = state["prod"] * chunk["prod"]
    return merged


def _moment_keys(state: dict) -> list:
    return ["n"] + [k for k in LANE_ORDER if k in state]


# shape: ts[S,n] i64, val[S,n] f64, mask[S,n] bool, edges[wc+1] i64
def stream_fold(state: dict, ts: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor, edges: torch.Tensor, w0: int = 0,
                audit: tuple | None = None) -> None:
    """S1: fold one chunk's moments into the state's columns [w0, w0 +
    wc), in place, where `edges`[wc+1] are the edges of those windows.
    With `audit` = (grid_lo, grid_hi), the valid points of the chunk in
    [grid_lo, grid_hi) that the slice does not hold are added to
    state["oob"].  The sketch, when the state holds one, is folded by
    sketch_fold before this call (it reads the count before the merge).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_chunk(state, ts, val, mask, edges, w0)
    if audit is not None and "oob" not in state:
        raise ValueError("an audited fold needs a state made with_oob")
    if ts.device.type == "cpu":
        stream_fold_plain(state, ts, val, mask, edges, w0, audit)
        return
    keys = _moment_keys(state) + (["oob"] if audit is not None else [])
    dev = kernels.require_cuda(ts, val, mask, edges,
                               *(state[k] for k in keys))
    s, n = ts.shape
    w = state["n"].shape[1]
    wc = edges.numel() - 1
    if s == 0:
        return
    lanes = [kernels.ptr(state[k]) if k in state else ctypes.c_void_p(None)
             for k in LANE_ORDER]
    oob = ctypes.c_void_p(None)
    grid_lo = grid_hi = 0
    if audit is not None:
        oob = kernels.ptr(state["oob"])
        grid_lo, grid_hi = int(audit[0]), int(audit[1])
    kernels.launch(
        "stream_fold", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), s, n, wc, w, int(w0),
        kernels.ptr(state["n"]), *lanes, oob, grid_lo, grid_hi)


def stream_fold_plain(state: dict, ts, val, mask, edges, w0: int = 0,
                      audit: tuple | None = None) -> None:
    """Plain PyTorch version of S1: the chunk's moments on the slice's
    windows (chunk_moments_plain), merged into the slice
    (merge_moments_plain), and the audit as the reference's
    ``_update_sliced`` (:513) counts it: the valid points in the grid
    less the points the slice holds."""
    wc = edges.numel() - 1
    keys = _moment_keys(state)
    lanes = frozenset(keys[1:])
    chunk = chunk_moments_plain(ts, val, mask, edges, lanes)
    cur = {k: state[k][:, w0:w0 + wc] for k in keys}
    merged = merge_moments_plain(cur, chunk)
    for k in keys:
        state[k][:, w0:w0 + wc] = merged[k]
    if audit is not None:
        ok = mask & ~torch.isnan(val)
        in_grid = (ok & (ts >= int(audit[0])) & (ts < int(audit[1]))).sum()
        state["oob"] += in_grid - chunk["n"].sum()


# -- S2: the quantile sketch -------------------------------------------------


def rank_grid_plain(sorted_rows, starts, cnt, k: int = SKETCH_K):
    """Exact k-point equi-rank grid per cell from row-sorted runs (the
    reference's ``_rank_grid``, :351): cell (s, w) holds its cnt[s, w]
    values ascending at columns [starts[s, w], starts[s, w] + cnt[s, w])
    of sorted_rows[S, N]; q[s, w, j] is the value at fractional rank
    (j + 0.5) / k, linearly interpolated between neighbouring order
    statistics; an empty cell is all zeros.  -> float64 [S, W, k]."""
    s, w = cnt.shape
    dev = cnt.device
    cf = cnt.to(torch.float64)[:, :, None]
    fr = (torch.arange(k, dtype=torch.float64, device=dev)[None, None, :]
          + 0.5) / k * cf - 0.5
    fr = torch.minimum(fr.clamp(min=0.0), (cf - 1.0).clamp(min=0.0))
    lo = torch.floor(fr)
    frac = fr - lo
    top = sorted_rows.shape[1] - 1
    base = starts[:, :, None].to(torch.int64)
    i_lo = (base + lo.to(torch.int64)).clamp(0, top)
    i_hi = (base + lo.to(torch.int64) + 1).clamp(0, top)
    last = base + (cnt[:, :, None].to(torch.int64) - 1).clamp(min=0)
    i_hi = torch.minimum(i_hi, last)
    v_lo = torch.gather(sorted_rows, 1, i_lo.reshape(s, w * k)).reshape(
        s, w, k)
    v_hi = torch.gather(sorted_rows, 1, i_hi.reshape(s, w * k)).reshape(
        s, w, k)
    q = v_lo + frac * (v_hi - v_lo)
    return torch.where(cnt[:, :, None] > 0, q, 0.0)


def interp_rows_plain(t, xp, fp):
    """Row-wise linear interpolation of fp over xp at t (the reference's
    ``_interp_rows``, :384): t[C, K], xp and fp [C, X], xp ascending.
    Where a bracket's two values are equal (or its width is 0) the result
    is the bracket's lower value, so grids holding infinite values do not
    turn into inf - inf."""
    x = xp.shape[1]
    idx = torch.searchsorted(xp.contiguous(), t.contiguous(), right=False)
    lo = (idx - 1).clamp(0, x - 1)
    hi = idx.clamp(0, x - 1)
    x_lo = torch.gather(xp, 1, lo)
    x_hi = torch.gather(xp, 1, hi)
    f_lo = torch.gather(fp, 1, lo)
    f_hi = torch.gather(fp, 1, hi)
    dx = x_hi - x_lo
    frac = torch.where(dx > 0, (t - x_lo) / torch.where(dx > 0, dx, 1.0),
                       0.0)
    same = (f_lo == f_hi) | (dx <= 0)
    return torch.where(same, f_lo, f_lo + frac * (f_hi - f_lo))


def merge_sketch_plain(q1, n1, q2, n2, k: int = SKETCH_K):
    """Weighted merge of two cells' summaries into one k-point grid (the
    reference's ``_merge_sketch``, :406): every summary point weighs n/k
    at its midpoint rank, and the merged grid reads the mixture's
    cumulative weight at the k midpoint targets.  A side with no points
    weighs nothing: its points sort last and take the row's greatest
    carried value, so that they move no target, while a real +inf value
    keeps its place.  q1, q2 float32 [C, k]; n1, n2 int64 [C] -> float32
    [C, k]."""
    nf1 = n1.to(torch.float64)[:, None]
    nf2 = n2.to(torch.float64)[:, None]
    v = torch.cat([q1, q2], dim=1)
    wt = torch.cat([(nf1 / k).expand_as(q1), (nf2 / k).expand_as(q2)], dim=1)
    sentinel = wt <= 0
    key = torch.where(sentinel, torch.inf, v)
    order = torch.sort(key, dim=1, stable=True).indices
    v = torch.gather(v, 1, order)
    wt = torch.gather(wt, 1, order)
    sentinel = torch.gather(sentinel, 1, order)
    vmax = torch.where(sentinel, -torch.inf, v).max(dim=1,
                                                    keepdim=True).values
    v = torch.where(sentinel, vmax, v)
    cum = torch.cumsum(wt, dim=1) - 0.5 * wt
    total = nf1 + nf2
    targets = (torch.arange(k, dtype=torch.float64, device=q1.device)[None, :]
               + 0.5) / k * total
    merged = interp_rows_plain(targets, cum, v)
    both_zero = (n1 + n2) <= 0
    return torch.where(both_zero[:, None], 0.0, merged).to(q1.dtype)


# shape: ts[S,n] i64, val[S,n] f64, mask[S,n] bool, edges[wc+1] i64
def sketch_fold(state: dict, ts: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor, edges: torch.Tensor,
                w0: int = 0) -> None:
    """S2: merge each cell's exact SKETCH_K-point grid of the chunk into
    the state's sketch q[:, w0:w0 + wc], in place, weighted by the cell's
    count before this chunk (state["n"], which stream_fold updates after
    this call) and the chunk's own count.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_chunk(state, ts, val, mask, edges, w0)
    if "q" not in state:
        raise ValueError("the state holds no sketch")
    if ts.device.type == "cpu":
        sketch_fold_plain(state, ts, val, mask, edges, w0)
        return
    dev = kernels.require_cuda(ts, val, mask, edges, state["n"], state["q"])
    s, n = ts.shape
    w = state["n"].shape[1]
    wc = edges.numel() - 1
    if s == 0:
        return
    # the cells whose runs pass 256 points, listed for the block path
    cell_list = torch.empty(s * wc + 1, dtype=torch.int64, device=dev)
    kernels.launch(
        "sketch_fold", dev, kernels.ptr(ts), kernels.ptr(val),
        kernels.ptr(mask), kernels.ptr(edges), s, n, wc, w, int(w0),
        kernels.ptr(state["n"]), kernels.ptr(state["q"]),
        kernels.ptr(cell_list))


def sketch_fold_plain(state: dict, ts, val, mask, edges,
                      w0: int = 0) -> None:
    """Plain PyTorch version of S2, the reference's algorithm: each row
    sorted by (window, value) (two stable sorts), the grid of every cell
    of the slice (rank_grid_plain, cast to float32), then the weighted
    merge (merge_sketch_plain) with the slice's summaries."""
    win, ok, cell, s, wc = _cells(ts, val, mask, edges)
    cnt = torch.zeros(s * wc + 1, dtype=torch.int64,
                      device=ts.device).index_add_(
        0, cell, ok.reshape(-1).to(torch.int64))[:-1].reshape(s, wc)
    by_val = torch.sort(torch.where(ok, val, torch.inf), dim=1,
                        stable=True).indices
    wkey = torch.gather(torch.where(ok, win, wc), 1, by_val)
    order = torch.gather(by_val, 1,
                         torch.sort(wkey, dim=1, stable=True).indices)
    sorted_rows = torch.gather(val, 1, order)
    starts = torch.cumsum(cnt, dim=1) - cnt
    q2 = rank_grid_plain(sorted_rows, starts, cnt).to(torch.float32)
    q1 = state["q"][:, w0:w0 + wc]
    n1 = state["n"][:, w0:w0 + wc]
    merged = merge_sketch_plain(q1.reshape(-1, SKETCH_K), n1.reshape(-1),
                                q2.reshape(-1, SKETCH_K), cnt.reshape(-1))
    state["q"][:, w0:w0 + wc] = merged.reshape(s, wc, SKETCH_K)


def sketch_quantile_plain(q, n, pct: float):
    """The pct-quantile (0-100) of summaries q[..., K] over n[...] points
    (the reference's ``sketch_quantile``, :444): linear interpolation on
    the midpoint-rank grid."""
    k = q.shape[-1]
    nf = n.to(torch.float64).clamp(min=1.0)
    lead = q.shape[:-1]
    qs = q.reshape(-1, k)
    nfs = nf.reshape(-1, 1)
    mid = (torch.arange(k, dtype=torch.float64, device=q.device)[None, :]
           + 0.5) / k * nfs
    target = float(pct) / 100.0 * nfs
    return interp_rows_plain(target, mid, qs)[:, 0].reshape(lead)


# -- S3: the finish ----------------------------------------------------------


def _finish_args(state: dict, ds_function: str) -> tuple[int, float]:
    """(S3 code, percentile) for `ds_function`; KeyError when the state
    lacks a lane it needs or the function does not stream."""
    missing = LANES_FOR.get(ds_function, frozenset()) - frozenset(state)
    if missing:
        raise KeyError(
            "accumulator lacks lane(s) %s for %s: create it with "
            "lanes=lanes_for([...]) covering every finish function"
            % (sorted(missing), ds_function))
    if ds_function in FINISH_CODES:
        return FINISH_CODES[ds_function], 0.0
    if "q" in state and is_sketch_ds(ds_function):
        pct = 50.0 if ds_function == "median" \
            else parse_percentile_name(ds_function)[0]
        return _FINISH_QUANTILE, pct
    raise KeyError("Downsample function does not stream: " + ds_function)


# shape: state n[S,W] i64 -> ([S,W] f64, [S,W] bool)
def stream_finish(state: dict, ds_function: str,
                  fill_policy: str = FILL_NONE, fill_value: float = 0.0):
    """S3: each cell's value of `ds_function` from the state's lanes (or
    its sketch for a rank function), then the fill policy -> (values[S,
    W] float64, mask[S, W] bool).  A cell holding no point is empty.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    code, pct = _finish_args(state, ds_function)
    if state["n"].device.type == "cpu":
        return stream_finish_plain(state, ds_function, fill_policy,
                                   fill_value)
    need = ["q"] if code == _FINISH_QUANTILE else LANES_FOR[ds_function]
    dev = kernels.require_cuda(state["n"], *(state[k] for k in need))
    s, w = state["n"].shape
    mode, fv = fill_args(fill_policy, fill_value)
    out = torch.empty((s, w), dtype=torch.float64, device=dev)
    out_mask = torch.empty((s, w), dtype=torch.bool, device=dev)
    if s * w == 0:
        return out, out_mask
    ptrs = [kernels.ptr(state[k]) if k in state else ctypes.c_void_p(None)
            for k in LANE_ORDER + ("q",)]
    kernels.launch("stream_finish", dev, kernels.ptr(state["n"]), *ptrs,
                   s * w, code, pct, mode, fv, kernels.ptr(out),
                   kernels.ptr(out_mask))
    return out, out_mask


def stream_finish_plain(state: dict, ds_function: str,
                        fill_policy: str = FILL_NONE,
                        fill_value: float = 0.0):
    """Plain PyTorch version of S3, the reference's ``_finish`` (:596)
    and ``apply_fill`` (downsample.py:1270): squareSum is m2 + total^2/n,
    dev and diff need two points, a rank function reads the sketch."""
    code, pct = _finish_args(state, ds_function)
    n = state["n"]
    safe = n.clamp(min=1)
    if code == 0:
        out = state["total"]
    elif code == 1:
        out = n.to(torch.float64)
    elif code == 2:
        out = state["total"] / safe
    elif code == 3:
        out = state["m2"] + state["total"] * state["total"] / safe
    elif code == 4:
        out = torch.where(n >= 2, torch.sqrt(state["m2"]
                                             / (n - 1).clamp(min=1)), 0.0)
    elif code == 5:
        out = state["lo"]
    elif code == 6:
        out = state["hi"]
    elif code == 7:
        out = state["first"]
    elif code == 8:
        out = state["last"]
    elif code == 9:
        out = torch.where(n >= 2, state["last"] - state["first"], 0.0)
    elif code == 10:
        out = state["prod"]
    else:
        out = sketch_quantile_plain(state["q"], n, pct)
    return apply_fill(out, n > 0, fill_policy, fill_value)


# -- the accumulator -------------------------------------------------------


@dataclass
class StreamAccumulator:
    """Per-(series, window) state on one device, fed chunk by chunk::

        acc = StreamAccumulator.create(num_series, windows, device)
        for ts, val, mask in chunks:        # each series in time order
            acc.update(ts, val, mask)       # [S, n] chunks on the device
        wts, values, mask = acc.finish("avg")

    `windows` is the host window plan (ops.downsample FixedWindows,
    EdgeWindows or AllWindow).  The launches are queued on the device's
    current stream; nothing here synchronises but oob_count."""
    windows: object
    edges: torch.Tensor        # [W+1] int64 on the state's device
    state: dict
    window_slice: int | None = None

    @staticmethod
    def create(num_series: int, windows, device, sketch: bool = False,
               lanes: frozenset | None = None,
               window_slice: int | None = None) -> "StreamAccumulator":
        """`sketch` adds the [S, W, SKETCH_K] summary, so that rank
        functions can finish; `lanes` (from lanes_for) restricts the
        state to what the finish functions need; `window_slice` (fixed
        grids) is the number of windows any one chunk can span, and
        enables sliced updates: update(..., w0=...) then folds each chunk
        into [w0, w0 + window_slice) only."""
        dev = torch.device(device)
        wc = quantize_window_slice(window_slice, windows)
        state = zero_state(num_series, windows.count, dev, sketch, lanes,
                           with_oob=wc is not None)
        return StreamAccumulator(windows, windows.window_edges(dev), state,
                                 wc)

    @property
    def device(self) -> torch.device:
        return self.state["n"].device

    def update(self, ts: torch.Tensor, val: torch.Tensor,
               mask: torch.Tensor, w0: int | None = None) -> None:
        """Fold one [S, n] chunk in.  `w0` is the first grid window the
        chunk's points can touch (known on the host when chunks are cut
        along time); with a slice-enabled accumulator the chunk must fit
        in [w0, w0 + window_slice), and its valid points outside that
        slice are counted in oob_count() rather than folded."""
        w = self.windows.count
        audit = None
        if w0 is not None and self.window_slice is not None:
            wc = self.window_slice
            w0 = min(max(int(w0), 0), w - wc)
            first = self.windows.first_window_ms
            audit = (first, first + w * self.windows.interval_ms)
        else:
            w0, wc = 0, w
        edges = self.edges[w0:w0 + wc + 1]
        if "q" in self.state:
            sketch_fold(self.state, ts, val, mask, edges, w0)
        stream_fold(self.state, ts, val, mask, edges, w0, audit)

    def oob_count(self) -> int:
        """Valid points that sliced updates did not fold (a wrong w0);
        0 in correct use.  Synchronises with the device."""
        if "oob" not in self.state:
            return 0
        return int(self.state["oob"].item())

    def finish(self, ds_function: str, fill_policy: str = FILL_NONE,
               fill_value: float = 0.0):
        """(window_ts[W], values[S, W], mask[S, W]): the downsample
        output, as ops.downsample.downsample gives it."""
        out, mask = stream_finish(self.state, ds_function, fill_policy,
                                  fill_value)
        return window_timestamps(self.edges), out, mask


class ChunkFeed:
    """Double-buffered host-to-device chunk copies for a streamed scan.

    ``slots`` sets of [S, n] host buffers (ts int64, val float64, mask
    bool), pinned on a CUDA device, each with its device copy.  The host
    packs chunk k + 1 into one slot while the device folds chunk k from
    the other, the copy running on a stream of its own (SaltScanner's
    ScannerCB overlap, SaltScanner.java:463).  Two events keep it safe: a
    slot's host buffers are packed again only after its last copy has
    completed, and its device buffers are overwritten only after the fold
    that read them (``folded``) has.  On the CPU the host buffers are the
    chunk and nothing overlaps.

    ``pack_ms`` sums the host's packing time between ``take`` and
    ``upload``; ``timings()`` (after the folds have completed) sums the
    device's copy and fold times from CUDA events."""

    def __init__(self, device, s: int, n: int, slots: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = []
        for _ in range(slots):
            host = [torch.empty((s, n), dtype=dt, pin_memory=self.cuda)
                    for dt in (torch.int64, torch.float64, torch.bool)]
            dev = ([torch.empty((s, n), dtype=h.dtype, device=self.device)
                    for h in host] if self.cuda else host)
            self.slots.append({"host": host, "np": [h.numpy() for h in host],
                               "dev": dev, "copied": None, "folded": None})
        self.host_bytes = slots * s * n * (8 + 8 + 1)
        self.copy_stream = (torch.cuda.Stream(self.device) if self.cuda
                            else None)
        self._next = 0
        self._marks: list = []      # (copy start, copy end, fold start, fold end)
        self._t_take = None
        self.pack_ms = 0.0

    def take(self) -> tuple:
        """The next slot's host buffers as numpy arrays (ts, val, mask),
        once its previous copy has completed."""
        slot = self.slots[self._next % len(self.slots)]
        if slot["copied"] is not None:
            slot["copied"].synchronize()
        self._t_take = time.perf_counter()
        return tuple(slot["np"])

    def upload(self) -> tuple:
        """Copy the slot just packed to the device -> its device (ts, val,
        mask); the current stream waits for the copy.  The caller folds
        them and then calls folded()."""
        self.pack_ms += (time.perf_counter() - self._t_take) * 1e3
        slot = self.slots[self._next % len(self.slots)]
        self._next += 1
        if not self.cuda:
            return tuple(slot["dev"])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        cs = self.copy_stream
        if slot["folded"] is not None:
            cs.wait_event(slot["folded"])
        with torch.cuda.stream(cs):
            ev[0].record(cs)
            for d, h in zip(slot["dev"], slot["host"]):
                d.copy_(h, non_blocking=True)
            ev[1].record(cs)
        slot["copied"] = ev[1]
        main = torch.cuda.current_stream(self.device)
        main.wait_event(ev[1])
        ev[2].record(main)
        self._marks.append(ev)
        return tuple(slot["dev"])

    def folded(self) -> None:
        """Mark the fold of the chunk last uploaded as queued."""
        if not self.cuda:
            return
        slot = self.slots[(self._next - 1) % len(self.slots)]
        ev = self._marks[-1][3]
        ev.record(torch.cuda.current_stream(self.device))
        slot["folded"] = ev

    def timings(self) -> tuple[float, float]:
        """(copy ms, fold ms) summed over the chunks; synchronises."""
        h2d = fold = 0.0
        for ev in self._marks:
            ev[3].synchronize()
            h2d += ev[0].elapsed_time(ev[1])
            fold += ev[2].elapsed_time(ev[3])
        return h2d, fold


# -- the chunk loop ----------------------------------------------------------

_PAD_TS = 2 ** 63 - 1


def stream_grid(series_list, start_ms: int, end_ms: int, fix: bool, windows,
                device, step, sketch: bool, chunk_points: int,
                max_len: int | None = None, mesh=None):
    """The finished [S, W] downsample grid of `series_list` over [start_ms,
    end_ms], streamed -> ((wts[W], v[S, W], m[S, W]), info); with `mesh`,
    each row shard's grid (a list of (wts, v, m), the mesh's
    ShardedStreamAccumulator.finish) in place of the one grid.

    Bounded [S, n_chunk] chunks are copied out of the store
    (Series.window_chunk, a timestamp cursor a series) into a ChunkFeed's
    pinned buffers, copied to the device while the previous chunk folds,
    folded into a StreamAccumulator (S2, S1; one a row shard of `mesh`,
    parallel/sharded.py) and finished (S3) by `step`
    (function, fill_policy, fill_value).  The streamed route and each
    tile of a tiled plan run this loop.  `max_len` is the longest row's
    point count, counted here when not given.  `info` holds the chunk
    count, the pinned host bytes, the host's packing ms and the device's
    copy and fold ms.  A fold that misses a point raises: no answer that
    dropped points is served."""
    s = len(series_list)
    if max_len is None:
        max_len = max((sr.window_count(start_ms, end_ms, fix)
                       for sr in series_list), default=0)
    n_chunk = pad_pow2(max(1024, chunk_points // max(s, 1)))
    lanes = lanes_for([step.function])
    n_chunks = -(-max_len // n_chunk)
    use_slice = isinstance(windows, FixedWindows)
    feed = ChunkFeed(device, s, n_chunk)

    def make_acc(wslice):
        if mesh is not None:
            from opentsdb_tpu_torch.parallel.sharded import (
                ShardedStreamAccumulator)
            return ShardedStreamAccumulator(mesh, s, windows, sketch=sketch,
                                            lanes=lanes, window_slice=wslice)
        return StreamAccumulator.create(s, windows, device, sketch=sketch,
                                        lanes=lanes, window_slice=wslice)

    acc = None
    cursors: list = [None] * s
    for _ in range(n_chunks):
        ts, val, mask = feed.take()
        tmin = tmax = None
        for i, series in enumerate(series_list):
            t, _v = series.window_chunk(start_ms, end_ms, cursors[i],
                                        n_chunk, fix, ts[i], val[i])
            m = len(t)
            ts[i, m:] = _PAD_TS
            val[i, m:] = 0.0
            mask[i, :m] = True
            mask[i, m:] = False
            if m:
                cursors[i] = int(t[-1])
                tmin = int(t[0]) if tmin is None else min(tmin, int(t[0]))
                tmax = int(t[-1]) if tmax is None else max(tmax, int(t[-1]))
        if tmin is None:
            # a chunk without points folds nothing; skipping it before the
            # accumulator exists lets the slice be sized from the first
            # chunk that has points
            continue
        if acc is None:
            wslice = None
            if use_slice:
                # twice the first chunk's span: the series advance on
                # their own cursors, so later spans vary; a chunk that
                # still overflows takes the full-grid fold
                wslice = 2 * ((tmax - tmin) // windows.interval_ms + 2)
            acc = make_acc(wslice)
        w0 = None
        if acc.window_slice is not None and \
                (tmax - tmin) // windows.interval_ms + 2 <= acc.window_slice:
            w0 = (tmin - windows.first_window_ms) // windows.interval_ms
        d_ts, d_val, d_mask = feed.upload()
        acc.update(d_ts, d_val, d_mask, w0=w0)
        feed.folded()
    if acc is None:     # no chunk held a point: an empty state
        acc = make_acc(None)
    oob = acc.oob_count()
    h2d_ms, fold_ms = feed.timings()
    if oob:
        # w0 from each chunk's first point with a slice at least the
        # chunk's span makes this impossible: never serve an answer that
        # dropped points
        raise RuntimeError("internal: %d points fell outside their "
                           "declared streaming window slice" % oob)
    grid = acc.finish(step.function, step.fill_policy, step.fill_value)
    return grid, {"chunks": n_chunks, "hostBytes": feed.host_bytes,
                  "packMs": feed.pack_ms, "h2dMs": h2d_ms,
                  "foldMs": fold_ms}
