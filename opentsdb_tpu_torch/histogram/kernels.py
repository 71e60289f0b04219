"""The histogram query's device work: H1 and H2.

Port of opentsdb_tpu/histogram/kernels.py.  All groups of a query share
one [rows, B] bucket grid whose rows are every group's data-bearing
windows stacked (histogram/store.assemble_columnar), so one call of each
kernel serves the whole query:

* ``accumulate_rows_deferred`` (H1, csrc/histogram_accumulate.cu): the
  int64 scatter of nnz bucket entries onto the grid, its stray-entry flag
  left for the caller to read with its own copy (the query path);
  ``accumulate_rows`` reads it at the call.
* ``percentile_rows`` (H2, csrc/histogram_percentile.cu): the
  SimpleHistogram.percentile rule on every row: cumulative share along
  the bound-sorted buckets, the first bucket reaching p, its midpoint.

Each has its plain PyTorch version beside it
(``accumulate_rows_deferred_plain`` and ``accumulate_rows_plain``,
``percentile_rows_plain``), which CPU tensors run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opentsdb_tpu_torch.ops import kernels

def _entry_error(cells: int) -> ValueError:
    return ValueError("histogram scatter entry outside the grid of %d cells"
                      % cells)


def _check_accumulate(seg, cnt, num_rows: int, num_buckets: int) -> int:
    if seg.dim() != 1 or cnt.shape != seg.shape:
        raise ValueError("accumulate_rows takes seg[nnz] and cnt[nnz]")
    if seg.dtype != torch.int64 or cnt.dtype != torch.int64:
        raise TypeError("accumulate_rows takes int64 seg and cnt, got %s "
                        "and %s" % (seg.dtype, cnt.dtype))
    if num_rows < 0 or num_buckets < 0:
        raise ValueError("accumulate_rows takes a non-negative grid shape")
    return num_rows * num_buckets


class PendingGrid(NamedTuple):
    """H1's answer before its stray-entry flag has been read: `buffer`
    holds the grid's num_rows * num_buckets cells and then the flag,
    nonzero where an entry fell outside the grid.  One copy of `buffer`
    brings both to the host; `check` raises on the flag's value."""
    buffer: torch.Tensor
    num_rows: int
    num_buckets: int

    @property
    def grid(self) -> torch.Tensor:
        return self.buffer[:-1].view(self.num_rows, self.num_buckets)

    @property
    def flag(self) -> torch.Tensor:
        return self.buffer[-1:]

    def check(self, flag) -> None:
        """Raise ValueError where `flag` (the flag's value, read back by
        the caller) is nonzero."""
        if int(flag):
            raise _entry_error(self.num_rows * self.num_buckets)


# shape: seg[nnz] i64, cnt[nnz] i64 -> buffer[R*B+1] i64
def accumulate_rows_deferred(seg: torch.Tensor, cnt: torch.Tensor,
                             num_rows: int, num_buckets: int) -> PendingGrid:
    """H1 without a read of its flag: every entry's count added at cell
    seg[i] = row * num_buckets + bucket of the grid, a negative count
    too, as the reference's segment sum adds it (a JSON bucket map may
    carry one); an entry outside the grid is left out and sets the flag.
    On the card nothing waits for the kernel: the caller reads the flag
    with the copy it makes of its answer and calls `check` before it
    answers."""
    cells = _check_accumulate(seg, cnt, num_rows, num_buckets)
    if seg.device.type == "cpu":
        return accumulate_rows_deferred_plain(seg, cnt, num_rows,
                                              num_buckets)
    dev = kernels.require_cuda(seg, cnt)
    if cells == 0:
        if seg.numel():
            raise _entry_error(cells)
        return PendingGrid(torch.zeros(1, dtype=torch.int64, device=dev),
                           num_rows, num_buckets)
    buf = torch.empty(cells + 1, dtype=torch.int64, device=dev)
    kernels.launch("histogram_accumulate", dev, kernels.ptr(seg),
                   kernels.ptr(cnt), seg.numel(), cells, kernels.ptr(buf))
    return PendingGrid(buf, num_rows, num_buckets)


# shape: seg[nnz] i64, cnt[nnz] i64 -> [R,B] i64
def accumulate_rows(seg: torch.Tensor, cnt: torch.Tensor, num_rows: int,
                    num_buckets: int) -> torch.Tensor:
    """H1 -> grid[num_rows, num_buckets] int64 (accumulate_rows_deferred),
    raising ValueError at the call on an entry outside the grid: on the
    card it waits for the kernel to read the flag."""
    acc = accumulate_rows_deferred(seg, cnt, num_rows, num_buckets)
    acc.check(acc.flag.item())
    return acc.grid


def accumulate_rows_deferred_plain(seg: torch.Tensor, cnt: torch.Tensor,
                                   num_rows: int,
                                   num_buckets: int) -> PendingGrid:
    """Plain PyTorch version of H1's deferred form: index_add_ of the
    entries inside the grid into a zeroed buffer, the flag set where
    some entry lies outside."""
    cells = _check_accumulate(seg, cnt, num_rows, num_buckets)
    inside = (seg >= 0) & (seg < cells)
    buf = torch.zeros(cells + 1, dtype=torch.int64, device=seg.device)
    buf[:cells].index_add_(0, seg[inside], cnt[inside])
    buf[cells] = int(not bool(inside.all()))
    return PendingGrid(buf, num_rows, num_buckets)


def accumulate_rows_plain(seg: torch.Tensor, cnt: torch.Tensor,
                          num_rows: int, num_buckets: int) -> torch.Tensor:
    """Plain PyTorch version of H1's form that raises at the call."""
    acc = accumulate_rows_deferred_plain(seg, cnt, num_rows, num_buckets)
    acc.check(acc.flag[0])
    return acc.grid


def _check_percentile(counts, mid, percs) -> None:
    if counts.dim() != 2 or mid.shape != (counts.shape[1],) \
            or percs.dim() != 1:
        raise ValueError("percentile_rows takes counts[R, B], mid[B] and "
                         "percs[P]")
    for tns, dtype in ((counts, torch.int64), (mid, torch.float64),
                       (percs, torch.float64)):
        if tns.dtype != dtype:
            raise TypeError("expected %s, got %s" % (dtype, tns.dtype))


# shape: counts[R,B] i64, mid[B] f64, percs[P] f64 -> [P,R] f64
def percentile_rows(counts: torch.Tensor, mid: torch.Tensor,
                    percs: torch.Tensor) -> torch.Tensor:
    """H2 -> [P, R] float64: for each percentile p and row, the midpoint
    of the first bucket whose cumulative share reaches p (bucket 0's when
    none does); 0.0 on a row with no mass; -1.0 for p outside [1, 100]."""
    _check_percentile(counts, mid, percs)
    if counts.device.type == "cpu":
        return percentile_rows_plain(counts, mid, percs)
    dev = kernels.require_cuda(counts, mid, percs)
    r, b = counts.shape
    out = torch.empty((percs.numel(), r), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out
    kernels.launch("histogram_percentile", dev, kernels.ptr(counts),
                   kernels.ptr(mid), kernels.ptr(percs), r, b, percs.numel(),
                   kernels.ptr(out))
    return out


def percentile_rows_plain(counts: torch.Tensor, mid: torch.Tensor,
                          percs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of H2: cumsum, the share, a compare and the
    first true index by argmax."""
    _check_percentile(counts, mid, percs)
    r, b = counts.shape
    valid = (percs >= 1.0) & (percs <= 100.0)
    if b == 0:
        return torch.where(valid[:, None], torch.zeros(
            (1, r), dtype=torch.float64, device=counts.device), -1.0)
    cum = torch.cumsum(counts, dim=1)
    total = cum[:, -1]
    has = total > 0
    share = torch.where(
        has[:, None],
        cum.double() * 100.0 / total.clamp(min=1).double()[:, None], 0.0)
    idx = (share[None, :, :] >= percs[:, None, None]).to(
        torch.uint8).argmax(dim=2)
    vals = torch.where(has[None, :], mid[idx], 0.0)
    return torch.where(valid[:, None], vals, -1.0)
