"""The driver entry of the port: the flagship step and the sharded dry run.

Port of __graft_entry__.py:

* ``entry(device)`` returns the flagship step and example tensors (the
  reference's :31-55): ``sum`` over an ``avg`` downsample of 8 series of
  128 points, through the port's grouped pipeline (K1, K2, K3 on a card;
  their plain versions on the CPU).
* ``dryrun_multichip(n, devices)`` runs the reference's ``_dryrun_body``
  program (:133-175, :247-317) over a mesh of ``n`` shards, in order:
  ``sharded_group_downsample`` for avg and max (P1) on an interleaved gid;
  ``sharded_rollup`` (L1); ``sharded_query_pipeline`` for sum with a rate
  and for p99, first and last; a streamed sketch p90 through
  ``ShardedStreamAccumulator``; and the window-sliced folds, whose slice
  contract is checked: every point folded (``oob_count() == 0``) and the
  answer bit for bit the full-grid fold's.

The devices are explicit: ``["cpu"] * 8`` (the tests' virtual mesh), four
shards of ``cuda:0``, or every card.  By default the shards go to the
visible cards, one a card when there are ``n`` of them, else all on
``cuda:0``; without a card that raises.  The reference's subprocess
re-exec and platform forcing (:58-130) deal with JAX's platform selection,
which torch does not have, and are not ported.  Its mode sweeps
(:199-245) race the TPU package's kernel strategies; the port has one
kernel a function ("port the answer, not the modes"), so they are not
ported either.  The pipelines of the port take groups as contiguous row
runs, as the planner lays them out: the dry run sorts the batch's rows by
group for them, and only the group downsample takes the interleaved gid.

Run it from the repository root::

    python -m opentsdb_tpu_torch.tools.dryrun [--shards 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opentsdb_tpu_torch.ops.downsample import FixedWindows
from opentsdb_tpu_torch.ops.pipeline import (DownsampleStep, PipelineSpec,
                                             build_batch, run_group_pipeline)
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.parallel import (
    ShardedStreamAccumulator, make_mesh, shard_rows, shard_series,
    sharded_group_downsample, sharded_query_pipeline, sharded_rollup)
from opentsdb_tpu_torch.parallel.distributed import host_major_devices

START = 1_356_998_400_000


def _require(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port's entry runs on a CUDA device, and "
                           "none is visible (pass device=\"cpu\" for the "
                           "plain versions)")
    return dev


# shape: -> (fn, ([8,128] i64, [8,128] f64, [8,128] bool))
def entry(device="cuda"):
    """(fn, (ts, val, mask)) for the single-device check: fn(ts, val,
    mask) -> (wts[W], out[1, W], out_mask[1, W]), ``sum:1m-avg`` over 8
    series of 128 points on `device`."""
    dev = _require(device)
    s, n = 8, 128
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(s):
        ts = START + np.cumsum(rng.integers(1_000, 30_000, n)).astype(
            np.int64)
        fv = rng.normal(100.0, 20.0, n)
        rows.append((ts, fv, np.zeros(n, np.int64), np.zeros(n, bool)))
    ts, val, mask, _ = build_batch(rows)
    edges = FixedWindows.for_range(START, int(ts[mask].max()),
                                   60_000).window_edges(dev)
    spec = PipelineSpec("sum", DownsampleStep("avg"))
    gid = np.zeros(s, np.int64)

    def step(ts, val, mask):
        return run_group_pipeline(spec, ts, val, mask, gid, 1, edges)

    return step, tuple(torch.from_numpy(x).to(dev) for x in (ts, val, mask))


def mesh_devices(n_devices: int, devices=None) -> list:
    """The shards' devices: `devices` as given (its first n), else one
    card a shard when n are visible, else n shards of cuda:0."""
    if devices is not None:
        devices = list(devices)[:n_devices]
        if len(devices) < n_devices:
            raise ValueError("%d shards need %d devices, got %d"
                             % (n_devices, n_devices, len(devices)))
        for d in devices:
            _require(d)
        return devices
    cards = host_major_devices()
    if not cards:
        _require("cuda")
    if len(cards) >= n_devices:
        return cards[:n_devices]
    return [cards[0]] * n_devices


def _assert_live(out, out_mask, groups: int, w: int, what: str) -> None:
    if tuple(out.shape) != (groups, w) or tuple(out_mask.shape) != (groups,
                                                                    w):
        raise AssertionError("%s answered %s, not [%d, %d]"
                             % (what, tuple(out.shape), groups, w))
    if not bool(out_mask.any()):
        raise AssertionError("%s produced no live cells" % what)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The sharded serving, rollup and streaming program over a mesh of
    `n_devices` shards (see the module docstring); raises on a failed
    check."""
    mesh = make_mesh(devices=mesh_devices(n_devices, devices))
    owner = mesh.owner
    s, n, groups = 2 * n_devices, 64, 2
    rng = np.random.default_rng(1)
    ts = START + np.cumsum(rng.integers(1_000, 30_000, (s, n)),
                           axis=1).astype(np.int64)
    val = rng.normal(50.0, 10.0, (s, n))
    mask = rng.random((s, n)) < 0.95
    gid = (np.arange(s) % groups).astype(np.int64)
    windows = FixedWindows.for_range(START, int(ts.max()), 300_000)
    w = windows.count
    edges = windows.window_edges(owner)

    # the group downsample on the interleaved gid (P1), and the rollup
    # pass (L1), over (series, time) blocks
    blocks = shard_series(mesh, ts, val, mask)
    for agg in ("avg", "max"):
        _, out, out_mask = sharded_group_downsample(mesh, agg, blocks, gid,
                                                    groups, edges)
        _assert_live(out, out_mask, groups, w, "group downsample " + agg)
    parts = sharded_rollup(mesh, blocks, edges)
    if sum(p[0].shape[0] for p in parts) != s \
            or any(p[0].shape[1] != w for p in parts):
        raise AssertionError("the sharded rollup answered other shapes")

    # the serving pipeline over row shards: the moment tail (a rate
    # included) and the gather-to-owner tail; groups as row runs
    order = np.argsort(gid, kind="stable")
    ts, val, mask, gid = ts[order], val[order], mask[order], gid[order]
    rows = shard_rows(mesh, ts, val, mask, gid)
    for agg, rate in (("sum", RateOptions()), ("p99", None),
                      ("first", None), ("last", None)):
        spec = PipelineSpec(agg, DownsampleStep("avg"), rate)
        _, out, out_mask = sharded_query_pipeline(mesh, spec, groups, rows,
                                                  edges)
        _assert_live(out, out_mask, groups, w, "%s pipeline" % agg)

    # the streamed sketch: two time chunks, p90 through the tail
    chunks = [tuple(torch.from_numpy(np.ascontiguousarray(x[:, c])).to(owner)
                    for x in (ts, val, mask))
              for c in (slice(0, n // 2), slice(n // 2, n))]
    acc = ShardedStreamAccumulator(mesh, s, windows, sketch=True)
    for chunk in chunks:
        acc.update(*chunk)
    _, out, out_mask = acc.finish_tail(
        PipelineSpec("sum", DownsampleStep("p90")), gid, groups)
    _assert_live(out, out_mask, groups, w, "streamed sketch")

    # the window-sliced folds: each chunk's first window and a slice of
    # its span; the reference's 5m grid is too small to slice, so the
    # contract is held on 1 s windows
    fine = FixedWindows.for_range(START, int(ts.max()), 1_000)
    w0s, spans = [], []
    for c_ts, _, c_mask in chunks:
        live = c_ts[c_mask]
        lo, hi = int(live.min()), int(live.max())
        w0s.append((lo - fine.first_window_ms) // fine.interval_ms)
        spans.append((hi - lo) // fine.interval_ms + 2)
    spec = PipelineSpec("sum", DownsampleStep("avg"))
    sliced = ShardedStreamAccumulator(mesh, s, fine,
                                      window_slice=max(spans))
    if sliced.window_slice is None:
        raise AssertionError("the sliced fold declined its slice")
    full = ShardedStreamAccumulator(mesh, s, fine)
    for chunk, w0 in zip(chunks, w0s):
        sliced.update(*chunk, w0=w0)
        full.update(*chunk)
    if sliced.oob_count() != 0:
        raise AssertionError("the sliced mesh fold dropped %d points"
                             % sliced.oob_count())
    _, out, out_mask = sliced.finish_tail(spec, gid, groups)
    _, want, want_mask = full.finish_tail(spec, gid, groups)
    _assert_live(out, out_mask, groups, fine.count, "sliced fold")
    if not (torch.equal(out_mask, want_mask)
            and torch.equal(out[out_mask], want[want_mask])):
        raise AssertionError("the sliced mesh fold differs from the "
                             "full-grid fold")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="every shard on this device (default: the "
                        "visible cards)")
    args = parser.parse_args(argv)
    device = args.device or "cuda"
    fn, tensors = entry(device)
    wts, out, out_mask = fn(*tensors)
    print("entry ok on %s: out %s, %d live cells"
          % (device, tuple(out.shape), int(out_mask.sum())))
    devices = None if args.device is None else [args.device] * args.shards
    dryrun_multichip(args.shards, devices)
    print("dryrun_multichip ok on %d shards (%s)"
          % (args.shards, ", ".join(str(d) for d in mesh_devices(
              args.shards, devices))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
