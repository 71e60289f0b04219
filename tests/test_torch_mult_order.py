"""The ordered product (mult) of K4, K5 and U3, and U1's awkward shapes,
against the JAX package on the CPU, where the port runs the plain PyTorch
versions.

mult multiplies a run's values in the run's order (time order in a
window, row order in a group), as the reference's segment_prod and prod
do at these shapes, and with an overflow to inf and a zero in one run the
order decides between NaN and 0.  Each class of the ordered product is
held here: overflow then a zero (NaN), a zero then an overflow (0), a
zero then an inf value (NaN), an inf value then a zero (NaN), negative
values (the sign of +-inf and +-0), underflow to 0 directly and through
the subnormals, a prefix that passes through the subnormals and recovers,
the edges of the finite range, runs whose product overflows the way the
headline batch's do, long finite near-1 runs (5,000 and 65,536 values)
and int64 wrap (U3 in int mode).  Masked slots holding 0 or inf and NaN
values sit between the values of every run and must take no part.

Classes are exact: NaN, +inf, -inf, +0, -0 and finite agree cell for
cell; finite values agree at rtol 1e-9 (torch_parity.RTOL, no atol: a
product's scale is its own); int64 values are exact.  The reference is
also held to the ordered product computed by a plain Python loop, which
is what the port's kernels promise.

U1: union_merge against union_timestamps group by group, exactly, on
groups of 1, 2, 3, 5 and 1024 rows, empty and all-masked rows,
duplicates within and across rows, every row equal, and rows outside
every group.
"""

import jax
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import group_agg as jga
from opentsdb_tpu.ops import union_agg as jua
from opentsdb_tpu.ops.aggregators import Aggregator, get_agg as jget_agg
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops import union_agg as tua

from mult_runs import (NAMES, RUNS, STEP_MS, T0, WINDOW_MS,
                       assert_same_product, classify, k4_batch, k5_columns,
                       near_one, ordered_product, u1_batch, u3_groups)
from torch_parity import PAD_TS, assert_exact, t

def check_runs(port, ref, runs):
    """The port is the ordered IEEE product of each run; the reference is
    the ordered product with subnormals flushed; the two agree on every
    run where flushing changes nothing (runs in the rows of the last
    axis, one a cell)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    ieee = np.broadcast_to([ordered_product(r) for r in runs], port.shape)
    flushed = np.broadcast_to([ordered_product(r, True) for r in runs],
                              port.shape)
    assert_same_product(port, ieee)
    assert_same_product(ref, flushed)
    same = (classify(ieee) == classify(flushed)) & (
        (ieee == flushed) | np.isnan(ieee))
    assert_same_product(port[same], ref[same])


def _k4_both(ts, val, mask, nwin):
    """(port, reference) mult over `nwin` windows of WINDOW_MS."""
    args = (T0, T0 + nwin * WINDOW_MS - 1, WINDOW_MS)
    plan = jds.FixedWindows.for_range(*args)
    assert plan.count == nwin
    spec, wargs = plan.split()
    _, ref, ref_mask = jds.downsample(ts, val, mask, "mult", spec, wargs)
    edges = tds.FixedWindows.for_range(*args).window_edges("cpu")
    port, port_mask = tds.window_order(t(ts), t(val), t(mask), edges, "mult")
    assert_exact(port_mask.numpy(), np.asarray(ref_mask)[:, :nwin])
    return port.numpy(), np.asarray(ref)[:, :nwin]


@pytest.mark.parametrize("interleaved", [False, True])
def test_k4_mult_classes_match_reference(interleaved):
    ts, val, mask = k4_batch(NAMES, interleaved)
    port, ref = _k4_both(ts, val, mask, len(NAMES))
    check_runs(port, ref, [RUNS[n] for n in NAMES])


def test_k4_mult_int64_rows_as_float64():
    """An int64 row is taken as float64: 2^62 seventeen times overflows;
    wrap-around is the int mode of U3, not K4's."""
    runs = [[2**62] * 17, [2**40 + 1, 2**30 + 3, -7], [0, 2**62] + [2**62] * 16]
    ts = np.full((1, 64), PAD_TS, np.int64)
    val = np.zeros((1, 64), np.int64)
    mask = np.zeros((1, 64), bool)
    j = 0
    for k, run in enumerate(runs):
        for i, v in enumerate(run):
            ts[0, j], val[0, j], mask[0, j] = T0 + k * WINDOW_MS + i * STEP_MS, v, True
            j += 1
    port, ref = _k4_both(ts, val, mask, len(runs))
    check_runs(port, ref, [[float(v) for v in r] for r in runs])
    assert classify(port).tolist() == [[2, 0, 4]]


@pytest.mark.parametrize("signs", [False, True])
@pytest.mark.parametrize("n", [5_000, 65_536])
def test_k4_mult_long_near_one_runs(n, signs):
    """One window over a long finite run (the "0all" length at 65,536)."""
    vals = near_one(10 + n, n, signs)
    ts = (T0 + np.arange(n, dtype=np.int64) * 10)[None, :]
    val = np.array([vals])
    mask = np.ones_like(ts, bool)
    spec, wargs = jds.AllWindow(T0, T0 + n * 10).split()
    _, ref, _ = jds.downsample(ts, val, mask, "mult", spec, wargs)
    edges = tds.AllWindow(T0, T0 + n * 10).window_edges("cpu")
    port, _ = tds.window_order(t(ts), t(val), t(mask), edges, "mult")
    ref = np.asarray(ref)[:, :1]
    assert classify(ref).tolist() == [[0]]
    check_runs(port.numpy(), ref, [vals])


# -- K5: row order within a (group, window) cell ----------------------------

_ordered = jax.jit(jga.ordered_group_reduce,
                   static_argnames=("agg_name", "num_groups"))


def test_k5_mult_classes_match_reference():
    """Two groups: the runs as they are, then with skipped cells between
    their values (not participating, holding 0 or inf, and NaN)."""
    a = k5_columns(NAMES, False)
    b = k5_columns(NAMES, True)
    contrib = np.concatenate([a[0], b[0]])
    part = np.concatenate([a[1], b[1]])
    gid = np.repeat(np.arange(2, dtype=np.int64), [len(a[0]), len(b[0])])
    ref, _ = _ordered(agg_name="mult", contrib=contrib, participate=part,
                      gid=gid, num_groups=2)
    out, _ = tga.group_order("mult", t(contrib), t(part),
                             t(np.ones_like(part)), tga.group_offsets(gid, 2))
    check_runs(out.numpy(), ref, [RUNS[n] for n in NAMES])


@pytest.mark.parametrize("n", [5_000, 65_536])
def test_k5_mult_long_near_one_column(n):
    vals = np.array([near_one(20 + n, n, False), near_one(30 + n, n, True)]).T
    part = np.ones_like(vals, bool)
    gid = np.zeros(n, np.int64)
    ref, _ = _ordered(agg_name="mult", contrib=vals, participate=part,
                      gid=gid, num_groups=1)
    out, _ = tga.group_order("mult", t(vals), t(part), t(part),
                             tga.group_offsets(gid, 1))
    check_runs(out.numpy(), ref, [vals[:, 0], vals[:, 1]])


# -- U3: row order at a union slot ------------------------------------------

_union_ref = jax.jit(jax.vmap(jua.union_aggregate,
                              in_axes=(0, 0, 0, None, None)),
                     static_argnums=(3, 4))


def _u3_both(ts, val, mask, int_mode: bool):
    g, m, _ = ts.shape
    agg = Aggregator("mult", jget_agg("mult").interpolation,
                     jget_agg("mult").reduce)
    ru, rout, rmask = (np.asarray(x) for x in _union_ref(ts, val, mask, agg,
                                                         int_mode))
    offsets = torch.arange(g + 1, dtype=torch.int64) * m
    flat = [t(x.reshape(g * m, 1)) for x in (ts, val, mask)]
    pu, pout, puoff = tua.union_aggregate(*flat, offsets, "mult",
                                          jget_agg("mult").interpolation)
    ref = np.array([rout[k][rmask[k]][0] for k in range(g)])
    assert_exact(pu.numpy(), np.array([ru[k][rmask[k]][0] for k in range(g)]))
    assert_exact(puoff.numpy(), np.arange(g + 1))
    return pout.numpy(), ref


@pytest.mark.parametrize("interleaved", [False, True])
def test_u3_mult_classes_match_reference(interleaved):
    ts, val, mask = u3_groups([RUNS[n] for n in NAMES], interleaved)
    port, ref = _u3_both(ts, val, mask, False)
    check_runs(port, ref, [RUNS[n] for n in NAMES])


@pytest.mark.parametrize("n", [5_000, 65_536])
def test_u3_mult_long_near_one_members(n):
    """At 65,536 members the reference's union keeps every member's copy
    of the slot ([S, S*N] contributions, 4.3e9 cells), so there the
    reference is the reduce that its union_aggregate applies, over the
    members' values (each member's contribution at its own point)."""
    runs = [near_one(40 + n, n, False), near_one(50 + n, n, True)]
    ts, val, mask = u3_groups(runs, False)
    if n <= 5_000:
        port, ref = _u3_both(ts, val, mask, False)
    else:
        g, m, _ = ts.shape
        _, pout, _ = tua.union_aggregate(
            *(t(x.reshape(g * m, 1)) for x in (ts, val, mask)),
            torch.arange(g + 1, dtype=torch.int64) * m, "mult",
            jget_agg("mult").interpolation)
        port = pout.numpy()
        ref = np.array([np.asarray(jget_agg("mult").reduce(val[k], mask[k]))[0]
                        for k in range(g)])
    check_runs(port, ref, runs)


def test_u3_mult_int64_wraps():
    """Int mode: Java long products wrap mod 2^64, in any order alike."""
    runs = [[2**40 + 1, 2**30 + 3, 123_457, -7, 2**62 - 1],
            [-(2**63), 3], [2**32, 2**32], [0, 2**62, 5], [-1, -1, -1],
            [9] * 40]
    ts, val, mask = u3_groups(runs, False, np.int64)
    port, ref = _u3_both(ts, val, mask, True)
    want = []
    for r in runs:
        p = 1
        for v in r:
            p = (p * v) & (2**64 - 1)
        want.append(p - 2**64 if p >= 2**63 else p)
    assert port.dtype == np.int64
    assert_exact(ref, np.array(want, np.int64))
    assert_exact(port, ref)


# -- U1: the merge's awkward shapes -------------------------------------------

_union_timestamps = jax.jit(jua.union_timestamps)


def test_u1_awkward_shapes_match_reference():
    ts, mask, gid, ng = u1_batch()
    offsets = tga.group_offsets(gid, ng)
    u, uoff = tua.union_merge(t(ts), t(mask), offsets)
    assert int(uoff[-1]) == u.numel()
    assert int(offsets[0]) == 1 and int(offsets[-1]) == len(gid) - 1
    for g in range(ng):
        rows = gid == g
        got = u[uoff[g]:uoff[g + 1]].numpy()
        if not rows.any():
            assert got.size == 0
            continue
        ru, rmask = (np.asarray(x) for x in _union_timestamps(ts[rows],
                                                              mask[rows]))
        assert_exact(got, ru[rmask])
    # the group of equal rows is one row's timestamps
    eq = np.flatnonzero(gid == 6)[0]
    assert_exact(u[uoff[6]:uoff[7]].numpy(), ts[eq][mask[eq]])
