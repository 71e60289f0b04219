"""Kernels U1 (union_merge) and U2 (union_reduce) against the JAX package's
union_timestamps and union_aggregate.

Every moment aggregator under every interpolation policy on float rows
(NaN values, holes, an empty row, equal timestamps across rows, a
single-point row), int mode with values above 2^53 and a truncating LERP,
and the golden cases of test_union_agg.py.  The JAX side runs each group
of the batch through union_aggregate (vmapped over equal-sized groups, as
its _union_batch_pipeline does); the port takes all groups in one batch.
The reference's union has masked duplicate slots, the port's only the
union's slots: the comparison takes the reference's masked-in entries.
Values agree at rtol 1e-9 (torch_parity.RTOL), exactly in int mode;
timestamps and group offsets are equal.  On the CPU the port runs the
plain PyTorch versions.
"""

import jax
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import union_agg as jua
from opentsdb_tpu.ops.aggregators import Aggregator, get_agg as jget_agg
from opentsdb_tpu_torch.ops import union_agg as tua
from opentsdb_tpu_torch.ops.group_agg import group_offsets

from kernel_utils import batch
from torch_parity import PAD_TS, assert_exact, assert_values, sorted_batch, t

AGGS = ["sum", "zimsum", "pfsum", "count", "avg", "min", "mimmin", "max",
        "mimmax", "dev", "squareSum"]
POLICIES = ["lerp", "zim", "max", "min", "prev"]
GROUPS, ROWS, N = 3, 4, 48

# one compile per (aggregator, int mode): the eager reference would compile
# its pieces on every call
_reference = jax.jit(jax.vmap(jua.union_aggregate, in_axes=(0, 0, 0, None,
                                                            None)),
                     static_argnums=(3, 4))


def compact(ts, val, mask):
    """Valid points to the front of each row, as the reference's
    compact_rows orders them; the rest PAD_TS, 0 and False."""
    order = np.argsort(np.where(mask, ts, PAD_TS), axis=1, kind="stable")
    m = np.take_along_axis(mask, order, 1)
    return (np.where(m, np.take_along_axis(ts, order, 1), PAD_TS),
            np.where(m, np.take_along_axis(val, order, 1), 0).astype(
                val.dtype), m)


def _share(ts, mask, dst, src, k):
    """Row dst starts with row src's first k timestamps."""
    head = ts[src][mask[src]][:k]
    tail = ts[dst][mask[dst]]
    row = np.concatenate([head, tail[tail > head[-1]]])[:N]
    ts[dst] = PAD_TS
    ts[dst, :len(row)] = row
    mask[dst] = np.arange(N) < len(row)


def _batch(seed: int, int_values: bool = False):
    """GROUPS x ROWS compacted rows: NaN values from sorted_batch, row 1
    empty, row 5 a single point, rows 6 and 7 sharing timestamps with row
    4, and in int mode values near and above 2^53."""
    rng = np.random.default_rng(seed)
    ts, val, mask = compact(*sorted_batch(
        rng, GROUPS * ROWS, N, span_ms=200_000, int_values=int_values))
    mask[5, 1:] = False
    ts[5, 1:] = PAD_TS
    _share(ts, mask, 6, 4, 10)
    _share(ts, mask, 7, 4, N)
    if int_values:
        val[::2] += 2**53 - 500
        val[3] += 2**60
    return ts, val, mask


def _run_both(ts, val, mask, agg_name, policy, int_mode):
    """(reference, port) lists of per-group (u, out) pairs."""
    agg = Aggregator(agg_name, policy, jget_agg(agg_name).reduce)
    shape = (GROUPS, ROWS, N)
    ru, rout, rmask = (np.asarray(x) for x in _reference(
        ts.reshape(shape), val.reshape(shape), mask.reshape(shape), agg,
        int_mode))
    gid = np.repeat(np.arange(GROUPS, dtype=np.int64), ROWS)
    pu, pout, puoff = tua.union_aggregate(
        t(ts), t(val), t(mask), group_offsets(gid, GROUPS), agg_name, policy)
    ref = [(ru[g][rmask[g]], rout[g][rmask[g]]) for g in range(GROUPS)]
    port = [(pu[puoff[g]:puoff[g + 1]].numpy(),
             pout[puoff[g]:puoff[g + 1]].numpy()) for g in range(GROUPS)]
    return ref, port


def _assert_same(ref, port, int_mode, agg_name):
    for (ru, rout), (pu, pout) in zip(ref, port):
        assert_exact(pu, ru)
        if int_mode:
            assert pout.dtype == np.int64
        if int_mode and agg_name != "dev":
            assert_exact(pout, rout)
        else:
            # dev in int mode is a float64 stddev truncated to a long
            # (Aggregators.java:522): the reference's own sum order moves
            # with its batch shape (vmapped or not), so near 2^60 it can
            # land one float64 ulp apart, and it is held to RTOL as floats
            assert_values(pout, rout)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("agg_name", AGGS)
def test_union_aggregate_matches_reference(agg_name, policy):
    ts, val, mask = _batch(31)
    _assert_same(*_run_both(ts, val, mask, agg_name, policy, False), False,
                 agg_name)


@pytest.mark.parametrize("agg_name", AGGS)
def test_union_aggregate_int_mode_matches_reference(agg_name):
    ts, val, mask = _batch(32, int_values=True)
    _assert_same(*_run_both(ts, val, mask, agg_name,
                            jget_agg(agg_name).interpolation, True), True,
                 agg_name)


@pytest.mark.parametrize("policy", POLICIES)
def test_union_aggregate_int_mode_policies(policy):
    ts, val, mask = _batch(33, int_values=True)
    _assert_same(*_run_both(ts, val, mask, "sum", policy, True), True, "sum")


def test_union_merge_matches_reference_timestamps():
    ts, val, mask = _batch(34)
    gid = np.repeat(np.arange(GROUPS, dtype=np.int64), ROWS)
    u, uoff = tua.union_merge(t(ts), t(mask), group_offsets(gid, GROUPS))
    for g in range(GROUPS):
        rows = slice(g * ROWS, (g + 1) * ROWS)
        ru, rmask = (np.asarray(x) for x in jua.union_timestamps(
            ts[rows], mask[rows]))
        assert_exact(u[uoff[g]:uoff[g + 1]].numpy(), ru[rmask])
    assert int(uoff[-1]) == u.numel()


def test_union_groups_of_different_sizes():
    """Groups as uneven row runs, an empty group and rows outside every
    group, against the reference group by group; moments (U2), order and
    rank functions (U3) and movingAverage<N> (U2 and MA)."""
    ts, val, mask = _batch(35)
    gid = np.array([0, 0, 0, 0, 0, 2, 3, 3, 3, 3, 3, 3], np.int64)
    offsets = group_offsets(gid, 4)
    for agg_name in ("sum", "dev", "mimmax", "median", "ep99r7", "last",
                     "movingAverage2"):
        pu, pout, puoff = tua.union_aggregate(
            t(ts), t(val), t(mask), offsets, agg_name,
            jget_agg(agg_name).interpolation)
        assert int(puoff[1]) == int(puoff[2])          # group 1 is empty
        for g in (0, 2, 3):
            rows = gid == g
            ru, rout, rmask = (np.asarray(x) for x in jua.union_aggregate(
                ts[rows], val[rows], mask[rows], jget_agg(agg_name)))
            assert_exact(pu[puoff[g]:puoff[g + 1]].numpy(), ru[rmask])
            assert_values(pout[puoff[g]:puoff[g + 1]].numpy(), rout[rmask])


# The cases of test_union_agg.py: series, aggregator, int mode, expected
# (timestamp, value) pairs.
GOLDEN = {
    "sum_two_aligned": ([([1000, 2000, 3000], [1, 2, 3]),
                         ([1000, 2000, 3000], [10, 20, 30])], "sum", False,
                        [(1000, 11.0), (2000, 22.0), (3000, 33.0)]),
    "min": ([([1000, 2000], [1, 4]), ([1000, 2000], [3, 2])], "min", False,
            [(1000, 1.0), (2000, 2.0)]),
    "max": ([([1000, 2000], [1, 4]), ([1000, 2000], [3, 2])], "max", False,
            [(1000, 3.0), (2000, 4.0)]),
    "avg": ([([1000, 2000], [1, 4]), ([1000, 2000], [3, 2])], "avg", False,
            [(1000, 2.0), (2000, 3.0)]),
    "single_series_passthrough": ([([1000, 2000, 3000], [5, 6, 7])], "sum",
                                  False,
                                  [(1000, 5.0), (2000, 6.0), (3000, 7.0)]),
    "lerp_float": ([([2000], [100.0]), ([1000, 3000], [10.0, 30.0])], "sum",
                   False, [(1000, 10.0), (2000, 120.0), (3000, 30.0)]),
    "lerp_int_truncating_division": ([([2000], [10]), ([1000, 4000], [1, 2])],
                                     "sum", True,
                                     [(1000, 1), (2000, 11), (4000, 2)]),
    "out_of_range_excluded": ([([1000, 2000], [1, 2]),
                               ([3000, 4000], [10, 20])], "sum", False,
                              [(1000, 1.0), (2000, 2.0), (3000, 10.0),
                               (4000, 20.0)]),
    "empty_series_ignored": ([([1000], [5.0]), ([], [])], "sum", False,
                             [(1000, 5.0)]),
    "zimsum_fills_zero": ([([1000, 3000], [1, 3]), ([2000], [10])], "zimsum",
                          False, [(1000, 1.0), (2000, 10.0), (3000, 3.0)]),
    "mimmin_ignores_missing": ([([1000, 3000], [5, 7]), ([2000], [10])],
                               "mimmin", False,
                               [(1000, 5.0), (2000, 10.0), (3000, 7.0)]),
    "mimmax_ignores_missing": ([([1000, 3000], [5, 7]), ([2000], [1])],
                               "mimmax", False,
                               [(1000, 5.0), (2000, 1.0), (3000, 7.0)]),
    "count_zim_quirk": ([([1000, 3000], [1, 3]), ([2000], [10])], "count",
                        False, [(1000, 1.0), (2000, 2.0), (3000, 1.0)]),
    "dev_across_series": ([([1000], [2.0]), ([1000], [4.0]),
                           ([1000], [6.0])], "dev", False, [(1000, 2.0)]),
    "squaresum": ([([1000], [3.0]), ([1000], [4.0])], "squareSum", False,
                  [(1000, 25.0)]),
}


@pytest.mark.parametrize("case", list(GOLDEN))
def test_union_golden_cases(case):
    series, agg_name, int_mode, expected = GOLDEN[case]
    ts, val, mask = batch(series)
    if int_mode:
        val = val.astype(np.int64)
    ru, rout, rmask = (np.asarray(x) for x in jua.union_aggregate(
        ts, val, mask, jget_agg(agg_name), int_mode=int_mode))
    offsets = torch.tensor([0, len(series)], dtype=torch.int64)
    pu, pout, _ = tua.union_aggregate(t(ts), t(val), t(mask), offsets,
                                      agg_name,
                                      jget_agg(agg_name).interpolation)
    got = list(zip(pu.tolist(), pout.tolist()))
    assert got == list(zip(ru[rmask].tolist(), rout[rmask].tolist()))
    assert [x for x, _ in got] == [x for x, _ in expected]
    np.testing.assert_allclose([v for _, v in got],
                               [v for _, v in expected], rtol=1e-12)


def test_union_reduce_refuses_unported_aggregators():
    """U2 computes the moments only and refuses the median; U3
    (union_order) answers it, as the reference's union_aggregate does."""
    ts, val, mask = _batch(36)
    offsets = torch.tensor([0, GROUPS * ROWS], dtype=torch.int64)
    u, uoff = tua.union_merge(t(ts), t(mask), offsets)
    with pytest.raises(KeyError):
        tua.union_reduce(t(ts), t(val), t(mask), offsets, u, uoff, "median",
                         "lerp")
    got = tua.union_order(t(ts), t(val), t(mask), offsets, u, uoff, "median",
                          "lerp")
    ru, rout, rmask = (np.asarray(x) for x in jua.union_aggregate(
        ts, val, mask, jget_agg("median")))
    assert_exact(u.numpy(), ru[rmask])
    assert_values(got.numpy(), rout[rmask])
