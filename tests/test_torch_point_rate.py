"""Kernel R (point_rate) against the JAX package's rate over raw rows
followed by compact_rows, as the union arm of its _pipeline runs them.

Every rate option set of chip_smoke.RATE_SETS, on float rows (NaN values,
holes, an empty row) and on all-integer rows (Java long differences, with
values above 2^53 and counters that wrap past counter_max).  The port
writes the surviving points first in each row and pads the rest with
PAD_TS, NaN and False; the reference's compacted rows hold the same
points first.  The same at the kernel's tile edges (torch_parity
R_EDGE_LENGTHS and r_edge_rows: rows no multiple of a tile long, resets at
tile edges, a previous valid point tiles back, rows with no valid point
and with one, values near 2^63).  Rates agree at rtol 1e-9
(torch_parity.RTOL); timestamps and masks are equal.  On the CPU the port
runs the plain version.
"""

import jax
import numpy as np
import pytest

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import rate as jrate
from opentsdb_tpu.ops import union_agg as jua
from opentsdb_tpu_torch.ops import rate as trate

from torch_parity import (R_EDGE_LENGTHS, assert_exact, assert_values,
                          r_edge_rows, sorted_batch, t)

RATE_SETS = {
    "rate": (),
    "counter": (True,),
    "counter_max": (True, 250_000),
    "counter_max_reset": (True, 250_000, 10),
    "drop_resets": (True, 2**63 - 1, 0, True),
    "counter_max_drop_resets": (True, 250_000, 0, True),
}

_rate = jax.jit(jrate.rate, static_argnums=(3, 4))
_compact = jax.jit(jua.compact_rows)


def _rows(int_values: bool):
    """Counters that climb and reset; int rows sit near 2^53 with one row
    beside int64 max, where the long difference wraps."""
    rng = np.random.default_rng(44 if int_values else 43)
    ts, _, mask = sorted_batch(rng, 10, 96, nan_frac=0.0)
    steps = rng.integers(-20_000, 60_000, ts.shape)
    val = np.cumsum(steps, axis=1)
    if int_values:
        val[::2] += 2**53
        val[3] = 2**63 - 1 - np.abs(val[3])
        return ts, val.astype(np.int64), mask
    val = val.astype(np.float64) * 0.37
    val[rng.random(val.shape) < 0.05] = np.nan
    return ts, val, mask


def _check(ts, val, mask, opts, int_values):
    _, rv, rm = _rate(ts, val, mask, jrate.RateOptions(*opts), int_values)
    rts, rv, rm = (np.asarray(x) for x in _compact(ts, rv, rm))
    pts, pv, pm = trate.point_rate(t(ts), t(val), t(mask),
                                   trate.RateOptions(*opts))
    assert_exact(pm.numpy(), rm)
    assert_exact(pts.numpy()[rm], rts[rm])
    assert (pts.numpy()[~rm] == trate.PAD_TS).all()
    assert np.isnan(pv.numpy()[~rm]).all()
    assert_values(pv.numpy()[rm], rv[rm])


@pytest.mark.parametrize("int_values", [False, True],
                         ids=["float", "int"])
@pytest.mark.parametrize("name", list(RATE_SETS))
def test_point_rate_matches_reference(name, int_values):
    _check(*_rows(int_values), RATE_SETS[name], int_values)


@pytest.mark.parametrize("name", list(RATE_SETS))
@pytest.mark.parametrize("int_values", [False, True],
                         ids=["float", "int"])
@pytest.mark.parametrize("n", R_EDGE_LENGTHS)
def test_point_rate_tile_edges_match_reference(n, int_values, name):
    _check(*r_edge_rows(n, int_values), RATE_SETS[name], int_values)


def test_point_rate_rows_without_a_rate():
    """An empty row, a single-point row and a row whose only later point
    is a dropped reset keep no point."""
    ts = np.full((3, 4), trate.PAD_TS, np.int64)
    val = np.zeros((3, 4), np.float64)
    mask = np.zeros((3, 4), bool)
    ts[1, 0], mask[1, 0] = 1000, True
    ts[2, :2], val[2, :2], mask[2, :2] = [1000, 2000], [5.0, 1.0], True
    out = trate.point_rate(t(ts), t(val), t(mask),
                           trate.RateOptions(True, drop_resets=True))
    assert not out[2].any()
    assert (out[0].numpy() == trate.PAD_TS).all()
