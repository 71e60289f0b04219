"""The port's percentile estimators (ops/percentile.py) against the JAX
package's: row_run_percentile, column_run_percentile and masked_percentile
under LEGACY, R-3 and R-7, on runs of 0, 1, 2 and many values, with ties
and +inf values; and parse_percentile_name over every percentile of the
registry.  These plain forms are what the kernels K4, K5 and U3 are held
to.  Values agree at rtol 1e-9 (torch_parity.RTOL) with NaN positions
equal.
"""

import jax
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import percentile as jp
from opentsdb_tpu.ops.downsample import parse_percentile_name as j_parse
from opentsdb_tpu_torch.ops import percentile as tp
from opentsdb_tpu_torch.ops.aggregators import PERCENTILE_AGGS

from torch_parity import assert_values, t

ESTIMATORS = [tp.EST_LEGACY, tp.EST_R3, tp.EST_R7]
QS = [99.9, 99.0, 50.0, 12.5, 100.0]
S, W = 9, 12

# one compile per (q, estimator)
_masked = jax.jit(jp.masked_percentile, static_argnums=(2, 3))
_rows = jax.jit(jp.row_run_percentile, static_argnums=(3, 4))
_cols = jax.jit(jp.column_run_percentile, static_argnums=(3, 4))


def _columns():
    """values[S, W] and mask[S, W]: column 0 empty, 1 one value, 2 two, 3
    all equal (ties), 4 holding +inf, the rest random with ties."""
    rng = np.random.default_rng(41)
    values = np.round(rng.normal(0.0, 3.0, (S, W)), 0) * 0.5
    mask = rng.random((S, W)) < 0.7
    mask[:, 0] = False
    mask[:, 1] = np.arange(S) == 4
    mask[:, 2] = np.isin(np.arange(S), (2, 7))
    values[:, 3] = 1.25
    mask[:, 3] = True
    values[[1, 5], 4] = np.inf
    return values, mask


def _sorted_runs():
    """Row-sorted runs: each row split into W runs of 0, 1, 2 or more
    values, each run ascending, the rest of the row +inf."""
    rng = np.random.default_rng(43)
    counts = rng.integers(0, 5, (S, W))
    counts[:, 0] = 0
    counts[:, 1] = 1
    counts[:, 2] = 2
    n = int(counts.sum(axis=1).max())
    rows = np.full((S, n), np.inf)
    starts = np.zeros((S, W), np.int64)
    for s in range(S):
        pos = 0
        for w in range(W):
            k = counts[s, w]
            starts[s, w] = pos
            rows[s, pos:pos + k] = np.sort(np.round(rng.normal(0, 2, k)))
            pos += k
    return rows, starts, counts.astype(np.int64)


@pytest.mark.parametrize("est", ESTIMATORS)
@pytest.mark.parametrize("q", QS)
def test_masked_percentile_matches_reference(q, est):
    values, mask = _columns()
    ref = np.asarray(_masked(values, mask, q, est))
    port = tp.masked_percentile(t(values), t(mask), q, est).numpy()
    assert np.isnan(port[0]) and np.isnan(ref[0])
    assert_values(port, ref)


@pytest.mark.parametrize("est", ESTIMATORS)
@pytest.mark.parametrize("q", QS)
def test_row_run_percentile_matches_reference(q, est):
    rows, starts, counts = _sorted_runs()
    ref = np.asarray(_rows(rows, starts, counts, q, est))
    port = tp.row_run_percentile(t(rows), t(starts), t(counts), q,
                                 est).numpy()
    assert np.isnan(port[:, 0]).all()
    assert_values(port, ref)


@pytest.mark.parametrize("est", ESTIMATORS)
@pytest.mark.parametrize("q", QS)
def test_column_run_percentile_matches_reference(q, est):
    rows, starts, counts = _sorted_runs()
    cols = np.ascontiguousarray(rows.T)
    ref = np.asarray(_cols(cols, starts.T, counts.T, q, est))
    port = tp.column_run_percentile(t(cols), t(starts.T), t(counts.T), q,
                                    est).numpy()
    assert_values(port, ref)


def test_single_value_runs_return_the_value():
    """at(k) clips to the run: every estimator of one value is that value
    (R-7 with n = 1 included)."""
    values = np.array([[3.5, 1.0], [9.0, 2.0]])
    mask = np.array([[True, False], [False, True]])
    for est in ESTIMATORS:
        for q in QS:
            out = tp.masked_percentile(t(values), t(mask), q, est).numpy()
            np.testing.assert_array_equal(out, [3.5, 2.0])


@pytest.mark.parametrize("name", PERCENTILE_AGGS)
def test_parse_percentile_name_matches_reference(name):
    assert tp.parse_percentile_name(name) == j_parse(name)


def test_parse_percentile_name_refuses_bad_names():
    for name in ("ep99r5", "p0", "p101"):
        with pytest.raises(KeyError):
            tp.parse_percentile_name(name)
    assert tp.EST_CODES == {tp.EST_LEGACY: 0, tp.EST_R3: 1, tp.EST_R7: 2}
    assert torch.equal(
        tp.masked_percentile(torch.zeros((2, 1)), torch.zeros(
            (2, 1), dtype=torch.bool), 50.0).isnan(), torch.tensor([True]))
