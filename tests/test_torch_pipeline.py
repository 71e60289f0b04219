"""The pipelines on both packages, on the CPU.

The grouped pipeline (K1 -> K2 -> K3): the JAX run_group_pipeline against
opentsdb_tpu_torch's over one batch of group-sorted rows.  The reference
pads the window count to a power of two; its answer is cut to the query's
windows, which are all the port computes.  The union pipeline (R -> U1 ->
U2): the JAX run_union_batch_pipeline over equal-sized groups against the
port's run_union_pipeline over all groups in one batch, with and without
a rate, in float and int mode.  Values agree at rtol 1e-9
(torch_parity.RTOL), int-mode values exactly; timestamps and masks are
equal."""

import numpy as np
import pytest

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.ops import pipeline as jpipe
from opentsdb_tpu.ops.rate import RateOptions as JRateOptions
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops import pipeline as tpipe
from opentsdb_tpu_torch.ops.rate import RateOptions

from torch_parity import assert_exact, assert_values, sorted_batch, t

T0 = 1_356_998_400_000
GID = np.array([0, 0, 0, 1, 1, 3, 3, 3], np.int64)   # group 2 has no rows
CASES = [
    # aggregator, downsample fn, fill, rate options, grid
    ("sum", "avg", "none", None, "fixed"),
    ("dev", "max", "zero", (), "fixed"),
    ("count", "count", "none", (True,), "fixed"),
    ("mimmin", "min", "nan", None, "edges"),
    ("avg", "sum", "scalar", (True, 2**63 - 1, 0, True), "fixed"),
    ("zimsum", "dev", "none", (True, 500, 3), "edges"),
    ("max", "squareSum", "none", None, "all"),
    ("pfsum", "mimmax", "zero", None, "fixed"),
]


def _plan(mod, kind):
    if kind == "fixed":
        return mod.FixedWindows.for_range(T0, T0 + 3_600_000, 300_000)
    if kind == "edges":
        return mod.EdgeWindows((T0, T0 + 700_000, T0 + 2_000_000,
                                T0 + 3_600_000))
    return mod.AllWindow(T0, T0 + 3_600_000)


def _run_both(case, batch):
    agg, fn, fill, rate_args, kind = case
    ts, val, mask = batch
    plan = _plan(jds, kind)
    spec, wargs = plan.split()
    ref = jpipe.run_group_pipeline(
        jpipe.PipelineSpec(
            agg, jpipe.DownsampleStep(fn, spec, fill, 1.5),
            None if rate_args is None else JRateOptions(*rate_args)),
        ts, val, mask, GID, 4, wargs)
    port = tpipe.run_group_pipeline(
        tpipe.PipelineSpec(
            agg, tpipe.DownsampleStep(fn, fill, 1.5),
            None if rate_args is None else RateOptions(*rate_args)),
        t(ts), t(val), t(mask), GID, 4, _plan(tds, kind).window_edges("cpu"))
    return ([np.asarray(x)[..., :plan.count] for x in ref],
            [x.numpy() for x in port])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_group_pipeline_matches_reference(case):
    batch = sorted_batch(np.random.default_rng(21), len(GID), 128)
    ref, port = _run_both(case, batch)
    assert_exact(port[0], ref[0])
    assert_exact(port[2], ref[2])
    assert_values(port[1], ref[1])


UNION_CASES = [
    # aggregator, rate options, int values
    ("sum", None, False),
    ("avg", None, True),
    ("dev", None, False),
    ("mimmin", None, True),
    ("count", (), False),
    ("sum", (True,), True),
    ("max", (True, 250_000), False),
    ("zimsum", (True, 250_000, 10), True),
    ("sum", (True, 2**63 - 1, 0, True), False),
]


@pytest.mark.parametrize("case", UNION_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_union_pipeline_matches_reference(case):
    agg, rate_args, int_values = case
    groups, rows, n = 3, 4, 64
    ts, val, mask = sorted_batch(np.random.default_rng(22), groups * rows, n,
                                 int_values=int_values)
    mask = np.arange(n)[None, :] < mask.sum(axis=1, keepdims=True)
    if int_values:
        val[::3] += 2**53
    shape = (groups, rows, n)
    ru, rout, rmask = (np.asarray(x) for x in jpipe.run_union_batch_pipeline(
        jpipe.PipelineSpec(agg, None, None if rate_args is None
                           else JRateOptions(*rate_args),
                           int_mode=int_values),
        ts.reshape(shape), val.reshape(shape), mask.reshape(shape)))
    offsets = tga.group_offsets(np.repeat(np.arange(groups), rows), groups)
    pu, pout, puoff = tpipe.run_union_pipeline(
        tpipe.PipelineSpec(agg, None, None if rate_args is None
                           else RateOptions(*rate_args)),
        t(ts), t(val), t(mask), offsets, int_values)
    for g in range(groups):
        lo, hi = int(puoff[g]), int(puoff[g + 1])
        assert_exact(pu[lo:hi].numpy(), ru[g][rmask[g]])
        if int_values and rate_args is None:
            assert_exact(pout[lo:hi].numpy(), rout[g][rmask[g]])
        else:
            assert_values(pout[lo:hi].numpy(), rout[g][rmask[g]])


def test_unported_pipeline_raises():
    """check_ported refuses only names outside the registry (and "none"
    as a downsample function, as the reference does); order, rank and
    movingAverage names pass."""
    with pytest.raises(KeyError):
        tpipe.check_ported(tpipe.PipelineSpec("p42x"))
    with pytest.raises(KeyError):
        tpipe.check_ported(tpipe.PipelineSpec(
            "sum", tpipe.DownsampleStep("none")))
    for name in ("median", "ep99r7", "first", "movingAverage7"):
        tpipe.check_ported(tpipe.PipelineSpec(
            name, tpipe.DownsampleStep(name if name != "first" else "last")))
        tpipe.check_ported(tpipe.PipelineSpec(name))


def test_build_batch_layouts_agree():
    """build_batch and build_batch_direct lay out the same batch."""
    from opentsdb_tpu_torch.storage.memstore import Series, SeriesKey
    rng = np.random.default_rng(2)
    series = []
    for i in range(3):
        s = Series(SeriesKey.make(1, {1: i + 1}))
        ts = np.sort(rng.choice(10_000, 20, replace=False)) + T0
        s.append_batch(ts, rng.normal(size=20), False)
        series.append(s)
    direct = tpipe.build_batch_direct(series, T0 + 1000, T0 + 9000, True)
    packed = tpipe.build_batch([s.window(T0 + 1000, T0 + 9000)
                                for s in series])
    for a, b in zip(direct[:3], packed[:3]):
        ok = direct[2]
        np.testing.assert_array_equal(np.where(ok, a, 0), np.where(ok, b, 0))
    assert direct[3] == packed[3] is False
