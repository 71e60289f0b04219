"""Kernel K1 (window_moments): the port's downsample against the JAX one.

Every moment downsample function under every fill policy on fixed,
calendar (edge) and run-all grids, over batches with NaN values, masked
slots, an empty row and int64 pads; on the CPU the port runs the plain
PyTorch version of K1.  The reference pads the window count to a power
of two and masks the windows past the query; the port computes exactly
the query's windows, so the reference's answer is cut to them.  Values
agree at rtol 1e-9 (torch_parity.RTOL); masks and window timestamps are
equal.
"""

import functools

import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu_torch.ops import downsample as tds

from torch_parity import assert_exact, assert_values, sorted_batch, t

FUNCS = ["sum", "zimsum", "pfsum", "count", "avg", "min", "mimmin", "max",
         "mimmax", "dev", "squareSum"]
FILLS = ["none", "zero", "nan", "null", "scalar"]
T0 = 1_356_998_400_000
FILL_VALUE = -7.25


def _plans(kind):
    """(reference plan, port plan) of one grid kind over the batch span."""
    if kind == "fixed":
        args = (T0, T0 + 3_600_000, 300_000)
        return jds.FixedWindows.for_range(*args), \
            tds.FixedWindows.for_range(*args)
    if kind == "edges":
        edges = (T0 - 100_000, T0 + 400_000, T0 + 1_300_000,
                 T0 + 1_300_001, T0 + 2_900_000, T0 + 3_000_000)
        return jds.EdgeWindows(edges), tds.EdgeWindows(edges)
    return jds.AllWindow(T0 + 200_000, T0 + 3_100_000), \
        tds.AllWindow(T0 + 200_000, T0 + 3_100_000)


def _port(ts, val, mask, func, kind, fill, fill_value=FILL_VALUE):
    edges = _plans(kind)[1].window_edges("cpu")
    p_wts, p_out, p_mask = tds.downsample(t(ts), t(val), t(mask), func,
                                          edges, fill, fill_value)
    return p_wts.numpy(), p_out.numpy(), p_mask.numpy()


def _reference(ts, val, mask, func, kind, fills):
    """The JAX downsample under FILL_NONE, then the reference's own
    apply_fill for each policy: downsample ends in exactly that call, so
    this is the reference's answer for every fill at the cost of one
    downsample (each eager reference call compiles its lax.cond).  Each
    answer is cut to the query's windows."""
    plan = _plans(kind)[0]
    spec, wargs = plan.split()
    wts, out, out_mask = jds.downsample(ts, val, mask, func, spec, wargs)
    live = np.arange(spec.count)[None, :] < int(wargs["nwin"])
    w = plan.count
    res = {}
    for fill in fills:
        v, m = jds.apply_fill(out, out_mask, live, fill, FILL_VALUE)
        res[fill] = (np.asarray(wts)[:w], np.asarray(v)[:, :w],
                     np.asarray(m)[:, :w])
    return res


@functools.cache
def _shared_reference(func, kind):
    return _reference(*_batch(), func, kind, FILLS)


def _batch():
    return sorted_batch(np.random.default_rng(7), 6, 64)


@pytest.mark.parametrize("kind", ["fixed", "edges", "all"])
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("func", FUNCS)
def test_window_moments_match_reference(func, fill, kind):
    ref = _shared_reference(func, kind)[fill]
    port = _port(*_batch(), func, kind, fill)
    assert_exact(port[0], ref[0])
    assert_exact(port[2], ref[2])
    assert_values(port[1], ref[1])


def test_fill_composition_is_the_reference_downsample():
    """_reference's shortcut gives what a direct reference downsample
    with the fill policy gives, on the query's windows."""
    ts, val, mask = _batch()
    plan = _plans("edges")[0]
    spec, wargs = plan.split()
    for fill in FILLS:
        direct = jds.downsample(ts, val, mask, "min", spec, wargs, fill,
                                FILL_VALUE)
        ref = _shared_reference("min", "edges")[fill]
        for a, b in zip(direct, ref):
            np.testing.assert_array_equal(np.asarray(a)[..., :plan.count],
                                          b)


@pytest.mark.parametrize("func", ["sum", "min", "dev"])
def test_int64_values_match_reference(func):
    rng = np.random.default_rng(11)
    batch = sorted_batch(rng, 6, 64, int_values=True)
    ref = _reference(*batch, func, "fixed", ["none"])["none"]
    port = _port(*batch, func, "fixed", "none")
    assert_exact(port[2], ref[2])
    assert_values(port[1], ref[1])


def test_dev_large_magnitude_matches_reference():
    """Two-pass dev keeps precision where sum-of-squares cancels
    (test_downsample_rate.py test_dev_large_magnitude)."""
    ts = np.broadcast_to(T0 + np.arange(64, dtype=np.int64) * 1000,
                         (6, 64)).copy()
    val = 1e9 + (np.arange(64, dtype=np.float64) % 8)[None, :].repeat(6, 0)
    mask = np.ones_like(ts, bool)
    ref = _reference(ts, val, mask, "dev", "fixed", ["none"])["none"]
    port = _port(ts, val, mask, "dev", "fixed", "none")
    assert_values(port[1], ref[1])
    assert np.isclose(port[1][0, 0], np.std(np.arange(64) % 8, ddof=1),
                      rtol=1e-9)


def test_unported_function_raises():
    """K1 computes the moments only; downsample sends the median to K4
    and refuses a name outside the registry."""
    rng = np.random.default_rng(1)
    ts, val, mask = sorted_batch(rng, 2, 8)
    edges = tds.FixedWindows.for_range(T0, T0 + 60_000, 10_000) \
        .window_edges("cpu")
    with pytest.raises(KeyError):
        tds.window_moments(t(ts), t(val), t(mask), edges, "median")
    with pytest.raises(KeyError):
        tds.downsample(t(ts), t(val), t(mask), "p42x", edges)
    _, out, out_mask = tds.downsample(t(ts), t(val), t(mask), "median",
                                      edges)
    want = tds.window_order(t(ts), t(val), t(mask), edges, "median")
    assert_exact(out_mask.numpy(), want[1].numpy())
    assert_values(out.numpy(), want[0].numpy())


def test_cuda_request_without_card_raises():
    """A wrapper handed non-CPU tensors launches the kernel or raises: on
    a box with no card it must raise, never compute."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the kernel launches here")
    ts = torch.empty((2, 8), dtype=torch.int64, device="meta")
    val = torch.empty((2, 8), dtype=torch.float64, device="meta")
    mask = torch.empty((2, 8), dtype=torch.bool, device="meta")
    edges = torch.empty(3, dtype=torch.int64, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        tds.window_moments(ts, val, mask, edges, "sum")
