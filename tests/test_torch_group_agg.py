"""Kernels K2 (grid_fill_rate) and K3 (group_moments) against the JAX
package's rate + grid_contributions and moment_group_reduce.

K2: every interpolation policy under every rate option set, on grids with
holes and without (the reference's hole-free lane).  K3: every moment
aggregator, plus the skew case of a 1e15-magnitude group beside a
1.0-magnitude group (test_grid_contrib.py, _SortedGroups.sum).  On the
CPU the port runs the plain PyTorch versions.  Values agree at rtol 1e-9
(torch_parity.RTOL); masks and counts are equal.
"""

import jax
import numpy as np
import pytest
import torch

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.ops import group_agg as jga
from opentsdb_tpu.ops import rate as jrate
from opentsdb_tpu.ops.aggregators import Aggregator
from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops.rate import RateOptions

from torch_parity import (K2_EDGE_WIDTHS, assert_exact, assert_values,
                          k2_edge_grid, t)

POLICIES = ["lerp", "zim", "max", "min", "prev"]
RATES = {
    "none": None,
    "rate": (),
    "counter": (True,),
    "counter_max": (True, 5000),
    "counter_max_reset": (True, 5000, 40),
    "drop_resets": (True, 2**63 - 1, 0, True),
}
AGGS = ["sum", "zimsum", "pfsum", "count", "avg", "min", "mimmin", "max",
        "mimmax", "dev", "squareSum"]
W = 24

# jitted once per static argument set: the eager reference compiles its
# lax.cond anew on every call
_rate = jax.jit(jrate.rate, static_argnums=(3, 4))
_contributions = jax.jit(jga.grid_contributions, static_argnums=3)
_moment_reduce = jax.jit(jga.moment_group_reduce,
                         static_argnames=("agg_name", "num_groups",
                                          "rows_sorted"))
_group_aggregate = jax.jit(jga.grid_group_aggregate,
                           static_argnames=("num_groups", "agg",
                                            "rows_sorted"))


def _grid(rng, s: int, holes: bool):
    """A downsampled [S, W] grid as FILL_NONE leaves it: NaN where masked,
    some rows stepping down (counter resets), one row empty."""
    wts = 1_356_998_400_000 + np.arange(W, dtype=np.int64) * 60_000
    wts[5] = wts[4]   # a zero-width step: rate divides by dt = inf
    v = np.cumsum(rng.normal(10.0, 30.0, (s, W)), axis=1)
    mask = (rng.random((s, W)) >= 0.35) if holes else np.ones((s, W), bool)
    if holes:
        mask[2] = False
    v = np.where(mask, v, np.nan)
    return wts, v, mask


def _ref_k2(wts, v, mask, policy, rate_args):
    if rate_args is not None:
        grid_b = np.broadcast_to(wts[None, :], v.shape)
        _, v, mask = _rate(grid_b, v, mask, jrate.RateOptions(*rate_args),
                           False)
    contrib, participate = _contributions(wts, v, mask,
                                          Aggregator("x", policy, None))
    return np.asarray(contrib), np.asarray(participate), np.asarray(mask)


@pytest.mark.parametrize("holes", [True, False])
@pytest.mark.parametrize("rate_name", list(RATES))
@pytest.mark.parametrize("policy", POLICIES)
def test_grid_fill_rate_matches_reference(policy, rate_name, holes):
    rng = np.random.default_rng(5)
    wts, v, mask = _grid(rng, 6, holes)
    rate_args = RATES[rate_name]
    r_c, r_p, r_m = _ref_k2(wts, v, mask, policy, rate_args)
    opts = None if rate_args is None else RateOptions(*rate_args)
    p_c, p_p, p_m = tga.grid_fill_rate(t(wts), t(v), t(mask), policy, opts)
    assert_exact(p_p.numpy(), r_p)
    assert_exact(p_m.numpy(), r_m)
    # non-participating cells carry no value (the port writes NaN there)
    assert_values(p_c.numpy(), r_c, where=r_p)
    assert np.isnan(p_c.numpy()[~r_p]).all()


@pytest.mark.parametrize("rate_name", list(RATES))
@pytest.mark.parametrize("w", K2_EDGE_WIDTHS)
def test_grid_fill_rate_chunk_edges_match_reference(w, rate_name):
    """The plain K2, the card tests' yardstick, against the reference at
    the widths where the kernel's chunks end, with rows empty, of one
    window, present only in the last chunk or the first, and with gap
    runs across every chunk edge; every policy."""
    wts, v, mask = k2_edge_grid(np.random.default_rng(w), 8, w)
    rate_args = RATES[rate_name]
    opts = None if rate_args is None else RateOptions(*rate_args)
    for policy in POLICIES:
        r_c, r_p, r_m = _ref_k2(wts, v, mask, policy, rate_args)
        p_c, p_p, p_m = tga.grid_fill_rate(t(wts), t(v), t(mask), policy,
                                           opts)
        assert_exact(p_p.numpy(), r_p)
        assert_exact(p_m.numpy(), r_m)
        assert_values(p_c.numpy(), r_c, where=r_p)
        assert np.isnan(p_c.numpy()[~r_p]).all()


def _ref_k3(agg, contrib, participate, present, gid, g):
    out, _ = _moment_reduce(agg_name=agg, contrib=contrib,
                            participate=participate, gid=gid, num_groups=g,
                            rows_sorted=True)
    # the presence mask does not depend on the aggregator
    _, _, out_mask = _group_aggregate(
        np.zeros(contrib.shape[1], np.int64), contrib, present, gid,
        num_groups=g, agg=Aggregator("sum", "lerp", None), rows_sorted=True)
    return np.asarray(out), np.asarray(out_mask)


def _k3_inputs(rng, s=12):
    wts, v, mask = _grid(rng, s, True)
    contrib, participate, _ = _ref_k2(wts, v, mask, "lerp", None)
    gid = np.sort(rng.integers(0, 5, s)).astype(np.int64)
    return contrib, participate, mask, gid


@pytest.mark.parametrize("agg", AGGS)
def test_group_moments_match_reference(agg):
    rng = np.random.default_rng(9)
    contrib, participate, present, gid = _k3_inputs(rng)
    g = 8   # padded: groups 5..7 are empty
    r_out, r_mask = _ref_k3(agg, contrib, participate, present, gid, g)
    p_out, p_mask = tga.group_moments(agg, t(contrib), t(participate),
                                      t(present), tga.group_offsets(gid, g))
    assert_exact(p_mask.numpy(), r_mask)
    assert_values(p_out.numpy(), r_out)


@pytest.mark.parametrize("agg", ["sum", "avg", "dev", "squareSum"])
def test_group_moments_skew_1e15_beside_1(agg):
    """A 1.0-magnitude group right after a 1e15-magnitude group keeps full
    precision: each group accumulates from zero."""
    rng = np.random.default_rng(13)
    big = 1e15 + rng.normal(0, 1e3, (4, W))
    small = 1.0 + rng.normal(0, 0.1, (4, W))
    contrib = np.concatenate([big, small, big])
    participate = np.ones_like(contrib, bool)
    gid = np.repeat(np.arange(3, dtype=np.int64), 4)
    r_out, _ = _ref_k3(agg, contrib, participate, participate, gid, 4)
    p_out, _ = tga.group_moments(agg, t(contrib), t(participate),
                                 t(participate), tga.group_offsets(gid, 4))
    assert_values(p_out.numpy(), r_out)
    exact = {"sum": small.sum(0), "avg": small.mean(0),
             "dev": small.std(0, ddof=1), "squareSum": (small ** 2).sum(0)}
    np.testing.assert_allclose(p_out.numpy()[1], exact[agg], rtol=1e-9)


def test_group_offsets_refuse_unsorted_gid():
    with pytest.raises(ValueError, match="non-decreasing"):
        tga.group_offsets(np.array([1, 0, 1]), 2)
    assert tga.group_offsets(np.array([0, 0, 2, 5]), 4).tolist() \
        == [0, 2, 2, 3, 3]


def test_group_moments_unported_aggregator_raises():
    """K3 computes the moments only and refuses the median; K5
    (group_order) answers it, as the reference's ordered_group_reduce
    does."""
    contrib = np.zeros((2, 2))
    ok = np.ones((2, 2), bool)
    with pytest.raises(KeyError):
        tga.group_moments("median", t(contrib), t(ok), t(ok),
                          tga.group_offsets(np.array([0, 0]), 1))
    rng = np.random.default_rng(9)
    contrib, participate, present, gid = _k3_inputs(rng)
    ref, _ = jax.jit(jga.ordered_group_reduce,
                     static_argnames=("agg_name", "num_groups"))(
        agg_name="median", contrib=contrib, participate=participate, gid=gid,
        num_groups=8)
    out, _ = tga.group_order("median", t(contrib), t(participate),
                             t(present), tga.group_offsets(gid, 8))
    assert_values(out.numpy(), np.asarray(ref))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the kernel launches here")
    v = torch.empty((2, 4), dtype=torch.float64, device="meta")
    m = torch.empty((2, 4), dtype=torch.bool, device="meta")
    wts = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        tga.grid_fill_rate(wts, v, m, "lerp")
    with pytest.raises((ValueError, RuntimeError)):
        tga.group_moments("sum", v, m, m,
                          torch.empty(2, dtype=torch.int64, device="meta"))
