"""The wide dynamic-range regime (ROADMAP queue C): one series holding
-1e15, then one point in each of the next four 1m windows.

The port sums each window directly (K1 window_moments, K4 window_order),
so its answers are the exact ones; the reference's prefix-difference
downsample (opentsdb_tpu/ops/downsample.py ``_prefix_downsample``) loses
the digits the -1e15 running sum swamps.  Both are held here: the port
to the exact values, through /api/query's planner and through K1 and K4
called directly, and the reference to what it gives, so that a change on
either side shows.  On the card the kernels against the same exact values
are in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from opentsdb_tpu.core import TSDB as RefTSDB
from opentsdb_tpu.models import TSQuery as RefTSQuery
from opentsdb_tpu.models import parse_m_subquery as ref_parse
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.ops import downsample as ds
from opentsdb_tpu_torch.utils.config import Config

BASE = 1_356_998_400
LATER = [-35.48827592954828, 2.0, 1.25, 0.1]
POINTS = [(BASE, -1e15)] + [(BASE + 60 * (k + 1), v)
                            for k, v in enumerate(LATER)]
END = BASE + 299
# the later windows' exact answers, and the reference's
EXACT = {"avg": LATER, "squareSum": [v * v for v in LATER],
         "median": LATER, "first": LATER}
REFERENCE = {"avg": [-35.5, 2.0, 1.25, 0.125],
             "squareSum": [0.0, 0.0, 0.0, 0.0]}
CFG = {"tsd.core.auto_create_metrics": True}


def _answers(tsdb, query_cls, parse, fn):
    for ts, v in POINTS:
        tsdb.add_point("wide.range", ts, v, {"host": "a"})
    q = query_cls(start=str(BASE), end=str(END),
                  queries=[parse("sum:1m-%s:wide.range" % fn)])
    q.validate()
    (result,) = tsdb.new_query_runner().run(q)
    return [v for _, v in result.dps]


@pytest.mark.parametrize("fn", sorted(EXACT))
def test_the_port_answers_the_exact_values(fn):
    tsdb = TSDB(Config(CFG), device="cpu")
    try:
        got = _answers(tsdb, TSQuery, parse_m_subquery, fn)
    finally:
        tsdb.shutdown()
    assert got[0] == (1e30 if fn == "squareSum" else -1e15)
    assert got[1:] == EXACT[fn]


@pytest.mark.parametrize("fn", sorted(REFERENCE))
def test_the_reference_loses_the_digits(fn):
    tsdb = RefTSDB(RefConfig({**CFG, "tsd.query.mesh.enable": False}))
    try:
        got = _answers(tsdb, RefTSQuery, ref_parse, fn)
    finally:
        tsdb.shutdown()
    assert got[1:] == REFERENCE[fn]
    assert got[1:] != EXACT[fn]


def _batch(device="cpu"):
    ts = torch.tensor([[t * 1000 for t, _ in POINTS]], dtype=torch.int64,
                      device=device)
    val = torch.tensor([[v for _, v in POINTS]], dtype=torch.float64,
                       device=device)
    mask = torch.ones_like(ts, dtype=torch.bool)
    edges = ds.FixedWindows.for_range(BASE * 1000, END * 1000,
                                      60_000).window_edges(device)
    return ts, val, mask, edges


@pytest.mark.parametrize("fn", sorted(EXACT))
def test_k1_and_k4_hold_the_exact_values(fn):
    """K1 (avg, squareSum) and K4 (median, first) over the one series,
    every window, to the exact float64 value."""
    ts, val, mask, edges = _batch()
    _, out, out_mask = ds.downsample(ts, val, mask, fn, edges)
    assert out_mask.all()
    want = [1e30 if fn == "squareSum" else -1e15] + EXACT[fn]
    np.testing.assert_array_equal(out[0].numpy(), np.array(want))
