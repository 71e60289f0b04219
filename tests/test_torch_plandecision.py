"""plan_decision on both packages, on the CPU.

The same matrix of RouteContexts and consults goes to the reference's
plan_decision (opentsdb_tpu/query/plandecision.py:239, with no mesh and
cpu_lane_ok False: the port has no host lane, and its RouteContext
carries none; the mesh's arm is tests/test_torch_mesh_query.py's) and to
the port's: the path, every
fingerprint field but ``modes`` and ``calibration`` (the port has no
kernel modes and one cost table) and the consults made, in order, must be
equal.  The matrix reaches every arm the port has: the rollup lane
(served whole and striped), tiled, refused, the aggregate cache's
rewrite (consulted before the batched arm, and not at all for a streamed
plan, a calendar grid or a rollup segment), batched, the device cache
(its consult carrying the int32 base), streamed, rollup_avg and
resident.  The batched arm is pinned with
``batch_factor`` (0 never batches, 1e12 always does), since each package
prices it on its own cost table.
"""

from types import SimpleNamespace

import pytest

import opentsdb_tpu.ops  # noqa: F401  (x64)
from opentsdb_tpu.query import plandecision as ref_pdn
from opentsdb_tpu.utils.config import Config as RefConfig
from opentsdb_tpu_torch.query import plandecision as pdn
from opentsdb_tpu_torch.utils.config import Config

BASE_CTX = dict(
    seg_kind="raw", ds_fn="avg", aggregator="sum", has_rate=False, s=8,
    n_max=100, wp=64, groups=2, g_pad=2, total_points=800,
    sketchable=False, stream_ok=True, windows_fixed=True,
    store_is_raw=True, has_store=True, platform="cpu", state_mb=6144,
    point_threshold=8_000_000, batch_ok=False, batch_factor=0.0,
    ts_base=None)
# the reference's context fields that the port has no use for
REF_ONLY_CTX = dict(use_mesh=False, n_chips=1, cpu_lane_ok=False,
                    host_lane_max=0)

# name: (context overrides, the TSDB's subsystems, consult answers, path)
MATRIX = {
    "lane": (dict(), {"lanes": True, "cache": True},
             {"lane": True}, "rollup_lane"),
    "lane striped": (dict(s=4096, wp=8192, state_mb=256, groups=8,
                          g_pad=8),
                     {"lanes": True, "cache": True}, {"lane": True},
                     "rollup_lane"),
    "lane striping unavailable": (
        dict(s=4096, wp=8192, state_mb=256, groups=8, g_pad=8,
             aggregator="p99"),
        {"lanes": True, "cache": True}, {"lane": True, "tiled": True},
        "tiled"),
    "tiled": (dict(s=4096, wp=16384, state_mb=256, groups=8, g_pad=8),
              {"cache": True}, {"tiled": True}, "tiled"),
    "tiled, streaming over its budget": (
        dict(s=4096, wp=16384, state_mb=256, total_points=9_000_000),
        {"cache": True}, {"tiled": True}, "tiled"),
    "refused, not streamable": (
        dict(s=4096, wp=16384, state_mb=256, stream_ok=False),
        {"cache": True}, {"tiled": True}, "refused"),
    "refused, no tile split": (
        dict(s=4096, wp=16384, state_mb=256), {"cache": True}, {},
        "refused"),
    "batched": (dict(batch_ok=True, batch_factor=1e12), {"cache": True},
                {"cache": True}, "batched"),
    "batched, priced out": (dict(batch_ok=True, batch_factor=0.0),
                            {"cache": True}, {"cache": True}, "resident"),
    "device cache": (dict(), {"cache": True}, {"cache": True}, "resident"),
    "streamed": (dict(total_points=9_000_000, batch_ok=True,
                      batch_factor=1e12), {"cache": True}, {}, "streamed"),
    "streamed hit over the grid budget": (
        dict(total_points=9_000_000, s=1024, wp=65536, state_mb=1024,
             groups=8, g_pad=8),
        {"cache": True}, {"cache": True}, "streamed"),
    "rollup_avg": (dict(seg_kind="rollup_avg", stream_ok=False,
                        store_is_raw=False, batch_ok=True,
                        batch_factor=1e12),
                   {"cache": True}, {"cache": True}, "rollup_avg"),
    "rollup segment, cache hit": (
        dict(seg_kind="rollup", store_is_raw=False), {"cache": True},
        {"cache": True}, "resident"),
    "device cache, int32 base": (dict(ts_base=1_356_998_400_000),
                                 {"cache": True}, {"cache": True},
                                 "resident"),
    "agg rewrite": (dict(batch_ok=True, batch_factor=1e12),
                    {"cache": True, "agg": True}, {"agg": True,
                                                   "cache": True},
                    "agg_rewrite"),
    "agg recomputes, batched": (dict(batch_ok=True, batch_factor=1e12),
                                {"cache": True, "agg": True},
                                {"cache": True}, "batched"),
    "agg recomputes, device cache": (dict(ts_base=1_356_998_400_000),
                                     {"cache": True, "agg": True},
                                     {"cache": True}, "resident"),
    "agg not consulted, streamed": (dict(total_points=9_000_000),
                                    {"cache": True, "agg": True},
                                    {"agg": True}, "streamed"),
    "agg not consulted, calendar": (dict(windows_fixed=False),
                                    {"cache": True, "agg": True},
                                    {"agg": True, "cache": True},
                                    "resident"),
    "agg not consulted, rollup segment": (
        dict(seg_kind="rollup", store_is_raw=False),
        {"cache": True, "agg": True}, {"agg": True}, "resident"),
    "lane before agg": (dict(), {"lanes": True, "agg": True},
                        {"lane": True, "agg": True}, "rollup_lane"),
    "resident": (dict(), {}, {}, "resident"),
    "resident, no ds batch arm": (dict(batch_ok=True, batch_factor=1e12,
                                       has_store=False), {"cache": True},
                                  {"cache": True}, "resident"),
}


class _Consults:
    """The consult hooks of either package; `calls` records each, in
    order, with its arguments."""

    def __init__(self, answers: dict, ref: bool):
        self.answers = answers
        self.ref = ref
        self.calls = []

    def rollup_plan(self):
        self.calls.append(("rollup_plan",))
        plan = None
        if self.answers.get("lane"):
            plan = SimpleNamespace(lane="1m", k=60, striped=False,
                                   tile_plan=None, decision={})
        return (plan, {"decision": "hit"} if plan else None) if self.ref \
            else plan

    def note_lane_served(self, plan):
        self.calls.append(("note_lane_served", plan.striped))

    def note_lane_fallback(self):
        self.calls.append(("note_lane_fallback",))

    def tiled_refusal(self, reason):
        self.calls.append(("tiled_refusal", reason))

    def tiled_plan(self, acc_cell):
        self.calls.append(("tiled_plan", acc_cell))
        if not self.answers.get("tiled"):
            return None
        return SimpleNamespace(n_tiles=4, tile_rows=1024, n_stripes=2,
                               stripe_w=8192)

    def agg_plan(self, platform):
        self.calls.append(("agg_plan", platform))
        note = {"decision": "recompute", "reason": "below_min_repeats",
                "cachedWindows": 0, "computedWindows": 64}
        if not self.answers.get("agg"):
            return None, note
        note = dict(note, decision="rewrite", reason="reuse",
                    cachedWindows=62, computedWindows=2)
        return SimpleNamespace(decision=note), note

    def device_batch(self, build, ts_base=None):
        self.calls.append(("device_batch", build, ts_base))
        return object() if self.answers.get("cache") else None


def _tsdb(ref: bool, parts: dict):
    return SimpleNamespace(
        config=RefConfig({}) if ref else Config({}),
        rollup_lanes=object() if parts.get("lanes") else None,
        device_cache=object() if parts.get("cache") else None,
        spill_pool=None,
        agg_cache=object() if parts.get("agg") else None)


@pytest.mark.parametrize("name", list(MATRIX))
def test_plan_decision_matches_reference(name):
    over, parts, answers, want = MATRIX[name]
    fields = dict(BASE_CTX, **over)
    decisions, calls = [], []
    for ref, mod in ((True, ref_pdn), (False, pdn)):
        consults = _Consults(answers, ref)
        ctx = mod.RouteContext(**dict(fields, **REF_ONLY_CTX)) if ref \
            else mod.RouteContext(**fields)
        pd = mod.plan_decision(_tsdb(ref, parts), ctx, consults)
        decisions.append(pd)
        calls.append(consults.calls)
    ref, port = decisions
    assert ref.path == port.path == want
    strip = lambda f: {k: v for k, v in f.items()  # noqa: E731
                       if k not in ("modes", "calibration")}
    assert strip(port.fp_fields) == strip(ref.fp_fields)
    assert port.fp_fields["calibration"] == "default"
    assert "modes" not in port.fp_fields
    assert calls[1] == calls[0]
    assert port.fingerprint.startswith("pf-")
    assert (port.refusal is None) == (want != "refused")


def test_fingerprint_is_stable_and_discrete():
    """The fingerprint hashes the routing facts only: the same context
    gives the same fingerprint, another path another one."""
    fields = dict(BASE_CTX)
    prints = set()
    for factor in (1e12, 1e12, 0.0):
        ctx = pdn.RouteContext(**dict(fields, batch_ok=True,
                                      batch_factor=factor))
        pd = pdn.plan_decision(_tsdb(False, {}), ctx,
                               _Consults({}, False))
        prints.add((pd.path, pd.fingerprint))
    assert len(prints) == 2
    assert pdn._fingerprint({"a": 1, "b": [1, 2]}) \
        == ref_pdn._fingerprint({"b": [1, 2], "a": 1})


def test_fingerprint_has_no_mesh_or_host_lane():
    """Every verdict the port gives off the mesh, refused or served,
    fingerprints ``mesh`` and ``hostSmall`` as false (it has no host
    lane)."""
    for over, parts, answers, _ in MATRIX.values():
        pd = pdn.plan_decision(_tsdb(False, parts),
                               pdn.RouteContext(**dict(BASE_CTX, **over)),
                               _Consults(answers, False))
        assert pd.fp_fields["mesh"] is False
        assert pd.fp_fields["hostSmall"] is False
