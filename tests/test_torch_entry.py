"""The port's driver entry (opentsdb_tpu_torch/tools/dryrun.py) against
the reference's (__graft_entry__.py), on the CPU: ``entry("cpu")`` runs
and gives finite or NaN outputs equal to the reference's flagship step,
and ``dryrun_multichip`` passes over eight ``cpu`` shards and smaller
meshes.  Without a card the default device raises."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import __graft_entry__ as graft  # noqa: E402
from opentsdb_tpu_torch.tools import dryrun  # noqa: E402

from torch_parity import assert_exact, assert_values  # noqa: E402


def test_entry_runs_and_matches_the_reference():
    fn, args = dryrun.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    wts, out, out_mask = fn(*args)
    for o in (wts, out, out_mask):
        x = o.double().numpy()
        assert np.all(np.isfinite(x) | np.isnan(x))
    rfn, rargs = graft.entry()
    rwts, rout, rmask = (np.asarray(x) for x in jax.jit(rfn)(*rargs))
    # the reference's step aggregates every series into one [W] row
    w = wts.numel()
    assert tuple(out.shape) == (1, w)
    assert_exact(wts.numpy(), rwts[:w])
    assert_exact(out_mask[0].numpy(), rmask[:w])
    assert_values(out[0].numpy(), rout[:w], where=out_mask[0].numpy())
    assert out_mask.any()


@pytest.mark.parametrize("n", [8, 4, 1])
def test_dryrun_multichip_on_cpu_shards(n):
    dryrun.dryrun_multichip(n, ["cpu"] * n)


def test_dryrun_mesh_devices():
    assert dryrun.mesh_devices(2, ["cpu"] * 4) == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="need"):
        dryrun.mesh_devices(4, ["cpu"])


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.mesh_devices(2, ["cuda:0", "cuda:0"])
