"""The host path to a kernel (ops/kernels.py `launch`, `library`,
`require_cuda`) and the K3 and T1 wrappers' checks, on the CPU.

A launch reads a loaded library without the build lock and enters the
device guard only for a device that is not the current one; every check
that raised before still raises: no library (no card), a nonzero code
from the C entry, tensors off a CUDA device, and the wrappers' shapes and
dtypes.  The launch counters count a launch that returned 0 and nothing
else.  Faked entries stand in for the card here.
"""

import contextlib

import pytest
import torch

from opentsdb_tpu_torch.ops import group_agg as tga
from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.ops import tiling

CUDA0 = torch.device("cuda", 0)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the kernels build and load here")


@pytest.fixture
def fake_entry(monkeypatch):
    """Install a fake C entry for a kernel name; the current device is 0
    and its raw stream 1234.  Returns (install, calls, guards)."""
    calls, guards = [], []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234 + index, raising=False)

    @contextlib.contextmanager
    def guard(index):
        guards.append(index)
        yield

    monkeypatch.setattr(torch.cuda, "device", guard)
    kernels.reset_launches()

    def install(name, rc=0):
        def fn(*args):
            calls.append(args)
            return rc
        monkeypatch.setitem(kernels._entries, name, (fn, lambda code: b"bad"))
    yield install, calls, guards
    kernels.reset_launches()


@pytest.mark.parametrize("name", ["group_moments", "tile_partials",
                                  "window_moments"])
def test_launch_raises_without_a_library(no_card, name):
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        kernels.launch(name, CUDA0, 0, 0)
    assert kernels.LAUNCHES[name] == 0 and name not in kernels._libs


@pytest.mark.parametrize("rc", [1, 2, 700])
@pytest.mark.parametrize("name", ["group_moments", "tile_partials"])
def test_launch_raises_on_a_nonzero_code(fake_entry, name, rc):
    install, calls, _ = fake_entry
    install(name, rc)
    with pytest.raises(RuntimeError,
                       match="CUDA kernel %s failed to launch: bad \\(%d\\)"
                       % (name, rc)):
        kernels.launch(name, CUDA0, 7, 8, mode="centred")
    assert len(calls) == 1
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.parametrize("mode", [None, "additive", "square", "centred"])
def test_launch_counts_a_launch_and_its_mode(fake_entry, mode):
    install, calls, guards = fake_entry
    install("tile_partials")
    kernels.launch("tile_partials", CUDA0, 1, None, 3, mode=mode)
    # the stream of the current device goes last; no device guard
    assert calls == [(1, None, 3, 1234)] and guards == []
    assert kernels.LAUNCHES["tile_partials"] == 1
    for m in ("square", "centred"):
        assert kernels.LAUNCHES["tile_partials." + m] == (m == mode)


@pytest.mark.parametrize("stacked,i32", [(True, False), (False, True),
                                         (True, True)])
def test_launch_counts_stacked_and_int32_forms(fake_entry, stacked, i32):
    install, calls, _ = fake_entry
    install("window_moments")
    kernels.launch("window_moments", CUDA0, 5, stacked=stacked, i32=i32)
    assert kernels.LAUNCHES["window_moments"] == 1
    assert kernels.LAUNCHES["window_moments.stacked"] == stacked
    assert kernels.LAUNCHES["window_moments.i32"] == i32


@pytest.mark.parametrize("device,guarded,stream", [
    (torch.device("cuda", 0), [], 1234),
    (torch.device("cuda"), [], 1234),
    (torch.device("cuda", 1), [1], 1235)])
def test_launch_guards_only_another_device(fake_entry, device, guarded,
                                           stream):
    install, calls, guards = fake_entry
    install("group_moments")
    kernels.launch("group_moments", device, 9)
    assert guards == guarded and calls == [(9, stream)]


def test_library_reads_a_loaded_library_without_the_lock(monkeypatch):
    class Refuse:
        def __enter__(self):
            raise AssertionError("the build lock was taken")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setitem(kernels._libs, "group_moments", lib)
    monkeypatch.setattr(kernels, "_lock", Refuse())
    assert kernels.library("group_moments") is lib


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(4),
    lambda: torch.zeros(4, device="meta"),
    lambda: torch.zeros((4, 4)).t()])
def test_require_cuda_refuses_tensors_off_the_card(make):
    with pytest.raises(ValueError):
        kernels.require_cuda(make())


def _k3_inputs(s=6, w=5, g=2):
    contrib = torch.arange(s * w, dtype=torch.float64).reshape(s, w)
    flags = torch.ones((s, w), dtype=torch.bool)
    return contrib, flags, flags.clone(), torch.tensor([0, 3, s])[:g + 1]


@pytest.mark.parametrize("bad,error", [
    ("participate shape", ValueError), ("present shape", ValueError),
    ("contrib 1-D", ValueError), ("offsets 2-D", ValueError),
    ("offsets empty", ValueError), ("contrib f32", TypeError),
    ("participate u8", TypeError), ("offsets i32", TypeError),
    ("aggregator", KeyError)])
@pytest.mark.parametrize("fn", ["group_moments", "group_order"])
def test_group_wrappers_refuse_bad_inputs(fn, bad, error):
    contrib, part, present, offsets = _k3_inputs()
    agg = "sum" if fn == "group_moments" else "p99"
    if bad == "participate shape":
        part = part[:, :4]
    elif bad == "present shape":
        present = present[:5]
    elif bad == "contrib 1-D":
        contrib = contrib.reshape(-1)
    elif bad == "offsets 2-D":
        offsets = offsets[None, :]
    elif bad == "offsets empty":
        offsets = offsets[:0]
    elif bad == "contrib f32":
        contrib = contrib.float()
    elif bad == "participate u8":
        part = part.to(torch.uint8)
    elif bad == "offsets i32":
        offsets = offsets.int()
    else:
        agg = "p99" if fn == "group_moments" else "sum"
    with pytest.raises(error):
        getattr(tga, fn)(agg, contrib, part, present, offsets)


@pytest.mark.parametrize("fn", ["group_moments", "group_order"])
def test_group_wrappers_never_fall_back_off_the_cpu(fn):
    """A tensor that is not on the CPU takes the kernel's path: without a
    card that raises, it never answers with the plain version."""
    contrib, part, present, offsets = (
        x.to("meta") for x in _k3_inputs())
    agg = "sum" if fn == "group_moments" else "p99"
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tga, fn)(agg, contrib, part, present, offsets)


def _t1_inputs(mode, s=6, w=5, g=2):
    contrib, part, present, offsets = _k3_inputs(s, w, g)
    acc = tiling.new_lane_fold(g, w, mode, "cpu")
    mean = torch.zeros((g, w), dtype=torch.float64) \
        if mode == "centred" else None
    return [contrib, part, present, offsets, acc, mean]


@pytest.mark.parametrize("mode,bad", [
    (mode, bad) for mode in tiling.FOLD_MODES
    for bad in ("participate shape", "lane shape", "lane dtype",
                "contrib f32", "offsets i32", "mean missing or extra")
] + [("centred", "mean shape"), ("centred", "mean f32")])
def test_tile_partials_refuses_bad_inputs(mode, bad):
    contrib, part, present, offsets, acc, mean = _t1_inputs(mode)
    lane = tiling.FOLD_LANES[mode][-1]
    if bad == "participate shape":
        part = part[:4]
    elif bad == "lane shape":
        acc[lane] = acc[lane][:, :3]
    elif bad == "lane dtype":
        acc[lane] = acc[lane].float()
    elif bad == "contrib f32":
        contrib = contrib.float()
    elif bad == "offsets i32":
        offsets = offsets.int()
    elif bad == "mean missing or extra":
        mean = None if mode == "centred" \
            else torch.zeros((2, 5), dtype=torch.float64)
    elif bad == "mean shape":
        mean = mean[:1]
    elif bad == "mean f32":
        mean = mean.float()
    with pytest.raises(ValueError):
        tiling.tile_partials(contrib, part, present, offsets, acc, mean)


@pytest.mark.parametrize("mode", tiling.FOLD_MODES)
def test_tile_partials_never_falls_back_off_the_cpu(mode):
    contrib, part, present, offsets, acc, mean = _t1_inputs(mode)
    meta = {k: v.to("meta") for k, v in acc.items()}
    with pytest.raises(ValueError, match="CUDA"):
        tiling.tile_partials(contrib.to("meta"), part.to("meta"),
                             present.to("meta"), offsets.to("meta"), meta,
                             None if mean is None else mean.to("meta"))


@pytest.mark.parametrize("mode", tiling.FOLD_MODES)
def test_tile_partials_wrapper_passes_its_lanes(fake_entry, monkeypatch,
                                                mode):
    """On a CUDA-looking path the T1 wrapper hands the C entry each lane
    of its mode at its place (the others null) and counts the launch."""
    install, calls, _ = fake_entry
    install("tile_partials")
    contrib, part, present, offsets, acc, mean = _t1_inputs(mode)
    monkeypatch.setattr(kernels, "require_cuda", lambda *ts: CUDA0)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    tiling.tile_partials(contrib, part, present, offsets, acc, mean)
    (args,) = calls
    at = {k: v.data_ptr() for k, v in acc.items()}
    assert args[:9] == (contrib.data_ptr(), part.data_ptr(),
                        present.data_ptr(), offsets.data_ptr(),
                        None if mean is None else mean.data_ptr(), 6, 2, 5,
                        tiling.FOLD_MODES.index(mode))
    assert args[9:15] == (at.get("cnt"), at.get("present"), at.get("tot"),
                          at.get("lo"), at.get("hi"),
                          at.get("m2" if mode == "centred" else "sq"))
    assert len(args) == len(kernels.SIGNATURES["tile_partials"])
    assert kernels.LAUNCHES["tile_partials"] == 1


@pytest.mark.parametrize("agg,code", [("sum", 0), ("count", 1), ("avg", 2),
                                      ("mimmin", 3), ("max", 4), ("dev", 5),
                                      ("squareSum", 6)])
def test_group_moments_wrapper_passes_its_arguments(fake_entry, monkeypatch,
                                                    agg, code):
    install, calls, _ = fake_entry
    install("group_moments")
    contrib, part, present, offsets = _k3_inputs()
    monkeypatch.setattr(kernels, "require_cuda", lambda *ts: CUDA0)
    monkeypatch.setattr(torch.Tensor, "is_cpu", property(lambda self: False))
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device:
                        torch.zeros(shape, dtype=dtype))
    out, mask = tga.group_moments(agg, contrib, part, present, offsets)
    (args,) = calls
    assert args[:8] == (contrib.data_ptr(), part.data_ptr(),
                        present.data_ptr(), offsets.data_ptr(), 6, 2, 5, code)
    assert args[8:] == (out.data_ptr(), mask.data_ptr(), 1234)
    assert len(args) == len(kernels.SIGNATURES["group_moments"])
    assert out.shape == mask.shape == (2, 5)
    assert kernels.LAUNCHES["group_moments"] == 1
