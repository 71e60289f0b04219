"""The kernels' build bookkeeping (ops/kernels.py), checked without nvcc:
every kernel has its source, C entry and launch counter; the build key of
a library covers its source and every shared header, so an edited header
(csrc/order_stats.cuh, which K4, K5 and U3 include) builds anew instead of
loading a stale library.
"""

import os
import re
import shutil

import pytest

from opentsdb_tpu_torch.ops import kernels


def _copy_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(kernels._CSRC, dst)
    return str(dst)


def test_header_edit_changes_the_library_paths(tmp_path):
    csrc = _copy_csrc(tmp_path)
    before = {name: kernels.library_path(name, csrc)
              for name in kernels.SIGNATURES}
    assert before == {name: kernels.library_path(name)
                      for name in kernels.SIGNATURES}
    with open(os.path.join(csrc, "order_stats.cuh"), "ab") as fh:
        fh.write(b"// edited\n")
    after = {name: kernels.library_path(name, csrc)
             for name in kernels.SIGNATURES}
    for name in ("window_order", "group_order", "union_order"):
        assert after[name] != before[name]


def test_source_edit_changes_only_its_library(tmp_path):
    csrc = _copy_csrc(tmp_path)
    before = {name: kernels.library_path(name, csrc)
              for name in kernels.SIGNATURES}
    with open(os.path.join(csrc, "moving_average.cu"), "ab") as fh:
        fh.write(b"\n")
    after = {name: kernels.library_path(name, csrc)
             for name in kernels.SIGNATURES}
    assert {n for n in before if before[n] != after[n]} == {"moving_average"}


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_every_kernel_has_its_source_and_entry(name):
    with open(os.path.join(kernels._CSRC, name + ".cu")) as fh:
        src = fh.read()
    assert re.search(r'extern "C" int %s\(' % name, src)
    assert re.search(r'extern "C" const char\* %s_error\(' % name, src)
    # the C entry takes the signature's arguments plus the stream
    entry = src[src.index('extern "C" int %s(' % name):]
    params = entry[:entry.index(")")].count(",") + 1
    assert params == len(kernels.SIGNATURES[name])
    for header in re.findall(r'#include "([^"]+)"', src):
        assert os.path.isfile(os.path.join(kernels._CSRC, header))
    assert kernels.LAUNCHES[name] >= 0


@pytest.mark.parametrize("name", ["histogram_accumulate",
                                  "histogram_percentile"])
def test_histogram_kernels_build_with_the_rest(name, tmp_path):
    """H1 and H2 are built like every other kernel: their own library,
    keyed by their source, the headers and the flags."""
    assert name in kernels.SIGNATURES and kernels.LAUNCHES[name] == 0
    csrc = _copy_csrc(tmp_path)
    before = kernels.library_path(name, csrc)
    assert os.path.dirname(before) == kernels.BUILD_DIR
    with open(os.path.join(csrc, name + ".cu"), "ab") as fh:
        fh.write(b"\n")
    assert kernels.library_path(name, csrc) != before


@pytest.mark.parametrize("name", ["lane_partials", "rollup_avg"])
def test_rollup_kernels_build_with_the_rest(name, tmp_path):
    """L1 and L2 are built like every other kernel: their own library,
    keyed by their source, the headers and the flags, with a launch
    counter."""
    assert name in kernels.SIGNATURES and kernels.LAUNCHES[name] == 0
    csrc = _copy_csrc(tmp_path)
    before = kernels.library_path(name, csrc)
    assert os.path.dirname(before) == kernels.BUILD_DIR
    with open(os.path.join(csrc, name + ".cu"), "ab") as fh:
        fh.write(b"\n")
    assert kernels.library_path(name, csrc) != before


def test_window_runs_header_is_shared_by_k1_l1_and_l2(tmp_path):
    """K1, L1 and L2 take their window-run search and warp reductions
    from csrc/window_runs.cuh: an edit of the header builds all three
    anew."""
    for name in ("window_moments", "lane_partials", "rollup_avg"):
        with open(os.path.join(kernels._CSRC, name + ".cu")) as fh:
            assert '#include "window_runs.cuh"' in fh.read()
    csrc = _copy_csrc(tmp_path)
    before = {name: kernels.library_path(name, csrc)
              for name in kernels.SIGNATURES}
    with open(os.path.join(csrc, "window_runs.cuh"), "ab") as fh:
        fh.write(b"// edited\n")
    for name in ("window_moments", "lane_partials", "rollup_avg"):
        assert kernels.library_path(name, csrc) != before[name]
