"""Build and bind the hand-written CUDA kernels (``opentsdb_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/lib<name>-<hash>.so`` under the repository root,
compiled by ``nvcc`` for ``sm_90a`` at first use.  The hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is loaded as it is.
All sources are compiled at once, one ``nvcc`` process each.  The
libraries are loaded with ctypes; every pointer and the stream pass as
``c_void_p``.

A kernel launches on torch's current stream, synchronises nothing and
allocates nothing: its wrapper (ops.downsample, ops.group_agg, ops.rate,
ops.union_agg, ops.aggregators, storage.device_cache, histogram.kernels,
ops.lanes, ops.streaming, ops.tiling)
allocates the outputs and any scratch with ``torch.empty``, checks
device, dtype, shape and contiguity, calls ``launch``, and raises when
the C entry returns a CUDA error.  A build or launch failure always
raises: nothing here falls back to a plain version.  ``launch`` is the
host's whole cost of reaching a kernel after the wrapper's checks: it
reads a loaded library without the build lock, takes the current stream
as a raw handle, and enters a device guard only for a device that is not
the current one.

``LAUNCHES`` counts kernel launches by name; ``launch`` is the one place
that adds to it.  A launch of K1, K4 or K2 over a stacked batch of more
than one member (the dispatch batcher's, B14) is counted under its name
and again under ``<name>.stacked``; a launch of G1, K1 or K4 over int32
timestamp offsets (B10, the device cache's re-based hit) under its name
and again under ``<name>.i32``; a launch of T1 in its square or centred
mode (the mesh's squareSum and dev partials, B15) under its name and
again under ``tile_partials.square`` or ``tile_partials.centred``; a
launch of P1 under its name and again under
``point_group_moments.<mode>``, each of its four modes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_REPO = os.path.dirname(os.path.dirname(_CSRC))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills, kept beside the library (resources()).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F64 = ctypes.c_double

# C signature of every kernel entry: source stem -> argument types.  Each
# entry returns the cudaError_t of its launch as an int.
SIGNATURES: dict[str, tuple] = {
    # ts, val, mask, edges, s, n, w, rows_per_member, agg, fill_mode,
    # fill_value, val_is_int, ts_is_i32, out, out_mask, stream (edges: one
    # row of w + 1 a member of rows_per_member rows; a solo call is one
    # member)
    "window_moments": (_P, _P, _P, _P, _I64, _I64, _I32, _I64, _I32, _I32,
                       _F64, _I32, _I32, _P, _P, _P),
    # v, m, wts, s, w, rows_per_member, do_rate, counter, drop_resets,
    # counter_max, reset_value, policy, contrib, participate, present,
    # stream (wts: one row of w a member)
    "grid_fill_rate": (_P, _P, _P, _I64, _I32, _I64, _I32, _I32, _I32, _F64,
                       _F64, _I32, _P, _P, _P, _P),
    # contrib, participate, present, offsets, s, g, w, agg, out, out_mask,
    # stream
    "group_moments": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P, _P, _P),
    # ts, val, mask, s, n, val_is_int, counter, drop_resets, counter_max,
    # reset_value, out_ts, out_val, out_mask, stream
    "point_rate": (_P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I64, _I64,
                   _P, _P, _P, _P),
    # ts, mask, offsets, s, n, g, rounds, merged, first, scans, scans_len,
    # u, uoff, stream
    "union_merge": (_P, _P, _P, _I64, _I64, _I64, _I64, _P, _P, _P, _I64, _P,
                    _P, _P),
    # ts, val, mask, offsets, u, uoff, s, n, g, total, agg, policy,
    # val_is_int, rows (3 * s int64 of scratch), out, stream
    "union_reduce": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                     _I32, _I32, _P, _P, _P),
    # ts, val, mask, edges, s, n, w, rows_per_member, code, q, est,
    # fill_mode, fill_value, val_is_int, ts_is_i32, out, out_mask, stream
    # (edges as window_moments takes them)
    "window_order": (_P, _P, _P, _P, _I64, _I64, _I32, _I64, _I32, _F64, _I32,
                     _I32, _F64, _I32, _I32, _P, _P, _P),
    # contrib, participate, present, offsets, s, g, w, code, q, est, out,
    # out_mask, stream
    "group_order": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _F64, _I32, _P, _P,
                    _P),
    # ts, val, mask, offsets, u, uoff, s, n, g, total, code, q, est, policy,
    # val_is_int, counts, out, stream
    "union_order": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                    _F64, _I32, _I32, _I32, _P, _P, _P),
    # sums, live (may be null), offsets, r, n_window, val_is_int, total,
    # pre (null for a window the kernel's rings hold), out, stream
    "moving_average": (_P, _P, _P, _I64, _I64, _I32, _I64, _P, _P, _P),
    # ts_buf, val_buf, p, starts, lengths, s, n, ts_base, ts_is_i32,
    # out_ts, out_val, out_mask, stream
    "gather_windows": (_P, _P, _I64, _P, _P, _I64, _I64, _I64, _I32, _P, _P,
                       _P, _P),
    # seg, cnt, nnz, cells, grid, stream (grid: cells + 1 int64, the
    # stray-entry flag last)
    "histogram_accumulate": (_P, _P, _I64, _I64, _P, _P),
    # counts, mid, percs, r, b, np, out, stream
    "histogram_percentile": (_P, _P, _P, _I64, _I32, _I32, _P, _P),
    # ts, val, mask, edges, s, n, w, val_is_int, sums, counts, mins, maxs,
    # stream
    "lane_partials": (_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P, _P, _P, _P,
                      _P),
    # ts_s, val_s, mask_s, n_s, ts_c, val_c, mask_c, n_c, edges, s, w,
    # fill_mode, fill_value, sum_is_int, cnt_is_int, out, out_mask, stream
    "rollup_avg": (_P, _P, _P, _I64, _P, _P, _P, _I64, _P, _I64, _I32, _I32,
                   _F64, _I32, _I32, _P, _P, _P),
    # ts, val, mask, edges, s, n, wc, w, w0, n_state, total, m2, lo, hi,
    # first, last, prod, oob, grid_lo, grid_hi, stream
    "stream_fold": (_P, _P, _P, _P, _I64, _I64, _I32, _I64, _I64, _P, _P, _P,
                    _P, _P, _P, _P, _P, _P, _I64, _I64, _P),
    # ts, val, mask, edges, s, n, wc, w, w0, n_state, q_state, list, stream
    # (list: s * wc + 1 int64 of scratch)
    "sketch_fold": (_P, _P, _P, _P, _I64, _I64, _I32, _I64, _I64, _P, _P, _P,
                    _P),
    # n, total, m2, lo, hi, first, last, prod, q, cells, code, pct,
    # fill_mode, fill_value, out, out_mask, stream
    "stream_finish": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _F64,
                      _I32, _F64, _P, _P, _P),
    # contrib, participate, present, offsets, mean, s, g, w, mode, cnt,
    # pres, tot, lo, hi, sq, stream (mode: 0 additive, 1 extreme, 2 square,
    # 3 centred)
    "tile_partials": (_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P, _P, _P,
                      _P, _P, _P, _P),
    # ts, val, mask, edges, members, offsets, mean, n, g, w, val_is_int,
    # mode, cnt, tot, lo, hi, sq, stream (mode as tile_partials; the
    # centred mode writes its m2 to sq)
    "point_group_moments": (_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32,
                            _I32, _I32, _P, _P, _P, _P, _P, _P),
}

# The kernels with a member-strided (stacked) form, those with a form
# over int32 timestamp offsets, and the modes counted on their own.
STACKED = ("window_moments", "window_order", "grid_fill_rate")
I32 = ("gather_windows", "window_moments", "window_order")
MODES = ("tile_partials.square", "tile_partials.centred",
         "point_group_moments.additive", "point_group_moments.extreme",
         "point_group_moments.square", "point_group_moments.centred")

# Launch counts per kernel, and per stacked and int32 form and counted
# mode, bumped only by launch().
LAUNCHES: dict[str, int] = {name: 0 for name in SIGNATURES}
LAUNCHES.update({name + ".stacked": 0 for name in STACKED})
LAUNCHES.update({name + ".i32": 0 for name in I32})
LAUNCHES.update({name: 0 for name in MODES})

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (C entry, its error-string function), set with _libs
_entries: dict[str, tuple] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.isfile(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "opentsdb_tpu_torch cannot be built")
    return path


def library_path(name: str, csrc: str = _CSRC) -> str:
    """Where the build of <csrc>/<name>.cu lives, keyed by the source, every
    shared header of <csrc> (*.cuh, which a source may include) and the
    flags."""
    digest = hashlib.sha256()
    for part in [name + ".cu"] + sorted(
            f for f in os.listdir(csrc) if f.endswith(".cuh")):
        with open(os.path.join(csrc, part), "rb") as fh:
            digest.update(part.encode() + b"\0" + fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                    digest.hexdigest()[:16]))


def build(names=None) -> dict[str, str]:
    """Compile every named kernel source that has no current build, one
    nvcc process per source, all started together.  Returns name -> .so
    path; raises with nvcc's output when a compile fails."""
    names = list(SIGNATURES if names is None else names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.isfile(paths[name])]
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        tmp = "%s.%d.tmp" % (paths[name], os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append("%s.cu (exit %d):\n%s" % (
                name, proc.returncode, out.decode(errors="replace")))
        else:
            with open(paths[name] + ".log", "wb") as fh:
                fh.write(out)
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def resources(name: str) -> list[str]:
    """ptxas's report for each kernel of csrc/<name>.cu's current build:
    lines "<kernel> <registers, shared memory, spills>"."""
    with open(library_path(name) + ".log", errors="replace") as fh:
        lines = fh.read().splitlines()
    out, kernel = [], None
    for line in lines:
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel and ("spill" in line or "Used" in line):
            out.append("%s %s" % (kernel, line.split(":", 1)[-1].strip()))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.  A
    loaded library is read without the lock, which guards the build and
    the load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("kernel %s needs a CUDA device" % name)
            lib = ctypes.CDLL(build([name])[name])
            fn = getattr(lib, name)
            fn.argtypes = list(SIGNATURES[name])
            fn.restype = ctypes.c_int
            err = getattr(lib, name + "_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _entries[name] = (fn, err)
            _libs[name] = lib
        return lib


def load_all() -> None:
    """Build every kernel in parallel, then load each library."""
    build()
    for name in SIGNATURES:
        library(name)


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; that device."""
    first = tensors[0]
    index = first.get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError("CUDA kernels take tensors on one CUDA device, "
                             "got %s and %s" % (first.device, t.device))
        if not t.is_contiguous():
            raise ValueError("CUDA kernels take contiguous tensors")
    return first.device


def ptr(t: torch.Tensor) -> int:
    """A tensor's data pointer as a C entry's void* argument (ctypes
    converts the int through the entry's argtypes)."""
    return t.data_ptr()


def launch(name: str, device: torch.device, *args,
           stacked: bool = False, i32: bool = False,
           mode: str | None = None) -> None:
    """Launch kernel `name` on the current stream of `device` with the
    C arguments `args` (the stream is appended); count it, and under
    ``<name>.stacked`` too when `stacked` (a batch of several members),
    under ``<name>.i32`` when `i32` (int32 timestamp offsets), under
    ``<name>.<mode>`` when that is one of MODES; raise on a CUDA error
    from the launch."""
    entry = _entries.get(name)
    if entry is None:
        library(name)
        entry = _entries[name]
    fn, err = entry
    # The device's current stream, read without a Stream object; the
    # device guard only where the device is not already the current one.
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = err(rc).decode(errors="replace")
        raise RuntimeError("CUDA kernel %s failed to launch: %s (%d)"
                           % (name, msg, rc))
    LAUNCHES[name] += 1
    if stacked:
        LAUNCHES[name + ".stacked"] += 1
    if i32:
        LAUNCHES[name + ".i32"] += 1
    if mode is not None and name + "." + mode in LAUNCHES:
        LAUNCHES[name + "." + mode] += 1
