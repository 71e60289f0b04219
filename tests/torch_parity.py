"""Shared inputs and comparisons for the opentsdb_tpu_torch parity tests.

Inputs are made with numpy from a seed and handed to both packages: the
JAX reference (on the CPU) and the port (``device="cpu"``, so every kernel
wrapper runs its plain PyTorch version).
"""

import numpy as np
import pytest
import torch

PAD_TS = np.iinfo(np.int64).max

# The tests' tensors are tiny; one intra-op thread keeps torch from
# contending for the cores that the other test workers' timing-sensitive
# tests run on.
torch.set_num_threads(1)

# Values agree at rtol 1e-9: the two packages sum in different orders
# (prefix differences and reset-scans against direct sums).  atol covers
# results that are zero in exact arithmetic (a dev over equal values, a
# rate over a flat stretch), where rounding leaves ~1e-13 on one side.
RTOL = 1e-9
ATOL = 1e-9


def sorted_batch(rng, s: int, n: int, t0: int = 1_356_998_400_000,
                 span_ms: int = 3_600_000, nan_frac: float = 0.05,
                 hole_frac: float = 0.1, int_values: bool = False):
    """A [S, N] batch laid out as build_batch lays it: each row's points
    strictly increasing, a random count per row (row 1 empty), the tail
    padded at int64 max and masked off.  Some kept slots are masked
    (holes) and some values NaN."""
    ts = np.full((s, n), PAD_TS, np.int64)
    val = np.zeros((s, n), np.int64 if int_values else np.float64)
    mask = np.zeros((s, n), bool)
    for i in range(s):
        k = 0 if i == 1 else int(rng.integers(n // 2, n + 1))
        t = np.sort(rng.choice(span_ms, size=k, replace=False)) + t0
        ts[i, :k] = t
        if int_values:
            val[i, :k] = rng.integers(-1000, 1000, k)
        else:
            val[i, :k] = rng.normal(50.0, 20.0, k)
            val[i, :k][rng.random(k) < nan_frac] = np.nan
        mask[i, :k] = rng.random(k) >= hole_frac
    return ts, val, mask


# K2's widths at the edges of its chunks and segments (a warp walks 128
# windows a chunk; a row is cut into 1, 2, 4 or 8 segments of whole
# chunks), the 1m grid's width, and a row whose segments pass 64 chunks.
K2_EDGE_WIDTHS = [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 385, 513,
                  1023, 1024, 1025, 2047, 2048, 2049, 16_931, 66_000]


def k2_edge_grid(rng, s: int, w: int, t0: int = 1_356_998_400_000):
    """An [S, W] grid as FILL_NONE leaves it (NaN where masked) for K2's
    chunk edges: row 0 has no present window, row 1 one, row 2 only
    windows in its last chunk, row 3 gap runs across every chunk edge,
    row 4 every window, row 5 only its first and last, row 6 only windows
    in its first chunk; the rest holes at random.  Values step down at
    times (counter resets); one zero-width window step (dt = 0)."""
    s = max(s, 8)
    wts = t0 + np.arange(w, dtype=np.int64) * 60_000
    if w > 5:
        wts[5] = wts[4]
    v = np.cumsum(rng.normal(10.0, 30.0, (s, w)), axis=1)
    mask = rng.random((s, w)) >= 0.35
    last = (w - 1) // 128 * 128
    mask[:3] = False
    mask[1, w // 2] = True
    mask[2, last:] = rng.random(w - last) >= 0.5
    mask[2, w - 1] = True
    mask[3] = True
    for edge in range(32, w, 32):
        mask[3, max(edge - 3, 1):edge + 3] = False
    mask[4] = True
    mask[5] = False
    mask[5, [0, w - 1]] = True
    mask[6] = False
    mask[6, :min(128, w)] = rng.random(min(128, w)) >= 0.3
    return wts, np.where(mask, v, np.nan), mask


# K5's routes (csrc/group_order.cu): a group of at most 32 rows is a
# thread a cell; up to 4,224 rows its cells are staged in shared memory (as
# many windows a pass as that holds: a warp a window, or the whole block
# where a pass holds one); a deeper group stays in device memory.  A block
# owns 128 windows where the mean group holds at most 32 rows, else 1.
K5_EDGE_LAYOUTS = {
    "128-window tiles, groups of 0-33 rows, w=37": (
        [0, 1, 2, 31, 32, 33] + [3] * 40, 37),
    "128-window tiles, groups of 100 and 2200 rows, w=37": (
        [1] * 300 + [100, 2200], 37),
    "1-window tiles, groups of 33 and 40 rows": ([33, 40], 5),
    "1-window tiles, groups of 1, 0 and 4224 rows": ([1, 0, 4224], 3),
    "1-window tiles, a group of 4225 rows": ([4225], 2),
}


def k5_edge_groups(layout: str, seed: int = 71):
    """One K5_EDGE_LAYOUTS layout: contrib [S, W] (ties across members,
    NaN values, no exact zero, so that an ordered product's class does
    not hang on where an overflow falls), participate, present and the
    group offsets [G + 1]."""
    sizes, w = K5_EDGE_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    s = sum(sizes)
    contrib = np.round(rng.normal(50.0, 30.0, (s, w)) * 4.0) / 4.0
    contrib[contrib == 0.0] = 0.25
    contrib[rng.random((s, w)) < 0.05] = np.nan
    participate = rng.random((s, w)) < 0.85
    present = participate | (rng.random((s, w)) < 0.1)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return contrib, participate, present, offsets


# R's tiles (csrc/point_rate.cu): a row of at most 2,048 points is one tile
# of 32-256 threads x 8 points; a longer row runs in tiles of 1,024.
R_EDGE_LENGTHS = [7, 255, 257, 2048, 2049, 3077]


def r_edge_rows(n: int, int_values: bool, seed: int = 81):
    """[6, n] sorted rows at R's tile edges: (0) a climbing counter with
    holes, resets and one repeated timestamp; (1) no valid point; (2) one;
    (3) two, at 0 and n - 1 (the second's previous valid point tiles back);
    (4) a reset just before and just after each tile edge (255/256,
    1023/1024, 2047/2048); (5) values near 2^63 (int64: some past it, so
    that the long difference wraps)."""
    rng = np.random.default_rng(seed + n)
    ts = 1_356_998_400_000 + np.cumsum(rng.integers(1, 20_000, (6, n)),
                                       axis=1)
    if n > 2:
        ts[0, n // 2] = ts[0, n // 2 - 1]
    val = np.cumsum(rng.integers(-2_000, 6_000, (6, n)), axis=1)
    for k in (255, 256, 1023, 1024, 2047, 2048):
        if k < n:
            val[4, k:] -= 1_000_000
    mask = np.ones((6, n), bool)
    mask[0] = rng.random(n) < 0.9
    mask[1] = False
    mask[2] = False
    mask[2, n // 2] = True
    mask[3] = False
    mask[3, [0, n - 1]] = True
    if int_values:
        val = val.astype(np.int64)
        val[5] = np.iinfo(np.int64).max - np.abs(val[5]) \
            + rng.integers(0, 2, n) * 3_000
        return ts, val, mask
    val = val.astype(np.float64) * 0.37
    val[5] = 2.0**63 + val[5]
    return ts, val, mask


# H2's layouts (csrc/histogram_percentile.cu): a lane holds K = 8, 4 or 2
# neighbouring buckets (8 where the grid keeps two blocks an SM busy, fewer
# on small grids) and a row takes the power of two at or above B / K lanes,
# so rows of up to 8 K buckets share a warp; rows past 256 buckets are read
# twice.  The widths cross each of those edges; the row counts give the
# card every K (h2_edge_rows).
H2_EDGE_WIDTHS = [1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 200, 256, 257, 600]
H2_EDGE_CLASSES = ["mixed", "negative", "wrap", "big"]
H2_EDGE_PS = [0, 1, 70]


def h2_edge_rows(b: int):
    """Row counts at width b: one row, 1,001 (no multiple of a block's
    rows), and two grids large enough that a 132-SM card takes K = 4 and
    K = 8 (273 blocks and more at K = 8)."""
    big = 70_001 * 8 // max(b, 8)
    return [1, 1001, big // 2 + 1, big]


def h2_edge_counts(r: int, b: int, cls: str, seed: int = 91):
    """counts [r, b] int64 and bound-sorted midpoints [b] of one class:
    "mixed", counts of 0-49 with ties and a row of zeros; "negative",
    negative counts, an all-negative row and a row whose total is 0;
    "wrap", 2^62 added three or four times a row, so that the running sums
    wrap past 2^63 (totals of either sign); "big", a last bucket of
    2^50-2^51, where total * 100.0 / total can round under 100 (row 0's
    does) and no bucket reaches p = 100."""
    rng = np.random.default_rng(seed + 1000 * b + 7 * r
                                + H2_EDGE_CLASSES.index(cls))
    counts = rng.integers(0, 50, (r, b)).astype(np.int64)
    counts[rng.random((r, b)) < 0.4] = 0
    if cls == "negative":
        counts -= rng.integers(0, 30, (r, b))
        counts[0] = -1 - rng.integers(0, 9, b)
        if r > 1:
            counts[1] = 0
            counts[1, 0] = -5
            counts[1, -1] = 5 if b > 1 else 0
    elif cls == "wrap":
        # 2^62 three times in even rows (a negative total), four times in
        # odd ones (the sum wraps back to a positive total)
        add = np.zeros((r, b), np.uint64)
        for k in (3, 4) if b else ():
            rows = np.arange(k - 3, r, 2)
            cols = np.linspace(0, b - 1, k).round().astype(np.int64)
            np.add.at(add, (np.repeat(rows, k), np.tile(cols, len(rows))),
                      np.uint64(1 << 62))
        counts = (counts.astype(np.uint64) + add).astype(np.int64)
    elif cls == "big" and b:
        counts[:, -1] = rng.integers(1 << 50, 1 << 51, r)
        # row 0's share of its whole total rounds under 100
        while True:
            tot = float(counts[0].sum())
            if tot * 100.0 / tot < 100.0:
                break
            counts[0, -1] = rng.integers(1 << 50, 1 << 51)
    if cls != "negative" and r > 2:
        counts[2] = 0
    mid = np.sort(rng.uniform(-50.0, 500.0, b))
    return counts, mid


def h2_edge_percs(n: int):
    """n percentiles: 100, NaN, 0.5, 101, 50, 1 and 99.9 first, then
    draws from [-1, 102)."""
    head = [100.0, np.nan, 0.5, 101.0, 50.0, 1.0, 99.9]
    tail = np.random.default_rng(n).uniform(-1.0, 102.0, max(0, n - 7))
    return np.concatenate([head[:n], tail]).astype(np.float64)


def assert_values(port, ref, where=None):
    """float64 values at RTOL/ATOL with NaN positions equal; `where`
    restricts the comparison to the cells that carry meaning."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    if where is not None:
        where = np.asarray(where, bool)
        port, ref = port[where], ref[where]
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


def assert_exact(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def t(x):
    """numpy -> CPU tensor of the same dtype."""
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda_device():
    """The CUDA device for tests marked `gpu`; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
