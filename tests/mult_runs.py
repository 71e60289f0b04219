"""Runs of the ordered product (mult) and U1's awkward batch, shared by
the CPU tests against the JAX package (test_torch_mult_order.py) and the
card tests against the plain versions (test_torch_gpu.py).  numpy only."""

import numpy as np

from torch_parity import PAD_TS, RTOL, assert_exact

T0 = 1_356_998_400_000
WINDOW_MS = 600_000
STEP_MS = 500
DBL_MAX = np.finfo(np.float64).max

# Every class of the ordered product; the comment is the ordered answer.
CLASS_RUNS = {
    "overflow then zero": [1e300, 1e300, 0.0, 2.0],              # NaN
    "zero then overflow": [0.0, 1e300, 1e300, 3.0],              # +0
    "zero then inf value": [5.0, 0.0, np.inf, 2.0],              # NaN
    "inf value then zero": [2.0, np.inf, 3.0, 0.0],              # NaN
    "overflow then tiny": [1e300, 1e300, 1e-300, 1e-300],        # +inf
    "negative overflow": [-1e300, 1e300, 2.0],                   # -inf
    "two negatives overflow": [-1e300, -1e300, 5.0],             # +inf
    "negative inf value": [2.0, -np.inf, 3.0],                   # -inf
    "negative zero": [-3.0, 0.0, 7.0],                           # -0
    "underflow to zero": [1e-300, 1e-300, 5.0],                  # +0
    "underflow then inf value": [1e-300, 1e-300, np.inf],        # NaN
    "negative underflow": [-1e-200, 1e-200, 1e-200, 3.0],        # -0
    "subnormal recovers": [1e-300, 1e-20, 1e300, 1e20],          # finite
    "subnormal input": [5e-324, 2.0**1000, 2.0**70],             # finite
    "finite": [1.5, -2.0, 0.25, 3.0],                            # -2.25
    "single": [42.0],
    "max exactly": [DBL_MAX / 2, 2.0],                           # DBL_MAX
    "max then over": [DBL_MAX / 2, np.nextafter(2.0, 3.0)],      # +inf
    "smallest normal": [2.0**-1000, 2.0**-22],                   # 2^-1022
    "just subnormal": [2.0**-1000, 2.0**-23],                    # 2^-1023
}


def headline_like(seed: int, n: int) -> list:
    """A headline-batch window: ~231 values in [100, 150), overflowing."""
    return list(100.0 + np.random.default_rng(seed).random(n) * 50.0)


def near_one(seed: int, n: int, signs: bool) -> list:
    rng = np.random.default_rng(seed)
    v = 1.0 + rng.normal(0.0, 1e-3, n)
    if signs:
        v *= np.where(rng.random(n) < 0.5, -1.0, 1.0)
    return list(v)


RUNS = dict(CLASS_RUNS)
RUNS["headline overflow"] = headline_like(1, 231)
RUNS["near-1 finite"] = near_one(2, 231, False)
RUNS["near-1 finite, signs"] = near_one(3, 300, True)
NAMES = list(RUNS)


def _flushed(x):
    x = np.float64(x)
    return np.copysign(0.0, x) if 0 < abs(x) < np.finfo(np.float64).tiny \
        else x


def ordered_product(values, flush: bool = False) -> float:
    """The product in the run's order, one IEEE rounding a step; with
    `flush`, every subnormal input and result is taken as a zero of its
    sign (the reference's XLA on the CPU does so)."""
    f = _flushed if flush else np.float64
    p = np.float64(1.0)
    with np.errstate(all="ignore"):
        for v in values:
            p = f(p * f(v))
    return float(p)


def classify(x) -> np.ndarray:
    """0 finite non-zero, 1 NaN, 2 +inf, 3 -inf, 4 +0, 5 -0."""
    x = np.asarray(x, np.float64)
    return np.select([np.isnan(x), x == np.inf, x == -np.inf,
                      (x == 0) & ~np.signbit(x), (x == 0) & np.signbit(x)],
                     [1, 2, 3, 4, 5], 0)


def assert_same_product(port, ref):
    """Classes exact, finite values at RTOL."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    assert_exact(classify(port), classify(ref))
    fin = classify(ref) == 0
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL, atol=0)


def interleave(values):
    """The run with a masked slot (holding 0, inf or -inf: it must take no
    part) and a NaN value before each value; -> (values, mask)."""
    junk = [0.0, np.inf, -np.inf]
    out, mask = [], []
    for i, v in enumerate(values):
        out += [junk[i % 3], np.nan, v]
        mask += [False, True, True]
    return out, mask


def k4_batch(names, interleaved: bool):
    """One row; window k holds run names[k] at 1 s steps."""
    cols = []
    for k, name in enumerate(names):
        vals, msk = (interleave(RUNS[name]) if interleaved
                     else (RUNS[name], [True] * len(RUNS[name])))
        for j, (v, m) in enumerate(zip(vals, msk)):
            cols.append((T0 + k * WINDOW_MS + j * STEP_MS, v, m))
    ts = np.array([[c[0] for c in cols]], np.int64)
    val = np.array([[c[1] for c in cols]], np.float64)
    mask = np.array([[c[2] for c in cols]], bool)
    return ts, val, mask


def k5_columns(names, interleaved: bool):
    """Column k holds run names[k] down the rows; -> (contrib, participate)."""
    cols = [(interleave(RUNS[n]) if interleaved
             else (RUNS[n], [True] * len(RUNS[n]))) for n in names]
    s = max(len(v) for v, _ in cols)
    contrib = np.zeros((s, len(names)))
    part = np.zeros((s, len(names)), bool)
    for k, (v, m) in enumerate(cols):
        contrib[:len(v), k] = v
        part[:len(v), k] = m
    return contrib, part


def u3_groups(runs, interleaved: bool, dtype=np.float64):
    """Group k's members hold one point each at T0, run k's values in row
    order; members past the run are empty rows.  -> ts, val, mask as
    [G, M, 1]."""
    cols = [(interleave(r) if interleaved else (r, [True] * len(r)))
            for r in runs]
    m = max(len(v) for v, _ in cols)
    ts = np.full((len(runs), m, 1), PAD_TS, np.int64)
    val = np.zeros((len(runs), m, 1), dtype)
    mask = np.zeros((len(runs), m, 1), bool)
    for g, (v, msk) in enumerate(cols):
        ts[g, :len(v), 0] = T0
        val[g, :len(v), 0] = v
        mask[g, :len(v), 0] = msk
    return ts, val, mask


def _row(rng, n, k, dups: bool, base=T0):
    """k sorted timestamps (with repeats where `dups`) as a prefix of n."""
    t_ = np.sort(rng.choice(200_000, size=k, replace=dups)) + base
    ts = np.full(n, PAD_TS, np.int64)
    ts[:k] = t_
    return ts, np.arange(n) < k


def u1_batch():
    """Groups of 1, 2, 3, 5 and 1024 rows, a group of empty and all-masked
    rows, a group of equal rows, an empty group, and rows outside every
    group; -> ts, mask, gid, number of groups."""
    rng = np.random.default_rng(61)
    n = 40
    sizes = {0: 1, 1: 2, 2: 3, 3: 5, 4: 1024, 5: 4, 6: 6, 7: 0, 8: 3}
    rows, gids = [], []
    rows.append(_row(rng, n, 12, False))            # outside: gid -1
    gids.append(-1)
    for g, size in sizes.items():
        for i in range(size):
            if g == 5:                              # empty, all-masked
                ts, mask = _row(rng, n, [0, 7, 0, 3][i], False)
                if i == 1:
                    mask[:] = False                 # all masked
            elif g == 6:                            # every row equal
                ts, mask = _row(np.random.default_rng(7), n, 25, False)
            elif g == 8:                            # repeats within rows
                ts, mask = _row(rng, n, 30, True, base=T0 + 1_000 * i)
            else:                                   # shares across rows
                ts, mask = _row(rng, n, int(rng.integers(0, n + 1)),
                                g in (1, 3))
            rows.append((ts, mask))
            gids.append(g)
    rows.append(_row(rng, n, 9, False))             # outside: past G
    gids.append(len(sizes))
    ts = np.stack([r[0] for r in rows])
    mask = np.stack([r[1] for r in rows])
    # share timestamps across the rows of group 4 from a small pool
    g4 = np.flatnonzero(np.array(gids) == 4)
    pool = np.sort(rng.choice(5_000, size=300, replace=False)) + T0
    for r in g4:
        k = int(rng.integers(0, n + 1))
        ts[r] = PAD_TS
        ts[r, :k] = np.sort(rng.choice(pool, size=k, replace=False))
        mask[r] = np.arange(n) < k
    return ts, mask, np.array(gids, np.int64), len(sizes)
