"""Materialized partial aggregates: block-cached downsample grids.

Port of opentsdb_tpu/storage/agg_cache.py.  Dashboards ask for the same
metrics over overlapping, sliding ranges all day.  This cache keeps the
expensive middle of the grouped pipeline, the per-(series, window)
downsample grid, in aligned blocks (the Factor Windows stance,
arXiv:2008.12379): a fixed-interval plan is cut into blocks of B
consecutive windows of the epoch-anchored window grid, every cached block
is reused, and only the uncovered pieces are computed.

* **The unit.**  A block is B windows of one plan family (store, metric,
  downsample function, interval, fill, platform, series set), aligned to
  the absolute window grid (block k covers windows [k*B, (k+1)*B)), and
  holds the finished [S, B] downsample values and mask.  Only windows
  wholly inside the query's range are cached; the edge windows, which see
  part of their points, are computed a query.  Rate, gap fill and the
  group reduce run fresh on the assembled grid (ops.pipeline
  run_grid_tail: K2, then K3 or K5).
* **Bit identity.**  A piece is computed by the same K1 or K4 launch a
  cold run makes over exactly its windows' points, and both kernels
  reduce each window's run in row order whatever precedes it in the
  batch, so a warm answer equals a cold one bit for bit, and the cache
  on equals the cache off on the same data.
* **Invalidation.**  The memstore calls ``note_mutation(metric, lo, hi)``
  after a write lands (write-then-mark): an acked write is never served
  stale.  Marks are (generation, time range) records a (store, metric);
  a block is valid while no mark newer than its build generation
  overlaps its range, so an append at "now" invalidates only the block
  under now.  The mark ring is bounded: its overflow raises the floor
  generation, which invalidates everything older.
* **Two tiers.**  The host tier holds every block in numpy under
  ``tsd.query.cache.mb`` (LRU).  Blocks served ``tsd.query.cache.
  promote_hits`` times queue for a mirror on the card (the device tier,
  ``tsd.query.cache.device_mb``, its own LRU), which the maintenance
  thread uploads (``promote_pending``), never a query; a grid whose
  pieces all lie on the card is assembled there with no upload.
* **Admission.**  ``plan`` prices the rewrite against the monolithic
  recompute with the cost model (ops/costmodel.py) and admits a plan
  family to materialization after ``tsd.query.cache.min_repeats``
  occurrences, when the populate's extra cost is recovered within
  ``tsd.query.cache.amortize_horizon`` repeats.

Differences: blocks are keyed on the platform (the TSDB's device type)
with no mode-policy epoch (the port has one kernel a function, no modes);
the device tier holds torch tensors on the card; the reference's
registry counters are ``collect_stats`` tallies (ROADMAP A, slice 8d).
``plan`` has the reference's dry run (``observe=False``), for explain.  When
the device cache holds the metric's entry, ``plan`` prices the recompute
as the hit it would be (a gather, no host build) and the rewrite with a
gather a piece it computes and a dispatch a block it replays; the
reference charges the recompute a host build of every point, which on
this port makes a repeat take a rewrite slower than the hit.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from opentsdb_tpu_torch.ops import costmodel as cm
from opentsdb_tpu_torch.ops.streaming import pad_pow2

# bytes a cached grid cell: float64 value + bool mask
_BYTES_PER_CELL = 9

# retained (generation, range) dirty marks a (store, metric); overflow
# raises the floor generation
_MARK_RING = 512

# plan families whose repeat counts are remembered
_MAX_FAMILIES = 4096


@dataclass
class _Block:
    """One cached block: the finished [S, B] downsample grid slice."""
    store: object            # strong ref: pins id(store)
    metric: int
    rows: dict               # Series object -> row index (by identity: a
    #                          deleted and recreated series never matches)
    val: np.ndarray          # [S, B] float64
    mask: np.ndarray         # [S, B] bool
    gen: int                 # build generation (mark-ring validation)
    lo_ms: int               # the block's range [lo_ms, hi_ms], inclusive
    hi_ms: int
    nbytes: int = 0
    hits: int = 0            # serves; past the bar it queues a promotion
    val_dev: torch.Tensor | None = None   # the device-tier mirror
    mask_dev: torch.Tensor | None = None
    dev_tick: int = 0        # device-tier LRU clock


@dataclass
class PlanPiece:
    """One window-contiguous slice of a rewritten plan."""
    first_ms: int            # ms of the piece's first window
    count: int               # windows in the piece
    fetch_lo: int            # the inclusive point range it reads
    fetch_hi: int
    block: int | None = None  # absolute block index of a cacheable piece
    cached: tuple | None = None   # (val, mask) when served from the cache
    tier: str = ""           # "agg_host" or "agg_device" for a hit
    # a hit's rows in its block (blocks hold their own series set)
    rows: np.ndarray | None = None


@dataclass
class RewritePlan:
    """The decomposition ``plan`` hands the planner."""
    pieces: list
    gen0: int                # the generation snapshot at plan time
    family: tuple
    store: object
    metric: int
    interval_ms: int
    platform: str
    decision: dict = field(default_factory=dict)

    @property
    def cached_windows(self) -> int:
        return sum(p.count for p in self.pieces if p.cached is not None)

    @property
    def computed_windows(self) -> int:
        return sum(p.count for p in self.pieces if p.cached is None)


class AggregateCache:
    """Two-tier block cache of per-(series, window) partial aggregates."""

    def __init__(self, config, device):
        # a power-of-two block span, as the reference's
        self.block_windows = pad_pow2(max(config.get_int(
            "tsd.query.cache.block_windows"), 1), 1)
        self.max_bytes = config.get_int("tsd.query.cache.mb") * 2 ** 20
        self.device_max_bytes = config.get_int(
            "tsd.query.cache.device_mb") * 2 ** 20
        self.min_repeats = max(config.get_int(
            "tsd.query.cache.min_repeats"), 1)
        self.promote_hits = max(config.get_int(
            "tsd.query.cache.promote_hits"), 1)
        self.amortize_horizon = max(config.get_int(
            "tsd.query.cache.amortize_horizon"), 1)
        self.dispatch_overhead_s = config.get_int(
            "tsd.query.cache.dispatch_overhead_us") * 1e-6
        self.device = torch.device(device)
        self._lock = threading.Lock()
        # the cached blocks, in LRU order (a consult moves its block to
        # the end; eviction pops from the front)  # guarded-by: _lock
        self._blocks: dict[tuple, _Block] = {}
        # (store_id, metric, ds_fn, interval) -> block keys, for coverage()
        self._family_index: dict[tuple, set] = {}  # guarded-by: _lock
        # (store_id, metric) -> deque[(gen, lo_ms, hi_ms)] dirty marks
        self._marks: dict[tuple, deque] = {}  # guarded-by: _lock
        # (store_id, metric) -> floor generation: older blocks are invalid
        self._floor: dict[tuple, int] = {}  # guarded-by: _lock
        self._gen = 0  # guarded-by: _lock
        # the newest generation a plan snapshotted: marks younger than it
        # widen in place instead of appending  # guarded-by: _lock
        self._planned_gen = 0
        # until the first plan commits, note_mutation returns without the
        # lock; set under the lock before that plan's executor reads any
        # store data, read without it (a writer that sees False checked
        # after its write landed, so every later plan reads that write)
        self._maybe_cached = False  # guarded-by: _lock (writes)
        self._host_bytes = 0  # guarded-by: _lock
        self._dev_tick = 0  # guarded-by: _lock
        self._dev_bytes = 0  # guarded-by: _lock
        # plan-family repeat counts, in recency order  # guarded-by: _lock
        self._repeats: dict[tuple, int] = {}
        # blocks waiting for a device-tier mirror  # guarded-by: _lock
        self._promote_pending: set = set()
        # tallies  # guarded-by: _lock
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.rewrites = 0
        self.populated = 0

    # -- invalidation ----------------------------------------------------

    def note_mutation(self, metric: int, lo_ms: int | None,
                      hi_ms: int | None, store=None) -> None:
        """The memstore's mutation listener, called after the write lands:
        mark (metric, [lo_ms, hi_ms]) dirty (None bounds: open)."""
        if not self._maybe_cached:
            return
        self.invalidate(store=store, metric=metric, lo_ms=lo_ms,
                        hi_ms=hi_ms)

    def invalidate(self, store=None, metric: int | None = None,
                   lo_ms: int | None = None,
                   hi_ms: int | None = None) -> None:
        """With a metric, a dirty mark over [lo_ms, hi_ms]: the blocks it
        overlaps fail their generation check from now on.  Without one,
        drop everything."""
        with self._lock:
            if metric is None:
                self.invalidations += 1
                self._blocks = {}
                self._family_index.clear()
                self._marks.clear()
                self._floor.clear()
                self._promote_pending.clear()
                self._dev_bytes = 0
                self._host_bytes = 0
                self._gen += 1
                return
            lo = -2 ** 62 if lo_ms is None else int(lo_ms)
            hi = 2 ** 62 if hi_ms is None else int(hi_ms)
            key = (id(store), metric)
            ring = self._marks.get(key)
            if ring is None:
                ring = self._marks[key] = deque(maxlen=_MARK_RING)
            if ring and ring[-1][0] > self._planned_gen:
                # no plan has snapshotted since the newest mark, so no
                # block carries a generation between it and now: widening
                # it invalidates the same set (per-point ingest coalesces)
                g, plo, phi = ring[-1]
                ring[-1] = (g, min(plo, lo), max(phi, hi))
                return
            self.invalidations += 1
            self._gen += 1
            if len(ring) == _MARK_RING:
                # overflow: everything as old as the evicted mark is
                # invalid from now on
                self._floor[key] = max(self._floor.get(key, 0), ring[0][0])
            ring.append((self._gen, lo, hi))

    def _valid_locked(self, entry: _Block) -> bool:
        key = (id(entry.store), entry.metric)
        if entry.gen < self._floor.get(key, 0):
            return False
        for gen, lo, hi in reversed(self._marks.get(key, ())):
            if gen <= entry.gen:
                break
            if lo <= entry.hi_ms and hi >= entry.lo_ms:
                return False
        return True

    # -- planning --------------------------------------------------------

    def plan(self, store, metric: int, series_list, windows,
             start_ms: int, end_ms: int, ds_fn: str, fill_policy: str,
             fill_value, platform: str, s: int, n_max: int, g_pad: int,
             has_rate: bool, total_points: int = 0,
             full_hit: bool = False, observe: bool = True):
        """The rewrite decision for one fixed-grid downsample segment ->
        (RewritePlan or None, decision dict).  None means recompute
        monolithically; the decision dict comes back either way (the
        pipeline span's ``agg_cache`` tag).  `full_hit` says that the
        device cache holds the metric's entry, so the recompute would be
        a hit (``_price``).

        ``observe=False`` is explain's dry run (the reference's :387-484):
        the same verdict from the same state, with no bookkeeping: the
        repeat count is read but not advanced, LRU recency and
        ``_planned_gen`` stay, stale blocks are left for the real pass to
        reap, and no hit, miss or rewrite is counted.  The executor's own
        ``plan`` prices with the count before its increment, so a dry run
        at the same instant gives the same decision."""
        interval = windows.interval_ms
        first = windows.first_window_ms
        w = windows.count
        decision = {"decision": "recompute", "reason": "",
                    "coverage": 0.0, "cachedWindows": 0,
                    "computedWindows": w}
        a0 = first // interval                      # absolute window index
        wf_lo = 0 if start_ms <= first else 1
        last_start = first + (w - 1) * interval
        wf_hi = w - 1 if last_start + interval - 1 <= end_ms else w - 2
        bw = self.block_windows
        if wf_hi < wf_lo:
            decision["reason"] = "no_full_windows"
            return None, decision
        a_lo, a_hi = a0 + wf_lo, a0 + wf_hi
        k_lo = -(-a_lo // bw)                       # ceil division
        k_hi = (a_hi + 1) // bw - 1
        if k_hi < k_lo:
            decision["reason"] = "no_full_blocks"
            return None, decision

        sig = hash(tuple(sorted(id(srs) for srs in series_list)))
        family = (id(store), metric, ds_fn, interval, fill_policy,
                  float(fill_value), platform, sig)
        pieces: list[PlanPiece] = []
        head_count = k_lo * bw - a0
        if head_count > 0:
            pieces.append(PlanPiece(
                first_ms=first, count=head_count, fetch_lo=start_ms,
                fetch_hi=first + head_count * interval - 1))
        hits: list[PlanPiece] = []
        hit_entries: list[tuple] = []
        missing: list[PlanPiece] = []
        with self._lock:
            gen0 = self._gen
            if observe:
                # blocks built from this plan are invalidated by any later
                # write: stop coalescing marks at this generation
                self._planned_gen = max(self._planned_gen, gen0)
                # pop-then-set keeps the counts in recency order, so
                # overflow evicts the stalest families
                repeats = self._repeats.pop(family, 0)
                self._repeats[family] = repeats + 1
                while len(self._repeats) > _MAX_FAMILIES:
                    self._repeats.pop(next(iter(self._repeats)))
            else:
                repeats = self._repeats.get(family, 0)
            for k in range(k_lo, k_hi + 1):
                piece = PlanPiece(
                    first_ms=k * bw * interval, count=bw,
                    fetch_lo=k * bw * interval,
                    fetch_hi=(k + 1) * bw * interval - 1, block=k)
                key = family + (k,)
                entry = self._blocks.get(key)
                if entry is not None and self._valid_locked(entry) and \
                        all(srs in entry.rows for srs in series_list):
                    piece.rows = np.fromiter(
                        (entry.rows[srs] for srs in series_list),
                        np.int64, count=len(series_list))
                    if observe:
                        self._blocks[key] = self._blocks.pop(key)   # LRU
                    if entry.val_dev is not None:
                        if observe:
                            self._dev_tick += 1
                            entry.dev_tick = self._dev_tick
                        piece.cached = (entry.val_dev, entry.mask_dev)
                        piece.tier = "agg_device"
                    else:
                        piece.cached = (entry.val, entry.mask)
                        piece.tier = "agg_host"
                    hits.append(piece)
                    hit_entries.append((key, entry))
                else:
                    if entry is not None and observe:
                        # stale or missing rows: make room for the rebuild
                        self._drop_locked(key)
                    missing.append(piece)
                pieces.append(piece)
        tail_off = (k_hi + 1) * bw - a0
        if tail_off < w:
            pieces.append(PlanPiece(
                first_ms=first + tail_off * interval, count=w - tail_off,
                fetch_lo=first + tail_off * interval, fetch_hi=end_ms))

        cached_windows = sum(p.count for p in hits)
        decision.update(
            coverage=round(cached_windows / max(w, 1), 4),
            cachedWindows=cached_windows,
            computedWindows=w - cached_windows,
            blocks=k_hi - k_lo + 1, blockHits=len(hits), repeats=repeats)

        def commit(reason: str) -> RewritePlan:
            decision.update(decision="rewrite", reason=reason)
            if observe:
                with self._lock:
                    # arm the ingest-side marks before the executor reads
                    # any store data
                    self._maybe_cached = True
                    self.rewrites += 1
                    self.hits += len(hits)
                    self.misses += len(missing)
                    self._note_serves_locked(hit_entries)
            return RewritePlan(pieces=pieces, gen0=gen0, family=family,
                               store=store, metric=metric,
                               interval_ms=interval, platform=platform,
                               decision=decision)

        if hits and not missing and cached_windows >= w - 2 \
                and not full_hit:
            # covered but for the edge windows: the replay wins, and
            # pricing it would tax the path the cache exists to shrink
            return commit("reuse"), decision

        pred_full, pred_rw, per_hit_saving = self._price(
            pieces, w, s, n_max, g_pad, ds_fn, has_rate, total_points,
            full_hit)
        decision["predictedRewriteMs"] = round(pred_rw * 1e3, 3)
        decision["predictedFullMs"] = round(pred_full * 1e3, 3)
        decision["perHitSavingMs"] = round(per_hit_saving * 1e3, 3)
        recoverable = per_hit_saving > 0.0 and pred_rw - pred_full \
            <= self.amortize_horizon * per_hit_saving

        if cached_windows == 0:
            if repeats + 1 < self.min_repeats:
                decision["reason"] = "below_min_repeats"
                return None, decision
            if not recoverable:
                # the populate's extra cost is not recovered within the
                # horizon (a dispatch-bound plan never caches)
                decision["reason"] = "populate_unamortizable"
                return None, decision
            return commit("cold_populate"), decision
        if pred_rw <= pred_full * 1.25:
            # 25% slack keeps a family from flapping on prediction noise
            return commit("reuse"), decision
        if recoverable:
            # partly invalidated: recomputing the missing blocks restores
            # full coverage, admitted by the populate's own rule
            return commit("heal_populate"), decision
        decision["reason"] = "recompute_cheaper"
        return None, decision

    def _price(self, pieces, w: int, s: int, n_max: int, g_pad: int,
               ds_fn: str, has_rate: bool, total_points: int,
               full_hit: bool) -> tuple[float, float, float]:
        """(monolithic recompute, this rewrite, a warm repeat's saving)
        in predicted seconds: each plan's device stages, its host build
        (of the points it copies) and a dispatch overhead a dispatch it
        issues, as the reference prices them.

        With `full_hit` the recompute is a device-cache hit, priced as
        this port runs it (a deliberate difference): a consult over the
        S series (``predict_cache_gather``) and no host build.  Each
        piece the rewrite computes gathers from the same entry, so it
        pays a consult of its own, each block it replays is a copy or a
        gather of its own (a dispatch overhead), and a warm repeat's
        saving is priced with its edge pieces."""
        wp = pad_pow2(w)
        full_bd = cm.stage_breakdown(s, pad_pow2(max(n_max, 1)), wp, g_pad,
                                     ds_fn, has_rate)
        ds_s = full_bd.get("downsample", 0.0)
        tail_s = sum(full_bd.values()) - ds_s
        oh = self.dispatch_overhead_s
        if full_hit:
            build_s, consult_s, replay_s = 0.0, cm.predict_cache_gather(s), oh
        else:
            build_s = cm.predict_host_build(total_points)
            consult_s = replay_s = 0.0
        pred_full = sum(full_bd.values()) + build_s + consult_s + oh
        pred_rw = tail_s + oh
        edges_s = 0.0
        for p in pieces:
            if p.cached is not None:
                pred_rw += replay_s
                continue
            # a piece's downsample and build: its window share of the
            # full plan's
            piece_s = (ds_s + build_s) * (p.count / max(w, 1)) \
                + consult_s + oh
            pred_rw += piece_s
            if p.block is None:
                edges_s += piece_s
        if full_hit:
            blocks = sum(p.block is not None for p in pieces)
            per_hit_saving = pred_full - (tail_s + oh + edges_s
                                          + blocks * replay_s)
        else:
            # a warm repeat costs about the tail and the edge pieces
            per_hit_saving = pred_full - (tail_s + 2 * oh)
        return pred_full, pred_rw, per_hit_saving

    # -- population ------------------------------------------------------

    def store_block(self, plan: RewritePlan, piece: PlanPiece,
                    series_list, val: np.ndarray, mask: np.ndarray) -> None:
        """Insert one computed block, unless a mark younger than the plan's
        generation snapshot overlaps it (it may have landed after the
        block's points were read: the next query recomputes)."""
        entry = _Block(store=plan.store, metric=plan.metric,
                       rows={srs: i for i, srs in enumerate(series_list)},
                       val=val, mask=mask, gen=plan.gen0,
                       lo_ms=piece.fetch_lo, hi_ms=piece.fetch_hi,
                       nbytes=val.shape[0] * val.shape[1] * _BYTES_PER_CELL)
        key = plan.family + (piece.block,)
        with self._lock:
            if not self._valid_locked(entry) \
                    or entry.nbytes > self.max_bytes:
                return
            self._evict_for_locked(entry.nbytes)
            self._drop_locked(key)
            self._blocks[key] = entry
            self._host_bytes += entry.nbytes
            self._family_index.setdefault(key[:4], set()).add(key)
            self.populated += 1

    def _note_serves_locked(self, hit_entries: list) -> None:
        """Count the serves of the blocks a committed plan replays (a plan
        that consults but recomputes never counts) and queue those past
        the promotion bar."""
        for key, entry in hit_entries:
            entry.hits += 1
            if entry.val_dev is None and entry.hits >= self.promote_hits \
                    and 0 < entry.nbytes <= self.device_max_bytes:
                self._promote_pending.add(key)

    def promote_pending(self, max_uploads: int = 8) -> int:
        """Mirror queued hot blocks onto the device (the maintenance
        thread's pass, off the query path); returns the blocks mirrored."""
        if self.device_max_bytes <= 0:
            return 0
        done = 0
        for _ in range(max_uploads):
            with self._lock:
                if not self._promote_pending:
                    break
                key = self._promote_pending.pop()
                entry = self._blocks.get(key)
            if entry is None or entry.val_dev is not None:
                continue
            val_dev = torch.from_numpy(entry.val).to(self.device)
            mask_dev = torch.from_numpy(entry.mask).to(self.device)
            with self._lock:
                if self._blocks.get(key) is not entry:
                    continue        # evicted while uploading
                self._evict_device_for_locked(entry.nbytes)
                entry.val_dev = val_dev
                entry.mask_dev = mask_dev
                self._dev_tick += 1
                entry.dev_tick = self._dev_tick
                self._dev_bytes += entry.nbytes
                done += 1
        return done

    # -- eviction --------------------------------------------------------

    def _drop_locked(self, key: tuple) -> None:
        entry = self._blocks.pop(key, None)
        if entry is None:
            return
        self._host_bytes -= entry.nbytes
        if entry.val_dev is not None:
            self._dev_bytes -= entry.nbytes
        fam = self._family_index.get(key[:4])
        if fam is not None:
            fam.discard(key)
            if not fam:
                del self._family_index[key[:4]]

    def _evict_for_locked(self, incoming: int) -> None:
        while self._blocks and self._host_bytes + incoming > self.max_bytes:
            self._drop_locked(next(iter(self._blocks)))
            self.evictions += 1

    def _evict_device_for_locked(self, incoming: int) -> None:
        while self._dev_bytes + incoming > self.device_max_bytes:
            mirrored = [b for b in self._blocks.values()
                        if b.val_dev is not None]
            if not mirrored:
                break
            victim = min(mirrored, key=lambda b: b.dev_tick)
            victim.val_dev = None
            victim.mask_dev = None
            self._dev_bytes -= victim.nbytes
            self.evictions += 1

    # -- admission support -----------------------------------------------

    def coverage(self, store, metric: int, interval_ms: int, ds_fn: str,
                 start_ms: int, end_ms: int) -> float:
        """The share of a plan's windows that valid cached blocks serve,
        for admission's cost estimate (tsd/admission.py prices the
        rewritten plan).  Approximate: it reads every family of the
        (store, metric, function, interval)."""
        if interval_ms <= 0:
            return 0.0
        bw = self.block_windows
        first = start_ms - start_ms % interval_ms
        w = (end_ms - end_ms % interval_ms - first) // interval_ms + 1
        if w <= 0:
            return 0.0
        covered: set[int] = set()
        with self._lock:
            for key in self._family_index.get(
                    (id(store), metric, ds_fn, interval_ms), ()):
                entry = self._blocks.get(key)
                k = key[-1]
                if entry is not None and k * bw * interval_ms >= first \
                        and (k + 1) * bw * interval_ms - 1 <= end_ms \
                        and self._valid_locked(entry):
                    covered.add(k)
        return min(len(covered) * bw / w, 1.0)

    # -- stats -----------------------------------------------------------

    def collect_stats(self) -> dict:
        with self._lock:
            return {
                "tsd.query.agg_cache.hits": float(self.hits),
                "tsd.query.agg_cache.misses": float(self.misses),
                "tsd.query.agg_cache.evictions": float(self.evictions),
                "tsd.query.agg_cache.invalidations": float(
                    self.invalidations),
                "tsd.query.agg_cache.rewrites": float(self.rewrites),
                "tsd.query.agg_cache.populated": float(self.populated),
                "tsd.query.agg_cache.entries": float(len(self._blocks)),
                "tsd.query.agg_cache.bytes": float(self._host_bytes),
                "tsd.query.agg_cache.device_bytes": float(self._dev_bytes),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)
