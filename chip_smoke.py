#!/usr/bin/env python3
"""Chip check of opentsdb_tpu_torch: build the CUDA kernels, hold each
against its plain PyTorch version on the card, then answer queries end to
end through the port's TSDB: grouped downsample queries, materialized,
streamed and tiled past the device budget, queries without a downsample
(the union path), histograms through the daemon, rollups with their
striped lane serving, a dashboard fleet through the daemon's
admission gate and dispatch batcher, and the device mesh.

    python3 chip_smoke.py [--seed N]
                          [--mesh-only | --fold-only
                           | --fill-only [--k2-digests FILE]
                                         [--h2-digests FILE]
                           | --union-only [--u3-digests FILE]
                                          [--u2-digests FILE]
                           | --sketch-only [--s2-digests FILE]
                           | [--stream-fold-only [--s1-digests FILE]]
                             [--group-only [--p1-digests FILE]]
                           | --order-only [--k5-digests FILE]
                                          [--r-digests FILE]]

Needs one CUDA card (exits 2 without one) and the repository around it.
--seed (default 0, bench_configs' own data) is mixed into the chunks of
phases 11-13.
The shape is the repository's headline query batch (bench.py): 1024
series in 100 tag groups, 65,536 points each at a ~15.5 s cadence (~11.8
days), 1h windows.  Phases:

1. build: nvcc compiles opentsdb_tpu_torch/csrc/*.cu for sm_90a, one
   process per source, all at once (ops/kernels.py).
2. kernels: K1 window_moments, K2 grid_fill_rate and K3 group_moments on
   the headline batch, each case against the plain version on the same
   inputs: values within rtol 1e-9 (plus atol 1e-9 for exact zeros),
   masks exact.  Times are the median of 7 CUDA-event timed runs.
   K3's timed cases (fold_phase; `--fold-only` runs them and phase 18
   (a) alone): (a) the headline grid in 100 groups, (b) the same grid as
   one group of 1024 rows (fan-in), (c) the 1m grid [1024, 16,931] in
   100 groups, each a wall (CUDA events around the Python call) and a
   device time (torch.profiler's kernel durations) beside index_add_'s.
   K2 also at the widths where its chunks and segments end (W = 1, 2,
   31-33, 127-129, 255-257, 385, 513, 1023-1025, 2047-2049, 16,931,
   66,000) on rows with no present window, one, only windows in the last
   chunk or the first and gap runs across every chunk edge, every policy
   under every rate set.
   K2's timed cases (fill_phase; `--fill-only` runs them and phase 7
   alone, on the fleet built by load_state, and `--k2-digests FILE`
   writes the sha256 of each case's outputs, or holds them to FILE's,
   for a bit-for-bit check against another tree's K2): (a) the headline
   grid [1024, 283] under lerp, every window present and with holes;
   (b) that grid under a counter rate (counter_max, reset_value); (c)
   the stacked grid of 16 headline panels [160, 60]; (d) one 256-row
   tile of the 1m grid [256, 16,931] (phase 14's holes); (e) that whole
   grid [1024, 16,931]; each held to the plain version, a wall and a
   device time beside its byte bound.
   Then K4 window_order (every order and rank downsample function, the
   fills for p99 and first, and "0all" p99 and median: 65,536-point
   runs), then mult's classes at the headline shape (the headline batch,
   whose every window overflows to +inf; a copy with zeros, inf values,
   negative values and factors of 1e-300 sprinkled over it; a near-1
   copy whose products stay finite), each case's cells counted by class
   (finite, +-inf, +-0, NaN), the last two held to the plain version on
   the CPU (classes exact), each timed against torch.segment_reduce
   prod; K5 group_order (every order and rank aggregator over the 100
   groups, median and ep99r7 over all 1024 rows as one group, mult timed;
   ep99r7 on the one group timed beside torch.nanquantile, wall and
   device, and p99 over the 100 groups, the main path's shape, as
   `group_order.grouped`)
   and MA moving_average after K1's and K3's sums (1024 and 100 runs of
   283 windows), movingAverage5 and 10 held to the plain version on the
   CPU bit for bit, movingAverage5 timed at each position beside its byte
   bound and its chain bound (the longest run's live slots times the
   card's dependent float64 add latency, measured once a run by
   csrc/moving_average.cu moving_average_chain).
3. G1 gather_windows, the device cache's gather, against its plain
   version on the headline batch's columns as one packed buffer: (a) the
   full range, 1024 rows x 65,536 points; (b) the last 6 h; (c) the rows
   of four groups, shuffled, over one day.  Timestamps, values and masks
   must be equal.
4. end to end, grouped: a TSDB on the card ingests the batch through
   MemStore.add_batch and answers seven grouped queries (moments, order
   and rank functions in either position, movingAverage5) on the
   materialized route, which builds the [S, N] batch on a miss
   (tsd.query.streaming.point_threshold raised past every query, as in
   phases 8 and 10 and their CPU copies; phase 12 streams them).  The first
   query builds the device cache's entry inline (the cold line); then
   every query is timed as a cache hit, and again with the cache detached
   (a miss: the host batch build and copy).  The count query must count
   every point written, and each answer on a filtered query must match a
   TSDB on the CPU holding the same state (load_state, cache off).  Then
   staleness: one point appended to one series makes the next query miss
   and match the CPU copy; `refresh()` rebuilds the entry and the query
   after it hits with the same answer.  The cold build's steps are timed
   apart (snapshot uploads, device concatenation), beside the host route
   (numpy snapshots, host concatenation, one upload).  Then writes at the
   store's cadence (a point a series every 15.5 s, spread across the
   period or aligned at its start, one period each) interleave with
   `sum:1h-avg:m{group=*}` run back to back while the maintenance thread
   rebuilds the stale entry: each arm prints its hit share and its hit
   and miss walls; afterwards a hit must equal a miss and the count must
   hold every write.  Kernel launch counts are reset before this phase
   and read after it.
5. union kernels: U1 union_merge and U2 union_reduce (a) on the headline
   batch as it is, under all eleven aggregators; (b) on all 1024 rows as
   one group over the last 6 h (the fan-in of `sum:metric` over a fleet);
   (c) on an integer copy of 64 rows in 8 groups near 2^53 (int mode,
   exact but for dev, a truncated float); R point_rate (d) on the headline
   batch under every rate option set, float and all-integer, timed there
   and on the last 6 h of every row, the union path's shape
   (`point_rate.union`); U1 (e) on
   awkward shapes over the last 6 h (groups of 1, 2, 3, 5 and 1013 rows
   with all-masked rows, 64 equal rows, every point repeated in its row),
   exactly.  U1 is timed on (a) and (b) against torch.unique, U2's sum
   and dev on (a) and its sum on (b) (`union_reduce`, `.dev`, `.fanin`),
   each beside its byte bound and its operation bound (an add at every
   member-slot pair where the member takes part, and where it
   interpolates a subtract, a multiply, an add and the division's
   float64 instructions as `cuobjdump -sass` lists them in the built
   kernel), the larger the row's bound.  Then U3
   union_order (first last diff mult median p99 ep99r3 ep99r7) and MA
   after U2's sums, in the same cases (a) to (c), (c) exact, MA bit for
   bit the plain version on the CPU in each; U3's median timed in (a)
   (first, p99 and mult beside it) and (b), MA's movingAverage5 in (a),
   each a wall and a device time.  `--union-only` runs MA's positions,
   U1 and U2 in cases (a)-(c) with their timed cases, U3 and MA in the
   same cases and phase 6 alone; `--u3-digests FILE` writes the sha256
   of U3's and MA's outputs in every case, or holds them to FILE's (U3's
   mult reported only: its shallow groups take the ordered walk itself),
   and `--u2-digests FILE` does the same for U2's outputs under every
   moment aggregator.  `--order-only` runs K5 and R alone at the shapes
   the main path launches them at, each against its plain version under
   every aggregator (rate option set), each timed case a wall and a
   device time beside its byte bound: K5 (a) the headline grid in its
   100 groups, (b) one stacked dispatch of phase 16's 16 order panels
   ([160, 60] in 16 groups), (c) one such panel, (d) the headline grid
   as one group, (e) one group of 40,000 rows x 2 windows (exactness
   only); R (a) the headline batch, (b) its last 6 h, (c) the integer
   counters `mi` over the last 6 h.  `--k5-digests FILE` and
   `--r-digests FILE` write the sha256 of their outputs, or hold them to
   FILE's (K5's mult reported only: a shallow group's product is the
   ordered walk itself).
6. end to end, union: the same TSDB plus an integer metric `mi` (64
   series x 65,536 points in 8 groups) answers ten queries without a
   downsample over the last 6 h of the range (the union path emits a point
   per distinct timestamp, so the full range would be ~6.7e7 points of
   Python extraction a query); each filtered answer must match the CPU
   copy.  Launch counts are reset before this phase and read after it.
7. histogram kernels: H1 histogram_accumulate and H2 histogram_percentile
   against their plain versions on the card, exactly (int64 grids equal,
   percentile values equal): (a) the batch the planner assembles for
   `sum:percentiles[50,90,99,99.9]:h{group=*}` over the latency fleet
   below (R = 23,040 rows, B = 32, nnz 11.8e6); (b) a synthetic batch made
   on the card, 4,096 series x 1,440 points x 32 buckets in 64 groups (nnz
   1.89e8, R = 92,160); (c) case (b) under a 1h downsample (R = 1,536,
   ~3,840 entries a cell); the batches phase 8's other percentile queries
   launch H2 at: (d) `sum:1h-sum:percentiles[50,99]:h{group=*}` (R = 384,
   P = 2, `histogram_percentile.1h`) and (e) `sum:percentiles[99]:h`, all
   256 series as one group (R = 1,440, P = 1,
   `histogram_percentile.ungrouped`).  Each case prints the kernel, bound,
   plain and `index_add_` (the library call for H1) times; H1's kernel
   time is its query-path form (accumulate_rows_deferred: the flag left
   for the answer's copy, no sync), beside the form that reads the flag at
   the call.  Then H2 untimed at the widths where its layout changes (B =
   1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 200, 256, 257, 600) on rows of four
   classes (mixed, negative counts and totals <= 0, running sums that wrap
   past 2^63, totals past 2^48 at p = 100), on 1 and 1,001 rows and on two
   grids that take 4 and 8 buckets a lane, under 0, 1 and 70 percentiles
   with NaN, 0.5, 100 and 101 among them, each exactly its plain version.
   `--fill-only` runs this phase on the latency fleet built by
   load_state, and `--h2-digests FILE` writes the sha256 of H2's outputs
   in every case, or holds them to FILE's.
8. the daemon on the card: a TSDServer on 127.0.0.1 (an ephemeral port)
   over the same TSDB, configured for histograms.  The latency fleet,
   metric `h`: 256 series in 16 groups, a histogram of 32 fixed,
   exponentially spaced buckets per series every 60 s for a day (368,640
   points), counts from the seed.  The last hour goes in through the
   daemon, 1,024 points as telnet `histogram` lines (base64) and the rest
   over POST /api/histogram in batches of 512; the first 23 hours in
   process through add_histogram_point_json, the function the RPC calls.
   10,240 scalar points of `m` go over POST /api/put and telnet `put`.
   (Phase 7 runs after this ingest: its case (a) needs the fleet.)  Then
   five queries over HTTP, GET and POST: the four-percentile query, a 1h
   downsample, show-histogram-buckets on two groups, all 256 series as one
   group, and `sum:1h-avg:m{group=*}`.  Each body must equal the
   in-process answer, and each histogram answer a CPU TSDB's built by
   load_state from the same histogram state.  Launch counts are reset
   before the queries and read after them; H2's launches are also printed
   by shape (`daemon H2 shapes`).
9. lane kernels (run after phase 6, on the headline batch): L1
   lane_partials under 1h windows (W = 283, the rollup job's 1h batch)
   and 1m windows (W = 16,931), with masked slots and NaN values, against
   its plain version: counts, minima and maxima exact, sums within rtol
   1e-9; on an integer metric (h % 1000, whose sums are exact in any
   order) every cell equals K1's sum, count, min and max of its window
   bit for bit.  L2 rollup_avg over the 1m sum and count lanes of the
   batch under 1h windows (int64 and float64 counts, fill none and zero,
   and thin lanes whose cells differ) against its plain version.  Each
   prints the kernel, bound, plain and library times (L1: three
   torch.segment_reduce calls, sum, min and max; L2: two segment_reduce
   sums and a divide).
10. rollups end to end (after phase 8), on a TSDB of their own holding
   `m` and an integer metric `mi` (h % 1000 over 64 series in 8 groups),
   with written rollups (the default 1m/1h/1d table, each interval's SLA
   halfway through the data) and maintenance-built 1h lanes.  (a) The
   rollup job writes the 1h and 1m lanes of both metrics through L1 (its
   wall and the cells written); five queries a metric with the default
   ROLLUP_NOFALLBACK (1h avg through L2, 1h sum, max and count, and a 4h
   avg re-reduced from the 1h lanes) are each held to the raw answer on
   the card (rollup_raw) and, on four groups, to a CPU TSDB's raw answer
   (load_state): rtol 1e-9 on `m`, bitwise on `mi`; one split query
   (tsd.rollups.split_query.enable: the lanes up to the SLA boundary, raw
   points after it) is held to the CPU's raw answer; 10,240 points go in
   over POST /api/rollup and 1,020 telnet `rollup` lines through the
   daemon, and the lane they land in sums to what was sent.  (b) One
   refresh() builds the demanded 1h blocks (its wall beside the cost
   model's prediction); four derivable queries a metric (rollup_raw keeps
   the written rollups out) are timed lane-served, as a device-cache hit
   (lanes detached) and as a miss (cache detached too), the lane answer
   held to the exact one: rtol 1e-9 on `m`, bitwise on `mi`.  One
   appended point makes the next query take the exact path with the
   point counted; refresh() rebuilds and the lane serves the same answer.
   Launch counts are reset before this phase and read after it; then the
   constants of ops/costmodel.py's `cuda` table from this run.
11. stream kernels (after phase 10): S1 stream_fold on two headline
   chunks ([1024, 4096] with masked slots and NaN, sliced as the
   planner slices, sum lanes and every lane) and on config 2's chunks
   ([128, 65,536] into the [128, 720,897] 10 s state, sliced), its audit
   of a wrong slice; S2 sketch_fold on the headline chunks under 1h
   windows, on "0all" windows over two chunks of 4,096 points (1024
   rows: the block path's sort) and of 16,384 (64 rows: its selection),
   and on edge runs of 0, 1, 2, 31, 32, 33, 255, 256, 257, 4,096 and
   4,097 points with NaN, +inf and -inf values and state cells of count
   0; S3 stream_finish on the p95 sketch and on a full config-2
   grid (every function of the config, fills none and zero), each
   against its plain version (the sketch at float32 tolerance, rtol 1e-6
   and atol 1e-4).  S1's library yardstick: torch.segment_reduce sum,
   min and max over the chunk's window runs and the elementwise merge.
   `--sketch-only` runs S2's cases and phase 12's streamed `sum:1h-p95`
   alone, and `--s2-digests FILE` writes the sha256 of each S2 case's
   folded sketch, or holds them to FILE's.  `--stream-fold-only` runs
   S1's cases alone (config 2's chunk printed with its device time and a
   bound over the cells it reaches), and `--s1-digests FILE` does the
   same for each S1 case's folded state.  `--group-only` runs phase 19
   (a), P1 in its four modes, alone, and `--p1-digests FILE` does the
   same for P1's lanes.
12. streamed queries (after phase 8, on its TSDB, the default
   threshold): the cold `sum:1h-avg` (cache entry dropped) must stream
   and queue its entry's build, refresh() build it and the next query
   hit.  With the cache detached the seven queries of phase 4 stream
   (16 chunks of [1024, 4096]): each prints its wall, chunk count and
   split (pack on the host, copy and fold from CUDA events, finish and
   tail, extract) and the host bytes its chunks hold against the
   batch's; then each runs materialized (threshold raised) beside it.
   Every moment answer equals the hit's (rtol 1e-9; count, max and first
   exactly); `sum:1h-p95` streams through the sketch and each of its
   answers lies between the exact per-member quantiles at p -/+ (C/(2K)
   + 1/K), C the most chunk merges a cell took; with
   sketch_percentiles=false it takes the materialized route and equals
   the hit exactly.  Launch counts are reset before this phase and read
   after its streamed runs.
13. BASELINE configs 2 (128 series x 720,896 points at 10 s, sum, min,
   max and count under 10 s windows, 92M points) and 4 (512 x 917,504,
   avg under 1 min windows, then rate and p99; 470M points) at full
   size: bench_configs' closed-form chunks made on the host into a
   ChunkFeed's pinned buffers, copied while the previous chunk folds,
   through a sliced StreamAccumulator; points/s and the per-chunk copy
   and fold times; each grid held to a one-shot K1 over the same data
   assembled on the card (rtol 1e-9; min, max and count exactly), and
   for config 4 the rate + p99 tail on both grids; oob_count() == 0.

14. T1 tile_partials (after phase 9): 256-row tiles of the headline
   batch's K1 sum grid at 1m windows (W = 16,931), one slot in eleven
   and a run of 512 slots in thirteen a row masked (empty windows that
   K2 fills), through K2 and folded by T1 for sum, count, avg, min and
   max, with and without a rate, against the plain version: counts,
   presence, min and max exact, sums at rtol 1e-9; on h % 1000 (the
   integer metric's values) the fold of the four tiles equals K3 over
   the whole grid bit for bit.  Times one tile's launch against its
   byte bound, the plain version and one index_add_ (scatter_reduce
   amin and amax for the extremes).
15. out-of-core queries: (a) after phase 12, on its TSDB, the device
   cache detached: `sum:1m-p95:m{group=*}` with sketch percentiles has
   8.9 GB of streaming state at the default state_mb, so it is tiled
   (2 tiles, 1 stripe); tiled and a resident streamed run at a raised
   state_mb both lie within the sketch's rank bound of the exact
   per-member quantiles.  (b) at state_mb 255, six queries (moments, a
   rate, dev, p99, movingAverage5) in 4 tiles and 4 stripes planned on
   the padded 32,768 windows, of which the 16,931 real windows run 3,
   each equal
   to the resident answer at the default budget (rtol 1e-9; count and
   the max rate exactly); with a 64 MB host ring `sum:1m-avg` demotes
   stripes to disk and answers the same bit for bit; with the pool off
   it answers 413; with the cache attached its tiles come from G1
   gathers.  Each query prints its wall, tiles, stripes, spilled bytes,
   split (tile grids, K2 and the copy to the host, pool writes and
   reads, stripe replays) and the cost model's prediction of the
   overhead (K2 and the pool's round trip and the replays).  (c) after phase 10, on its TSDB, 1m lanes
   built for `m` (state_mb 256) and `mi` (state_mb 16, so that its 64
   series stripe too): `sum:1m-sum` and `sum:1m-sum:rate` take the
   device fold (T1 launches), `dev:1m-avg` the pool replay, each equal to the exact answer (rtol 1e-9 on `m`,
   bitwise on `mi`).  Launch counts are reset before (a) and before (c)
   and read after each.
16. the dashboard fleet (after phase 15 (a, b), on the headline TSDB).
   (a) The member-strided K1, K4 and K2 and the stacked pipeline
   (ops/pipeline.stacked_group_outputs) at Q = 16 members, each with its
   own range, for two panel shapes: the reference's dispatch-layer panel
   (tools/bench_qps.py:66-67, 1 series x 128 points x 16 windows) and a
   headline panel (10 series of the batch over an hour, 256 points
   padded, 60 1m windows): each against its plain version (rtol 1e-9,
   masks exact) and the stacked answers against 16 solo dispatches bit
   for bit; the stacked K2 at chunk-edge widths (16 members of 10 rows,
   W = 16, 60, 128, 129, 1025, every policy and rate set) against its
   plain version and each member's rows bit for bit its solo call's (its
   time is phase 2's case (c)); one stacked dispatch of sum:1m-avg must
   launch each of its kernels once; one stacked dispatch against 16 solo
   ones on CUDA events and on the host clock (the dispatch batcher's own
   dispatch: host stack, copies, kernels, copy back), beside its byte
   bound; the two shapes' host walls give the cost model's
   stacked_dispatch and stacked_cell.  (b) plan_decision's path and fingerprint for
   `sum:1h-avg:m{group=*}` (not batched) and a panel (batched).  (c) A
   TSDServer (8 responder threads) serves 16 client threads in a child
   process, each panel `sum:1m-avg:m{group=gNNN}` or
   `max:1m-max:rate:m{group=gNNN}` over the data's last hour, rotating
   over the 100 groups: batching off (the panels hit the device cache)
   then on, each 3 s of warm-up and 8 s timed; QPS, p50 and p99 on the
   client clock, stacked dispatches, members a dispatch, bucket keys, a
   dispatch's host wall, its thread's CPU time and its copy-back wall
   (the batcher's tallies); no status but 200, and every panel's body
   byte-equal across the arms.  Then 5 s of `p99:1m-p95` panels (K4,
   K5).  Launch counts are reset before the on arm and read after the
   order panels.  (d) Admission: 8
   concurrent full-range queries on one permit and one queue slot get
   503s with Retry-After; X-TSDB-Deadline-Ms: 1 on a full-range query
   gets a 503 (degrade=error); degrade=allow answers a 200 carrying
   partialResults, equal to a CPU TSDB's answer for the coarsened query;
   a client that hangs up while queued is cancelled without a permit.
17. the cache-hit path (after phase 16, on the headline TSDB, the
   threshold raised as in phase 4).  (a) G1's int32 form (timestamps as
   int32 offsets from the first window) against its plain version in
   phase 3's cases (a)-(c), offsets, values and masks exact; K1's int32
   form under every moment function and K4's under mult, p95, first and
   "0all" p99, against their plain versions (rtol 1e-9, masks exact) and
   bit for bit against their int64 forms on the same points; each prints
   its time, bound, plain and library times.  (b) Phase 4's seven
   queries as device-cache hits with the int32 gather and with the base
   withheld (int64): equal bit for bit; both walls with the planner's
   phase split, the gather phase's and G1's shares and the batch's bytes
   (13 against 17 a slot); the int64 gather phase a series is the cost
   model's `cache_gather_series`.  (c) The aggregate cache attached (the
   reference's defaults) on `sum:1h-avg:m{group=*}` and
   `max:1m-max:m{group=*}` over the full range: with the device cache
   holding the metric, three repeats stay device-cache hits (the cache
   prices the recompute as a hit), before and after blocks exist; with
   the device cache detached, first sight, cold populate, warm, and warm
   from the device tier (promote_pending), each warm answer equal to the
   cold one bit for bit and to the cache-off answer; a range slid by one
   window; one appended point served fresh.  Walls, the path and its
   reason, windows served from blocks and computed, and the device
   tier's bytes.  (d) The default-route follow-up: phase
   16's fleet at 1, 2, 4 and 8 responder threads, three arms each (agg
   off and batching off: device-cache hits; agg off, batching on;
   default: agg on, batching on), 2 s warm-up and 4 s timed: QPS, p50,
   p99, each query's request phases from /api/diag/latency and the
   responder thread's CPU a query; every body equal to the hits arm's.
   Launch counts are reset before (b) and read after (d).  Since phase
   18 came, (d) runs at 1 and 8 responders only, and since S1's and P1's
   redesign at 8 only (the full run's time limit).
18. the device mesh (after phase 17, on the headline TSDB's state).  (a)
   T1's four modes (square and centred: the mesh's squareSum and dev
   partials) against their plain versions on a 256-row tile of the 1m
   grid (holes as in phase 14), the centred pass around the tile's own
   mean; counts, presence and extremes exact, sums at rtol 1e-9; each
   timed as a wall and a device time against its byte bound, the plain
   version and one index_add_ (scatter_reduce_ for the extremes).  (b)
   The shared-device combine of four shards' partials timed against one
   torch.stack(...).sum(0) a lane; then `sum:1h-avg`, `dev:1h-avg`,
   `squareSum:1h-avg`, `p95:1h-avg`, `first:1h-avg` and
   `sum:1h-max:rate` (`{group=*}`) as device-cache hits on a TSDB whose
   mesh is four shards on cuda:0, each equal to the single-device hit
   (rtol 1e-9), its wall beside the single-device wall, and through
   /api/query on that TSDB's daemon, the body equal to the same answer.
   (c) The same, HTTP included, on a one-device NCCL mesh
   (torch.cuda.nccl), and, where two or more cards are visible, on a mesh
   of them (else a line says that multi-GPU speed is not measured).  (d)
   `sum:1h-avg` streamed on the four-shard mesh (the cache detached, the
   default threshold).  (e)
   The rollup job's 1h lanes on a (2, 2) mesh on cuda:0 against the
   one-card job's (and, with four or more cards, on a (2, 2) mesh of
   four of them): counts, minima and maxima exact, sums at rtol 1e-9.
   Launch counts are reset before (b) and read after (e); T1's square
   and centred modes must have launched.  `--mesh-only` runs the build
   and this phase alone on the headline TSDB.

Prints a line per case (worst absolute and relative error, and the worst
error as a share of its limit), the `costmodel cuda` line, the `kernels`
JSON line (each kernel's wall `ms`, CUDA events around the Python call,
and its `device_ms`, torch.profiler's kernel durations, with
`library_device_ms` beside `library_ms` where measured; K3's timed cases
as `group_moments.fanin` and `group_moments.1m` and K2's as
`grid_fill_rate.holes`, `.rate`, `.tile` and `.1m`, carrying their
kernel's launches),
the card's name and power limit, and last the result line.  Any failed
check exits 1 before the result line.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

S = 1024              # series
N = 65_536            # points per series
GROUPS = 100
START = 1_356_998_400_000
STEP_MS = 15_500      # mean cadence; jitter below keeps rows strictly sorted
INTERVAL_MS = 3_600_000
END = START + N * STEP_MS + 5_000
RTOL = 1e-9
ATOL = 1e-9
HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
F64_FLOPS = 34e12         # H100 SXM float64 rate outside the tensor cores
FUNCS = ["sum", "zimsum", "pfsum", "count", "avg", "min", "mimmin", "max",
         "mimmax", "dev", "squareSum"]
FILLS = ["none", "zero", "nan", "scalar"]
POLICIES = ["lerp", "zim", "max", "min", "prev"]
RATE_SETS = {"none": None, "rate": (), "counter": (True,),
             "counter_max": (True, 250_000),
             "counter_max_reset": (True, 250_000, 10),
             "drop_resets": (True, 2**63 - 1, 0, True)}
REPLACES = {
    "window_moments": "opentsdb_tpu/ops/downsample.py:1108",
    "grid_fill_rate": "opentsdb_tpu/ops/group_agg.py:354",
    "group_moments": "opentsdb_tpu/ops/group_agg.py:420",
    "union_merge": "opentsdb_tpu/ops/union_agg.py:65",
    "union_reduce": "opentsdb_tpu/ops/union_agg.py:143",
    "point_rate": "opentsdb_tpu/ops/rate.py:58",
    "point_rate.union": "opentsdb_tpu/ops/rate.py:58",
    "window_order": "opentsdb_tpu/ops/downsample.py:1218",
    "group_order": "opentsdb_tpu/ops/group_agg.py:558",
    "group_order.grouped": "opentsdb_tpu/ops/group_agg.py:558",
    "union_order": "opentsdb_tpu/ops/union_agg.py:209",
    "moving_average": "opentsdb_tpu/ops/aggregators.py:177",
    "gather_windows": "opentsdb_tpu/storage/device_cache.py:443",
    "histogram_accumulate": "opentsdb_tpu/histogram/kernels.py:24",
    "histogram_percentile": "opentsdb_tpu/histogram/kernels.py:35",
    "histogram_percentile.1h": "opentsdb_tpu/histogram/kernels.py:35",
    "histogram_percentile.ungrouped": "opentsdb_tpu/histogram/kernels.py:35",
    "lane_partials": "opentsdb_tpu/ops/pipeline.py:190",
    "rollup_avg": "opentsdb_tpu/ops/pipeline.py:109",
    "stream_fold": "opentsdb_tpu/ops/streaming.py:513",
    "sketch_fold": "opentsdb_tpu/ops/streaming.py:406",
    "stream_finish": "opentsdb_tpu/ops/streaming.py:596",
    "tile_partials": "opentsdb_tpu/ops/tiling.py:238",
    "gather_windows.i32": "opentsdb_tpu/storage/device_cache.py:443",
    "window_moments.i32": "opentsdb_tpu/ops/downsample.py:515",
    "window_order.i32": "opentsdb_tpu/ops/downsample.py:515",
    "window_moments.stacked": "opentsdb_tpu/ops/pipeline.py:225",
    "window_order.stacked": "opentsdb_tpu/ops/pipeline.py:225",
    "grid_fill_rate.stacked": "opentsdb_tpu/ops/pipeline.py:225",
    "grid_fill_rate.holes": "opentsdb_tpu/ops/group_agg.py:354",
    "grid_fill_rate.rate": "opentsdb_tpu/ops/rate.py:58",
    "grid_fill_rate.tile": "opentsdb_tpu/ops/tiling.py:188",
    "grid_fill_rate.1m": "opentsdb_tpu/ops/group_agg.py:354",
    "group_moments.fanin": "opentsdb_tpu/ops/group_agg.py:420",
    "union_merge.fanin": "opentsdb_tpu/ops/union_agg.py:65",
    "union_order.fanin": "opentsdb_tpu/ops/union_agg.py:209",
    "union_reduce.dev": "opentsdb_tpu/ops/union_agg.py:143",
    "union_reduce.fanin": "opentsdb_tpu/ops/union_agg.py:143",
    "moving_average.downsample": "opentsdb_tpu/ops/aggregators.py:177",
    "moving_average.grid": "opentsdb_tpu/ops/aggregators.py:177",
    "group_moments.1m": "opentsdb_tpu/ops/group_agg.py:420",
    "tile_partials.square": "opentsdb_tpu/parallel/sharded.py:223",
    "tile_partials.centred": "opentsdb_tpu/parallel/sharded.py:223",
    "point_group_moments": "opentsdb_tpu/parallel/sharded.py:52",
    "point_group_moments.extreme": "opentsdb_tpu/parallel/sharded.py:86",
    "point_group_moments.square": "opentsdb_tpu/parallel/sharded.py:86",
    "point_group_moments.centred": "opentsdb_tpu/parallel/sharded.py:86",
}
# K2's widths at the edges of its chunks and segments (a warp walks 128
# windows a chunk; a row is cut into 1, 2, 4 or 8 segments of whole
# chunks), the 1m grid's width, and a row whose segments pass 64 chunks
K2_EDGE_WIDTHS = [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 385, 513,
                  1023, 1024, 1025, 2047, 2048, 2049, 16_931, 66_000]
PERCENTILES = [p + n + e for n in ("999", "99", "95", "90", "75", "50")
               for p, e in (("p", ""), ("ep", "r3"), ("ep", "r7"))]
ORDER_DS = ["first", "last", "diff", "mult", "median"] + PERCENTILES
ORDER_AGGS = ORDER_DS + ["none"]
UNION_ORDER = ["first", "last", "diff", "mult", "median", "p99", "ep99r3",
               "ep99r7"]
SIX_HOURS_MS = 6 * 3_600_000
INT_ROWS, INT_GROUPS = 64, 8   # the integer metric `mi`
HIST_CONFIG = '{"SimpleHistogramDecoder": 0}'
# the latency fleet `h`: a histogram a series every 60 s for a day
H_SERIES, H_GROUPS, H_POINTS, H_STEP_S = 256, 16, 1_440, 60
H_START_S = START // 1000
H_END_S = H_START_S + H_POINTS * H_STEP_S
# 33 edges, 50 us to ~2.4 s, integers (exact in the binary codec's float32)
H_EDGES = [round(50 * 1.4 ** k) for k in range(33)]
H_PERCS = [50.0, 90.0, 99.0, 99.9]
HB_SERIES, HB_GROUPS = 4_096, 64   # the synthetic histogram batch (b)
# H2's layouts (csrc/histogram_percentile.cu): a lane holds K = 8, 4 or 2
# neighbouring buckets (fewer on small grids), a row the power of two at or
# above B / K lanes; rows past 256 buckets are read twice.  A copy of
# tests/torch_parity.py's H2_EDGE_*, h2_edge_rows, h2_edge_counts and
# h2_edge_percs.
H2_EDGE_WIDTHS = [1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 200, 256, 257, 600]
H2_EDGE_CLASSES = ["mixed", "negative", "wrap", "big"]
H2_EDGE_PS = [0, 1, 70]
# Phases 4-10 keep the materialized route (their misses build
# the [S, N] batch): the streaming threshold raised past every query.
MATERIALIZE = {"tsd.query.streaming.point_threshold": str(2 ** 62)}
# The aggregate cache is on by default; the phases that measure the
# device-cache hit, the batched route or the lanes turn it off, so that a
# repeat stays on its route (phase 17 attaches it where it measures it).
AGG_OFF = {"tsd.query.cache.enable": False}
SKETCH_RTOL, SKETCH_ATOL = 1e-6, 1e-4    # the float32 sketch
# BASELINE configs 2 and 4 (bench_configs.py:406, :452): bench_configs'
# closed-form chunks at a 10 s cadence, 65,536 points a series a chunk
C_START, C_STEP, C_CHUNK = 1_356_998_400_000, 10_000, 65_536
CONFIGS = {
    2: {"s": 128, "chunks": 11, "interval": 10_000,
        "fns": ["sum", "min", "max", "count"]},
    4: {"s": 512, "chunks": 14, "interval": 60_000, "fns": ["avg"]},
}
# Phase 15's device budgets (tsd.query.streaming.state_mb): (b)'s tiled
# queries (count's streaming state, 8 B a cell at the padded 32,768
# windows, is exactly 256 MB: 255 tiles all six), and (c)'s striped lane
# serves by metric
TILED_MB = "255"
STRIPED_MB = {"m": "256", "mi": "16"}
STREAM_QUERIES = ["sum:1h-avg:m{group=*}", "sum:1h-count:m{group=*}",
                  "sum:1h-max:rate:m{group=*}", "p99:1h-avg:m{group=*}",
                  "sum:1h-p95:m{group=*}", "last:1h-first:m{group=*}",
                  "movingAverage5:1h-sum:m{group=*}"]


class Checks:
    """Collects comparison failures and per-kernel worst errors: absolute,
    relative (over cells whose reference is not 0) and as a share of the
    case's limit ATOL + RTOL * |want| (at most 1 passes).  A NaN where the
    other side holds a number counts as an infinite error."""

    def __init__(self):
        self.failures: list[str] = []
        self.worst: dict[str, dict[str, float]] = {}

    def _note(self, kernel: str, **errs) -> None:
        worst = self.worst.setdefault(kernel, dict.fromkeys(errs, 0.0))
        for key, x in errs.items():
            worst[key] = max(worst[key], math.inf if math.isnan(x) else x)

    def values(self, kernel: str, case: str, got, want,
               rtol: float = RTOL, atol: float = ATOL) -> None:
        got = got.double().cpu()
        want = want.double().cpu()
        both_nan = torch.isnan(got) & torch.isnan(want)
        diff = torch.where(both_nan, 0.0, (got - want).abs())
        # inf == inf is a match (empty extremes never leave the kernel,
        # but MAX/MIN_IF_MISSING put f64 max in K2's output)
        diff = torch.where(got == want, 0.0, diff)
        abs_err = float(diff.max()) if diff.numel() else 0.0
        nz = want.abs() > 0
        rel_err = float((diff[nz] / want.abs()[nz]).max()) if nz.any() else 0.0
        limit = atol + rtol * want.abs().nan_to_num(0.0)
        # an exact case (limit 0) is 0 of its limit where it holds
        ratio = torch.where(diff == 0, 0.0, diff / limit)
        to_limit = float(ratio.max()) if diff.numel() else 0.0
        ok = bool((diff <= limit).all())
        self._note(kernel, abs=abs_err, rel=rel_err, to_limit=to_limit)
        print("%-15s %-44s max_abs=%.3e max_rel=%.3e of_limit=%.3e %s"
              % (kernel, case, abs_err, rel_err, to_limit,
                 "ok" if ok else "FAIL"))
        if not ok:
            self.failures.append("%s %s: values differ (max_abs %.3e)"
                                 % (kernel, case, abs_err))

    def exact(self, kernel: str, case: str, got, want,
              what: str = "masks") -> None:
        """Equal tensors: a difference counts as an infinite error."""
        same = torch.equal(got.cpu(), want.cpu())
        err = 0.0 if same else math.inf
        self._note(kernel, abs=err, rel=err, to_limit=err)
        if not same:
            self.failures.append("%s %s: %s differ" % (kernel, case, what))
            print("%-15s %-44s %s FAIL" % (kernel, case, what))


def time_ms(fn, reps: int = 7) -> float:
    """Median of `reps` CUDA-event timed runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, tries: int = 3) -> float | None:
    """Device time of one call of `fn`: the durations of the kernels and
    memsets it puts on the card, as torch.profiler records them (CUPTI
    activity) over `reps` calls after one warm-up, the host's time before
    and between them left out.  Each kernel counts at its mean duration
    times its launches a call, so a record the profiler misses does not
    shorten the figure; a profile that holds no device record at all is
    taken again, up to `tries` times.  None where none held any.  Each
    call runs inside a record_function scope, so a kernel launched through
    ctypes, outside any torch operator, has an operator to correlate with;
    the scope's own span on the device timeline is not a kernel and is
    left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    scope = "chip_smoke.call"
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with record_function(scope):
                    fn()
            torch.cuda.synchronize()
        by_name: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name != scope:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            return sum(sum(d) / len(d) * max(1, round(len(d) / reps))
                       for d in by_name.values()) / 1e3
    return None


def kernel_ms(fn) -> dict:
    """A kernel row's own arm: time_ms's wall (median of 7) as `ms` and
    device_ms's kernel time as `device_ms`."""
    return {"ms": time_ms(fn), "device_ms": device_ms(fn)}


def both_ms(fn) -> tuple[float, float | None]:
    """(wall, device): time_ms's CUDA events around the whole call, host
    work included (median of 31), and device_ms's kernel time alone."""
    return time_ms(fn, 31), device_ms(fn)


def _fmt(x) -> str:
    return "not measured" if x is None else "%.4f ms" % x


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_S, flops / F64_FLOPS) * 1e3


def headline_batch():
    """bench.py's closed-form batch: absolute int64 ms timestamps, float64
    values, every slot present; gid in contiguous group runs."""
    rows = np.arange(S, dtype=np.int64)[:, None]
    cols = np.arange(N, dtype=np.int64)[None, :]
    h = (rows * 2_654_435_761 + cols * 40_503) & 0x7FFFFFFF
    ts = START + cols * STEP_MS + h % 5_000
    val = 100.0 + (h % 1_000).astype(np.float64) * 0.05
    gid = (np.arange(S, dtype=np.int64) * GROUPS) // S
    return ts, val, gid, h


def kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops.rate import RateOptions
    from opentsdb_tpu_torch.utils import datetime_util as DT

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    # the checks also cover masked slots and NaN values
    d_h = torch.from_numpy(h).to(dev)
    c_mask = d_mask & (d_h % 97 != 0)
    c_val = torch.where(d_h % 211 == 0, torch.nan, d_val)
    del d_h
    grids = {
        "fixed": ds.FixedWindows.for_range(START, END, INTERVAL_MS),
        "calendar": ds.EdgeWindows(tuple(DT.calendar_window_edges(
            START, END, 1, "h", "Asia/Kathmandu"))),
        "all": ds.AllWindow(START, END),
    }
    for kind, plan in grids.items():
        edges = plan.window_edges(dev)
        for func in FUNCS:
            for fill in FILLS:
                got = ds.window_moments(d_ts, c_val, c_mask, edges, func,
                                        fill, -1.5)
                want = ds.window_moments_plain(d_ts, c_val, c_mask, edges,
                                               func, fill, -1.5)
                case = "%s %s fill=%s" % (kind, func, fill)
                checks.exact("window_moments", case, got[1], want[1])
                checks.values("window_moments", case, got[0], want[0])
    edges = grids["fixed"].window_edges(dev)
    int_val = (torch.from_numpy(h % 1_000)).to(dev)
    got = ds.window_moments(d_ts, int_val, c_mask, edges, "sum")
    want = ds.window_moments_plain(d_ts, int_val, c_mask, edges, "sum")
    checks.exact("window_moments", "fixed sum int64 values", got[1], want[1])
    checks.values("window_moments", "fixed sum int64 values", got[0],
                  want[0])
    del int_val, c_val, c_mask

    # the main path's K1 call: sum:1h-avg on the clean batch.  Its bound
    # reads val and mask once (9 B a point) but ts only where an edge
    # falls: one 8-byte lookup per edge and row, never a pass over ts.
    w = edges.numel() - 1
    # the library yardstick: torch.segment_reduce over the same window
    # runs, their lengths from the plain edge search outside the timed
    # call (every point of the batch lies inside the windows)
    pos = torch.searchsorted(d_ts, edges.expand(S, -1).contiguous())
    lengths = (pos[:, 1:] - pos[:, :-1]).reshape(-1)
    flat = d_val.reshape(-1)
    if int(lengths.sum()) != S * N:
        checks.failures.append("segment_reduce lengths miss points")
    seg = {red: time_ms(lambda red=red: torch.segment_reduce(
        flat, red, lengths=lengths)) for red in ("sum", "max", "mean")}
    print("time segment_reduce sum %.4f ms  max %.4f ms  mean %.4f ms "
          "(K1 library, %d runs)" % (seg["sum"], seg["max"], seg["mean"],
                                     lengths.numel()))
    del pos, lengths, flat
    k1 = {
        **kernel_ms(lambda: ds.window_moments(d_ts, d_val, d_mask, edges,
                                              "avg")),
        "plain_ms": time_ms(lambda: ds.window_moments_plain(
            d_ts, d_val, d_mask, edges, "avg")),
        "bound_ms": bound_ms(S * N * (8 + 1) + S * (w + 1) * 8
                             + (w + 1) * 8 + S * w * (8 + 1), 2.0 * S * N),
        "library_ms": seg["mean"],
    }
    v, m = ds.window_moments(d_ts, d_val, d_mask, edges, "avg")
    wts = edges[:w]
    del d_ts, d_val, d_mask

    # K2 on the [S, W] grid, with holes punched in and without
    hole = (torch.arange(S * w, device=dev).reshape(S, w) * 7919) % 13 == 0
    grids2 = {"holes": (torch.where(hole, torch.nan, v), m & ~hole),
              "no holes": (v.nan_to_num(0.0), torch.ones_like(m))}
    for gname, (gv, gm) in grids2.items():
        for policy in POLICIES:
            for rname, rargs in RATE_SETS.items():
                opts = None if rargs is None else RateOptions(*rargs)
                got = ga.grid_fill_rate(wts, gv, gm, policy, opts)
                want = ga.grid_fill_rate_plain(wts, gv, gm, policy, opts)
                case = "%s policy=%s rate=%s" % (gname, policy, rname)
                checks.exact("grid_fill_rate", case, got[1], want[1])
                checks.exact("grid_fill_rate", case, got[2], want[2])
                checks.values("grid_fill_rate", case, got[0], want[0])
    # K2 at the widths where its chunks end, on rows empty, of one
    # window, present only in the last chunk or the first, and with gap
    # runs across every chunk edge
    for ew in K2_EDGE_WIDTHS:
        ev = k2_edge_grid(np.random.default_rng(ew), 64, ew, dev)
        for policy in POLICIES:
            for rname, rargs in RATE_SETS.items():
                opts = None if rargs is None else RateOptions(*rargs)
                got = ga.grid_fill_rate(*ev, policy, opts)
                want = ga.grid_fill_rate_plain(*ev, policy, opts)
                case = "edges W=%d policy=%s rate=%s" % (ew, policy, rname)
                checks.exact("grid_fill_rate", case, got[1], want[1])
                checks.exact("grid_fill_rate", case, got[2], want[2])
                checks.values("grid_fill_rate", case, got[0], want[0])
    del ev, got, want

    # K3 over the main path's contributions, and the skew case
    contrib, part, present = ga.grid_fill_rate(wts, v, m, "lerp")
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    for agg in FUNCS:
        got = ga.group_moments(agg, contrib, part, present, offsets)
        want = ga.group_moments_plain(agg, contrib, part, present, offsets)
        checks.exact("group_moments", agg, got[1], want[1])
        checks.values("group_moments", agg, got[0], want[0])
    rng = np.random.default_rng(0)
    scale = np.where(gid % 2 == 0, 1e15, 1.0)[:, None]
    skew_np = scale * (1.0 + rng.normal(0, 1e-3, (S, w)))
    skew = torch.from_numpy(skew_np).to(dev)
    ones = torch.ones((S, w), dtype=torch.bool, device=dev)
    for agg in ("sum", "avg", "dev", "squareSum"):
        got = ga.group_moments(agg, skew, ones, ones, offsets)
        want = ga.group_moments_plain(agg, skew, ones, ones, offsets)
        checks.values("group_moments", "skew 1e15/1.0 " + agg, got[0],
                      want[0])
    small = gid % 2 == 1
    exact_sum = np.zeros((GROUPS, w))
    np.add.at(exact_sum, gid[small], skew_np[small])
    small_groups = torch.from_numpy(np.unique(gid[small]))
    got = ga.group_moments("sum", skew, ones, ones, offsets)[0].cpu()
    checks.values("group_moments", "skew 1.0 groups vs numpy",
                  got[small_groups],
                  torch.from_numpy(exact_sum)[small_groups])
    del skew, ones
    times = {"window_moments": k1}
    times.update(fill_phase(dev, ts, val, h, checks))
    torch.cuda.empty_cache()
    times.update(fold_phase(dev, ts, val, gid, h, checks))
    print_times(times)
    return times


def _k3_times(dev, contrib, part, present, offsets, gid, g) -> dict:
    """K3 `sum` over [S, W] in `g` groups: wall and device time of the
    kernel, the plain version and index_add_ of contrib (its yardstick
    since PR 4), and the byte bound: contrib, participate and present
    read once (10 B a cell), offsets, out and out_mask (9 B a group
    cell)."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    s, w = contrib.shape
    d_gid = torch.from_numpy(gid).to(dev)
    ms, dms = both_ms(lambda: ga.group_moments("sum", contrib, part, present,
                                               offsets))
    lib, lib_dms = both_ms(lambda: torch.zeros(
        (g, w), dtype=torch.float64, device=dev).index_add_(0, d_gid,
                                                            contrib))
    return {
        "ms": ms, "device_ms": dms,
        "plain_ms": time_ms(lambda: ga.group_moments_plain(
            "sum", contrib, part, present, offsets)),
        "bound_ms": bound_ms(s * w * (8 + 1 + 1) + (g + 1) * 8
                             + g * w * (8 + 1), 2.0 * s * w),
        "library_ms": lib, "library_device_ms": lib_dms,
    }


def _k3_checks(checks: Checks, name: str, case: str, contrib, part, present,
               offsets) -> None:
    from opentsdb_tpu_torch.ops import group_agg as ga
    for agg in FUNCS:
        got = ga.group_moments(agg, contrib, part, present, offsets)
        want = ga.group_moments_plain(agg, contrib, part, present, offsets)
        checks.exact(name, "%s %s" % (case, agg), got[1], want[1])
        checks.values(name, "%s %s" % (case, agg), got[0], want[0])


def _host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of `fn` (the mean of n back-to-back calls
    on the host clock; the card, faster than the host here, keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / n * 1e6


def host_split(dev, contrib, part, present, offsets, d_gid) -> None:
    """Where the host's time of a K3 call goes, against index_add_'s: the
    wrapper whole, its checks, its two outputs, kernels.launch, and the C
    entry alone (ctypes and the CUDA launch); torch.zeros and index_add_."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import kernels
    g, w = offsets.numel() - 1, contrib.shape[1]
    out = torch.empty((g, w), dtype=torch.float64, device=dev)
    mask = torch.empty((g, w), dtype=torch.bool, device=dev)
    args = (contrib.data_ptr(), part.data_ptr(), present.data_ptr(),
            offsets.data_ptr(), contrib.shape[0], g, w, 0, out.data_ptr(),
            mask.data_ptr())
    entry = getattr(kernels.library("group_moments"), "group_moments")
    stream = torch.cuda.current_stream(dev).cuda_stream
    into = torch.zeros((g, w), dtype=torch.float64, device=dev)

    def checks():
        ga._check_group_inputs(contrib, part, present, offsets)
        kernels.require_cuda(contrib, part, present, offsets)
    us = {
        "wrapper": _host_us(lambda: ga.group_moments(
            "sum", contrib, part, present, offsets)),
        "checks": _host_us(checks),
        "outputs": _host_us(lambda: (
            torch.empty((g, w), dtype=torch.float64, device=dev),
            torch.empty((g, w), dtype=torch.bool, device=dev))),
        "launch": _host_us(lambda: kernels.launch("group_moments", dev,
                                                  *args)),
        "entry": _host_us(lambda: entry(*args, stream)),
        "zeros": _host_us(lambda: torch.zeros((g, w), dtype=torch.float64,
                                              device=dev)),
        "index_add_": _host_us(lambda: into.index_add_(0, d_gid, contrib)),
    }
    print("host us a call, K3 sum [%d, %d] in %d groups: %s"
          % (contrib.shape[0], w, g,
             "  ".join("%s %.2f" % kv for kv in us.items())))


def _t1_host_split(dev, contrib, part, actual, off, acc, mean,
                   library) -> None:
    """Where the host's time of a centred T1 call goes, against its
    library call's: the wrapper whole, kernels.launch, the C entry alone
    (ctypes and the CUDA launch)."""
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.ops import tiling
    g, w = off.numel() - 1, contrib.shape[1]
    args = (contrib.data_ptr(), part.data_ptr(), actual.data_ptr(),
            off.data_ptr(), mean.data_ptr(), contrib.shape[0], g, w, 3, None,
            None, None, None, None, acc["m2"].data_ptr())
    entry = getattr(kernels.library("tile_partials"), "tile_partials")
    stream = torch.cuda.current_stream(dev).cuda_stream
    us = {
        "wrapper": _host_us(lambda: tiling.tile_partials(
            contrib, part, actual, off, acc, mean=mean)),
        "launch": _host_us(lambda: kernels.launch("tile_partials", dev, *args,
                                                  mode="centred")),
        "entry": _host_us(lambda: entry(*args, stream)),
        "library": _host_us(library),
    }
    print("host us a call, T1 centred [%d, %d] in %d groups: %s"
          % (contrib.shape[0], w, g,
             "  ".join("%s %.2f" % kv for kv in us.items())))


def fold_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    """K3's timed cases, each as a wall (CUDA events around the Python
    call) and a device time (torch.profiler's kernel durations), beside
    index_add_'s two figures: (a) the headline, the [1024, 283] grid in
    100 groups; (b) fan-in, the same grid as one group of 1024 rows (sum
    and dev), every function held to the plain version; (c) the 1m grid
    [1024, 16,931] in 100 groups, the grid of the tiled replay (holes as
    in phase 14, through K1 and K2), every function held to the plain
    version."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import tiling
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    # (a) and (b): K2 over K1's sum:1h-avg grid of the clean batch, as the
    # main path's K3 call takes it
    edges = ds.FixedWindows.for_range(START, END, INTERVAL_MS) \
        .window_edges(dev)
    v, m = ds.window_moments(d_ts, d_val, torch.ones((S, N), dtype=torch.bool,
                                                     device=dev), edges, "avg")
    contrib, part, present = ga.grid_fill_rate(edges[:-1], v, m, "lerp")
    del v, m
    s = contrib.shape[0]
    times = {}
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    times["group_moments"] = _k3_times(dev, contrib, part, present, offsets,
                                       gid, GROUPS)
    host_split(dev, contrib, part, present, offsets,
               torch.from_numpy(gid).to(dev))
    one = np.zeros(s, dtype=np.int64)
    fan = ga.group_offsets(one, 1).to(dev)
    _k3_checks(checks, "group_moments.fanin", "%d rows one group" % s,
               contrib, part, present, fan)
    t = _k3_times(dev, contrib, part, present, fan, one, 1)
    t["dev_ms"], t["dev_device_ms"] = both_ms(lambda: ga.group_moments(
        "dev", contrib, part, present, fan))
    times["group_moments.fanin"] = t

    # (c) the 1m grid: K1 on the headline batch with phase 14's holes
    d_h = torch.from_numpy(h).to(dev)
    cols = torch.arange(N, device=dev)[None, :]
    rix = torch.arange(S, device=dev)[:, None]
    mask = (d_h % 11 != 0) & ((cols // 512) % 13 != rix % 13)
    del d_h, cols, rix
    plan = ds.FixedWindows.for_range(START, END, 60_000)
    edges = plan.window_edges(dev)
    v, m = ds.window_moments(d_ts, d_val, mask, edges, "sum")
    del d_ts, d_val, mask
    c1, p1, a1 = tiling.tile_contrib(PipelineSpec("sum"), edges[:-1], v, m)
    del v, m
    _k3_checks(checks, "group_moments.1m", "[%d, %d] %d groups"
               % (s, plan.count, GROUPS), c1, p1, a1, offsets)
    times["group_moments.1m"] = _k3_times(dev, c1, p1, a1, offsets, gid,
                                          GROUPS)
    for name, t in times.items():
        print("time %-22s kernel wall %.4f ms device %s  library (index_add_)"
              " wall %.4f ms device %s  bound %.4f ms (bytes)%s"
              % (name, t["ms"], _fmt(t["device_ms"]), t["library_ms"],
                 _fmt(t["library_device_ms"]), t["bound_ms"],
                 "  dev wall %.4f ms device %s" % (t["dev_ms"],
                                                   _fmt(t["dev_device_ms"]))
                 if "dev_ms" in t else ""))
    return times


def k2_edge_grid(rng, s: int, w: int, dev, t0: int = START):
    """(wts, v, m) on `dev`: an [S, W] grid as FILL_NONE leaves it (NaN
    where masked) for K2's chunk edges, as tests/torch_parity.py makes
    it: row 0 has no present window, row 1 one, row 2 only windows in its
    last chunk, row 3 gap runs across every chunk edge, row 4 every
    window, row 5 its first and last, row 6 only windows in its first
    chunk; the rest holes at random.  Values step down at times (counter
    resets); one zero-width window step."""
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
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (wts, np.where(mask, v, np.nan), mask))


def fill_cases(dev, ts, val, h) -> dict:
    """K2's timed cases (fill_phase) on `dev`: name -> (wts, v, m,
    policy, rate options)."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops.rate import RateOptions

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    edges = ds.FixedWindows.for_range(START, END, INTERVAL_MS) \
        .window_edges(dev)
    w = edges.numel() - 1
    v, m = ds.window_moments(d_ts, d_val, torch.ones(
        (S, N), dtype=torch.bool, device=dev), edges, "avg")
    hole = (torch.arange(S * w, device=dev).reshape(S, w) * 7919) % 13 == 0
    cases = {
        "grid_fill_rate": (edges[:w], v, m, "lerp", None),
        "grid_fill_rate.holes": (edges[:w], torch.where(hole, torch.nan, v),
                                 m & ~hole, "lerp", None),
        "grid_fill_rate.rate": (edges[:w], v, m, "lerp", RateOptions(
            *RATE_SETS["counter_max_reset"])),
    }
    q_ts, q_val, q_mask, _, _, q_edges = _stacked_args(
        _fleet_members("headline", ts, val, 16), dev)
    qv, qm = ds.window_moments(q_ts, q_val, q_mask, q_edges, "avg")
    cases["grid_fill_rate.stacked"] = (q_edges[:, :-1].contiguous(), qv, qm,
                                       "lerp", None)
    del q_ts, q_val, q_mask
    d_h = torch.from_numpy(h).to(dev)
    cols = torch.arange(N, device=dev)[None, :]
    rix = torch.arange(S, device=dev)[:, None]
    mask = (d_h % 11 != 0) & ((cols // 512) % 13 != rix % 13)
    del d_h, cols, rix
    e1 = ds.FixedWindows.for_range(START, END, 60_000).window_edges(dev)
    v1, m1 = ds.window_moments(d_ts, d_val, mask, e1, "sum")
    del d_ts, d_val, mask
    cases["grid_fill_rate.tile"] = (e1[:-1], v1[:256], m1[:256], "lerp",
                                    None)
    cases["grid_fill_rate.1m"] = (e1[:-1], v1, m1, "lerp", None)
    return cases


def _k2_host_split(dev, wts, v, m) -> None:
    """Where the host's time of a K2 call goes: the wrapper whole, its
    checks, its outputs (one allocation carved in three; three
    torch.empty beside it), kernels.launch, and the C entry alone."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import kernels
    s, w = v.shape
    contrib, part, present = ga.grid_fill_rate(wts, v, m, "lerp")
    args = (v.data_ptr(), m.data_ptr(), wts.data_ptr(), s, w, s, 0, 0, 0,
            0.0, 0.0, 0, contrib.data_ptr(), part.data_ptr(),
            present.data_ptr())
    entry = getattr(kernels.library("grid_fill_rate"), "grid_fill_rate")
    stream = torch.cuda.current_stream(dev).cuda_stream
    split = {"wrapper": lambda: ga.grid_fill_rate(wts, v, m, "lerp")}
    if hasattr(ga, "_fill_outputs"):
        split.update({
            "checks": lambda: (ga._check_fill(wts, v, m, "lerp"),
                               kernels.require_cuda(wts, v, m)),
            "outputs": lambda: ga._fill_outputs(s, w, dev)})
    split.update({
        "three_empty": lambda: (
            torch.empty((s, w), dtype=torch.float64, device=dev),
            torch.empty((s, w), dtype=torch.bool, device=dev),
            torch.empty((s, w), dtype=torch.bool, device=dev)),
        "launch": lambda: kernels.launch("grid_fill_rate", dev, *args),
        "entry": lambda: entry(*args, stream)})
    print("host us a call, K2 lerp [%d, %d]: %s" % (s, w, "  ".join(
        "%s %.2f" % (k, _host_us(fn)) for k, fn in split.items())))


def fill_phase(dev, ts, val, h, checks: Checks,
               digests: str | None = None) -> dict:
    """K2's timed cases, each held to the plain version (masks exact,
    values at rtol 1e-9) and timed as a wall and a device time beside its
    byte bound (19 B a cell and a row of window timestamps a member) and
    the plain version: (a) the headline grid [1024, 283] under lerp as
    K1's sum:1h-avg leaves it (every window present; `grid_fill_rate`)
    and with holes punched in (`.holes`); (b) the same grid under a
    counter rate with counter_max and reset_value (`.rate`); (c) the
    stacked grid of 16 headline panels [160, 60] (`.stacked`); (d) one
    256-row tile of the 1m grid [256, 16,931] with phase 14's holes, the
    tiled replay's call (`.tile`); (e) that whole grid [1024, 16,931]
    (`.1m`).  With `digests`, each case's outputs' sha256 goes to that
    JSON file, or, where the file exists, is held to the digests in it:
    the same inputs through another tree's K2 give the same bits."""
    import hashlib
    from opentsdb_tpu_torch.ops import group_agg as ga

    cases = fill_cases(dev, ts, val, h)
    times, sums = {}, {}
    for name, (wts, gv, gm, policy, opts) in cases.items():
        got = ga.grid_fill_rate(wts, gv, gm, policy, opts)
        want = ga.grid_fill_rate_plain(wts, gv, gm, policy, opts)
        rows, cols = gv.shape
        case = "[%d, %d] %s rate=%s" % (rows, cols, policy, opts is not None)
        checks.exact(name, case, got[1], want[1])
        checks.exact(name, case, got[2], want[2])
        checks.values(name, case, got[0], want[0])
        sums[name] = hashlib.sha256(b"".join(
            x.cpu().numpy().tobytes() for x in got)).hexdigest()
        del got, want
        ms, dms = both_ms(lambda: ga.grid_fill_rate(wts, gv, gm, policy,
                                                    opts))
        members = wts.shape[0] if wts.dim() == 2 else 1
        times[name] = {
            "ms": ms, "device_ms": dms,
            "plain_ms": time_ms(lambda: ga.grid_fill_rate_plain(
                wts, gv, gm, policy, opts)),
            # v, m read and contrib, participate, present written once (19
            # B a cell), each member's window timestamps read once
            "bound_ms": bound_ms(rows * cols * 19 + members * cols * 8,
                                 4.0 * rows * cols),
            "library_ms": None}
        print("time %-22s %-28s kernel wall %.4f ms device %s  plain %.4f "
              "ms  bound %.4f ms (bytes)" % (name, case, ms, _fmt(dms),
                                             times[name]["plain_ms"],
                                             times[name]["bound_ms"]))
    # (64 rows: a kernel of a few us, so that the host sets the pace)
    wts, gv, gm = cases["grid_fill_rate"][:3]
    _k2_host_split(dev, wts, gv[:64], gm[:64])
    hold_digests(checks, "k2", sums, digests)
    return times


def fleet_tsdb(dev):
    """The latency fleet `h` (phase 8's series, tags and counts) in a
    TSDB of its own through load_state, for phase 7 without the daemon."""
    from opentsdb_tpu_torch.core import load_state
    from opentsdb_tpu_torch.utils.config import Config
    counts = histogram_fleet()
    tags = [_h_tags(s) for s in range(H_SERIES)]
    tagv = sorted({v for t in tags for v in t.values()})
    uids = {"metric": {"h": 1}, "tagk": {"group": 1, "host": 2},
            "tagv": {v: i + 1 for i, v in enumerate(tagv)}}
    bounds = np.array(list(zip(H_EDGES, H_EDGES[1:])), dtype=np.float64)
    ts = (H_START_S + np.arange(H_POINTS, dtype=np.int64) * H_STEP_S) * 1000
    hist = [(1, {1: uids["tagv"][t["group"]], 2: uids["tagv"][t["host"]]},
             ts, [(bounds, counts[s, i], 0, 0) for i in range(H_POINTS)])
            for s, t in enumerate(tags)]
    return load_state(uids, [], config=Config(
        {"tsd.core.histograms.config": HIST_CONFIG}), device=dev,
        histograms=hist)


def order_kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    """K4 window_order and K5 group_order on the headline batch, each
    against its plain version."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    d_h = torch.from_numpy(h).to(dev)
    c_mask = d_mask & (d_h % 97 != 0)
    c_val = torch.where(d_h % 211 == 0, torch.nan, d_val)
    del d_h
    edges = ds.FixedWindows.for_range(START, END, INTERVAL_MS) \
        .window_edges(dev)
    everything = ds.AllWindow(START, END).window_edges(dev)
    w = edges.numel() - 1
    cases = [("fixed", edges, f, "none") for f in ORDER_DS]
    cases += [("fixed", edges, f, fill) for f in ("p99", "first")
              for fill in FILLS if fill != "none"]
    # 65,536-point runs: the selection reads device memory, no staging
    cases += [("all", everything, f, "none") for f in ("p99", "median")]
    for kind, e, func, fill in cases:
        got = ds.window_order(d_ts, c_val, c_mask, e, func, fill, -1.5)
        want = ds.window_order_plain(d_ts, c_val, c_mask, e, func, fill,
                                     -1.5)
        case = "%s %s fill=%s" % (kind, func, fill)
        checks.exact("window_order", case, got[1], want[1])
        checks.values("window_order", case, got[0], want[0])
    del c_val, c_mask

    # K4's library yardstick: torch.segment_reduce "prod" over the same
    # window runs (lengths from the plain edge search, outside the timed
    # call; every point lies inside the windows)
    pos = torch.searchsorted(d_ts, edges.expand(S, -1).contiguous())
    lengths = (pos[:, 1:] - pos[:, :-1]).reshape(-1)
    flat = d_val.reshape(-1)
    del pos
    k4_bytes = (S * N * (8 + 1) + S * (w + 1) * 8 + (w + 1) * 8
                + S * w * (8 + 1))
    k4 = {
        **kernel_ms(lambda: ds.window_order(d_ts, d_val, d_mask, edges,
                                            "mult")),
        "plain_ms": time_ms(lambda: ds.window_order_plain(
            d_ts, d_val, d_mask, edges, "mult")),
        "bound_ms": bound_ms(k4_bytes, 1.0 * S * N),
        "library_ms": time_ms(lambda: torch.segment_reduce(
            flat, "prod", lengths=lengths)),
    }
    del flat
    mult_class_phase(dev, ts, val, h, d_ts, d_mask, edges, lengths, checks)
    del lengths
    extra = {f: time_ms(lambda f=f: ds.window_order(d_ts, d_val, d_mask,
                                                    edges, f))
             for f in ("first", "median", "p95", "ep99r7")}
    extra["0all p99"] = time_ms(lambda: ds.window_order(
        d_ts, d_val, d_mask, everything, "p99"))
    print("time window_order by function: %s ms"
          % ", ".join("%s %.4f" % kv for kv in extra.items()))

    v, m = ds.window_moments(d_ts, d_val, d_mask, edges, "avg")
    wts = edges[:w]
    del d_ts, d_val, d_mask

    # K5 over the main path's contributions: 100 groups, then all 1024
    # rows as one group
    contrib, part, present = ga.grid_fill_rate(wts, v, m, "lerp")
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    one = torch.tensor([0, S], dtype=torch.int64, device=dev)
    for agg in ORDER_AGGS:
        got = ga.group_order(agg, contrib, part, present, offsets)
        want = ga.group_order_plain(agg, contrib, part, present, offsets)
        checks.exact("group_order", agg, got[1], want[1])
        checks.values("group_order", agg, got[0], want[0])
    for agg in ("median", "ep99r7"):
        got = ga.group_order(agg, contrib, part, present, one)
        want = ga.group_order_plain(agg, contrib, part, present, one)
        checks.exact("group_order", "1024 rows one group " + agg, got[1],
                     want[1])
        checks.values("group_order", "1024 rows one group " + agg, got[0],
                      want[0])
    # the library call: nanquantile is R-7 over the non-NaN cells K2
    # leaves, which are exactly the participating ones here
    lib = torch.nanquantile(contrib, 0.99, dim=0)
    checks.values("group_order", "1024 rows ep99r7 vs nanquantile",
                  ga.group_order("ep99r7", contrib, part, present, one)[0][0],
                  lib)
    k5 = {
        **kernel_ms(lambda: ga.group_order("ep99r7", contrib, part,
                                           present, one)),
        "plain_ms": time_ms(lambda: ga.group_order_plain(
            "ep99r7", contrib, part, present, one)),
        "bound_ms": _k5_bound(contrib, one),
    }
    k5["library_ms"], k5["library_device_ms"] = both_ms(
        lambda: torch.nanquantile(contrib, 0.99, dim=0))
    # the main path's shape: p99 over the 100 groups (case (a))
    k5_grouped = {
        **kernel_ms(lambda: ga.group_order("p99", contrib, part, present,
                                           offsets)),
        "plain_ms": time_ms(lambda: ga.group_order_plain(
            "p99", contrib, part, present, offsets)),
        "bound_ms": _k5_bound(contrib, offsets),
        "library_ms": None,
    }
    print("time group_order mult (the shared ordered product) over %d "
          "groups %.4f ms, 1024 rows one group %.4f ms"
          % (GROUPS, time_ms(lambda: ga.group_order("mult", contrib, part,
                                                    present, offsets)),
             time_ms(lambda: ga.group_order("mult", contrib, part, present,
                                            one))))

    times = {"window_order": k4, "group_order": k5,
             "group_order.grouped": k5_grouped}
    print_times(times)
    return times


def k5_inputs(dev, ts, val, gid) -> dict:
    """K5's operands at the shapes the main path launches it at: name ->
    (contrib, participate, present, offsets, label).  (a) the headline
    grid [1024, 283] in its 100 groups (`p99:1h-avg:m{group=*}`); (b) one
    stacked dispatch of the fleet's 16 `p99:1m-p95` order panels, [160,
    60] in 16 groups of 10; (c) one such panel alone, [10, 60] in one
    group; (d) the headline grid as one group of 1024 rows (a downsampled
    order function with no group-by); (e) one group of 40,000 rows x 2
    windows, past the kernel's staging room (exactness only)."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import pipeline as pl

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    edges = ds.FixedWindows.for_range(START, END, INTERVAL_MS) \
        .window_edges(dev)
    w = edges.numel() - 1
    v, m = ds.window_moments(d_ts, d_val, d_mask, edges, "avg")
    del d_ts, d_val, d_mask
    grid = ga.grid_fill_rate(edges[:w], v, m, "lerp")
    cases = {
        "(a)": (*grid, ga.group_offsets(gid, GROUPS).to(dev),
                "[%d x %d] %d groups" % (S, w, GROUPS)),
        "(d)": (*grid, torch.tensor([0, S], dtype=torch.int64, device=dev),
                "[%d x %d] one group" % (S, w)),
    }
    members = _fleet_members("headline", ts, val, 16)
    for name, chosen in (("(b)", members), ("(c)", members[:1])):
        d_ts, d_val, d_mask, m_gid, groups, d_edges = _stacked_args(chosen,
                                                                    dev)
        ov, om = ds.window_order(d_ts, d_val, d_mask, d_edges, "p95")
        c = ga.grid_fill_rate(d_edges[:, :-1].contiguous(), ov, om, "lerp")
        offsets = pl.stacked_offsets(m_gid, groups).to(dev)
        cases[name] = (*c, offsets, "[%d x %d] %d group%s" % (
            c[0].shape[0], c[0].shape[1], len(chosen),
            "s" if len(chosen) > 1 else ""))
    rng = np.random.default_rng(22)
    contrib = np.round(rng.normal(0, 50, (40_000, 2)), 1)
    part = torch.from_numpy(rng.random((40_000, 2)) < 0.9).to(dev)
    cases["(e)"] = (torch.from_numpy(contrib).to(dev), part, part,
                    torch.tensor([0, 40_000], dtype=torch.int64, device=dev),
                    "[40000 x 2] one group")
    return cases


def _k5_bound(contrib, offsets) -> float:
    s, w = contrib.shape
    g = offsets.numel() - 1
    return bound_ms(s * w * (8 + 1 + 1) + (g + 1) * 8 + g * w * (8 + 1), 0.0)


# K5's timed functions at each case: the main path's p99 (and first and
# mult beside it on the headline groups), ep99r7 and mult on one group
K5_TIMED = {"(a)": ("p99", "first", "mult"), "(b)": ("p99",),
            "(c)": ("p99",), "(d)": ("ep99r7", "mult"), "(e)": ()}


def k5_phase(dev, ts, val, gid, checks: Checks,
             digests: dict | None = None) -> dict:
    """K5 at cases (a)-(e) (k5_inputs): every order and rank aggregator
    against the plain version ((e): the rank functions, first and mult;
    mult against the plain version on the CPU), outputs' sha256 into
    `digests`; each timed function's wall and device time beside its byte
    bound and the plain version's time, and at (d)
    torch.nanquantile's (R-7 over the non-NaN cells, exactly the
    participating ones there).  Returns the timed rows by name."""
    from opentsdb_tpu_torch.ops import group_agg as ga

    rows = {}
    for case, (contrib, part, present, offsets, label) in k5_inputs(
            dev, ts, val, gid).items():
        aggs = ORDER_AGGS if case != "(e)" else (
            "median", "ep99r7", "p50", "ep50r3", "first", "mult")
        for agg in aggs:
            got = ga.group_order(agg, contrib, part, present, offsets)
            # torch's product scatter on the card multiplies in no fixed
            # order (an overflow and a zero in one run make NaN or 0 by
            # their order): mult is held to the plain version on the CPU
            args = (contrib, part, present, offsets)
            want = ga.group_order_plain(agg, *(
                x.cpu() for x in args) if agg == "mult" else args)
            name = "%s %s %s" % (case, label, agg)
            checks.exact("group_order", name, got[1], want[1])
            checks.values("group_order", name, got[0], want[0])
            if digests is not None:
                digests["group_order %s %s" % (case, agg)] = _digest(
                    torch.cat([got[0].view(torch.uint8).reshape(-1),
                               got[1].view(torch.uint8).reshape(-1)]))
        if case == "(e)":
            med = ga.group_order("median", contrib, part, present,
                                 offsets)[0][0].cpu()
            for col in range(2):
                vals = torch.sort(contrib[:, col][part[:, col]]).values
                checks.exact("group_order", "(e) median column %d" % col,
                             med[col], vals[vals.numel() // 2])
        bound = _k5_bound(contrib, offsets)
        for agg in K5_TIMED[case]:
            wall, device = both_ms(lambda agg=agg: ga.group_order(
                agg, contrib, part, present, offsets))
            row = {"ms": wall, "device_ms": device, "bound_ms": bound,
                   "plain_ms": time_ms(lambda agg=agg: ga.group_order_plain(
                       agg, contrib, part, present, offsets)),
                   "library_ms": None}
            if case == "(d)" and agg == "ep99r7":
                checks.values("group_order", "(d) ep99r7 vs nanquantile",
                              ga.group_order(agg, contrib, part, present,
                                             offsets)[0][0],
                              torch.nanquantile(contrib, 0.99, dim=0))
                row["library_ms"], row["library_device_ms"] = both_ms(
                    lambda: torch.nanquantile(contrib, 0.99, dim=0))
            rows["group_order %s %s %s" % (case, label, agg)] = row
    print_times(rows)
    return rows


def r_inputs(dev, ts, val, h) -> dict:
    """R's operands at the shapes the main path launches it at: name ->
    (ts, val, mask, label, the timed rate set).  (a) the headline batch
    [1024, 65,536] float64; (b) its last 6 h, [1024, ~1,394] (what
    `sum:rate:m{group=*}` and `diff:rate:m{group=*}` read on the union
    path); (c) the integer counters `mi` over the last 6 h, [64, ~1,394]
    (`sum:rate{counter}:mi{group=*}`)."""
    start = END - SIX_HOURS_MS
    cases = {"(a)": tuple(torch.from_numpy(x).to(dev) for x in (
        ts, val, np.ones((S, N), bool))) + ("[%d x %d] float" % (S, N),
                                            "rate")}
    b = _last_hours(ts, val, start)
    cases["(b)"] = tuple(torch.from_numpy(x).to(dev) for x in b) + (
        "[%d x %d] float, last 6 h" % b[0].shape, "rate")
    ival = np.cumsum(h[:INT_ROWS] % 1_000, axis=1) + 2**53
    c = _last_hours(ts[:INT_ROWS], ival, start)
    cases["(c)"] = tuple(torch.from_numpy(x).to(dev) for x in c) + (
        "[%d x %d] int64, last 6 h" % c[0].shape, "counter")
    return cases


def r_phase(dev, ts, val, h, checks: Checks,
            digests: dict | None = None) -> dict:
    """R at cases (a)-(c) (r_inputs) under every rate option set against
    the plain version, outputs' sha256 into `digests`; each case's timed
    set's wall and device time beside its byte bound (17 bytes in and 17
    out a point) and the plain version's time.  Returns the timed rows by
    name."""
    from opentsdb_tpu_torch.ops import rate as rt

    rows = {}
    for case, (d_ts, d_val, d_mask, label, timed) in r_inputs(
            dev, ts, val, h).items():
        for rname, rargs in RATE_SETS.items():
            if rargs is None:
                continue
            opts = rt.RateOptions(*rargs)
            got = rt.point_rate(d_ts, d_val, d_mask, opts)
            want = rt.point_rate_plain(d_ts, d_val, d_mask, opts)
            name = "%s %s rate=%s" % (case, label, rname)
            checks.exact("point_rate", name, got[0], want[0], "timestamps")
            checks.exact("point_rate", name, got[2], want[2])
            checks.values("point_rate", name, got[1], want[1])
            if digests is not None:
                digests["point_rate %s %s" % (case, rname)] = _digest(
                    torch.cat([x.view(torch.uint8).reshape(-1)
                               for x in got]))
        opts = rt.RateOptions(*RATE_SETS[timed])
        wall, device = both_ms(lambda: rt.point_rate(d_ts, d_val, d_mask,
                                                     opts))
        rows["point_rate %s %s %s" % (case, label, timed)] = {
            "ms": wall, "device_ms": device,
            "bound_ms": bound_ms(d_ts.numel() * 17 * 2, 0.0),
            "plain_ms": time_ms(lambda: rt.point_rate_plain(
                d_ts, d_val, d_mask, opts)),
            "library_ms": None}
        del d_ts, d_val, d_mask
        torch.cuda.empty_cache()
    print_times(rows)
    return rows


def order_only(dev, ts, val, gid, h, checks: Checks,
               k5_file: str | None, r_file: str | None) -> None:
    """`--order-only`: K5's cases (a)-(e) and R's (a)-(c) alone, each
    against its plain version; with `k5_file` (`r_file`) their outputs'
    sha256 are written there, or held to the ones it holds (K5's mult
    reported, not failed: a shallow group's product is the ordered walk
    itself, a tree before it combined it in another order)."""
    k5 = {} if k5_file else None
    r = {} if r_file else None
    t_start = time.perf_counter()
    k5_phase(dev, ts, val, gid, checks, k5)
    torch.cuda.empty_cache()
    r_phase(dev, ts, val, h, checks, r)
    torch.cuda.empty_cache()
    print("order-only wall %.1f s" % (time.perf_counter() - t_start))
    hold_digests(checks, "k5", k5, k5_file, reported=(" mult",))
    hold_digests(checks, "r", r, r_file)


def _gather_cases(ts, gid) -> dict:
    """Phase 3's gathers over the headline batch packed as one buffer:
    name -> (starts[R], lengths[R])."""
    row0 = np.arange(S, dtype=np.int64) * N
    day0 = START + 5 * 86_400_000
    sub = np.random.default_rng(4).permutation(np.flatnonzero(gid < 4))
    lo6 = np.array([np.searchsorted(ts[i], END - SIX_HOURS_MS) for i in
                    range(S)], np.int64)
    lo_d = np.array([np.searchsorted(ts[i], day0) for i in sub], np.int64)
    hi_d = np.array([np.searchsorted(ts[i], day0 + 86_400_000, "right")
                     for i in sub], np.int64)
    return {
        "(a) full range": (row0, np.full(S, N, np.int64)),
        "(b) last 6h": (row0 + lo6, N - lo6),
        "(c) groups 0-3 shuffled, 1 day": (row0[sub] + lo_d, hi_d - lo_d),
    }


def gather_phase(dev, ts, val, gid, checks: Checks) -> dict:
    """G1 gather_windows against its plain version on the headline
    batch's columns packed as the device cache packs a metric: (a) every
    row's full range, (b) the last 6 h, (c) the rows of groups 0-3 in a
    shuffled order over one day."""
    from opentsdb_tpu_torch.storage import device_cache as dc

    ts_buf = torch.from_numpy(ts.reshape(-1)).to(dev)
    val_buf = torch.from_numpy(val.reshape(-1)).to(dev)
    row0 = np.arange(S, dtype=np.int64) * N
    cases = _gather_cases(ts, gid)
    times = {}
    for name, (starts, lengths) in cases.items():
        n = int(lengths.max())
        d_st = torch.from_numpy(starts).to(dev)
        d_len = torch.from_numpy(lengths).to(dev)
        got = dc.gather_windows(ts_buf, val_buf, d_st, d_len, n)
        want = dc.gather_windows_plain(ts_buf, val_buf, d_st, d_len, n)
        for what, a, b in zip(("timestamps", "values", "masks"), got, want):
            checks.exact("gather_windows", name, a, b, what)
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        print("%-15s %-44s %d rows x %d, %d points exact %s"
              % ("gather_windows", name, len(starts), n, int(lengths.sum()),
                 "ok" if ok else "FAIL"))
        del got, want
        points = int(lengths.sum())
        times[name] = {
            **kernel_ms(lambda: dc.gather_windows(ts_buf, val_buf, d_st,
                                                  d_len, n)),
            "plain_ms": time_ms(lambda: dc.gather_windows_plain(
                ts_buf, val_buf, d_st, d_len, n), 3),
            # each requested point read once from both buffers, each
            # [S, N] slot written once (ts, val, mask), starts and lengths
            "bound_ms": bound_ms(points * 16 + len(starts) * n * 17
                                 + len(starts) * 16, 0.0),
            "library_ms": None,
        }
    # (a) is the headline batch itself
    full = dc.gather_windows(ts_buf, val_buf, torch.from_numpy(row0).to(dev),
                             torch.full((S,), N, dtype=torch.int64,
                                        device=dev), N)
    checks.exact("gather_windows", "(a) against the batch", full[0].cpu(),
                 torch.from_numpy(ts), "timestamps")
    checks.exact("gather_windows", "(a) against the batch", full[1].cpu(),
                 torch.from_numpy(val), "values")
    del full
    for name, t in times.items():
        print("time gather_windows %-32s kernel %.4f ms  plain %.4f ms  "
              "bound %.4f ms (bytes)" % (name, t["ms"], t["plain_ms"],
                                         t["bound_ms"]))
    # no single torch call gathers runs into a padded, masked batch
    return {"gather_windows": times["(a) full range"]}


def print_times(times: dict) -> None:
    for name, t in times.items():
        print("time %-15s kernel %.4f ms (device %s)  plain %.4f ms  bound "
              "%.4f ms (%s)%s  library %s"
              % (name, t["ms"], _fmt(t.get("device_ms")), t["plain_ms"],
                 t["bound_ms"], t.get("bound_by", "bytes"),
                 "  chain bound %s" % _fmt(t["chain_bound_ms"])
                 if "chain_bound_ms" in t else "",
                 "none" if t["library_ms"] is None else "%.4f ms%s" % (
                     t["library_ms"], " (device %s)" % _fmt(
                         t["library_device_ms"])
                     if "library_device_ms" in t else "")))


def _query(m: str, start: int = START, end: int = END):
    from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
    q = TSQuery(start=str(start), end=str(end), queries=[parse_m_subquery(m)])
    q.validate()
    return q


def _cpu_copy(tsdb):
    """The TSDB's whole state on the CPU (load_state, the device cache
    off: the oracle is the host path), every series in the card's order:
    first, last, diff and none take a group's members in the order its
    metric's series come out of the store, so a copy of only the filtered
    groups could order them otherwise."""
    from opentsdb_tpu_torch.core import load_state
    from opentsdb_tpu_torch.utils.config import Config
    uid_maps = {kind: tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in tsdb.store.all_series()]
    return load_state(uid_maps, series, config=Config(
        {"tsd.query.device_cache.enable": False, **AGG_OFF, **MATERIALIZE}),
        device="cpu")


def cold_split(tsdb, metric: int, dev) -> None:
    """The device cache's inline build (_build_guarded) step by step on
    the host clock: each series' columns uploaded inside its snapshot's
    lock hold, then one device-side concatenation.  Beside it, on the same
    store, the host route (numpy snapshots, a host concatenation, one
    pageable upload of the packed buffers)."""
    series = tsdb.store.series_for_metric(metric)
    fix = tsdb.config.fix_duplicates

    def upload(column):
        return torch.from_numpy(column).to(dev, copy=True)

    t0 = time.perf_counter()
    parts = [s.snapshot(fix, upload) for s in series]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    packed = (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    nbytes = sum(x.nbytes for x in packed)
    del parts, packed
    print("e2e cold split (the build): %d snapshot uploads %.1f ms, device "
          "concatenation %.1f ms, %.3f GB"
          % (len(series), (t1 - t0) * 1e3, (t2 - t1) * 1e3, nbytes / 1e9))
    t0 = time.perf_counter()
    parts = [s.snapshot(fix) for s in series]
    t1 = time.perf_counter()
    ts_buf = np.concatenate([p[0] for p in parts])
    val_buf = np.concatenate([p[1] for p in parts])
    t2 = time.perf_counter()
    del parts
    up = (torch.from_numpy(ts_buf).to(dev), torch.from_numpy(val_buf).to(dev))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print("e2e cold split (the host route): snapshots %.1f ms, "
          "concatenation %.1f ms, upload %.1f ms"
          % ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    del up, ts_buf, val_buf


def ingest_arm(tsdb, m: str, median_wall: dict, checks: Checks) -> None:
    """Writes at the store's cadence, a point a series every STEP_MS,
    interleaved with a dashboard's grouped query `m` run back to back,
    while the maintenance thread (TSDB.start_maintenance) rebuilds the
    device cache's stale entry.  Two arms of one period each: "spread",
    the series' points one at a time across the period, as independent
    hosts' collectors send them; "aligned", every series' point at once
    at the start of each period, as a relay flushing a fleet's points
    each interval sends them.  Each arm prints its queries, the share
    that hit, the hit and miss walls beside the miss arm's, and the
    rebuilds.  Then, the writes over, a hit must equal a miss on the same
    TSDB, and the count query must count every point written."""
    import threading

    periods = 1
    cache = tsdb.device_cache
    # past every point this phase writes: period k of arm a writes at
    # END + (a * periods + k) * STEP_MS + a slot of its own
    end = END + (2 * periods + 1) * STEP_MS
    tags = [{"host": "h%04d" % i, "group": "g%03d" % (i * GROUPS // S)}
            for i in range(S)]
    written = [0]
    tsdb.start_maintenance()
    try:
        for a, arm in enumerate(("spread", "aligned")):
            done = threading.Event()
            errors = []

            def writer():
                try:
                    t_start = time.perf_counter()
                    for k in range(periods):
                        for i in range(S):
                            slot = k * S + i if arm == "spread" else k * S
                            delay = (t_start + slot * STEP_MS / 1e3 / S
                                     - time.perf_counter())
                            if delay > 0:
                                time.sleep(delay)
                            tsdb.add_point(
                                "m", END + (a * periods + k) * STEP_MS
                                + i * (STEP_MS // S),
                                100.0 + (i * 7 + k) % 1_000 * 0.05, tags[i])
                            written[0] += 1
                    delay = t_start + periods * STEP_MS / 1e3 \
                        - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                except Exception as e:      # reported in the main thread
                    errors.append(e)
                finally:
                    done.set()

            builds0, hits0, misses0 = cache.builds, cache.hits, cache.misses
            walls = {True: [], False: []}
            th = threading.Thread(target=writer)
            t_arm = time.perf_counter()
            th.start()
            while not done.is_set():
                runner = tsdb.new_query_runner()
                t0 = time.perf_counter()
                runner.run(_query(m, end=end))
                walls[runner.exec_stats.get("deviceCacheHit") == 1.0].append(
                    (time.perf_counter() - t0) * 1e3)
            th.join()
            span = time.perf_counter() - t_arm
            if errors:
                checks.failures.append("ingest %s: %r" % (arm, errors[0]))
            n = len(walls[True]) + len(walls[False])
            print("e2e ingest %-7s %d writes in %.1f s (a point a series "
                  "each %.1f s), %d queries: %d hits, share %.3f (of the "
                  "arm's time in hits %.3f) | hit wall %s ms, miss wall %s "
                  "ms (the miss arm's %.1f ms) | rebuilds %d; cache hits "
                  "%d misses %d"
                  % (arm, periods * S, span, STEP_MS / 1e3, n,
                     len(walls[True]), len(walls[True]) / max(n, 1),
                     sum(walls[True]) / 1e3 / span,
                     "%.1f" % statistics.median(walls[True])
                     if walls[True] else "none",
                     "%.1f" % statistics.median(walls[False])
                     if walls[False] else "none",
                     median_wall["miss", m], cache.builds - builds0,
                     cache.hits - hits0, cache.misses - misses0))
        # the writes over, the thread's next rebuild makes the query hit
        deadline = time.perf_counter() + 30.0
        hit = None
        while time.perf_counter() < deadline:
            runner = tsdb.new_query_runner()
            res = runner.run(_query(m, end=end))
            if runner.exec_stats.get("deviceCacheHit") == 1.0:
                hit = res
                break
            time.sleep(0.5)
        count_q = m.replace(":1h-avg:", ":1h-count:")
        runner = tsdb.new_query_runner()
        counted = sum(v for r in runner.run(_query(count_q, end=end))
                      for _, v in r.dps)
        count_hit = runner.exec_stats.get("deviceCacheHit")
        refreshes = tsdb.maintenance.device_cache_refreshes
    finally:
        tsdb.shutdown()
    tsdb.device_cache = None
    miss = tsdb.new_query_runner().run(_query(m, end=end))
    tsdb.device_cache = cache
    same = hit is not None and [(r.tags, r.dps) for r in hit] \
        == [(r.tags, r.dps) for r in miss]
    want = S * N + 1 + written[0]
    print("e2e ingest after the writes: the query %s, answer %s the miss's; "
          "count %s total %d (written %d); maintenance rebuilt %d entries"
          % ("hit" if hit is not None else "NEVER HIT",
             "the same as" if same else "DIFFERENT from",
             "hit" if count_hit == 1.0 else "missed", counted, want,
             refreshes))
    if not same or counted != want or written[0] != 2 * periods * S:
        checks.failures.append("ingest arm: no hit after the writes, a hit "
                               "that differs from a miss, or a lost write")


def headline_tsdb(dev, ts, val):
    """A TSDB on `dev` holding the headline batch as metric `m` (`host`
    and `group` tags), the threshold raised and the aggregate cache off;
    returns (tsdb, the metric's UID)."""
    from opentsdb_tpu_torch.core import TSDB
    from opentsdb_tpu_torch.storage.memstore import SeriesKey
    from opentsdb_tpu_torch.utils.config import Config

    tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True,
                        "tsd.core.histograms.config": HIST_CONFIG,
                        **AGG_OFF, **MATERIALIZE}),
                device=dev)
    metric = tsdb.metrics.get_or_create_id("m")
    k_host = tsdb.tag_names.get_or_create_id("host")
    k_group = tsdb.tag_names.get_or_create_id("group")
    for i in range(S):
        key = SeriesKey.make(metric, {
            k_host: tsdb.tag_values.get_or_create_id("h%04d" % i),
            k_group: tsdb.tag_values.get_or_create_id(
                "g%03d" % (i * GROUPS // S))})
        tsdb.store.add_batch(key, ts[i], val[i], False)
    return tsdb, metric


def e2e_phase(dev, ts, val, checks: Checks):
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.query.planner import PHASES
    from opentsdb_tpu_torch.storage.memstore import SeriesKey

    t0 = time.perf_counter()
    tsdb, metric = headline_tsdb(dev, ts, val)
    ingest_s = time.perf_counter() - t0
    k_host = tsdb.tag_names.get_id("host")
    k_group = tsdb.tag_names.get_id("group")
    points = tsdb.store.total_datapoints
    print("e2e ingest %.3f s, %d series, %d points" % (ingest_s, S, points))
    if points != S * N:
        checks.failures.append("ingest stored %d points" % points)

    queries = ["sum:1h-avg:m{group=*}", "sum:1h-count:m{group=*}",
               "sum:1h-max:rate:m{group=*}", "p99:1h-avg:m{group=*}",
               "sum:1h-p95:m{group=*}", "last:1h-first:m{group=*}",
               "movingAverage5:1h-sum:m{group=*}"]
    subset = "{group=g000|g001|g002|g003}"
    cache = tsdb.device_cache
    kernels.reset_launches()

    # cold: the first query builds the device cache's entry inline
    # (snapshot of every series of m, then one upload) and gathers from it
    runner = tsdb.new_query_runner()
    t0 = time.perf_counter()
    runner.run(_query(queries[0]))
    cold = (time.perf_counter() - t0) * 1e3
    st = runner.exec_stats
    print("e2e cold %-30s wall %.1f ms | build %.1f gather %.1f (inline "
          "entry build + gather) h2d %.1f kernels %.1f extract %.1f ms | "
          "deviceCacheHit %s | builds %d, entry %.3f GB on the card"
          % (queries[0], cold, st["buildMs"], st["gatherMs"], st["h2dMs"],
             st["kernelsMs"], st["extractMs"], st.get("deviceCacheHit"),
             cache.builds, cache.bytes_used / 1e9))
    if cache.builds != 1 or st.get("deviceCacheHit") != 1.0:
        checks.failures.append("the cold query did not build and hit")
    cold_split(tsdb, metric, dev)

    def timed(m, arm):
        runner = tsdb.new_query_runner()
        runner.run(_query(m))                    # warm-up
        walls, splits = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            res = runner.run(_query(m))
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(runner.exec_stats))
        wall = statistics.median(walls)
        split = {p: statistics.median(s[p + "Ms"] for s in splits)
                 for p in PHASES}
        hit = [s.get("deviceCacheHit", 0.0) for s in splits]
        print("e2e %-4s %-30s wall %.1f ms (median of 5) | build %.1f h2d "
              "%.1f gather %.1f kernels %.1f extract %.1f ms | kernel share "
              "%.4f | %.3e points/s | deviceCacheHit %s | %d results"
              % (arm, m, wall, split["build"], split["h2d"], split["gather"],
                 split["kernels"], split["extract"], split["kernels"] / wall,
                 points / (wall / 1e3), min(hit), len(res)))
        if min(hit) != (1.0 if arm == "hit" else 0.0):
            checks.failures.append("%s: expected a cache %s" % (m, arm))
        median_wall[arm, m] = wall
        return res

    median_wall = {}
    answers, filtered = {}, {}
    for m in queries:
        answers[m] = timed(m, "hit")
        filtered[m] = tsdb.new_query_runner().run(
            _query(m.replace("{group=*}", subset)))
    # the same queries with the cache detached from the same TSDB (the
    # host holds one copy of the store): the host batch build and copy
    tsdb.device_cache = None
    misses = {m: timed(m, "miss") for m in queries}
    tsdb.device_cache = cache
    for m in queries:
        if [(r.tags, r.dps) for r in misses[m]] \
                != [(r.tags, r.dps) for r in answers[m]]:
            checks.failures.append("%s: hit and miss answers differ" % m)

    for m, res in answers.items():
        if len(res) != GROUPS:
            checks.failures.append("%s: %d results" % (m, len(res)))
        vals = np.array([v for r in res for _, v in r.dps], np.float64)
        if vals.size == 0 or not np.isfinite(vals).all():
            checks.failures.append("%s: empty or non-finite values" % m)
    total = sum(v for r in answers["sum:1h-count:m{group=*}"]
                for _, v in r.dps)
    print("e2e count total %d (written %d)" % (total, S * N))
    if total != S * N:
        checks.failures.append("count query totals %d, not %d"
                               % (total, S * N))

    # the same state on the CPU, through load_state, on the filtered query
    cpu = _cpu_copy(tsdb)

    def same_as_cpu(fm, got, note=""):
        want = cpu.new_query_runner().run(_query(fm))
        same = [(a.tags, [t for t, _ in a.dps]) for a in got] \
            == [(b.tags, [t for t, _ in b.dps]) for b in want]
        if not same:
            checks.failures.append("%s%s: card and CPU differ in groups or "
                                   "timestamps" % (fm, note))
            return
        checks.values("e2e", fm + note,
                      torch.tensor([v for a in got for _, v in a.dps]),
                      torch.tensor([v for b in want for _, v in b.dps]))

    for m in queries:
        same_as_cpu(m.replace("{group=*}", subset), filtered[m])

    # staleness: one point appended to one series of group g000, on the
    # card's TSDB and the CPU copy alike
    fm = queries[0].replace("{group=*}", subset)
    key = SeriesKey.make(metric, {
        k_host: tsdb.tag_values.get_id("h0000"),
        k_group: tsdb.tag_values.get_id("g000")})
    for t in (tsdb, cpu):
        t.store.add_batch(key, np.array([END - 1], np.int64),
                          np.array([1e6]), False)
    runner = tsdb.new_query_runner()
    stale = runner.run(_query(fm))
    stale_hit = runner.exec_stats.get("deviceCacheHit")
    same_as_cpu(fm, stale, " after an append")
    rebuilt = cache.refresh()
    runner = tsdb.new_query_runner()
    fresh = runner.run(_query(fm))
    fresh_hit = runner.exec_stats.get("deviceCacheHit")
    print("e2e staleness: after an append the query %s; refresh() rebuilt "
          "%d; the query after it %s, answer %s"
          % ("missed" if stale_hit is None else "HIT", rebuilt,
             "hit" if fresh_hit == 1.0 else "MISSED",
             "the same" if [(r.tags, r.dps) for r in fresh]
             == [(r.tags, r.dps) for r in stale] else "DIFFERENT"))
    if stale_hit is not None or rebuilt != 1 or fresh_hit != 1.0 \
            or [(r.tags, r.dps) for r in fresh] \
            != [(r.tags, r.dps) for r in stale]:
        checks.failures.append("staleness sequence failed")
    ingest_arm(tsdb, queries[0], median_wall, checks)
    launches = dict(kernels.LAUNCHES)
    print("e2e launches %s" % json.dumps(launches))
    for name in ("window_moments", "grid_fill_rate", "group_moments",
                 "window_order", "group_order", "moving_average",
                 "gather_windows"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the main "
                                   "path" % name)
    print("e2e device cache %s" % json.dumps(cache.collect_stats()))
    cache.invalidate()      # the union phases run without the entry
    del cpu
    return tsdb, launches


def _last_hours(ts: np.ndarray, val: np.ndarray, start: int):
    """Each row's points at or after `start`, as a prefix padded at
    int64 max: (ts, val, mask)."""
    keep = ts >= start
    n = int(keep.sum(axis=1).max())
    out_ts = np.full((ts.shape[0], n), np.iinfo(np.int64).max, np.int64)
    out_val = np.zeros((ts.shape[0], n), val.dtype)
    counts = keep.sum(axis=1)
    for r in range(ts.shape[0]):
        out_ts[r, :counts[r]] = ts[r][keep[r]]
        out_val[r, :counts[r]] = val[r][keep[r]]
    return out_ts, out_val, np.arange(n)[None, :] < counts[:, None]


def _union_cases(name, d_ts, d_val, d_mask, offsets,
                 checks: Checks, exact_ints: bool,
                 digests: dict | None = None):
    """U1, then U2 under every aggregator (each with its own
    interpolation policy), each against its plain version; with
    `digests`, each U2 output's sha256 goes into it.  Returns (u, uoff)
    of the kernel."""
    from opentsdb_tpu_torch.ops import union_agg as ua
    from opentsdb_tpu_torch.ops.aggregators import get_agg

    u, uoff = ua.union_merge(d_ts, d_mask, offsets)
    pu, puoff = ua.union_merge_plain(d_ts, d_mask, offsets)
    checks.exact("union_merge", name + " u", u, pu, "timestamps")
    checks.exact("union_merge", name + " uoff", uoff, puoff, "offsets")
    print("%-15s %-44s U=%d %s" % ("union_merge", name, u.numel(),
                                   "ok" if torch.equal(u, pu) else "FAIL"))
    for agg in FUNCS:
        policy = get_agg(agg).interpolation
        got = ua.union_reduce(d_ts, d_val, d_mask, offsets, u, uoff, agg,
                              policy)
        want = ua.union_reduce_plain(d_ts, d_val, d_mask, offsets, u, uoff,
                                     agg, policy)
        case = "%s %s policy=%s" % (name, agg, policy)
        if digests is not None:
            digests["union_reduce %s %s" % (name, agg)] = _digest(got)
        if exact_ints and agg != "dev":
            checks.exact("union_reduce", case, got, want, "int64 values")
            print("%-15s %-44s exact %s" % (
                "union_reduce", case,
                "ok" if torch.equal(got, want) else "FAIL"))
        else:
            checks.values("union_reduce", case, got, want)
    return u, uoff


def union_shape_cases(dev, b_ts, b_mask, checks: Checks) -> None:
    """(e) U1's awkward shapes over the last 6 h, each against the plain
    version exactly: groups of 1, 2, 3, 5 and 1013 rows with all-masked
    rows among them; 64 equal rows in one group; every point repeated
    within its row, 100 groups."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import union_agg as ua

    pad = np.iinfo(np.int64).max
    e_ts, e_mask = b_ts.copy(), b_mask.copy()
    e_mask[[1, 7, 12, S - 3]] = False         # all masked
    e_ts[[1, 7, 12, S - 3]] = pad
    sizes = np.array([1, 2, 3, 5, S - 11])
    rep = np.repeat(b_ts[:, : b_ts.shape[1] // 2], 2, axis=1)
    rep_mask = np.repeat(b_mask[:, : b_ts.shape[1] // 2], 2, axis=1)
    cases = {
        "(e) groups of 1, 2, 3, 5, 1013": (
            e_ts, e_mask, np.repeat(np.arange(5), sizes)),
        "(e) 64 equal rows": (np.tile(b_ts[:1], (64, 1)),
                              np.tile(b_mask[:1], (64, 1)),
                              np.zeros(64, np.int64)),
        "(e) repeats within rows": (rep, rep_mask,
                                    (np.arange(S) * GROUPS) // S),
    }
    for name, (c_ts, c_mask, c_gid) in cases.items():
        d = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (c_ts, c_mask)]
        offsets = ga.group_offsets(c_gid, int(c_gid.max()) + 1).to(dev)
        u, uoff = ua.union_merge(d[0], d[1], offsets)
        pu, puoff = ua.union_merge_plain(d[0], d[1], offsets)
        checks.exact("union_merge", name + " u", u, pu, "timestamps")
        checks.exact("union_merge", name + " uoff", uoff, puoff, "offsets")
        print("%-15s %-44s U=%d %s" % (
            "union_merge", name, u.numel(),
            "ok" if torch.equal(u, pu) and torch.equal(uoff, puoff)
            else "FAIL"))


def _classes(x) -> dict:
    """Cells of a float64 tensor by the classes of a product."""
    return {"finite": int((torch.isfinite(x) & (x != 0)).sum()),
            "+inf": int((x == math.inf).sum()),
            "-inf": int((x == -math.inf).sum()),
            "+0": int(((x == 0) & ~torch.signbit(x)).sum()),
            "-0": int(((x == 0) & torch.signbit(x)).sum()),
            "NaN": int(torch.isnan(x).sum())}


def _class_codes(x):
    return torch.where(torch.isnan(x), 1, torch.where(
        torch.isinf(x), 2 + torch.signbit(x).long(), torch.where(
            x == 0, 4 + torch.signbit(x).long(), 0)))


def mult_class_phase(dev, ts, val, h, d_ts, d_mask, edges, lengths,
                     checks: Checks) -> None:
    """K4 mult's classes at the headline shape.  (i) The headline batch:
    every window's product overflows to +inf.  (ii) Classes: zeros,
    infinite values, negative values and factors of 1e-300 sprinkled over
    the batch, so that windows overflow before or after a zero or an inf
    value and a few pass near the subnormals (the ordered walk inside the
    kernel).  (iii) A near-1 copy (values in [0.99, 1.01]) whose products
    stay finite.  (ii) and (iii) are held to the plain version on the CPU,
    which multiplies each run in its order (on the card scatter_reduce_
    multiplies in no set order): classes exact, finite values at rtol
    1e-9.  Each case is timed against torch.segment_reduce prod of the
    same runs (masked or NaN slots as 1, outside the timed call)."""
    from opentsdb_tpu_torch.ops import downsample as ds

    cls = val.copy()
    cls[h % 5 == 0] *= -1.0
    cls[h % 1009 == 3] = 0.0
    cls[h % 2003 == 5] = math.inf
    cls[h % 4099 == 11] = 1e-300
    near = 1.0 + ((h % 1000) - 500).astype(np.float64) * 2e-5
    c_ts = torch.from_numpy(ts)
    c_mask = torch.ones((S, N), dtype=torch.bool)
    c_edges = edges.cpu()
    for name, v in (("headline", val), ("classes", cls), ("near-1", near)):
        d_v = torch.from_numpy(v).to(dev)
        got, got_mask = ds.window_order(d_ts, d_v, d_mask, edges, "mult")
        torch.cuda.synchronize()
        counts = _classes(got)
        print("window_order mult %-8s cells: %s" % (
            name, ", ".join("%s %d" % kv for kv in counts.items())))
        if name != "headline":
            want, want_mask = ds.window_order_plain(
                c_ts, torch.from_numpy(v), c_mask, c_edges, "mult")
            case = "mult %s at the headline shape" % name
            checks.exact("window_order", case, got_mask, want_mask)
            checks.exact("window_order", case + " classes",
                         _class_codes(got.cpu()), _class_codes(want),
                         "classes")
            checks.values("window_order", case, got, want)
        flat = torch.where(torch.isnan(d_v), 1.0, d_v).reshape(-1)
        k_ms = time_ms(lambda: ds.window_order(d_ts, d_v, d_mask, edges,
                                               "mult"))
        lib_ms = time_ms(lambda: torch.segment_reduce(flat, "prod",
                                                      lengths=lengths))
        print("time window_order mult %-8s %.4f ms, torch.segment_reduce "
              "prod %.4f ms" % (name, k_ms, lib_ms))
        del d_v, flat, got


def _u2_pairs(d_ts, d_mask, offsets, u, uoff) -> tuple[int, int]:
    """The member-slot pairs U2 must compute: (those where a member takes
    part, the slot within its first and last point; those where it has a
    point, its distinct timestamps).  The rest it interpolates."""
    dev = d_ts.device
    g = offsets.numel() - 1
    groups = torch.arange(g, device=dev)
    row_g = torch.repeat_interleave(groups, offsets[1:] - offsets[:-1])
    slot_g = torch.repeat_interleave(groups, uoff[1:] - uoff[:-1])
    counts = d_mask.sum(dim=1)
    base = int(u.min())
    key = slot_g * (1 << 42) + (u - base)
    first = d_ts[:, 0] - base
    last = d_ts.gather(1, (counts - 1).clamp(min=0)[:, None])[:, 0] - base
    lo = torch.searchsorted(key, row_g * (1 << 42) + first)
    hi = torch.searchsorted(key, row_g * (1 << 42) + last, right=True)
    part = int(torch.where(counts > 0, hi - lo, 0).sum())
    repeats = int(((d_ts[:, 1:] == d_ts[:, :-1]) & d_mask[:, 1:]).sum())
    return part, int(counts.sum()) - repeats


@functools.lru_cache(maxsize=None)
def ddiv_ops() -> int | None:
    """The float64 instructions nvcc emits for one division in U2's
    interpolation, read from `cuobjdump -sass` of the built union_reduce
    library: in union_reduce_kernel<double, SUM>, its first MUFU.RCP64H
    and every DFMA, DMUL and DADD after it that reads a register the
    reciprocal's chain wrote, up to the quotient's range check (the first
    FFMA); the slow path's call is left out.  None where the listing
    cannot be read."""
    import re
    import shutil
    from opentsdb_tpu_torch.ops import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", kernels.library_path(
            "union_reduce")], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    body = next((part for part in re.split(r"\n\s*Function : ", sass)[1:]
                 if "union_reduce_kernelIdLi0E" in part.split("\n", 1)[0]),
                None)
    if body is None:
        return None
    ops, chain = 0, None
    for line in body.splitlines():
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);",
                      line)
        if not m:
            continue
        op, regs = m.group(1), [int(r) & ~1 for r in
                                re.findall(r"\bR(\d+)", m.group(2))]
        if chain is None:
            if op.startswith("MUFU.RCP64H"):
                ops, chain = 1, {regs[0]}
            continue
        if op.startswith("FFMA"):
            break
        if op.split(".")[0] in ("DFMA", "DMUL", "DADD") and regs \
                and chain.intersection(regs[1:]):
            ops += 1
            chain.add(regs[0])
    return ops or None


def _u2_bound(name: str, nbytes: float, part: int, exact: int,
              per_pair: int) -> tuple[float, str]:
    """U2's bound: its bytes against its float64 operations, `per_pair`
    at every pair where a member takes part and an interpolation (a
    subtract, a multiply, the division's instructions and an add) at
    every pair without a point; prints both, returns the larger and what
    bounds it."""
    div = ddiv_ops()
    ops = part * per_pair + (part - exact) * (3 + (div or 1))
    b_bytes, b_ops = bound_ms(nbytes, 0.0), bound_ms(0.0, ops)
    print("bound union_reduce %-18s bytes %.4f ms (%.3e B), operations "
          "%.4f ms (%.3e: %.3e pairs taking part, %.3e interpolated, a "
          "division %s float64 instructions%s)"
          % (name, b_bytes, nbytes, b_ops, ops, part, part - exact,
             div or 1, "" if div else ", not read: counted as 1"))
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def u2_phase(dev, ts, val, gid, h, checks: Checks,
             digests: dict | None = None) -> dict:
    """U1 and U2 in phase 5's cases (a)-(c), each U2 output against its
    plain version (and into `digests`); U1 timed in (a) and (b), U2's
    sum and dev in (a) and its sum in (b), each a wall and a device time
    beside its byte and operation bounds."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import union_agg as ua

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    offsets = ga.group_offsets(gid, GROUPS).to(dev)

    # (a) the headline batch as it is: ~6.55e5 union slots a group
    u, uoff = _union_cases("(a) headline", d_ts, d_val, d_mask,
                           offsets, checks, False, digests)
    n_slots = u.numel()
    keys = torch.from_numpy(gid).to(dev)[:, None] * (1 << 42) + d_ts
    u1 = {
        **kernel_ms(lambda: ua.union_merge(d_ts, d_mask, offsets)),
        "plain_ms": time_ms(lambda: ua.union_merge_plain(d_ts, d_mask,
                                                         offsets), 3),
        # each timestamp read once, each union slot written once
        "bound_ms": bound_ms(S * N * 8 + n_slots * 8, 0.0),
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.unique(keys)),
    }
    del keys
    part, exact = _u2_pairs(d_ts, d_mask, offsets, u, uoff)
    nbytes = S * N * 17 + n_slots * 16 + (GROUPS + 1) * 16
    times = {"union_merge": u1}
    for row, agg, per_pair in (("union_reduce", "sum", 1),
                               ("union_reduce.dev", "dev", 4)):
        bound, by = _u2_bound("(a) " + agg, nbytes, part, exact, per_pair)
        times[row] = {
            **kernel_ms(lambda: ua.union_reduce(d_ts, d_val, d_mask, offsets,
                                                u, uoff, agg, "lerp")),
            "plain_ms": time_ms(lambda: ua.union_reduce_plain(
                d_ts, d_val, d_mask, offsets, u, uoff, agg, "lerp"), 3),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    del u, uoff, d_val

    # (b) all 1024 rows as one group over the last 6 h
    b_ts, b_val, b_mask = _last_hours(ts, val, END - SIX_HOURS_MS)
    bd = [torch.from_numpy(x).to(dev) for x in (b_ts, b_val, b_mask)]
    one = torch.tensor([0, S], dtype=torch.int64, device=dev)
    u, uoff = _union_cases("(b) ungrouped 6h", *bd, one, checks, False,
                           digests)
    times.update(union_fanin_merge(dev, b_ts, b_mask))
    part, exact = _u2_pairs(bd[0], bd[2], one, u, uoff)
    # each valid point's ts and val read once, the mask, u and out
    bound, by = _u2_bound("(b) sum", int(b_mask.sum()) * 16 + b_mask.size
                          + u.numel() * 16 + 32, part, exact, 1)
    times["union_reduce.fanin"] = {
        **kernel_ms(lambda: ua.union_reduce(*bd, one, u, uoff, "sum",
                                            "lerp")),
        "plain_ms": time_ms(lambda: ua.union_reduce_plain(
            *bd, one, u, uoff, "sum", "lerp"), 3),
        "bound_ms": bound, "bound_by": by, "library_ms": None}
    print("time (b) ungrouped 6h: %d rows x %d points, U=%d, %.3e "
          "member-slot pairs taking part" % (S, b_ts.shape[1], u.numel(),
                                             part))
    del bd, u, uoff

    # (c) an integer copy of 64 rows in 8 groups, values near 2^53
    c_val = (h[:INT_ROWS] % 1_000).astype(np.int64) + 2**53 - 500
    c_gid = (np.arange(INT_ROWS, dtype=np.int64) * INT_GROUPS) // INT_ROWS
    _union_cases("(c) int64 near 2^53",
                 d_ts[:INT_ROWS], torch.from_numpy(c_val).to(dev),
                 d_mask[:INT_ROWS],
                 ga.group_offsets(c_gid, INT_GROUPS).to(dev), checks, True,
                 digests)
    return times


def union_kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    from opentsdb_tpu_torch.ops import rate as rt

    times = u2_phase(dev, ts, val, gid, h, checks)
    b_ts, _, b_mask = _last_hours(ts, val, END - SIX_HOURS_MS)
    union_shape_cases(dev, b_ts, b_mask, checks)
    del b_ts, b_mask
    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)

    # (d) R on the headline batch under every rate option set
    i_val = torch.from_numpy(h % 1_000 + 2**53).to(dev)
    for vname, v in (("float", d_val), ("all_int", i_val)):
        for rname, rargs in RATE_SETS.items():
            if rargs is None:
                continue
            opts = rt.RateOptions(*rargs)
            got = rt.point_rate(d_ts, v, d_mask, opts)
            want = rt.point_rate_plain(d_ts, v, d_mask, opts)
            case = "(d) %s rate=%s" % (vname, rname)
            checks.exact("point_rate", case, got[0], want[0], "timestamps")
            checks.exact("point_rate", case, got[2], want[2])
            checks.values("point_rate", case, got[1], want[1])
    del i_val
    opts = rt.RateOptions()
    r = {
        **kernel_ms(lambda: rt.point_rate(d_ts, d_val, d_mask, opts)),
        "plain_ms": time_ms(lambda: rt.point_rate_plain(d_ts, d_val, d_mask,
                                                        opts)),
        "bound_ms": bound_ms(S * N * 17 * 2, 3.0 * S * N),
        "bound_by": "bytes",
        "library_ms": None,
    }
    times["point_rate"] = r
    del d_ts, d_val, d_mask
    # the union path's shape: the last 6 h of every row (case (b))
    b_ts, b_val, b_mask = (torch.from_numpy(x).to(dev) for x in _last_hours(
        ts, val, END - SIX_HOURS_MS))
    times["point_rate.union"] = {
        **kernel_ms(lambda: rt.point_rate(b_ts, b_val, b_mask, opts)),
        "plain_ms": time_ms(lambda: rt.point_rate_plain(b_ts, b_val, b_mask,
                                                        opts)),
        "bound_ms": bound_ms(b_ts.numel() * 17 * 2, 0.0),
        "library_ms": None,
    }
    print_times(times)
    return times


def _union_order_cases(name, d_ts, d_val, d_mask, offsets, checks: Checks,
                       exact_ints: bool, digests: dict | None = None):
    """U1, then U3 under each of UNION_ORDER (each with its own
    interpolation policy) and MA after U2's sums (movingAverage,
    movingAverage10), each against its plain version (MA's on the CPU, bit
    for bit); with `digests`, each output's sha256 goes into it.  Returns
    (u, uoff)."""
    from opentsdb_tpu_torch.ops import aggregators as ag
    from opentsdb_tpu_torch.ops import union_agg as ua

    u, uoff = ua.union_merge(d_ts, d_mask, offsets)
    for agg in UNION_ORDER:
        policy = ag.get_agg(agg).interpolation
        got = ua.union_order(d_ts, d_val, d_mask, offsets, u, uoff, agg,
                             policy)
        if digests is not None:
            digests["union_order %s %s" % (name, agg)] = _digest(got)
        if exact_ints:
            # the plain version on the CPU: torch's division by a scalar on
            # the card multiplies by the reciprocal, which a truncated
            # int-mode percentile can see
            want = ua.union_order_plain(d_ts.cpu(), d_val.cpu(),
                                        d_mask.cpu(), offsets.cpu(),
                                        u.cpu(), uoff.cpu(), agg, policy)
        else:
            want = ua.union_order_plain(d_ts, d_val, d_mask, offsets, u,
                                        uoff, agg, policy)
        case = "%s %s policy=%s" % (name, agg, policy)
        if exact_ints:
            got = got.cpu()
            checks.exact("union_order", case, got, want, "int64 values")
            print("%-15s %-44s exact %s" % (
                "union_order", case,
                "ok" if torch.equal(got, want) else "FAIL"))
        else:
            checks.values("union_order", case, got, want)
    sums = ua.union_reduce(d_ts, d_val, d_mask, offsets, u, uoff, "sum",
                           "lerp")
    for nw in (5, 10):
        got = ag.moving_average(sums, None, uoff, nw)
        # the plain version on the CPU: its cumsum runs in order there, as
        # the kernel's running sums do, and a window sum is a difference
        # of running sums that cancellation magnifies
        want = ag.moving_average_plain(sums.cpu(), None, uoff.cpu(), nw)
        _ma_exact(checks, "%s union movingAverage%d" % (name, nw), got,
                  want)
        if digests is not None:
            digests["moving_average %s union %d" % (name, nw)] = _digest(got)
    return u, uoff


def union_order_phase(dev, ts, val, gid, h, checks: Checks,
                      digests: dict | None = None) -> dict:
    """U3 union_order and MA at the union position: (a) the headline batch
    in its 100 groups, (b) all 1024 rows as one group over the last 6 h,
    (c) 64 integer rows near 2^53 in 8 groups, exact.  Timed: U3's median
    in (a) (`union_order`, first, p99 and mult beside it) and (b)
    (`union_order.fanin`), MA's movingAverage5 in (a) (`moving_average`,
    with its chain bound)."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import union_agg as ua

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    u, uoff = _union_order_cases("(a) headline", d_ts, d_val, d_mask,
                                 offsets, checks, False, digests)
    n_slots = u.numel()
    s_g = S / GROUPS
    u3_bytes = S * N * 17 + n_slots * 16 + (GROUPS + 1) * 16
    u3_ops = n_slots * s_g
    u3 = {
        **kernel_ms(lambda: ua.union_order(d_ts, d_val, d_mask, offsets,
                                           u, uoff, "median", "lerp")),
        "plain_ms": time_ms(lambda: ua.union_order_plain(
            d_ts, d_val, d_mask, offsets, u, uoff, "median", "lerp"), 3),
        "bound_ms": bound_ms(u3_bytes, u3_ops),
        "bound_by": "bytes" if u3_bytes > u3_ops / F64_FLOPS * HBM_BYTES_S
        else "operations",
        "library_ms": None,
    }
    extra = {f: kernel_ms(lambda f=f, p=p: ua.union_order(
        d_ts, d_val, d_mask, offsets, u, uoff, f, p))
        for f, p in (("first", "zim"), ("p99", "zim"), ("mult", "lerp"))}
    print("time union_order (a) %s" % ", ".join(
        "%s %.4f ms (device %s)" % (f, t["ms"], _fmt(t["device_ms"]))
        for f, t in extra.items()))
    sums = ua.union_reduce(d_ts, d_val, d_mask, offsets, u, uoff, "sum",
                           "lerp")
    ma = ma_row(dev, sums, None, uoff)
    del u, uoff, sums

    b_ts, b_val, b_mask = _last_hours(ts, val, END - SIX_HOURS_MS)
    bd = [torch.from_numpy(x).to(dev) for x in (b_ts, b_val, b_mask)]
    one = torch.tensor([0, S], dtype=torch.int64, device=dev)
    u, uoff = _union_order_cases("(b) ungrouped 6h", *bd, one, checks,
                                 False, digests)
    b_bytes = b_ts.size * 17 + u.numel() * 16 + 2 * 16
    b_ops = u.numel() * S
    u3_b = {
        **kernel_ms(lambda: ua.union_order(*bd, one, u, uoff, "median",
                                           "lerp")),
        "plain_ms": time_ms(lambda: ua.union_order_plain(
            *bd, one, u, uoff, "median", "lerp"), 3),
        "bound_ms": bound_ms(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes > b_ops / F64_FLOPS * HBM_BYTES_S
        else "operations",
        "library_ms": None,
    }
    print("time (b) ungrouped 6h: union_order median, U=%d" % u.numel())
    del bd, u, uoff

    c_val = (h[:INT_ROWS] % 1_000).astype(np.int64) + 2**53 - 500
    c_gid = (np.arange(INT_ROWS, dtype=np.int64) * INT_GROUPS) // INT_ROWS
    _union_order_cases("(c) int64 near 2^53",
                       d_ts[:INT_ROWS], torch.from_numpy(c_val).to(dev),
                       d_mask[:INT_ROWS],
                       ga.group_offsets(c_gid, INT_GROUPS).to(dev), checks,
                       True, digests)
    times = {"union_order": u3, "union_order.fanin": u3_b,
             "moving_average": ma}
    print_times(times)
    return times


def _digest(x: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def _ma_exact(checks: Checks, case: str, got, want) -> None:
    """MA against its plain version on the CPU, bit for bit: the same
    ordered additions from 0 (float64 compared as their bits)."""
    got = got.cpu()
    if got.is_floating_point():
        got, want = _raw_bits(got), _raw_bits(want)
    checks.exact("moving_average", case, got, want, "bits")
    print("%-15s %-44s bit for bit %s" % (
        "moving_average", case, "ok" if torch.equal(got, want) else "FAIL"))


@functools.cache
def chain_latency_ns(dev) -> float | None:
    """The card's dependent float64 add latency in ns: one thread adding
    2^20 and then 2^22 times (csrc/moving_average.cu moving_average_chain,
    CUDA events, medians of 7), the difference over the adds between.
    Measured once a run; None where the library has no such entry (a tree
    from before it)."""
    import ctypes
    from opentsdb_tpu_torch.ops import kernels

    fn = getattr(kernels.library("moving_average"), "moving_average_chain",
                 None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(adds):
        if fn(adds, 1.0, out.data_ptr(), stream) != 0:
            raise RuntimeError("moving_average_chain failed to launch")

    lo, hi = 1 << 20, 1 << 22
    t_lo, t_hi = time_ms(lambda: run(lo)), time_ms(lambda: run(hi))
    if float(out[0]) != hi:
        raise RuntimeError("moving_average_chain summed %r" % float(out[0]))
    ns = (t_hi - t_lo) * 1e6 / (hi - lo)
    print("chain: a dependent float64 add %.4f ns (%d adds %.4f ms, %d adds "
          "%.4f ms)" % (ns, lo, t_lo, hi, t_hi))
    return ns


def ma_row(dev, sums, live, offsets, nw: int = 5) -> dict:
    """MA's timed row at one position, movingAverage<nw>: wall and device
    time, the plain version, the byte bound (sums, live and out once, the
    offsets once) and, for float64 sums, the chain bound: the longest
    run's live slots times the dependent float64 add latency."""
    from opentsdb_tpu_torch.ops import aggregators as ag

    r = offsets.numel() - 1
    if live is None:
        per_run = offsets[1:] - offsets[:-1]
    else:
        seen = torch.cat([live.new_zeros(1, dtype=torch.int64),
                          torch.cumsum(live.to(torch.int64), 0)])
        per_run = seen[offsets[1:]] - seen[offsets[:-1]]
    ns = chain_latency_ns(dev) if sums.is_floating_point() else None
    return {
        **kernel_ms(lambda: ag.moving_average(sums, live, offsets, nw)),
        "plain_ms": time_ms(lambda: ag.moving_average_plain(
            sums, live, offsets, nw)),
        "bound_ms": bound_ms(sums.numel() * (16 if live is None else 17)
                             + (r + 1) * 8, 2.0 * sums.numel()),
        "chain_bound_ms": None if ns is None
        else int(per_run.max()) * ns * 1e-6,
        "library_ms": None,
    }


def ma_positions_phase(dev, ts, val, gid, checks: Checks,
                       digests: dict | None = None) -> dict:
    """MA at the downsample position (K1's 1h window sums of the headline
    batch over their mask: 1024 runs of 283) and at the grid position
    (K3's group sums over the windows with data: 100 runs of 283),
    movingAverage5 and movingAverage10 each held to the plain version on
    the CPU bit for bit; movingAverage5 timed at each
    (`moving_average.downsample`, `moving_average.grid`)."""
    from opentsdb_tpu_torch.ops import aggregators as ag
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    edges = ds.FixedWindows.for_range(START, END, INTERVAL_MS) \
        .window_edges(dev)
    w = edges.numel() - 1
    sums, sum_mask = ds.window_moments(d_ts, d_val, d_mask, edges, "sum")
    v, m = ds.window_moments(d_ts, d_val, d_mask, edges, "avg")
    del d_ts, d_val, d_mask
    contrib, part, present = ga.grid_fill_rate(edges[:w], v, m, "lerp")
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    gsum, _ = ga.group_moments("sum", contrib, part, present, offsets)
    gcnt, _ = ga.group_moments("count", contrib, part, present, offsets)
    del v, m, contrib, part, present
    positions = {  # name: (sums, live, offsets of runs of w)
        "downsample": (sums.reshape(-1), sum_mask.reshape(-1),
                       torch.arange(S + 1, device=dev) * w),
        "grid": (gsum.reshape(-1), (gcnt > 0).reshape(-1),
                 torch.arange(GROUPS + 1, device=dev) * w),
    }
    times = {}
    for name, (x, live, off) in positions.items():
        for nw in (5, 10):
            got = ag.moving_average(x, live, off, nw)
            want = ag.moving_average_plain(x.cpu(), live.cpu(), off.cpu(),
                                           nw)
            _ma_exact(checks, "%s movingAverage%d" % (name, nw), got, want)
            if digests is not None:
                digests["moving_average %s %d" % (name, nw)] = _digest(got)
        times["moving_average." + name] = ma_row(dev, x, live, off)
    print_times(times)
    return times


def union_fanin_merge(dev, b_ts, b_mask) -> dict:
    """U1 on case (b), all 1024 rows as one group over the last 6 h
    (`union_merge.fanin`): wall and device time beside its byte bound
    (each valid timestamp read once, each union slot written once), the
    plain version and torch.unique of the same timestamps."""
    from opentsdb_tpu_torch.ops import union_agg as ua

    d_ts = torch.from_numpy(b_ts).to(dev)
    d_mask = torch.from_numpy(b_mask).to(dev)
    one = torch.tensor([0, S], dtype=torch.int64, device=dev)
    u, _ = ua.union_merge(d_ts, d_mask, one)
    keys = d_ts[d_mask]
    lib = kernel_ms(lambda: torch.unique(keys))
    return {"union_merge.fanin": {
        **kernel_ms(lambda: ua.union_merge(d_ts, d_mask, one)),
        "plain_ms": time_ms(lambda: ua.union_merge_plain(d_ts, d_mask, one),
                            3),
        "bound_ms": bound_ms(keys.numel() * 8 + u.numel() * 8, 0.0),
        "library_ms": lib["ms"], "library_device_ms": lib["device_ms"]}}


def union_e2e_phase(dev, tsdb, ts, h, checks: Checks) -> dict:
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.query.planner import PHASES
    from opentsdb_tpu_torch.storage.memstore import SeriesKey

    metric = tsdb.metrics.get_or_create_id("mi")
    k_host = tsdb.tag_names.get_id("host")
    k_group = tsdb.tag_names.get_id("group")
    # counters climbing from 2^53
    ival = np.cumsum(h[:INT_ROWS] % 1_000, axis=1) + 2**53
    for i in range(INT_ROWS):
        key = SeriesKey.make(metric, {
            k_host: tsdb.tag_values.get_or_create_id("h%04d" % i),
            k_group: tsdb.tag_values.get_or_create_id(
                "g%03d" % (i * INT_GROUPS // INT_ROWS))})
        tsdb.store.add_batch(key, ts[i], ival[i], True)

    start = END - SIX_HOURS_MS
    queries = {"sum:m{group=*}": GROUPS, "avg:m": 1,
               "sum:rate:m{group=*}": GROUPS,
               "sum:rate{counter}:mi{group=*}": INT_GROUPS,
               "sum:mi{group=*}": INT_GROUPS,
               "p99:m{group=*}": GROUPS, "diff:rate:m{group=*}": GROUPS,
               "median:mi{group=*}": INT_GROUPS,
               "first:mi{group=*}": INT_GROUPS,
               "movingAverage5:m{group=*}": GROUPS}
    int_answers = ("sum:mi{group=*}", "median:mi{group=*}",
                   "first:mi{group=*}")
    subset = "{group=g000|g001|g002|g003}"
    kernels.reset_launches()
    answers, filtered = {}, {}
    for m in queries:
        runner = tsdb.new_query_runner()
        runner.run(_query(m, start))             # warm-up
        walls, splits = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            res = runner.run(_query(m, start))
            walls.append((time.perf_counter() - t0) * 1e3)
            splits.append(dict(runner.exec_stats))
        answers[m] = res
        wall = statistics.median(walls)
        split = {p: statistics.median(s[p + "Ms"] for s in splits)
                 for p in PHASES}
        points = splits[-1]["pointsScanned"]
        print("e2e %-30s wall %.1f ms (median of 5) | build %.1f h2d %.1f "
              "kernels %.1f extract %.1f ms | kernel share %.4f | %d points "
              "in, %.3e points/s | %d results, %d points out"
              % (m, wall, split["build"], split["h2d"], split["kernels"],
                 split["extract"], split["kernels"] / wall, points,
                 points / (wall / 1e3), len(res),
                 sum(len(r.dps) for r in res)))
        filtered[m] = tsdb.new_query_runner().run(_query(
            m.replace("{group=*}", "") + subset, start))
    launches = dict(kernels.LAUNCHES)
    print("e2e union launches %s" % json.dumps(launches))
    for name in ("union_merge", "union_reduce", "point_rate",
                 "union_order", "moving_average"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the union "
                                   "path" % name)

    for m, res in answers.items():
        if len(res) != queries[m]:
            checks.failures.append("%s: %d results" % (m, len(res)))
        vals = np.array([v for r in res for _, v in r.dps], np.float64)
        if vals.size == 0 or not np.isfinite(vals).all():
            checks.failures.append("%s: empty or non-finite values" % m)
    for m in int_answers:
        if not all(isinstance(v, int) for r in answers[m] for _, v in r.dps):
            checks.failures.append("%s: values are not integers" % m)

    cpu = _cpu_copy(tsdb)
    for m in queries:
        fm = m.replace("{group=*}", "") + subset
        want = cpu.new_query_runner().run(_query(fm, start))
        got = filtered[m]
        same = [(a.tags, [t for t, _ in a.dps]) for a in got] \
            == [(b.tags, [t for t, _ in b.dps]) for b in want]
        if not same:
            checks.failures.append("%s: card and CPU differ in groups or "
                                   "timestamps" % fm)
            continue
        gv = [v for a in got for _, v in a.dps]
        wv = [v for b in want for _, v in b.dps]
        if m in int_answers:
            checks.exact("e2e union", fm, torch.tensor(gv), torch.tensor(wv),
                         "int64 values")
            print("%-15s %-44s exact %s" % ("e2e union", fm,
                                            "ok" if gv == wv else "FAIL"))
        else:
            checks.values("e2e union", fm, torch.tensor(gv),
                          torch.tensor(wv))
    return launches


def histogram_fleet():
    """The latency fleet's bucket counts, [H_SERIES, H_POINTS, 32] int64:
    each series' mass centred on a bucket of its own, Poisson counts."""
    rng = np.random.default_rng(11)
    k = np.arange(len(H_EDGES) - 1)
    counts = np.empty((H_SERIES, H_POINTS, k.size), np.int64)
    for s in range(H_SERIES):
        lam = 200.0 * np.exp(-((k - (8 + s % 12)) / 3.0) ** 2) + 0.5
        counts[s] = rng.poisson(lam, (H_POINTS, k.size))
    return counts


def _h_tags(s: int) -> dict:
    return {"group": "g%02d" % (s * H_GROUPS // H_SERIES), "host": "h%03d" % s}


def _h_json(counts, s: int, t: int, keys) -> dict:
    return {"metric": "h", "timestamp": H_START_S + t * H_STEP_S,
            "buckets": dict(zip(keys, counts[s, t].tolist())),
            "tags": _h_tags(s)}


class Serving:
    """A TSDServer on 127.0.0.1:<ephemeral> with its event loop in a
    thread; leaving the block stops it (the pool drains, then the TSDB
    shuts down) and joins the thread."""

    def __init__(self, tsdb, workers: int = 4):
        import asyncio
        import threading
        from opentsdb_tpu_torch.tsd.server import TSDServer
        self.server = TSDServer(tsdb, port=0, bind="127.0.0.1",
                                worker_threads=workers)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever)

    def __enter__(self):
        import asyncio
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(),
                                         self.loop).result(timeout=30)
        return self.server

    def __exit__(self, *exc):
        import asyncio
        try:
            asyncio.run_coroutine_threadsafe(self.server.stop(),
                                             self.loop).result(timeout=60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            self.loop.close()


def _telnet(port: int, lines: list[str]) -> tuple[str, float]:
    """Send `lines` on one telnet connection, then `version`; returns what
    came back before the version reply and the seconds until it did."""
    import socket
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port)) as sock:
        sock.settimeout(120)
        sock.sendall(("".join(l + "\n" for l in lines) + "version\nexit\n")
                     .encode())
        out = b""
        while b"exiting\n" not in out:
            chunk = sock.recv(65536)
            if not chunk:
                break
            out += chunk
    text = out.decode()
    return text[:text.find("opentsdb_tpu_torch ")], time.perf_counter() - t0


def daemon_ingest(tsdb, port: int, counts, checks: Checks) -> None:
    """The fleet into the TSDB: the first 23 hours in process, the last
    hour through the daemon (telnet, then HTTP); then 10,240 scalar points
    of `m` over HTTP and telnet."""
    import http.client
    from opentsdb_tpu_torch.histogram import SimpleHistogram

    keys = ["%d,%d" % (lo, hi) for lo, hi in zip(H_EDGES, H_EDGES[1:])]
    last_hour = H_POINTS - 60
    t0 = time.perf_counter()
    for s in range(H_SERIES):
        tags = _h_tags(s)
        for t in range(last_hour):
            dp = _h_json(counts, s, t, keys)
            tsdb.add_histogram_point_json("h", dp["timestamp"], dp, tags)
    in_proc = time.perf_counter() - t0
    n_in = H_SERIES * last_hour

    # 1,024 points as telnet `histogram` lines (base64), the first four
    # minutes of the last hour
    lines = []
    for t in range(last_hour, last_hour + 4):
        for s in range(H_SERIES):
            h = SimpleHistogram(0)
            for lo, hi, c in zip(H_EDGES, H_EDGES[1:], counts[s, t].tolist()):
                h.add_bucket(lo, hi, c)
            lines.append("histogram 0 h %d %s %s" % (
                H_START_S + t * H_STEP_S, h.to_base64(include_id=False),
                " ".join("%s=%s" % kv for kv in _h_tags(s).items())))
    reply, tel_s = _telnet(port, lines)
    if reply:
        checks.failures.append("telnet histogram replied %r" % reply[:200])

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    dps = [_h_json(counts, s, t, keys) for t in range(last_hour + 4, H_POINTS)
           for s in range(H_SERIES)]
    t0 = time.perf_counter()
    for i in range(0, len(dps), 512):
        body = json.dumps(dps[i:i + 512])
        conn.request("POST", "/api/histogram", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        answer = r.read()
        if r.status != 204:
            checks.failures.append("POST /api/histogram: %d %r"
                                   % (r.status, answer[:200]))
    http_s = time.perf_counter() - t0
    print("daemon ingest h: %d points in process %.1f s (%.0f/s); %d "
          "telnet histogram lines %.2f s (%.0f/s); %d points over POST "
          "/api/histogram in %d batches %.2f s (%.0f/s)"
          % (n_in, in_proc, n_in / in_proc, len(lines), tel_s,
             len(lines) / tel_s, len(dps), (len(dps) + 511) // 512, http_s,
             len(dps) / http_s))

    # 10,240 scalar points of m: 8 rounds over HTTP, 2 over telnet
    tags = [{"host": "h%04d" % i, "group": "g%03d" % (i * GROUPS // S)}
            for i in range(S)]
    scalar = [{"metric": "m",
               "timestamp": END + (5 + k) * STEP_MS + i * (STEP_MS // S),
               "value": 100.0 + (i * 7 + k) % 1_000 * 0.05, "tags": tags[i]}
              for k in range(10) for i in range(S)]
    t0 = time.perf_counter()
    for i in range(0, 8 * S, 512):
        conn.request("POST", "/api/put", json.dumps(scalar[i:i + 512]),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        answer = r.read()
        if r.status != 204:
            checks.failures.append("POST /api/put: %d %r"
                                   % (r.status, answer[:200]))
    put_s = time.perf_counter() - t0
    conn.close()
    reply, tput_s = _telnet(port, [
        "put m %d %r %s" % (dp["timestamp"], dp["value"], " ".join(
            "%s=%s" % kv for kv in dp["tags"].items()))
        for dp in scalar[8 * S:]])
    if reply:
        checks.failures.append("telnet put replied %r" % reply[:200])
    print("daemon ingest m: %d points over POST /api/put %.2f s (%.0f/s); "
          "%d telnet put lines %.2f s (%.0f/s)"
          % (8 * S, put_s, 8 * S / put_s, 2 * S, tput_s, 2 * S / tput_s))
    stored = sum(len(x) for x in tsdb.histogram_store.all_series())
    if stored != H_SERIES * H_POINTS:
        checks.failures.append("the fleet stored %d histogram points"
                               % stored)


def _h_groups(tsdb):
    """[(group_key, [HistogramSeries])] of `h` by group, as the planner
    orders them."""
    by_group = {}
    for series in tsdb.histogram_store.series_for_metric(
            tsdb.metrics.get_id("h")):
        g = tsdb.resolve_key_tags(series.key)["group"]
        by_group.setdefault((g,), []).append(series)
    return [(g, by_group[g]) for g in sorted(by_group)]


def _hist_times(fn, plain, library, nbytes) -> dict:
    return {**kernel_ms(fn), "plain_ms": time_ms(plain),
            "bound_ms": bound_ms(nbytes, 0.0), "bound_by": "bytes",
            "library_ms": None if library is None else time_ms(library),
            "library_device_ms": None if library is None
            else device_ms(library)}


def histogram_cases(dev, tsdb) -> dict:
    """Phase 7's cases on `dev`: name -> (seg, cnt, rows, buckets, mid,
    percentiles)."""
    from opentsdb_tpu_torch.histogram.store import assemble_columnar

    def planner_batch(groups, interval_ms):
        batch = assemble_columnar(groups, H_START_S * 1000, H_END_S * 1000,
                                  interval_ms)
        return (torch.from_numpy(batch["seg"]).to(dev),
                torch.from_numpy(batch["cnt"]).to(dev),
                batch["n_rows"], batch["n_buckets"],
                torch.from_numpy(batch["mid"]).to(dev))

    groups = _h_groups(tsdb)
    seg, cnt, r, b, mid = planner_batch(groups, 0)
    print("histogram (a) planner batch: R=%d B=%d nnz=%d" % (r, b,
                                                             seg.numel()))
    # the daemon's other percentile queries: 1h-sum by group, and every
    # series as one group
    hour = planner_batch(groups, 3_600_000) + ([50.0, 99.0],)
    flat = planner_batch([((), list(tsdb.histogram_store.series_for_metric(
        tsdb.metrics.get_id("h"))))], 0) + ([99.0],)

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n_s, n_g, n_t, n_b = HB_SERIES, HB_GROUPS, H_POINTS, 32
    e = torch.arange(n_s * n_t * n_b, dtype=torch.int64, device=dev)
    s_of, t_of, k_of = e // (n_t * n_b), (e // n_b) % n_t, e % n_b
    g_of = s_of // (n_s // n_g)
    seg_b = (g_of * n_t + t_of) * n_b + k_of
    seg_c = (g_of * (n_t // 60) + t_of // 60) * n_b + k_of
    del e, s_of, t_of, k_of, g_of
    cnt_b = torch.randint(0, 100, (seg_b.numel(),), generator=gen,
                          dtype=torch.int64, device=dev)
    mid_b = torch.arange(1, n_b + 1, dtype=torch.float64, device=dev) * 1.5
    return {"(a) planner batch": (seg, cnt, r, b, mid, H_PERCS),
            "(b) synthetic %dx%d" % (n_s, n_t): (seg_b, cnt_b, n_g * n_t,
                                                 n_b, mid_b, H_PERCS),
            "(c) synthetic, 1h downsample": (seg_c, cnt_b, n_g * n_t // 60,
                                             n_b, mid_b, H_PERCS),
            "(d) daemon 1h-sum by group": hour,
            "(e) daemon, one group": flat}


def h2_edge_rows(b: int):
    """A copy of tests/torch_parity.py's: 1, 1,001 and two row counts at
    which a 132-SM card takes K = 4 and K = 8 at width b."""
    big = 70_001 * 8 // max(b, 8)
    return [1, 1001, big // 2 + 1, big]


def h2_edge_counts(r: int, b: int, cls: str, seed: int = 91):
    """A copy of tests/torch_parity.py's: counts [r, b] int64 and
    bound-sorted midpoints [b] of one H2_EDGE_CLASSES class."""
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
        add = np.zeros((r, b), np.uint64)
        for k in (3, 4) if b else ():
            rows = np.arange(k - 3, r, 2)
            cols = np.linspace(0, b - 1, k).round().astype(np.int64)
            np.add.at(add, (np.repeat(rows, k), np.tile(cols, len(rows))),
                      np.uint64(1 << 62))
        counts = (counts.astype(np.uint64) + add).astype(np.int64)
    elif cls == "big" and b:
        counts[:, -1] = rng.integers(1 << 50, 1 << 51, r)
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
    """A copy of tests/torch_parity.py's: n percentiles, 100, NaN, 0.5,
    101, 50, 1 and 99.9 first, then draws from [-1, 102)."""
    head = [100.0, np.nan, 0.5, 101.0, 50.0, 1.0, 99.9]
    tail = np.random.default_rng(n).uniform(-1.0, 102.0, max(0, n - 7))
    return np.concatenate([head[:n], tail]).astype(np.float64)


def h2_edge_phase(dev, checks: Checks, digests: dict | None = None) -> None:
    """H2 untimed at every H2_EDGE_WIDTHS width and class, on
    h2_edge_rows' row counts (1, 1,001, and grids that take K = 4 and K =
    8) and under 0, 1 and 70 percentiles, each exactly its plain version
    on the card; with `digests`, each output's sha256 goes into it."""
    from opentsdb_tpu_torch.histogram import kernels as hk

    bad = 0
    for b in H2_EDGE_WIDTHS:
        for cls in H2_EDGE_CLASSES:
            for r in h2_edge_rows(b):
                counts, mid = h2_edge_counts(r, b, cls)
                d_counts = torch.from_numpy(counts).to(dev)
                d_mid = torch.from_numpy(mid).to(dev)
                for n_p in H2_EDGE_PS:
                    percs = torch.from_numpy(h2_edge_percs(n_p)).to(dev)
                    got = hk.percentile_rows(d_counts, d_mid, percs)
                    want = hk.percentile_rows_plain(d_counts, d_mid, percs)
                    case = "edge B=%d %s R=%d P=%d" % (b, cls, r, n_p)
                    checks.exact("histogram_percentile", case, got, want,
                                 "percentile values")
                    bad += not torch.equal(got, want)
                    if digests is not None:
                        digests["histogram_percentile " + case] = \
                            _digest(got)
    print("%-20s %-44s %s" % (
        "histogram_percentile", "edge cases (%d widths x %d classes x 4 R "
        "x %d P)" % (len(H2_EDGE_WIDTHS), len(H2_EDGE_CLASSES),
                     len(H2_EDGE_PS)),
        "exact ok" if not bad else "%d FAIL" % bad))


def histogram_kernel_phase(dev, tsdb, checks: Checks,
                           digests: dict | None = None) -> dict:
    """H1 and H2 against their plain versions on the card, exactly, in
    cases (a) to (e), with their times, then H2's edge cases; with
    `digests`, each H2 output's sha256 goes into it."""
    from opentsdb_tpu_torch.histogram import kernels as hk

    cases = histogram_cases(dev, tsdb)
    # the query path's form: the flag left for the answer's copy (a tree
    # before it has only the form that reads it at the call)
    deferred = getattr(hk, "accumulate_rows_deferred", None)
    out = {}
    for name, (sg, ct, rows, buckets, md, pl) in cases.items():
        percs = torch.tensor(pl, dtype=torch.float64, device=dev)
        grid = hk.accumulate_rows(sg, ct, rows, buckets)
        want = hk.accumulate_rows_plain(sg, ct, rows, buckets)
        checks.exact("histogram_accumulate", name, grid, want, "int64 grids")
        if deferred is not None:
            host = deferred(sg, ct, rows, buckets).buffer.cpu()
            checks.exact("histogram_accumulate", name + " deferred",
                         host, torch.cat((want.cpu().reshape(-1),
                                          torch.zeros(1, dtype=torch.int64))),
                         "int64 grids and flag")
        pv = hk.percentile_rows(grid, md, percs)
        pwant = hk.percentile_rows_plain(grid, md, percs)
        checks.exact("histogram_percentile", name, pv, pwant,
                     "percentile values")
        if digests is not None:
            digests["histogram_percentile " + name] = _digest(pv)
        print("%-20s %-44s R=%d B=%d P=%d nnz=%d grid and percentiles "
              "exact %s" % ("histogram", name, rows, buckets, len(pl),
                            sg.numel(),
                 "ok" if torch.equal(grid, want) and torch.equal(pv, pwant)
                 else "FAIL"))
        cells = rows * buckets

        def direct():
            hk.accumulate_rows(sg, ct, rows, buckets)

        def h1_call():
            deferred(sg, ct, rows, buckets)

        h1 = _hist_times(
            direct if deferred is None else h1_call,
            lambda: hk.accumulate_rows_plain(sg, ct, rows, buckets),
            lambda: torch.zeros(cells, dtype=torch.int64,
                                device=dev).index_add_(0, sg, ct),
            # each entry read once (seg and count), each cell written once
            sg.numel() * 16 + cells * 8)
        h2 = _hist_times(
            lambda: hk.percentile_rows(grid, md, percs),
            lambda: hk.percentile_rows_plain(grid, md, percs), None,
            # each count read once, each answer written once
            cells * 8 + buckets * 8 + percs.numel() * (8 + rows * 8))
        h1["direct_ms"] = h1["ms"] if deferred is None else time_ms(direct)
        for kname, t in (("histogram_accumulate", h1),
                         ("histogram_percentile", h2)):
            print("time %-20s %-30s kernel %.4f ms (device %s)  plain "
                  "%.4f ms  bound %.4f ms (bytes)  library %s%s"
                  % (kname, name, t["ms"], _fmt(t["device_ms"]),
                     t["plain_ms"], t["bound_ms"],
                     "%.4f ms (device %s; index_add_)"
                     % (t["library_ms"], _fmt(t["library_device_ms"]))
                     if t["library_ms"] is not None else "none",
                     "  %s form %.4f ms, read at the call %.4f ms"
                     % ("deferred" if deferred else "one", t["ms"],
                        t["direct_ms"]) if "direct_ms" in t else ""))
        out[name] = (h1, h2)
        del grid, want, pv, pwant
    del cases
    h2_edge_phase(dev, checks, digests)
    return {"histogram_accumulate": out["(a) planner batch"][0],
            "histogram_percentile": out["(a) planner batch"][1],
            "histogram_percentile.1h": out["(d) daemon 1h-sum by group"][1],
            "histogram_percentile.ungrouped": out["(e) daemon, one group"][1]}


H_QUERIES = [
    ("sum:percentiles[50,90,99,99.9]:h{group=*}",
     {"aggregator": "sum", "metric": "h", "percentiles": H_PERCS,
      "filters": [{"type": "wildcard", "tagk": "group", "filter": "*",
                   "groupBy": True}]}),
    ("sum:1h-sum:percentiles[50,99]:h{group=*}",
     {"aggregator": "sum", "metric": "h", "percentiles": [50, 99],
      "downsample": "1h-sum", "filters": [
          {"type": "wildcard", "tagk": "group", "filter": "*",
           "groupBy": True}]}),
    ("sum:show-histogram-buckets:h{group=g00|g01}",
     {"aggregator": "sum", "metric": "h", "showHistogramBuckets": True,
      "filters": [{"type": "literal_or", "tagk": "group",
                   "filter": "g00|g01", "groupBy": True}]}),
    ("sum:percentiles[99]:h",
     {"aggregator": "sum", "metric": "h", "percentiles": [99]}),
]


def daemon_query_phase(dev, tsdb, server, checks: Checks) -> dict:
    """The five queries over HTTP, GET and POST, each body against the
    in-process answer; the histogram ones also against a CPU TSDB (the
    same histogram state through load_state).  Each query is also timed
    in process on a fresh thread, and through the server's RpcManager
    without the socket, to place the HTTP wall's time.  Returns the
    launches."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import quote
    from opentsdb_tpu_torch.core import load_state
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.query.planner import PHASES
    from opentsdb_tpu_torch.tsd.http import HttpRequest
    from opentsdb_tpu_torch.tsd.serializers import HttpJsonSerializer
    from opentsdb_tpu_torch.utils.config import Config

    m_end = END + 16 * STEP_MS
    queries = [(m, body, H_START_S * 1000, H_END_S * 1000)
               for m, body in H_QUERIES]
    queries.append(("sum:1h-avg:m{group=*}",
                    {"aggregator": "sum", "metric": "m", "downsample":
                     "1h-avg", "filters": [{"type": "wildcard",
                                            "tagk": "group", "filter": "*",
                                            "groupBy": True}]},
                    START, m_end))
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)

    def over_http(method, uri, body=None):
        t0 = time.perf_counter()
        conn.request(method, uri, body,
                     {"Content-Type": "application/json"} if body else {})
        r = conn.getresponse()
        raw = r.read()
        wall = (time.perf_counter() - t0) * 1e3
        if r.status != 200:
            checks.failures.append("%s %s: %d %r" % (method, uri[:80],
                                                     r.status, raw[:300]))
            return None, wall
        return json.loads(raw), wall

    # H2's launches by shape: the planner's percentile_rows wrapped for
    # the phase (the kernel's own count stays the one in kernels.LAUNCHES)
    from opentsdb_tpu_torch.query import planner
    h2_shapes: dict[str, int] = {}
    h2 = planner.percentile_rows

    def h2_by_shape(counts, mid, percs):
        key = "[%d, %d] P=%d" % (*counts.shape, percs.numel())
        h2_shapes[key] = h2_shapes.get(key, 0) + 1
        return h2(counts, mid, percs)

    planner.percentile_rows = h2_by_shape
    kernels.reset_launches()
    answers = {}
    for m, sub, start, end in queries:
        uri = "/api/query?start=%d&end=%d&m=%s" % (start, end, quote(m))
        got_get, get_ms = over_http("GET", uri)
        got_post, post_ms = over_http("POST", "/api/query", json.dumps(
            {"start": start, "end": end, "queries": [sub]}))
        q = _query(m, start, end)
        runner = tsdb.new_query_runner()
        t0 = time.perf_counter()
        res = runner.run(q)
        run_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = HttpJsonSerializer().format_query_v1(q, res)
        text = json.dumps(want)
        ser_ms = (time.perf_counter() - t0) * 1e3
        st = runner.exec_stats
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            pool.submit(tsdb.new_query_runner().run, q).result()
        thread_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        handled = server.rpc_manager.handle_http(HttpRequest("GET", uri))
        handler_ms = (time.perf_counter() - t0) * 1e3
        print("daemon %-44s GET %.1f ms POST %.1f ms | in process %.1f ms: "
              "%s | serialize %.1f ms | on a fresh thread %.1f ms | the "
              "GET's handler without the socket %.1f ms | %d results, %d "
              "points, %.1f MB"
              % (m, get_ms, post_ms, run_ms, " ".join(
                  "%s %.1f" % (p, st.get(p + "Ms", 0.0)) for p in PHASES),
                 ser_ms, thread_ms, handler_ms, len(res),
                 sum(len(r.dps) for r in res), len(text) / 1e6))
        if handled.response.status != 200:
            checks.failures.append("%s: the handler answered %d"
                                   % (m, handled.response.status))
        want = json.loads(text)
        if got_get != want or got_post != want:
            checks.failures.append("%s: the HTTP answer differs from the "
                                   "in-process one" % m)
        if not want:
            checks.failures.append("%s: no results" % m)
        answers[m] = (q, want)
    conn.close()
    launches = dict(kernels.LAUNCHES)
    planner.percentile_rows = h2
    print("daemon launches %s" % json.dumps(launches))
    print("daemon H2 shapes %s" % json.dumps(h2_shapes))
    for name in ("histogram_accumulate", "histogram_percentile"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the "
                                   "histogram path" % name)

    # shapes and values of the four-percentile answer
    pct = answers[H_QUERIES[0][0]][1]
    vals = np.array([v for r in pct for v in r["dps"].values()], np.float64)
    if len(pct) != len(H_PERCS) * H_GROUPS \
            or any(len(r["dps"]) != H_POINTS for r in pct) \
            or not np.isfinite(vals).all() or vals.min() <= 0:
        checks.failures.append("four-percentile answer: %d results, "
                               "values %s" % (len(pct), vals[:4]))

    # the same histogram state on the CPU
    t0 = time.perf_counter()
    uid_maps = {kind: tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    cpu = load_state(uid_maps, [], config=Config(
        {"tsd.core.histograms.config": HIST_CONFIG}), device="cpu",
        histograms=[(s.key.metric, dict(s.key.tags), *s.arrays())
                    for s in tsdb.histogram_store.all_series()])
    print("daemon CPU copy of the histograms (load_state) %.1f s"
          % (time.perf_counter() - t0))
    for m, _sub in H_QUERIES:
        q, want = answers[m]
        got = json.loads(json.dumps(HttpJsonSerializer().format_query_v1(
            q, cpu.new_query_runner().run(q))))
        same = got == want
        print("%-20s %-44s card and CPU answers %s" % (
            "daemon", m, "equal" if same else "DIFFER"))
        if not same:
            checks.failures.append("%s: card and CPU answers differ" % m)
    return launches


def lane_kernel_phase(dev, ts, val, h, checks: Checks) -> dict:
    """Phase 9: L1 lane_partials and L2 rollup_avg against their plain
    versions on the card, at the rollup job's shapes."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import lanes

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    d_h = torch.from_numpy(h).to(dev)
    c_mask = d_mask & (d_h % 97 != 0)
    c_val = torch.where(d_h % 211 == 0, torch.nan, d_val)
    # the integer metric of the rollup phase: small integers, whose f64
    # sums are exact in any order
    mi = d_h % 1_000
    del d_h
    plans = {name: ds.FixedWindows.for_range(START, END, ms)
             for name, ms in (("1h", INTERVAL_MS), ("1m", 60_000))}
    times = {}
    for name, plan in plans.items():
        edges = plan.window_edges(dev)
        w = plan.count
        got = lanes.lane_partials(d_ts, c_val, c_mask, edges)
        want = lanes.lane_partials_plain(d_ts, c_val, c_mask, edges)
        case = "%s (W=%d)" % (name, w)
        checks.values("lane_partials", case + " sums", got[0], want[0])
        for part, g, wv in zip(("counts", "mins", "maxs"), got[1:],
                               want[1:]):
            checks.exact("lane_partials", case + " " + part, g, wv, part)
        # on integers every cell is K1's sum, count, min and max, bitwise
        got = lanes.lane_partials(d_ts, mi, c_mask, edges)
        for agg, part in zip(("sum", "count", "min", "max"), got):
            v, m = ds.window_moments(d_ts, mi, c_mask, edges, agg)
            label = "%s mi vs K1 %s" % (case, agg)
            checks.exact("lane_partials", label, v[m], part.double()[m],
                         "cells")
            print("%-15s %-44s bitwise %s" % (
                "lane_partials", label,
                "ok" if torch.equal(v[m], part.double()[m]) else "FAIL"))
        # the main path's call (the rollup job's batch): clean f64 values.
        # It reads val and mask once (9 B a point), ts only where an edge
        # falls, and writes 28 B a cell.
        pos = torch.searchsorted(d_ts, edges.expand(S, -1).contiguous())
        lengths = (pos[:, 1:] - pos[:, :-1]).reshape(-1)
        flat = d_val.reshape(-1)
        if int(lengths.sum()) != S * N:
            checks.failures.append("segment_reduce lengths miss points")
        del pos
        t = {
            **kernel_ms(lambda: lanes.lane_partials(d_ts, d_val, d_mask,
                                                    edges)),
            "plain_ms": time_ms(lambda: lanes.lane_partials_plain(
                d_ts, d_val, d_mask, edges)),
            "bound_ms": bound_ms(S * N * (8 + 1) + S * (w + 1) * 8
                                 + (w + 1) * 8 + S * w * 28, 4.0 * S * N),
            # the library yardstick: torch.segment_reduce sum, min and max
            # over the same runs (three calls; the count is the lengths)
            "library_ms": time_ms(lambda: [torch.segment_reduce(
                flat, red, lengths=lengths) for red in ("sum", "min",
                                                         "max")]),
        }
        print("time lane_partials %s kernel %.4f ms  plain %.4f ms  bound "
              "%.4f ms (bytes)  library %.4f ms (segment_reduce sum, min, "
              "max)" % (case, t["ms"], t["plain_ms"], t["bound_ms"],
                        t["library_ms"]))
        times[name] = t
        del lengths, flat

    # L2 over the 1m sum and count lanes of the batch, under 1h windows
    e1m = plans["1m"].window_edges(dev)
    w1m = plans["1m"].count
    # the lanes as a rollup read takes them: a point a cell at the cell's
    # start, the cells that hold no point masked
    val_s, counts, _mins, _maxs = lanes.lane_partials(d_ts, d_val, d_mask,
                                                      e1m)
    ts_l = e1m[:-1].expand(S, -1).contiguous()
    mask_l = counts > 0
    val_c = counts.long()
    e1h = plans["1h"].window_edges(dev)
    w1h = plans["1h"].count
    for fill, counts_as in (("none", "int64"), ("zero", "int64"),
                            ("none", "float64")):
        vc = val_c if counts_as == "int64" else val_c.double()
        got = lanes.rollup_avg(ts_l, val_s, mask_l, ts_l, vc, mask_l, e1h,
                               fill, -1.0)
        want = lanes.rollup_avg_plain(ts_l, val_s, mask_l, ts_l, vc, mask_l,
                                      e1h, fill, -1.0)
        case = "1m lanes under 1h fill=%s counts %s" % (fill, counts_as)
        checks.exact("rollup_avg", case, got[1], want[1])
        checks.values("rollup_avg", case, got[0], want[0])
    # thin lanes: a cell in three, the count lane's cells elsewhere
    thin_s = mask_l & (torch.arange(w1m, device=dev) % 3 == 0)
    thin_c = mask_l & (torch.arange(w1m, device=dev) % 2 == 0)
    got = lanes.rollup_avg(ts_l, val_s, thin_s, ts_l, val_c, thin_c, e1h)
    want = lanes.rollup_avg_plain(ts_l, val_s, thin_s, ts_l, val_c, thin_c,
                                  e1h)
    checks.exact("rollup_avg", "thin lanes", got[1], want[1])
    checks.values("rollup_avg", "thin lanes", got[0], want[0])
    pos = torch.searchsorted(ts_l, e1h.expand(S, -1).contiguous())
    lengths = (pos[:, 1:] - pos[:, :-1]).reshape(-1)
    del pos
    flat_s, flat_c = val_s.reshape(-1), val_c.double().reshape(-1)
    times["rollup_avg"] = {
        **kernel_ms(lambda: lanes.rollup_avg(ts_l, val_s, mask_l, ts_l,
                                             val_c, mask_l, e1h)),
        "plain_ms": time_ms(lambda: lanes.rollup_avg_plain(
            ts_l, val_s, mask_l, ts_l, val_c, mask_l, e1h)),
        # each lane's val and mask read once, 9 B a cell each, ts only at
        # the edges; 9 B written a window cell
        "bound_ms": bound_ms(2 * S * w1m * (8 + 1) + 2 * S * (w1h + 1) * 8
                             + (w1h + 1) * 8 + S * w1h * (8 + 1),
                             3.0 * S * w1m),
        # two segment_reduce sums and a divide
        "library_ms": time_ms(lambda: torch.segment_reduce(
            flat_s, "sum", lengths=lengths) / torch.segment_reduce(
                flat_c, "sum", lengths=lengths)),
    }
    print_times({"rollup_avg": times["rollup_avg"]})
    return {"lane_partials": times["1h"], "rollup_avg": times["rollup_avg"]}


def _rollup_tsdb(dev, ts, val, h):
    """A TSDB on the card with written rollups (the default 1m/1h/1d
    table, each interval with an SLA that puts its boundary halfway
    through the data) and maintenance-built 1h lanes, holding `m` and the
    integer metric `mi` (h % 1000 over the first INT_ROWS series)."""
    from opentsdb_tpu_torch.core import TSDB
    from opentsdb_tpu_torch.storage.memstore import SeriesKey
    from opentsdb_tpu_torch.utils.config import Config

    sla = int(time.time() * 1e3) - (START + (END - START) // 2)
    table = {"aggregationIds": {"sum": 0, "count": 1, "min": 2, "max": 3},
             "intervals": [{"interval": i, "table": "tsdb-rollup-" + i,
                            "preAggregationTable": "tsdb-rollup-agg-" + i,
                            "delaySla": sla} for i in ("1m", "1h", "1d")]}
    tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True,
                        "tsd.rollups.enable": True,
                        "tsd.rollups.config": json.dumps(table),
                        "tsd.rollup.enable": True,
                        "tsd.rollup.intervals": "1h",
                        "tsd.rollup.interval": 0, **AGG_OFF,
                        **MATERIALIZE}),
                device=dev)
    for name, rows, values in (("m", S, val), ("mi", INT_ROWS, h % 1_000)):
        metric = tsdb.metrics.get_or_create_id(name)
        for i in range(rows):
            key = SeriesKey.make(metric, {
                tsdb.tag_names.get_or_create_id("host"):
                    tsdb.tag_values.get_or_create_id("h%04d" % i),
                tsdb.tag_names.get_or_create_id("group"):
                    tsdb.tag_values.get_or_create_id(
                        "g%03d" % (i * GROUPS // S))})
            tsdb.store.add_batch(key, ts[i], values[i], name == "mi")
    return tsdb


def _same(checks, label, got, want, exact):
    """Card answer against the exact one: groups and timestamps equal,
    values at rtol 1e-9 or bitwise."""
    if [(a.tags, [t for t, _ in a.dps]) for a in got] \
            != [(b.tags, [t for t, _ in b.dps]) for b in want] or not got:
        checks.failures.append("%s: groups or timestamps differ" % label)
        print("%-15s %-44s groups or timestamps FAIL" % ("e2e rollup",
                                                         label))
        return
    gv = torch.tensor([float(v) for a in got for _, v in a.dps])
    wv = torch.tensor([float(v) for b in want for _, v in b.dps])
    if exact:
        checks.exact("e2e rollup", label, gv, wv, "values")
        print("%-15s %-44s bitwise %s" % ("e2e rollup", label,
                                          "ok" if torch.equal(gv, wv)
                                          else "FAIL"))
    else:
        checks.values("e2e rollup", label, gv, wv)


def _timed_run(tsdb, m, reps=3):
    """(answer, median wall ms, exec_stats with each phase's median)."""
    from opentsdb_tpu_torch.query.planner import PHASES
    runner = tsdb.new_query_runner()
    runner.run(_query(m))                                 # warm-up
    walls, stats = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = runner.run(_query(m))
        walls.append((time.perf_counter() - t0) * 1e3)
        stats.append(dict(runner.exec_stats))
    split = dict(stats[-1])
    for p in PHASES:
        split[p + "Ms"] = statistics.median(st[p + "Ms"] for st in stats)
    return res, statistics.median(walls), split


def rollup_e2e_phase(dev, ts, val, h, checks: Checks) -> tuple:
    """Phase 10: written rollups (a) and maintenance-built lanes (b) end to
    end on the card.  Returns (launches, measured cost constants, the
    TSDB)."""
    from opentsdb_tpu_torch.core import load_state
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.ops.costmodel import (LANE_CELL_BYTES,
                                                  predict_lane,
                                                  predict_lane_build)
    from opentsdb_tpu_torch.rollup.job import run_rollup_job
    from opentsdb_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    tsdb = _rollup_tsdb(dev, ts, val, h)
    print("e2e rollup ingest %.3f s: m %d series, mi %d series, %d points"
          % (time.perf_counter() - t0, S, INT_ROWS,
             tsdb.store.total_datapoints))
    kernels.reset_launches()

    # (a) written rollups: the job through L1 into the 1h and 1m lanes
    for interval in ("1h", "1m"):
        t0 = time.perf_counter()
        written = run_rollup_job(tsdb, intervals=[interval])
        wall = time.perf_counter() - t0
        print("e2e rollup job %s: %d cells a lane written in %.3f s (%d "
              "series, %d points read, %.3e points/s)"
              % (interval, written[interval], wall, S + INT_ROWS,
                 S * N + INT_ROWS * N, (S + INT_ROWS) * N / wall))
        if written[interval] <= 0:
            checks.failures.append("rollup job %s wrote nothing" % interval)
    store = tsdb.store
    subset = "{group=g000|g001|g002|g003}"
    # the CPU oracle: the raw state without rollups, the host path
    uid_maps = {kind: tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    cpu = load_state(uid_maps, [(s.key.metric, dict(s.key.tags), *s.arrays())
                                for s in store.all_series()],
                     config=Config({"tsd.query.device_cache.enable": False,
                                    **AGG_OFF, **MATERIALIZE}),
                     device="cpu")
    written_q = ["sum:1h-avg:%s{group=*}", "sum:1h-sum:%s{group=*}",
                 "max:1h-max:%s{group=*}", "sum:1h-count:%s{group=*}",
                 "sum:4h-avg:%s{group=*}"]
    for metric in ("m", "mi"):
        for q in written_q:
            m = q % metric
            res, wall, st = _timed_run(tsdb, m)
            raw = tsdb.new_query_runner().run(_query(
                m.replace(":%s" % metric, ":rollup_raw:%s" % metric)))
            print("e2e rollup %-28s wall %.1f ms (median of 3) | build %.1f "
                  "h2d %.1f kernels %.1f extract %.1f ms | %d results"
                  % (m, wall, st["buildMs"], st["h2dMs"], st["kernelsMs"],
                     st["extractMs"], len(res)))
            _same(checks, m + " vs raw on the card", res, raw,
                  metric == "mi")
            fm = m.replace("{group=*}", subset)
            _same(checks, fm + " vs the CPU raw",
                  tsdb.new_query_runner().run(_query(fm)),
                  cpu.new_query_runner().run(_query(
                      fm.replace(":%s" % metric, ":rollup_raw:%s" % metric))),
                  metric == "mi")
    # the split: rollups up to the SLA boundary, raw points after it
    tsdb.config.override_config("tsd.rollups.split_query.enable", "true")
    m = "sum:1h-avg:m%s" % subset
    t0 = time.perf_counter()
    split = tsdb.new_query_runner().run(_query(m))
    wall = (time.perf_counter() - t0) * 1e3
    tsdb.config.override_config("tsd.rollups.split_query.enable", "false")
    boundary = int(time.time() * 1e3) - tsdb.rollup_config.intervals[0] \
        .delay_sla_ms
    print("e2e rollup split %s wall %.1f ms, boundary %.1f h into the data"
          % (m, wall, (boundary - START) / 3.6e6))
    _same(checks, m + " split vs the CPU raw", split,
          cpu.new_query_runner().run(_query(
              m.replace(":m", ":rollup_raw:m"))), False)
    if not START < boundary < END:
        checks.failures.append("the split boundary is outside the data")
    del cpu

    # /api/rollup and telnet rollup through the daemon
    import http.client
    dps = [{"metric": "rw", "timestamp": START // 1000 + 3600 * k,
            "value": i + k, "tags": {"host": "h%04d" % i},
            "interval": "1h", "aggregator": "sum"}
           for k in range(10) for i in range(S)]
    with Serving(tsdb) as server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=120)
        t0 = time.perf_counter()
        for i in range(0, len(dps), 512):
            conn.request("POST", "/api/rollup", json.dumps(dps[i:i + 512]),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            answer = r.read()
            if r.status != 204:
                checks.failures.append("POST /api/rollup: %d %r"
                                       % (r.status, answer[:200]))
        http_s = time.perf_counter() - t0
        conn.close()
        reply, tel_s = _telnet(server.port, [
            "rollup 1h-count rw %d 1 host=h%04d" % (
                START // 1000 + 3600 * k, i)
            for k in range(10) for i in range(S // 10)])
        if reply:
            checks.failures.append("telnet rollup replied %r" % reply[:200])
    print("e2e rollup ingest rw: %d points over POST /api/rollup %.2f s "
          "(%.0f/s); %d telnet rollup lines %.2f s (%.0f/s)"
          % (len(dps), http_s, len(dps) / http_s, 10 * (S // 10), tel_s,
             10 * (S // 10) / tel_s))
    got = tsdb.new_query_runner().run(_query("sum:1h-sum:rw"))
    want = sum(d["value"] for d in dps)
    total = sum(v for r in got for _, v in r.dps)
    if total != want:
        checks.failures.append("rw: the rollup lane sums to %r, not %r"
                               % (total, want))

    # (b) maintenance-built lanes: rollup_raw keeps the written rollups out
    derivable = ["sum:1h-sum:rollup_raw:%s{group=*}",
                 "sum:1h-avg:rollup_raw:%s{group=*}",
                 "max:1h-max:rollup_raw:%s{group=*}",
                 "sum:1h-count:rollup_raw:%s{group=*}"]
    lanes = tsdb.rollup_lanes
    cache = tsdb.device_cache
    for q in derivable:
        for metric in ("m", "mi"):
            tsdb.new_query_runner().run(_query(q % metric))   # demand
    t0 = time.perf_counter()
    built = lanes.refresh(store, max_blocks=256)
    build_s = time.perf_counter() - t0
    stats = lanes.collect_stats()
    cells = lanes.block_windows * built
    print("e2e lanes refresh: %d blocks (%d cells x up to %d series) built "
          "in %.3f s, %.3f MB resident"
          % (built, cells, S, build_s, stats["tsd.query.rollup.bytes"] / 1e6))
    if built <= 0:
        checks.failures.append("refresh() built no lane block")
    series_cells = stats["tsd.query.rollup.bytes"] / LANE_CELL_BYTES
    print("e2e lanes refresh predicted %.3f s (ops/costmodel "
          "predict_lane_build over %d series-cells)"
          % (predict_lane_build(1, int(series_cells)), series_cells))
    costs = {"lane_build_cell": build_s / max(series_cells, 1)}
    walls = {}
    for q in derivable:
        for metric in ("m", "mi"):
            m = q % metric
            served, wall, st = _timed_run(tsdb, m, reps=5)
            if st.get("rollupLane") != 1.0:
                checks.failures.append("%s: not served by the lanes" % m)
            walls["lane", m] = wall
            tsdb.rollup_lanes = None
            hit, walls["hit", m], _ = _timed_run(tsdb, m, reps=5)
            tsdb.device_cache = None
            _, walls["miss", m], mst = _timed_run(tsdb, m, reps=5)
            tsdb.rollup_lanes, tsdb.device_cache = lanes, cache
            print("e2e lane %-36s lane %.1f ms (build %.1f kernels %.1f "
                  "extract %.1f) | device-cache hit %.1f ms | miss %.1f ms "
                  "(build %.1f)" % (m, wall, st["buildMs"], st["kernelsMs"],
                                    st["extractMs"], walls["hit", m],
                                    walls["miss", m], mst["buildMs"]))
            _same(checks, m + " lane vs exact", served, hit, metric == "mi")
            if m == derivable[0] % "m":
                w = len(served[0].dps)
                mb = S * w * LANE_CELL_BYTES / 2.0 ** 20
                costs["lane_assemble_mb"] = st["buildMs"] / 1e3 / mb
                costs["host_build_point"] = mst["buildMs"] / 1e3 / (S * N)
                print("e2e lane %s: the lane-serve host work predicted "
                      "%.1f ms (ops/costmodel predict_lane), measured %.1f"
                      % (m, predict_lane(S, w, 1) * 1e3, st["buildMs"]))
    # one appended point: the next query takes the exact path with it
    m = derivable[0] % "m"
    tsdb.add_point("m", START // 1000 + 7200, 1e6,
                   {"host": "h0000", "group": "g000"})
    runner = tsdb.new_query_runner()
    after = runner.run(_query(m))
    stale = runner.exec_stats.get("rollupLane")
    tsdb.rollup_lanes = None
    exact = tsdb.new_query_runner().run(_query(m))
    tsdb.rollup_lanes = lanes
    _same(checks, m + " after an append", after, exact, False)
    rebuilt = lanes.refresh(store, max_blocks=256)
    runner = tsdb.new_query_runner()
    again = runner.run(_query(m))
    served_again = runner.exec_stats.get("rollupLane")
    _same(checks, m + " rebuilt lane vs exact", again, exact, False)
    print("e2e lane staleness: after an append the query %s; refresh() "
          "rebuilt %d blocks; the query after it %s"
          % ("took the exact path" if stale is None else "WAS LANE-SERVED",
             rebuilt, "was lane-served" if served_again == 1.0
             else "DID NOT USE THE LANE"))
    if stale is not None or rebuilt < 1 or served_again != 1.0:
        checks.failures.append("lane staleness sequence failed")
    launches = dict(kernels.LAUNCHES)
    print("e2e rollup launches %s" % json.dumps(launches))
    print("e2e rollup lanes %s" % json.dumps(lanes.collect_stats()))
    for name in ("lane_partials", "rollup_avg"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the "
                                   "rollup path" % name)
    return launches, costs, tsdb


def _headline_chunks(dev, ts, val, h, n_chunk: int, clean: bool):
    """The headline batch's first two [S, n_chunk] chunks on the card:
    (ts, val, mask) each, with masked slots and NaN values unless
    `clean`."""
    out = []
    for k in range(2):
        sl = slice(k * n_chunk, (k + 1) * n_chunk)
        c_ts = torch.from_numpy(np.ascontiguousarray(ts[:, sl])).to(dev)
        c_val = torch.from_numpy(np.ascontiguousarray(val[:, sl])).to(dev)
        c_mask = torch.ones_like(c_ts, dtype=torch.bool)
        if not clean:
            c_h = torch.from_numpy(np.ascontiguousarray(h[:, sl])).to(dev)
            c_mask = c_h % 97 != 0
            c_val = torch.where(c_h % 211 == 0, torch.nan, c_val)
        out.append((c_ts, c_val, c_mask))
    return out


def _slice_of(c_ts, windows, wc: int) -> int:
    """w0 of a chunk's slice: its first point's window, clipped as
    StreamAccumulator.update clips it."""
    tmin = int(c_ts.min())
    w0 = (tmin - windows.first_window_ms) // windows.interval_ms
    return min(max(w0, 0), windows.count - wc)


def _fold_both(st, states, chunks, windows, wc, sketch=False):
    """Fold the chunks in order into the kernel's state and the plain
    version's (states[0], states[1]), sliced as the planner slices."""
    for c_ts, c_val, c_mask in chunks:
        w0 = _slice_of(c_ts, windows, wc)
        edges = windows.window_edges(c_ts.device)[w0:w0 + wc + 1]
        first = windows.first_window_ms
        audit = (first, first + windows.count * windows.interval_ms)
        if sketch:
            st.sketch_fold(states[0], c_ts, c_val, c_mask, edges, w0)
            st.sketch_fold_plain(states[1], c_ts, c_val, c_mask, edges, w0)
        st.stream_fold(states[0], c_ts, c_val, c_mask, edges, w0, audit)
        st.stream_fold_plain(states[1], c_ts, c_val, c_mask, edges, w0,
                             audit)


def _compare_states(checks, kernel, case, states, rtol=RTOL, atol=ATOL):
    got, want = states
    for k in want:
        if k in ("n", "oob"):
            checks.exact(kernel, "%s %s" % (case, k), got[k], want[k],
                         "counts")
        else:
            checks.values(kernel, "%s %s" % (case, k), got[k], want[k],
                          rtol, atol)


def _segment_fold(state, c_ts, c_val, edges, w0: int):
    """S1's library yardstick on a chunk: torch.segment_reduce sum, min
    and max over the chunk's window runs (a leading and a trailing run
    take what lies outside the slice's windows), then the elementwise
    merge into the state's slice (n, total, lo, hi).  Returns the call."""
    s, n = c_ts.shape
    wc = edges.numel() - 1
    dev = c_ts.device
    pos = torch.searchsorted(c_ts, edges.expand(s, -1).contiguous())
    bounds = torch.cat([torch.zeros((s, 1), dtype=torch.int64, device=dev),
                        pos, torch.full((s, 1), n, dtype=torch.int64,
                                        device=dev)], dim=1)
    lengths = (bounds[:, 1:] - bounds[:, :-1]).reshape(-1)
    cnt = lengths.reshape(s, wc + 2)[:, 1:-1]
    flat = c_val.reshape(-1)
    sl = slice(w0, w0 + wc)

    def run():
        parts = [torch.segment_reduce(flat, red, lengths=lengths).reshape(
            s, wc + 2)[:, 1:-1] for red in ("sum", "min", "max")]
        state["n"][:, sl] += cnt
        state["total"][:, sl] += parts[0]
        torch.minimum(state["lo"][:, sl], parts[1], out=state["lo"][:, sl])
        torch.maximum(state["hi"][:, sl], parts[2], out=state["hi"][:, sl])
    return run


def _config_chunk(pinned, s: int, base_col: int, seed: int) -> None:
    """bench_configs._chunk_gen's closed form, into the host buffers
    (ts, val, mask) [s, C_CHUNK] (numpy); `seed` 0 gives bench_configs'
    data.  In place, on torch's CPU threads: no [s, n] temporaries."""
    ts, val, mask = (torch.from_numpy(x) for x in pinned)
    rows = torch.arange(s, dtype=torch.int64)[:, None]
    cols = base_col + torch.arange(C_CHUNK, dtype=torch.int64)[None, :]
    torch.add(rows * 2_654_435_761, cols * 40_503 + seed * 7_919, out=ts)
    ts.bitwise_and_(0x7FFFFFFF)
    torch.remainder(ts, 1_000, out=val)
    val.mul_(0.05).add_(100.0)
    ts.remainder_(4_000).add_(C_START + cols * C_STEP)
    mask.fill_(True)


# S2's edge runs: one window a run of each length, 1 s a point
S2_RUNS = (0, 1, 2, 31, 32, 33, 255, 256, 257, 4096, 4097)


def _sketch_pair(st, windows, chunks, dev, digests, name, checks):
    """The chunks folded by S2 (and S1's count) into a state on the card
    and by the plain versions into one on the CPU (whose sort orders NaN
    grid points as the reference's does), unsliced; the sketches held
    together at the sketch's tolerance and the card's into `digests`."""
    s = chunks[0][0].shape[0]
    states = [st.zero_state(s, windows.count, d, sketch=True,
                            lanes=frozenset()) for d in (dev, "cpu")]
    edges = windows.window_edges(dev)
    for c_ts, c_val, c_mask in chunks:
        st.sketch_fold(states[0], c_ts, c_val, c_mask, edges)
        st.stream_fold(states[0], c_ts, c_val, c_mask, edges)
        cpu = [x.cpu() for x in (c_ts, c_val, c_mask, edges)]
        st.sketch_fold_plain(states[1], *cpu)
        st.stream_fold_plain(states[1], *cpu)
    checks.values("sketch_fold", name, states[0]["q"], states[1]["q"],
                  SKETCH_RTOL, SKETCH_ATOL)
    if digests is not None:
        digests["sketch_fold " + name] = _digest(states[0]["q"])


def _s2_edge_chunks(dev, seed: int, infinite: bool):
    """Two [4, 9,060] chunks over windows whose runs hold S2_RUNS points,
    with NaN values (and with `infinite` +inf and -inf ones, whose equal
    neighbours interpolate to NaN grid points) and masked slots: row 2
    holds no point in the first chunk (its cells merge into a count of
    0), row 3 none in the second (state cells merged with an empty
    chunk)."""
    from opentsdb_tpu_torch.ops import downsample as ds

    rng = np.random.default_rng(seed)
    n = sum(S2_RUNS)
    edges = START + 1000 * np.concatenate([[0], np.cumsum(S2_RUNS)])
    chunks = []
    for k in range(2):
        c_ts = np.tile(START + 1000 * np.arange(n, dtype=np.int64), (4, 1))
        c_val = np.round(rng.normal(10.0, 5.0, (4, n)), 1)
        cls = rng.random((4, n))
        c_val[cls < 0.03] = np.nan
        if infinite:
            c_val[(cls >= 0.03) & (cls < 0.05)] = np.inf
            c_val[(cls >= 0.05) & (cls < 0.07)] = -np.inf
        c_mask = rng.random((4, n)) >= 0.1
        c_mask[2 if k == 0 else 3] = False
        chunks.append(tuple(torch.from_numpy(x).to(dev)
                            for x in (c_ts, c_val, c_mask)))
    return ds.EdgeWindows(tuple(int(e) for e in edges)), chunks


def sketch_phase(dev, ts, val, h, checks: Checks,
                 digests: dict | None = None) -> dict:
    """Phase 11 (d): S2 on the headline chunks under 1h windows (p95's
    sketch, two chunks, sliced as the planner slices) with S3's p95 and
    median over it; "0all" runs of 4,096 points (the block path's sort)
    and 16,384 points (its selection); the edge runs; each sketch against
    the plain version's at float32 tolerance (rtol 1e-6, atol 1e-4) and
    into `digests`.  Then S2's time on a clean headline chunk."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import streaming as st

    n_chunk = 4_096      # the planner's chunk at 1024 series (4e6 points)
    windows = ds.FixedWindows.for_range(START, END, INTERVAL_MS)
    w = windows.count
    chunks = _headline_chunks(dev, ts, val, h, n_chunk, clean=False)
    span = int(chunks[0][0].max() - chunks[0][0].min())
    wc = st.quantize_window_slice(2 * (span // INTERVAL_MS + 2), windows) \
        or w
    states = [st.zero_state(S, w, dev, sketch=True, lanes=frozenset(),
                            with_oob=True) for _ in range(2)]
    _fold_both(st, states, chunks, windows, wc, sketch=True)
    _compare_states(checks, "sketch_fold", "headline p95 sketch",
                    [{"q": states[0]["q"]}, {"q": states[1]["q"]}],
                    SKETCH_RTOL, SKETCH_ATOL)
    if digests is not None:
        digests["sketch_fold headline p95 sketch"] = _digest(states[0]["q"])
    for fn in ("p95", "median"):
        got = st.stream_finish(states[0], fn)
        want = st.stream_finish_plain(states[1], fn)
        checks.exact("stream_finish", "headline " + fn, got[1], want[1])
        checks.values("stream_finish", "headline " + fn, got[0], want[0],
                      SKETCH_RTOL, SKETCH_ATOL)
    del chunks

    # "0all": one window a row over two chunks of 4,096 points (1024
    # rows) and of 16,384 (64 rows)
    every = ds.AllWindow(START, END)
    for rows, n in ((S, 4_096), (64, 16_384)):
        part = _headline_chunks(dev, ts[:rows], val[:rows], h[:rows], n,
                                clean=False)
        _sketch_pair(st, every, part, dev, digests,
                     "0all [%d, %d] x 2" % (rows, n), checks)
        del part
    for infinite in (False, True):
        _sketch_pair(st, *_s2_edge_chunks(dev, 53, infinite), dev, digests,
                     "edge runs" + (" inf values" if infinite else ""),
                     checks)

    clean = _headline_chunks(dev, ts, val, h, n_chunk, clean=True)[0]
    c_ts, c_val, c_mask = clean
    w0 = _slice_of(c_ts, windows, wc)
    edges = windows.window_edges(dev)[w0:w0 + wc + 1]
    q_state, q_plain = states     # the state of the two chunks folded
    times = {"sketch_fold": {
        **kernel_ms(lambda: st.sketch_fold(q_state, c_ts, c_val, c_mask,
                                           edges, w0)),
        "plain_ms": time_ms(lambda: st.sketch_fold_plain(
            q_plain, c_ts, c_val, c_mask, edges, w0)),
        "bound_ms": bound_ms(S * n_chunk * (8 + 1) + S * (wc + 1) * 8
                             + S * wc * (st.SKETCH_K * 4 * 2 + 8),
                             2.0 * S * n_chunk),
        # no torch call merges equi-rank summaries
        "library_ms": None,
    }}
    print("time sketch_fold     headline chunk [%d, %d], a %d-window slice"
          % (S, n_chunk, wc))
    return times


def stream_p95_phase(dev, ts, val, checks: Checks) -> None:
    """Phase 12's streamed `sum:1h-p95:m{group=*}` alone on the headline
    TSDB (the device cache detached, the default threshold): its wall and
    split, the fold's ms among them, median of 3."""
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.utils.config import DEFAULTS

    tsdb, _ = headline_tsdb(dev, ts, val)
    key = "tsd.query.streaming.point_threshold"
    tsdb.config.override_config(key, DEFAULTS[key])
    tsdb.device_cache = None
    m = "sum:1h-p95:m{group=*}"
    kernels.reset_launches()
    _, wall, sp = _timed_query(tsdb, m)
    print("stream e2e %-34s wall %.1f ms (median of 3) | %d chunks | "
          "stream %.1f (pack %.1f h2d %.1f fold %.1f) finish+tail %.1f "
          "extract %.1f ms | sketch_fold launches %d"
          % (m, wall, sp.get("streamedChunks", 0), sp["streamMs"],
             sp.get("streamPackMs", 0.0), sp.get("streamH2dMs", 0.0),
             sp.get("streamFoldMs", 0.0), sp["kernelsMs"], sp["extractMs"],
             kernels.LAUNCHES["sketch_fold"]))
    if not sp.get("streamedChunks") or kernels.LAUNCHES["sketch_fold"] < 1:
        checks.failures.append("stream: %s did not stream through S2" % m)


def _timed_query(tsdb, m, reps=3):
    """A warm-up, then `reps` runs of query `m`: (the last answer, the
    median wall in ms, the median of each exec_stats entry)."""
    runner = tsdb.new_query_runner()
    runner.run(_query(m))                   # warm-up
    walls, stats = [], []
    for _ in range(reps):
        runner = tsdb.new_query_runner()
        t0 = time.perf_counter()
        res = runner.run(_query(m))
        walls.append((time.perf_counter() - t0) * 1e3)
        stats.append(dict(runner.exec_stats))
    split = {k: statistics.median(s.get(k, 0.0) for s in stats)
             for k in stats[0]}
    return res, statistics.median(walls), split


def stream_fold_cases(dev, ts, val, h, checks: Checks, seed: int,
                      digests: dict | None = None) -> dict:
    """Phase 11's S1 cases: (a) two headline chunks, sum lanes and every
    lane, (b) the audit of a wrong slice, the headline chunk timed, (c)
    config 2's chunks, held to the plain version and timed.  With
    `digests`, each case's folded state (and the audit's count) goes in
    as sha256."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import streaming as st

    def digest(case, state):
        if digests is not None:
            for k, x in state.items():
                digests["stream_fold %s %s" % (case, k)] = _digest(x)

    n_chunk = 4_096      # the planner's chunk at 1024 series (4e6 points)
    windows = ds.FixedWindows.for_range(START, END, INTERVAL_MS)
    w = windows.count
    chunks = _headline_chunks(dev, ts, val, h, n_chunk, clean=False)
    span = int(chunks[0][0].max() - chunks[0][0].min())
    wc = st.quantize_window_slice(2 * (span // INTERVAL_MS + 2), windows) \
        or w
    print("stream headline chunk [%d, %d], slice of %d of %d 1h windows"
          % (S, n_chunk, wc, w))
    # (a) S1, sum lanes and every lane, two chunks (the Chan merge where
    # a window straddles them), with masked slots and NaN values
    for name, lanes in (("sum lanes", st.lanes_for(["sum"])),
                        ("all lanes", None)):
        states = [st.zero_state(S, w, dev, lanes=lanes, with_oob=True)
                  for _ in range(2)]
        _fold_both(st, states, chunks, windows, wc)
        _compare_states(checks, "stream_fold", "headline " + name, states)
        digest("headline " + name, states[0])
        del states
    # (b) the audit: a slice 10 windows past the chunk's
    states = [st.zero_state(S, w, dev, lanes=st.lanes_for(["sum"]),
                            with_oob=True) for _ in range(2)]
    c_ts, c_val, c_mask = chunks[1]
    w0 = min(_slice_of(c_ts, windows, wc) + 10, w - wc)
    edges = windows.window_edges(dev)[w0:w0 + wc + 1]
    audit = (windows.first_window_ms,
             windows.first_window_ms + w * INTERVAL_MS)
    st.stream_fold(states[0], c_ts, c_val, c_mask, edges, w0, audit)
    st.stream_fold_plain(states[1], c_ts, c_val, c_mask, edges, w0, audit)
    checks.exact("stream_fold", "wrong slice audit", states[0]["oob"],
                 states[1]["oob"], "counts")
    _compare_states(checks, "stream_fold", "wrong slice", states)
    digest("wrong slice", states[0])
    print("stream_fold     wrong slice: oob %d (plain %d)"
          % (int(states[0]["oob"]), int(states[1]["oob"])))
    if int(states[1]["oob"]) <= 0:
        checks.failures.append("stream_fold: a wrong slice counted nothing")
    del states

    # S1's times on a clean chunk, sum lanes (the main path's fold)
    clean = _headline_chunks(dev, ts, val, h, n_chunk, clean=True)[0]
    c_ts, c_val, c_mask = clean
    w0 = _slice_of(c_ts, windows, wc)
    edges = windows.window_edges(dev)[w0:w0 + wc + 1]
    lanes = st.lanes_for(["sum"])
    state = st.zero_state(S, w, dev, lanes=lanes)
    plain_state = st.zero_state(S, w, dev, lanes=lanes)
    lib_state = st.zero_state(S, w, dev, lanes=frozenset({"total", "lo",
                                                          "hi"}))
    slice_bytes = S * wc * 8 * 2 * 2     # n and total, read and written
    times = {"stream_fold": {
        **kernel_ms(lambda: st.stream_fold(state, c_ts, c_val, c_mask,
                                           edges, w0)),
        "plain_ms": time_ms(lambda: st.stream_fold_plain(
            plain_state, c_ts, c_val, c_mask, edges, w0)),
        "bound_ms": bound_ms(S * n_chunk * (8 + 1) + S * (wc + 1) * 8
                             + slice_bytes, 2.0 * S * n_chunk),
        "library_ms": time_ms(_segment_fold(lib_state, c_ts, c_val, edges,
                                            w0)),
    }}
    del state, plain_state, lib_state, chunks, clean

    # (c) S1 at config 2's chunk into its 720,897-window state, sliced
    cfg = CONFIGS[2]
    s2 = cfg["s"]
    c2_windows = ds.FixedWindows.for_range(
        C_START, C_START + C_CHUNK * cfg["chunks"] * C_STEP, cfg["interval"])
    w2 = c2_windows.count
    wc2 = st.quantize_window_slice(
        2 * ((C_CHUNK * C_STEP + 4_000) // cfg["interval"] + 2),
        c2_windows) or w2
    host = [np.empty((s2, C_CHUNK), np.int64), np.empty((s2, C_CHUNK)),
            np.empty((s2, C_CHUNK), bool)]
    c2 = []
    for k in (4, 5):
        _config_chunk(host, s2, k * C_CHUNK, seed)
        c2.append(tuple(torch.from_numpy(x).to(dev) for x in host))
    lanes2 = st.lanes_for(cfg["fns"])
    states = [st.zero_state(s2, w2, dev, lanes=lanes2, with_oob=True)
              for _ in range(2)]
    _fold_both(st, states, c2, c2_windows, wc2)
    _compare_states(checks, "stream_fold", "config 2 chunk", states)
    digest("config 2 chunk", states[0])
    del states
    c_ts, c_val, c_mask = c2[1]
    w0 = _slice_of(c_ts, c2_windows, wc2)
    edges = c2_windows.window_edges(dev)[w0:w0 + wc2 + 1]
    # the cells this chunk reaches: the only ones the fold reads and writes
    reached = int((st.chunk_moments_plain(c_ts, c_val, c_mask, edges,
                                          frozenset())["n"] > 0).sum())
    state = st.zero_state(s2, w2, dev, lanes=lanes2)
    plain_state = st.zero_state(s2, w2, dev, lanes=lanes2)
    lib_state = st.zero_state(s2, w2, dev, lanes=lanes2)
    t_c2 = {
        **kernel_ms(lambda: st.stream_fold(state, c_ts, c_val, c_mask,
                                           edges, w0)),
        "plain_ms": time_ms(lambda: st.stream_fold_plain(
            plain_state, c_ts, c_val, c_mask, edges, w0)),
        "bound_ms": bound_ms(s2 * C_CHUNK * (8 + 1) + s2 * (wc2 + 1) * 8
                             + s2 * wc2 * 8 * 4 * 2, 3.0 * s2 * C_CHUNK),
        "library_ms": time_ms(_segment_fold(lib_state, c_ts, c_val, edges,
                                            w0)),
    }
    # the bound over the reached cells only (n and 3 lanes, read and
    # written), and each row's edges read once
    reached_ms = bound_ms(s2 * C_CHUNK * (8 + 1) + s2 * (wc2 + 1) * 8
                          + reached * 8 * 4 * 2, 3.0 * s2 * C_CHUNK)
    print("time stream_fold     config 2 chunk [%d, %d] into [%d, %d] "
          "(slice %d, 4 lanes, %d cells reached): kernel %.4f ms, device %s"
          "  plain %.4f ms  bound %.4f ms (bytes; %.4f ms over the reached "
          "cells)  library %.4f ms"
          % (s2, C_CHUNK, s2, w2, wc2, reached, t_c2["ms"],
             _fmt(t_c2["device_ms"]), t_c2["plain_ms"], t_c2["bound_ms"],
             reached_ms, t_c2["library_ms"]))
    del state, plain_state, lib_state, c2
    return times


def stream_kernel_phase(dev, ts, val, h, checks: Checks, seed: int) -> dict:
    """Phase 11: S1 stream_fold, S2 sketch_fold and S3 stream_finish
    against their plain versions on the card."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import streaming as st

    times = stream_fold_cases(dev, ts, val, h, checks, seed)
    cfg = CONFIGS[2]
    s2 = cfg["s"]
    w2 = ds.FixedWindows.for_range(
        C_START, C_START + C_CHUNK * cfg["chunks"] * C_STEP,
        cfg["interval"]).count
    times.update(sketch_phase(dev, ts, val, h, checks))

    # (e) S3 on config 2's grid: a full [128, 720,897] state, some cells
    # empty, every function of the config and the fills
    gen = torch.Generator(device=dev).manual_seed(seed)
    cells = (s2, w2)
    fin = {"n": torch.randint(0, 3, cells, device=dev, generator=gen),
           "total": torch.rand(cells, dtype=torch.float64, device=dev,
                               generator=gen) * 300.0}
    fin["lo"] = fin["total"] / 3.0
    fin["hi"] = fin["total"] / 2.0
    for fn in cfg["fns"] + ["avg"]:
        for fill in ("none", "zero"):
            got = st.stream_finish(fin, fn, fill)
            want = st.stream_finish_plain(fin, fn, fill)
            case = "config 2 %s fill=%s" % (fn, fill)
            checks.exact("stream_finish", case, got[1], want[1])
            checks.values("stream_finish", case, got[0], want[0])
    times["stream_finish"] = {
        **kernel_ms(lambda: st.stream_finish(fin, "sum")),
        "plain_ms": time_ms(lambda: st.stream_finish_plain(fin, "sum")),
        "bound_ms": bound_ms(s2 * w2 * (8 + 8 + 8 + 1), 1.0 * s2 * w2),
        # no torch call finishes moment lanes by a function and a fill
        "library_ms": None,
    }
    del fin
    print_times(times)
    return times


def _exact_cell_quantiles(tsdb, windows, pct: float, delta: float):
    """Per series of `m` (in the store's order), the exact quantiles of
    each window's values at pct -/+ delta (fractions), by the sketch's
    midpoint-rank convention: (lo[S, W], hi[S, W])."""
    series = tsdb.store.series_for_metric(tsdb.metrics.get_id("m"))
    w = windows.count
    out = np.zeros((2, len(series), w))
    for i, s in enumerate(series):
        t, v, _, _ = s.window(START, END)
        win = (t - windows.first_window_ms) // windows.interval_ms
        order = np.lexsort((v, win))
        sv = v[order]
        cnt = np.bincount(win, minlength=w)
        starts = np.cumsum(cnt) - cnt
        for j, q in enumerate((pct - delta, pct + delta)):
            fr = np.clip(q * cnt - 0.5, 0.0, np.maximum(cnt - 1.0, 0.0))
            lo = np.floor(fr).astype(np.int64)
            hi = np.minimum(lo + 1, np.maximum(cnt - 1, 0))
            a = sv[np.minimum(starts + lo, len(sv) - 1)]
            b = sv[np.minimum(starts + hi, len(sv) - 1)]
            out[j, i] = np.where(cnt > 0, a + (fr - lo) * (b - a), np.nan)
    return out[0], out[1], series


def stream_e2e_phase(dev, tsdb, checks: Checks) -> dict:
    """Phase 12: the seven grouped queries streamed on the headline TSDB
    at the default threshold, beside the materialized miss."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.ops.streaming import SKETCH_K, pad_pow2
    from opentsdb_tpu_torch.utils.config import DEFAULTS

    cfg = tsdb.config
    key = "tsd.query.streaming.point_threshold"
    cache = tsdb.device_cache
    cache.invalidate()
    cfg.override_config(key, DEFAULTS[key])
    batch_bytes = S * N * 17
    kernels.reset_launches()

    # cold: the query streams and queues the entry's build
    builds0 = cache.builds
    runner = tsdb.new_query_runner()
    t0 = time.perf_counter()
    cold = runner.run(_query(STREAM_QUERIES[0]))
    cold_ms = (time.perf_counter() - t0) * 1e3
    st0 = runner.exec_stats
    cold_builds = cache.builds - builds0
    t0 = time.perf_counter()
    rebuilt = cache.refresh()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    runner = tsdb.new_query_runner()
    after = runner.run(_query(STREAM_QUERIES[0]))
    after_hit = runner.exec_stats.get("deviceCacheHit")
    print("stream cold %s wall %.1f ms | streamedChunks %s deviceCacheHit "
          "%s inline builds %d | refresh() rebuilt %d in %.1f ms | the query "
          "after it %s" % (STREAM_QUERIES[0], cold_ms,
                           st0.get("streamedChunks"),
                           st0.get("deviceCacheHit"), cold_builds, rebuilt,
                           refresh_ms,
                           "hit" if after_hit == 1.0 else "MISSED"))
    if not st0.get("streamedChunks") or st0.get("deviceCacheHit") \
            or cold_builds != 0 or rebuilt != 1 or after_hit != 1.0:
        checks.failures.append("stream: the cold query did not stream, "
                               "queue its build and hit after refresh()")

    # the exact answers: device-cache hits
    hits = {}
    for m in STREAM_QUERIES:
        runner = tsdb.new_query_runner()
        hits[m] = runner.run(_query(m))
        if runner.exec_stats.get("deviceCacheHit") != 1.0:
            checks.failures.append("stream: %s did not hit" % m)
    _same_answer(checks, "cold streamed " + STREAM_QUERIES[0], cold,
                 hits[STREAM_QUERIES[0]], exact=False)

    tsdb.device_cache = None
    streamed = {}
    for m in STREAM_QUERIES:
        res, wall, sp = _timed_query(tsdb, m)
        streamed[m] = (res, wall, sp)
        print("stream e2e %-34s wall %.1f ms (median of 3) | %d chunks | "
              "build %.1f stream %.1f (pack %.1f h2d %.1f fold kernels "
              "%.1f) finish+tail %.1f extract %.1f ms | host chunk bytes "
              "%.1f MB against the batch's %.3f GB | %.3e points/s"
              % (m, wall, sp.get("streamedChunks", 0), sp["buildMs"],
                 sp["streamMs"], sp.get("streamPackMs", 0.0),
                 sp.get("streamH2dMs", 0.0), sp.get("streamFoldMs", 0.0),
                 sp["kernelsMs"], sp["extractMs"],
                 sp.get("streamHostBytes", 0.0) / 1e6, batch_bytes / 1e9,
                 S * N / (wall / 1e3)))
        if not sp.get("streamedChunks"):
            checks.failures.append("stream: %s did not stream" % m)
    launches = dict(kernels.LAUNCHES)
    print("stream launches %s" % json.dumps(launches))
    for name in ("stream_fold", "sketch_fold", "stream_finish"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the main "
                                   "path" % name)

    # the materialized miss beside it (threshold raised)
    cfg.override_config(key, MATERIALIZE[key])
    for m in STREAM_QUERIES:
        _, wall, sp = _timed_query(tsdb, m)
        print("stream miss %-34s materialized wall %.1f ms (median of 3) | "
              "build %.1f h2d %.1f kernels %.1f extract %.1f ms | streamed "
              "%.1f ms" % (m, wall, sp["buildMs"], sp["h2dMs"],
                           sp["kernelsMs"], sp["extractMs"],
                           streamed[m][1]))
    # p95 with the sketch off takes the materialized route: exact
    cfg.override_config(key, DEFAULTS[key])
    cfg.override_config("tsd.query.streaming.sketch_percentiles", "false")
    runner = tsdb.new_query_runner()
    exact_p95 = runner.run(_query("sum:1h-p95:m{group=*}"))
    if runner.exec_stats.get("streamedChunks"):
        checks.failures.append("stream: p95 streamed with the sketch off")
    _same_answer(checks, "p95 sketch off", exact_p95,
                 hits["sum:1h-p95:m{group=*}"], exact=True)
    cfg.override_config("tsd.query.streaming.sketch_percentiles", "true")
    tsdb.device_cache = cache

    for m in STREAM_QUERIES:
        if "p95" in m:
            continue
        exact = any(f in m for f in (":1h-count:", ":1h-max:", ":1h-first:"))
        _same_answer(checks, "streamed " + m, streamed[m][0], hits[m], exact)

    # p95 through the sketch: each member's estimate lies between its
    # exact quantiles at p -/+ (C / 2K + 1 / K), C the merges a cell took
    windows = ds.FixedWindows.for_range(START, END, INTERVAL_MS)
    n_chunk = pad_pow2(max(1024, int(DEFAULTS[
        "tsd.query.streaming.chunk_points"]) // S))
    merges = 1
    for s in tsdb.store.series_for_metric(tsdb.metrics.get_id("m")):
        tsb = s.window_stride_timestamps(START, END, n_chunk)
        wids = (tsb - windows.first_window_ms) // INTERVAL_MS
        merges = max(merges, int(np.unique(wids, return_counts=True)[1]
                                 .max()) + 1)
    delta = merges / (2.0 * SKETCH_K) + 1.0 / SKETCH_K
    lo, hi, series = _exact_cell_quantiles(tsdb, windows, 0.95, delta)
    group_of = {}
    for i, s in enumerate(series):
        tags = tsdb.resolve_key_tags(s.key)
        group_of.setdefault(tags["group"], []).append(i)
    m = "sum:1h-p95:m{group=*}"
    worst, outside, rel_to_hit = 0.0, 0, 0.0
    wts = windows.first_window_ms + np.arange(windows.count) * INTERVAL_MS
    for r, hr in zip(streamed[m][0], hits[m]):
        rows = group_of[r.tags["group"]]
        glo = np.nansum(lo[rows], axis=0)
        ghi = np.nansum(hi[rows], axis=0)
        for (t_ms, v), (_, hv) in zip(r.dps, hr.dps):
            j = int(np.searchsorted(wts, t_ms))
            span = max(ghi[j] - glo[j], 1e-12)
            if not glo[j] - 1e-9 <= v <= ghi[j] + 1e-9:
                outside += 1
            worst = max(worst, abs(v - hv) / span)
            rel_to_hit = max(rel_to_hit, abs(v - hv) / max(abs(hv), 1e-12))
    print("stream p95 sketch: %d merges a cell at most, rank bound %.4f; "
          "%d answers outside the exact [p-%.4f, p+%.4f] bounds; largest "
          "difference to the hit's p95 (the LEGACY estimator) %.3e "
          "relative, %.3f of the bound's width" % (
              merges, delta, outside, delta, delta, rel_to_hit, worst))
    if outside:
        checks.failures.append("stream: p95 sketch outside its rank bound")
    return launches


def _same_answer(checks, label, got, want, exact: bool) -> None:
    same_shape = [(a.tags, [t for t, _ in a.dps]) for a in got] \
        == [(b.tags, [t for t, _ in b.dps]) for b in want]
    if not same_shape:
        checks.failures.append("%s: groups or timestamps differ" % label)
        return
    g = torch.tensor([v for a in got for _, v in a.dps], dtype=torch.float64)
    w = torch.tensor([v for b in want for _, v in b.dps], dtype=torch.float64)
    if exact:
        checks.exact("e2e", label, g, w, "values")
        print("%-15s %-44s %s" % ("e2e", label, "exact" if torch.equal(g, w)
                                  else "DIFFERENT"))
    else:
        checks.values("e2e", label, g, w)


def config_phase(dev, cid: int, checks: Checks, seed: int) -> None:
    """Phase 13: BASELINE config `cid` at full size through a
    StreamAccumulator, chunks made on the host and copied through a
    ChunkFeed, each grid held to a one-shot K1 over the same data."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import streaming as st
    from opentsdb_tpu_torch.ops.pipeline import (DownsampleStep,
                                                 PipelineSpec, run_grid_tail)
    from opentsdb_tpu_torch.ops.rate import RateOptions

    cfg = CONFIGS[cid]
    s, chunks, interval = cfg["s"], cfg["chunks"], cfg["interval"]
    total = s * C_CHUNK * chunks
    windows = ds.FixedWindows.for_range(
        C_START, C_START + C_CHUNK * chunks * C_STEP, interval)
    wslice = (C_CHUNK * C_STEP + 4_000) // interval + 2
    acc = st.StreamAccumulator.create(s, windows, dev,
                                      lanes=st.lanes_for(cfg["fns"]),
                                      window_slice=wslice)
    feed = st.ChunkFeed(dev, s, C_CHUNK)
    # the one-shot batch, assembled on the card from the copied chunks
    batch = [torch.empty((s, C_CHUNK * chunks), dtype=dt, device=dev)
             for dt in (torch.int64, torch.float64, torch.bool)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(chunks):
        _config_chunk(feed.take(), s, k * C_CHUNK, seed)
        d = feed.upload()
        w0 = (C_START + k * C_CHUNK * C_STEP - windows.first_window_ms) \
            // interval
        acc.update(*d, w0=w0)
        feed.folded()
        for b, x in zip(batch, d):
            b[:, k * C_CHUNK:(k + 1) * C_CHUNK].copy_(x)
    oob = acc.oob_count()
    wall = time.perf_counter() - t0
    h2d, fold = feed.timings()
    print("config %d: %d series x %d points (%d chunks of %d), W = %d "
          "%d s windows, slice %d | wall %.3f s, %.3e points/s (%.3e over "
          "the card's copies and folds alone) | host make %.1f ms a chunk, "
          "copy %.3f ms a chunk (%.1f MB, %.1f GB/s), fold %.3f ms a chunk "
          "| oob %d"
          % (cid, s, C_CHUNK * chunks, chunks, C_CHUNK, windows.count,
             interval // 1000, acc.window_slice, wall, total / wall,
             total / max((h2d + fold) / 1e3, 1e-12),
             feed.pack_ms / chunks, h2d / chunks, s * C_CHUNK * 17 / 1e6,
             s * C_CHUNK * 17 / max(h2d / chunks / 1e3, 1e-12) / 1e9,
             fold / chunks,
             oob))
    if oob:
        checks.failures.append("config %d: %d points outside their slices"
                               % (cid, oob))
    edges = windows.window_edges(dev)
    grids = {}
    for fn in cfg["fns"]:
        t1 = time.perf_counter()
        wts, got, gm = acc.finish(fn)
        torch.cuda.synchronize()
        finish_ms = (time.perf_counter() - t1) * 1e3
        want, wm = ds.window_moments(*batch, edges, fn)
        case = "config %d %s" % (cid, fn)
        checks.exact("stream_finish", case, gm, wm)
        if fn in ("min", "max", "count"):     # exact (NaN where empty)
            checks.values("stream_fold", case, got, want, 0.0, 0.0)
        else:
            checks.values("stream_fold", case, got, want)
        print("config %d %-5s finish %.2f ms, grid against one-shot K1 %s"
              % (cid, fn, finish_ms, "checked"))
        grids[fn] = (wts, got, gm, want, wm)
    del batch
    if cid == 4:
        spec = PipelineSpec("p99", DownsampleStep("avg"),
                            rate=RateOptions())
        gid = np.zeros(s, np.int64)
        wts, got, gm, want, wm = grids["avg"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tail = run_grid_tail(spec, wts, got, gm, gid, 1)
        torch.cuda.synchronize()
        tail_ms = (time.perf_counter() - t1) * 1e3
        ref = run_grid_tail(spec, wts, want, wm, gid, 1)
        checks.exact("e2e", "config 4 rate+p99 mask", tail[2], ref[2])
        checks.values("e2e", "config 4 rate+p99", tail[1], ref[1])
        print("config 4 rate + p99 tail %.2f ms on the streamed grid"
              % tail_ms)
    del grids, acc, feed


def _fold_tiles(tiling, spec, wts, v, m, gid, rows, mode, plain=False):
    """K2, then T1 (or its plain version) in `mode` over the [rows]-row
    tiles of the grid -> the [GROUPS, W] partial moments."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    acc = tiling.new_lane_fold(GROUPS, v.shape[1], mode, v.device)
    fold = tiling.tile_partials_plain if plain else tiling.tile_partials
    for lo in range(0, v.shape[0], rows):
        contrib, part, actual = tiling.tile_contrib(spec, wts, v[lo:lo + rows],
                                                    m[lo:lo + rows])
        fold(contrib, part, actual, ga.group_offsets(
            gid[lo:lo + rows], GROUPS).to(v.device), acc)
    return acc


def tile_kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    """Phase 14: T1 tile_partials against its plain version on the card:
    256-row tiles of the headline batch's K1 grid at 1m windows, holes
    masked, through K2."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import tiling
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    from opentsdb_tpu_torch.ops.rate import RateOptions

    rows = 256
    d_ts = torch.from_numpy(ts).to(dev)
    d_h = torch.from_numpy(h).to(dev)
    cols = torch.arange(N, device=dev)[None, :]
    rix = torch.arange(S, device=dev)[:, None]
    # holes: one slot in eleven, and a run of 512 slots in thirteen a row
    # (hours of empty 1m windows, which K2 fills by interpolation)
    mask = (d_h % 11 != 0) & ((cols // 512) % 13 != rix % 13)
    plan = ds.FixedWindows.for_range(START, END, 60_000)
    edges = plan.window_edges(dev)
    w = plan.count
    v, m = ds.window_moments(d_ts, torch.from_numpy(val).to(dev), mask,
                             edges, "sum")
    mi, mim = ds.window_moments(d_ts, (d_h % 1_000).double(), mask, edges,
                                "sum")
    del d_h, cols, rix, mask
    wts = edges[:-1]
    offsets = ga.group_offsets(gid, GROUPS).to(dev)
    print("tile_partials grid [%d, %d] (1m windows), %.1f%% of cells empty"
          % (S, w, 100.0 * float((~m).double().mean())))
    for rate in (None, RateOptions()):
        for mode, aggs in (("additive", ("sum", "count", "avg")),
                           ("extreme", ("min", "max"))):
            spec = PipelineSpec(aggs[0], rate=rate)
            got = _fold_tiles(tiling, spec, wts, v, m, gid, rows, mode)
            want = _fold_tiles(tiling, spec, wts, v, m, gid, rows, mode,
                               plain=True)
            case = "%s%s" % (mode, " rate" if rate is not None else "")
            for lane in want:
                if lane == "tot":
                    checks.values("tile_partials", case + " tot", got[lane],
                                  want[lane])
                else:
                    checks.exact("tile_partials", case + " " + lane,
                                 got[lane], want[lane], lane)
            for agg in aggs:
                out, mask_g = tiling.finish_lane_fold(got, agg)
                pout, pmask = tiling.finish_lane_fold(want, agg)
                checks.exact("tile_partials", "%s %s mask" % (case, agg),
                             mask_g, pmask)
                checks.values("tile_partials", "%s %s" % (case, agg), out,
                              pout, rtol=RTOL if agg in ("sum", "avg")
                              else 0.0, atol=ATOL if agg in ("sum", "avg")
                              else 0.0)
    # the integer metric: the fold of four tiles is K3 over the whole grid
    for agg in ("sum", "count", "avg", "min", "max"):
        spec = PipelineSpec(agg)
        acc = _fold_tiles(tiling, spec, wts, mi, mim, gid, rows,
                          tiling.lane_mode(agg))
        out, mask_g = tiling.finish_lane_fold(acc, agg)
        contrib, part, actual = tiling.tile_contrib(spec, wts, mi, mim)
        want, want_mask = ga.group_moments(agg, contrib, part, actual,
                                           offsets)
        label = "mi fold vs K3 %s" % agg
        # limits of 0: equal bit for bit, NaN where K3 gives NaN
        checks.values("tile_partials", label, out, want, rtol=0.0,
                      atol=0.0)
        checks.exact("tile_partials", label + " mask", mask_g, want_mask)
    # one tile's launch, as the striped lane fold makes it (additive)
    spec = PipelineSpec("sum")
    contrib, part, actual = tiling.tile_contrib(spec, wts, v[:rows],
                                                m[:rows])
    t_off = ga.group_offsets(gid[:rows], GROUPS).to(dev)
    g_tile = int(np.unique(gid[:rows]).size)
    times = {}
    for mode in ("additive", "extreme"):
        acc = tiling.new_lane_fold(GROUPS, w, mode, dev)
        ok = part & ~torch.isnan(contrib)
        grows = torch.from_numpy(gid[:rows]).to(dev)
        if mode == "extreme":
            idx = grows[:, None].expand(-1, w)
            lo_src = torch.where(ok, contrib, math.inf)
            hi_src = torch.where(ok, contrib, -math.inf)

            def library():
                acc["lo"].scatter_reduce_(0, idx, lo_src, "amin")
                acc["hi"].scatter_reduce_(0, idx, hi_src, "amax")
            lanes = 32
            what = "scatter_reduce amin and amax"
        else:
            stacked = torch.cat([torch.where(ok, contrib, 0.0),
                                 ok.double(), actual.double()], dim=1)
            into = torch.zeros((GROUPS, 3 * w), dtype=torch.float64,
                               device=dev)

            def library():
                into.index_add_(0, grows, stacked)
            lanes = 24
            what = "index_add_ of sums, counts and presence"
        ms, dms = both_ms(lambda: tiling.tile_partials(contrib, part, actual,
                                                       t_off, acc))
        lib, lib_dms = both_ms(library)
        t = {
            "ms": ms, "device_ms": dms,
            "plain_ms": time_ms(lambda: tiling.tile_partials_plain(
                contrib, part, actual, t_off, acc)),
            # the tile's cells read once (10 B), the accumulators of the
            # groups it holds read and written once
            "bound_ms": bound_ms(rows * w * 10 + 2 * g_tile * w * lanes,
                                 2.0 * rows * w),
            "library_ms": lib, "library_device_ms": lib_dms,
        }
        print("time tile_partials %s tile [%d, %d], %d groups: kernel %.4f "
              "ms (device %s)  plain %.4f ms  bound %.4f ms (bytes)  library "
              "%.4f ms (device %s; %s)"
              % (mode, rows, w, g_tile, t["ms"], _fmt(dms), t["plain_ms"],
                 t["bound_ms"], t["library_ms"], _fmt(lib_dms), what))
        times[mode] = t
    return {"tile_partials": times["additive"]}


def _fresh_pool(tsdb, host_mb: int | None = None):
    """A spill pool of the TSDB's configured budgets (host_mb overridden):
    a daemon's shutdown closes the TSDB's own."""
    from opentsdb_tpu_torch.storage.spill import SpillPool
    cfg = tsdb.config
    return SpillPool((cfg.get_int("tsd.query.spill.host_mb")
                      if host_mb is None else host_mb) * 2 ** 20,
                     cfg.get_int("tsd.query.spill.disk_mb") * 2 ** 20)


def _tiled_run(tsdb, m):
    """(answer, wall ms, exec_stats) of one run after a warm-up."""
    tsdb.new_query_runner().run(_query(m))
    runner = tsdb.new_query_runner()
    t0 = time.perf_counter()
    res = runner.run(_query(m))
    return res, (time.perf_counter() - t0) * 1e3, dict(runner.exec_stats)


def _print_tiled(label, m, wall, st):
    overhead = sum(st.get(k, 0.0) for k in ("tileContribMs", "spillWriteMs",
                                            "spillReadMs", "replayMs"))
    print("tiled %-5s %-34s wall %.1f ms | %d tiles %d stripes (%d "
          "planned), %.1f MB spilled, %d chunks | tile grids %.1f (pack "
          "%.1f h2d %.1f fold %.1f) K2+copy %.1f pool write %.1f pool read "
          "%.1f stripe replay %.1f extract %.1f ms | overhead %.1f ms, "
          "predicted %.1f ms"
          % (label, m, wall, st.get("tiledTiles", 0),
             st.get("tiledStripes", 0), st.get("tiledStripesPlanned", 0),
             st.get("spillBytes", 0) / 1e6,
             st.get("streamedChunks", 0), st.get("tileGridMs", 0.0),
             st.get("streamPackMs", 0.0), st.get("streamH2dMs", 0.0),
             st.get("streamFoldMs", 0.0), st.get("tileContribMs", 0.0),
             st.get("spillWriteMs", 0.0), st.get("spillReadMs", 0.0),
             st.get("replayMs", 0.0), st.get("extractMs", 0.0), overhead,
             st.get("tiledPredictedMs", 0.0)))


def tiled_e2e_phase(dev, tsdb, checks: Checks) -> tuple[dict, dict]:
    """Phase 15 (a) and (b): out-of-core grouped queries on the headline
    TSDB, the device cache detached so that tiles stream.  Returns
    (launches, the measured tiled cost constants)."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.ops.streaming import SKETCH_K, pad_pow2
    from opentsdb_tpu_torch.query.limits import QueryException
    from opentsdb_tpu_torch.utils.config import DEFAULTS

    cfg = tsdb.config
    budget_key = "tsd.query.streaming.state_mb"
    threshold_key = "tsd.query.streaming.point_threshold"
    threshold = cfg.get_string(threshold_key)
    cfg.override_config(threshold_key, DEFAULTS[threshold_key])
    cache = tsdb.device_cache
    tsdb.device_cache = None
    tsdb.spill_pool = _fresh_pool(tsdb)
    kernels.reset_launches()
    spill_mb, write_ms, read_ms, stripe_ms = 0.0, 0.0, 0.0, []

    def account(st):
        nonlocal spill_mb, write_ms, read_ms
        spill_mb += st["spillBytes"] / 2.0 ** 20
        write_ms += st["tileContribMs"] + st["spillWriteMs"]
        read_ms += st["spillReadMs"]

    # (a) the default budget: p95 through the sketch, 8.9 GB of state
    m = "sum:1m-p95:m{group=*}"
    res, wall, st = _tiled_run(tsdb, m)
    _print_tiled("(a)", m, wall, st)
    if st.get("tiledExecution") != 1.0 or st.get("tiledTiles") != 2 \
            or st.get("tiledStripes") != 1:
        checks.failures.append("tiled (a): %s was not tiled in 2 tiles and "
                               "1 stripe" % m)
    account(st)
    cfg.override_config(budget_key, "65536")
    resident, r_wall, r_st = _tiled_run(tsdb, m)
    cfg.override_config(budget_key, DEFAULTS[budget_key])
    print("tiled (a) %s resident streamed at state_mb 65536: wall %.1f ms, "
          "%d chunks" % (m, r_wall, r_st.get("streamedChunks", 0)))
    windows = ds.FixedWindows.for_range(START, END, 60_000)
    merges = 1
    for n_chunk in {pad_pow2(max(1024, int(DEFAULTS[
            "tsd.query.streaming.chunk_points"]) // rows))
            for rows in (S, -(-S // 2))}:
        for s in tsdb.store.series_for_metric(tsdb.metrics.get_id("m")):
            tsb = s.window_stride_timestamps(START, END, n_chunk)
            wids = (tsb - windows.first_window_ms) // 60_000
            merges = max(merges, int(np.unique(wids, return_counts=True)[1]
                                     .max()) + 1)
    delta = merges / (2.0 * SKETCH_K) + 1.0 / SKETCH_K
    lo, hi, series = _exact_cell_quantiles(tsdb, windows, 0.95, delta)
    group_of = {}
    for i, s in enumerate(series):
        group_of.setdefault(tsdb.resolve_key_tags(s.key)["group"],
                            []).append(i)
    wts = windows.first_window_ms + np.arange(windows.count) * 60_000
    outside, worst = 0, 0.0
    for answer in (res, resident):
        for r in answer:
            rows = group_of[r.tags["group"]]
            glo = np.nansum(lo[rows], axis=0)
            ghi = np.nansum(hi[rows], axis=0)
            t_ms = np.array([t for t, _ in r.dps], np.int64)
            v = np.array([x for _, x in r.dps], np.float64)
            j = np.searchsorted(wts, t_ms)
            # the sketch is float32: its rounding beside the bounds
            slack = SKETCH_ATOL + SKETCH_RTOL * np.abs(v)
            outside += int(np.sum((v < glo[j] - slack)
                                  | (v > ghi[j] + slack)))
    for a, b in zip(res, resident):
        x = np.array([v for _, v in a.dps], np.float64)
        y = np.array([v for _, v in b.dps], np.float64)
        if len(x) == len(y) and len(x):
            worst = max(worst, float(np.max(np.abs(x - y)
                                            / np.maximum(np.abs(y), 1e-12))))
    print("tiled (a) p95 sketch: %d merges a cell at most, rank bound "
          "%.4f; %d answers (tiled and resident) outside the exact bounds "
          "(float32 slack); tiled vs resident %.3e relative at most"
          % (merges, delta, outside, worst))
    if outside or [(r.tags, [t for t, _ in r.dps]) for r in res] \
            != [(r.tags, [t for t, _ in r.dps]) for r in resident]:
        checks.failures.append("tiled (a): p95 outside its rank bound or "
                               "groups differ")
    del lo, hi, resident

    # (b) state_mb 255: four tiles and four stripes each, planned on the
    # padded windows; the real windows run the stripes they reach
    stripes_run = -(-windows.count // (pad_pow2(windows.count) // 4))
    queries = ["sum:1m-avg:m{group=*}", "count:1m-count:m{group=*}",
               "sum:1m-max:rate:m{group=*}", "dev:1m-avg:m{group=*}",
               "p99:1m-avg:m{group=*}", "movingAverage5:1m-sum:m{group=*}"]
    tiled = {}
    for m in queries:
        cfg.override_config(budget_key, TILED_MB)
        res, wall, st = _tiled_run(tsdb, m)
        cfg.override_config(budget_key, DEFAULTS[budget_key])
        _print_tiled("(b)", m, wall, st)
        account(st)
        if st.get("tiledExecution") != 1.0 or st.get("tiledTiles") != 4 \
                or st.get("tiledStripesPlanned") != 4 \
                or st.get("tiledStripes") != stripes_run:
            checks.failures.append(
                "tiled (b): %s took %s tiles and %s stripes (%s planned), "
                "not 4 and %d (4)" % (m, st.get("tiledTiles"),
                                      st.get("tiledStripes"),
                                      st.get("tiledStripesPlanned"),
                                      stripes_run))
        runner = tsdb.new_query_runner()
        t0 = time.perf_counter()
        want = runner.run(_query(m))
        r_wall = (time.perf_counter() - t0) * 1e3
        rst = runner.exec_stats
        print("tiled (b) %-34s resident at the default budget: wall %.1f ms "
              "(%s)" % (m, r_wall, "streamed" if rst.get("streamedChunks")
                        else "materialized"))
        exact = m.startswith(("count:", "sum:1m-max"))
        _same_answer(checks, "tiled " + m, res, want, exact)
        tiled[m] = res
        # a stripe's dispatch: its copy to the card and its reduce
        stripe_ms.append(st["replayMs"] / st["tiledStripes"])
    # the host ring at 64 MB: the stripes demote to disk, same answer
    m = queries[0]
    cfg.override_config(budget_key, TILED_MB)
    pool = tsdb.spill_pool
    tsdb.spill_pool = _fresh_pool(tsdb, host_mb=64)
    runner = tsdb.new_query_runner()
    t0 = time.perf_counter()
    small = runner.run(_query(m))
    wall = (time.perf_counter() - t0) * 1e3
    pst = tsdb.spill_pool.collect_stats()
    _print_tiled("64MB", m, wall, runner.exec_stats)
    print("tiled host_mb 64: %d entries demoted to disk, %d disk reads"
          % (pst["tsd.query.spill.evictions"], pst["tsd.query.spill.reads"]))
    if pst["tsd.query.spill.evictions"] < 1:
        checks.failures.append("tiled: host_mb 64 demoted nothing")
    _same_answer(checks, "tiled host_mb 64 " + m, small, tiled[m], True)
    tsdb.spill_pool.close()
    # the pool off: the reference's 413
    tsdb.spill_pool = None
    try:
        tsdb.new_query_runner().run(_query(m))
        status = 200
    except QueryException as e:
        status = e.status
    print("tiled spill disabled: %s answers %d" % (m, status))
    if status != 413:
        checks.failures.append("tiled: spill off gave %d, not 413" % status)
    # one query with the cache attached: tiles from G1 gathers
    tsdb.spill_pool = pool
    tsdb.device_cache = cache
    res, wall, st = _tiled_run(tsdb, m)
    _print_tiled("(hit)", m, wall, st)
    if st.get("tiledCacheHits") != 4:
        checks.failures.append("tiled: cache-hit tiles %s, not 4"
                               % st.get("tiledCacheHits"))
    _same_answer(checks, "tiled cache-hit tiles " + m, res, tiled[m], False)
    cfg.override_config(budget_key, DEFAULTS[budget_key])
    cfg.override_config(threshold_key, threshold)
    launches = dict(kernels.LAUNCHES)
    print("tiled launches %s" % json.dumps(launches))
    tsdb.spill_pool.close()
    # the pool's round trip per MB (K2's grids copied to the host and
    # put; stripes assembled), and a stripe replay's cost
    costs = {"spill_write_mb": write_ms / 1e3 / spill_mb,
             "spill_read_mb": read_ms / 1e3 / spill_mb,
             "tile_dispatch": statistics.median(stripe_ms) / 1e3}
    return launches, costs


def striped_lane_phase(dev, tsdb, checks: Checks) -> dict:
    """Phase 15 (c): striped rollup-lane serving on phase 10's TSDB, 1m
    lanes built for m and mi; each query in its mode, held to the exact
    answer (lanes detached, the device cache's hit)."""
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.storage.rollup import RollupLanes
    from opentsdb_tpu_torch.utils.config import DEFAULTS

    cfg = tsdb.config
    lanes_1h = tsdb.rollup_lanes
    cfg.override_config("tsd.rollup.intervals", "1m")
    cfg.override_config("tsd.rollup.mb", "2048")
    lanes = RollupLanes(cfg, dev)
    tsdb.store.add_mutation_listener(lanes.note_mutation)
    tsdb.rollup_lanes = lanes
    tsdb.spill_pool = _fresh_pool(tsdb)
    # every 1m window holds points of every series (the cadence leaves at
    # most 20.5 s between two): the dense grid that the reference folds
    # on the host and the port on the device.  The range ends on the
    # last ms of the last window the data fills.
    end = START + ((N - 1) * STEP_MS // 60_000) * 60_000 - 1
    modes = [("sum:1m-sum:rollup_raw:%s{group=*}", "rollupFoldDevice"),
             ("sum:1m-sum:rate:rollup_raw:%s{group=*}", "rollupFoldDevice"),
             ("dev:1m-avg:rollup_raw:%s{group=*}", "rollupFoldReplay")]
    for q, _ in modes:
        for metric in ("m", "mi"):
            tsdb.new_query_runner().run(_query(q % metric, end=end))
    t0 = time.perf_counter()
    built = 0
    while True:
        n = lanes.refresh(tsdb.store, max_blocks=1024)
        built += n
        if not n:
            break
    print("striped 1m lanes: %d blocks built in %.1f s, %.1f MB"
          % (built, time.perf_counter() - t0,
             lanes.collect_stats()["tsd.query.rollup.bytes"] / 1e6))
    kernels.reset_launches()
    for q, mode in modes:
        for metric in ("m", "mi"):
            m = q % metric
            cfg.override_config("tsd.query.streaming.state_mb",
                                STRIPED_MB[metric])
            before = kernels.LAUNCHES["tile_partials"]
            runner = tsdb.new_query_runner()
            t0 = time.perf_counter()
            served = runner.run(_query(m, end=end))
            wall = (time.perf_counter() - t0) * 1e3
            st = runner.exec_stats
            t1 = kernels.LAUNCHES["tile_partials"] - before
            cfg.override_config("tsd.query.streaming.state_mb",
                                DEFAULTS["tsd.query.streaming.state_mb"])
            tsdb.rollup_lanes = None
            exact = tsdb.new_query_runner().run(_query(m, end=end))
            tsdb.rollup_lanes = lanes
            print("striped %-40s state_mb %s wall %.1f ms | %s | T1 "
                  "launches %d | build %.1f kernels %.1f extract %.1f ms"
                  % (m, STRIPED_MB[metric], wall,
                     " ".join(k for k in st if k.startswith("rollup")), t1,
                     st["buildMs"], st["kernelsMs"], st["extractMs"]))
            if st.get("rollupLaneStriped") != 1.0 or st.get(mode) != 1.0 \
                    or (mode == "rollupFoldDevice") != (t1 > 0):
                checks.failures.append("striped: %s did not take %s" % (
                    m, mode))
            _same(checks, "striped " + m, served, exact, metric == "mi")
    launches = dict(kernels.LAUNCHES)
    print("striped launches %s" % json.dumps(launches))
    if launches["tile_partials"] < 1:
        checks.failures.append("kernel tile_partials never launched on "
                               "the striped lane path")
    tsdb.rollup_lanes = lanes_1h
    tsdb.spill_pool.close()
    return launches


# Phase 16: the dashboard fleet.  FLEET_Q members a stacked dispatch; the
# reference's dispatch-layer panel (tools/bench_qps.py:66-67) and a
# headline panel (one group of the headline batch over its last hour).
FLEET_Q = 16
MINUTE_MS = 60_000
DL_S, DL_N, DL_W = 1, 128, 16
PANEL_S, PANEL_W = 10, 60
FLEET_FORMS = ("sum:1m-avg:m{group=%s}", "max:1m-max:rate:m{group=%s}")
ORDER_FORM = "p99:1m-p95:m{group=%s}"
FLEET_THREADS, FLEET_WARMUP_S, FLEET_WINDOW_S = 16, 3.0, 8.0


def _fleet_members(shape: str, ts, val, seed: int):
    """FLEET_Q members of one panel shape, each with its own range: host
    (ts, val, mask) [S, N], gid [S] and edges [W+1]."""
    from opentsdb_tpu_torch.ops.pipeline import PAD_TS
    from opentsdb_tpu_torch.ops.streaming import pad_pow2
    rng = np.random.default_rng(seed)
    out = []
    for q in range(FLEET_Q):
        if shape == "dispatch":
            base = START + q * DL_W * MINUTE_MS
            step = DL_W * MINUTE_MS // DL_N
            m_ts = (base + np.arange(DL_N, dtype=np.int64) * step
                    + rng.integers(0, step // 2, DL_N))[None, :]
            m_val = rng.normal(100.0, 5.0, (DL_S, DL_N))
            m_mask = np.ones((DL_S, DL_N), bool)
            edges = base + np.arange(DL_W + 1, dtype=np.int64) * MINUTE_MS
        else:
            last = END - END % MINUTE_MS - q * MINUTE_MS
            edges = last - PANEL_W * MINUTE_MS + np.arange(
                PANEL_W + 1, dtype=np.int64) * MINUTE_MS
            rows = np.arange(q * 10, q * 10 + PANEL_S)
            bounds = [np.searchsorted(ts[r], [edges[0], edges[-1]])
                      for r in rows]
            n = pad_pow2(max(hi - lo for lo, hi in bounds))
            m_ts = np.full((PANEL_S, n), PAD_TS, np.int64)
            m_val = np.zeros((PANEL_S, n))
            m_mask = np.zeros((PANEL_S, n), bool)
            for i, (r, (lo, hi)) in enumerate(zip(rows, bounds)):
                m_ts[i, :hi - lo] = ts[r, lo:hi]
                m_val[i, :hi - lo] = val[r, lo:hi]
                m_mask[i, :hi - lo] = True
        out.append((m_ts, m_val, m_mask,
                    np.zeros(m_ts.shape[0], np.int64), edges))
    return out


def _stacked_args(members, dev):
    """The stacked operands of `members` on `dev`: ts, val, mask [Q*S, N],
    gid [Q, S], the group counts, edges [Q, W+1]."""
    d = [torch.from_numpy(np.concatenate([m[i] for m in members])).to(dev)
         for i in range(3)]
    return (*d, np.stack([m[3] for m in members]), [1] * len(members),
            torch.from_numpy(np.stack([m[4] for m in members])).to(dev))


def _host_wall_ms(fn, reps: int = 21) -> float:
    """Median host-clock wall of `fn` (which ends synchronised)."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def _stacked_edge_checks(dev, checks: Checks) -> None:
    """The stacked K2 at chunk-edge widths: 16 members of 10 rows, each
    member's own window timestamps and k2_edge_grid's rows, under every
    policy and rate option set, against the plain version (masks exact,
    values at rtol 1e-9) and each member's rows bit for bit its solo
    call's."""
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops.rate import RateOptions
    for w in (16, 60, 128, 129, 1025):
        grids = [k2_edge_grid(np.random.default_rng(100 + q), 10, w, dev,
                              START + q * 7_000) for q in range(FLEET_Q)]
        wts = torch.stack([g[0] for g in grids])
        v = torch.cat([g[1] for g in grids])
        m = torch.cat([g[2] for g in grids])
        per = v.shape[0] // FLEET_Q
        same = True
        for policy in POLICIES:
            for rname, rargs in RATE_SETS.items():
                opts = None if rargs is None else RateOptions(*rargs)
                got = ga.grid_fill_rate(wts, v, m, policy, opts)
                want = ga.grid_fill_rate_plain(wts, v, m, policy, opts)
                case = "edges [%d x %d, %d] %s rate=%s" % (
                    FLEET_Q, per, w, policy, rname)
                checks.exact("grid_fill_rate.stacked", case, got[1], want[1])
                checks.exact("grid_fill_rate.stacked", case, got[2], want[2])
                checks.values("grid_fill_rate.stacked", case, got[0],
                              want[0])
                for q, (g_wts, g_v, g_m) in enumerate(grids):
                    solo = ga.grid_fill_rate(g_wts, g_v, g_m, policy, opts)
                    for a, b in zip(got, solo):
                        a = a[q * per:(q + 1) * per]
                        same &= torch.equal(
                            a.view(torch.int64) if a.is_floating_point()
                            else a,
                            b.view(torch.int64) if b.is_floating_point()
                            else b)
        checks.exact("grid_fill_rate.stacked",
                     "edges W=%d vs %d solo" % (w, FLEET_Q),
                     torch.tensor(same), torch.tensor(True), "bits")
        print("stacked K2 edges W=%-5d rows vs %d solo calls: %s"
              % (w, FLEET_Q, "bit for bit" if same else "DIFFERENT"))


def stacked_kernel_phase(dev, ts, val, checks: Checks) -> tuple[dict, dict]:
    """Phase 16 (a): the member-strided K1, K4 and K2 and the stacked
    pipeline at Q = 16 for two panel shapes, against their plain versions
    and against 16 solo dispatches (bit for bit); one stacked dispatch
    against 16 solo ones on CUDA events and on the host clock.  Returns
    the stacked forms' times and the stacked-dispatch cost constants."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.ops import pipeline as pl
    from opentsdb_tpu_torch.ops.rate import RateOptions
    from types import SimpleNamespace
    from opentsdb_tpu_torch.query.batcher import DispatchBatcher, _Member
    from opentsdb_tpu_torch.utils.config import Config

    specs = {
        "sum:avg": pl.PipelineSpec("sum", pl.DownsampleStep("avg")),
        "max:max:rate": pl.PipelineSpec("max", pl.DownsampleStep("max"),
                                        RateOptions()),
        "p99:p95": pl.PipelineSpec("p99", pl.DownsampleStep("p95")),
    }
    # the batcher's own dispatch, on a TSDB that is only its device
    batcher = DispatchBatcher(Config(), SimpleNamespace(device=dev))
    walls, times = {}, {}
    for shape in ("dispatch", "headline"):
        members = _fleet_members(shape, ts, val, 16)
        s, n = members[0][0].shape
        w = members[0][4].size - 1
        d_ts, d_val, d_mask, gid, groups, d_edges = _stacked_args(members,
                                                                  dev)
        solo_args = [_stacked_args([m], dev) for m in members]
        label = "%s [%d x %d x %d] x %d" % (shape, s, n, w, FLEET_Q)
        for sname, spec in specs.items():
            kernels.reset_launches()
            got = pl.stacked_group_outputs(spec, d_ts, d_val, d_mask, gid,
                                           groups, d_edges)
            torch.cuda.synchronize()
            fired = {k: v for k, v in kernels.LAUNCHES.items() if v}
            k1 = "window_order" if sname == "p99:p95" else "window_moments"
            k3 = "group_order" if sname == "p99:p95" else "group_moments"
            want = {k1: 1, k1 + ".stacked": 1, "grid_fill_rate": 1,
                    "grid_fill_rate.stacked": 1, k3: 1}
            print("stacked %-24s %-13s launches %s"
                  % (label, sname, json.dumps(fired)))
            if fired != want:
                checks.failures.append("stacked %s %s: launches %s, not %s"
                                       % (label, sname, fired, want))
            plain = pl.stacked_group_outputs(
                spec, *(x.cpu() for x in (d_ts, d_val, d_mask)), gid,
                groups, d_edges.cpu())
            case = "%s %s vs plain" % (label, sname)
            checks.exact("stacked_pipeline", case, got[2], plain[2])
            checks.values("stacked_pipeline", case, got[1], plain[1])
            # each member's slice is its solo dispatch's, bit for bit
            same = True
            for q, (mine, args) in enumerate(zip(
                    pl.split_members(got, groups), solo_args)):
                solo = pl.run_group_pipeline(
                    spec, args[0], args[1], args[2], args[3][0], 1,
                    args[5][0])
                for a, b in zip(mine, solo):
                    same &= torch.equal(torch.nan_to_num(a, nan=7.25),
                                        torch.nan_to_num(b, nan=7.25))
            checks.exact("stacked_pipeline", "%s %s vs %d solo"
                          % (label, sname, FLEET_Q),
                          torch.tensor(same), torch.tensor(True),
                          "bits")
            print("stacked %-24s %-13s vs %d solo dispatches: %s"
                  % (label, sname, FLEET_Q,
                     "bit for bit" if same else "DIFFERENT"))

        # the member-strided kernels alone against their plain versions
        v, m = ds.window_moments(d_ts, d_val, d_mask, d_edges, "avg")
        pv, pm = ds.window_moments_plain(d_ts, d_val, d_mask, d_edges, "avg")
        checks.exact("window_moments.stacked", label, m, pm)
        checks.values("window_moments.stacked", label, v, pv)
        ov, om = ds.window_order(d_ts, d_val, d_mask, d_edges, "p95")
        pov, pom = ds.window_order_plain(d_ts, d_val, d_mask, d_edges, "p95")
        checks.exact("window_order.stacked", label, om, pom)
        checks.values("window_order.stacked", label, ov, pov)
        wts = d_edges[:, :-1].contiguous()
        for policy, rate in (("lerp", None), ("prev", RateOptions())):
            got2 = ga.grid_fill_rate(wts, v, m, policy, rate)
            want2 = ga.grid_fill_rate_plain(wts, v, m, policy, rate)
            case = "%s %s rate=%s" % (label, policy, rate is not None)
            checks.exact("grid_fill_rate.stacked", case, got2[1], want2[1])
            checks.exact("grid_fill_rate.stacked", case, got2[2], want2[2])
            checks.values("grid_fill_rate.stacked", case, got2[0],
                          want2[0])
        if shape == "headline":
            _stacked_edge_checks(dev, checks)
        offsets = pl.stacked_offsets(gid, groups).to(dev)
        c, part, pres = ga.grid_fill_rate(wts, v, m, "lerp")
        for agg, k3, plain3 in (("sum", ga.group_moments,
                                 ga.group_moments_plain),
                                ("p99", ga.group_order,
                                 ga.group_order_plain)):
            got3 = k3(agg, c, part, pres, offsets)
            want3 = plain3(agg, c, part, pres, offsets)
            name = "group_moments" if agg == "sum" else "group_order"
            checks.exact(name, "stacked " + label, got3[1], want3[1])
            checks.values(name, "stacked " + label, got3[0], want3[0])

        # one stacked dispatch against 16 solo ones: CUDA events (the
        # pipeline on operands already on the card) and the host clock
        # (the batcher's dispatch: host stack, copies, kernels, copy back)
        spec = specs["sum:avg"]
        stacked_ms = time_ms(lambda: pl.stacked_group_outputs(
            spec, d_ts, d_val, d_mask, gid, groups, d_edges))
        solo_ms = time_ms(lambda: [pl.run_group_pipeline(
            spec, a[0], a[1], a[2], a[3][0], 1, a[5][0]) for a in solo_args])
        offsets = pl.stacked_offsets(gid, groups).to(dev)

        def plain_pipeline():
            pv, pm = ds.window_moments_plain(d_ts, d_val, d_mask, d_edges,
                                             "avg")
            pc = ga.grid_fill_rate_plain(d_edges[:, :-1], pv, pm, "lerp")
            return ga.group_moments_plain("sum", *pc, offsets)

        plain_ms = time_ms(plain_pipeline)
        live = [_Member(*mb[:4], 1, mb[4], None) for mb in members]
        host_stacked = _host_wall_ms(lambda: batcher._dispatch(spec, live))
        host_solo = _host_wall_ms(lambda: [batcher._dispatch(spec, [mb])
                                           for mb in live])
        nbytes = (FLEET_Q * s * n * 17 + FLEET_Q * (w + 1) * 8
                  + FLEET_Q * s * 8 + FLEET_Q * w * 8 + FLEET_Q * w * 9)
        cells = FLEET_Q * (s * n + w)
        walls[shape] = (host_stacked, cells)
        print("stacked %-24s dispatch: CUDA events %.4f ms stacked, %.4f ms "
              "for %d solo (%.2fx); host wall %.4f ms stacked, %.4f ms for "
              "%d solo (%.2fx); plain %.4f ms; bound %.4f ms (bytes)"
              % (label, stacked_ms, solo_ms, FLEET_Q, solo_ms / stacked_ms,
                 host_stacked, host_solo, FLEET_Q, host_solo / host_stacked,
                 plain_ms, bound_ms(nbytes, 0.0)))
        if shape != "headline":
            continue
        # the member-strided kernels at the headline panel's shape
        rows = FLEET_Q * s
        # their library yardstick, as the solo K1 and K4 rows': one
        # torch.segment_reduce over the window runs of every row, each
        # row's lengths from the plain edge search against its member's
        # edges, outside the timed call.  Every point of a panel lies in
        # its windows, and a row's padding past the last edge is one
        # more segment a row, so that the lengths cover the batch.
        pos = torch.searchsorted(
            d_ts, d_edges.repeat_interleave(s, dim=0).contiguous())
        if int(pos[:, 0].max()) != 0:
            checks.failures.append("stacked segment_reduce: points before "
                                   "the first edge")
        lengths = torch.diff(pos, dim=1, append=torch.full(
            (rows, 1), n, dtype=pos.dtype, device=dev)).reshape(-1)
        flat = d_val.reshape(-1)
        seg = {red: time_ms(lambda red=red: torch.segment_reduce(
            flat, red, lengths=lengths)) for red in ("mean", "prod")}
        print("time segment_reduce mean %.4f ms  prod %.4f ms (stacked K1 "
              "and K4 library, %d runs)"
              % (seg["mean"], seg["prod"], lengths.numel()))
        del pos, lengths, flat
        times["window_moments.stacked"] = {
            **kernel_ms(lambda: ds.window_moments(d_ts, d_val, d_mask,
                                                  d_edges, "avg")),
            "plain_ms": time_ms(lambda: ds.window_moments_plain(
                d_ts, d_val, d_mask, d_edges, "avg")),
            "bound_ms": bound_ms(rows * n * 9 + rows * (w + 1) * 8
                                 + FLEET_Q * (w + 1) * 8 + rows * w * 9,
                                 2.0 * rows * n),
            "library_ms": seg["mean"]}
        # K4 at mult, as the solo K4 row, against segment_reduce prod;
        # the fleet's order panels run it at p95
        times["window_order.stacked"] = {
            **kernel_ms(lambda: ds.window_order(d_ts, d_val, d_mask,
                                                d_edges, "mult")),
            "plain_ms": time_ms(lambda: ds.window_order_plain(
                d_ts, d_val, d_mask, d_edges, "mult")),
            "bound_ms": bound_ms(rows * n * 9 + rows * (w + 1) * 8
                                 + FLEET_Q * (w + 1) * 8 + rows * w * 9,
                                 1.0 * rows * n),
            "library_ms": seg["prod"]}
        print("time window_order.stacked p95 %.4f ms (plain %.4f ms)"
              % (time_ms(lambda: ds.window_order(d_ts, d_val, d_mask,
                                                 d_edges, "p95")),
                 time_ms(lambda: ds.window_order_plain(
                     d_ts, d_val, d_mask, d_edges, "p95"))))
        # (K2's stacked row, this panel's grid, is fill_phase's case (c))
    print_times(times)
    (wall_a, cells_a), (wall_b, cells_b) = walls["dispatch"], \
        walls["headline"]
    cell_s = max((wall_b - wall_a) / 1e3 / (cells_b - cells_a), 0.0)
    costs = {"stacked_dispatch": wall_a / 1e3 - cell_s * cells_a,
             "stacked_cell": cell_s}
    print("stacked dispatch cost: %s (the host walls of the two shapes, "
          "linear in the member cells)" % json.dumps(costs))
    return times, costs


def _fleet_panels(tsdb) -> list[str]:
    """The fleet's panels: both forms over each group, rotating, over the
    data's last hour."""
    groups = sorted(tsdb.tag_values.get_name(v) for v in {
        dict(s.key.tags)[tsdb.tag_names.get_id("group")]
        for s in tsdb.store.all_series()})
    start_s, end_s = (END - 3_600_000) // 1000, END // 1000
    return ["/api/query?start=%d&end=%d&m=%s" % (start_s, end_s, form % g)
            for g in groups for form in FLEET_FORMS]


def fleet_client(spec: dict) -> int:
    """The fleet's clients, in a process of their own (`--fleet-client`):
    `threads` threads each send the panels in turn over one keep-alive
    connection for `warmup` + `window` seconds; prints one JSON line of
    what the timed window saw: queries, latencies on this clock, statuses
    and each panel's body hashes."""
    import hashlib
    import http.client
    import threading
    port, panels = spec["port"], spec["panels"]
    threads = spec["threads"]
    t_begin = time.perf_counter() + spec["warmup"]
    t_end = t_begin + spec["window"]
    lock = threading.Lock()
    lat, statuses, hashes, retry = [], {}, {}, []

    def run(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        k = i
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            idx = k % len(panels)
            k += threads
            try:
                conn.request("GET", panels[idx])
                resp = conn.getresponse()
                body = resp.read()
                status = resp.status
                after = resp.getheader("Retry-After")
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=120)
                status, body, after = -1, b"", None
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                if status == 200:
                    hashes.setdefault(idx, set()).add(
                        hashlib.sha256(body).hexdigest())
                if t0 >= t_begin:
                    lat.append(dt)
                    statuses[status] = statuses.get(status, 0) + 1
                    if status == 503:
                        retry.append(after)
        conn.close()

    pool = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(spec["warmup"] + spec["window"] + 180)
    lat.sort()
    pct = (lambda p: lat[min(int(p * len(lat)), len(lat) - 1)]
           if lat else float("nan"))
    print(json.dumps({
        "queries": len(lat), "qps": len(lat) / spec["window"],
        "p50_ms": pct(0.50), "p99_ms": pct(0.99),
        "statuses": {str(k): v for k, v in statuses.items()},
        "retry_after": sum(1 for r in retry if r),
        "hashes": {str(k): sorted(v) for k, v in hashes.items()}}))
    return 0


def _run_fleet(port: int, panels: list[str], window: float,
               warmup: float = FLEET_WARMUP_S) -> dict:
    """One arm of the fleet: the clients in a child process."""
    spec = {"port": port, "panels": panels, "threads": FLEET_THREADS,
            "warmup": warmup, "window": window}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--fleet-client",
         json.dumps(spec)], capture_output=True, text=True,
        timeout=warmup + window + 240)
    if proc.returncode != 0:
        raise RuntimeError("fleet client failed: %s" % proc.stderr[-2000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _http_get(port: int, path: str, headers: dict | None = None,
              timeout: float = 120):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def fleet_phase(dev, tsdb, checks: Checks) -> dict:
    """Phase 16 (b)-(d) on the headline TSDB: the routing verdicts, the
    fleet over HTTP with batching off then on, and admission.  Returns
    the launch counts of the main path (the on arm and the order
    panels)."""
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.query.batcher import DispatchBatcher
    from opentsdb_tpu_torch.tsd import admission
    from opentsdb_tpu_torch.utils.config import Config

    cfg = tsdb.config
    key = "tsd.query.streaming.point_threshold"
    threshold = cfg.get_string(key)
    cfg.override_config(key, MATERIALIZE[key])
    batcher = DispatchBatcher(Config(), tsdb=tsdb)
    tsdb.dispatch_batcher = batcher

    # (b) two routing verdicts
    panel_q = _query(FLEET_FORMS[0] % "g007", END - 3_600_000, END)
    for label, q, want in (("sum:1h-avg:m{group=*}",
                            _query("sum:1h-avg:m{group=*}"), False),
                           ("panel " + FLEET_FORMS[0] % "g007", panel_q,
                            True)):
        runner = tsdb.new_query_runner()
        runner.run(q)
        pd = runner.decisions[0]
        print("fleet route %-36s path %s fingerprint %s fields %s"
              % (label, pd.path, pd.fingerprint, json.dumps(pd.fp_fields)))
        if (pd.path == "batched") != want:
            checks.failures.append("fleet route %s: path %s" % (label,
                                                                pd.path))

    panels = _fleet_panels(tsdb)
    arms = {}

    def arm(label, arm_batcher, window):
        """One arm of the fleet with `arm_batcher` (None: batching off)."""
        tsdb.dispatch_batcher = arm_batcher
        stats = arm_batcher or batcher
        before = stats.collect_stats()
        t0 = time.perf_counter()
        res = _run_fleet(server.port, panels, window)
        after = stats.collect_stats()
        delta = {k.rsplit(".", 1)[1]: after[k] - before[k] for k in after}
        res.update(dispatches=delta["stacked_dispatches"],
                   members=delta["stacked_members"],
                   solo=delta["solo_dispatches"])
        n_disp = max(res["dispatches"] + res["solo"], 1)
        print("fleet %-12s %d client threads, %d panels: %.1f QPS, p50 "
              "%.2f ms, p99 %.2f ms (client clock) | statuses %s | stacked "
              "dispatches %d, %.2f members a dispatch, solo dispatches %d "
              "(buckets formed %d, bucket keys %d), coalesce wait %.3f ms "
              "a batched query | a dispatch: host wall %.3f ms, its "
              "thread's CPU %.3f ms, copy back %.3f ms | wall %.1f s"
              % (label, FLEET_THREADS, len(panels), res["qps"],
                 res["p50_ms"], res["p99_ms"], json.dumps(res["statuses"]),
                 res["dispatches"],
                 res["members"] / max(res["dispatches"], 1), res["solo"],
                 res["dispatches"] + res["solo"],
                 after["tsd.query.batch.keys"],
                 delta["wait_ms"] / max(delta["queries"], 1),
                 delta["dispatch_ms"] / n_disp,
                 delta["dispatch_cpu_ms"] / n_disp,
                 delta["copy_back_ms"] / n_disp,
                 time.perf_counter() - t0))
        if res["statuses"].get("503") or set(res["statuses"]) - {"200"}:
            checks.failures.append("fleet %s: statuses %s"
                                   % (label, res["statuses"]))
        if "off" in arms:
            # every panel answered one body, the off arm's
            diff = [k for k, h in res["hashes"].items()
                    if len(h) != 1 or arms["off"]["hashes"].get(k, h) != h]
            shared = len(set(res["hashes"]) & set(arms["off"]["hashes"]))
            print("fleet %s bodies: %d panels answered in this arm and "
                  "the off arm, %d differ" % (label, shared, len(diff)))
            if diff or not shared:
                checks.failures.append("fleet %s: %d panel bodies differ "
                                       "from the off arm's"
                                       % (label, len(diff)))
        return res

    with Serving(tsdb, workers=8) as server:
        arms["off"] = arm("off", None, FLEET_WINDOW_S)
        kernels.reset_launches()
        arms["on"] = arm("on", batcher, FLEET_WINDOW_S)
        if arms["on"]["dispatches"] <= 0:
            checks.failures.append("fleet on: no stacked dispatch")
        # the order panels (K4, K5) through the same server, batching on
        tsdb.dispatch_batcher = batcher
        before = batcher.collect_stats()["tsd.query.batch.stacked_dispatches"]
        start_s, end_s = (END - 3_600_000) // 1000, END // 1000
        order = ["/api/query?start=%d&end=%d&m=%s"
                 % (start_s, end_s, ORDER_FORM % ("g%03d" % g))
                 for g in range(0, GROUPS, 2)]
        res = _run_fleet(server.port, order, 5.0)
        print("fleet order panels %s: %.1f QPS, p50 %.2f ms, statuses %s, "
              "stacked dispatches %d"
              % (ORDER_FORM % "gNNN", res["qps"], res["p50_ms"],
                 json.dumps(res["statuses"]),
                 batcher.collect_stats()["tsd.query.batch.stacked_dispatches"]
                 - before))
        launches = dict(kernels.LAUNCHES)
        print("fleet launches %s" % json.dumps(launches))
        for name in ("window_moments.stacked", "window_order.stacked",
                     "grid_fill_rate.stacked", "group_moments",
                     "group_order"):
            if launches[name] < 1:
                checks.failures.append("kernel %s never launched on the "
                                       "fleet's path" % name)
        admission_phase(tsdb, server, checks, admission)
    cfg.override_config(key, threshold)
    return launches


def admission_phase(tsdb, server, checks: Checks, admission) -> None:
    """Phase 16 (d): a shed under permits=1, the request deadline's 503,
    a degraded 200 and a client that hangs up while queued."""
    import socket
    import threading
    cfg = tsdb.config
    gate = tsdb.admission_gate
    full = "/api/query?start=%d&end=%d&m=" % (START // 1000, END // 1000)

    def fresh_gate(**over):
        for k, v in over.items():
            cfg.override_config(k, v)
        tsdb.admission_gate = admission.AdmissionGate(cfg)
        return tsdb.admission_gate

    # 8 concurrent full-range queries on one permit and one queue slot
    g1 = fresh_gate(**{"tsd.query.admission.permits": "1",
                       "tsd.query.admission.queue_limit": "1"})
    out = []
    go = threading.Barrier(8)

    def client():
        go.wait()
        out.append(_http_get(server.port, full + "sum:1h-avg:m{group=*}"))

    pool = [threading.Thread(target=client) for _ in range(8)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(120)
    codes = sorted(o[0] for o in out)
    sheds = [o for o in out if o[0] == 503]
    print("admission permits=1 queue=1, 8 concurrent: statuses %s, "
          "Retry-After on %d of %d 503s | gate %s"
          % (codes, sum(1 for o in sheds if o[1]), len(sheds),
             json.dumps(g1.collect_stats())))
    if not sheds or not all(o[1] for o in sheds) \
            or set(codes) - {200, 503}:
        checks.failures.append("admission: statuses %s" % codes)

    # the request deadline: 1 ms on a full-range query, degrade=error
    fresh_gate(**{"tsd.query.admission.permits": "8",
                  "tsd.query.admission.queue_limit": "64"})
    st, after, body = _http_get(server.port, full + "sum:1m-avg:m{group=*}",
                                {"X-TSDB-Deadline-Ms": "1"})
    print("admission X-TSDB-Deadline-Ms 1, degrade=error: %d Retry-After "
          "%s %s" % (st, after, body[:160]))
    if st != 503 or not after:
        checks.failures.append("admission: a 1 ms deadline answered %d" % st)

    # degrade=allow: the ladder coarsens x4.  At a 1 ms deadline no
    # degraded run can finish (the cost table prices device work only),
    # so, as tests/test_admission.py::test_degrade_allow_answers_200_partial
    # does, the estimate is replaced for this request: it fits once the
    # interval is coarsened x4, under a 5000 ms deadline
    subset = "{group=g000|g001|g002|g003}"
    cfg.override_config("tsd.query.degrade", "allow")
    real = admission.estimate_plan_cost_ms
    admission.estimate_plan_cost_ms = lambda _t, tq: (
        1e9 if tq.queries[0].downsample_spec.interval_ms < 2_400_000
        else 1.0)
    try:
        st, _, body = _http_get(server.port, full + "sum:10m-avg:m" + subset,
                                {"X-TSDB-Deadline-Ms": "5000"})
    finally:
        admission.estimate_plan_cost_ms = real
        cfg.override_config("tsd.query.degrade", "error")
    payload = json.loads(body) if st == 200 else []
    trailer = [e for e in payload if "partialResults" in e]
    print("admission degrade=allow: %d, trailer %s"
          % (st, json.dumps(trailer)))
    if st != 200 or not trailer or trailer[0]["degraded"].get(
            "coarsenedIntervalFactor") != 4:
        checks.failures.append("admission: degrade=allow answered %d %s"
                               % (st, trailer))
    else:
        cpu = _cpu_copy(tsdb)
        want = cpu.new_query_runner().run(
            _query("sum:40m-avg:m" + subset))
        del cpu
        got = [e for e in payload if "metric" in e]
        if [(e["tags"], list(e["dps"])) for e in got] \
                != [(r.tags, [str(t // 1000) for t, _ in r.dps])
                    for r in want]:
            checks.failures.append("admission: the degraded answer's "
                                   "groups or timestamps differ")
        else:
            checks.values("e2e", "degraded sum:40m-avg" + subset,
                          torch.tensor([v for e in got
                                        for v in e["dps"].values()]),
                          torch.tensor([v for r in want for _, v in r.dps]))

    # a client that hangs up while queued leaves without a permit
    g2 = fresh_gate(**{"tsd.query.admission.permits": "1",
                       "tsd.query.admission.queue_limit": "4",
                       "tsd.query.admission.max_wait_ms": "30000"})
    held = []
    ta = threading.Thread(target=lambda: held.append(_http_get(
        server.port, full + "sum:1m-avg:m{group=*}")))
    ta.start()
    t0 = time.time()
    while time.time() - t0 < 30 and g2.demand() < 1:
        time.sleep(0.005)
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    sock.sendall(("GET %ssum:1h-avg:m{group=*} HTTP/1.1\r\nHost: x\r\n\r\n"
                  % full).encode())
    while time.time() - t0 < 30 and g2.demand() < 2:
        time.sleep(0.005)
    queued = g2.demand()
    sock.close()
    while time.time() - t0 < 30 and not g2.cancelled:
        time.sleep(0.005)
    ta.join(120)
    stats = g2.collect_stats()
    print("admission hang-up: demand %d before it, A %s, gate %s"
          % (queued, held[0][0] if held else None, json.dumps(stats)))
    if queued != 2 or not held or held[0][0] != 200 \
            or stats.get("tsd.query.admission.cancelled.client_disconnect") \
            != 1.0 or stats["tsd.query.admission.admitted"] != 1.0 \
            or stats["tsd.query.admission.inflight"] != 0.0:
        checks.failures.append("admission: the hang-up did not release "
                               "its place (%s)" % json.dumps(stats))
    fresh_gate(**{"tsd.query.admission.permits": "8",
                  "tsd.query.admission.queue_limit": "64",
                  "tsd.query.admission.max_wait_ms": "5000"})
    tsdb.admission_gate = gate


# Phase 17: the cache-hit path.  The follow-up's responder counts, its
# arms' warm-up and timed seconds, and (c)'s queries.
FOLLOWUP_THREADS = (8,)
# (shorter than phase 16's: the script's 1200 s limit)
FOLLOWUP_WARMUP_S, FOLLOWUP_WINDOW_S = 2.0, 4.0
AGG_QUERIES = ("sum:1h-avg:m{group=*}", "max:1m-max:m{group=*}")


def _raw_bits(x: torch.Tensor) -> torch.Tensor:
    """A float64 tensor's bits (NaN payloads included) for an exact
    comparison."""
    return x.contiguous().view(torch.int64)


def int32_kernel_phase(dev, ts, val, gid, h, checks: Checks,
                       times: dict) -> dict:
    """Phase 17 (a): G1's, K1's and K4's int32 forms against their plain
    versions, and K1 and K4 bit for bit against their int64 forms."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.storage import device_cache as dc

    plan = ds.FixedWindows.for_range(START, END, INTERVAL_MS)
    base = ds.precompact_base(plan, plan.first_window_ms)
    if base is None:
        checks.failures.append("the headline grid has no int32 base")
        return {}
    ts_buf = torch.from_numpy(ts.reshape(-1)).to(dev)
    val_buf = torch.from_numpy(val.reshape(-1)).to(dev)
    out = {}
    for name, (starts, lengths) in _gather_cases(ts, gid).items():
        n = int(lengths.max())
        d_st = torch.from_numpy(starts).to(dev)
        d_len = torch.from_numpy(lengths).to(dev)
        got = dc.gather_windows(ts_buf, val_buf, d_st, d_len, n, base)
        want = dc.gather_windows_plain(ts_buf, val_buf, d_st, d_len, n, base)
        for what, a, b in zip(("offsets", "values", "masks"), got, want):
            checks.exact("gather_windows.i32", name, a, b, what)
        print("%-18s %-44s %d rows x %d int32 offsets exact %s"
              % ("gather_windows.i32", name, len(starts), n,
                 "ok" if all(torch.equal(a, b) for a, b in zip(got, want))
                 else "FAIL"))
        del got, want
        if name.startswith("(a)"):
            points = int(lengths.sum())
            rows = len(starts)
            i64_ms = time_ms(lambda: dc.gather_windows(
                ts_buf, val_buf, d_st, d_len, n))
            out["gather_windows.i32"] = {
                **kernel_ms(lambda: dc.gather_windows(
                    ts_buf, val_buf, d_st, d_len, n, base)),
                "plain_ms": time_ms(lambda: dc.gather_windows_plain(
                    ts_buf, val_buf, d_st, d_len, n, base), 3),
                # each point read once from both buffers, each slot
                # written once (int32 offset, value, mask), the runs read
                "bound_ms": bound_ms(points * 16 + rows * n * 13 + rows * 16,
                                     0.0),
                "library_ms": None,
            }
            print("time gather_windows.i32 (a) kernel %.4f ms (the int64 "
                  "form %.4f ms in this call), bound %.4f ms (bytes; the "
                  "int64 form's %.4f ms)"
                  % (out["gather_windows.i32"]["ms"], i64_ms,
                     out["gather_windows.i32"]["bound_ms"],
                     bound_ms(points * 16 + rows * n * 17 + rows * 16, 0.0)))
            d_ts32 = dc.gather_windows(ts_buf, val_buf, d_st, d_len, n,
                                       base)[0]
    del ts_buf, val_buf

    d_ts = torch.from_numpy(ts).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_mask = torch.ones((S, N), dtype=torch.bool, device=dev)
    d_h = torch.from_numpy(h).to(dev)
    c_mask = d_mask & (d_h % 97 != 0)
    c_val = torch.where(d_h % 211 == 0, torch.nan, d_val)
    del d_h
    grids = {"fixed": plan.window_edges(dev),
             "all": ds.AllWindow(START, END).window_edges(dev)}
    cases = [("window_moments", "fixed", f) for f in FUNCS]
    cases += [("window_order", "fixed", f) for f in ("mult", "p95", "first")]
    cases.append(("window_order", "all", "p99"))
    for kernel, kind, func in cases:
        fn, plain = ((ds.window_moments, ds.window_moments_plain)
                     if kernel == "window_moments"
                     else (ds.window_order, ds.window_order_plain))
        edges = grids[kind]
        edges32 = ds.compact_edges(edges, base)
        got = fn(d_ts32, c_val, c_mask, edges32, func)
        want = plain(d_ts32, c_val, c_mask, edges32, func)
        name = kernel + ".i32"
        case = "%s %s" % (kind, func)
        checks.exact(name, case, got[1], want[1])
        checks.values(name, case, got[0], want[0])
        wide = fn(d_ts, c_val, c_mask, edges, func)
        checks.exact(name, case + " vs int64 form", got[1], wide[1])
        checks.exact(name, case + " vs int64 form", _raw_bits(got[0]),
                     _raw_bits(wide[0]), "value bits")
    del c_val, c_mask
    edges = grids["fixed"]
    edges32 = ds.compact_edges(edges, base)
    w = edges.numel() - 1
    # the bound reads val and mask once (9 B a point), a 4-byte offset
    # where an edge falls, and writes 9 B a cell
    i32_bytes = S * N * 9 + S * (w + 1) * 4 + (w + 1) * 4 + S * w * 9
    for kernel, fn, plain, func, flops in (
            ("window_moments", ds.window_moments, ds.window_moments_plain,
             "avg", 2.0 * S * N),
            ("window_order", ds.window_order, ds.window_order_plain, "mult",
             1.0 * S * N)):
        out[kernel + ".i32"] = {
            **kernel_ms(lambda: fn(d_ts32, d_val, d_mask, edges32, func)),
            "plain_ms": time_ms(lambda: plain(d_ts32, d_val, d_mask,
                                              edges32, func)),
            "bound_ms": bound_ms(i32_bytes, flops),
            "library_ms": times[kernel]["library_ms"],
        }
        print("time %s.i32 %s kernel %.4f ms (the int64 form %.4f ms in "
              "this call)" % (kernel, func, out[kernel + ".i32"]["ms"],
                              time_ms(lambda: fn(d_ts, d_val, d_mask, edges,
                                                 func))))
    print_times(out)
    return out


def _batch_points(tsdb, m: str) -> tuple[int, int]:
    """(series, longest run) of `m`'s batch over the full range."""
    metric = tsdb.metrics.get_id("m")
    series = tsdb.store.series_for_metric(metric)
    fix = tsdb.config.fix_duplicates
    return len(series), max(s.window_count(START, END, fix) for s in series)


def int32_hit_phase(tsdb, checks: Checks, times: dict) -> dict:
    """Phase 17 (b): phase 4's seven queries as device-cache hits with the
    int32 gather and with the base withheld, bit for bit alike; returns
    the cost model's `cache_gather_series`, the int64 hits' median gather
    phase (the cache's walk over the series and G1) a series."""
    from opentsdb_tpu_torch.query import planner
    from opentsdb_tpu_torch.query.planner import PHASES

    with_base = planner.precompact_base
    tsdb.new_query_runner().run(_query(STREAM_QUERIES[0]))  # the entry
    s, n = _batch_points(tsdb, "m")
    print("e2e int32 batch [%d, %d]: %.3f GB at 13 B a slot, %.3f GB at 17"
          % (s, n, s * n * 13 / 1e9, s * n * 17 / 1e9))
    # G1's CUDA-event time on the full range (phases 3 and 17 (a))
    g1_ms = {"int32": times["gather_windows.i32"]["ms"],
             "int64": times["gather_windows"]["ms"]}
    gathers = []
    for m in STREAM_QUERIES:
        arms = {}
        runs = {"int32": ([], []), "int64": ([], [])}
        # the two arms in turns (a warm-up, then int32, int64, int64,
        # int32, ...): host noise falls on both alike
        for i, arm in enumerate(["int32", "int64"] + ["int32", "int64",
                                                      "int64", "int32"] * 3):
            if arm == "int64":
                planner.precompact_base = lambda windows, first: None
            try:
                runner = tsdb.new_query_runner()
                t0 = time.perf_counter()
                res = runner.run(_query(m))
                wall = (time.perf_counter() - t0) * 1e3
            finally:
                planner.precompact_base = with_base
            arms[arm] = res
            if i >= 2:
                runs[arm][0].append(wall)
                runs[arm][1].append(dict(runner.exec_stats))
        for arm, (walls, splits) in runs.items():
            wall = statistics.median(walls)
            split = {p: statistics.median(x[p + "Ms"] for x in splits)
                     for p in PHASES}
            compacted = {x.get("tsCompacted") for x in splits}
            hit = {x.get("deviceCacheHit") for x in splits}
            print("e2e hit %-5s %-34s wall %.1f ms (median of 6) | build "
                  "%.1f gather %.1f h2d %.1f kernels %.1f extract %.1f ms | "
                  "gather share %.4f, G1's %.4f | tsCompacted %s"
                  % (arm, m, wall, split["build"], split["gather"],
                     split["h2d"], split["kernels"], split["extract"],
                     split["gather"] / wall, g1_ms[arm] / wall,
                     sorted(compacted, key=str)))
            if arm == "int64":
                gathers.append(split["gather"])
            if hit != {1.0} or compacted != (
                    {1.0} if arm == "int32" else {None}):
                checks.failures.append("%s %s: not a %s hit" % (m, arm, arm))
        if [(r.tags, r.dps) for r in arms["int32"]] \
                != [(r.tags, r.dps) for r in arms["int64"]]:
            checks.failures.append("%s: int32 and int64 hits differ" % m)
        else:
            print("e2e hit %s: int32 and int64 answers equal bit for bit" % m)
    return {"cache_gather_series": statistics.median(gathers) / 1e3 / s}


def _agg_run(tsdb, m, start=START, end=END):
    """(answer, runner, wall ms) of one run of `m`."""
    runner = tsdb.new_query_runner()
    t0 = time.perf_counter()
    res = runner.run(_query(m, start, end))
    wall = (time.perf_counter() - t0) * 1e3
    return [(r.tags, r.dps) for r in res], runner, wall


def agg_cache_phase(dev, tsdb, checks: Checks):
    """Phase 17 (c): the aggregate cache on the headline TSDB; returns the
    cache (phase 17 (d)'s default arm uses it).  With the metric's entry
    in the device cache a recompute is a hit, and the cache's pricing
    keeps each repeat on it; with the device cache detached the same
    queries populate blocks, replay them warm and from the device tier,
    slide, and serve an append fresh, each answer equal to the cache
    off's."""
    from opentsdb_tpu_torch.storage.agg_cache import AggregateCache
    from opentsdb_tpu_torch.storage.memstore import SeriesKey
    from opentsdb_tpu_torch.utils.config import Config

    agg = AggregateCache(Config(), dev)
    dcache = tsdb.device_cache

    def run(label, m, start=START, end=END):
        tsdb.agg_cache = agg
        got, runner, wall = _agg_run(tsdb, m, start, end)
        st = runner.exec_stats
        pd = runner.decisions[0]
        print("e2e agg %-22s %-24s wall %.1f ms | path %s (%s) | windows "
              "from blocks %d, computed %d | device tier %.3f MB"
              % (label, m, wall, pd.path,
                 (pd.agg_note or {}).get("reason"),
                 st.get("aggCacheHitWindows", 0),
                 st.get("aggCacheComputedWindows", 0),
                 agg.collect_stats()["tsd.query.agg_cache.device_bytes"]
                 / 2**20))
        return got, st, pd

    def cache_off(m, start=START, end=END):
        tsdb.agg_cache = None
        got, _, wall = _agg_run(tsdb, m, start, end)
        print("e2e agg %-22s %-24s wall %.1f ms" % ("cache off", m, wall))
        return got

    def stays_on_hits(label):
        for m in AGG_QUERIES:
            want = cache_off(m)
            for i in range(3):
                got, st, pd = run("%s, hit %d" % (label, i), m)
                if pd.path != "resident" \
                        or st.get("deviceCacheHit") != 1.0 or got != want:
                    checks.failures.append(
                        "agg %s %s: a repeat left the device-cache hit "
                        "(path %s) or changed its answer" % (label, m,
                                                             pd.path))

    stays_on_hits("entry held")
    # the rewrite's own route: the device cache detached, pieces built on
    # the host; the repeats above were the family's first sights
    tsdb.device_cache = None
    for m in AGG_QUERIES:
        want = cache_off(m)
        cold, st, _ = run("cold populate", m)
        warm, st_w, _ = run("warm", m)
        # a second serve earns a block its device-tier mirror
        # (tsd.query.cache.promote_hits), uploaded here as the
        # maintenance thread would
        run("warm again", m)
        promoted = agg.promote_pending(max_uploads=1024)
        dev_warm, st_d, _ = run("warm, device tier", m)
        print("e2e agg %s: %d blocks mirrored on the device" % (m, promoted))
        if not st.get("aggCacheComputedWindows") \
                or not st_w.get("aggCacheHitWindows") \
                or not st_d.get("aggCacheHitWindows"):
            checks.failures.append("agg %s: no populate or no warm hit" % m)
        if not (warm == cold == dev_warm == want):
            checks.failures.append("agg %s: warm, cold and cache-off "
                                   "answers differ" % m)
    m = AGG_QUERIES[0]
    slid = (START + INTERVAL_MS, END + INTERVAL_MS)
    got, st, _ = run("slid by one window", m, *slid)
    if got != cache_off(m, *slid) or not st.get("aggCacheHitWindows"):
        checks.failures.append("agg: the slid range differs or missed")
    before = cache_off(m)
    # (phase 4's staleness check appended END - 1 to h0000)
    key = SeriesKey.make(tsdb.metrics.get_id("m"), {
        tsdb.tag_names.get_id("host"): tsdb.tag_values.get_id("h0001"),
        tsdb.tag_names.get_id("group"): tsdb.tag_values.get_id("g000")})
    tsdb.store.add_batch(key, np.array([END - 3], np.int64),
                         np.array([1e6]), False)
    fresh, st, _ = run("after an append", m)
    after = cache_off(m)
    print("e2e agg after an append: answer %s, %s the cache-off answer; "
          "%d windows recomputed"
          % ("changed" if fresh != before else "UNCHANGED",
             "equal to" if fresh == after else "DIFFERENT from",
             st.get("aggCacheComputedWindows", 0)))
    if fresh == before or fresh != after:
        checks.failures.append("agg: an appended point was not served")
    # the entry back, blocks cached: the priced verdict still takes the
    # hit ((d)'s hits need the entry too).  The append moved a series'
    # version while the cache was detached: the first cache-off run
    # rebuilds the entry inline
    tsdb.device_cache = dcache
    dcache.invalidate()
    stays_on_hits("blocks cached")
    print("e2e agg cache %s" % json.dumps(agg.collect_stats()))
    return agg


def _query_phases(port: int) -> tuple[dict, int]:
    """The /api/query profiles' summed phase milliseconds and request
    count from /api/diag/latency."""
    status, _, body = _http_get(port, "/api/diag/latency")
    if status != 200:
        raise RuntimeError("/api/diag/latency answered %d" % status)
    totals = dict.fromkeys(json.loads(body)["phases"], 0.0)
    count = 0
    for profile in json.loads(body)["profiles"]:
        if profile["route"] != "api/query":
            continue
        count += profile["count"]
        for p, summary in profile["phases"].items():
            totals[p] += summary["totalMs"]
    return totals, count


def route_followup_phase(tsdb, agg, checks: Checks) -> None:
    """Phase 17 (d): phase 16's fleet at 1, 2, 4 and 8 responder threads,
    three arms at each, the request phases and thread CPU a query."""
    import threading
    from opentsdb_tpu_torch.query.batcher import DispatchBatcher
    from opentsdb_tpu_torch.utils.config import Config

    panels = _fleet_panels(tsdb)
    batcher = DispatchBatcher(Config(), tsdb=tsdb)
    arms = (("hits", None, None), ("agg off", None, batcher),
            ("default", agg, batcher))
    want = None
    for threads in FOLLOWUP_THREADS:
        with Serving(tsdb, workers=threads) as server:
            handle_http = server.rpc_manager.handle_http
            lock = threading.Lock()
            cpu = {"ms": 0.0, "n": 0}

            def timed(request, remote="unknown"):
                c0 = time.thread_time()
                q = handle_http(request, remote)
                if q.base_route() == "api/query":
                    with lock:
                        cpu["ms"] += (time.thread_time() - c0) * 1e3
                        cpu["n"] += 1
                return q

            server.rpc_manager.handle_http = timed
            for label, arm_agg, arm_batcher in arms:
                tsdb.agg_cache = arm_agg
                tsdb.dispatch_batcher = arm_batcher
                p0, n0 = _query_phases(server.port)
                c0, k0 = cpu["ms"], cpu["n"]
                res = _run_fleet(server.port, panels, FOLLOWUP_WINDOW_S,
                                 FOLLOWUP_WARMUP_S)
                p1, n1 = _query_phases(server.port)
                q = max(n1 - n0, 1)
                split = " ".join("%s %.3f" % (p, (p1[p] - p0[p]) / q)
                                 for p in p1)
                print("followup %d responders %-8s %.1f QPS, p50 %.2f ms, "
                      "p99 %.2f ms | statuses %s | a query: %s ms | thread "
                      "CPU %.3f ms a query"
                      % (threads, label, res["qps"], res["p50_ms"],
                         res["p99_ms"], json.dumps(res["statuses"]), split,
                         (cpu["ms"] - c0) / max(cpu["n"] - k0, 1)))
                if set(res["statuses"]) - {"200"}:
                    checks.failures.append("followup %d %s: statuses %s"
                                           % (threads, label,
                                              res["statuses"]))
                if want is None:
                    want = res["hashes"]
                diff = [k for k, hs in res["hashes"].items()
                        if len(hs) != 1 or want.get(k, hs) != hs]
                if diff:
                    checks.failures.append(
                        "followup %d %s: %d panel bodies differ from the "
                        "hits arm's" % (threads, label, len(diff)))
            del server.rpc_manager.handle_http
    tsdb.agg_cache = None
    tsdb.dispatch_batcher = None


def cache_hit_phase(dev, tsdb, checks: Checks,
                    times: dict) -> tuple[dict, dict]:
    """Phase 17 (b)-(d) on the headline TSDB, the threshold raised as in
    phase 4; returns the launch counts of their main path and the cost
    model's terms that (b) measured."""
    from opentsdb_tpu_torch.ops import kernels

    cfg = tsdb.config
    key = "tsd.query.streaming.point_threshold"
    threshold = cfg.get_string(key)
    cfg.override_config(key, MATERIALIZE[key])
    tsdb.dispatch_batcher = None
    kernels.reset_launches()
    t0 = time.perf_counter()
    costs = int32_hit_phase(tsdb, checks, times)
    print("phase 17 (b) wall %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    agg = agg_cache_phase(dev, tsdb, checks)
    print("phase 17 (c) wall %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    route_followup_phase(tsdb, agg, checks)
    print("phase 17 (d) wall %.1f s" % (time.perf_counter() - t0))
    launches = dict(kernels.LAUNCHES)
    print("cache-hit launches %s" % json.dumps(launches))
    for name in ("gather_windows.i32", "window_moments.i32",
                 "window_order.i32"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the "
                                   "cache-hit path" % name)
    cfg.override_config(key, threshold)
    return launches, costs


# -- phase 18: the device mesh ------------------------------------------------

MESH_QUERIES = ["sum:1h-avg:m{group=*}", "dev:1h-avg:m{group=*}",
                "squareSum:1h-avg:m{group=*}", "p95:1h-avg:m{group=*}",
                "first:1h-avg:m{group=*}", "sum:1h-max:rate:m{group=*}"]
MESH_SHARDS = 4          # the virtual mesh: four shards on cuda:0
MESH_ROWS = 256          # (a)'s tile


def mesh_kernel_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    """Phase 18 (a): T1's four modes against their plain versions on a
    256-row tile of the headline batch's 1m grid (holes masked as in
    phase 14), the centred pass around the tile's own mean; each timed as
    a wall (CUDA events around the call) and a device time
    (torch.profiler's kernel durations) against its byte bound, the plain
    version and one PyTorch call: index_add_ of its precomputed operand
    (scatter_reduce_ amin and amax for the extremes).  Returns the square
    and centred modes' figures (phase 14 gives the additive one's)."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops import tiling
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec

    rows = MESH_ROWS
    d_ts = torch.from_numpy(ts[:rows]).to(dev)
    d_h = torch.from_numpy(h[:rows]).to(dev)
    cols = torch.arange(N, device=dev)[None, :]
    rix = torch.arange(rows, device=dev)[:, None]
    mask = (d_h % 11 != 0) & ((cols // 512) % 13 != rix % 13)
    plan = ds.FixedWindows.for_range(START, END, 60_000)
    edges = plan.window_edges(dev)
    w = plan.count
    v, m = ds.window_moments(d_ts, torch.from_numpy(val[:rows]).to(dev),
                             mask, edges, "sum")
    del d_ts, d_h, cols, rix, mask
    contrib, part, actual = tiling.tile_contrib(PipelineSpec("sum"),
                                                edges[:-1], v, m)
    off = ga.group_offsets(gid[:rows], GROUPS).to(dev)
    g_tile = int(np.unique(gid[:rows]).size)
    grows = torch.from_numpy(gid[:rows]).to(dev)
    ok = part & ~torch.isnan(contrib)
    x = torch.where(ok, contrib, 0.0)
    first = tiling.new_lane_fold(GROUPS, w, "additive", dev)
    tiling.tile_partials(contrib, part, actual, off, first)
    mean = first["tot"] / first["cnt"].clamp(min=1)
    times = {}
    for mode in ("additive", "extreme", "square", "centred"):
        name = "tile_partials." + mode
        extra = {"mean": mean} if mode == "centred" else {}
        got = tiling.new_lane_fold(GROUPS, w, mode, dev)
        want = tiling.new_lane_fold(GROUPS, w, mode, dev)
        tiling.tile_partials(contrib, part, actual, off, got, **extra)
        tiling.tile_partials_plain(contrib, part, actual, off, want, **extra)
        # the additive and extreme modes count under the kernel's name
        label = name if mode in ("square", "centred") else "tile_partials"
        for lane in want:
            if lane in ("cnt", "present", "lo", "hi"):
                checks.exact(label, "tile %s %s" % (mode, lane), got[lane],
                             want[lane], lane)
            else:
                checks.values(label, "tile %s %s" % (mode, lane), got[lane],
                              want[lane])
        if mode == "extreme":
            idx = grows[:, None].expand(-1, w)
            lo_src = torch.where(ok, contrib, math.inf)
            hi_src = torch.where(ok, contrib, -math.inf)
            lo_acc = torch.full((GROUPS, w), math.inf, dtype=torch.float64,
                                device=dev)
            hi_acc = torch.full((GROUPS, w), -math.inf, dtype=torch.float64,
                                device=dev)

            def library():
                lo_acc.scatter_reduce_(0, idx, lo_src, "amin")
                hi_acc.scatter_reduce_(0, idx, hi_src, "amax")
            # the tile read once (10 B a cell), cnt, present, lo and hi of
            # its groups read and written once
            nbytes = rows * w * 10 + 2 * g_tile * w * 32
            what = "scatter_reduce_ amin and amax"
        else:
            if mode == "additive":
                operand = torch.cat([x, ok.double(), actual.double()], dim=1)
                # cnt, present and tot read and written once
                nbytes = rows * w * 10 + 2 * g_tile * w * 24
                what = "index_add_ of the stacked sums, counts and presence"
            elif mode == "square":
                operand = torch.cat([ok.double(), actual.double(), x * x],
                                    dim=1)
                # the tile read once (contrib, participate and present:
                # 10 B a cell), cnt, present and sq of its groups read
                # and written once
                nbytes = rows * w * 10 + 2 * g_tile * w * 24
                what = ("index_add_ of the precomputed counts, presence and "
                        "squares")
            else:
                c = torch.where(ok, contrib - mean[grows], 0.0)
                operand = c * c
                # contrib and participate read once (9 B a cell; the
                # centred branch reads no presence), the mean and m2
                # read, m2 written
                nbytes = rows * w * 9 + g_tile * w * 24
                what = "index_add_ of the precomputed centred squares"
            into = torch.zeros((GROUPS, operand.shape[1]),
                               dtype=torch.float64, device=dev)

            def library():
                into.index_add_(0, grows, operand)
        acc = tiling.new_lane_fold(GROUPS, w, mode, dev)
        ms, dms = both_ms(lambda: tiling.tile_partials(
            contrib, part, actual, off, acc, **extra))
        lib, lib_dms = both_ms(library)
        t = {
            "ms": ms, "device_ms": dms,
            "plain_ms": time_ms(lambda: tiling.tile_partials_plain(
                contrib, part, actual, off, acc, **extra)),
            "bound_ms": bound_ms(nbytes, 3.0 * rows * w),
            "library_ms": lib, "library_device_ms": lib_dms,
        }
        if mode == "centred":
            _t1_host_split(dev, contrib, part, actual, off, acc, mean,
                           library)
        print("time %s tile [%d, %d], %d groups: kernel wall %.4f ms device "
              "%s  plain %.4f ms  bound %.4f ms (bytes)  library wall %.4f "
              "ms device %s (%s)"
              % (name, rows, w, g_tile, t["ms"], _fmt(dms), t["plain_ms"],
                 t["bound_ms"], t["library_ms"], _fmt(lib_dms), what))
        if label == name:
            times[name] = t
    return times


def _mesh_tsdb(tsdb, mesh, **over):
    """The headline TSDB's state in a TSDB of its own over `mesh` (the
    device cache on, its first query building the entry inline)."""
    from opentsdb_tpu_torch.core import load_state
    from opentsdb_tpu_torch.utils.config import Config
    uid_maps = {kind: tsdb.uid_table(kind).snapshot()
                for kind in ("metric", "tagk", "tagv")}
    series = [(s.key.metric, dict(s.key.tags), *s.arrays())
              for s in tsdb.store.all_series()]
    return load_state(uid_maps, series, config=Config(
        {"tsd.core.auto_create_metrics": True, **AGG_OFF, **MATERIALIZE,
         **over}), device=tsdb.device, mesh=mesh)


def _same_json(checks, label, got: list, want: list) -> None:
    """An HTTP body against the in-process answer's JSON: groups and
    timestamps equal, values at rtol 1e-9."""
    if [(a["tags"], list(a["dps"])) for a in got] \
            != [(b["tags"], list(b["dps"])) for b in want] or not got:
        checks.failures.append("%s: groups or timestamps differ" % label)
        return
    gv = torch.tensor([float(v) for a in got for v in a["dps"].values()],
                      dtype=torch.float64)
    wv = torch.tensor([float(v) for b in want for v in b["dps"].values()],
                      dtype=torch.float64)
    checks.values("e2e mesh", label, gv, wv)


def _combine_times(mesh, dev, checks: Checks) -> dict:
    """The shared-device combine of four shards' sum:1h-avg partials
    (cnt, present, tot at 100 x 283) by CUDA events, against its byte
    bound and one torch.stack(...).sum(0) a lane."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.parallel import sharded
    w = ds.FixedWindows.for_range(START, END, INTERVAL_MS).count
    gen = torch.Generator(device=dev).manual_seed(18)
    accs = [{"cnt": torch.randint(0, 11, (GROUPS, w), generator=gen,
                                  device=dev),
             "present": torch.randint(0, 11, (GROUPS, w), generator=gen,
                                      device=dev),
             "tot": torch.rand((GROUPS, w), generator=gen, device=dev,
                               dtype=torch.float64)}
            for _ in range(mesh.size)]
    got = sharded._combine(mesh, accs)
    for lane in got:
        want = torch.stack([a[lane] for a in accs]).sum(0)
        checks.values("e2e mesh", "combine " + lane, got[lane], want)
    lanes = len(accs[0])
    t = {**kernel_ms(lambda: sharded._combine(mesh, accs)),
         "library_ms": time_ms(lambda: [torch.stack(
             [a[k] for a in accs]).sum(0) for k in accs[0]]),
         "bound_ms": bound_ms((mesh.size + 1) * lanes * GROUPS * w * 8,
                              (mesh.size - 1) * lanes * GROUPS * w)}
    print("time mesh combine (%d shards, %d lanes of [%d, %d]): %.4f ms  "
          "bound %.4f ms (bytes)  library %.4f ms (torch.stack(...).sum(0) "
          "a lane)" % (mesh.size, lanes, GROUPS, w, t["ms"], t["bound_ms"],
                       t["library_ms"]))
    return t


def mesh_phase(dev, tsdb, ts, val, h, checks: Checks) -> dict:
    """Phase 18 (b)-(e) on the headline TSDB's state (the threshold raised
    as in phase 4); returns the launch counts of their main path."""
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.parallel import make_mesh
    from opentsdb_tpu_torch.parallel.distributed import host_major_devices
    from opentsdb_tpu_torch.rollup.job import run_rollup_job
    from opentsdb_tpu_torch.utils.config import DEFAULTS

    cards = torch.cuda.device_count()
    if cards < 2:
        print("mesh: %d card visible: multi-GPU speed is not measured (a "
              "mesh of distinct devices needs two or more cards); the "
              "meshes below are four shards on cuda:0 and one-device NCCL"
              % cards)
    cfg = tsdb.config
    key = "tsd.query.streaming.point_threshold"
    threshold = cfg.get_string(key)
    cfg.override_config(key, MATERIALIZE[key])
    # the single-device answers and walls: the headline TSDB off its
    # default mesh (every card, where there are two or more)
    cfg.override_config("tsd.query.mesh.enable", "false")
    tsdb.dispatch_batcher = None
    virtual = make_mesh(devices=[dev] * MESH_SHARDS)
    one = make_mesh(devices=[dev])
    print("mesh (b): %d shards on %s, backend %s; (c): %s, backend %s"
          % (virtual.size, virtual.owner, virtual.backend, one.devices[0],
             one.backend))
    if virtual.backend != "shared" or one.backend != "nccl":
        checks.failures.append("mesh backends %s and %s, not shared and "
                               "nccl" % (virtual.backend, one.backend))
    combine = _combine_times(virtual, dev, checks)
    mtsdb = _mesh_tsdb(tsdb, virtual)
    ntsdb = _mesh_tsdb(tsdb, one)
    arms = [("(b) 4 shards", mtsdb), ("(c) NCCL", ntsdb)]
    if cards >= 2:
        # the distinct-device mesh over every card, against one card
        arms.append(("%d cards" % cards, _mesh_tsdb(
            tsdb, make_mesh(devices=host_major_devices()))))
    kernels.reset_launches()
    singles = {}
    for m in MESH_QUERIES:
        want, wall, _ = _timed_run(tsdb, m)
        singles[m] = want
        for arm, other in arms:
            got, mwall, st = _timed_run(other, m)
            _same_answer(checks, "mesh %s %s" % (arm, m), got, want,
                         exact=False)
            if st.get("meshDevices") != float(other.query_mesh().size) \
                    or st.get("deviceCacheHit") != 1.0:
                checks.failures.append("mesh %s %s: not a meshed hit (%s)"
                                       % (arm, m, st.get("meshDevices")))
            bitwise = torch.equal(*(torch.tensor(
                [v for r in res for _, v in r.dps],
                dtype=torch.float64).nan_to_num(-1.5)
                for res in (got, want)))
            print("e2e mesh %-12s %-30s wall %.1f ms (median of 3) against "
                  "%.1f ms on one device | gather %.1f h2d %.1f kernels %.1f "
                  "extract %.1f ms | bitwise %s | combine %.4f ms"
                  % (arm, m, mwall, wall, st["gatherMs"], st["h2dMs"],
                     st["kernelsMs"], st["extractMs"], bitwise,
                     combine["ms"]))
    # (b) and (c) through /api/query on each meshed TSDB's daemon
    for arm, other in arms:
        with Serving(other) as server:
            for m in MESH_QUERIES:
                path = "/api/query?start=%d&end=%d&m=%s" % (
                    START // 1000, END // 1000,
                    m.replace("{", "%7B").replace("}", "%7D"))
                t0 = time.perf_counter()
                status, _, body = _http_get(server.port, path)
                wall = (time.perf_counter() - t0) * 1e3
                if status != 200:
                    checks.failures.append("mesh HTTP %s %s: %d"
                                           % (arm, m, status))
                    continue
                _same_json(checks, "mesh http %s %s" % (arm, m),
                           json.loads(body),
                           [r.to_json() for r in singles[m]])
                print("e2e mesh http %-12s %-30s wall %.1f ms, %d bytes"
                      % (arm, m, wall, len(body)))
    # (d) one streamed query on the mesh: the cache detached, the default
    # threshold
    mtsdb = _mesh_tsdb(tsdb, virtual, **{key: DEFAULTS[key]})
    mtsdb.device_cache = None
    m = MESH_QUERIES[0]
    got, wall, st = _timed_run(mtsdb, m)
    _same_answer(checks, "mesh (d) streamed " + m, got, singles[m],
                 exact=False)
    print("e2e mesh (d) streamed %-30s wall %.1f ms (median of 3) | %d "
          "chunks, %s devices | pack %.1f h2d %.1f fold %.1f ms"
          % (m, wall, st.get("streamedChunks", 0), st.get("meshDevices"),
             st.get("streamPackMs", 0.0), st.get("streamH2dMs", 0.0),
             st.get("streamFoldMs", 0.0)))
    if st.get("meshDevices") != float(MESH_SHARDS) \
            or not st.get("streamedChunks"):
        checks.failures.append("mesh (d): the query did not stream on the "
                               "mesh")
    del mtsdb, ntsdb, arms
    torch.cuda.empty_cache()
    # (e) the rollup job on the one-device NCCL mesh, on a (2, 2) mesh (and
    # on four distinct cards, where there are) against the one-card job
    # with no mesh (one L1 launch a batch)
    meshes = [None, one, make_mesh(devices=[dev] * 4, shape=(2, 2))]
    if cards >= 4:
        meshes.append(make_mesh(devices=host_major_devices()[:4],
                                shape=(2, 2)))
    cells = []
    for mesh in meshes:
        rtsdb = _rollup_tsdb(dev, ts, val, h)
        if mesh is None:
            rtsdb.config.override_config("tsd.query.mesh.enable", "false")
        t0 = time.perf_counter()
        written = run_rollup_job(rtsdb, intervals=["1h"], mesh=mesh)
        print("e2e mesh (e) rollup job 1h on %s: %d cells a lane in %.3f s"
              % ("one card, no mesh" if mesh is None
                 else "a %s mesh on %s (%s)"
                 % (mesh.shape, ", ".join(sorted({str(d)
                                                  for d in mesh.devices})),
                    mesh.backend), written["1h"], time.perf_counter() - t0))
        cells.append({(lane, rtsdb.tsuid(s.key)): s.arrays()
                      for lane in ("sum", "count", "min", "max")
                      for s in rtsdb.rollup_store.lane("1h",
                                                       lane).all_series()})
        del rtsdb
    for other in cells[1:]:
        if sorted(cells[0]) != sorted(other) or not cells[0]:
            checks.failures.append("mesh (e): the lanes hold other series")
            continue
        for exact, lanes in ((True, ("count", "min", "max")),
                             (False, ("sum",))):
            keys = sorted(k for k in cells[0] if k[0] in lanes)
            got = [torch.from_numpy(other[k][i]).double() for k in keys
                   for i in (0, 1)]
            want = [torch.from_numpy(cells[0][k][i]).double() for k in keys
                    for i in (0, 1)]
            label = "mesh (e) rollup %s" % "/".join(lanes)
            if exact:
                checks.exact("e2e mesh", label, torch.cat(got),
                             torch.cat(want), "cells")
            else:
                checks.values("e2e mesh", label, torch.cat(got),
                              torch.cat(want))
    launches = dict(kernels.LAUNCHES)
    print("mesh launches %s" % json.dumps(launches))
    for name in ("tile_partials", "tile_partials.square",
                 "tile_partials.centred", "window_moments", "grid_fill_rate",
                 "group_order", "stream_fold", "stream_finish",
                 "lane_partials", "gather_windows"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the mesh "
                                   "path" % name)
    cfg.override_config(key, threshold)
    cfg.override_config("tsd.query.mesh.enable", "true")
    return launches


# -- phase 19: the group downsample (P1) and explain ----------------------

P1_NAMES = {"additive": "point_group_moments",
            "extreme": "point_group_moments.extreme",
            "square": "point_group_moments.square",
            "centred": "point_group_moments.centred"}
# the operations a point of each mode takes (adds, compares, multiplies)
P1_OPS = {"additive": 2.0, "extreme": 3.0, "square": 3.0, "centred": 4.0}


def _p1_batch(dev, ts, val, h):
    """The headline batch on `dev` for P1: holes where h % 11 == 0 and
    NaN values where h % 97 == 0 (both take no part)."""
    d_h = torch.from_numpy(h).to(dev)
    d_val = torch.from_numpy(val).to(dev)
    d_val = torch.where(d_h % 97 == 0, math.nan, d_val)
    mask = d_h % 11 != 0
    del d_h
    return torch.from_numpy(ts).to(dev), d_val, mask


def _interleaved_gid(gid) -> np.ndarray:
    """The headline gid permuted: every group's rows spread over the
    batch, in no order."""
    return gid[np.random.default_rng(19).permutation(gid.size)]


def _p1_library(mode, d_ts, d_val, mask, edges, gid_t, mean, g, w):
    """The library yardstick of one mode, its operand precomputed: one
    index_add_ (the sums and the counts as two columns) or one
    scatter_reduce_ (amin over the values and their negatives, so that
    one call gives both extremes) over the flat gid x W + window
    segment ids."""
    win = torch.searchsorted(edges, d_ts, right=True) - 1
    ok = mask & ~torch.isnan(d_val) & (win >= 0) & (win < w)
    seg = torch.where(ok, gid_t[:, None] * w + win, g * w).reshape(-1)
    del win
    x = torch.where(ok, d_val, 0.0).reshape(-1)
    if mode == "extreme":
        both = torch.cat([torch.where(ok.reshape(-1), x, math.inf),
                          torch.where(ok.reshape(-1), -x, math.inf)])
        seg2 = torch.cat([seg, seg + g * w + 1])
        into = torch.full((2 * (g * w + 1),), math.inf,
                          dtype=torch.float64, device=d_ts.device)
        return lambda: into.scatter_reduce_(0, seg2, both, "amin",
                                            include_self=True)
    if mode == "centred":
        mu = torch.cat([mean.reshape(-1), mean.new_zeros(1)])[seg]
        c = torch.where(ok.reshape(-1), x - mu, 0.0)
        operand = (c * c)[:, None]
    else:
        operand = torch.stack([x * x if mode == "square" else x,
                               ok.reshape(-1).double()], dim=1)
    into = torch.zeros((g * w + 1, operand.shape[1]), dtype=torch.float64,
                       device=d_ts.device)
    return lambda: into.index_add_(0, seg, operand)


def group_kernel_phase(dev, ts, val, gid, h, checks: Checks,
                       digests: dict | None = None) -> dict:
    """Phase 19 (a): P1 against its plain version on the headline batch
    (100 groups) at 1h windows (W = 283) and at 1m windows, on the
    headline gid and on a permuted, interleaved one, every mode: counts
    and extremes exact, sums at rtol 1e-9.  At 1h on the headline gid
    each mode is timed against its byte bound, the plain version and
    the library yardstick (``_p1_library``).  With `digests`, each
    case's lanes go in as sha256."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import lanes

    d_ts, d_val, mask = _p1_batch(dev, ts, val, h)
    times = {}
    for label, interval in (("1h", INTERVAL_MS), ("1m", 60_000)):
        plan = ds.FixedWindows.for_range(START, END, interval)
        edges = plan.window_edges(dev)
        w = plan.count
        for gname, g_host in (("headline", gid),
                              ("interleaved", _interleaved_gid(gid))):
            gid_t = torch.from_numpy(g_host).to(dev)
            members, offsets = lanes.group_members(gid_t, GROUPS)
            # the centred mode's mean from P1's own additive lanes: the
            # plain version's index_add_ adds in no fixed order on the
            # card, and the centred digests need the same mean every run
            first = lanes.point_group_moments(
                d_ts, d_val, mask, edges, members, offsets, "additive")
            mean = first["tot"] / first["cnt"].clamp(min=1)
            for mode, name in P1_NAMES.items():
                mu = mean if mode == "centred" else None
                got = lanes.point_group_moments(
                    d_ts, d_val, mask, edges, members, offsets, mode, mu)
                want = lanes.point_group_moments_plain(
                    d_ts, d_val, mask, edges, members, offsets, mode, mu)
                case = "%s %s gid %s" % (label, gname, mode)
                if digests is not None:
                    for lane in got:
                        digests["%s %s %s" % (name, case, lane)] = _digest(
                            got[lane])
                for lane in want:
                    if lane in ("cnt", "lo", "hi"):
                        checks.exact(name, case + " " + lane, got[lane],
                                     want[lane], lane)
                    else:
                        checks.values(name, case + " " + lane, got[lane],
                                      want[lane])
                del got, want
                if label != "1h" or gname != "headline":
                    continue
                lanes_out = len(lanes.P1_LANES[mode])
                # val and mask read once (9 B a point; ts only at the
                # window edges), each [G, W] lane written once, the mean
                # read in the centred mode
                nbytes = S * N * 9 + GROUPS * w * 8 * (
                    lanes_out + (mode == "centred"))
                library = _p1_library(mode, d_ts, d_val, mask, edges, gid_t,
                                      mean, GROUPS, w)
                t = {
                    **kernel_ms(lambda: lanes.point_group_moments(
                        d_ts, d_val, mask, edges, members, offsets, mode,
                        mu)),
                    "plain_ms": time_ms(lambda: lanes.point_group_moments_plain(
                        d_ts, d_val, mask, edges, members, offsets, mode,
                        mu), reps=3),
                    "bound_ms": bound_ms(nbytes, P1_OPS[mode] * S * N),
                    "library_ms": time_ms(library),
                }
                del library
                print("time %s [%d, %d] -> [%d, %d]: kernel %.4f ms, device "
                      "%s  plain %.4f ms  bound %.4f ms (bytes)  library %.4f "
                      "ms (%s over gid x W + window)"
                      % (name, S, N, GROUPS, w, t["ms"],
                         _fmt(t["device_ms"]), t["plain_ms"],
                         t["bound_ms"], t["library_ms"],
                         "one scatter_reduce_ amin of values and negatives"
                         if mode == "extreme" else "one index_add_"))
                times[name] = t
            del first, mean, members, offsets, gid_t
            torch.cuda.empty_cache()
    return times


def _plain_group_downsample(agg, d_ts, d_val, mask, edges, gid_t):
    """The plain composition on the card: P1's plain version over the
    whole batch (a centred second pass for dev), then the reference's
    finish."""
    from opentsdb_tpu_torch.ops import lanes
    from opentsdb_tpu_torch.ops.tiling import finish_lane_fold, lane_mode
    members, offsets = lanes.group_members(gid_t, GROUPS)
    acc = lanes.point_group_moments_plain(d_ts, d_val, mask, edges, members,
                                          offsets, lane_mode(agg))
    m2 = None
    if agg == "dev":
        mean = acc["tot"] / acc["cnt"].clamp(min=1).double()
        m2 = lanes.point_group_moments_plain(
            d_ts, d_val, mask, edges, members, offsets, "centred", mean)["m2"]
    out, om = finish_lane_fold(dict(acc, present=acc["cnt"]), agg, m2)
    return torch.where(om, out, math.nan), om


def group_mesh_phase(dev, ts, val, gid, h, checks: Checks) -> dict:
    """Phase 19 (b): ``sharded_group_downsample`` for each of the ten
    SHARDED_AGGS over the whole headline batch at 1h windows, on the
    interleaved gid, on four shards of cuda:0 shaped (4, 1) and (2, 2),
    on a one-device NCCL mesh and, with two or more cards, on a mesh of
    every card: each answer equal to the one-device answer (counts
    exact, values at rtol 1e-9) and to the plain composition; then
    ``dryrun_multichip(4, ["cuda:0"] * 4)``.  Returns the launch counts of
    this main path (reset just before it)."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.parallel import (SHARDED_AGGS, make_mesh,
                                             shard_series,
                                             sharded_group_downsample)
    from opentsdb_tpu_torch.parallel.distributed import host_major_devices
    from opentsdb_tpu_torch.tools.dryrun import dryrun_multichip

    cards = torch.cuda.device_count()
    d_ts, d_val, mask = _p1_batch(dev, ts, val, h)
    edges = ds.FixedWindows.for_range(START, END, INTERVAL_MS).window_edges(
        dev)
    g_host = _interleaved_gid(gid)
    gid_t = torch.from_numpy(g_host).to(dev)
    plain = {agg: _plain_group_downsample(agg, d_ts, d_val, mask, edges,
                                          gid_t)
             for agg in sorted(SHARDED_AGGS)}
    host = [x.cpu().numpy() for x in (d_ts, d_val, mask)]
    del d_ts, d_val, mask
    torch.cuda.empty_cache()
    meshes = [("one-device NCCL", make_mesh(devices=[dev])),
              ("(4, 1) on %s" % dev, make_mesh(devices=[dev] * 4,
                                               shape=(4, 1))),
              ("(2, 2) on %s" % dev, make_mesh(devices=[dev] * 4,
                                               shape=(2, 2)))]
    if cards >= 2:
        meshes.append(("%d cards" % cards,
                       make_mesh(devices=host_major_devices())))
    else:
        print("group downsample: %d card visible: multi-GPU is not measured "
              "(a mesh of distinct devices needs two or more cards)" % cards)
    kernels.reset_launches()
    one = {}
    for label, mesh in meshes:
        blocks = shard_series(mesh, *host)
        for agg in sorted(SHARDED_AGGS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, out, om = sharded_group_downsample(mesh, agg, blocks, g_host,
                                                  GROUPS, edges)
            out, om = out.to(dev), om.to(dev)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            want, want_mask = plain[agg]
            case = "%s %s" % (label, agg)
            checks.exact("e2e group", case + " mask", om, want_mask)
            if agg == "count":
                checks.exact("e2e group", case + " plain", out, want,
                             "counts")
            else:
                checks.values("e2e group", case + " plain", out, want)
            if agg in one:
                checks.exact("e2e group", case + " one-device mask", om,
                             one[agg][1])
                if agg == "count":
                    checks.exact("e2e group", case + " one-device", out,
                                 one[agg][0], "counts")
                else:
                    checks.values("e2e group", case + " one-device", out,
                                  one[agg][0])
            else:
                one[agg] = (out, om)
            print("e2e group downsample %-26s %-9s wall %.2f ms (%s, %d "
                  "live cells)" % (label, agg, wall, mesh.backend,
                                   int(om.sum())))
        del blocks
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        dryrun_multichip(4, [dev] * 4)
        print("dryrun_multichip(4, [%s] * 4) ok in %.2f s"
              % (dev, time.perf_counter() - t0))
    except AssertionError as e:
        checks.failures.append("dryrun_multichip: %s" % e)
    launches = dict(kernels.LAUNCHES)
    print("group launches %s" % json.dumps(
        {k: v for k, v in launches.items() if v}))
    for name in ("point_group_moments", "point_group_moments.additive",
                 "point_group_moments.extreme", "point_group_moments.square",
                 "point_group_moments.centred"):
        if launches[name] < 1:
            checks.failures.append("kernel %s never launched on the group "
                                   "downsample path" % name)
    return launches


def explain_phase(tsdb, checks: Checks) -> None:
    """Phase 19 (c): /api/query/explain over HTTP for phase 4's seven
    queries on the headline TSDB, as device-cache hits, as misses with
    the cache detached and streamed (the default threshold, the cache
    detached): each explained path and fingerprint equal to those of the
    same query then executed (the runner's verdict).  The launch counts
    are reset before each arm's explains and read after them: explain
    launches nothing."""
    from opentsdb_tpu_torch.ops import kernels
    from opentsdb_tpu_torch.utils.config import DEFAULTS

    cfg = tsdb.config
    key = "tsd.query.streaming.point_threshold"
    threshold = cfg.get_string(key)
    cache = tsdb.device_cache
    arms = (("hit", MATERIALIZE[key], cache),
            ("miss", MATERIALIZE[key], None),
            ("streamed", DEFAULTS[key], None))
    with Serving(tsdb) as server:
        for arm, limit, attached in arms:
            cfg.override_config(key, limit)
            tsdb.device_cache = attached
            explained = {}
            kernels.reset_launches()
            for m in STREAM_QUERIES:
                # the range in ms, as _query gives it to the runner
                path = "/api/query/explain?start=%d&end=%d&m=%s" % (
                    START, END, m.replace("{", "%7B").replace("}", "%7D"))
                t0 = time.perf_counter()
                status, _, body = _http_get(server.port, path)
                wall = (time.perf_counter() - t0) * 1e3
                if status != 200:
                    checks.failures.append("explain %s %s: %d %s"
                                           % (arm, m, status, body[:200]))
                    continue
                seg = json.loads(body)["subQueries"][0]["segments"][0]
                explained[m] = (seg["path"], seg["fingerprint"], wall)
            launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
            if launched:
                checks.failures.append("explain %s launched kernels: %s"
                                       % (arm, launched))
            for m, (path, fp, wall) in explained.items():
                runner = tsdb.new_query_runner()
                runner.run(_query(m))
                pd = runner.decisions[0]
                same = pd.path == path and pd.fingerprint == fp
                print("explain %-8s %-34s wall %.1f ms | %s %s | executed "
                      "%s %s | %s" % (arm, m, wall, path, fp, pd.path,
                                      pd.fingerprint,
                                      "same" if same else "DIFFERENT"))
                if not same:
                    checks.failures.append(
                        "explain %s %s: explained %s %s, executed %s %s"
                        % (arm, m, path, fp, pd.path, pd.fingerprint))
    tsdb.device_cache = cache
    cfg.override_config(key, threshold)


def cost_constants(dev, times: dict, measured: dict) -> dict:
    """The `cuda` table of ops/costmodel.py from this run: per-point and
    per-cell kernel times at the headline batch, the host launch floor,
    the lane costs phase 10 measured and the tiled costs of phase 15."""
    from opentsdb_tpu_torch.ops import downsample as ds
    from opentsdb_tpu_torch.ops import group_agg as ga
    from opentsdb_tpu_torch.ops.rate import RateOptions

    w = ds.FixedWindows.for_range(START, END, INTERVAL_MS).count
    tiny = [torch.zeros((1, 8), dtype=torch.int64, device=dev),
            torch.zeros((1, 8), dtype=torch.float64, device=dev),
            torch.ones((1, 8), dtype=torch.bool, device=dev)]
    edges = torch.tensor([0, 10], dtype=torch.int64, device=dev)
    ds.window_moments(*tiny, edges, "sum")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ds.window_moments(*tiny, edges, "sum")
    torch.cuda.synchronize()
    launch = (time.perf_counter() - t0) / 200
    v = torch.rand((S, w), dtype=torch.float64, device=dev)
    m = torch.ones((S, w), dtype=torch.bool, device=dev)
    wts = torch.arange(w, dtype=torch.int64, device=dev) * INTERVAL_MS
    k2_rate = time_ms(lambda: ga.grid_fill_rate(wts, v, m, "prev",
                                                RateOptions()))
    out = {
        "launch": launch,
        "downsample_point": times["window_moments"]["ms"] / 1e3 / (S * N),
        "order_point": times["window_order"]["ms"] / 1e3 / (S * N),
        "rate_cell": max(k2_rate - times["grid_fill_rate"]["ms"], 0.0)
        / 1e3 / (S * w),
        "group_cell": times["grid_fill_rate"]["ms"] / 1e3 / (S * w),
        "aggregate_cell": times["group_moments"]["ms"] / 1e3 / (GROUPS * w),
        **measured,
    }
    return out


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name:
    `..._cu_a5e3d54b20group_moments_kernelILi128ELi6ELb1EEEv...` ->
    `group_moments_kernel<128, 6, 1>` (integers, and type codes as
    letters: `window_order_kernel<2, l, d>`)."""
    import re
    # each digit run, and each of its tails, may be a name's length
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        at = m.start() + len(m.group(1))
        name = mangled[at:at + int(m.group(1))]
        if not name.endswith("_kernel"):
            continue
        rest, args = mangled[at + len(name):], []
        if rest.startswith("I"):
            for tok in re.finditer(r"L[a-z](\d+)E|([a-z])|(E)", rest[1:]):
                if tok.group(3):
                    break
                args.append(tok.group(1) or tok.group(2))
        return "%s<%s>" % (name, ", ".join(args)) if args else name
    return mangled


def ptxas_report(lines: list[str]) -> list[str]:
    """kernels.resources' lines, one a kernel instance: its name and
    template arguments, then ptxas's words for it."""
    merged: dict[str, list[str]] = {}
    for line in lines:
        mangled, info = line.split(" ", 1)
        merged.setdefault(_kernel_name(mangled), []).append(info)
    return ["%s %s" % (k, "; ".join(v)) for k, v in merged.items()]


def kernel_rows(times: dict, launches: dict, checks: Checks) -> list:
    """The `kernels` line's rows.  A timed case of a kernel
    (group_moments.fanin, moving_average.grid) is not a form of its own:
    it carries the kernel's launches, and its errors where its checks are
    the kernel's."""
    rows = []
    for name, t in times.items():
        base = name.split(".")[0]
        worst = checks.worst.get(name) or checks.worst[base]
        rows.append({
            "name": name, "route": "cuda",
            "source": "opentsdb_tpu_torch/csrc/%s.cu" % base,
            "replaces": REPLACES[name],
            "launches": launches[name if name in launches else base],
            "max_abs_err": worst["abs"], "max_rel_err": worst["rel"],
            "max_err_of_limit": worst["to_limit"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"),
            "library_ms": t["library_ms"], "device_ms": t.get("device_ms"),
            "library_device_ms": t.get("library_device_ms"),
            "chain_bound_ms": t.get("chain_bound_ms")})
    return rows


def hold_digests(checks: Checks, label: str, digests: dict | None,
                 digests_file: str | None, reported=()) -> None:
    """Write `digests` (name -> sha256) to `digests_file`, or, where it
    exists, fail each one that differs from the file's, except those whose
    name ends with one of `reported` (printed only)."""
    if digests is None or not digests_file:
        return
    if not os.path.exists(digests_file):
        with open(digests_file, "w") as fh:
            json.dump(digests, fh, indent=1)
        print("%s outputs' digests written to %s" % (label, digests_file))
        return
    with open(digests_file) as fh:
        before = json.load(fh)
    for name, digest in digests.items():
        same = before.get(name) == digest
        print("%s outputs %-40s %s %s" % (
            label, name, "equal bit for bit to" if same else "DIFFER from",
            digests_file))
        if not same and not name.endswith(tuple(reported)):
            checks.failures.append("%s: outputs differ from %s"
                                   % (name, digests_file))


def union_only(dev, ts, val, gid, h, checks: Checks,
               u3_file: str | None, u2_file: str | None) -> None:
    """`--union-only`: MA at the downsample and grid positions, U1 and U2
    in phase 5's cases (a)-(c) with U2's timed cases, U3 and MA in the
    same cases, then phase 6's union queries on the headline TSDB.  With
    `u3_file` (`u2_file`), U3's and MA's (U2's) outputs' sha256 are
    written there, or held to the ones it holds (U3's mult reported, not
    failed: the shallow groups' product is the ordered walk itself, a
    tree before it combined in another order)."""
    u3 = {} if u3_file else None
    u2 = {} if u2_file else None
    t_start = time.perf_counter()
    ma_positions_phase(dev, ts, val, gid, checks, u3)
    torch.cuda.empty_cache()
    print_times(u2_phase(dev, ts, val, gid, h, checks, u2))
    torch.cuda.empty_cache()
    union_order_phase(dev, ts, val, gid, h, checks, u3)
    torch.cuda.empty_cache()
    tsdb, _ = headline_tsdb(dev, ts, val)
    union_e2e_phase(dev, tsdb, ts, h, checks)
    del tsdb
    torch.cuda.empty_cache()
    print("union-only wall %.1f s" % (time.perf_counter() - t_start))
    hold_digests(checks, "union", u3, u3_file, reported=(" mult",))
    hold_digests(checks, "u2", u2, u2_file)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="mixed into the data of phases 11-13 (0: "
                        "bench_configs' own chunks)")
    parser.add_argument("--fold-only", action="store_true",
                        help="build the kernels and run the grouped fold's "
                        "timed cases alone: K3 (a)-(c) and T1's four modes "
                        "on phase 18 (a)'s tile; prints no result line")
    parser.add_argument("--fill-only", action="store_true",
                        help="build the kernels and run K2's and H1's timed "
                        "cases alone: K2 (a)-(e) (fill_phase) and phase 7 "
                        "on the latency fleet built by load_state; prints "
                        "no result line")
    parser.add_argument("--k2-digests", metavar="FILE",
                        help="with --fill-only: write the sha256 of K2's "
                        "outputs in each case to FILE, or, where FILE "
                        "exists, fail unless they equal its digests")
    parser.add_argument("--h2-digests", metavar="FILE",
                        help="with --fill-only: write the sha256 of H2's "
                        "outputs in every phase 7 case and edge case to "
                        "FILE, or, where FILE exists, fail unless they "
                        "equal its digests")
    parser.add_argument("--union-only", action="store_true",
                        help="build the kernels and run the union path's "
                        "timed cases alone: MA at the downsample and grid "
                        "positions, U1's case (b), U3 and MA in phase 5's "
                        "cases (a)-(c), then phase 6; prints no result line")
    parser.add_argument("--u3-digests", metavar="FILE",
                        help="with --union-only: write the sha256 of U3's "
                        "and MA's outputs in each case to FILE, or, where "
                        "FILE exists, fail unless they equal its digests "
                        "(U3's mult, the ordered product, may differ: "
                        "reported, not failed)")
    parser.add_argument("--u2-digests", metavar="FILE",
                        help="with --union-only: write the sha256 of U2's "
                        "outputs under every moment aggregator in cases "
                        "(a)-(c) to FILE, or, where FILE exists, fail "
                        "unless they equal its digests")
    parser.add_argument("--sketch-only", action="store_true",
                        help="build the kernels and run S2's cases alone: "
                        "phase 11 (d) on the headline chunks, the \"0all\" "
                        "runs and the edge runs, then phase 12's streamed "
                        "sum:1h-p95 on the headline TSDB; prints no result "
                        "line")
    parser.add_argument("--s2-digests", metavar="FILE",
                        help="with --sketch-only: write the sha256 of the "
                        "folded sketch in each S2 case to FILE, or, where "
                        "FILE exists, fail unless they equal its digests")
    parser.add_argument("--stream-fold-only", action="store_true",
                        help="build the kernels and run S1's cases alone: "
                        "phase 11's two headline chunks, the wrong slice's "
                        "audit, the timed headline chunk and config 2's "
                        "chunks; prints no result line")
    parser.add_argument("--s1-digests", metavar="FILE",
                        help="with --stream-fold-only: write the sha256 of "
                        "the folded state in each S1 case to FILE, or, "
                        "where FILE exists, fail unless they equal its "
                        "digests")
    parser.add_argument("--group-only", action="store_true",
                        help="build the kernels and run phase 19 (a) alone: "
                        "P1 in every mode at 1h and 1m on the headline and "
                        "the interleaved gid, timed at 1h; prints no result "
                        "line")
    parser.add_argument("--p1-digests", metavar="FILE",
                        help="with --group-only: write the sha256 of P1's "
                        "lanes in each case to FILE, or, where FILE exists, "
                        "fail unless they equal its digests")
    parser.add_argument("--order-only", action="store_true",
                        help="build the kernels and run K5's cases (a)-(e) "
                        "and R's (a)-(c) alone, each against its plain "
                        "version, timed at the shapes the main path "
                        "launches them at; prints no result line")
    parser.add_argument("--k5-digests", metavar="FILE",
                        help="with --order-only: write the sha256 of K5's "
                        "outputs under every aggregator in each case to "
                        "FILE, or, where FILE exists, fail unless they "
                        "equal its digests (mult, the ordered product, may "
                        "differ: reported, not failed)")
    parser.add_argument("--r-digests", metavar="FILE",
                        help="with --order-only: write the sha256 of R's "
                        "outputs under every rate option set in each case "
                        "to FILE, or, where FILE exists, fail unless they "
                        "equal its digests")
    parser.add_argument("--mesh-only", action="store_true",
                        help="build the kernels and run phase 18 alone on "
                        "the headline TSDB (every visible card: with two "
                        "or more it times their mesh against one card); "
                        "prints no result line")
    # phase 16's clients run in a child process of their own
    parser.add_argument("--fleet-client", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.fleet_client:
        return fleet_client(json.loads(args.fleet_client))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "opentsdb_tpu_torch")):
        print("chip_smoke: opentsdb_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from opentsdb_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    t_start = t0 = time.perf_counter()
    kernels.load_all()
    print("kernel build %.2f s" % (time.perf_counter() - t0))
    # the redesigned kernels' registers, shared memory and spills
    for name in ("window_order", "union_merge", "group_moments",
                 "tile_partials", "grid_fill_rate", "histogram_accumulate",
                 "union_order", "moving_average", "union_reduce",
                 "sketch_fold", "stream_fold", "point_group_moments",
                 "group_order", "point_rate", "histogram_percentile"):
        for line in ptxas_report(kernels.resources(name)):
            print("ptxas %s %s" % (name, line))

    dev = torch.device("cuda")
    checks = Checks()
    ts, val, gid, h = headline_batch()
    if args.fill_only:
        fill_phase(dev, ts, val, h, checks, args.k2_digests)
        torch.cuda.empty_cache()
        h2 = {} if args.h2_digests else None
        histogram_kernel_phase(dev, fleet_tsdb(dev), checks, h2)
        hold_digests(checks, "h2", h2, args.h2_digests)
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    if args.order_only:
        order_only(dev, ts, val, gid, h, checks, args.k5_digests,
                   args.r_digests)
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    if args.union_only:
        union_only(dev, ts, val, gid, h, checks, args.u3_digests,
                   args.u2_digests)
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    if args.sketch_only:
        s2 = {} if args.s2_digests else None
        print_times(sketch_phase(dev, ts, val, h, checks, s2))
        torch.cuda.empty_cache()
        stream_p95_phase(dev, ts, val, checks)
        # the infinite edge runs' NaN grid points sort last in the merge,
        # as the reference's argsort orders them; a build that keyed a NaN
        # by its sign bit differs there: reported, not failed
        hold_digests(checks, "s2", s2, args.s2_digests,
                     reported=(" inf values",))
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    if args.stream_fold_only or args.group_only:
        if args.stream_fold_only:
            s1 = {} if args.s1_digests else None
            print_times(stream_fold_cases(dev, ts, val, h, checks, args.seed,
                                          s1))
            hold_digests(checks, "s1", s1, args.s1_digests)
            torch.cuda.empty_cache()
        if args.group_only:
            p1 = {} if args.p1_digests else None
            group_kernel_phase(dev, ts, val, gid, h, checks, p1)
            hold_digests(checks, "p1", p1, args.p1_digests)
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    if args.fold_only:
        fold_phase(dev, ts, val, gid, h, checks)
        torch.cuda.empty_cache()
        mesh_kernel_phase(dev, ts, val, gid, h, checks)
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    if args.mesh_only:
        tsdb, _ = headline_tsdb(dev, ts, val)
        tsdb.new_query_runner().run(_query(MESH_QUERIES[0]))
        t_phase = time.perf_counter()
        mesh_kernel_phase(dev, ts, val, gid, h, checks)
        mesh_phase(dev, tsdb, ts, val, h, checks)
        print("phase 18 wall %.1f s" % (time.perf_counter() - t_phase))
        t_phase = time.perf_counter()
        group_kernel_phase(dev, ts, val, gid, h, checks)
        group_mesh_phase(dev, ts, val, gid, h, checks)
        print("phase 19 (a, b) wall %.1f s" % (time.perf_counter() - t_phase))
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        print(smi)
        return 1 if checks.failures else 0
    times = kernel_phase(dev, ts, val, gid, h, checks)
    torch.cuda.empty_cache()
    times.update(order_kernel_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    times.update(ma_positions_phase(dev, ts, val, gid, checks))
    torch.cuda.empty_cache()
    times.update(gather_phase(dev, ts, val, gid, checks))
    torch.cuda.empty_cache()
    tsdb, launches = e2e_phase(dev, ts, val, checks)
    torch.cuda.empty_cache()
    times.update(union_kernel_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    times.update(union_order_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    union_launches = union_e2e_phase(dev, tsdb, ts, h, checks)
    torch.cuda.empty_cache()
    times.update(lane_kernel_phase(dev, ts, val, h, checks))
    torch.cuda.empty_cache()
    times.update(tile_kernel_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    fleet = histogram_fleet()
    with Serving(tsdb) as server:
        daemon_ingest(tsdb, server.port, fleet, checks)
        del fleet
        times.update(histogram_kernel_phase(dev, tsdb, checks))
        torch.cuda.empty_cache()
        daemon_launches = daemon_query_phase(dev, tsdb, server, checks)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    stream_launches = stream_e2e_phase(dev, tsdb, checks)
    print("phase 12 wall %.1f s" % (time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tiled_launches, tiled_costs = tiled_e2e_phase(dev, tsdb, checks)
    print("phase 15 (a, b) wall %.1f s" % (time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    stacked_times, stacked_costs = stacked_kernel_phase(dev, ts, val, checks)
    times.update(stacked_times)
    torch.cuda.empty_cache()
    fleet_launches = fleet_phase(dev, tsdb, checks)
    print("phase 16 wall %.1f s" % (time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    times.update(int32_kernel_phase(dev, ts, val, gid, h, checks, times))
    torch.cuda.empty_cache()
    hit_launches, hit_costs = cache_hit_phase(dev, tsdb, checks, times)
    print("phase 17 wall %.1f s" % (time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    times.update(mesh_kernel_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    mesh_launches = mesh_phase(dev, tsdb, ts, val, h, checks)
    print("phase 18 wall %.1f s" % (time.perf_counter() - t_phase))
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    times.update(group_kernel_phase(dev, ts, val, gid, h, checks))
    torch.cuda.empty_cache()
    group_launches = group_mesh_phase(dev, ts, val, gid, h, checks)
    torch.cuda.empty_cache()
    explain_phase(tsdb, checks)
    print("phase 19 wall %.1f s" % (time.perf_counter() - t_phase))
    del tsdb
    torch.cuda.empty_cache()
    rollup_launches, lane_costs, rtsdb = rollup_e2e_phase(dev, ts, val, h,
                                                          checks)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    striped_launches = striped_lane_phase(dev, rtsdb, checks)
    print("phase 15 (c) wall %.1f s" % (time.perf_counter() - t_phase))
    del rtsdb
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    times.update(stream_kernel_phase(dev, ts, val, h, checks, args.seed))
    del ts, val, gid, h
    torch.cuda.empty_cache()
    print("phase 11 wall %.1f s" % (time.perf_counter() - t_phase))
    t_phase = time.perf_counter()
    for cid in CONFIGS:
        config_phase(dev, cid, checks, args.seed)
        torch.cuda.empty_cache()
    print("phase 13 wall %.1f s; the script %.1f s"
          % (time.perf_counter() - t_phase, time.perf_counter() - t_start))
    print("costmodel cuda %s" % json.dumps(cost_constants(
        dev, times, {**lane_costs, **tiled_costs, **stacked_costs,
                     **hit_costs})))

    # Each kernel's launches on the main path: the grouped, union, daemon,
    # streamed, rollup, tiled, striped, fleet, cache-hit, mesh and group
    # downsample phases, their counts reset just before each.
    for name in launches:
        launches[name] += (union_launches[name] + daemon_launches[name]
                           + stream_launches[name] + rollup_launches[name]
                           + tiled_launches[name] + striped_launches[name]
                           + fleet_launches[name] + hit_launches[name]
                           + mesh_launches[name] + group_launches[name])
    print(json.dumps({"kernels": kernel_rows(times, launches, checks)}))
    if checks.failures:
        for f in checks.failures:
            print("FAILED: " + f, file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
