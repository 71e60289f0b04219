"""Fused multi-query dispatch: concurrent small grouped queries share one
launch of each kernel.

Port of opentsdb_tpu/query/batcher.py.  At dashboard-fleet rates the
per-dispatch floor, not the arithmetic, caps throughput: a panel's grouped
query pays at least three launches (K1 or K4, K2, K3 or K5) and the host
round trips around them.  Plans that the routing verdict prices as
dispatch-bound (query/plandecision.py, path ``batched``) meet here, are
bucketed by compatibility, and run as ONE stacked dispatch
(ops/pipeline.stacked_group_outputs): the members' [S, N] batches stacked
on the host into one [Q*S, N] batch, copied to the device once, each
kernel launched once for all members (K1/K4 and K2 read each member's own
window edges; K3/K5 reduce every member's groups), the outputs copied back
once and sliced per member on the host.  A member's slice is bit for bit
its solo dispatch's: every kernel runs the same code on each row.

The rendezvous is the reference's.  The first member of a bucket leads: it
holds the bucket open for ``tsd.query.batch.hold_ms`` only while the
admission gate shows other queries in flight (an uncontended query never
waits), seals it at ``tsd.query.batch.max_q`` members or
``tsd.query.batch.max_mb`` of operands, dispatches once and hands out the
slices.  Q = 1 runs the solo pipeline.  Deadlines stay per member: a member
whose deadline expires or is cancelled while it waits leaves the bucket
without its siblings noticing; the leader drops expired members, its own
included, before stacking.

Deliberate differences: the bucket key has no mode-policy epoch (the port
has no kernel modes) and no host-lane flag (no host lane), and the member
axis is not padded to a power of four (the reference pads it to bound jit
recompiles; the port compiles nothing per shape, and padding would launch
wasted members).  The counts are ``collect_stats`` tallies.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from opentsdb_tpu_torch.obs import latattr
from opentsdb_tpu_torch.ops.pipeline import (
    run_group_pipeline, split_members, stacked_group_outputs)
from opentsdb_tpu_torch.query.limits import QueryException

# Waiting members re-check their own deadline on this cadence even without
# a notification (a cancellation flips a token without notifying).
_WAIT_TICK_S = 0.05

# distinct bucket keys remembered for collect_stats
_MAX_KEYS = 1024


class _Member:
    """One submitted plan: operands in, its host slice (or an error) out.
    State moves under the batcher's lock; `done` flips once."""

    __slots__ = ("ts", "val", "mask", "gid", "num_groups", "edges",
                 "deadline", "done", "result", "error", "abandoned")

    def __init__(self, ts, val, mask, gid, num_groups, edges, deadline):
        self.ts = ts
        self.val = val
        self.mask = mask
        self.gid = gid
        self.num_groups = num_groups
        self.edges = edges
        self.deadline = deadline
        self.done = False        # guarded-by: DispatchBatcher._lock
        self.result = None       # guarded-by: DispatchBatcher._lock
        self.error = None        # guarded-by: DispatchBatcher._lock
        self.abandoned = False   # guarded-by: DispatchBatcher._lock

    def nbytes(self) -> int:
        return (self.ts.nbytes + self.val.nbytes + self.mask.nbytes
                + self.gid.nbytes)

    def expired(self) -> bool:
        d = self.deadline
        return d is not None and (d.is_cancelled() or d.expired())


class _Bucket:
    """One open coalesce window of compatible members."""

    __slots__ = ("key", "members", "sealed", "nbytes")

    def __init__(self, key):
        self.key = key
        self.members: list[_Member] = []  # guarded-by: DispatchBatcher._lock
        self.sealed = False               # guarded-by: DispatchBatcher._lock
        self.nbytes = 0                   # guarded-by: DispatchBatcher._lock


def bucket_key(spec, num_groups: int, ts, val, gid, edges) -> tuple:
    """The compatibility key: members stack when they share the pipeline
    (PipelineSpec is frozen), the group count, the operands' shapes and
    dtypes and the window count."""
    return (spec, int(num_groups), tuple(ts.shape), val.dtype.str,
            gid.dtype.str, tuple(edges.shape))


class DispatchBatcher:
    """The rendezvous: ``submit`` blocks until this plan's slice (or its
    bucket's error) is ready, electing one submitting thread a bucket to
    dispatch.  One a TSDB (``tsdb.dispatch_batcher``), on the TSDB's
    device."""

    def __init__(self, config, tsdb):
        self.enabled = config.get_bool("tsd.query.batch.enable")
        self.hold_ms = max(config.get_int("tsd.query.batch.hold_ms"), 0)
        self.max_q = max(config.get_int("tsd.query.batch.max_q"), 1)
        self.max_bytes = max(
            config.get_int("tsd.query.batch.max_mb"), 1) * 2 ** 20
        self._tsdb = tsdb
        self.device = torch.device(tsdb.device)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buckets: dict[tuple, _Bucket] = {}  # guarded-by: _lock
        self._keys: set = set()                   # guarded-by: _lock
        self.stacked_dispatches = 0  # guarded-by: _lock
        self.stacked_members = 0     # guarded-by: _lock
        self.solo_dispatches = 0     # guarded-by: _lock
        # answered submits and their coalesce waits (the rendezvous, the
        # shared dispatch included), the reference's wait_ms histogram
        # as a sum
        self.queries = 0             # guarded-by: _lock
        self.wait_ms = 0.0           # guarded-by: _lock
        # the dispatches' host wall and the dispatching thread's CPU time
        # in them (their gap is time spent waiting: for the GIL, or for
        # the device), and the wall of the copies back, which wait for
        # the work queued before them on the stream
        self.dispatch_ms = 0.0       # guarded-by: _lock
        self.dispatch_cpu_ms = 0.0   # guarded-by: _lock
        self.copy_back_ms = 0.0      # guarded-by: _lock

    def _concurrent_demand(self) -> int:
        """Queries holding or waiting for admission permits: the leader's
        evidence that a sibling may arrive within the hold."""
        gate = getattr(self._tsdb, "admission_gate", None)
        if gate is None:
            return 0
        return gate.demand()

    def submit(self, spec, ts: np.ndarray, val: np.ndarray,
               mask: np.ndarray, gid, num_groups: int, edges: np.ndarray,
               deadline=None):
        """Run one batch-routed plan: its host operands ts, val, mask
        [S, N], gid [S] and window edges [W+1].  Returns ((wts[W],
        out[G, W], out_mask[G, W]) as numpy arrays, info) with info the
        batch verdict {q, stacked, waitMs}.  Raises the member's own
        deadline error when it expires while coalescing; its siblings are
        unaffected."""
        member = _Member(ts, val, mask, np.asarray(gid, np.int64),
                         int(num_groups), np.asarray(edges, np.int64),
                         deadline)
        t0 = time.monotonic()
        key = bucket_key(spec, num_groups, ts, val, member.gid,
                         member.edges)
        with self._lock:
            if len(self._keys) < _MAX_KEYS:
                self._keys.add(key)
            bucket = self._buckets.get(key)
            leader = bucket is None
            if leader:
                bucket = _Bucket(key)
                self._buckets[key] = bucket
            bucket.members.append(member)
            bucket.nbytes += member.nbytes()
            full = (len(bucket.members) >= self.max_q
                    or bucket.nbytes >= self.max_bytes)
            if full and not bucket.sealed:
                bucket.sealed = True
                del self._buckets[bucket.key]
                self._cv.notify_all()
        if leader:
            self._lead(spec, bucket, full, t0)
        else:
            self._follow(bucket, member)
        with self._lock:
            if member.error is not None:
                raise member.error
            result = member.result
            abandoned = member.abandoned
        if abandoned:
            # the deadline died while the bucket held: the member leaves
            # without an answer (its own 413 or 503), its siblings keep
            # theirs
            member.deadline.check()
            raise QueryException(
                "Sorry, your query's deadline expired while batched.")
        # the coalesce wait (a follower's holds the leader's shared
        # dispatch) is the request's batch_rendezvous: the planner's
        # "dispatch" mark right after this returns reads ~0
        latattr.mark("batch_rendezvous")
        q = result[3]
        waited_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self.queries += 1
            self.wait_ms += waited_ms
        return result[:3], {"q": q, "stacked": q > 1,
                            "waitMs": round(waited_ms, 3)}

    def _follow(self, bucket: _Bucket, member: _Member) -> None:
        """Wait for the leader's dispatch; leave alone on expiry."""
        with self._lock:
            while not member.done:
                if member.expired():
                    if not bucket.sealed:
                        # still coalescing: step out so that the leader
                        # never stacks a dead member
                        bucket.members.remove(member)
                        bucket.nbytes -= member.nbytes()
                    member.abandoned = True
                    member.done = True
                    break
                self._cv.wait(_WAIT_TICK_S)

    def _lead(self, spec, bucket: _Bucket, already_full: bool,
              t0: float) -> None:
        """Hold the window, seal, dispatch once, hand out the slices."""
        if not already_full:
            hold_s = self.hold_ms / 1e3 if self.hold_ms > 0 \
                and self._concurrent_demand() > 1 else 0.0
            until = t0 + hold_s
            with self._lock:
                while not bucket.sealed:
                    remaining = until - time.monotonic()
                    if remaining <= 0:
                        bucket.sealed = True
                        self._buckets.pop(bucket.key, None)
                        break
                    self._cv.wait(min(remaining, _WAIT_TICK_S))
        with self._lock:
            # drop members whose deadline died while the window held, the
            # leader's own included: submitting first does not outrank
            # the deadline
            live = []
            for m in bucket.members:
                if m.abandoned:
                    continue
                if m.expired():
                    m.abandoned = True
                    m.done = True
                    continue
                live.append(m)
            self._cv.notify_all()
        wall0, cpu0 = time.perf_counter(), time.thread_time()
        try:
            outs = self._dispatch(spec, live)
        except BaseException as e:
            with self._lock:
                for m in live:
                    m.error = e
                    m.done = True
                self._cv.notify_all()
            if isinstance(e, Exception):
                return          # each member raises it from submit()
            raise
        with self._lock:
            self.dispatch_ms += (time.perf_counter() - wall0) * 1e3
            self.dispatch_cpu_ms += (time.thread_time() - cpu0) * 1e3
            for m, out in zip(live, outs):
                m.result = out
                m.done = True
            self._cv.notify_all()

    def _dispatch(self, spec, live: list[_Member]) -> list:
        """One dispatch for the sealed bucket: Q = 1 runs the solo
        pipeline; Q > 1 stacks the members' operands on the host, copies
        them to the device once, launches each kernel once and copies the
        outputs back once, then slices them per member."""
        q = len(live)
        if q == 0:
            return []
        dev = self.device
        if q == 1:
            m = live[0]
            out = run_group_pipeline(
                spec, *(torch.from_numpy(x).to(dev)
                        for x in (m.ts, m.val, m.mask)),
                m.gid, m.num_groups, torch.from_numpy(m.edges).to(dev))
            with self._lock:
                self.solo_dispatches += 1
            return [self._copy_back(out) + (1,)]
        ts, val, mask = (torch.from_numpy(np.concatenate(
            [getattr(m, name) for m in live])).to(dev)
            for name in ("ts", "val", "mask"))
        edges = torch.from_numpy(np.stack([m.edges for m in live])).to(dev)
        groups = [m.num_groups for m in live]
        outs = stacked_group_outputs(spec, ts, val, mask,
                                     np.stack([m.gid for m in live]),
                                     groups, edges)
        members = split_members(self._copy_back(outs), groups)
        with self._lock:
            self.stacked_dispatches += 1
            self.stacked_members += q
        return [out + (q,) for out in members]

    def _copy_back(self, outs) -> tuple:
        """The dispatch's outputs as host arrays, the copies timed."""
        t0 = time.perf_counter()
        host = tuple(x.cpu().numpy() for x in outs)
        with self._lock:
            self.copy_back_ms += (time.perf_counter() - t0) * 1e3
        return host

    def collect_stats(self) -> dict:
        with self._lock:
            return {
                "tsd.query.batch.stacked_dispatches": float(
                    self.stacked_dispatches),
                "tsd.query.batch.stacked_members": float(
                    self.stacked_members),
                "tsd.query.batch.solo_dispatches": float(
                    self.solo_dispatches),
                "tsd.query.batch.keys": float(len(self._keys)),
                "tsd.query.batch.queries": float(self.queries),
                "tsd.query.batch.wait_ms": self.wait_ms,
                "tsd.query.batch.dispatch_ms": self.dispatch_ms,
                "tsd.query.batch.dispatch_cpu_ms": self.dispatch_cpu_ms,
                "tsd.query.batch.copy_back_ms": self.copy_back_ms,
            }
