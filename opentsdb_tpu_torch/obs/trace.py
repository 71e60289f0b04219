"""Span-tree tracer for query serving.

Port of opentsdb_tpu/obs/trace.py.  One ``Trace`` a request (started by
RpcManager.handle_http when ``tsd.trace.enable`` is on), a stack of
nested ``Span``s that the request's handler thread pushes and pops, and
explicit ``child()`` spans for work that hops threads.  The planner and
the RPC layer annotate stages through the AMBIENT trace (``stage()``),
which costs next to nothing when no trace is active: library callers of
QueryRunner.run() see no change.

Span times:

* ``wallMs``: a stage's start-to-finish wall time.
* ``deviceMs``: the time a stage waited for its device work
  (``device_wait``, with ``tsd.trace.device_time``).  Kernels launch
  asynchronously on torch's current stream, so this is the queue and
  run time of the work the stage enqueued: a synchronize of the
  outputs' stream, timed on the host clock.  It copies nothing to the
  host.

Trace ids travel in the ``X-TSDB-Trace-Id`` header: handle_http adopts
an incoming one.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from contextlib import contextmanager

import torch

TRACE_HEADER = "x-tsdb-trace-id"


def _new_trace_id() -> str:
    return struct.unpack("<Q", os.urandom(8))[0].__format__("016x")


class Span:
    """One named stage; a node of the trace tree."""

    __slots__ = ("name", "tags", "children", "start", "wall_ms",
                 "device_ms")

    def __init__(self, name: str, **tags):
        self.name = name
        self.tags = tags
        self.children: list[Span] = []
        self.start = time.perf_counter()
        self.wall_ms: float | None = None
        self.device_ms = 0.0

    def finish(self) -> None:
        if self.wall_ms is None:
            self.wall_ms = (time.perf_counter() - self.start) * 1e3

    def child(self, name: str, **tags) -> "Span":
        """A new child span.  Create it on the thread that owns this span
        (the children list is not locked)."""
        sp = Span(name, **tags)
        self.children.append(sp)
        return sp

    def to_json(self) -> dict:
        wall = self.wall_ms
        if wall is None:        # still running: elapsed so far
            wall = (time.perf_counter() - self.start) * 1e3
        out: dict = {
            "name": self.name,
            "wallMs": round(wall, 3),
            "deviceMs": round(self.device_ms, 3),
        }
        if self.tags:
            # another thread may still be adding tags: a dict copy that
            # meets an insert raises, so it is retried
            for _ in range(4):
                try:
                    out["tags"] = dict(self.tags)
                    break
                except RuntimeError:
                    continue
        if self.children:
            out["spans"] = [c.to_json() for c in self.children]
        return out


class Trace:
    """One request's span tree and the id that names it."""

    def __init__(self, name: str, trace_id: str | None = None,
                 device_time: bool = True):
        self.trace_id = trace_id or _new_trace_id()
        self.device_time = device_time
        self.root = Span(name)
        # the span stack of the owning thread
        self._stack: list[Span] = [self.root]

    def current(self) -> Span:
        return self._stack[-1]

    @contextmanager
    def span(self, name: str, **tags):
        sp = self.current().child(name, **tags)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.finish()

    def finish(self) -> None:
        """Close the trace: every span still open finishes now (an error
        path may leave one open between begin() and end())."""
        self._finish_open(self.root)
        del self._stack[1:]

    @staticmethod
    def _finish_open(span: Span) -> None:
        for child in span.children:
            Trace._finish_open(child)
        span.finish()

    def to_json(self) -> dict:
        out = self.root.to_json()
        out["traceId"] = self.trace_id
        return out


# The ambient trace: one a handler thread.

_tls = threading.local()


def activate(trace: Trace) -> None:
    _tls.trace = trace


def deactivate() -> None:
    _tls.trace = None


def active() -> Trace | None:
    return getattr(_tls, "trace", None)


@contextmanager
def stage(name: str, **tags):
    """``with stage("scan", kind="raw") as sp:``, a child span of the
    ambient trace's current span, or None (at no cost) untraced."""
    tr = active()
    if tr is None:
        yield None
        return
    with tr.span(name, **tags) as sp:
        yield sp


def annotate(span: Span | None, **tags) -> None:
    if span is not None:
        span.tags.update(tags)


def begin(name: str, **tags) -> Span | None:
    """Start a stage without a with-block (the planner's dispatch chain);
    pair with ``end()``.  An exception between the two leaves the span
    open until the trace finishes."""
    tr = active()
    if tr is None:
        return None
    sp = tr.current().child(name, **tags)
    tr._stack.append(sp)
    return sp


def end(span: Span | None) -> None:
    tr = active()
    if span is None or tr is None:
        return
    if tr._stack and tr._stack[-1] is span:
        tr._stack.pop()
    span.finish()


def device_wait(span: Span | None, outputs) -> float:
    """Wait until the device work behind `outputs` (tensors, or a tuple
    of them) is done, and add the wait to `span`'s device time; returns
    the wait in ms.  A synchronize of each CUDA output's current stream,
    the one its kernels were launched on: nothing is copied to the host.
    0.0, and no wait, when untraced, with device timing off, or for CPU
    tensors."""
    tr = active()
    if span is None or tr is None or not tr.device_time:
        return 0.0
    if isinstance(outputs, torch.Tensor):
        outputs = (outputs,)
    devices = {t.device for t in outputs
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    if not devices:
        return 0.0
    t0 = time.perf_counter()
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    span.device_ms += dt
    return dt
