"""Profiling and timing hooks.

Port of ``hierdiff_tpu/utils/profiling.py``: ``profile_trace`` records a
``torch.profiler`` trace (host and, where the build has CUPTI, CUDA
activity) and writes it under a directory as a Chrome trace, which
Perfetto and ``chrome://tracing`` open; ``timed`` is a wall-clock timer
that waits for the device only at its boundaries.

Spans. ``span(name, **attrs)`` marks a stretch of host work inside the
program: ``coarse.request`` and ``coarse.step`` in ``sampling/coarse.py``,
``egnn.fused_gcl`` and ``egnn.fused_coord_update`` in
``ops/egnn_kernels.py``. A span is on exactly while a ``torch.profiler``
session is active (``profile_trace``, or any ``torch.profiler.profile``);
otherwise it is one flag check and a shared no-op context, with no clock
read and no allocation. When on, it

- keeps a record in memory: name, start and end in ``time.time_ns()``
  (the Unix clock of the profiler's Chrome trace, whose event times are
  ``ts`` microseconds after ``baseTimeNanoseconds``), its index, the index
  of the innermost span open around it on the same thread, the id of the
  request it belongs to, and ``attrs``;
- opens a profiler range of the same name, so it shows in the Chrome
  trace beside the device's work. A range costs under a microsecond while
  the profiler records no host activity (a CUDA-only session).

Records go to a ring of ``SPAN_CAPACITY`` spans; the oldest are dropped
when it is full and counted (``dropped_spans``). ``spans()`` returns a copy
of the ring, oldest first, and ``clear_spans()`` empties it. No span waits
for the device.

    with profile_trace("runs/x/trace"):
        sample_coarse(model, node_mask, edge_mask, generator=g)
    steps = [s for s in spans() if s["name"] == "coarse.step"]
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def profile_trace(logdir: str, with_perfetto: bool = False) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed work and write ``trace-<pid>-<ns>.json`` under
    ``logdir``; yields the profiler (``key_averages()`` for sums by op).

        with profile_trace("runs/x/trace"):
            loss = step(batch)
            torch.cuda.synchronize()

    ``with_perfetto`` prints the trace's path to open in Perfetto."""
    activities = [a for a in (torch.profiler.ProfilerActivity.CPU,
                              torch.profiler.ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = out / f"trace-{os.getpid()}-{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    if with_perfetto:
        print(f"[trace] {path}: open it at ui.perfetto.dev", flush=True)


def _sync() -> None:
    """Wait for the current CUDA device, if this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class timed:
    """Wall-clock timer that waits for the current CUDA device (when one is
    in use) at entry and exit, so the window covers exactly the enclosed
    work.

        with timed("sample") as t: ...
        print(t.seconds)
    """

    def __init__(self, name: str = "", sync: bool = True, verbose: bool = False):
        self.name = name
        self.sync = sync
        self.verbose = verbose
        self.seconds: Optional[float] = None

    def __enter__(self):
        if self.sync:
            _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        self.seconds = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[timed] {self.name}: {self.seconds:.4f}s", flush=True)
        return False


SPAN_CAPACITY = 65536
_ring: deque = deque(maxlen=SPAN_CAPACITY)
_ring_lock = threading.Lock()
_next_index = itertools.count()
_request_ids = itertools.count(1)
_dropped = 0
# torch's C++ profiler range, far cheaper than ``record_function`` while no
# profiler records host activity; ``record_function`` where a build lacks it
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 _autograd_profiler.record_function)


class _Thread(threading.local):
    """Per thread: the open spans, innermost last, and the request's id."""

    def __init__(self):
        self.stack: list = []
        self.request: Optional[int] = None


_local = _Thread()


_OFF = contextlib.nullcontext()    # what every span is while no profiler is active


class _Span:
    __slots__ = ("name", "attrs", "index", "parent", "request", "start_ns", "end_ns",
                 "_range", "_stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.end_ns = name, attrs, None

    def __enter__(self):
        global _dropped
        local = _local
        self._stack = stack = local.stack
        self.parent = stack[-1].index if stack else None
        self.request = local.request
        self._range = _Range(self.name)
        self._range.__enter__()
        with _ring_lock:
            self.index = next(_next_index)
            if len(_ring) == _ring.maxlen:
                _dropped += 1
            _ring.append(self)
        stack.append(self)
        self.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._stack.pop()
        return False


class _RequestScope:
    """A request's id on this thread, around its span when one is recorded."""

    __slots__ = ("request", "_span", "_outer")

    def __init__(self, request: int, inner: Optional[_Span]):
        self.request, self._span = request, inner

    def __enter__(self):
        self._outer = _local.request
        _local.request = self.request
        if self._span is not None:
            self._span.__enter__()
        return None

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)
        _local.request = self._outer
        return False


def span(name: str, **attrs):
    """A context manager that records the enclosed host work as a span
    named ``name`` with ``attrs`` (host-known values: shapes, counts,
    indices) while a profiler is active; otherwise it does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def request_span(name: str, **attrs):
    """``span`` for one request: it takes a new request id whether or not a
    profiler is active (one counter step per request), so the spans inside
    it carry that id even when a profiler starts after the request has
    begun and the request's own span is not recorded."""
    request = next(_request_ids)
    if not _autograd_profiler._is_profiler_enabled:
        return _RequestScope(request, None)
    return _RequestScope(request, _Span(name, attrs))


def spans() -> List[dict]:
    """A copy of the recorded spans, oldest first: ``name``, ``start_ns``,
    ``end_ns`` (None while open), ``index``, ``parent`` (the index of the
    span open around it on its thread, or None), ``request`` (the id of
    its ``request_span``, or None) and ``attrs``."""
    with _ring_lock:
        held = list(_ring)
    return [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns, "index": s.index,
             "parent": s.parent, "request": s.request, "attrs": dict(s.attrs)} for s in held]


def dropped_spans() -> int:
    """Spans dropped from the full ring since the last ``clear_spans``."""
    return _dropped


def clear_spans() -> None:
    """Empty the ring and zero the dropped count; indices keep counting."""
    global _dropped
    with _ring_lock:
        _ring.clear()
        _dropped = 0
