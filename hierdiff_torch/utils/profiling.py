"""Profiling and timing hooks.

Port of ``hierdiff_tpu/utils/profiling.py``: ``profile_trace`` records a
``torch.profiler`` trace (host and, where the build has CUPTI, CUDA
activity) and writes it under a directory as a Chrome trace, which
Perfetto and ``chrome://tracing`` open; ``timed`` is a wall-clock timer
that waits for the device only at its boundaries.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


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
