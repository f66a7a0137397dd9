"""Reading a profiled stretch: device busy time, each kernel wrapper's
device time and launches, the top device operations and the idle gaps by
what the host was doing.

A stretch is profiled twice, at consecutive steps of the same traffic: once
with the CUDA activity alone, whose device events give the busy time, the
window (from the first device event's start to the last one's end) and
each kernel's time, since recording every host operation slows the host's
launches and would lengthen the window; then once with the CPU activity
too, around a ``record_function(STRETCH)`` range, which names each idle
gap by the innermost host event covering its midpoint. The Chrome traces
are read back as JSON. Device activity is every ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` event. The three kernel wrappers of ``hierdiff_torch/ops/egnn_kernels.py``
launch only kernels of the ``hd::`` namespace (``csrc/*.cu``); the shared
ones of ``csrc/sm90.cuh`` (work list and projections) are given to the
wrapper whose own kernel follows them on the stream.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

STRETCH = "hdbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")

OWN_KERNELS = {
    "fused_gcl": ("gcl_edge_kernel", "gcl_node_kernel"),
    "fused_coord_update": ("coord_edge_kernel",),
    "fused_gcl_bwd": ("gcl_bwd_edge_kernel", "gemm_kernel", "node_prep_kernel",
                      "node_act_kernel", "node_dz_kernel", "node_split_kernel",
                      "colsum_kernel", "reduce_kernel", "posmap_kernel",
                      "node_edge_sums_kernel"),
}
SHARED_KERNELS = ("edge_count_kernel", "edge_fill_kernel", "proj_sm90_kernel")
# one kernel per wrapper call: the launch count in the trace
LAUNCH_KERNEL = {"fused_gcl": "gcl_node_kernel", "fused_coord_update": "coord_edge_kernel",
                 "fused_gcl_bwd": "gcl_bwd_edge_kernel"}
TOP = 10


def kernel_base(name: str) -> Optional[str]:
    """'void hd::gcl_edge_kernel<true, true>(hd::GclArgs)' -> 'gcl_edge_kernel';
    None for a kernel outside the ``hd`` namespace."""
    at = name.find("hd::")
    if at < 0:
        return None
    rest = name[at + 4:]
    for stop in ("<", "("):
        cut = rest.find(stop)
        if cut >= 0:
            rest = rest[:cut]
    return rest.strip()


def wrapper_of(base: str) -> Optional[str]:
    for wrapper, names in OWN_KERNELS.items():
        if base in names:
            return wrapper
    return None


def export_events(prof) -> List[dict]:
    """The complete ('X') events of a stopped profiler's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device_events(events: List[dict], w0: float, w1: float) -> List[dict]:
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS
                   and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0),
                  key=lambda e: float(e["ts"]))


def _clipped(e: dict, w0: float, w1: float) -> tuple:
    return max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)


def _busy(dev: List[dict], w0: float, w1: float) -> List[list]:
    out = []
    for s, e in sorted(_clipped(d, w0, w1) for d in dev):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[dict]) -> dict:
    """From a CUDA-only stretch: the window, device busy and total
    seconds, each wrapper's device seconds and launches, the plain
    operations' seconds and the top device operations."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        raise ValueError("no device activity in the stretch")
    w0 = min(float(e["ts"]) for e in dev)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    dev = _device_events(dev, w0, w1)

    by_wrapper: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    by_name: Dict[str, float] = defaultdict(float)
    pending: List[float] = []
    total = 0.0
    for e in dev:
        s, t = _clipped(e, w0, w1)
        dur = max(t - s, 0.0)
        total += dur
        name = e.get("name", "?")
        by_name[name[:160]] += dur
        base = kernel_base(name) if e.get("cat") == "kernel" else None
        if base is None:
            continue
        wrapper = wrapper_of(base)
        if wrapper is None and base in SHARED_KERNELS:
            pending.append(dur)
            continue
        if wrapper is None:
            raise ValueError(f"kernel {name!r} of the hd namespace belongs to no wrapper")
        by_wrapper[wrapper] += dur + sum(pending)
        pending = []
        if base == LAUNCH_KERNEL[wrapper]:
            launches[wrapper] += 1
    if pending:
        raise ValueError("shared work-list kernels at the stretch's end with no wrapper kernel")
    busy_us = sum(e - s for s, e in _busy(dev, w0, w1))
    wrapper_total = sum(by_wrapper.values())
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_s": total * 1e-6,
        "wrapper_s": {k: v * 1e-6 for k, v in by_wrapper.items()},
        "plain_s": (total - wrapper_total) * 1e-6,
        "launches": dict(launches),
        "device_ops": [[k, v * 1e-6] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def idle_gaps(events: List[dict]) -> List[list]:
    """From a stretch with host events: the device's idle time inside the
    STRETCH range, summed by the innermost host event that covers each
    gap's midpoint ("host outside any op" where none does), largest first."""
    spans = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {STRETCH!r} range in the trace")
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    gaps, cursor = [], w0
    for s, e in _busy(_device_events(events, w0, w1), w0, w1):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("name") != STRETCH))
    idle: Dict[str, float] = defaultdict(float)
    active: list = []
    i = 0
    for s, e in gaps:    # in time order: sweep the host events once
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        inner = min(active, key=lambda h: h[1] - h[0]) if active else None
        idle[(inner[2] if inner else "host outside any op")[:160]] += e - s
    return [[k, v * 1e-6] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]


class Stretches:
    """Profiles steps [a, b) of a loop: ``at_step(k)`` is called before
    each step k, with a synchronise at each edge. ``plan`` lists (a, b,
    with_host): the first without host activity gives ``summarize`` and the
    launch counts of ``egnn_kernels`` over it, the second with host
    activity gives ``idle_gaps``."""

    def __init__(self, device, plan):
        self.device, self.plan = device, plan
        self.traces, self.active, self.counts = [], None, {}

    def at_step(self, k: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from hierdiff_torch.ops import egnn_kernels

        if self.active is not None and k == self.active[0]:
            torch.cuda.synchronize(self.device)
            _, prof, rng, with_host = self.active
            if rng is not None:
                rng.__exit__(None, None, None)
            prof.stop()
            if not with_host:
                self.counts = {key: egnn_kernels.launch_counts[key] - v
                               for key, v in self.counts.items()}
            # read each trace before the next profiler starts
            self.traces.append((export_events(prof), with_host))
            self.active = None
        for a, b, with_host in self.plan:
            if k == a:
                torch.cuda.synchronize(self.device)
                acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_host else [])
                prof = profile(activities=acts)
                if not with_host:
                    self.counts = dict(egnn_kernels.launch_counts)
                prof.start()
                rng = record_function(STRETCH) if with_host else None
                if rng is not None:
                    rng.__enter__()
                self.active = (b, prof, rng, with_host)

    def read(self):
        summary, gaps = None, []
        for events, with_host in self.traces:
            if with_host:
                gaps = idle_gaps(events)
            else:
                summary = summarize(events)
                summary["counter_launches"] = self.counts
        if summary is None:
            raise ValueError("the profiled stretch never ran")
        return summary, gaps
