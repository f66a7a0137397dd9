"""Host time of the profiled request's reverse steps, read from the spans
the program keeps under a profiler (``hierdiff_torch.utils.profiling``):
``coarse.step`` around each reverse step and ``egnn.*`` around each kernel
wrapper call inside it.

The steps read are the first ``ctx["trace"]["steps"]`` by ``k`` of the
newest request that has ``coarse.step`` spans: in a traced run the
stretch profiled with the CUDA activity alone, whose last step is the one
in which the profiler is stopped and restarted (left to the median). A
program without spans gives None."""

from __future__ import annotations

import statistics
from typing import List, Optional, Tuple

STEP = "coarse.step"
WRAPPER_PREFIX = "egnn."


def step_walls(records: List[dict], steps: int = 0) -> List[Tuple[float, float]]:
    """(step wall, summed wall of the wrapper spans directly under it), in
    ms, for the first ``steps`` steps by ``k`` of the newest request with
    closed ``coarse.step`` spans (all of its steps when ``steps`` is 0)."""
    closed = [s for s in records if s["name"] == STEP and s["end_ns"] is not None]
    if not closed:
        return []
    newest = max(closed, key=lambda s: s["start_ns"])["request"]
    chosen = sorted((s for s in closed if s["request"] == newest), key=lambda s: s["attrs"]["k"])
    if steps:
        chosen = chosen[:steps]
    inner = {s["index"]: 0.0 for s in chosen}
    for s in records:
        if (s["parent"] in inner and s["name"].startswith(WRAPPER_PREFIX)
                and s["end_ns"] is not None):
            inner[s["parent"]] += s["end_ns"] - s["start_ns"]
    return [((s["end_ns"] - s["start_ns"]) * 1e-6, inner[s["index"]] * 1e-6) for s in chosen]


def program_spans() -> Optional[List[dict]]:
    """The program's recorded spans, or None where it keeps none."""
    try:
        from hierdiff_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def median_ms(ctx: dict, part: str) -> Optional[float]:
    """Median over the steps of ``part``: "step" (the step's wall),
    "wrappers" (its wrapper spans) or "plain" (the wall outside them)."""
    records = program_spans()
    if records is None:
        return None
    walls = step_walls(records, int(ctx.get("trace", {}).get("steps") or 0))
    if not walls:
        return None
    pick = {"step": lambda w: w[0], "wrappers": lambda w: w[1], "plain": lambda w: w[0] - w[1]}
    return statistics.median(pick[part](w) for w in walls)
