"""Shared arithmetic of the per-layer readers. Each reader takes the run's
context (``drivers/*.py`` ``run``: the trace summary, the least time of
the traced launches, the window's FLOPs and length) and returns a number,
or None where the run has nothing to read."""

from __future__ import annotations

from typing import Optional

from hdbench.roofline import PEAK_BF16_FLOPS


def roofline_share(ctx: dict, wrapper: str) -> Optional[float]:
    """% of a wrapper's device time that its launches' least time is."""
    spent = ctx.get("trace", {}).get("wrapper_s", {}).get(wrapper)
    least = ctx.get("bounds_s", {}).get(wrapper)
    if not spent or not least:
        return None
    return 100.0 * least / spent


def mfu(ctx: dict) -> Optional[float]:
    """% of the card's dense bf16 peak that the window's model FLOPs are."""
    if not ctx.get("window_flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["window_flops"] / ctx["window_s"] / PEAK_BF16_FLOPS


def device_idle(ctx: dict) -> Optional[float]:
    """% of the profiled stretch with no kernel, copy or memset running."""
    tr = ctx.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def plain_ops_share(ctx: dict) -> Optional[float]:
    """% of the stretch's device time outside the three kernel wrappers."""
    tr = ctx.get("trace")
    if not tr or not tr.get("device_s"):
        return None
    return 100.0 * tr["plain_s"] / tr["device_s"]
