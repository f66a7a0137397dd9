"""Median host wall of a profiled reverse step's kernel-wrapper calls (the
``egnn.*`` spans under its ``coarse.step`` span)."""

from hdbench.metrics._spans import median_ms


def read(ctx):
    return median_ms(ctx, "wrappers")
