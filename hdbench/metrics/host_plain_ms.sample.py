"""Median host wall of a profiled reverse step outside its kernel-wrapper
calls: the coarse model's plain PyTorch and the chain's update."""

from hdbench.metrics._spans import median_ms


def read(ctx):
    return median_ms(ctx, "plain")
