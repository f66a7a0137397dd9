"""Device idle share of the profiled sampling stretch."""

from hdbench.metrics._common import device_idle


def read(ctx):
    return device_idle(ctx)
