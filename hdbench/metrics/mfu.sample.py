"""The sampling window's model FLOPs against the bf16 peak."""

from hdbench.metrics._common import mfu


def read(ctx):
    return mfu(ctx)
