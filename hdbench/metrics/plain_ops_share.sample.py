"""Device time outside the kernel wrappers in the sampling cells."""

from hdbench.metrics._common import plain_ops_share


def read(ctx):
    return plain_ops_share(ctx)
