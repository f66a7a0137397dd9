"""fused_gcl's share of its roofline in the sampling cells."""

from hdbench.metrics._common import roofline_share


def read(ctx):
    return roofline_share(ctx, "fused_gcl")
