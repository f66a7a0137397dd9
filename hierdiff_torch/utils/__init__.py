from hierdiff_torch.utils.profiling import profile_trace, timed  # noqa: F401
