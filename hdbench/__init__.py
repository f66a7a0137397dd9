"""The benchmark of ``hierdiff_torch`` on an NVIDIA H100 (see README.md)."""
