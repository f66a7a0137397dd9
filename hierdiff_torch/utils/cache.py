"""The counterpart of ``hierdiff_tpu/utils/cache.py``'s persistent XLA
compilation cache.

The port compiles no XLA program. What it compiles are the CUDA kernels
(``ops/_build.py``) and the native searches (``runtime/``), and both keep
their libraries in ``BUILD_DIR``, keyed by a hash of their sources and
flags, so a later process reuses them already. ``enable_compilation_cache``
is therefore a no-op that returns that directory; the CLIs call it where the
JAX CLIs call theirs.
"""

from __future__ import annotations

from typing import Optional

from hierdiff_torch.ops._build import BUILD_DIR


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """No-op; returns the build directory that persists the compiled kernels
    across processes. ``path`` is accepted for the JAX signature and unused:
    the build directory is fixed."""
    return str(BUILD_DIR)
