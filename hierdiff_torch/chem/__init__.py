"""Host-side chemistry toolkit (RDKit-gated).

The port's own copy of ``hierdiff_tpu/chem``: the fragment vocabulary,
junction-tree decomposition, assembly validity and the geometry-scored
reconstruction. It is host Python (numpy, RDKit); the card never sees it.

RDKit is probed at call time (``has_rdkit()``), never frozen at import: a
process may gain an ``rdkit`` module after this package loads (a test
harness registering a stand-in in ``sys.modules``) or lose it again. Code
that needs RDKit raises ``RDKitUnavailable`` when it is called without it,
so the device path works in RDKit-less environments.
"""

from __future__ import annotations

import importlib.util
import sys


def has_rdkit() -> bool:
    """True when an ``rdkit`` module is loaded or installed."""
    if sys.modules.get("rdkit") is not None:
        return True
    try:
        return importlib.util.find_spec("rdkit") is not None
    except ValueError:
        # a module left in sys.modules with __spec__ = None makes find_spec
        # raise instead of answering; it was removed above, so nothing is there
        return False


class RDKitUnavailable(RuntimeError):
    def __init__(self, what: str = "this operation"):
        super().__init__(
            f"RDKit is required for {what} but is not installed in this "
            "environment. The model and sampling path works without it; "
            "install rdkit for chemistry (tree_decomp, assembly, eval).")


def require_rdkit(what: str = "this operation"):
    if not has_rdkit():
        raise RDKitUnavailable(what)
