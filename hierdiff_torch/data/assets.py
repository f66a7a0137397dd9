"""Bundled node-count histograms (the port's own copies of
``hierdiff_tpu/assets/*_histogram.json``)."""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict

ASSET_DIR = Path(__file__).resolve().parent.parent / "assets"


@lru_cache(maxsize=None)
def load_histogram(name: str = "geom") -> Dict[int, int]:
    """Named fragment-count histogram: 'geom' | 'crossdock' | 'qm9'."""
    with open(ASSET_DIR / f"{name}_histogram.json") as f:
        raw = json.load(f)
    return {int(k): int(v) for k, v in raw.items()}
