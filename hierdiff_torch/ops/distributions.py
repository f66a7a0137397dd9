"""Node-count prior: categorical over the fragment-count histogram.

(reference: endiffusion/models/distributions.py:62-102)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


class DistributionNodes:
    """Categorical prior over molecule fragment counts, sampled on the host."""

    def __init__(self, histogram: Mapping[int, float]):
        items = sorted(histogram.items())
        self.n_nodes = np.array([k for k, _ in items], dtype=np.int32)
        prob = np.array([v for _, v in items], dtype=np.float64)
        self.prob = (prob / prob.sum()).astype(np.float32)

    def sample_np(self, rng: np.random.Generator, n_samples: int = 1) -> np.ndarray:
        """Node counts drawn with a numpy generator."""
        idx = rng.choice(len(self.n_nodes), size=n_samples, p=self.prob / self.prob.sum())
        return self.n_nodes[idx]
