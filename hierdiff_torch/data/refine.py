"""The refine stage's vocabulary restriction (port of the sampling half of
``hierdiff_tpu/data/refine.py``): the masked-node token and the vocab
support of a heavy-atom count. ``make_refine_batch`` serves training, which
is not ported yet."""

from __future__ import annotations

from typing import List

from hierdiff_torch.data.assets import load_size_dict

# vocab id of a masked node: one past the 780 fragment types
# (hierdiff_tpu/models/refine.py:35)
MASK_TOKEN = 780


def size_support_indices(size: int, vocab_size: int = 780) -> List[int]:
    """Allowed vocab indices for a heavy-atom count, with the reference's
    +-1/+-2 fallback for unseen sizes (ar_sampling_nosize.py:115-122)."""
    sd = load_size_dict()
    if size in sd and sd[size]:
        return sd[size]
    best: List[int] = []
    for perm in (-1, 1, -2, 2):
        cand = sd.get(size + perm, [])
        if len(cand) > len(best):
            best = cand
    return best or list(range(vocab_size))
