"""State-dict math (counterpart of ``fedml_tpu/core/pytree.py``).

A model's variables are a flat ``{name: tensor}`` state dict (parameters
and BatchNorm running statistics alike); a cohort's variables are stacked
along a new leading client axis.
"""

from __future__ import annotations

from typing import Sequence

import torch

StateDict = dict


def tree_stack(trees: Sequence[StateDict]) -> StateDict:
    """Stack identically-keyed state dicts along a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_weighted_mean(stacked: StateDict, weights: torch.Tensor) -> StateDict:
    """Weighted average along the leading (client) axis of every floating
    leaf, BatchNorm running stats included. Weights are normalised in f32;
    each leaf is summed in f32 and cast back to its dtype. A non-floating
    leaf keeps the first client's value."""
    w = weights.to(torch.float32)
    w = w / torch.clamp(w.sum(), min=1e-12)
    out = {}
    for k, x in stacked.items():
        if not x.is_floating_point():
            out[k] = x[0]
            continue
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        out[k] = (x.to(torch.float32) * wb).sum(0).to(x.dtype)
    return out
