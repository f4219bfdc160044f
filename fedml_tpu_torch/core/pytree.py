"""State-dict math (counterpart of ``fedml_tpu/core/pytree.py``).

A model's variables are a flat ``{name: tensor}`` state dict (parameters
and BatchNorm running statistics alike); a cohort's variables are stacked
along a new leading client axis. The leafwise helpers also take nested
dicts (an algorithm's extras, ``{"pd": {...}, "na": tensor}``).

The JAX package keeps parameters and BatchNorm statistics in two
collections, ``"params"`` and ``"batch_stats"``; :func:`split_params` is the
port's counterpart: a BatchNorm's running statistics are its ``mean`` and
``var`` buffers (``models/norm.py``), everything else is a parameter.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

StateDict = dict

#: leaf names of a BatchNorm's running statistics (models/norm.py)
BN_BUFFERS = ("mean", "var")


def is_bn_buffer(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in BN_BUFFERS


def split_params(state: StateDict) -> tuple[StateDict, StateDict]:
    """``(params, buffers)``: a state dict's parameters and its BatchNorm
    running statistics, each in the state dict's order."""
    params = {k: v for k, v in state.items() if not is_bn_buffer(k)}
    return params, {k: v for k, v in state.items() if is_bn_buffer(k)}


def tree_map(fn: Callable, tree, *rest):
    """``fn`` leafwise over identically-keyed (nested) dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    """a - b, leafwise. The FedOpt pseudo-gradient is tree_sub(global, avg)."""
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_dot(a, b) -> torch.Tensor:
    """Global inner product over all leaves, in f32."""
    return sum((x.to(torch.float32) * y.to(torch.float32)).sum()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_global_norm(tree) -> torch.Tensor:
    """L2 norm over every element of every leaf, in f32."""
    return torch.sqrt(sum(x.to(torch.float32).square().sum() for x in tree_leaves(tree)))


def tree_stack(trees: Sequence[StateDict]) -> StateDict:
    """Stack identically-keyed state dicts along a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def weighted_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_i x[i] * w[i]`` over the leading axis, in f32: the one
    arithmetic of :func:`tree_weighted_mean` and of the streamed rounds'
    fold (whose weights arrive normalized), so a one-chunk streamed round
    equals the batch round bit for bit."""
    wb = w.to(device=x.device, dtype=torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
    return (x.to(torch.float32) * wb).sum(0)


def tree_weighted_mean(stacked: StateDict, weights: torch.Tensor) -> StateDict:
    """Weighted average along the leading (client) axis of every floating
    leaf, BatchNorm running stats included. Weights are normalised in f32;
    each leaf is summed in f32 (:func:`weighted_sum`) and cast back to its
    dtype. A non-floating leaf keeps the first client's value."""
    w = weights.to(torch.float32)
    w = w / torch.clamp(w.sum(), min=1e-12)
    return {k: weighted_sum(x, w).to(x.dtype) if x.is_floating_point() else x[0]
            for k, x in stacked.items()}
