"""Server-side aggregation (counterpart of ``fedml_tpu/core/aggregation.py``):
the plain weighted average, the unit-wise adaptive clip of FedAGC, the
robust defenses (norm-difference clipping of a client's update, weak-DP
gaussian noise on the aggregate), the gossip mixing average and the
two-tier hierarchical aggregate.

BatchNorm running statistics are averaged but never clipped or noised
(:func:`is_weight_path`). The noise draws follow the JAX package's leaf
order, the flatten order of the flax variables (``models/convert.
flax_leaf_order``), one normal tensor per float weight leaf.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from fedml_tpu_torch.core.pytree import StateDict, is_bn_buffer, tree_weighted_mean
from fedml_tpu_torch.models.convert import flax_leaf_order

#: ``noise(i, name, shape) -> tensor``: the normal draw of leaf ``name``,
#: index ``i`` in the JAX package's flattened tree, in the port's ``shape``
#: (tests inject the JAX package's ``normal(fold_in(server_key, i))``)
NoiseSource = Callable[[int, str, tuple], torch.Tensor]

#: fragments of the names of non-weight statistics, which are averaged but
#: never clipped (the JAX package's list; the port's BatchNorm buffers are
#: ``mean`` and ``var``, matched by ``pytree.is_bn_buffer``)
NON_WEIGHT_KEY_FRAGMENTS = ("batch_stats", "running_mean", "running_var", "num_batches_tracked")


def is_weight_path(path: str) -> bool:
    return not (is_bn_buffer(path) or any(frag in path for frag in NON_WEIGHT_KEY_FRAGMENTS))


def fedavg_aggregate(stacked: StateDict, num_samples: torch.Tensor) -> StateDict:
    """Sample-weighted FedAvg aggregation over the leading client axis
    (reference FedAvgAPI._aggregate, fedavg_api.py:100-115)."""
    return tree_weighted_mean(stacked, num_samples)


def unitwise_norm(x: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """NFNet unit-wise L2 norm, keeping the reduced axes: a vector's global
    norm; per output unit for a Dense weight ``[out, in]`` and a conv weight
    ``[Co, Ci, kh, kw]``. The port's unit axis is therefore the FIRST (flax
    kernels are ``[..., in, out]``, where it is the last). The leading
    ``batch_dims`` axes (a stack of clients, or the lanes of a folded leaf
    viewed as ``[L, n0, ...]``) are kept apart: a lane-folded vector
    ``[L*C]`` viewed as ``[L, C]`` has one norm per lane."""
    unit = batch_dims if x.dim() - batch_dims >= 2 else batch_dims - 1
    dims = tuple(range(unit + 1, x.dim()))
    if not dims:
        return x.abs()
    return torch.sqrt(x.to(torch.float32).square().sum(dims, keepdim=True))


def agc_clip_update(global_params: StateDict, local_params: StateDict, clipping: float = 1e-2,
                    eps: float = 1e-3, batch_dims: int = 0) -> StateDict:
    """Adaptive clip of the client update relative to the unit-wise norm of
    the global parameters (SiloFedAGC._aggregate, silo_fedagc.py:50-69).
    ``local_params`` may stack clients on ``batch_dims`` leading axes."""
    out = {}
    for k, g in global_params.items():
        upd = local_params[k] - g
        p_norm = torch.clamp(unitwise_norm(g), min=eps)
        u_norm = torch.clamp(unitwise_norm(upd, batch_dims), min=1e-6)
        max_norm = p_norm * clipping
        out[k] = g + torch.where(u_norm > max_norm, upd * (max_norm / u_norm), upd)
    return out


def _batch_sum(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Sum of squares over every axis after the leading ``batch_dims``, in f32."""
    return x.to(torch.float32).square().sum(tuple(range(batch_dims, x.dim())))


def clip_update_by_norm(global_params: StateDict, local_params: StateDict, clip: float,
                        batch_dims: int = 0) -> StateDict:
    """Scale the client update (local - global) to L2 norm <= ``clip`` and
    re-add it (RobustAggregator.norm_diff_clipping,
    robust_aggregation.py:38-49). The norm runs over the float weight
    leaves only; the statistics' updates are re-added unscaled and integer
    leaves pass through. ``local_params`` may stack clients on
    ``batch_dims`` leading axes, each clipped by its own norm."""
    diff = {k: local_params[k] - g for k, g in global_params.items()}
    clipped = [k for k, d in diff.items() if d.is_floating_point() and is_weight_path(k)]
    sq = sum(_batch_sum(diff[k], batch_dims) for k in clipped)
    scale = torch.clamp(clip / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
    out = {}
    for k, g in global_params.items():
        if not diff[k].is_floating_point():
            out[k] = local_params[k]
            continue
        d = diff[k]
        if k in clipped:
            d = d * scale.reshape(scale.shape + (1,) * (d.dim() - batch_dims))
        out[k] = (g + d).to(local_params[k].dtype)
    return out


def add_dp_noise(params: StateDict, stddev: float,
                 rng: Union[torch.Generator, NoiseSource, None] = None,
                 noise: Optional[NoiseSource] = None) -> StateDict:
    """Add i.i.d. gaussian noise of ``stddev`` to the float weight leaves
    (weak DP defense, robust_aggregation.py:51-55); statistics and integer
    leaves pass through untouched. The draws come from ``rng`` (a
    ``torch.Generator`` on the leaves' device), one ``randn`` a leaf in the
    JAX package's leaf order, in the leaf's dtype; ``noise`` (or a callable
    ``rng``) supplies them instead."""
    if noise is None and callable(rng):
        noise, rng = rng, None
    if noise is None and rng is None:
        raise ValueError("dp noise requires a generator or a noise source")
    out = dict(params)
    for i, k in enumerate(flax_leaf_order(params)):
        x = params[k]
        if not (x.is_floating_point() and is_weight_path(k)):
            continue
        if noise is not None:
            n = torch.as_tensor(noise(i, k, tuple(x.shape))).to(device=x.device, dtype=x.dtype)
        else:
            n = torch.randn(x.shape, generator=rng, device=x.device, dtype=x.dtype)
        out[k] = x + stddev * n
    return out


def robust_aggregate(global_params: StateDict, stacked_local_params: StateDict,
                     num_samples: torch.Tensor, norm_bound: Optional[float] = None,
                     dp_stddev: Optional[float] = None,
                     rng: Union[torch.Generator, NoiseSource, None] = None) -> StateDict:
    """Norm-clip each stacked client's update, take the weighted mean, and
    add DP noise (FedAvgRobustAggregator.py:14-60 with
    robust_aggregation.py:38-55). ``dp_stddev`` without ``rng`` raises."""
    if norm_bound is not None:
        stacked_local_params = clip_update_by_norm(global_params, stacked_local_params,
                                                   norm_bound, batch_dims=1)
    agg = tree_weighted_mean(stacked_local_params, num_samples)
    if dp_stddev is not None:
        if rng is None:
            raise ValueError("dp noise requires an rng")
        agg = add_dp_noise(agg, dp_stddev, rng)
    return agg


def mixing_average(stacked_params: StateDict, mixing_row: torch.Tensor) -> StateDict:
    """One node's gossip step: its neighbours' stacked states combined by a
    row of the topology's mixing matrix (symmetric_topology_manager.py:54-62,
    decentralized_worker_manager.py:29-46)."""
    return tree_weighted_mean(stacked_params, mixing_row)


def hierarchical_aggregate(stacked_params: StateDict, num_samples: torch.Tensor,
                           group_ids: Union[torch.Tensor, Sequence[int]],
                           num_groups: int) -> tuple[StateDict, StateDict]:
    """Two-tier client -> group -> global aggregation (hierarchical_fl/
    group.py:24-46 and trainer.py:43-69). Returns ``(group_params`` stacked
    ``[num_groups, ...], global_params)``: each group's sample-weighted mean
    (a segment sum by ``index_add_``, over the group's total clamped at
    1e-12, in f32 and cast back), then the group means weighted by their
    totals."""
    w = num_samples.to(torch.float32)
    gid = torch.as_tensor(group_ids, dtype=torch.int64, device=w.device)
    group_tot = torch.zeros(num_groups, dtype=torch.float32, device=w.device).index_add_(0, gid, w)

    def group_avg(x: torch.Tensor) -> torch.Tensor:
        shape = (-1,) + (1,) * (x.dim() - 1)
        xw = x.to(torch.float32) * w.reshape(shape)
        s = torch.zeros((num_groups,) + tuple(x.shape[1:]), dtype=torch.float32,
                        device=x.device).index_add_(0, gid, xw)
        return (s / torch.clamp(group_tot, min=1e-12).reshape(shape)).to(x.dtype)

    group_params = {k: group_avg(x) for k, x in stacked_params.items()}
    return group_params, tree_weighted_mean(group_params, group_tot)
