"""Server-side aggregation (counterpart of ``fedml_tpu/core/aggregation.py``):
the plain weighted average and the unit-wise adaptive clip of FedAGC."""

from __future__ import annotations

import torch

from fedml_tpu_torch.core.pytree import StateDict, is_bn_buffer, tree_weighted_mean

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
