"""Server-side aggregation (counterpart of ``fedml_tpu/core/aggregation.py``;
only the plain weighted average is on the ported path)."""

from __future__ import annotations

import torch

from fedml_tpu_torch.core.pytree import StateDict, tree_weighted_mean


def fedavg_aggregate(stacked: StateDict, num_samples: torch.Tensor) -> StateDict:
    """Sample-weighted FedAvg aggregation over the leading client axis
    (reference FedAvgAPI._aggregate, fedavg_api.py:100-115)."""
    return tree_weighted_mean(stacked, num_samples)
