"""Linear models (counterpart of ``fedml_tpu/models/linear.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.layers import Dense


class LogisticRegression(nn.Module):
    """One dense layer named ``linear``, raw logits out (the loss applies
    the softmax or the sigmoid); the input is flattened and cast to f32.

    ``n_lanes=L > 0`` is the lane-stacked twin that the packed schedule
    trains (``parallel/packed.py``): L independent layers, ``weight``
    ``[L*out, in]`` and ``bias`` ``[L*out]`` (lane l's rows ``l*out ..``),
    input ``[L, N, ...]``, logits ``[L, N, out]`` from one batched product
    (``Dense(n_lanes=L)``)."""

    def __init__(self, input_dim: int, output_dim: int, n_lanes: int = 0):
        super().__init__()
        self.input_dim, self.output_dim, self.n_lanes = input_dim, output_dim, n_lanes
        self.linear = Dense(input_dim, output_dim, n_lanes=n_lanes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.linear.reset_parameters(generator)

    def lane_stacked(self, n_lanes: int) -> "LogisticRegression":
        """A new lane-stacked twin for ``n_lanes`` lanes, on this model's
        device (its weights are the caller's to set)."""
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        twin = LogisticRegression(self.input_dim, self.output_dim, n_lanes=n_lanes)
        return twin.to(self.linear.weight.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.n_lanes:
            return self.linear(x.reshape(x.shape[0], -1).to(torch.float32))
        L, n = x.shape[:2]
        # Dense's lane form takes [N, L*in] (lane l's features at l*in + i)
        xs = x.reshape(L, n, -1).to(torch.float32).transpose(0, 1).reshape(n, -1)
        return self.linear(xs)


@register_model("lr")
def _lr(output_dim: int, input_dim: int = 784, input_shape: Optional[Sequence[int]] = None,
        **_):
    if input_shape is not None:
        input_dim = math.prod(input_shape)
    return ModelBundle(name="lr", module=LogisticRegression(input_dim, output_dim),
                       input_shape=(input_dim,))
