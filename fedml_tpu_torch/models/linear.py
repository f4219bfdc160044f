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
    the softmax); the input is flattened and cast to f32."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.linear = Dense(input_dim, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.linear.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1).to(torch.float32))


@register_model("lr")
def _lr(output_dim: int, input_dim: int = 784, input_shape: Optional[Sequence[int]] = None,
        **_):
    if input_shape is not None:
        input_dim = math.prod(input_shape)
    return ModelBundle(name="lr", module=LogisticRegression(input_dim, output_dim),
                       input_shape=(input_dim,))
