"""Split-model pairs for SplitNN (counterpart of ``fedml_tpu/models/split.py``;
reference fedml_api/distributed/split_nn).

A split pair is two :class:`ModelBundle`\\ s: the client bundle maps input to
the cut activations, the server bundle maps activations to logits. The
trainer runs both in one step with one backward (``algorithms/split_nn``).
Submodules carry the flax names (``Conv_0``, ``Dense_1``), so
``models/convert.py`` maps the weights; activations are flattened in NHWC
order, as flax flattens them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.initializers import reset_submodules
from fedml_tpu_torch.models.layers import Conv, Dense


class _ClientCNN(nn.Module):
    """Lower half: two [3x3 SAME conv with bias -> ReLU -> 2x2 max pool]
    blocks -> the flattened feature activations."""

    def __init__(self, in_features: int, features: int = 32):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3, use_bias=True)
        self.Conv_1 = Conv(features, features * 2, 3, use_bias=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.Conv_0, self.Conv_1):
            x = F.max_pool2d(F.relu(conv(x)).permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class _ServerMLP(nn.Module):
    """Upper half: a dense head on the cut activations."""

    def __init__(self, in_features: int, hidden: int = 128, output_dim: int = 10):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden)
        self.Dense_1 = Dense(hidden, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(x)))


class _ClientDense(nn.Module):
    def __init__(self, in_features: int, cut_dim: int):
        super().__init__()
        self.Dense_0 = Dense(in_features, cut_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


def create_split_cnn(output_dim: int, input_shape: Sequence[int] = (28, 28, 1),
                     features: int = 32, hidden: int = 128) -> tuple[ModelBundle, ModelBundle]:
    """(client_bundle, server_bundle) for a CNN split at the flatten point."""
    input_shape = tuple(input_shape)
    act_dim = (input_shape[0] // 4) * (input_shape[1] // 4) * features * 2
    client = ModelBundle("splitnn_client_cnn", _ClientCNN(input_shape[-1], features),
                         input_shape)
    server = ModelBundle("splitnn_server_mlp", _ServerMLP(act_dim, hidden, output_dim),
                         (act_dim,))
    return client, server


def create_split_mlp(output_dim: int, input_shape: Sequence[int],
                     cut_dim: int = 64) -> tuple[ModelBundle, ModelBundle]:
    """Dense/dense split for flat-feature datasets (synthetic, tabular)."""
    input_shape = tuple(input_shape)
    n_in = 1
    for d in input_shape:
        n_in *= int(d)
    client = ModelBundle("splitnn_client_mlp", _ClientDense(n_in, cut_dim), input_shape)
    server = ModelBundle("splitnn_server_mlp", _ServerMLP(cut_dim, cut_dim, output_dim),
                         (cut_dim,))
    return client, server
