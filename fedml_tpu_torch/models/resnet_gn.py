"""ResNet-18 with GroupNorm for fed_cifar100 (counterpart of
``fedml_tpu/models/resnet_gn.py``): the TFF baseline's GroupNorm(2 groups)
in place of BatchNorm, so there is no batch statistic and the state is
parameters only. flax's GroupNorm: contiguous channel groups, f32 fast
variance, epsilon 1e-6 (``models/layers.GroupNorm``). No TPU kernel lies
behind it: it is torch ops here as it is XLA ops there. Input 24 x 24 x 3
(TFF's crop).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import reset_submodules
from fedml_tpu_torch.models.layers import Conv, Dense, GroupNorm, add_flax
from fedml_tpu_torch.models.mobilenet import spatial_mean


class GNBasicBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1, groups: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, stride=strides, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(filters, groups, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(filters, groups, dtype=dtype)
        self.project = strides != 1 or in_features != filters
        if self.project:
            self.Conv_2 = Conv(in_features, filters, 1, stride=strides, dtype=dtype)
            self.GroupNorm_2 = GroupNorm(filters, groups, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class ResNet18GN(nn.Module):
    def __init__(self, output_dim: int = 100, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 groups: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(3, 64, 3, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(64, groups, dtype=dtype)
        self.blocks, cin = [], 64
        for stage, (filters, nblocks) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            for block in range(nblocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.blocks.append(add_flax(self, "GNBasicBlock", GNBasicBlock(
                    cin, filters, strides, groups, dtype)))
                cin = filters
        self.Dense_0 = Dense(cin, output_dim, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x.to(self.dtype))))
        for block in self.blocks:
            x = block(x)
        return self.Dense_0(spatial_mean(x).to(torch.float32))


@register_model("resnet18_gn")
def _resnet18_gn(output_dim: int, dtype=torch.float32, **_):
    return ModelBundle(name="resnet18_gn", module=ResNet18GN(output_dim, dtype=dtype),
                       input_shape=(24, 24, 3))
