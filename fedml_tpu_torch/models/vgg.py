"""VGG-11/16/19 with BatchNorm, CIFAR-sized (counterpart of
``fedml_tpu/models/vgg.py``), NHWC.

Each 3x3 SAME conv (no bias under BN, as in the JAX package) is followed by
a :class:`~fedml_tpu_torch.models.norm.PallasBatchNorm` with the ReLU
fused (``bn_impl="pallas"``: K1/K2), and each ``"M"`` is a 2x2 VALID max
pool. The flattened features (NHWC order) go through Dense(512) + ReLU and
an f32 Dense head. BNs a forward: vgg11 8, vgg16 13, vgg19 16 (C up to 512).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import reset_submodules
from fedml_tpu_torch.models.layers import Conv, Dense, add_flax
from fedml_tpu_torch.models.norm import add_batch_norm

_CFG: dict[str, Sequence] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512,
              "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512,
              512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, output_dim: int = 10, use_bn: bool = True,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla",
                 input_shape: Sequence[int] = (32, 32, 3)):
        super().__init__()
        self.dtype = dtype
        h, w, cin = (int(s) for s in input_shape)
        self.layers = []       # (conv, bn or None), or None for a pool
        for v in cfg:
            if v == "M":
                self.layers.append(None)
                h, w = h // 2, w // 2
                continue
            conv = add_flax(self, "Conv", Conv(cin, v, 3, use_bias=not use_bn, dtype=dtype))
            bn = add_batch_norm(self, v, bn_impl, fuse_relu=True) if use_bn else None
            self.layers.append((conv, bn))
            cin = v
        self.Dense_0 = Dense(h * w * cin, 512, dtype=dtype)
        self.Dense_1 = Dense(512, output_dim, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.layers:
            if layer is None:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
                continue
            conv, bn = layer
            x = bn(conv(x)) if bn is not None else F.relu(conv(x))
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x.to(torch.float32))


def _register(name: str):
    @register_model(name)
    def _factory(output_dim: int, input_shape: Optional[Sequence[int]] = None,
                 dtype=torch.float32, bn_impl: str = "xla", **_):
        shape = tuple(input_shape) if input_shape is not None else (32, 32, 3)
        return ModelBundle(name=name, module=VGG(_CFG[name], output_dim, dtype=dtype,
                                                 bn_impl=bn_impl, input_shape=shape),
                           input_shape=(32, 32, 3))
    return _factory


for _name in _CFG:
    _register(_name)
