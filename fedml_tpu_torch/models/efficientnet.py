"""EfficientNet-B0..B7 (counterpart of ``fedml_tpu/models/efficientnet.py``):
MBConv blocks with expansion, squeeze-excite, swish, stochastic depth and
compound width/depth scaling, NHWC, CIFAR-sized input by default.

Every BatchNorm (momentum 0.99) is a
:class:`~fedml_tpu_torch.models.norm.PallasBatchNorm` under ``bn_impl``
with the ReLU off (swish follows, or nothing): ``"pallas"`` runs it
through K1/K2. The widest rows are b0's 1280, b2's 2112 and b7's 3840
channels, which the kernels take since their wide instantiation.

Stochastic depth drops a residual block's branch per sample at rate
``0.2 * block_idx / total`` (blocks with a residual only), and the head
drops at the variant's ``_SCALING`` rate. Both are explicit-key dropout
(``ops/dropout.seed_dropout``) at call sites numbered in forward order,
the dropping blocks first and the head last: ``forward(x, dropout_key)``
takes the step's key. The JAX package draws them from the flax
``'dropout'`` stream, so the bundle has ``uses_dropout`` but not
``explicit_dropout`` (no packed twin either).

The squeeze-excite 1x1 convs have biases and no dtype (they compute in
the promoted type, f32 under a bf16 model), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import reset_submodules
from fedml_tpu_torch.models.layers import Conv, Dense, add_flax
from fedml_tpu_torch.models.mobilenet import spatial_mean
from fedml_tpu_torch.models.norm import add_batch_norm
from fedml_tpu_torch.ops.dropout import seed_dropout

# (expand_ratio, channels, repeats, stride, kernel): the B0 backbone
_B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# width_mult, depth_mult, resolution, dropout
_SCALING = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

BN_MOMENTUM = 0.99


def _round_filters(filters: float, width_mult: float, divisor: int = 8) -> int:
    f = filters * width_mult
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(repeats * depth_mult))


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, reduced: int):
        super().__init__()
        self.Conv_0 = Conv(features, reduced, 1, use_bias=True)
        self.Conv_1 = Conv(reduced, features, 1, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.to(torch.float32).mean((1, 2), keepdim=True).to(x.dtype)
        s = self.Conv_1(F.silu(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """``site``: this block's dropout call site, used when it has a
    residual and ``drop_rate > 0``."""

    def __init__(self, c_in: int, c_out: int, expand: int, stride: int, kernel: int,
                 drop_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 bn_impl: str = "xla", site: int = 0):
        super().__init__()
        ch = c_in * expand
        self.stages = []           # (conv, bn): expansion (expand != 1), depthwise
        if expand != 1:
            self.stages.append((add_flax(self, "Conv", Conv(c_in, ch, 1, dtype=dtype)),
                                add_batch_norm(self, ch, bn_impl, momentum=BN_MOMENTUM)))
        self.stages.append((add_flax(self, "Conv", Conv(ch, ch, kernel, stride=stride, groups=ch,
                                                        dtype=dtype)),
                            add_batch_norm(self, ch, bn_impl, momentum=BN_MOMENTUM)))
        self.SqueezeExcite_0 = SqueezeExcite(ch, max(1, c_in // 4))
        self.project = (add_flax(self, "Conv", Conv(ch, c_out, 1, dtype=dtype)),
                        add_batch_norm(self, c_out, bn_impl, momentum=BN_MOMENTUM))
        self.residual = stride == 1 and c_in == c_out
        self.drop_rate, self.site = drop_rate, site

    @property
    def drops(self) -> bool:
        """Whether the block takes a dropout call site."""
        return self.residual and self.drop_rate > 0

    def forward(self, x: torch.Tensor, dropout_key: Optional[torch.Tensor] = None):
        y = x
        for conv, bn in self.stages:
            y = F.silu(bn(conv(y)))
        y = self.SqueezeExcite_0(y)
        conv, bn = self.project
        y = bn(conv(y))
        if self.residual:
            if self.drops:      # stochastic depth: the whole branch, per sample
                y = seed_dropout(y, dropout_key, self.drop_rate, self.site, not self.training,
                                 shape=(y.shape[0], 1, 1, 1))
            y = y + x
        return y


class EfficientNet(nn.Module):
    def __init__(self, variant: str = "b0", output_dim: int = 10,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla"):
        super().__init__()
        width, depth, _, dropout = _SCALING[variant]
        self.dtype, self.dropout = dtype, dropout
        stem = _round_filters(32, width)
        self.Conv_0 = Conv(3, stem, 3, stride=2, dtype=dtype)
        self.bns = [add_batch_norm(self, stem, bn_impl, momentum=BN_MOMENTUM)]
        total = sum(_round_repeats(r, depth) for _, _, r, _, _ in _B0_BLOCKS)
        self.blocks, cin, site = [], stem, 0
        for expand, c, repeats, stride, kernel in _B0_BLOCKS:
            c_out = _round_filters(c, width)
            for i in range(_round_repeats(repeats, depth)):
                # linearly increasing stochastic depth, survival 0.8 at the top
                drop = 0.2 * len(self.blocks) / max(total, 1)
                block = add_flax(self, "MBConv", MBConv(cin, c_out, expand, stride if i == 0 else 1,
                                                        kernel, drop, dtype, bn_impl, site))
                site += block.drops
                self.blocks.append(block)
                cin = c_out
        head = _round_filters(1280, width)
        self.Conv_1 = Conv(cin, head, 1, dtype=dtype)
        self.bns.append(add_batch_norm(self, head, bn_impl, momentum=BN_MOMENTUM))
        self.head_site = site
        self.Dense_0 = Dense(head, output_dim, dtype=torch.float32)

    @property
    def dropout_sites(self) -> int:
        """Dropout call sites a train-mode forward uses."""
        return self.head_site + (self.dropout > 0)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor, dropout_key: Optional[torch.Tensor] = None):
        x = F.silu(self.bns[0](self.Conv_0(x.to(self.dtype))))
        for block in self.blocks:
            x = block(x, dropout_key)
        x = F.silu(self.bns[1](self.Conv_1(x)))
        x = seed_dropout(spatial_mean(x), dropout_key, self.dropout, self.head_site,
                         not self.training)
        return self.Dense_0(x.to(torch.float32))


def _register(variant: str):
    name = f"efficientnet-{variant}"

    @register_model(name)
    def _factory(output_dim: int, dtype=torch.float32, bn_impl: str = "xla", **_):
        return ModelBundle(name=name, module=EfficientNet(variant, output_dim, dtype, bn_impl),
                           input_shape=(32, 32, 3), uses_dropout=True)
    return _factory


for _v in _SCALING:
    _register(_v)
