"""MobileNet v1 and v3, CIFAR-sized (counterpart of
``fedml_tpu/models/mobilenet.py``), NHWC throughout.

Every BatchNorm is a :class:`~fedml_tpu_torch.models.norm.PallasBatchNorm`
under ``bn_impl``: ``"pallas"`` runs it through K1/K2, with the ReLU fused
where a ReLU follows it (v1 everywhere, v3 where a block's activation is
relu); a hard_swish follows a BN with the ReLU off. ``"xla"`` is the plain
BN. Submodules carry the flax names (``DepthwiseSeparable_3.Conv_0``,
``InvertedResidual_2.SqueezeExcite_0.Dense_1``), so ``models/convert.py``
maps the weights. The depthwise convs are grouped convs of
``models/layers.Conv`` with flax's SAME padding, asymmetric at stride 2;
the squeeze-excite Dense layers are plain ``F.linear``.

BNs a forward: v1 27 (C up to 1024), v3 small 34 (C up to 576), v3 large
46 (C up to 960).
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


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W of NHWC ``x``, taken in f32 and rounded to
    x's dtype, as ``jnp.mean`` does."""
    return x.to(torch.float32).mean((1, 2)).to(x.dtype)


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla"):
        super().__init__()
        self.Conv_0 = Conv(in_features, in_features, 3, stride=strides, groups=in_features,
                           dtype=dtype)
        self.bns = [add_batch_norm(self, in_features, bn_impl, fuse_relu=True)]
        self.Conv_1 = Conv(in_features, filters, 1, dtype=dtype)
        self.bns.append(add_batch_norm(self, filters, bn_impl, fuse_relu=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bns[1](self.Conv_1(self.bns[0](self.Conv_0(x))))


V1_SCHEDULE = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1), (512, 1),
               (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))


class MobileNetV1(nn.Module):
    """The standard v1 (channel, stride) schedule with a CIFAR stem (stride 1)."""

    def __init__(self, output_dim: int = 10, width: float = 1.0,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla",
                 schedule: Sequence[tuple] = V1_SCHEDULE):
        super().__init__()
        self.dtype = dtype
        cin = int(32 * width)
        self.Conv_0 = Conv(3, cin, 3, dtype=dtype)
        self.bns = [add_batch_norm(self, cin, bn_impl, fuse_relu=True)]
        self.blocks = []
        for ch, s in schedule:
            block = add_flax(self, "DepthwiseSeparable",
                             DepthwiseSeparable(cin, int(ch * width), s, dtype, bn_impl))
            self.blocks.append(block)
            cin = int(ch * width)
        self.Dense_0 = Dense(cin, output_dim, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bns[0](self.Conv_0(x.to(self.dtype)))
        for block in self.blocks:
            x = block(x)
        return self.Dense_0(spatial_mean(x).to(torch.float32))


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, reduce: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = max(features // reduce, 8)
        self.Dense_0 = Dense(features, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = hard_sigmoid(self.Dense_1(F.relu(self.Dense_0(spatial_mean(x)))))
        return x * s[:, None, None, :]


class InvertedResidual(nn.Module):
    def __init__(self, in_features: int, exp: int, filters: int, kernel: int, strides: int,
                 use_se: bool, use_hs: bool, dtype: torch.dtype = torch.float32,
                 bn_impl: str = "xla"):
        super().__init__()
        self.use_hs = use_hs
        self.expand = exp != in_features
        self.residual = strides == 1 and in_features == filters
        relu = not use_hs
        # (conv, bn) pairs in order: the expansion (when exp != in), the
        # depthwise conv, the projection; flax numbers them Conv_0.., BatchNorm_0..
        self.stages = []
        if self.expand:
            self.stages.append((add_flax(self, "Conv", Conv(in_features, exp, 1, dtype=dtype)),
                                add_batch_norm(self, exp, bn_impl, fuse_relu=relu)))
        self.stages.append((add_flax(self, "Conv", Conv(exp, exp, kernel, stride=strides,
                                                        groups=exp, dtype=dtype)),
                            add_batch_norm(self, exp, bn_impl, fuse_relu=relu)))
        self.use_se = use_se
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(exp, dtype=dtype)
        self.stages.append((add_flax(self, "Conv", Conv(exp, filters, 1, dtype=dtype)),
                            add_batch_norm(self, filters, bn_impl)))

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        return hard_swish(y) if self.use_hs else y      # relu is fused into the BN

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, bn in self.stages[:-1]:
            y = self._act(bn(conv(y)))
        if self.use_se:
            y = self.SqueezeExcite_0(y)
        conv, bn = self.stages[-1]
        y = bn(conv(y))
        return y + x if self.residual else y


# (kernel, exp, out, SE, HS, stride): the v3-large and v3-small schedules
V3_LARGE = (
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2), (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2), (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1), (5, 960, 160, True, True, 1),
)
V3_SMALL = (
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2), (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2), (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1), (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1), (5, 576, 96, True, True, 1),
)


class MobileNetV3(nn.Module):
    def __init__(self, output_dim: int = 10, mode: str = "small",
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla"):
        super().__init__()
        if mode not in ("small", "large"):
            raise ValueError(f"mode must be 'small' or 'large', got {mode!r}")
        self.dtype = dtype
        self.Conv_0 = Conv(3, 16, 3, dtype=dtype)
        self.bns = [add_batch_norm(self, 16, bn_impl)]
        self.blocks = []
        cin = 16
        for k, exp, out, se, hs, s in (V3_LARGE if mode == "large" else V3_SMALL):
            self.blocks.append(add_flax(self, "InvertedResidual", InvertedResidual(
                cin, exp, out, k, s, se, hs, dtype, bn_impl)))
            cin = out
        last = 960 if mode == "large" else 576
        self.Conv_1 = Conv(cin, last, 1, dtype=dtype)
        self.bns.append(add_batch_norm(self, last, bn_impl))
        hidden = 1280 if mode == "large" else 1024
        self.Dense_0 = Dense(last, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, output_dim, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hard_swish(self.bns[0](self.Conv_0(x.to(self.dtype))))
        for block in self.blocks:
            x = block(x)
        x = hard_swish(self.bns[1](self.Conv_1(x)))
        x = hard_swish(self.Dense_0(spatial_mean(x)))
        return self.Dense_1(x.to(torch.float32))


@register_model("mobilenet")
def _mobilenet(output_dim: int, dtype=torch.float32, bn_impl: str = "xla", **_):
    return ModelBundle(name="mobilenet", module=MobileNetV1(output_dim, dtype=dtype,
                                                            bn_impl=bn_impl),
                       input_shape=(32, 32, 3))


@register_model("mobilenet_v3")
def _mobilenet_v3(output_dim: int, mode: str = "small", dtype=torch.float32,
                  bn_impl: str = "xla", **_):
    return ModelBundle(name="mobilenet_v3",
                       module=MobileNetV3(output_dim, mode=mode, dtype=dtype, bn_impl=bn_impl),
                       input_shape=(32, 32, 3))
