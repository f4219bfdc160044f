"""BatchNorm module (counterpart of ``fedml_tpu/models/norm.py:PallasBatchNorm``
over channels-last activations and, with ``use_kernel=False``, of flax
``nn.BatchNorm``).

Leaves follow flax: parameters ``scale``/``bias``, buffers ``mean``/``var``.
The running statistics move as flax moves them: ``ra = m * ra + (1 - m) *
batch`` with momentum ``m = 0.9`` and the BIASED batch variance.
``torch.nn.BatchNorm2d`` is not a drop-in: it blends the unbiased variance,
and its ``momentum`` weights the other side of the blend.

``affine=False`` is flax ``nn.BatchNorm(use_scale=False, use_bias=False)``
(DARTS): ``scale`` = 1 and ``bias`` = 0 are non-persistent buffers, so
they are in no parameter list and no state dict, as flax has no such
leaves.

``axis=1`` is flax ``nn.BatchNorm(axis=1)`` on the lanes layout
``[N, C, H*W]`` (``conv_impl="lanes"``): statistics over (N, H*W), the
same numerics, plain PyTorch only (the JAX package runs no BN kernel on
that layout).
"""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.ops.batchnorm import fused_bn_relu


class PallasBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 fuse_relu: bool = False, use_kernel: bool = True, axis: int = -1,
                 affine: bool = True):
        super().__init__()
        if axis not in (-1, 1) or (axis == 1 and use_kernel):
            raise ValueError(f"axis must be -1, or 1 without the kernel; got axis={axis}, "
                             f"use_kernel={use_kernel}")
        self.axis = axis
        self.momentum = momentum
        self.epsilon = epsilon
        self.fuse_relu = fuse_relu
        self.use_kernel = use_kernel
        if affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_buffer("scale", torch.ones(features), persistent=False)
            self.register_buffer("bias", torch.zeros(features), persistent=False)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()           # broadcasts a [C] vector along the channel axis
        shape[self.axis] = -1
        if not self.training:
            y = (x.to(torch.float32) - self.mean.view(shape)) \
                * torch.rsqrt(self.var + self.epsilon).view(shape) \
                * self.scale.view(shape) + self.bias.view(shape)
            if self.fuse_relu:
                y = torch.clamp_min(y, 0.0)
            return y.to(x.dtype)
        if self.use_kernel:
            y, mean, var = fused_bn_relu(x, self.scale, self.bias, self.epsilon, self.fuse_relu)
        else:
            y, mean, var = _bn_plain(x, self.scale, self.bias, self.epsilon, self.fuse_relu, shape)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean.detach())
            self.var.copy_(m * self.var + (1.0 - m) * var.detach())
        return y


def _bn_plain(x, gamma, beta, eps: float, relu: bool, shape: list):
    """Plain train-mode BN(+ReLU) over every axis of ``x`` but the channel
    axis (the one where ``shape`` is -1): f32 statistics, biased variance,
    output in x's dtype. Returns (y, mean, var)."""
    dims = tuple(d for d, n in enumerate(shape) if n == 1)
    x32 = x.to(torch.float32)
    mean = x32.mean(dims)
    xc = x32 - mean.view(shape)
    var = (xc * xc).mean(dims)
    y = xc * torch.rsqrt(var + eps).view(shape) * gamma.view(shape) + beta.view(shape)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype), mean, var
