"""BatchNorm module over channels-last activations (counterpart of
``fedml_tpu/models/norm.py:PallasBatchNorm`` and, with ``use_kernel=False``,
of flax ``nn.BatchNorm`` on the same path).

Leaves follow flax: parameters ``scale``/``bias``, buffers ``mean``/``var``.
The running statistics move as flax moves them: ``ra = m * ra + (1 - m) *
batch`` with momentum ``m = 0.9`` and the BIASED batch variance.
``torch.nn.BatchNorm2d`` is not a drop-in: it blends the unbiased variance,
and its ``momentum`` weights the other side of the blend.
"""

from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.ops.batchnorm import bn_relu_fwd_plain, fused_bn_relu


class PallasBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 fuse_relu: bool = False, use_kernel: bool = True):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.fuse_relu = fuse_relu
        self.use_kernel = use_kernel
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = (x.to(torch.float32) - self.mean) * torch.rsqrt(self.var + self.epsilon) \
                * self.scale + self.bias
            if self.fuse_relu:
                y = torch.clamp_min(y, 0.0)
            return y.to(x.dtype)
        if self.use_kernel:
            y, mean, var = fused_bn_relu(x, self.scale, self.bias, self.epsilon, self.fuse_relu)
        else:
            C = x.shape[-1]
            y, mean, _rstd, var = bn_relu_fwd_plain(
                x.reshape(-1, C), self.scale, self.bias, self.epsilon, self.fuse_relu)
            y = y.reshape(x.shape)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean.detach())
            self.var.copy_(m * self.var + (1.0 - m) * var.detach())
        return y
