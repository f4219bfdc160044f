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

Synchronized BN (the JAX package's ``bn_axis`` / GSPMD's batch moments):
``bn_axis="batch"`` is flax ``nn.BatchNorm(axis_name=...)``: the plain BN
whose f32 moments E[x] and E[x^2] are averaged over that axis of the bound
mesh (``parallel/mesh.bound_axes``) through a differentiable all-reduce,
with var = max(E[x^2] - E[x]^2, 0) (biased); it launches no kernel,
whatever ``bn_impl`` says, as in the JAX package. Inside
:class:`sync_batch_norm` (the data-parallel step) every BN of a model
without ``bn_axis`` sees the global batch too: the plain BN syncs its
moments, and the kernel BN gathers the axis's rows and runs K1/K2 on the
whole batch (what GSPMD does around a custom call it cannot partition),
keeping this rank's rows. On an axis of one rank the BN runs as given.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models.layers import add_flax
from fedml_tpu_torch.ops.batchnorm import fused_bn_relu
from fedml_tpu_torch.parallel.collectives import all_gather_rows, all_reduce_sum
from fedml_tpu_torch.parallel.mesh import axis_line

#: the data-parallel axis whose global batch every BN without its own
#: ``bn_axis`` normalizes over (:class:`sync_batch_norm`); process-wide
_SYNC_AXIS: list = []


class sync_batch_norm:
    """``with sync_batch_norm(axis):`` makes every train-mode BN without a
    ``bn_axis`` normalize over the global batch of the bound ``axis`` (the
    data-parallel step, ``parallel/dataparallel.py``)."""

    def __init__(self, axis: str):
        self.axis = axis

    def __enter__(self):
        _SYNC_AXIS.append(self.axis)

    def __exit__(self, *_exc):
        _SYNC_AXIS.pop()


def running_variance_names(module: nn.Module) -> list[str]:
    """The state-dict names of every BatchNorm's running variance in
    ``module``: leaves that must stay ``>= 0`` for an evaluation to be
    finite."""
    return [f"{name}.var" if name else "var" for name, m in module.named_modules()
            if isinstance(m, PallasBatchNorm)]


class PallasBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 fuse_relu: bool = False, use_kernel: bool = True, axis: int = -1,
                 affine: bool = True, bn_axis: Optional[str] = None):
        super().__init__()
        self.bn_axis = bn_axis
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
        sync = self.bn_axis or (_SYNC_AXIS[-1] if _SYNC_AXIS else None)
        line = axis_line(sync) if sync else None
        args = (self.scale, self.bias, self.epsilon, self.fuse_relu)
        if self.bn_axis is not None or (line is not None and line.size > 1
                                        and not self.use_kernel):
            y, mean, var = _bn_sync(x, *args, shape, line)
        elif line is not None and line.size > 1:
            rows = x.shape[0]
            y, mean, var = fused_bn_relu(all_gather_rows(line, x), *args)
            y = y[line.index * rows:(line.index + 1) * rows]
        elif self.use_kernel:
            y, mean, var = fused_bn_relu(x, *args)
        else:
            y, mean, var = _bn_plain(x, *args, shape)
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


def _bn_sync(x, gamma, beta, eps: float, relu: bool, shape: list, line):
    """flax's ``nn.BatchNorm(axis_name=...)``: f32 E[x] and E[x^2] over
    every axis but the channel axis, averaged over ``line`` (the identity
    without one), var = max(E[x^2] - E[x]^2, 0). Returns (y, mean, var)."""
    dims = tuple(d for d, n in enumerate(shape) if n == 1)
    x32 = x.to(torch.float32)
    moments = torch.stack([x32.mean(dims), (x32 * x32).mean(dims)])
    if line is not None and line.size > 1:
        moments = all_reduce_sum(line, moments) / line.size
    mean, mean2 = moments[0], moments[1]
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (x32 - mean.view(shape)) * (torch.rsqrt(var + eps) * gamma).view(shape) + beta.view(shape)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype), mean, var


def batch_norm(features: int, bn_impl: str, fuse_relu: bool = False, axis: int = -1,
               momentum: float = 0.9, bn_axis: Optional[str] = None
               ) -> tuple[str, PallasBatchNorm]:
    """(flax class name, module) of one train-mode BatchNorm: ``BatchNorm``
    (the plain BN) or, for ``bn_impl="pallas"``, ``PallasBatchNorm`` (the
    kernel pair K1/K2). With ``bn_axis`` it is the plain ``BatchNorm``
    synchronized over that mesh axis, whatever ``bn_impl`` says."""
    if bn_impl not in ("xla", "pallas"):
        raise ValueError(f"bn_impl must be 'xla' or 'pallas', got {bn_impl!r}")
    kernel = bn_impl == "pallas" and bn_axis is None
    return ("PallasBatchNorm" if kernel else "BatchNorm",
            PallasBatchNorm(features, momentum=momentum, fuse_relu=fuse_relu,
                            use_kernel=kernel, axis=axis, bn_axis=bn_axis))


def add_batch_norm(parent: nn.Module, features: int, bn_impl: str, fuse_relu: bool = False,
                   momentum: float = 0.9) -> PallasBatchNorm:
    """Register the next train-mode BatchNorm of ``parent`` under its flax
    name (``BatchNorm_i`` or ``PallasBatchNorm_i``, :func:`batch_norm`) and
    return it."""
    return add_flax(parent, *batch_norm(features, bn_impl, fuse_relu, momentum=momentum))
