"""CIFAR ResNets (counterpart of ``fedml_tpu/models/resnet.py``).

Depth 6n+2: a 3x3 stem, three stages of BasicBlocks (widths 16/32/64 by
default), a 1x1 projection shortcut where the shape changes, global average
pooling and a Dense head in f32.

Activations stay NHWC, as in the JAX package. A ``permute(0, 3, 1, 2)`` of
an NHWC-contiguous tensor is ``torch.channels_last`` memory, so
``F.conv2d`` runs on channels-last tensors and the BatchNorm kernel sees the
row-major ``[N*H*W, C]`` buffer. Submodules are named after their flax
paths (``Conv_0``, ``PallasBatchNorm_0`` or ``BatchNorm_0``,
``BasicBlock_3``, ``Dense_0``), so weight conversion is a path map
(``models/convert.py``).

``conv_impl="lanes"`` runs the stages of width <= 32 on the lanes layout
``[N, C, H*W]`` (``ops/conv_lanes.py``): their 3x3 convs go through the
hand-written kernels K3/K4 and their BatchNorms are the plain
``BatchNorm(axis=1)``; the stem and wider stages stay NHWC. The lanes modules
keep the NHWC names, so both bodies share one state dict. ``"packed"``
raises ``NotImplementedError``.

``n_lanes=L > 0`` builds the lane-stacked twin that the packed schedule
trains (``parallel/packed.py``), the counterpart of ``vmap`` of the model
over L lanes: the lanes are folded into the channel axis, so activations are
NHWC ``[N, H, W, L*C]`` with lane l's channel c at ``l*C + c``. Each conv is
one grouped ``F.conv2d(groups=L)`` (weight ``[L*Co, Ci, k, k]``), each
train-mode BatchNorm one call over ``[N*H*W, L*C]`` (with ``bn_impl="pallas"``
one K1 and one K2 launch for all lanes; the statistics are per channel, so
per lane), and the head a per-lane Dense. It takes ``[L, N, H, W, 3]`` and
gives ``[L, N, out]``; its state dict has the plain model's keys, each leaf
folded as ``ops/packed_conv.stack_variables`` folds it. Only the NHWC body
(``conv_impl="xla"``) has a lane-stacked twin.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import lecun_normal_
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.norm import PallasBatchNorm
from fedml_tpu_torch.ops import conv_lanes


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax padding='SAME': (low, high) pads of one spatial dim. At k=3,
    s=2 on an even size this is (0, 1), not PyTorch's symmetric (1, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding='SAME')`` on NHWC input;
    ``weight`` is OIHW. Computes in the input's dtype. ``n_lanes=L > 0``:
    L independent convs on the lane-folded channels, weight
    ``[L*features, in_features, k, k]``, one ``groups=L`` conv."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 n_lanes: int = 0):
        super().__init__()
        self.stride = stride
        self.groups = max(n_lanes, 1)
        self.weight = nn.Parameter(torch.empty(self.groups * features, in_features,
                                               kernel_size, kernel_size))

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        (ht, hb), (wl, wr) = (_same_pads(x.shape[1], k, self.stride),
                              _same_pads(x.shape[2], k, self.stride))
        xc = x.permute(0, 3, 1, 2)           # channels_last memory
        if (ht, wl) == (hb, wr):
            pad = (ht, wl)
        else:
            xc = F.pad(xc, (wl, wr, ht, hb))
            pad = 0
        y = F.conv2d(xc, self.weight.to(x.dtype), stride=self.stride, padding=pad,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


def _norm(features: int, bn_impl: str, fuse_relu: bool = False,
          axis: int = -1) -> tuple[str, PallasBatchNorm]:
    """(flax class name, module) of one train-mode BatchNorm."""
    name = "PallasBatchNorm" if bn_impl == "pallas" else "BatchNorm"
    return name, PallasBatchNorm(features, momentum=0.9, fuse_relu=fuse_relu,
                                 use_kernel=bn_impl == "pallas", axis=axis)


class BasicBlock(nn.Module):
    """NHWC body, or with ``conv_impl="lanes"`` the lanes body
    (``fedml_tpu/models/resnet.py:_call_lanes``), whose ``forward`` also
    takes the input's (H, W)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1, bn_impl: str = "xla",
                 conv_impl: str = "xla", n_lanes: int = 0):
        super().__init__()
        lanes = conv_impl == "lanes"
        conv = conv_lanes.Conv if lanes else functools.partial(Conv, n_lanes=n_lanes)
        axis = 1 if lanes else -1
        width = max(n_lanes, 1) * filters     # the lane-folded channels
        bn, n0 = _norm(width, bn_impl, fuse_relu=True, axis=axis)
        _, n1 = _norm(width, bn_impl, axis=axis)
        self.Conv_0 = conv(in_features, filters, 3, strides)
        self.add_module(f"{bn}_0", n0)
        self.Conv_1 = conv(filters, filters, 3)
        self.add_module(f"{bn}_1", n1)
        self.project = strides != 1 or in_features != filters
        if self.project:
            self.Conv_2 = conv(in_features, filters, 1, strides)
            self.add_module(f"{bn}_2", _norm(width, bn_impl, axis=axis)[1])
        self._bn = bn
        self.lanes = lanes
        self.strides = strides

    def forward(self, x: torch.Tensor, hw: Optional[tuple] = None) -> torch.Tensor:
        bn = self._bn
        if self.lanes:
            h, w = hw
            s = self.strides
            y = getattr(self, f"{bn}_0")(self.Conv_0(x, (h, w)))      # BN + fused ReLU
            y = getattr(self, f"{bn}_1")(self.Conv_1(y, (h // s, w // s)))
            residual = x
            if self.project:
                residual = getattr(self, f"{bn}_2")(self.Conv_2(x, (h, w)))
            return torch.relu(y + residual)
        y = getattr(self, f"{bn}_0")(self.Conv_0(x))      # BN + fused ReLU
        y = getattr(self, f"{bn}_1")(self.Conv_1(y))
        residual = x
        if self.project:
            residual = getattr(self, f"{bn}_2")(self.Conv_2(x))
        return torch.relu(y + residual)


class CifarResNet(nn.Module):
    """depth = 6 * blocks_per_stage + 2."""

    def __init__(self, blocks_per_stage: int, output_dim: int = 10,
                 dtype: torch.dtype = torch.float32, widths: tuple = (16, 32, 64),
                 bn_impl: str = "xla", conv_impl: str = "xla", n_lanes: int = 0):
        super().__init__()
        if conv_impl == "packed":
            raise NotImplementedError("conv_impl='packed' is not ported yet")
        if conv_impl not in ("xla", "lanes"):
            raise ValueError(f"conv_impl must be 'xla', 'lanes' or 'packed', got {conv_impl!r}")
        if bn_impl not in ("xla", "pallas"):
            raise ValueError(f"bn_impl must be 'xla' or 'pallas', got {bn_impl!r}")
        if conv_impl == "lanes" and bn_impl == "pallas":
            raise ValueError("conv_impl='lanes' uses the plain BatchNorm on its own layout; "
                             "combine it with bn_impl='xla'")
        if n_lanes and conv_impl != "xla":
            raise NotImplementedError(f"conv_impl={conv_impl!r} has no lane-stacked twin "
                                      "(the packed schedule takes conv_impl='xla')")
        self._config = dict(blocks_per_stage=blocks_per_stage, output_dim=output_dim,
                            dtype=dtype, widths=tuple(widths), bn_impl=bn_impl,
                            conv_impl=conv_impl)
        self.dtype = dtype
        self.n_lanes = n_lanes
        self.Conv_0 = Conv(3, widths[0], 3, n_lanes=n_lanes)         # RGB input
        bn, stem_norm = _norm(max(n_lanes, 1) * widths[0], bn_impl, fuse_relu=True)
        self.add_module(f"{bn}_0", stem_norm)
        self._stem_norm = f"{bn}_0"
        # lanes: the stages of width <= 32 run on the lanes layout
        blocks, cin, i = [], widths[0], 0
        for stage, filters in enumerate(widths):
            lanes = conv_impl == "lanes" and filters <= 32
            for block in range(blocks_per_stage):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"BasicBlock_{i}", BasicBlock(
                    cin, filters, strides, bn_impl, "lanes" if lanes else "xla", n_lanes))
                blocks.append(f"BasicBlock_{i}")
                cin, i = filters, i + 1
        self._blocks = blocks
        self.Dense_0 = Dense(cin, output_dim, n_lanes=n_lanes)

    def lane_stacked(self, n_lanes: int) -> "CifarResNet":
        """A new lane-stacked twin of this model for ``n_lanes`` lanes, on
        this model's device (its weights are the caller's to set)."""
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        twin = CifarResNet(**self._config, n_lanes=n_lanes)
        return twin.to(self.Conv_0.weight.device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh weights from ``generator``, in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, C] images -> [N, output_dim] f32 logits; lane-stacked,
        [L, N, H, W, C] -> [L, N, output_dim]."""
        x = x.to(self.dtype)
        if self.n_lanes:        # [L, N, H, W, C] -> [N, H, W, L*C]
            x = x.permute(1, 2, 3, 0, 4).reshape(*x.shape[1:4], -1)
        x = getattr(self, self._stem_norm)(self.Conv_0(x))
        h, w = x.shape[1], x.shape[2]
        in_lanes = False
        for name in self._blocks:
            block = getattr(self, name)
            if in_lanes and not block.lanes:
                x, in_lanes = conv_lanes.from_lanes(x, h, w), False
            elif block.lanes and not in_lanes:
                x, in_lanes = conv_lanes.to_lanes(x), True
            x = block(x, (h, w)) if in_lanes else block(x)
            if block.strides == 2:
                h, w = h // 2, w // 2
        if in_lanes:
            x = conv_lanes.from_lanes(x, h, w)
        # the mean is taken in f32 and rounded to the compute dtype, as
        # jnp.mean does, before the f32 head
        pooled = x.to(torch.float32).mean((1, 2)).to(x.dtype)
        return self.Dense_0(pooled.to(torch.float32))


def _make(depth: int, output_dim: int, dtype=torch.float32, bn_impl: str = "xla",
          conv_impl: str = "xla", widths: tuple = (16, 32, 64)) -> CifarResNet:
    if (depth - 2) % 6:
        raise ValueError("CIFAR ResNet depth must be 6n+2")
    return CifarResNet((depth - 2) // 6, output_dim, dtype=dtype, widths=widths,
                       bn_impl=bn_impl, conv_impl=conv_impl)


def _register_resnet(name: str, depth: int):
    @register_model(name)
    def _factory(output_dim: int, dtype=torch.float32, bn_impl: str = "xla",
                 conv_impl: str = "xla", widths: tuple = (16, 32, 64), **_):
        return ModelBundle(
            name=name,
            module=_make(depth, output_dim, dtype, bn_impl, conv_impl, widths),
            input_shape=(32, 32, 3),
        )
    return _factory


_register_resnet("resnet56", 56)
_register_resnet("resnet110", 110)
_register_resnet("resnet20", 20)

