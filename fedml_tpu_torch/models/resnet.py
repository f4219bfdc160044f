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

``use_norm=False`` (``resnet56_nonorm``) has no BatchNorm: the ReLU that
followed a norm stays. ``resnet56_w64`` / ``resnet56_w128`` are uniform
widths at depth 56.

``conv_impl="lanes"`` runs the stages of width <= 32 on the lanes layout
``[N, C, H*W]`` (``ops/conv_lanes.py``): their 3x3 convs go through the
hand-written kernels K3/K4 and their BatchNorms are the plain
``BatchNorm(axis=1)``; the stem and wider stages stay NHWC. The lanes modules
keep the NHWC names, so both bodies share one state dict. ``"packed"``
(the JAX package's lane-major packed body) is the lane-stacked twin below.

``n_lanes=L > 0`` builds the lane-stacked twin that the packed schedule
trains (``parallel/packed.py``), the counterpart of ``vmap`` of the model
over L lanes (the JAX package's ``conv_impl="packed"`` body): the lanes are
folded into the channel axis, so activations are NHWC ``[N, H, W, L*C]`` with
lane l's channel c at ``l*C + c``. Each conv is L lanes' convs in one call
(weight ``[L*Co, Ci, k, k]``), lowered as ``packed_impl`` says
(``ops/packed_conv.py``): ``"off"`` (the default) and ``"grouped"`` one
``F.conv2d(groups=L)``, ``"blockdiag"`` one block-diagonal im2col GEMM. Each
train-mode BatchNorm is one call over ``[N*H*W, L*C]`` (with
``bn_impl="pallas"`` one K1 and one K2 launch for all lanes, under every
lowering; the statistics are per channel, so per lane), and the head a
per-lane Dense. It takes ``[L, N, H, W, 3]`` and gives ``[L, N, out]``; its
state dict has the plain model's keys, each leaf folded as
``ops/packed_conv.stack_variables`` folds it. Only the NHWC body
(``conv_impl="xla"``) has a lane-stacked twin.

``bn_axis`` (the JAX package's sync-BN over a mapped axis) makes every
BatchNorm the plain ``BatchNorm`` synchronized over that axis of the bound
mesh (``models/norm.py``), whatever ``bn_impl`` says: such a model runs no
K1/K2.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import lecun_normal_, reset_submodules
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.norm import batch_norm as _norm
from fedml_tpu_torch.ops import conv_lanes
from fedml_tpu_torch.ops.packed_conv import resolve_impl


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, padding='SAME')`` on NHWC input;
    ``weight`` is OIHW. Computes in the input's dtype. ``n_lanes=L > 0``:
    L independent convs on the lane-folded channels, weight
    ``[L*features, in_features, k, k]``, lowered as ``packed_impl`` says."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 n_lanes: int = 0, packed_impl: str = "off"):
        super().__init__()
        self.stride = stride
        self.n_lanes = n_lanes
        self.conv = resolve_impl(packed_impl)
        self.weight = nn.Parameter(torch.empty(max(n_lanes, 1) * features, in_features,
                                               kernel_size, kernel_size))

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.n_lanes, self.stride)


class BasicBlock(nn.Module):
    """NHWC body, or with ``conv_impl="lanes"`` the lanes body
    (``fedml_tpu/models/resnet.py:_call_lanes``), whose ``forward`` also
    takes the input's (H, W)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1, bn_impl: str = "xla",
                 conv_impl: str = "xla", n_lanes: int = 0, packed_impl: str = "off",
                 use_norm: bool = True, bn_axis: Optional[str] = None):
        super().__init__()
        lanes = conv_impl == "lanes"
        conv = conv_lanes.Conv if lanes else functools.partial(Conv, n_lanes=n_lanes,
                                                               packed_impl=packed_impl)
        axis = 1 if lanes else -1
        width = max(n_lanes, 1) * filters     # the lane-folded channels
        bn = _norm(width, bn_impl, bn_axis=bn_axis)[0] if use_norm else None
        self.project = strides != 1 or in_features != filters
        for i, (cin, k, s) in enumerate(((in_features, 3, strides), (filters, 3, 1),
                                         (in_features, 1, strides))[:3 if self.project else 2]):
            self.add_module(f"Conv_{i}", conv(cin, filters, k, s))
            if use_norm:
                self.add_module(f"{bn}_{i}", _norm(width, bn_impl, fuse_relu=i == 0, axis=axis,
                                                   bn_axis=bn_axis)[1])
        self._bn = bn
        self.use_norm = use_norm
        self.lanes = lanes
        self.strides = strides

    def _normed(self, i: int, y: torch.Tensor) -> torch.Tensor:
        """BatchNorm ``i`` (the first with its ReLU fused), or without norms
        (``use_norm=False``) that ReLU alone."""
        if self.use_norm:
            return getattr(self, f"{self._bn}_{i}")(y)
        return torch.relu(y) if i == 0 else y

    def forward(self, x: torch.Tensor, hw: Optional[tuple] = None) -> torch.Tensor:
        if self.lanes:
            h, w = hw
            s = self.strides
            y = self._normed(0, self.Conv_0(x, (h, w)))      # BN + fused ReLU
            y = self._normed(1, self.Conv_1(y, (h // s, w // s)))
            residual = x
            if self.project:
                residual = self._normed(2, self.Conv_2(x, (h, w)))
            return torch.relu(y + residual)
        y = self._normed(0, self.Conv_0(x))      # BN + fused ReLU
        y = self._normed(1, self.Conv_1(y))
        residual = x
        if self.project:
            residual = self._normed(2, self.Conv_2(x))
        return torch.relu(y + residual)


class CifarResNet(nn.Module):
    """depth = 6 * blocks_per_stage + 2."""

    def __init__(self, blocks_per_stage: int, output_dim: int = 10,
                 dtype: torch.dtype = torch.float32, widths: tuple = (16, 32, 64),
                 bn_impl: str = "xla", conv_impl: str = "xla", n_lanes: int = 0,
                 packed_impl: str = "off", use_norm: bool = True,
                 bn_axis: Optional[str] = None):
        super().__init__()
        if conv_impl == "packed":
            raise NotImplementedError("conv_impl='packed' (the JAX package's lane-major body) "
                                      "is the lane-stacked twin in the port: "
                                      "module.lane_stacked(L, packed_impl=...)")
        if conv_impl not in ("xla", "lanes"):
            raise ValueError(f"conv_impl must be 'xla', 'lanes' or 'packed', got {conv_impl!r}")
        if bn_impl not in ("xla", "pallas"):
            raise ValueError(f"bn_impl must be 'xla' or 'pallas', got {bn_impl!r}")
        if conv_impl == "lanes" and bn_impl == "pallas" and bn_axis is None:
            raise ValueError("conv_impl='lanes' uses the plain BatchNorm on its own layout; "
                             "combine it with bn_impl='xla'")
        if n_lanes and conv_impl != "xla":
            raise NotImplementedError(f"conv_impl={conv_impl!r} has no lane-stacked twin "
                                      "(the packed schedule takes conv_impl='xla')")
        self._config = dict(blocks_per_stage=blocks_per_stage, output_dim=output_dim,
                            dtype=dtype, widths=tuple(widths), bn_impl=bn_impl,
                            conv_impl=conv_impl, use_norm=use_norm, bn_axis=bn_axis)
        self.dtype = dtype
        self.n_lanes = n_lanes
        #: the lane-stacked twin takes the joint lowerings (ModelBundle.packed_twin)
        self.packed_twin = conv_impl == "xla"
        self.Conv_0 = Conv(3, widths[0], 3, n_lanes=n_lanes, packed_impl=packed_impl)  # RGB
        self._stem_norm = None
        if use_norm:
            bn, stem_norm = _norm(max(n_lanes, 1) * widths[0], bn_impl, fuse_relu=True,
                                  bn_axis=bn_axis)
            self.add_module(f"{bn}_0", stem_norm)
            self._stem_norm = f"{bn}_0"
        # lanes: the stages of width <= 32 run on the lanes layout
        blocks, cin, i = [], widths[0], 0
        for stage, filters in enumerate(widths):
            lanes = conv_impl == "lanes" and filters <= 32
            for block in range(blocks_per_stage):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"BasicBlock_{i}", BasicBlock(
                    cin, filters, strides, bn_impl, "lanes" if lanes else "xla", n_lanes,
                    packed_impl, use_norm, bn_axis))
                blocks.append(f"BasicBlock_{i}")
                cin, i = filters, i + 1
        self._blocks = blocks
        self.Dense_0 = Dense(cin, output_dim, n_lanes=n_lanes)

    def lane_stacked(self, n_lanes: int, packed_impl: str = "off") -> "CifarResNet":
        """A new lane-stacked twin of this model for ``n_lanes`` lanes whose
        convs take the lowering ``packed_impl`` ("off" | "grouped" |
        "blockdiag"), on this model's device (its weights are the caller's
        to set)."""
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        twin = CifarResNet(**self._config, n_lanes=n_lanes, packed_impl=packed_impl)
        return twin.to(self.Conv_0.weight.device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh weights from ``generator``, in module order."""
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, C] images -> [N, output_dim] f32 logits; lane-stacked,
        [L, N, H, W, C] -> [L, N, output_dim]."""
        x = x.to(self.dtype)
        if self.n_lanes:        # [L, N, H, W, C] -> [N, H, W, L*C]
            x = x.permute(1, 2, 3, 0, 4).reshape(*x.shape[1:4], -1)
        x = self.Conv_0(x)
        x = getattr(self, self._stem_norm)(x) if self._stem_norm else torch.relu(x)
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
          conv_impl: str = "xla", widths: tuple = (16, 32, 64),
          bn_axis: Optional[str] = None) -> CifarResNet:
    if (depth - 2) % 6:
        raise ValueError("CIFAR ResNet depth must be 6n+2")
    return CifarResNet((depth - 2) // 6, output_dim, dtype=dtype, widths=widths,
                       bn_impl=bn_impl, conv_impl=conv_impl, bn_axis=bn_axis)


def _register_resnet(name: str, depth: int):
    @register_model(name)
    def _factory(output_dim: int, dtype=torch.float32, bn_impl: str = "xla",
                 conv_impl: str = "xla", widths: tuple = (16, 32, 64),
                 bn_axis: Optional[str] = None, **_):
        return ModelBundle(
            name=name,
            module=_make(depth, output_dim, dtype, bn_impl, conv_impl, widths, bn_axis),
            input_shape=(32, 32, 3),
        )
    return _factory


_register_resnet("resnet56", 56)
_register_resnet("resnet110", 110)
_register_resnet("resnet20", 20)


def _register_variant(name: str, widths: tuple = (16, 32, 64), use_norm: bool = True):
    """The depth-56 measurement variants of the JAX package
    (``docs/mfu_experiments.md``): uniform widths, or no BatchNorm at all.
    Like the JAX bundles they have no joint packed lowering
    (``ModelBundle.packed_twin`` is False)."""

    @register_model(name)
    def _factory(output_dim: int, dtype=torch.float32, bn_impl: str = "xla",
                 bn_axis: Optional[str] = None, **_):
        module = CifarResNet(9, output_dim, dtype=dtype, widths=widths, bn_impl=bn_impl,
                             use_norm=use_norm, bn_axis=bn_axis)
        module.packed_twin = False
        return ModelBundle(name=name, module=module, input_shape=(32, 32, 3))
    return _factory


_register_variant("resnet56_w64", (64, 64, 64))
_register_variant("resnet56_w128", (128, 128, 128))
_register_variant("resnet56_nonorm", use_norm=False)

