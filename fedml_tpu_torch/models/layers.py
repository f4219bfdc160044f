"""flax's basic layers with their defaults: ``Dense``, ``Conv`` (NHWC,
SAME or VALID, strided, grouped), ``Embed``, ``LayerNorm`` and
``GroupNorm``. Parameters keep flax's leaf names (``weight`` for a Dense
kernel, transposed; ``embedding``; ``scale``, ``bias``), so weight
conversion is a path map (``models/convert.py``).

flax ``padding="SAME"`` pads ``max((out - 1) * s + k_eff - in, 0)`` in
all, the larger half at the end (:func:`same_pads`): at stride 2 on an
even size that is asymmetric ((0, 1) for a 3x3 on 32 x 32, (1, 2) for a
5x5), which torch's symmetric ``padding=`` does not give, so
:func:`pad_same_nchw` pads explicitly there."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.initializers import embed_normal_, lecun_normal_


def add_flax(parent: nn.Module, kind: str, module: nn.Module) -> nn.Module:
    """Register ``module`` under ``parent`` by flax's automatic name, the
    next ``{kind}_{i}`` (flax counts each class's submodules in creation
    order), and return it."""
    i = sum(1 for name in parent._modules if name.rsplit("_", 1)[0] == kind)
    parent.add_module(f"{kind}_{i}", module)
    return module


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` [out, in] (lecun normal), zero bias.
    Input, weight and bias are cast to ``dtype`` (by default their promoted
    type) and the product is computed in it, as flax's ``promote_dtype``
    does.

    ``n_lanes=L > 0`` is L independent Dense layers, one per packed lane
    (``ops/packed_conv.py``): ``weight`` [L*out, in], ``bias`` [L*out];
    the input [N, L*in] (lane l's features at ``l*in + i``) gives
    [L, N, out]."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None,
                 n_lanes: int = 0):
        super().__init__()
        lanes = max(n_lanes, 1)
        self.weight = nn.Parameter(torch.empty(lanes * features, in_features))
        self.bias = nn.Parameter(torch.zeros(lanes * features))
        self.dtype = dtype
        self.n_lanes = n_lanes

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if not self.n_lanes:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        L, (out, d) = self.n_lanes, self.weight.shape
        xs = x.to(dt).reshape(x.shape[0], L, d).transpose(0, 1)       # [L, N, in]
        w = self.weight.to(dt).view(L, out // L, d).transpose(1, 2)   # [L, in, out]
        return torch.baddbmm(self.bias.to(dt).view(L, 1, out // L), xs, w)


def same_pads(size: int, k_eff: int, stride: int) -> tuple[int, int]:
    """flax's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def pad_same_nchw(x: torch.Tensor, k_eff: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded as flax SAME pads it, and the symmetric
    padding left for the op itself: ``(x, p)`` with ``p`` the op's own
    ``padding=`` when both axes pad symmetrically, else ``x`` padded
    explicitly and ``p = 0``."""
    ph = same_pads(x.shape[2], k_eff, stride)
    pw = same_pads(x.shape[3], k_eff, stride)
    if ph[0] == ph[1] == pw[0] == pw[1]:
        return x, ph[0]
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=s, padding=..., kernel_dilation=r,
    feature_group_count=g)`` on NHWC input: ``weight`` OIHW
    ``[features, in / g, k, k]`` (lecun normal over ``in / g * k * k``; a
    depthwise kernel is ``[C, 1, k, k]``), an optional zero-initialised
    ``bias``. ``padding`` is ``"SAME"`` (flax's, :func:`same_pads`) or
    ``"VALID"``. Computes in ``dtype``, or by default in the promoted type
    of input and weight."""

    def __init__(self, in_features: int, features: int, kernel_size: int, dilation: int = 1,
                 use_bias: bool = False, dtype: Optional[torch.dtype] = None, stride: int = 1,
                 groups: int = 1, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.dilation, self.stride, self.groups, self.padding = dilation, stride, groups, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        xp, pad = x.to(dt).permute(0, 3, 1, 2), 0
        if self.padding == "SAME":
            xp, pad = pad_same_nchw(xp, self.dilation * (self.weight.shape[-1] - 1) + 1,
                                    self.stride)
        y = F.conv2d(xp, self.weight.to(dt), bias, self.stride, pad, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` [num, features]
    (``embed_normal_``); the table is cast to ``dtype`` before the
    lookup."""

    def __init__(self, num_embeddings: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        embed_normal_(self.embedding, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embedding if self.dtype is None else self.embedding.to(self.dtype)
        return F.embedding(ids.long(), table)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, f32
    statistics with the fast variance ``max(E[x^2] - E[x]^2, 0)``,
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, cast to
    ``dtype`` (by default the input's promoted with the parameters')."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.eps = eps

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp_min((x32 * x32).mean(-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - mean) * mul + self.bias
        return y.to(self.dtype or torch.promote_types(x.dtype, self.scale.dtype))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over NHWC input: the channels of
    the last axis in ``num_groups`` contiguous groups, statistics over
    (H, W, the group's channels) in f32 with the fast variance
    ``max(E[x^2] - E[x]^2, 0)`` and flax's epsilon 1e-6 (torch's default is
    1e-5), ``y = (x - mean) * rsqrt(var + eps)``, then ``scale`` and
    ``bias`` per channel, cast to ``dtype`` (by default the input's
    promoted with the parameters')."""

    def __init__(self, features: int, num_groups: int = 32, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-6):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{features} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.eps = eps

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        g = (self.num_groups, c // self.num_groups)
        xg = x.to(torch.float32).reshape(n, -1, *g)
        mean = xg.mean((1, 3), keepdim=True)
        var = torch.clamp_min((xg * xg).mean((1, 3), keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.view(g)
        y = ((xg - mean) * mul + self.bias.view(g)).reshape(x.shape)
        return y.to(self.dtype or torch.promote_types(x.dtype, self.scale.dtype))
