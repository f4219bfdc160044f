"""flax's basic layers with their defaults: ``Dense``, ``Conv`` (stride 1,
NHWC), ``Embed`` and ``LayerNorm``. Parameters keep flax's leaf names (``weight`` for a Dense
kernel, transposed; ``embedding``; ``scale``, ``bias``), so weight
conversion is a path map (``models/convert.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.initializers import embed_normal_, lecun_normal_


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


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME", kernel_dilation=r)``
    at stride 1 on NHWC input: ``weight`` OIHW, an optional zero-initialised
    ``bias``. A SAME conv of odd size k at dilation r pads ``r * (k - 1) / 2``
    on each side. Computes in ``dtype``, or by default in the promoted type
    of input and weight."""

    def __init__(self, in_features: int, features: int, kernel_size: int, dilation: int = 1,
                 use_bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
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
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     padding=self.dilation * (self.weight.shape[-1] // 2),
                     dilation=self.dilation)
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
