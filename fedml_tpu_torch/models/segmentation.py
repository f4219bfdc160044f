"""Semantic-segmentation models for FedSeg (counterpart of
``fedml_tpu/models/segmentation.py``), NHWC throughout:

- ``deeplab_lite``: a stride-8 residual encoder (the flagship's
  ``BasicBlock``), ``ASPPLite`` (parallel atrous branches and image-level
  pooling fused by a 1x1 conv), a 1x1 classifier and a bilinear upsample;
- ``unet``: an encoder/decoder with skip concatenations.

Both register with ``task="segmentation"`` and take ``bn_impl`` as the
CIFAR ResNets do (``"pallas"``: every BatchNorm through K1/K2). Dtypes are
the JAX modules', layer by layer: ``DeepLabLite`` computes its stem and
encoder in its ``dtype``; ``ASPPLite`` and ``UNet`` carry no dtype, so each
conv runs in the promoted type of its input and its f32 weights (f32 for a
bf16 input), as flax's ``promote_dtype`` does; the classifier is f32.

``jax.image.resize(..., "bilinear")`` upsamples as ``F.interpolate(mode=
"bilinear", align_corners=False)`` does (JAX antialiases only when it
downsamples, which neither model does); the port computes it as two
products with fixed weight matrices, whose backward is deterministic on the
card. ``nn.max_pool`` with window and stride 2 is ``F.max_pool2d(2, 2)``.
Submodules carry the flax paths, so ``models/convert.py`` maps the weights.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import reset_submodules
from fedml_tpu_torch.models.layers import Conv
from fedml_tpu_torch.models.resnet import BasicBlock, _norm


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype
                   ) -> torch.Tensor:
    """``[n_out, n_in]`` weights of a 1-D linear resize with half-pixel
    centres: output i samples ``(i + 0.5) * n_in / n_out - 0.5``, clamped to
    the input, from its two neighbours."""
    src = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = src - i0
    a = np.zeros((n_out, n_in))
    np.add.at(a, (np.arange(n_out), i0), 1.0 - frac)
    np.add.at(a, (np.arange(n_out), i1), frac)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC bilinear resize to (h, w) with half-pixel centres (what
    ``F.interpolate(mode="bilinear", align_corners=False)`` computes), as two
    products with fixed weight matrices: their backward is deterministic on
    the card, where ``F.interpolate``'s accumulates with atomics. The
    matrices are made once per shape, device and dtype, before any capture
    (a captured step's warm-up makes them)."""
    ah = _interp_matrix(x.shape[1], h, x.device, x.dtype)
    aw = _interp_matrix(x.shape[2], w, x.device, x.dtype)
    return torch.einsum("oh,nhwc,pw->nopc", ah, x, aw).contiguous()


class ASPPLite(nn.Module):
    """Parallel atrous branches (a 1x1 conv, then a 3x3 conv at each rate
    after the first) and image-level pooling, fused by a 1x1 conv and a
    BatchNorm + ReLU."""

    def __init__(self, in_features: int, channels: int, rates: Sequence[int] = (1, 3, 6),
                 bn_impl: str = "xla"):
        super().__init__()
        self.channels = channels
        convs = [Conv(in_features, channels, 1)]
        convs += [Conv(in_features, channels, 3, dilation=r) for r in rates[1:]]
        convs += [Conv(in_features, channels, 1),                          # the pooled branch
                  Conv(channels * (len(rates) + 1), channels, 1)]          # the fuse
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
        self._branches = [f"Conv_{i}" for i in range(len(rates))]
        self._pooled, self._fuse = f"Conv_{len(rates)}", f"Conv_{len(rates) + 1}"
        bn, norm = _norm(channels, bn_impl, fuse_relu=True)
        self.add_module(f"{bn}_0", norm)
        self._norm = f"{bn}_0"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, name)(x) for name in self._branches]
        # jnp.mean of the input in its own dtype (taken in f32, rounded)
        pooled = x.to(torch.float32).mean((1, 2), keepdim=True).to(x.dtype)
        pooled = getattr(self, self._pooled)(pooled).expand(*x.shape[:3], self.channels)
        y = getattr(self, self._fuse)(torch.cat(branches + [pooled], dim=-1))
        return getattr(self, self._norm)(y)


class DeepLabLite(nn.Module):
    """Stride-8 encoder (residual blocks at width, 2x and 4x width) + ASPP +
    an f32 1x1 classifier, bilinearly upsampled to the input's size."""

    def __init__(self, output_dim: int, width: int = 32, blocks_per_stage: int = 2,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla", in_features: int = 3):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(in_features, width, 3, dtype=dtype)
        bn, stem_norm = _norm(width, bn_impl, fuse_relu=True)
        self.add_module(f"{bn}_0", stem_norm)
        self._stem_norm = f"{bn}_0"
        self._blocks, cin = [], width
        for stage, mult in enumerate((1, 2, 4)):
            for block in range(blocks_per_stage):
                name = f"BasicBlock_{len(self._blocks)}"
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, BasicBlock(cin, width * mult, strides, bn_impl))
                self._blocks.append(name)
                cin = width * mult
        self.ASPPLite_0 = ASPPLite(cin, width * 4, bn_impl=bn_impl)
        self.Conv_1 = Conv(width * 4, output_dim, 1, use_bias=True, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = getattr(self, self._stem_norm)(self.Conv_0(x))
        for name in self._blocks:
            x = getattr(self, name)(x)
        logits = self.Conv_1(self.ASPPLite_0(x).to(torch.float32))
        return _resize_bilinear(logits, h, w)


class UNet(nn.Module):
    """``depth`` encoder blocks (two 3x3 conv + BN + ReLU each, then a 2x2
    max pool, doubling the width), a bottleneck block, and ``depth``
    decoder blocks, each on the bilinearly upsampled map concatenated with
    its skip; a 1x1 classifier with bias."""

    def __init__(self, output_dim: int, width: int = 16, depth: int = 3, in_features: int = 3,
                 bn_impl: str = "xla"):
        super().__init__()
        self.depth = depth
        self._bn = "PallasBatchNorm" if bn_impl == "pallas" else "BatchNorm"
        n = 0

        def block(cin: int, c: int) -> None:
            nonlocal n
            for _ in range(2):
                self.add_module(f"Conv_{n}", Conv(cin, c, 3))
                self.add_module(f"{self._bn}_{n}", _norm(c, bn_impl, fuse_relu=True)[1])
                cin, n = c, n + 1

        c, cin = width, in_features
        for _ in range(depth):
            block(cin, c)
            cin, c = c, c * 2
        block(cin, c)                       # the bottleneck
        for _ in range(depth):
            block(c + c // 2, c // 2)       # upsampled map + its skip
            c //= 2
        self._convs = n
        self.add_module(f"Conv_{n}", Conv(c, output_dim, 1, use_bias=True))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = iter(range(self._convs))

        def block(y):
            for _ in range(2):
                i = next(layer)
                y = getattr(self, f"{self._bn}_{i}")(getattr(self, f"Conv_{i}")(y))
            return y

        skips = []
        for _ in range(self.depth):
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = block(x)
        for skip in reversed(skips):
            x = block(torch.cat([_resize_bilinear(x, skip.shape[1], skip.shape[2]), skip], -1))
        return getattr(self, f"Conv_{self._convs}")(x)


def _channels(input_shape) -> int:
    return int(input_shape[-1]) if input_shape else 3


@register_model("deeplab_lite")
def _deeplab(output_dim: int, input_shape=None, dtype=torch.float32, bn_impl: str = "xla",
             **_):
    module = DeepLabLite(output_dim, dtype=dtype, bn_impl=bn_impl,
                         in_features=_channels(input_shape))
    return ModelBundle("deeplab_lite", module, (32, 32, 3), task="segmentation")


@register_model("unet")
def _unet(output_dim: int, input_shape=None, bn_impl: str = "xla", **_):
    module = UNet(output_dim, bn_impl=bn_impl, in_features=_channels(input_shape))
    return ModelBundle("unet", module, (32, 32, 3), task="segmentation")
