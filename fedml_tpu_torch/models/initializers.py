"""flax's weight initialisers, drawn from a ``torch.Generator``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax ``lecun_normal``: truncated normal on [-2, 2] std, scaled so
    the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)


def embed_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax ``nn.Embed``'s default on a [num, features] table,
    ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``: a plain
    (untruncated) normal of variance 1 / features."""
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(1.0 / w.shape[1]), generator=generator)
