"""The Group-Knowledge-Transfer split ResNet pair (counterpart of
``fedml_tpu/models/gkt.py``): a small client edge net that returns its
auxiliary logits AND its feature map, and a server net that runs
ResNet-56's 32- and 64-wide stages on that feature map.

Both halves are built from the flagship's ``BasicBlock`` and take
``bn_impl`` as the CIFAR ResNets do: ``"xla"`` (the default, flax's
``BatchNorm_*`` names) is the plain BatchNorm, ``"pallas"`` the
hand-written kernels K1/K2 (``ops/batchnorm.py``). Dtypes follow the JAX
modules: the convolutions and the feature map are in the model dtype, the
mean pool and the Dense head in f32. Submodules carry the flax paths
(``Conv_0``, ``BatchNorm_0``, ``BasicBlock_i``, ``Dense_0``), so
``models/convert.py`` maps the weights.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.initializers import reset_submodules
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.resnet import BasicBlock, Conv, _norm


def _pool_head(head: Dense, x: torch.Tensor) -> torch.Tensor:
    """Mean pool taken in f32 and rounded to the compute dtype, as
    ``jnp.mean`` does, then the f32 head."""
    return head(x.to(torch.float32).mean((1, 2)).to(x.dtype).to(torch.float32))


class GKTClientNet(nn.Module):
    """Edge net: stem + ``blocks`` 16-filter BasicBlocks; returns
    ``(aux_logits [B, out] f32, feature_map [B, H, W, 16])``."""

    def __init__(self, blocks: int = 3, output_dim: int = 10,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla", in_features: int = 3):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(in_features, 16, 3)
        bn, stem_norm = _norm(16, bn_impl, fuse_relu=True)
        self.add_module(f"{bn}_0", stem_norm)
        self._stem_norm = f"{bn}_0"
        self._blocks = [f"BasicBlock_{i}" for i in range(blocks)]
        for name in self._blocks:
            self.add_module(name, BasicBlock(16, 16, 1, bn_impl))
        self.Dense_0 = Dense(16, output_dim, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = getattr(self, self._stem_norm)(self.Conv_0(x.to(self.dtype)))
        for name in self._blocks:
            x = getattr(self, name)(x)
        return _pool_head(self.Dense_0, x), x


class GKTServerNet(nn.Module):
    """Server net: the client feature map [B, H, W, 16] through the 32- and
    64-filter stages (each stage's first block at stride 2) and an f32
    head."""

    def __init__(self, blocks_per_stage: int = 9, output_dim: int = 10,
                 dtype: torch.dtype = torch.float32, bn_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self._blocks, cin = [], 16
        for filters in (32, 64):
            for block in range(blocks_per_stage):
                name = f"BasicBlock_{len(self._blocks)}"
                self.add_module(name, BasicBlock(cin, filters, 2 if block == 0 else 1, bn_impl))
                self._blocks.append(name)
                cin = filters
        self.Dense_0 = Dense(64, output_dim, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        x = f.to(self.dtype)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return _pool_head(self.Dense_0, x)


class GKTHalfBundle(ModelBundle):
    """One half of the split pair as a :class:`ModelBundle` (the client half's
    forward returns a ``(logits, features)`` tuple)."""


@dataclass
class GKTPair:
    client: GKTHalfBundle
    server: GKTHalfBundle
    feature_shape: tuple          # one example's feature-map shape


def gkt_blocks_from_names(model_client: str, model_server: str) -> tuple:
    """``--model_client``/``--model_server`` (``resnet8`` /
    ``resnet56_server``) -> ``(client_blocks, server_blocks_per_stage)``: the
    client half is a one-stage CIFAR ResNet of depth 2n + 2, the server half
    a three-stage one of depth 6n + 2."""
    def depth(name: str) -> int:
        m = re.search(r"(\d+)", name)
        if not m:
            raise ValueError(f"cannot parse a ResNet depth out of {name!r}")
        return int(m.group(1))

    return max((depth(model_client) - 2) // 2, 1), max((depth(model_server) - 2) // 6, 1)


def create_gkt_pair(output_dim: int = 10, input_shape: tuple = (32, 32, 3),
                    client_blocks: int = 3, server_blocks_per_stage: int = 9,
                    dtype: torch.dtype = torch.float32, bn_impl: str = "xla") -> GKTPair:
    """Defaults: the reference pair resnet8 (client) + resnet56_server."""
    feature_shape = tuple(input_shape[:-1]) + (16,)
    return GKTPair(
        client=GKTHalfBundle("gkt_client", GKTClientNet(client_blocks, output_dim, dtype,
                                                        bn_impl, int(input_shape[-1])),
                             tuple(input_shape)),
        server=GKTHalfBundle("gkt_server",
                             GKTServerNet(server_blocks_per_stage, output_dim, dtype, bn_impl),
                             feature_shape),
        feature_shape=feature_shape)
