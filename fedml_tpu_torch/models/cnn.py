"""The FedAvg paper's CNN for MNIST/FEMNIST (counterpart of
``fedml_tpu/models/cnn.py``; reference fedml_api/model/cv/cnn.py:5-70).

``cnn`` (``CNNOriginalFedAvg``): 2 x [5x5 SAME conv with bias -> ReLU ->
2x2 max pool] -> Dense(512) -> ReLU -> Dense(out), McMahan et al. 2016,
table 2. It takes flat 784-vectors (read as 28x28x1) or NHWC images; the
conv output is flattened in NHWC order, as flax flattens it, so weight
conversion from the flax tree is ``models/convert.py``'s path map
(``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``). The product runs in the
promoted type of input and weights (f32 for bf16 inputs), as flax's
``promote_dtype`` does.

``n_lanes=L > 0`` is the lane-stacked twin the packed schedule trains
(``parallel/packed.py``; the JAX package's ``conv_impl="packed"`` body):
the lanes folded into the channel axis, each conv L lanes' convs in one
call (weight ``[L*Co, Ci, 5, 5]``, bias ``[L*Co]``) lowered as
``packed_impl`` says (``ops/packed_conv.py``: ``"off"`` and ``"grouped"``
one ``groups=L`` conv, ``"blockdiag"`` one block-diagonal GEMM), the
pooling per channel, each lane's features flattened in NHWC order and the
Dense layers lane-batched (``Dense(n_lanes=L)``). It takes ``[L, N, ...]``
and gives ``[L, N, out]``; its state dict folds each leaf as
``ops/packed_conv.stack_variables`` folds it.

``cnn_dropout`` (CNN_DropOut) needs dropout, which the port does not have
yet: it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import lecun_normal_
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.ops.packed_conv import conv_blockdiag


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME")`` at stride 1 on
    NCHW input (an odd k pads (k - 1) / 2 each side): ``weight`` OIHW,
    ``bias``; ``n_lanes=L > 0``: L convs on the folded channels, one
    ``groups=L`` conv, or with ``packed_impl="blockdiag"`` one
    block-diagonal GEMM on the NHWC view."""

    def __init__(self, in_features: int, features: int, kernel_size: int, n_lanes: int = 0,
                 packed_impl: str = "off"):
        super().__init__()
        if packed_impl not in ("off", "grouped", "blockdiag"):
            raise ValueError(f"packed_impl must be off|grouped|blockdiag, got {packed_impl!r}")
        self.groups = max(n_lanes, 1)
        self.blockdiag = packed_impl == "blockdiag"
        self.weight = nn.Parameter(torch.empty(self.groups * features, in_features,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(self.groups * features))

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        if self.blockdiag:
            y = conv_blockdiag(x.to(dt).permute(0, 2, 3, 1), self.weight.to(dt), self.groups)
            return (y + self.bias.to(dt)).permute(0, 3, 1, 2)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.weight.shape[-1] // 2, groups=self.groups)


def _image_shape(input_shape: Optional[Sequence[int]]) -> tuple:
    if input_shape is None or len(input_shape) == 1:
        return (28, 28, 1)
    return tuple(int(s) for s in input_shape)


class CNNOriginalFedAvg(nn.Module):
    #: the lane-stacked twin takes the joint lowerings (ModelBundle.packed_twin)
    packed_twin = True

    def __init__(self, output_dim: int = 62, input_shape: Optional[Sequence[int]] = None,
                 n_lanes: int = 0, packed_impl: str = "off"):
        super().__init__()
        h, w, c = _image_shape(input_shape)
        self._config = dict(output_dim=output_dim, input_shape=(h, w, c))
        self.n_lanes = n_lanes
        self.Conv_0 = _Conv(c, 32, 5, n_lanes, packed_impl)
        self.Conv_1 = _Conv(32, 64, 5, n_lanes, packed_impl)
        self.Dense_0 = Dense((h // 4) * (w // 4) * 64, 512, n_lanes=n_lanes)
        self.Dense_1 = Dense(512, output_dim, n_lanes=n_lanes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            m.reset_parameters(generator)

    def lane_stacked(self, n_lanes: int, packed_impl: str = "off") -> "CNNOriginalFedAvg":
        """A new lane-stacked twin for ``n_lanes`` lanes whose convs take the
        lowering ``packed_impl``, on this model's device (its weights are
        the caller's to set)."""
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        return CNNOriginalFedAvg(**self._config, n_lanes=n_lanes,
                                 packed_impl=packed_impl).to(self.Conv_0.weight.device)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW [N, L*C, H, W] -> the pooled conv stack, NCHW."""
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        return F.max_pool2d(F.relu(self.Conv_1(x)), 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 784] or [N, H, W, C] -> [N, out]; lane-stacked, [L, N, ...]
        -> [L, N, out]."""
        shape = self._config["input_shape"]
        if not self.n_lanes:
            x = x.reshape(x.shape[0], *shape)
            y = self._features(x.permute(0, 3, 1, 2))
            y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)    # NHWC flatten
            return self.Dense_1(F.relu(self.Dense_0(y)))
        L, n = x.shape[:2]
        x = x.reshape(L, n, *shape).permute(1, 2, 3, 0, 4).reshape(n, *shape[:2], -1)
        y = self._features(x.permute(0, 3, 1, 2))                # [N, L*64, h, w]
        y = y.reshape(n, L, -1, *y.shape[2:]).permute(0, 1, 3, 4, 2).reshape(n, -1)
        h = F.relu(self.Dense_0(y))                              # [L, N, 512]
        return self.Dense_1(h.transpose(0, 1).reshape(n, -1))


@register_model("cnn")
def _cnn(output_dim: int, input_shape: Optional[Sequence[int]] = None, **_):
    return ModelBundle(name="cnn", module=CNNOriginalFedAvg(output_dim, input_shape),
                       input_shape=(28, 28, 1))


@register_model("cnn_dropout")
def _cnn_dropout(output_dim: int, **_):
    raise NotImplementedError("cnn_dropout needs dropout, which is not ported yet "
                              "(ROADMAP §1 item 8)")

