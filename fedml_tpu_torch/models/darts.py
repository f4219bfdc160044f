"""DARTS search space for FedNAS (counterpart of ``fedml_tpu/models/darts.py``),
NHWC throughout: the 8 primitives, the mixed op, the search cell and
network, genotype derivation, and the discrete network built from a
genotype.

As in the JAX package the architecture weights (alphas) are an input of
``DartsSearchNetwork.forward``, not parameters: ``{"normal": [k, 8],
"reduce": [k, 8]}`` tensors, so the alpha gradient and the weight gradient
are two ``torch.autograd.grad`` calls over the same forward.

The search net's BatchNorms are affine-free (flax ``use_scale=False,
use_bias=False``: ``PallasBatchNorm(affine=False)``, gamma = 1 and beta = 0
outside the parameter tree); the stem's is affine. ``bn_impl="pallas"``
runs every one through K1/K2 (``ops/batchnorm.py``) with ``relu=False``;
``"xla"`` is the plain BN.

flax ``padding="SAME"`` pads ``max((out - 1) * s + d * (k - 1) + 1 - in, 0)``
in all, the larger half at the end: at stride 2 on an even size that is
asymmetric ((0, 1) for a 3x3 on 32 x 32, (1, 2) for a 5x5 or a dilated
3x3, (3, 4) for a dilated 5x5), which torch's symmetric ``padding=`` does
not give, so :class:`SameConv` and the pools pad explicitly there.
``max_pool`` pads with -inf; ``_avg_pool_3x3`` divides by the count of
real elements under each window. Submodules carry the flax paths
(``SearchCell_3.MixedOp_5.SepConv_1.Conv_2``), so ``models/convert.py``
maps the weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.initializers import lecun_normal_, reset_submodules
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.norm import PallasBatchNorm

PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)


class Genotype(NamedTuple):
    normal: tuple          # ((op_name, input_node), ...)
    normal_concat: tuple
    reduce: tuple
    reduce_concat: tuple


def num_edges(steps: int) -> int:
    return sum(2 + i for i in range(steps))


# -- SAME padding -----------------------------------------------------------------------

def same_pads(size: int, k_eff: int, stride: int) -> tuple[int, int]:
    """flax's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k_eff: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded as flax SAME pads it, and the symmetric
    padding left for the op itself: ``(x, p)`` with ``p`` the op's own
    ``padding=`` when both axes pad symmetrically, else ``x`` padded
    explicitly and ``p = 0``."""
    ph = same_pads(x.shape[2], k_eff, stride)
    pw = same_pads(x.shape[3], k_eff, stride)
    if ph[0] == ph[1] == pw[0] == pw[1]:
        return x, ph[0]
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), 0


def _transpose_padding(size: int, out: int, k_eff: int, stride: int) -> int:
    """The ``output_padding`` that makes the transposed conv of an ``out``
    map come back to ``size`` (the padded input's)."""
    return size - ((out - 1) * stride + k_eff)


class _GroupedConv(torch.autograd.Function):
    """``F.conv2d(x, w, stride=s, dilation=d, groups=g)`` on an already
    padded ``x`` (NCHW), with a backward made of ops whose own backward is
    a plain conv: the input gradient is ``conv_transpose2d(gO, w)`` and the
    weight gradient :class:`_GroupedWGrad`. PyTorch's double backward of a
    grouped conv loops over the groups (a conv per channel of a depthwise
    conv), which the unrolled architect's second-order pass would run for
    every depthwise conv; this one runs two convs."""

    @staticmethod
    def forward(ctx, x, w, stride: int, dilation: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, dilation, groups)
        return F.conv2d(x, w, None, stride, 0, dilation, groups)

    @staticmethod
    def backward(ctx, g_out):
        x, w = ctx.saved_tensors
        s, d, groups = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _conv_input_grad(g_out, w, x.shape, s, d, groups)
        if ctx.needs_input_grad[1]:
            gw = _GroupedWGrad.apply(x, g_out, w, s, d, groups)
        return gx, gw, None, None, None


def _conv_input_grad(g_out, w, x_shape, stride: int, dilation: int, groups: int):
    k_eff = dilation * (w.shape[-1] - 1) + 1
    pad = tuple(_transpose_padding(x_shape[i], g_out.shape[i], k_eff, stride) for i in (2, 3))
    return F.conv_transpose2d(g_out, w, None, stride, 0, pad, groups, dilation)


class _GroupedWGrad(torch.autograd.Function):
    """The weight gradient of :class:`_GroupedConv` as a function of
    ``(x, g_out)``; its vjp is a transposed conv (by x) and a conv (by
    g_out), each with the cotangent as the weight."""

    @staticmethod
    def forward(ctx, x, g_out, w, stride: int, dilation: int, groups: int):
        ctx.save_for_backward(x, g_out)
        ctx.conf = (stride, dilation, groups)
        return torch.ops.aten.convolution_backward(
            g_out, x, w, None, [stride] * 2, [0, 0], [dilation] * 2, False, [0, 0], groups,
            [False, True, False])[1]

    @staticmethod
    def backward(ctx, v):
        x, g_out = ctx.saved_tensors
        s, d, groups = ctx.conf
        gx = _conv_input_grad(g_out, v, x.shape, s, d, groups) if ctx.needs_input_grad[0] else None
        gg = F.conv2d(x, v, None, s, 0, d, groups) if ctx.needs_input_grad[1] else None
        return gx, gg, None, None, None, None


class SameConv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=s, padding="SAME",
    kernel_dilation=d, feature_group_count=g, use_bias=False)`` on NHWC
    input: ``weight`` OIHW [features, in / g, k, k], lecun normal. A
    grouped (depthwise) conv runs as :class:`_GroupedConv`, whose second
    derivative is two convs."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, kernel, kernel))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k_eff = self.dilation * (self.weight.shape[-1] - 1) + 1
        xp, pad = _pad_nchw(x.permute(0, 3, 1, 2), k_eff, self.stride)
        if self.groups > 1:
            if pad:
                xp = F.pad(xp, (pad,) * 4)
            y = _GroupedConv.apply(xp, self.weight, self.stride, self.dilation, self.groups)
        else:
            y = F.conv2d(xp, self.weight, None, self.stride, pad, self.dilation)
        return y.permute(0, 2, 3, 1).contiguous()


def _bn(module: nn.Module, index: int, features: int, bn_impl: str,
        affine: bool = False) -> str:
    """Register the ``index``-th train-mode BatchNorm of ``module`` under
    its flax name (``BatchNorm_i``, or ``PallasBatchNorm_i`` for the
    kernel) and return the name. The DARTS BNs are affine-free."""
    if bn_impl not in ("xla", "pallas"):
        raise ValueError(f"bn_impl must be 'xla' or 'pallas', got {bn_impl!r}")
    name = f"{'PallasBatchNorm' if bn_impl == 'pallas' else 'BatchNorm'}_{index}"
    module.add_module(name, PallasBatchNorm(features, momentum=0.9, affine=affine,
                                            use_kernel=bn_impl == "pallas"))
    return name


def _max_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    xp, pad = _pad_nchw(x.permute(0, 3, 1, 2), 3, stride, float("-inf"))
    return F.max_pool2d(xp, 3, stride, pad).permute(0, 2, 3, 1)


def _avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """count_include_pad=False semantics: the window's sum over the count
    of its real elements."""
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype, device=x.device)
    xp, pad = _pad_nchw(x.permute(0, 3, 1, 2), 3, stride)
    op, _ = _pad_nchw(ones, 3, stride)
    s = F.avg_pool2d(xp, 3, stride, pad)
    c = F.avg_pool2d(op, 3, stride, pad)
    return (s / torch.clamp(c, min=1e-12)).permute(0, 2, 3, 1)


def _zero(x: torch.Tensor, stride: int) -> torch.Tensor:
    if stride == 1:
        return x * 0.0
    return x[:, ::stride, ::stride, :] * 0.0


# -- the primitives ---------------------------------------------------------------------

class ReLUConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int = 1, stride: int = 1,
                 bn_impl: str = "xla"):
        super().__init__()
        self.Conv_0 = SameConv(c_in, c_out, kernel, stride)
        self._bn = _bn(self, 0, c_out, bn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self._bn)(self.Conv_0(F.relu(x)))


class DilConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, dilation: int,
                 bn_impl: str = "xla"):
        super().__init__()
        self.Conv_0 = SameConv(c_in, c_in, kernel, stride, dilation, groups=c_in)
        self.Conv_1 = SameConv(c_in, c_out, 1)
        self._bn = _bn(self, 0, c_out, bn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self._bn)(self.Conv_1(self.Conv_0(F.relu(x))))


class SepConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bn_impl: str = "xla"):
        super().__init__()
        self.Conv_0 = SameConv(c_in, c_in, kernel, stride, groups=c_in)
        self.Conv_1 = SameConv(c_in, c_in, 1)
        self.Conv_2 = SameConv(c_in, c_in, kernel, 1, groups=c_in)
        self.Conv_3 = SameConv(c_in, c_out, 1)
        self._bns = (_bn(self, 0, c_in, bn_impl), _bn(self, 1, c_out, bn_impl))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, bn in enumerate(self._bns):
            dw, pw = getattr(self, f"Conv_{2 * i}"), getattr(self, f"Conv_{2 * i + 1}")
            x = getattr(self, bn)(pw(dw(F.relu(x))))
        return x


class FactorizedReduce(nn.Module):
    def __init__(self, c_in: int, c_out: int, bn_impl: str = "xla"):
        super().__init__()
        self.Conv_0 = SameConv(c_in, c_out // 2, 1, 2)
        self.Conv_1 = SameConv(c_in, c_out // 2, 1, 2)
        self._bn = _bn(self, 0, 2 * (c_out // 2), bn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        shifted = F.pad(x[:, 1:, 1:, :], (0, 0, 0, 1, 0, 1))
        return getattr(self, self._bn)(torch.cat([self.Conv_0(x), self.Conv_1(shifted)], -1))


class MixedOp(nn.Module):
    """All 8 primitives, contracted with the edge's softmax weights; the
    pools carry a trailing affine-free BN (``BatchNorm_0`` max,
    ``BatchNorm_1`` avg)."""

    def __init__(self, channels: int, stride: int, bn_impl: str = "xla"):
        super().__init__()
        c, self.stride = channels, stride
        self._pool_bns = (_bn(self, 0, c, bn_impl), _bn(self, 1, c, bn_impl))
        if stride != 1:
            self.FactorizedReduce_0 = FactorizedReduce(c, c, bn_impl)
        self.SepConv_0 = SepConv(c, c, 3, stride, bn_impl)
        self.SepConv_1 = SepConv(c, c, 5, stride, bn_impl)
        self.DilConv_0 = DilConv(c, c, 3, stride, 2, bn_impl)
        self.DilConv_1 = DilConv(c, c, 5, stride, 2, bn_impl)

    def forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        s = self.stride
        outs = [
            _zero(x, s),
            getattr(self, self._pool_bns[0])(_max_pool_3x3(x, s)),
            getattr(self, self._pool_bns[1])(_avg_pool_3x3(x, s)),
            x if s == 1 else self.FactorizedReduce_0(x),
            self.SepConv_0(x), self.SepConv_1(x), self.DilConv_0(x), self.DilConv_1(x),
        ]
        return torch.einsum("o,obhwc->bhwc", weights, torch.stack(outs, 0))


def _preprocess(cell: nn.Module, c_pp: int, c_p: int, c: int, reduction_prev: bool,
                bn_impl: str) -> tuple[str, str]:
    """The cell's input ops, under flax's names: s0 through
    ``FactorizedReduce_0`` (after a reduction) or ``ReLUConvBN_0``, s1
    through the next ``ReLUConvBN``."""
    if reduction_prev:
        cell.FactorizedReduce_0 = FactorizedReduce(c_pp, c, bn_impl)
        cell.ReLUConvBN_0 = ReLUConvBN(c_p, c, bn_impl=bn_impl)
        return "FactorizedReduce_0", "ReLUConvBN_0"
    cell.ReLUConvBN_0 = ReLUConvBN(c_pp, c, bn_impl=bn_impl)
    cell.ReLUConvBN_1 = ReLUConvBN(c_p, c, bn_impl=bn_impl)
    return "ReLUConvBN_0", "ReLUConvBN_1"


def _cells_widths(channels: int, layers: int, stem_width: int, cell_width):
    """(layer, c_pp, c_p, c, reduction, reduction_prev) of each cell, and
    the last cell's output width; reductions at 1/3 and 2/3 depth double
    the width. ``cell_width(c, reduction)`` is a cell's output width."""
    c_pp = c_p = stem_width
    c, reduction_prev, out = channels, False, []
    for layer in range(layers):
        reduction = layer in (layers // 3, 2 * layers // 3)
        if reduction:
            c *= 2
        out.append((layer, c_pp, c_p, c, reduction, reduction_prev))
        c_pp, c_p, reduction_prev = c_p, cell_width(c, reduction), reduction
    return out, c_p


class SearchCell(nn.Module):
    """DAG cell: ``steps`` nodes, each the sum of mixed-op edges from all
    its predecessors; the output concatenates the last ``multiplier``."""

    def __init__(self, steps: int, multiplier: int, c_pp: int, c_p: int, channels: int,
                 reduction: bool, reduction_prev: bool, bn_impl: str = "xla"):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        self._pre = _preprocess(self, c_pp, c_p, channels, reduction_prev, bn_impl)
        n = 0
        for i in range(steps):
            for j in range(2 + i):
                self.add_module(f"MixedOp_{n}", MixedOp(channels, 2 if reduction and j < 2 else 1,
                                                        bn_impl))
                n += 1

    def forward(self, s0, s1, weights: torch.Tensor) -> torch.Tensor:
        states = [getattr(self, self._pre[0])(s0), getattr(self, self._pre[1])(s1)]
        offset = 0
        for _ in range(self.steps):
            s = sum(getattr(self, f"MixedOp_{offset + j}")(h, weights[offset + j])
                    for j, h in enumerate(states))
            offset += len(states)
            states.append(s)
        return torch.cat(states[-self.multiplier:], dim=-1)


class DartsSearchNetwork(nn.Module):
    """The over-parameterized search net: a 3x3 stem with an affine BN,
    ``layers`` search cells (reductions at 1/3 and 2/3 depth), a global
    average pool and a Dense classifier. ``forward(x, alphas)``."""

    def __init__(self, channels: int = 16, layers: int = 8, steps: int = 4, multiplier: int = 4,
                 stem_multiplier: int = 3, output_dim: int = 10, in_features: int = 3,
                 bn_impl: str = "xla"):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        stem = stem_multiplier * channels
        self.Conv_0 = SameConv(in_features, stem, 3)
        self._stem_bn = _bn(self, 0, stem, bn_impl, affine=True)
        cells, width = _cells_widths(channels, layers, stem, lambda c, _: multiplier * c)
        self._cells = []
        for layer, c_pp, c_p, c, reduction, reduction_prev in cells:
            self.add_module(f"SearchCell_{layer}", SearchCell(steps, multiplier, c_pp, c_p, c,
                                                              reduction, reduction_prev, bn_impl))
            self._cells.append((f"SearchCell_{layer}", reduction))
        self.Dense_0 = Dense(width, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor, alphas: dict) -> torch.Tensor:
        w_normal = torch.softmax(alphas["normal"], dim=-1)
        w_reduce = torch.softmax(alphas["reduce"], dim=-1)
        s0 = s1 = getattr(self, self._stem_bn)(self.Conv_0(x))
        for name, reduction in self._cells:
            s0, s1 = s1, getattr(self, name)(s0, s1, w_reduce if reduction else w_normal)
        return self.Dense_0(s1.mean((1, 2)))


def init_alphas(generator: Optional[torch.Generator] = None, steps: int = 4,
                device=None) -> dict:
    """``1e-3 * randn`` of ``[num_edges(steps), 8]`` each, normal then
    reduce (JAX draws them from a split key: the parity tests convert its
    draw)."""
    k = num_edges(steps)
    return {name: (1e-3 * torch.randn(k, len(PRIMITIVES), generator=generator)).to(device)
            for name in ("normal", "reduce")}


def derive_genotype(alphas: dict, steps: int = 4, multiplier: int = 4) -> Genotype:
    """Discretize: per node keep the 2 strongest input edges (ranked by
    their best non-'none' op weight), each with its best non-'none' op;
    the JAX package's numpy ranking, ties included."""

    def parse(w: np.ndarray):
        gene, offset = [], 0
        for i in range(steps):
            n_in = 2 + i
            W = w[offset:offset + n_in]
            edge_strength = [
                max(W[j][k] for k in range(len(PRIMITIVES)) if PRIMITIVES[k] != "none")
                for j in range(n_in)
            ]
            top2 = sorted(range(n_in), key=lambda j: -edge_strength[j])[:2]
            for j in sorted(top2):
                k_best = max(
                    (k for k in range(len(PRIMITIVES)) if PRIMITIVES[k] != "none"),
                    key=lambda k: W[j][k],
                )
                gene.append((PRIMITIVES[k_best], j))
            offset += n_in
        return gene

    def weights(a) -> np.ndarray:
        return torch.softmax(torch.as_tensor(a).detach().float().cpu(), dim=-1).numpy()

    concat = tuple(range(2 + steps - multiplier, steps + 2))
    return Genotype(tuple(parse(weights(alphas["normal"]))), concat,
                    tuple(parse(weights(alphas["reduce"]))), concat)


# -- the discrete network ---------------------------------------------------------------

class _DiscreteOp(nn.Module):
    def __init__(self, op_name: str, channels: int, stride: int, bn_impl: str = "xla"):
        super().__init__()
        if op_name not in PRIMITIVES:
            raise ValueError(f"unknown op {op_name!r}")
        c, self.op_name, self.stride = channels, op_name, stride
        if op_name == "skip_connect" and stride != 1:
            self.FactorizedReduce_0 = FactorizedReduce(c, c, bn_impl)
        elif op_name.startswith("sep_conv"):
            self.SepConv_0 = SepConv(c, c, int(op_name[-1]), stride, bn_impl)
        elif op_name.startswith("dil_conv"):
            self.DilConv_0 = DilConv(c, c, int(op_name[-1]), stride, 2, bn_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s = self.op_name, self.stride
        if n == "none":
            return _zero(x, s)
        if n == "max_pool_3x3":
            return _max_pool_3x3(x, s)
        if n == "avg_pool_3x3":
            return _avg_pool_3x3(x, s)
        if n == "skip_connect":
            return x if s == 1 else self.FactorizedReduce_0(x)
        return (self.SepConv_0 if n.startswith("sep_conv") else self.DilConv_0)(x)


class DiscreteCell(nn.Module):
    def __init__(self, genotype_edges: tuple, concat: tuple, c_pp: int, c_p: int,
                 channels: int, reduction: bool, reduction_prev: bool, bn_impl: str = "xla"):
        super().__init__()
        self.edges, self.concat = tuple(genotype_edges), tuple(concat)
        self._pre = _preprocess(self, c_pp, c_p, channels, reduction_prev, bn_impl)
        for n, (op_name, j) in enumerate(self.edges):
            self.add_module(f"_DiscreteOp_{n}", _DiscreteOp(
                op_name, channels, 2 if reduction and j < 2 else 1, bn_impl))

    def forward(self, s0, s1) -> torch.Tensor:
        states = [getattr(self, self._pre[0])(s0), getattr(self, self._pre[1])(s1)]
        for i in range(len(self.edges) // 2):
            states.append(sum(getattr(self, f"_DiscreteOp_{n}")(states[self.edges[n][1]])
                              for n in (2 * i, 2 * i + 1)))
        return torch.cat([states[i] for i in self.concat], dim=-1)


class DartsNetwork(nn.Module):
    """The discrete network of a derived genotype (FedNAS' train phase)."""

    def __init__(self, genotype: Genotype, channels: int = 16, layers: int = 8,
                 stem_multiplier: int = 3, output_dim: int = 10, in_features: int = 3,
                 bn_impl: str = "xla"):
        super().__init__()
        g = self.genotype = genotype
        stem = stem_multiplier * channels
        self.Conv_0 = SameConv(in_features, stem, 3)
        self._stem_bn = _bn(self, 0, stem, bn_impl, affine=True)
        widths = {False: len(g.normal_concat), True: len(g.reduce_concat)}
        cells, width = _cells_widths(channels, layers, stem, lambda c, r: widths[r] * c)
        self._cells = []
        for layer, c_pp, c_p, c, reduction, reduction_prev in cells:
            edges, concat = (g.reduce, g.reduce_concat) if reduction else (g.normal,
                                                                         g.normal_concat)
            self.add_module(f"DiscreteCell_{layer}", DiscreteCell(
                edges, concat, c_pp, c_p, c, reduction, reduction_prev, bn_impl))
            self._cells.append(f"DiscreteCell_{layer}")
        self.Dense_0 = Dense(width, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s0 = s1 = getattr(self, self._stem_bn)(self.Conv_0(x))
        for name in self._cells:
            s0, s1 = s1, getattr(self, name)(s0, s1)
        return self.Dense_0(s1.mean((1, 2)))
