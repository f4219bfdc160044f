"""Tensor (Megatron) and expert parallelism for the transformer LMs
(counterpart of ``fedml_tpu/parallel/tensor.py``).

The JAX package places parameters with ``PartitionSpec``s and lets GSPMD
insert the collectives. Here the split is explicit: :func:`shard_params_tp`
returns a twin of the module whose rank holds its shards, and the twin's
blocks run the Megatron pattern over the bound ``tp`` axis
(``models/transformer.py``): ``qkv`` and MLP ``Dense_0`` column-parallel
behind ``f``, ``attn.out`` and ``Dense_1`` row-parallel ahead of ``g``, so
one all-reduce an attention block and one an MLP; each rank runs kernel K6
on its own heads. Replicated parameters get the same, whole gradient on
every ``tp`` rank.

The fused ``qkv`` kernel ``[D, 3D]`` is the trap: JAX's ``P(None, 'tp')``
cuts it into contiguous column blocks, which do not align with heads
(GSPMD reshards behind the scenes). Rank r's shard here holds rank r's
heads of each of q, k and v; its shape is JAX's shard shape, and
:func:`gather_params` puts the whole tensor back together.

Expert parallelism (:func:`shard_params_ep`, a ``MoeTransformerLM``): rank
r holds experts ``[r*E/n, (r+1)*E/n)`` of every expert weight; the router
and everything else stay replicated, and each MoE layer's partial combine
is all-reduced (``models/moe.py``).

:func:`make_tp_lm_train_step` serves both: a rank takes its ``dp`` rows of
the global batch, the loss is its masked K5 sum over the global token
count, and the loss and the gradients are SUM all-reduced over ``dp``.
"""

from __future__ import annotations

import copy
import re
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from fedml_tpu_torch.core.optim import Optimizer
from fedml_tpu_torch.models.convert import flax_path
from fedml_tpu_torch.ops.xent import masked_cross_entropy
from fedml_tpu_torch.parallel.collectives import all_reduce_sum_
from fedml_tpu_torch.parallel.mesh import NamedMesh, bound_axes, named_mesh
from fedml_tpu_torch.parallel.sequence import local_block

#: Megatron placement on flax paths: (path regex, spec builder), first
#: match wins, default replicated; a spec is the PartitionSpec's entries
_TP_RULES = (
    (re.compile(r"attn.*qkv.*kernel"), lambda tp: (None, tp)),
    (re.compile(r"attn.*qkv.*bias"), lambda tp: (tp,)),
    (re.compile(r"attn.*out.*kernel"), lambda tp: (tp, None)),
    (re.compile(r"Dense_0.*kernel"), lambda tp: (None, tp)),   # MLP up
    (re.compile(r"Dense_0.*bias"), lambda tp: (tp,)),
    (re.compile(r"Dense_1.*kernel"), lambda tp: (tp, None)),   # MLP down
)

#: expert placement: the expert axis of every stacked expert weight
_EP_RULES = (
    (re.compile(r"moe.*w_(up|dn)"), lambda ep: (ep,)),
    (re.compile(r"moe.*b_(up|dn)"), lambda ep: (ep,)),
)


def _spec_for(rules, path: str, axis: str) -> tuple:
    for rx, spec in rules:
        if rx.search(path):
            return spec(axis)
    return ()


def tp_spec(path: str, tp_axis: str = "tp") -> tuple:
    """The Megatron PartitionSpec entries of one flax parameter path
    (``()``: replicated), as the JAX package's ``tp_spec`` gives them."""
    return _spec_for(_TP_RULES, path, tp_axis)


def ep_spec(path: str, ep_axis: str = "ep") -> tuple:
    """The expert-parallel PartitionSpec entries of one flax path."""
    return _spec_for(_EP_RULES, path, ep_axis)


def tp_mesh(n_dp: int, n_tp: int, device=None) -> NamedMesh:
    """The 2-D ``('dp', 'tp')`` mesh (keep tp within a host: it
    all-reduces twice a layer)."""
    return named_mesh(("dp", "tp"), (n_dp, n_tp), device)


def ep_mesh(n_dp: int, n_ep: int, device=None) -> NamedMesh:
    """The 2-D ``('dp', 'ep')`` mesh: batch over dp, experts over ep."""
    return named_mesh(("dp", "ep"), (n_dp, n_ep), device)


def _layout(rules, key: str, t: torch.Tensor, axis: str) -> Optional[tuple]:
    """(dim, groups) of a state-dict entry's shard in the port's layout, or
    None when it is replicated. A 2-D ``weight`` is the transposed flax
    kernel; the fused qkv splits within each of its three parts."""
    spec = _spec_for(rules, "/".join(flax_path(key, t.dim())), axis)
    if not spec:
        return None
    d = spec.index(axis)
    if key.endswith(".weight") and t.dim() == 2:
        d = 1 - d
    return d, 3 if ".qkv." in key else 1


def _take(t: torch.Tensor, dim: int, groups: int, n: int, r: int) -> torch.Tensor:
    parts = torch.chunk(t, groups, dim=dim)
    return torch.cat([torch.chunk(p, n, dim=dim)[r] for p in parts], dim=dim)


def _shard(module: nn.Module, mesh: NamedMesh, rules, axis: str, flag: str) -> nn.Module:
    line = mesh.line(axis)
    twin = copy.deepcopy(module)
    for key, p in list(twin.named_parameters()):
        lay = _layout(rules, key, p, axis)
        if lay is None:
            continue
        if p.shape[lay[0]] % (lay[1] * line.size):
            raise ValueError(f"{key} {tuple(p.shape)} does not split over {line.size} ranks")
        owner, name = twin.get_submodule(key.rpartition(".")[0]), key.rpartition(".")[2]
        setattr(owner, name, nn.Parameter(_take(p.detach(), *lay, line.size, line.index)
                                          .clone().to(mesh.device)))
    for m in twin.modules():
        if hasattr(m, flag):
            setattr(m, flag, axis)
    twin._sharded = (rules, axis)
    return twin.to(mesh.device)


def shard_params_tp(module: nn.Module, mesh: NamedMesh, tp_axis: str = "tp") -> nn.Module:
    """A twin of ``module`` (a ``TransformerLM``) that holds this rank's
    Megatron shards over ``mesh``'s ``tp_axis`` and runs tensor parallel
    over it. Heads and the MLP width must divide the axis."""
    return _shard(module, mesh, _TP_RULES, tp_axis, "tp_axis")


def shard_params_ep(module: nn.Module, mesh: NamedMesh, ep_axis: str = "ep") -> nn.Module:
    """A twin of ``module`` (a ``MoeTransformerLM``) that holds this rank's
    experts over ``mesh``'s ``ep_axis`` and runs expert parallel over it.
    The expert count must divide the axis."""
    return _shard(module, mesh, _EP_RULES, ep_axis, "ep_axis")


def gather_params(module: nn.Module, mesh: NamedMesh) -> dict:
    """The whole state dict of a sharded twin, on every rank: each shard
    all-gathered over its axis and put back in place."""
    rules, axis = module._sharded
    line = mesh.line(axis)
    out = {}
    for key, t in module.state_dict().items():
        lay = _layout(rules, key, t, axis)
        if lay is None or line.size == 1:
            out[key] = t.detach().clone()
            continue
        parts = [torch.empty_like(t) for _ in range(line.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=line.group)
        dim, groups = lay
        chunks = [torch.chunk(p, groups, dim=dim) for p in parts]
        out[key] = torch.cat([c[g] for g in range(groups) for c in chunks], dim=dim)
    return out


def make_tp_lm_train_step(module: nn.Module, mesh: NamedMesh, *,
                          xent_impl: str = "auto") -> Callable:
    """Build ``step(opt, x, y, mask) -> loss`` for a sharded twin
    (:func:`shard_params_tp` / :func:`shard_params_ep`; or the module itself
    on a mesh whose model axis has one rank). ``opt`` is bound to the twin's
    parameters; ``x``/``y``/``mask`` are the global ``[B, T]`` batch, of
    which this rank takes its ``dp`` rows. The global token count is
    all-reduced over ``dp`` outside autograd, and the loss and the gradients
    are SUM all-reduced over ``dp``; the model axis needs no gradient
    reduction."""
    dp = mesh.line("dp")

    def step(opt: Optimizer, x, y, mask) -> torch.Tensor:
        x, y, mask = (local_block(mesh, t, "dp") for t in (x, y, mask))
        total = mask.to(torch.float32).sum()
        all_reduce_sum_(dp, [total])
        module.train()
        opt.zero_grad()
        with bound_axes(mesh):
            logits = module(x)
            per = masked_cross_entropy(logits, y, mask, impl=xent_impl)
            loss = per.sum() / torch.clamp(total, min=1.0)
            loss.backward()
        loss = loss.detach().reshape(1)
        all_reduce_sum_(dp, [p.grad for p in opt.params if p.grad is not None] + [loss])
        opt.step()
        return loss[0]

    return step
