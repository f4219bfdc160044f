"""Sequence parallelism over an ``'sp'`` mesh axis (counterpart of
``fedml_tpu/parallel/sequence.py``): ring and Ulysses attention over
``torch.distributed``, and the LM train step on a ``('dp', 'sp')`` mesh.

A sequence is sharded over ``'sp'`` in order of mesh position; every rank
holds the whole model and one shard of ``Tl`` tokens.

- :func:`ring_attention` runs kernel K6's ``attention_block_partial`` on
  the resident K/V shard, then ``axis_size - 1`` ring hops of (K, V)
  (``parallel/collectives.ring_hop``), each followed by K6 at the global
  offsets ``(idx * Tl, src * Tl)``; the partials merge online and are
  normalized once. Its backward is the plain recompute of each partial,
  and the hops' reverse.
- :func:`ulysses_attention` scatters heads and gathers the sequence with
  one all-to-all, runs K6's ``attention`` over ``H / n`` heads and the
  whole sequence, and reshards back.

:func:`make_sp_lm_train_step` is the JAX step over a :func:`sp_mesh`: a
rank takes its ``[B / dp, T / sp]`` block of the global batch, the module
(a ``TransformerLM`` with ``ring_axis='sp'``, ``ring_size = sp``) runs with
the mesh's axes bound (``parallel/mesh.bound_axes``) at ``pos_offset =
idx * Tl``, the loss goes through kernel K5, and the loss and the
gradients are SUM all-reduced over both axes. On one card the mesh is
(1, 1): the whole sequence on one device, the plain ``attention`` call and
no collective but the world group's one-rank all-reduce.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from fedml_tpu_torch.core.optim import Optimizer
from fedml_tpu_torch.ops.attention import (attention, attention_block_partial, merge_partials,
                                           normalize_partial)
from fedml_tpu_torch.ops.xent import masked_cross_entropy
from fedml_tpu_torch.parallel.collectives import Ring, all_reduce_sum_, all_to_all
from fedml_tpu_torch.parallel.mesh import NamedMesh, axis_line, bound_axes, named_mesh


def _line(axis_name: str, axis_size: int):
    line = axis_line(axis_name)
    if line.size != axis_size:
        raise ValueError(f"axis {axis_name!r} has {line.size} ranks, not axis_size={axis_size}")
    return line


def ring_attention(q, k, v, *, axis_name: str, axis_size: int, causal: bool = True,
                   sm_scale: Optional[float] = None, impl: str = "auto", hop=None):
    """Attention over a sequence sharded along ``axis_name``: ``q/k/v`` are
    this rank's ``[B, H, Tl, D]`` shards of a ``[B, H, axis_size*Tl, D]``
    sequence. ``hop`` is the per-hop body: an object with this rank's
    ``index`` that moves (k, v) one place along the ring, ``hop(k, v) ->
    (k, v)``; by default the bound axis's ring
    (``parallel/collectives.Ring``)."""
    if hop is None and axis_size > 1:
        hop = Ring(_line(axis_name, axis_size))
    idx = hop.index if hop is not None else 0
    tl = q.shape[2]
    kw = dict(causal=causal, sm_scale=sm_scale, impl=impl)
    acc = attention_block_partial(q, k, v, q_offset=idx * tl, k_offset=idx * tl, **kw)
    for i in range(1, axis_size):
        k, v = hop(k, v)
        src = (idx - i) % axis_size          # whose shard this rank holds now
        acc = merge_partials(acc, attention_block_partial(q, k, v, q_offset=idx * tl,
                                                          k_offset=src * tl, **kw))
    return normalize_partial(*acc, out_dtype=q.dtype)


def ulysses_attention(q, k, v, *, axis_name: str, axis_size: int, causal: bool = True,
                      sm_scale: Optional[float] = None, impl: str = "auto"):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism, with the
    layout of :func:`ring_attention`: heads scatter and the sequence
    gathers, K6 runs full attention over ``H / axis_size`` heads, and the
    inverse reshard restores the sequence shards. Needs ``H % axis_size ==
    0``."""
    h = q.shape[1]
    if h % axis_size:
        raise ValueError(f"ulysses needs heads ({h}) divisible by the sp axis ({axis_size}); "
                         "use ring_attention for head counts below the axis size")
    if axis_size == 1:
        return attention(q, k, v, causal=causal, sm_scale=sm_scale, impl=impl)
    line = _line(axis_name, axis_size)
    b = q.shape[0]
    # q, k, v reshard in one all-to-all: stacked on the batch axis
    qkv = all_to_all(line, torch.cat([q, k, v]), split=1, concat=2)
    qg, kg, vg = qkv[:b], qkv[b:2 * b], qkv[2 * b:]
    out = attention(qg.contiguous(), kg.contiguous(), vg.contiguous(), causal=causal,
                    sm_scale=sm_scale, impl=impl)
    return all_to_all(line, out, split=2, concat=1)


def sequence_attention(q, k, v, *, axis_name: str, axis_size: int, mode: str = "ring", **kw):
    """Dispatch between the two exact sequence-parallel attention schemes."""
    if mode == "ring":
        return ring_attention(q, k, v, axis_name=axis_name, axis_size=axis_size, **kw)
    if mode == "ulysses":
        return ulysses_attention(q, k, v, axis_name=axis_name, axis_size=axis_size, **kw)
    raise ValueError(f"unknown sequence-parallel mode {mode!r} (ring|ulysses)")


def sp_mesh(n_dp: int, n_sp: int, device=None) -> NamedMesh:
    """The 2-D ``('dp', 'sp')`` mesh: batch over dp, sequence over sp."""
    return named_mesh(("dp", "sp"), (n_dp, n_sp), device)


def local_block(mesh: NamedMesh, t: torch.Tensor, row_axis: str = "dp",
                col_axis: Optional[str] = None) -> torch.Tensor:
    """This rank's block of a global ``[B, T]`` array: rows over
    ``row_axis``, columns over ``col_axis`` (None: every column), on the
    mesh's device."""
    rows = mesh.block(t.shape[0], row_axis)
    cols = mesh.block(t.shape[1], col_axis) if col_axis else slice(None)
    return t[rows, cols].to(mesh.device)


def make_sp_lm_train_step(module: nn.Module, mesh: Optional[NamedMesh] = None, *,
                          attn_impl: str = "auto") -> Callable:
    """Build the LM train step ``step(opt, x, y, mask) -> loss``
    over ``mesh`` (default: the one-rank ``sp_mesh(1, 1)``).

    ``module`` is a ``TransformerLM`` built with ``ring_axis='sp'`` and
    ``ring_size = mesh.shape['sp']`` (any ring fields at sp = 1); ``opt`` an
    optimizer bound to its parameters, which holds the variables and the
    optimizer state the JAX step threads through: both are updated in place,
    alike on every rank. ``x``/``y`` are the global ``[B, T]`` token ids,
    ``mask`` ``[B, T]``. The global
    token count is all-reduced before the differentiated loss (a psum
    inside it would scale every cotangent by the mesh size); each rank's
    loss is its masked K5 sum over that count, and the loss and the
    gradients are SUM all-reduced over ``('dp', 'sp')``. The returned loss
    is a detached 0-dim tensor (no host sync)."""
    mesh = mesh if mesh is not None else sp_mesh(1, 1)
    n_sp = mesh.shape["sp"]
    ring = getattr(module, "ring_size", 1)
    if n_sp > 1 and (ring != n_sp or getattr(module, "ring_axis", None) != "sp"):
        raise ValueError(f"the module must be built with ring_axis='sp', ring_size={n_sp}; "
                         f"it has {getattr(module, 'ring_axis', None)!r}, {ring}")
    both = mesh.line("dp", "sp")

    def step(opt: Optimizer, x, y, mask) -> torch.Tensor:
        x, y, mask = (local_block(mesh, t, "dp", "sp") for t in (x, y, mask))
        tl = x.shape[1]
        total = mask.to(torch.float32).sum()
        all_reduce_sum_(both, [total])
        total = torch.clamp(total, min=1.0)
        module.train()
        opt.zero_grad()
        with bound_axes(mesh):
            logits = module(x, pos_offset=mesh.coord("sp") * tl)
            per = masked_cross_entropy(logits, y, mask, impl=attn_impl)
            loss = per.sum() / total
            loss.backward()
        loss = loss.detach().reshape(1)
        all_reduce_sum_(both, [p.grad for p in opt.params if p.grad is not None] + [loss])
        opt.step()
        return loss[0]

    return step
