"""Batch-sharded data-parallel training with synchronized BatchNorm
(counterpart of ``fedml_tpu/parallel/dataparallel.py``; the reference's
``nn.DataParallel`` FedGKT server and its sync-BN helpers).

The JAX package jits the single-device step with the batch axis sharded
over a 1-D ``('batch',)`` mesh and lets GSPMD all-reduce the BatchNorm
moments and the gradients. Here each rank runs the single-device step on
its rows of the global batch (:func:`place_batch`) and the step makes those
reductions itself:

- every BatchNorm sees the global batch's moments
  (``models/norm.sync_batch_norm``): the plain BN all-reduces E[x] and
  E[x^2] through a differentiable all-reduce, so its backward is
  synchronized too; the kernel BN (``bn_impl="pallas"``) gathers the
  axis's rows and runs K1/K2 on the whole batch. On an axis of one rank the
  bundle runs as given (K1/K2 launch as on one card);
- the loss is the global masked mean: the task's ``count`` is all-reduced
  before the backward (:func:`count_share`), each rank differentiates its
  masked mean times its share ``c_r / C`` of the global count (its local
  sum over ``C``), and one SUM all-reduce carries the gradients and the
  loss. Since sync-BN's backward crosses ranks, each rank's cotangents must
  already be the global loss's, so the weights come before the backward,
  not after it. The clip, when set, acts on the global gradients, then the
  optimizer steps alike on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.tasks import Task
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.norm import sync_batch_norm
from fedml_tpu_torch.parallel.collectives import all_reduce_sum_
from fedml_tpu_torch.parallel.local import clip_grads_
from fedml_tpu_torch.parallel.mesh import AxisLine, NamedMesh, bound_axes, named_mesh

BATCH_AXIS = "batch"


def batch_mesh(n_devices: Optional[int] = None, axis: str = BATCH_AXIS,
               device=None) -> NamedMesh:
    """The 1-D mesh over the batch axis: every rank of the process group
    (or ``n_devices``, which must be the world size)."""
    from fedml_tpu_torch.parallel.mesh import client_mesh

    n = n_devices or client_mesh(device=device).world_size
    return named_mesh((axis,), (n,), device)


def place_batch(mesh: NamedMesh, *arrays, axis: str = BATCH_AXIS):
    """This rank's rows of each global array (numpy or tensor; the leading
    axis split evenly over ``axis``), as tensors on the mesh's device."""
    out = []
    for a in arrays:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        out.append(t[mesh.block(t.shape[0], axis)].to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def count_share(line: AxisLine, count: torch.Tensor) -> torch.Tensor:
    """This rank's share ``c_r / C`` of the line's total ``count``, summed
    outside autograd (a sum inside the loss would scale every cotangent by
    the line's size): the weight that turns its masked mean into its part
    of the global mean. 1 on a line of one rank with records."""
    count = count.detach().to(torch.float32).reshape(1)
    total = count.clone()
    all_reduce_sum_(line, [total])
    return (count / torch.clamp(total, min=1.0))[0]


def make_dp_train_step(bundle: ModelBundle, task: Task, tx: optim.Transform,
                       mesh: Optional[NamedMesh] = None, axis: str = BATCH_AXIS,
                       compute_dtype=None, grad_clip: Optional[float] = None) -> Callable:
    """Build ``step(x, y, mask, key=None) -> loss`` on ``bundle.module``,
    with ``tx`` bound to its parameters (``step.opt``) at the build; ``x``,
    ``y``, ``mask`` are this rank's rows (:func:`place_batch`), ``key`` a
    dropout model's step key. ``mesh=None`` is the plain single-device
    step. The returned loss is the global masked mean, a detached 0-dim
    tensor; the module's parameters and BN statistics, and the optimizer
    state, are updated in place, alike on every rank."""
    module = bundle.module
    opt = tx(module.parameters())
    line = mesh.line(axis) if mesh is not None else None

    def step(x, y, mask, key=None) -> torch.Tensor:
        if compute_dtype is not None and x.is_floating_point():
            x = x.to(compute_dtype)
        opt.zero_grad(set_to_none=False)
        module.train()
        kw = {"dropout_key": key} if bundle.uses_dropout else {}
        if line is None:
            loss = task.loss(module(x, **kw), y, mask)
            loss.backward()
            loss = loss.detach()
        else:
            with bound_axes(mesh), sync_batch_norm(axis):
                logits = module(x, **kw)
                share = count_share(line, task.metrics(logits.detach(), y, mask)["count"])
                loss = task.loss(logits, y, mask) * share
                loss.backward()
            loss = loss.detach().reshape(1)
            all_reduce_sum_(line, [p.grad for p in opt.params if p.grad is not None] + [loss])
            loss = loss[0]
        if grad_clip:
            clip_grads_(opt.params, grad_clip)
        opt.step()
        return loss

    step.opt = opt
    return step


def make_dp_eval_fn(bundle: ModelBundle, task: Task, mesh: NamedMesh,
                    axis: str = BATCH_AXIS) -> Callable:
    """Build ``evaluate(x, y, mask) -> metric-sum dict`` in eval mode on
    this rank's rows, the sums all-reduced over ``axis`` (global sums)."""
    line = mesh.line(axis)

    @torch.no_grad()
    def evaluate(x, y, mask) -> dict:
        sums = task.metrics(bundle.apply_eval(bundle.module, x), y, mask)
        keys = sorted(sums)
        vals = [sums[k].to(torch.float32).reshape(-1) for k in keys]
        all_reduce_sum_(line, vals)
        return {k: v.reshape(sums[k].shape) for k, v in zip(keys, vals)}

    return evaluate
