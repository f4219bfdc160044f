"""The cross-silo paradigm's rounds over the client mesh (counterpart of
``fedml_tpu/parallel/crosssilo.py``).

The JAX package runs a round as one ``shard_map``-ped program: each device
trains its block of clients under ``vmap`` and the weighted mean is a
``psum``. Here each rank trains its clients one after another
(``make_local_train_fn``, every live step a replay of the captured step),
adds ``w * variables`` into f32 accumulators, and the round ends in ONE SUM
all-reduce of a single flat f32 buffer holding every state leaf, the loss
sum and the algorithm's extras (:func:`mesh_finish`). The total weight is
host numpy on every rank (counts and masks), so the division, the server
hook and the all-failed rollback need no device sync. The all-reduce runs
once a round, eagerly, outside the captured step graphs.

The grouped schedule of the JAX package (``make_crosssilo_round_grouped``)
is :func:`make_crosssilo_round` over the groups' clients, each on its
record axis cut to its group's scan length, so it has no function of its
own, and ``place_round_inputs`` is ``parallel/mesh.shard_client_batch``
(each rank takes its block of the host cohort; nothing is replicated by a
sharding). The hierarchical round (:func:`make_hierarchical_round`) runs
on the 2-D ``('group', 'clients')`` mesh (``parallel/mesh.hierarchical_mesh``):
a flat all-reduce over the group's row each group round, one across groups
at the end.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from fedml_tpu_torch.core.pytree import tree_add, tree_leaves, tree_map
from fedml_tpu_torch.parallel.local import LocalResult


def apply_server_and_rollback(variables0: dict, agg: dict, extras: Optional[dict],
                              total: float, server_state: dict, rng,
                              server_update: Optional[Callable]) -> tuple[dict, dict]:
    """The post-aggregation tail: the server hook
    ``server_update(variables0, agg, extras, total, server_state, rng)`` on
    the aggregate, then the all-failed rollback: a round whose total weight
    is 0 keeps the weights AND the server state (a server optimizer would
    otherwise absorb the zero aggregate as a pseudo-gradient). ``total`` is
    known on the host, so such a round skips the hook instead of undoing
    it: the server optimizers update their state in place."""
    if not total > 0:
        return variables0, server_state
    if server_update is None:
        return agg, server_state
    return server_update(variables0, agg, extras, total, server_state, rng)


def all_reduce_flat(mesh, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One SUM all-reduce over the mesh of every tensor, concatenated into
    a single flat f32 buffer; returns the summed tensors (f32, their
    shapes). Without a process group the sum is over one rank: the
    tensors as they are, in f32."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    if mesh.group is not None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def mesh_finish(mesh, variables0: dict, acc: dict, loss_sum: torch.Tensor,
                extras: Optional[dict], total: float, server_state: dict,
                server_update: Optional[Callable], rng=None) -> tuple[dict, dict, torch.Tensor]:
    """The shared tail of every mesh round: this rank's f32 partial sums
    (``acc``: name -> sum of ``w * variables``; ``loss_sum``; ``extras``)
    all-reduced in one call, each leaf divided by
    ``max(total, 1e-12)`` and cast back to its dtype (the JAX package's
    ``weighted_psum_tree_mean``), then ``apply_server_and_rollback`` with
    the round's server randomness ``rng`` (every rank derives the same).
    Returns ``(variables, server_state, loss)``, the loss a 0-dim device
    tensor."""
    names = list(acc)
    ex_leaves = tree_leaves(extras) if extras is not None else []
    reduced = all_reduce_flat(mesh, [acc[k] for k in names] + [loss_sum.reshape(1)] + ex_leaves)
    denom = max(float(total), 1e-12)
    agg = {k: (r / denom).to(variables0[k].dtype) for k, r in zip(names, reduced)}
    loss = reduced[len(names)][0] / denom
    if extras is not None:
        it = iter(reduced[len(names) + 1:])
        extras = tree_map(lambda x: next(it).to(x.dtype), extras)
    new_vars, new_state = apply_server_and_rollback(variables0, agg, extras, total,
                                                    server_state, rng, server_update)
    return new_vars, new_state, loss


class SiloWork(NamedTuple):
    """One client of a rank's share of a mesh round: its records (on the
    rank's device, the record axis possibly cut to a group's scan length),
    its real count, its aggregation weight and its per-epoch orders."""
    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    count: int
    weight: float
    orders: torch.Tensor


def make_crosssilo_round(local_train: Callable, mesh, *,
                         client_transform: Optional[Callable] = None,
                         reduce_extras: Optional[Callable] = None,
                         server_update: Optional[Callable] = None) -> Callable:
    """Build ``round_fn(variables, server_state, work, total, rng=None) ->
    (variables, server_state, loss)``: ``work`` this rank's clients
    (:class:`SiloWork`), ``total`` the round's total weight over every rank
    (host), ``rng`` the round's server randomness.

    The hooks are the cross-silo contract of the JAX package:
    ``client_transform(global_vars, stacked)`` maps a client's variables
    (a singleton client axis) before they enter the weighted sum;
    ``reduce_extras(global_vars, LocalResult, w)`` returns weighted partial
    sums that ride the same all-reduce; ``server_update`` runs on every
    rank after it (:func:`mesh_finish`)."""

    def round_fn(variables: dict, server_state: dict, work: Sequence[SiloWork],
                 total: float, rng=None):
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in variables.items()}
        dev = next(iter(variables.values())).device
        loss_sum = torch.zeros((), device=dev)
        extras = None
        for c in work:
            res = local_train(variables, c.x, c.y, c.mask, c.count, orders=c.orders)
            one = {k: v.unsqueeze(0) for k, v in res.variables.items()}
            out = one if client_transform is None else client_transform(variables, one)
            torch._foreach_add_(list(acc.values()), [out[k][0].to(torch.float32) for k in acc],
                                alpha=c.weight)
            loss_sum = loss_sum + res.train_loss * c.weight
            if reduce_extras is not None:
                w = torch.full((1,), c.weight, dtype=torch.float32, device=dev)
                stacked = LocalResult(one, res.train_loss.reshape(1),
                                      torch.full((1,), res.tau, dtype=torch.float32, device=dev))
                ex = reduce_extras(variables, stacked, w)
                extras = ex if extras is None else tree_add(extras, ex)
        return mesh_finish(mesh, variables, acc, loss_sum, extras, total, server_state,
                           server_update, rng)

    return round_fn


def make_hierarchical_round(local_train: Callable, mesh, group_rounds: int = 1) -> Callable:
    """Two-tier aggregation on the ``('group', 'clients')`` mesh
    (hierarchical_fl/trainer.py:43-69; ``mesh`` a
    ``parallel/mesh.HierarchicalMesh``). Each rank holds some of its group
    row's clients. In each of ``group_rounds`` group rounds they train from
    the group model, and one flat all-reduce over the row
    (:func:`all_reduce_flat`) gives the group's sum of ``w * variables``
    and of ``w * loss``, each divided by the group's mass (clamped at
    1e-12). After the group rounds one all-reduce across the rows weighs
    the group models by their mass. A round whose total weight is 0 keeps
    the variables.

    Returns ``round_fn(variables, work, gmass, total) -> (variables,
    loss)``: ``work[r]`` this rank's clients for group round r
    (:class:`SiloWork`; their orders differ by group round), ``gmass`` the
    group row's total weight and ``total`` the whole cohort's (host)."""

    def round_fn(variables: dict, work: Sequence[Sequence[SiloWork]], gmass: float,
                 total: float):
        if len(work) != group_rounds:
            raise ValueError(f"{len(work)} group rounds of work; the round has {group_rounds}")
        names = list(variables)
        dev = next(iter(variables.values())).device
        gden = max(float(gmass), 1e-12)
        gvars, loss = variables, torch.zeros((), device=dev)
        for clients in work:
            acc = [torch.zeros_like(variables[k], dtype=torch.float32) for k in names]
            loss_sum = torch.zeros((), device=dev)
            for c in clients:
                res = local_train(gvars, c.x, c.y, c.mask, c.count, orders=c.orders)
                torch._foreach_add_(acc, [res.variables[k].to(torch.float32) for k in names],
                                    alpha=c.weight)
                loss_sum = loss_sum + res.train_loss * c.weight
            reduced = all_reduce_flat(mesh.clients, acc + [loss_sum.reshape(1)])
            gvars = {k: (r / gden).to(variables[k].dtype) for k, r in zip(names, reduced)}
            loss = reduced[-1][0] / gden
        denom = max(float(total), 1e-12)
        reduced = all_reduce_flat(mesh.groups, [gvars[k].to(torch.float32) * float(gmass)
                                                for k in names] + [loss.reshape(1) * float(gmass)])
        loss = reduced[-1][0] / denom
        if not total > 0:
            return variables, loss
        return {k: (r / denom).to(variables[k].dtype) for k, r in zip(names, reduced)}, loss

    return round_fn
