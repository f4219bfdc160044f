"""Gossip over the client mesh: DSGD and PushSum with the nodes split over
the ranks of a ``torch.distributed`` process group (counterpart of
``fedml_tpu/parallel/gossip.py``).

The simulator (``algorithms/decentralized.py``) mixes the stacked node
models with one product ``W @ X`` over a flat ``[N, D]`` f32 view
(:func:`mix_stacked`). Here each rank holds the nodes ``[rank * n_local,
(rank + 1) * n_local)`` and the matching columns of ``W``, trains its nodes,
and computes their contribution to every node, ``W[:, local] @ X_local``.
That ``[N, D]`` buffer, the PushSum mass ``W[:, local] @ ps_local`` and the
rank's loss and weight sums go out in ONE flat SUM all-reduce
(``parallel/crosssilo.all_reduce_flat``), which completes
``new_i = sum_j W[i, j] x_j`` on every rank: rather than one message an
edge, as the reference's per-neighbour sends do
(decentralized_worker_manager.py:41-46), one collective a round. Every rank
keeps the whole mixed state (what the JAX package's node-sharded global
array holds) and trains its own rows of it next round. Without a process
group the all-reduce is the identity, and the one-rank round is the
simulator's product on the same rows.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fedml_tpu_torch.core.pytree import tree_stack
from fedml_tpu_torch.parallel.crosssilo import SiloWork, all_reduce_flat


def flatten_nodes(stacked: dict) -> torch.Tensor:
    """Node-stacked leaves ``[N, ...]`` as one ``[N, D]`` f32 matrix, the
    leaves side by side in the state dict's order."""
    return torch.cat([v.reshape(v.shape[0], -1).to(torch.float32) for v in stacked.values()], 1)


def unflatten_nodes(flat: torch.Tensor, like: dict) -> dict:
    """The inverse of :func:`flatten_nodes`: rows of ``flat`` back into
    leaves of ``like``'s trailing shapes and dtypes."""
    parts = torch.split(flat, [v[0].numel() for v in like.values()], dim=1)
    return {k: p.reshape((flat.shape[0],) + tuple(v.shape[1:])).to(v.dtype)
            for (k, v), p in zip(like.items(), parts)}


def mix_flat(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``W @ X`` in f32: the gossip mix of the flat node matrix ``X``."""
    return torch.matmul(W.to(torch.float32), X)


def mix_mass(W: torch.Tensor, ps_weights: torch.Tensor) -> torch.Tensor:
    """``W @ ps_weights``, PushSum's mass mixed by the same product."""
    return mix_flat(W, ps_weights.reshape(-1, 1)).reshape(-1)


def mix_stacked(stacked: dict, W: torch.Tensor) -> dict:
    """``new_i = sum_j W[i, j] * x_j`` for every leaf, in f32, cast back to
    the leaf's dtype: one product over the flat ``[N, D]`` view."""
    return unflatten_nodes(mix_flat(W, flatten_nodes(stacked)), stacked)


def make_gossip_round(local_train: Callable, mesh, pushsum: bool = False) -> Callable:
    """Build ``round_fn(node_vars, ps_weights, W_cols, work) -> (node_vars,
    ps_weights, loss)``: ``node_vars`` every node's variables stacked
    ``[N, ...]`` and ``ps_weights`` the ``[N]`` PushSum mass (both the same
    on every rank), ``W_cols`` this rank's columns ``W[:, local]`` of the
    mixing matrix (column-stochastic for PushSum), ``work`` this rank's
    nodes in order (:class:`~fedml_tpu_torch.parallel.crosssilo.SiloWork`,
    the weight its sample count). Returns every node's mixed variables, the
    mixed mass (unchanged for DSGD) and the count-weighted train loss."""

    def round_fn(node_vars: dict, ps_weights: torch.Tensor, W_cols: torch.Tensor,
                 work: Sequence[SiloWork]):
        N, n_local = W_cols.shape
        if len(work) != n_local:
            raise ValueError(f"{len(work)} nodes of work for {n_local} columns of W")
        start = mesh.rank * n_local
        results = [local_train({k: v[start + i] for k, v in node_vars.items()}, c.x, c.y,
                               c.mask, c.count, orders=c.orders, key=c.key)
                   for i, c in enumerate(work)]
        part = mix_flat(W_cols, flatten_nodes(tree_stack([r.variables for r in results])))
        dev = part.device
        w = torch.tensor([c.weight for c in work], dtype=torch.float32, device=dev)
        losses = torch.stack([r.train_loss for r in results])
        mass = (mix_mass(W_cols, ps_weights[start:start + n_local]) if pushsum
                else torch.zeros(0, device=dev))
        full, mass, loss_sum, w_sum = all_reduce_flat(
            mesh, [part, mass, (losses * w).sum().reshape(1), w.sum().reshape(1)])
        loss = loss_sum[0] / torch.clamp(w_sum[0], min=1e-12)
        return (unflatten_nodes(full, node_vars), mass if pushsum else ps_weights, loss)

    return round_fn


def place_gossip_inputs(mesh, W: torch.Tensor, node_vars: dict, ps_weights: torch.Tensor,
                        arrays: Sequence, dtype=None) -> tuple:
    """This rank's share of the round's inputs on its device: ``W``'s
    columns of its nodes, the node state and mass whole, and its block of
    the node-stacked host ``(x, y, mask)``, ``x`` cast to ``dtype`` when
    given and floating."""
    from fedml_tpu_torch.parallel.mesh import shard_client_batch

    x, y, mask = arrays
    cols = mesh.block(W.shape[1])
    return (W[:, cols].to(mesh.device), {k: v.to(mesh.device) for k, v in node_vars.items()},
            ps_weights.to(mesh.device),
            shard_client_batch(mesh, [x], dtype) + shard_client_batch(mesh, [y, mask]))
