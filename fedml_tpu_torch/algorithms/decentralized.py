"""Decentralized (serverless) FL: DSGD and PushSum gossip over a topology
(counterpart of ``fedml_tpu/algorithms/decentralized.py``; reference
fedml_api/standalone/decentralized/, ClientDSGD client_dsgd.py:6-90,
ClientPushsum client_pushsum.py:7-108).

Every node keeps its own model (``node_vars``, each leaf stacked ``[N,
...]``), and a round alternates

    train:  node i <- local SGD from its own variables on its own records
    mix:    nodes  <- W @ nodes      (one f32 product over a flat [N, D] view)

with every node training every round (client sampling does not apply). Each
node's per-epoch orders are those of cohort position i in a cohort of N
(``order_hook(round, i)``), the counterpart of JAX's node keys
``split(round_key, N)``. The mix is ``parallel/gossip.mix_stacked``.

PushSum mixes with the column-stochastic form of the topology (node j
splits its mass evenly among its out-neighbours, ``W = A / A.sum(0)`` with
``A = W > 0``), so total mass is conserved, and mixes a scalar weight per
node (``ps_weights``) by the same matrix. The nodes train on their biased
variables; only the consensus estimate, ``self.variables``, divides by the
weights (``_update_consensus``), which recovers the uniform average on
directed graphs where row-stochastic gossip converges to a degree-biased one.

The round is the algorithm's own (``fedavg.OwnRoundMixin``): ``device_data``,
``pack_lanes`` and ``failure_prob`` are ignored with the JAX package's
warnings. Every node's records are placed on the device at the first round
and stay there. :class:`MeshDecentralizedFedAPI` runs the round over the
ranks of a process group (``parallel/gossip.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, OwnRoundMixin, _live_slots
from fedml_tpu_torch.core.pytree import tree_stack
from fedml_tpu_torch.distributed.topology import BaseTopologyManager, SymmetricTopologyManager
from fedml_tpu_torch.parallel.crosssilo import SiloWork
from fedml_tpu_torch.parallel.gossip import (make_gossip_round, mix_mass, mix_stacked,
                                             place_gossip_inputs)
from fedml_tpu_torch.parallel.local import finalize_metrics
from fedml_tpu_torch.parallel.mesh import ClientMesh, client_mesh

__all__ = ["DecentralizedFedAPI", "MeshDecentralizedFedAPI", "mix_stacked"]


class DecentralizedFedAPI(OwnRoundMixin, FedAvgAPI):
    """Gossip simulator: every node holds its own model; rounds alternate
    local training and neighbour mixing. The consensus estimate (the node
    average, de-biased under PushSum) is ``self.variables``, which the
    global evaluation reads."""

    def __init__(self, dataset, config, bundle=None,
                 topology: Optional[BaseTopologyManager] = None, mode: str = "dsgd", **kw):
        if mode not in ("dsgd", "pushsum"):
            raise ValueError(f"mode must be dsgd|pushsum, got {mode!r}")
        self.mode = mode
        n = dataset.num_clients
        if topology is None:
            topology = SymmetricTopologyManager(n, neighbor_num=2, seed=config.seed)
            topology.generate_topology()
        self.topology = topology
        W = np.asarray(topology.mixing_matrix, np.float32)
        if mode == "pushsum":
            # column-stochastic: node j pushes 1/out_degree(j) to each
            # out-neighbour; W @ ones is not ones, which ps_weights tracks
            A = (W > 0).astype(np.float32)
            W = A / A.sum(axis=0, keepdims=True)
        super().__init__(dataset, config, bundle, **kw)
        self.W = torch.from_numpy(W).to(self.device)
        self._node_data = None
        self.init_nodes()

    def init_nodes(self) -> None:
        """Every node starts from ``self.variables``, with PushSum mass 1."""
        n = self.dataset.num_clients
        self.node_vars = {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
                          for k, v in self.variables.items()}
        self.ps_weights = torch.ones(n, dtype=torch.float32, device=self.device)

    def round_counts(self, round_idx: int) -> tuple:
        """(real, executed) examples one epoch of a round processes: every
        node's records and the batch slots of their live steps."""
        counts = np.asarray(self.dataset.train_counts, np.int64)
        return int(counts.sum()), _live_slots(counts, self.config.batch_size)

    def _run_round_inner(self, round_idx: int) -> "float | torch.Tensor":
        ds, N = self.dataset, self.dataset.num_clients
        if self._node_data is None:
            x, y, m, _ = ds.client_slice(np.arange(N))
            self._node_data = self._to_device(x, y, m)
        x, y, m = self._node_data
        counts = np.asarray(ds.train_counts, np.int64)
        orders, keys = self._round_orders(round_idx, N), self._round_keys(round_idx, N)
        results = [self._local_train({k: v[i] for k, v in self.node_vars.items()}, x[i], y[i],
                                     m[i], int(counts[i]), orders=orders[i],
                                     key=keys[i])
                   for i in range(N)]
        self.node_vars = mix_stacked(tree_stack([r.variables for r in results]), self.W)
        if self.mode == "pushsum":
            self.ps_weights = mix_mass(self.W, self.ps_weights)
        w = torch.as_tensor(counts.astype(np.float32), device=self.device)
        loss = (torch.stack([r.train_loss for r in results]) * w).sum() / w.sum()
        self._update_consensus()
        return loss if self.config.async_rounds else float(loss)

    def _update_consensus(self) -> None:
        """``self.variables`` = the node average in f32, each node divided
        by its PushSum weight first (by 1 under DSGD), cast back to the
        leaf's dtype. Shared by the simulator and the mesh, so their
        evaluations read the same estimate."""
        debias = self.ps_weights if self.mode == "pushsum" else torch.ones_like(self.ps_weights)
        self.variables = {
            k: (x.to(torch.float32) / debias.reshape((-1,) + (1,) * (x.dim() - 1))
                ).mean(0).to(x.dtype)
            for k, x in self.node_vars.items()}

    def consensus_distance(self) -> float:
        """Mean over nodes of the squared distance of a node's model from
        the consensus estimate, the convergence diagnostic of gossip."""
        total = sum(float((x.to(torch.float32) - self.variables[k].to(torch.float32)[None])
                          .square().sum()) for k, x in self.node_vars.items())
        return total / self.dataset.num_clients

    def evaluate_node(self, node_idx: int) -> dict:
        """Node ``node_idx``'s own model on the global test pool."""
        if self._dev_test is None:
            ds = self.dataset
            self._dev_test = self._to_device(ds.test_x, ds.test_y, ds.test_mask, cast=False)
        sums = self._eval({k: v[node_idx] for k, v in self.node_vars.items()}, *self._dev_test)
        return finalize_metrics({k: v.item() for k, v in sums.items()})


class MeshDecentralizedFedAPI(DecentralizedFedAPI):
    """Gossip with the nodes split over the ranks of the client mesh
    (``parallel/mesh.client_mesh``: the initialised process group, or one
    rank without one): each rank trains its block of nodes and the mix is
    one all-reduce (``parallel/gossip.make_gossip_round``). The arithmetic
    is the simulator's up to the all-reduce's order of summation; every rank
    ends a round with every node's state. ``num_clients`` must be a
    multiple of the world size."""

    def __init__(self, dataset, config, bundle=None,
                 topology: Optional[BaseTopologyManager] = None, mode: str = "dsgd",
                 mesh: Optional[ClientMesh] = None, **kw):
        self.mesh = mesh or client_mesh(device=kw.get("device"))
        if dataset.num_clients % self.mesh.world_size:
            raise ValueError(f"num_clients ({dataset.num_clients}) must be a multiple of the "
                             f"mesh's ranks ({self.mesh.world_size})")
        kw["device"] = self.mesh.device
        super().__init__(dataset, config, bundle, topology, mode, **kw)
        self._round = make_gossip_round(self._local_train, self.mesh,
                                        pushsum=mode == "pushsum")
        self._placed = None      # (W's columns, this rank's node records) after round 0

    def _run_round_inner(self, round_idx: int) -> "float | torch.Tensor":
        ds, N = self.dataset, self.dataset.num_clients
        if self._placed is None:
            x, y, m, _ = ds.client_slice(np.arange(N))
            dtype = torch.bfloat16 if self.config.dtype == "bfloat16" else None
            W_cols, self.node_vars, self.ps_weights, data = place_gossip_inputs(
                self.mesh, self.W, self.node_vars, self.ps_weights, (x, y, m), dtype)
            self._placed = (W_cols, data)
        W_cols, (x, y, m) = self._placed
        blk = self.mesh.block(N)
        counts = np.asarray(ds.train_counts, np.int64)[blk]
        orders = self._round_orders(round_idx, range(blk.start, blk.stop))
        keys = self._round_keys(round_idx, range(blk.start, blk.stop))
        work = [SiloWork(x[i], y[i], m[i], int(c), float(c), orders[i], keys[i])
                for i, c in enumerate(counts)]
        self.node_vars, self.ps_weights, loss = self._round(self.node_vars, self.ps_weights,
                                                            W_cols, work)
        self._update_consensus()
        return loss if self.config.async_rounds else float(loss)
