"""Hierarchical FL, two-tier client -> group -> global aggregation
(counterpart of ``fedml_tpu/algorithms/hierarchical.py``; reference
fedml_api/standalone/hierarchical_fl/, Group.train group.py:24-46 and
Trainer.train trainer.py:43-69).

Each global round runs ``group_comm_round`` group rounds. In a group round
every client trains from its group's model and each group takes the
sample-weighted mean of its clients (``core/aggregation.
hierarchical_aggregate``); after the group rounds the global model is the
group models weighted by group mass, and the round's loss is the last group
round's. Clients go to groups round-robin: cohort position i to group
``i % group_num``. With ``group_comm_round = 1`` the scheme is flat FedAvg
(the reference CI's property, CI-script-fedavg.sh:51-57): group round 0
draws the flat round's orders.

As in the JAX package, the round program is the algorithm's own
(``fedavg.OwnRoundMixin``), so the round is the host round (the cohort
shipped each round, its record axis cut to the bucket): the data is not
placed on the device, the packed schedule is not taken whatever
``pack_lanes`` says, the rounds do not stream, and ``failure_prob`` is
ignored with the JAX package's warning. Each group round
draws its own orders (``_round_orders(..., group_round=r)``), the
counterpart of JAX's per-client keys ``split(split(rng, GR)[r], C)[i]``.

:class:`CrossSiloHierarchicalFedAvgAPI` runs the same round on the 2-D
``('group', 'clients')`` mesh (``parallel/mesh.hierarchical_mesh``,
``parallel/crosssilo.make_hierarchical_round``): group row g holds the
clients ``{j*G + g}``, the simulation's groups.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, OwnRoundMixin
from fedml_tpu_torch.core.aggregation import hierarchical_aggregate
from fedml_tpu_torch.core.pytree import tree_stack
from fedml_tpu_torch.parallel.crosssilo import SiloWork, make_hierarchical_round
from fedml_tpu_torch.parallel.mesh import HierarchicalMesh, hierarchical_mesh


class HierarchicalFedAvgAPI(OwnRoundMixin, FedAvgAPI):
    """Standalone hierarchical simulator; clients assigned to groups
    round-robin (client i -> group i % group_num, like the reference's even
    split)."""

    def __init__(self, dataset, config, bundle=None, **kw):
        self.group_num = max(int(config.group_num), 1)
        self.group_comm_round = max(int(config.group_comm_round), 1)
        super().__init__(dataset, config, bundle, **kw)

    def _plain_round(self, round_idx: int, cx, cy, cm, counts: np.ndarray,
                     wn: np.ndarray) -> "float | torch.Tensor":
        G = self.group_num
        C, n = len(counts), cx.shape[1]
        gids = np.arange(C) % G
        w = torch.as_tensor(wn, dtype=torch.float32, device=self.device)
        group_vars = [self.variables] * G
        for gr in range(self.group_comm_round):
            orders = self._round_orders(round_idx, range(C), n, group_round=gr)
            results = [self._local_train(group_vars[gids[j]], cx[j], cy[j], cm[j],
                                         min(int(counts[j]), n), orders=orders[j])
                       for j in range(C)]
            # the global model: after the last group round, the group models
            # weighted by group mass
            stacked, global_vars = hierarchical_aggregate(
                tree_stack([r.variables for r in results]), w, gids, G)
            group_vars = [{k: v[g] for k, v in stacked.items()} for g in range(G)]
            losses = torch.stack([r.train_loss for r in results])
            train_loss = (losses * w).sum() / w.sum()
        self.variables = global_vars
        return train_loss if self.config.async_rounds else float(train_loss)


class CrossSiloHierarchicalFedAvgAPI(HierarchicalFedAvgAPI):
    """Hierarchical FL on the 2-D ``('group', 'clients')`` mesh over the
    ranks of the process group (the deployable counterpart of the
    reference's process tree, hierarchical_fl/trainer.py:43-69): the group
    all-reduce runs over a row's ranks every group round, the global one
    across rows once a round. Row g holds the clients ``{j*G + g}``, the
    simulator's ``i % G``, and each client draws the simulator's orders (its
    cohort position's), so the round is the simulator's.

    The effective cohort must be ``group_num`` x a multiple of the mesh's
    ``clients`` axis; ``group_num`` must divide the world size (one rank
    without a process group, so there ``group_num`` is 1)."""

    def __init__(self, dataset, config, bundle=None, mesh: HierarchicalMesh = None, **kw):
        group_num = max(int(config.group_num), 1)
        if mesh is None:
            world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
            if world % group_num:
                raise ValueError(f"group_num ({group_num}) must divide the device count "
                                 f"({world}) to build the ('group','clients') mesh")
            mesh = hierarchical_mesh(group_num, world // group_num, device=kw.get("device"))
        self.mesh = mesh
        if set(mesh.shape) != {"group", "clients"}:
            raise ValueError(f"mesh must have ('group','clients') axes, got {tuple(mesh.shape)}")
        cohort = min(config.client_num_per_round, dataset.num_clients)
        cpg_dev = mesh.shape["clients"]
        if group_num != mesh.shape["group"]:
            raise ValueError(f"config.group_num ({group_num}) != mesh 'group' axis "
                             f"({mesh.shape['group']})")
        if cohort % group_num or (cohort // group_num) % cpg_dev:
            raise ValueError(f"effective cohort ({cohort}) must split into {group_num} groups of "
                             f"a multiple of {cpg_dev} clients")
        kw["device"] = mesh.device
        super().__init__(dataset, config, bundle, **kw)
        self._round = make_hierarchical_round(self._local_train, mesh, self.group_comm_round)

    def _plain_round(self, round_idx: int, cx, cy, cm, counts: np.ndarray,
                     wn: np.ndarray) -> "float | torch.Tensor":
        G, mesh = self.group_num, self.mesh
        C, n = len(counts), cx.shape[1]
        row = np.arange(mesh.group_index, C, G)          # this row's clients {j*G + g}
        mine = row[mesh.clients.block(len(row))]
        work = []
        for gr in range(self.group_comm_round):
            orders = self._round_orders(round_idx, mine, n, group_round=gr)
            work.append([SiloWork(cx[p], cy[p], cm[p], min(int(counts[p]), n), float(wn[p]),
                                  orders[i]) for i, p in enumerate(mine)])
        self.variables, loss = self._round(self.variables, work, float(wn[row].sum()),
                                           float(wn.astype(np.float64).sum()))
        return loss if self.config.async_rounds else float(loss)
