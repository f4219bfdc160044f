"""FedAGC, adaptive-gradient-clipping aggregation (counterpart of
``fedml_tpu/algorithms/fedagc.py``; the fork's silo_fedagc.py).

Each client's round update is clipped unit-wise relative to the global
parameters (``core/aggregation.agc_clip_update``) before the weighted
average; the BatchNorm statistics are averaged unclipped. ``clipping`` is
read when a round aggregates, so setting it on an instance takes effect at
the next round.
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.core.aggregation import agc_clip_update
from fedml_tpu_torch.core.pytree import split_params, tree_weighted_mean


class FedAGCAPI(FedAvgAPI):
    #: AGC clipping ratio lambda (fork default 1e-2)
    clipping: float = 1e-2

    def _clip_stacked(self, gvars: dict, stacked: dict) -> dict:
        """Every stacked client's parameters clipped; buffers as they are."""
        params, _ = split_params(gvars)
        return {**stacked, **agc_clip_update(params, stacked, self.clipping, batch_dims=1)}

    def aggregate(self, variables, stacked_vars, counts, infos, rng, server_state):
        return tree_weighted_mean(self._clip_stacked(variables, stacked_vars), counts), \
            server_state

    def crosssilo_hooks(self) -> dict:
        return dict(client_transform=self._clip_stacked)


class CrossSiloFedAGCAPI(CrossSiloFedAvgAPI, FedAGCAPI):
    """FedAGC on the cross-silo mesh: each rank clips its clients' updates
    unit-wise before the weighted all-reduce (the ``client_transform`` of
    :meth:`FedAGCAPI.crosssilo_hooks`)."""
