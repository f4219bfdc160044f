"""FedProx, local proximal regularization (counterpart of
``fedml_tpu/algorithms/fedprox.py``; Li et al. 2018).

Each local step minimizes ``F_k(w) + (mu / 2) ||w - w_global||^2`` over the
parameters: the ``prox_mu`` of the shared trainer kwargs, so the plain and
the packed trainer both carry the term. Aggregation is FedAvg's.
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI


class FedProxAPI(FedAvgAPI):
    def _local_train_kwargs(self) -> dict:
        return dict(super()._local_train_kwargs(), prox_mu=self.config.fedprox_mu)


class CrossSiloFedProxAPI(CrossSiloFedAvgAPI, FedProxAPI):
    """FedProx on the cross-silo mesh: the proximal term is all client-side
    (the trainer kwargs) and the aggregate is the plain weighted
    all-reduce; the MRO composes the two."""
