"""FedOpt, server-side adaptive optimization (counterpart of
``fedml_tpu/algorithms/fedopt.py``; Reddi et al. 2020).

The server treats ``w_global - w_avg`` as a pseudo-gradient and feeds it to
a server optimizer whose state persists across rounds
(``self.server_state["opt"]``). The step touches the parameters only; the
BatchNorm running statistics take the weighted mean. Server optimizers
(``server_optimizer``): sgd (FedAvgM when ``server_momentum > 0``), adam
(FedAdam), adagrad (FedAdagrad), yogi (FedYogi), each with optax's
defaults (``core/optim.py``).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.pytree import split_params, tree_weighted_mean


def make_server_optimizer(name: str, lr: float, momentum: float = 0.0) -> optim.Transform:
    rules = {"sgd": lambda: optim.sgd(lr, momentum), "adam": lambda: optim.adam(lr),
             "adagrad": lambda: optim.adagrad(lr), "yogi": lambda: optim.yogi(lr)}
    rule = rules.get(name.lower())
    if rule is None:
        raise ValueError(f"unknown server optimizer {name!r}")
    return rule()


def server_step(tx: optim.Transform, names: list, variables0: dict, agg: dict,
                state: dict) -> dict:
    """One server step from ``variables0`` along ``variables0 - agg`` over
    the parameters ``names`` (the order of the state's lists; the state is
    updated in place); every other leaf of the result is ``agg``'s."""
    with torch.no_grad():
        old = [variables0[n] for n in names]
        pseudo_grad = torch._foreach_sub(old, [agg[n] for n in names])
        updates, state["opt"] = tx.update(pseudo_grad, state["opt"], old)
        new = torch._foreach_add(old, updates)
    return {**agg, **dict(zip(names, new))}


class FedOptAPI(FedAvgAPI):
    """FedAvg with a persistent server optimizer over the pseudo-gradient."""

    def __init__(self, dataset, config, bundle=None, **kw):
        self._server_tx = make_server_optimizer(config.server_optimizer, config.server_lr,
                                                config.server_momentum)
        super().__init__(dataset, config, bundle, **kw)

    def init_server_state(self) -> dict:
        params, _ = split_params(self.variables)
        self._param_names = list(params)
        return {"opt": self._server_tx.init(list(params.values()))}

    def aggregate(self, variables, stacked_vars, counts, infos, rng, server_state):
        avg = tree_weighted_mean(stacked_vars, counts)
        return (server_step(self._server_tx, self._param_names, variables, avg, server_state),
                server_state)

    def crosssilo_hooks(self) -> dict:
        tx = self._server_tx

        def server_update(vars0, agg, extras, total, server_state, rng):
            return server_step(tx, self._param_names, vars0, agg, server_state), server_state

        return dict(server_update=server_update)


class CrossSiloFedOptAPI(CrossSiloFedAvgAPI, FedOptAPI):
    """FedOpt on the cross-silo mesh: the weighted all-reduce gives every
    rank the client average, then the server step runs on every rank on
    the reduced values (the hooks of :meth:`FedOptAPI.crosssilo_hooks`),
    the server state on each rank's device."""
