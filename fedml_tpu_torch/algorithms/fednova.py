"""FedNova, normalized averaging for heterogeneous local work (counterpart
of ``fedml_tpu/algorithms/fednova.py``; Wang et al. 2020).

From each client's step count ``tau_i`` (``LocalResult.tau``; in the packed
round ``epochs * steps_real`` from the plan):

    a_i      = tau_i                                          (plain SGD)
             = (tau_i - rho (1 - rho^tau_i) / (1 - rho)) / (1 - rho)  (momentum rho)
    tau_eff  = sum_i p_i a_i,          p_i = n_i / n_total
    w_next   = w_global - tau_eff * sum_i p_i (w_global - w_i) / a_i

over the parameters; the BatchNorm statistics take the weighted mean. With
homogeneous tau and no momentum this is FedAvg.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.core.pytree import split_params, tree_weighted_mean


def _nova_a(tau: torch.Tensor, rho: float) -> torch.Tensor:
    """FedNova's per-client normalizing coefficient a_i from step count tau_i."""
    if rho > 0.0:
        return (tau - rho * (1.0 - torch.pow(rho, tau)) / (1.0 - rho)) / (1.0 - rho)
    return tau


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


class FedNovaAPI(FedAvgAPI):
    def aggregate(self, variables, stacked_vars, counts, infos, rng, server_state):
        a = _nova_a(infos.tau.to(torch.float32), float(self.config.momentum))
        p = counts.to(torch.float32)
        p = p / torch.clamp(p.sum(), min=1e-12)
        tau_eff = (p * a).sum()
        coef = tau_eff * p / torch.clamp(a, min=1e-12)                  # [C]
        new_vars = tree_weighted_mean(stacked_vars, counts)
        for k, g in split_params(variables)[0].items():
            s = stacked_vars[k]
            g32 = g.to(torch.float32)
            delta = ((g32[None] - s.to(torch.float32)) * _bcast(coef, s)).sum(0)
            new_vars[k] = (g32 - delta).to(s.dtype)
        return new_vars, server_state

    def crosssilo_hooks(self) -> dict:
        """:meth:`aggregate` as weighted partial sums over the emits:

            pd = sum_i (n_i / a_i) (w_global - w_i)     (per parameter)
            na = sum_i  n_i a_i
            w_next = w_global - na * pd / n_total^2
        """
        rho = float(self.config.momentum)

        def reduce_extras(gvars, res, w):
            inv = w / torch.clamp(_nova_a(res.tau.to(torch.float32), rho), min=1e-12)
            pd = {k: ((g.to(torch.float32)[None] - res.variables[k].to(torch.float32))
                      * _bcast(inv, res.variables[k])).sum(0)
                  for k, g in split_params(gvars)[0].items()}
            return {"pd": pd, "na": (w * _nova_a(res.tau.to(torch.float32), rho)).sum()}

        def server_update(vars0, agg, extras, total, server_state, rng):
            den2 = max(float(total), 1e-12) ** 2
            new_vars = dict(agg)
            for k, d in extras["pd"].items():
                g = vars0[k]
                new_vars[k] = (g.to(torch.float32) - extras["na"] * d / den2).to(g.dtype)
            return new_vars, server_state

        return dict(reduce_extras=reduce_extras, server_update=server_update)


class CrossSiloFedNovaAPI(CrossSiloFedAvgAPI, FedNovaAPI):
    """FedNova on the cross-silo mesh: the partial sums of
    :meth:`FedNovaAPI.crosssilo_hooks` ride the same all-reduce as the
    variables."""
