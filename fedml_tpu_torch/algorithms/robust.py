"""FedAvg-robust, a backdoor attacker against robust aggregation
(counterpart of ``fedml_tpu/algorithms/robust.py``; reference
fedml_api/distributed/fedavg_robust/).

One client is a backdoor attacker: ``poison_frac`` of its real records get
a pixel trigger stamped on and are relabeled to ``target_class``
(FedAvgRobustTrainer.py:14-25). The server defends with norm-difference
clipping of each client's update (``norm_bound``) and weak-DP gaussian noise
on the aggregate (``stddev``; FedAvgRobustAggregator.py:14-60 with
robustness/robust_aggregation.py:38-55). ``evaluate_backdoor`` measures the
targeted success: the share of triggered non-target test inputs classified
as the target.

The poison is stamped on the host dataset before ``FedAvgAPI.__init__``,
so the rows placed on the device carry it. On the packed round the clip is
the ``client_transform`` at each lane's emit (one client's state at a
time, never a folded tensor) and the noise the ``server_update`` on the
aggregate, drawn from the round's server generator; the cross-silo mesh
runs the same hooks around its all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.core.aggregation import add_dp_noise, clip_update_by_norm, robust_aggregate
from fedml_tpu_torch.parallel.local import LocalResult, finalize_metrics


def stamp_trigger(x: np.ndarray, value: float = 2.5, size: int = 3) -> np.ndarray:
    """Stamp a bright square in the top-left corner (image tensors [..., H, W, C]
    or flat vectors — flat vectors get their first ``size*size`` features set)."""
    x = np.array(x, copy=True)
    if x.ndim >= 3:
        x[..., :size, :size, :] = value
    else:
        x[..., : size * size] = value
    return x


class FedAvgRobustAPI(FedAvgAPI):
    """FedAvg with one backdoor attacker and clip/DP server defenses."""

    def __init__(self, dataset, config, bundle=None, *, attacker_idx: int = 0,
                 target_class: int = 1, poison_frac: Optional[float] = None,
                 trigger_value: float = 2.5, trigger_size: int = 3, **kw):
        poison_frac = config.poison_frac if poison_frac is None else poison_frac
        self.trigger_value = trigger_value
        self.trigger_size = trigger_size
        if poison_frac > 0:
            dataset = self._poison(dataset, attacker_idx, target_class, poison_frac,
                                   trigger_value, trigger_size)
        self.attacker_idx = attacker_idx
        self.target_class = target_class
        super().__init__(dataset, config, bundle, **kw)

    @staticmethod
    def _poison(dataset, attacker_idx: int, target_class: int, frac: float,
                trigger_value: float = 2.5, trigger_size: int = 3):
        tx = np.array(dataset.train_x, copy=True)
        ty = np.array(dataset.train_y, copy=True)
        # a fraction of the attacker's REAL records (real rows come first in
        # the padded layout), not of the padded length
        n_real = int(dataset.train_mask[attacker_idx].sum())
        n_poison = int(n_real * frac)
        tx[attacker_idx, :n_poison] = stamp_trigger(
            tx[attacker_idx, :n_poison], trigger_value, trigger_size)
        ty[attacker_idx, :n_poison] = target_class
        return dataclasses.replace(dataset, train_x=tx, train_y=ty)

    def aggregate(self, variables, stacked_vars, counts, infos: LocalResult, rng, server_state):
        c = self.config
        return robust_aggregate(variables, stacked_vars, counts, norm_bound=c.norm_bound,
                                dp_stddev=c.stddev, rng=rng), server_state

    def crosssilo_hooks(self) -> dict:
        """``aggregate`` split around the weighted sum: the clip of each
        client's update before it (a rank's clients on the mesh, a lane's
        emitted member on the packed round), the noise on the aggregate
        after it, from the round's server generator, the same on every rank."""
        norm_bound, stddev = self.config.norm_bound, self.config.stddev

        def client_transform(gvars, stacked):
            if norm_bound is None:
                return stacked
            return clip_update_by_norm(gvars, stacked, norm_bound, batch_dims=1)

        def server_update(vars0, agg, extras, total, server_state, rng):
            if stddev is not None:
                agg = add_dp_noise(agg, stddev, rng)
            return agg, server_state

        return dict(client_transform=client_transform, server_update=server_update)

    def evaluate_backdoor(self) -> dict:
        """Targeted-class success on triggered test inputs (reference
        FedAvgRobustAggregator's backdoor eval on the targeted task)."""
        ds = self.dataset
        keep = ds.test_y != self.target_class      # non-target samples only
        x = stamp_trigger(np.asarray(ds.test_x)[keep], self.trigger_value, self.trigger_size)
        y = np.full(x.shape[0], self.target_class, ds.test_y.dtype)
        m = np.asarray(ds.test_mask)[keep]
        sums = self._eval(self.variables, *self._to_device(x, y, m, cast=False))
        out = finalize_metrics({k: v.item() for k, v in sums.items()})
        return {"backdoor_success": out.get("acc", 0.0)}


class CrossSiloFedAvgRobustAPI(CrossSiloFedAvgAPI, FedAvgRobustAPI):
    """FedAvg-robust on the cross-silo mesh: each rank clips its clients'
    updates before the all-reduce, and every rank adds the same noise to
    the reduced aggregate (:meth:`FedAvgRobustAPI.crosssilo_hooks`). The
    attacker is one of the silos; the backdoor eval is unchanged."""
