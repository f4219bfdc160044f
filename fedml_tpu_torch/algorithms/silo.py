"""Silo training harness, the fork's cross-silo workflow (counterpart of
``fedml_tpu/algorithms/silo.py``; the fork's silo_fedavg.py:11-162,
silo_fedopt.py:13, silo_fednova.py:12, silo_fedagc.py:31 and
fedml_core/instances/ client.py:6-83).

Every client takes part in every round, the global validation metric drives
early stopping (``patience`` / ``min_delta``), the best model is saved to
``model_best.ckpt`` and the last to ``model_last.ckpt``
(``utils/checkpoint.py``), and per-client and ``GLOBAL`` histories are kept
under the JAX package's keys, with an optional ``history_save_fn``. A
harness over any algorithm API, since the fork's four silo classes differ
only in aggregation.

Per-client exit (``client_patience``, off by default): a client whose own
train accuracy stalls leaves the federation through
``FedAvgAPI.set_client_active``: its weight is 0 from the next round on
every schedule, and on the packed rounds its lane span is frozen. When every
client has left, training stops.
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Callable, Optional, Type

import numpy as np

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.parallel.local import finalize_metrics
from fedml_tpu_torch.utils.checkpoint import save_checkpoint

log = logging.getLogger(__name__)


class SiloRunner:
    """Early-stopping round loop around an algorithm API (``api_cls``, built
    with ``bundle`` and ``api_kw``, e.g. ``device``).

    Two stopping scopes: GLOBAL (``patience``), the fork's validation-driven
    stop when the global metric stalls (silo_fedavg.py:87-95); PER-CLIENT
    (``client_patience``), the client's exit above. Exits take effect from
    the next round."""

    def __init__(self, dataset: FedDataset, config: FedConfig,
                 api_cls: Type[FedAvgAPI] = FedAvgAPI, bundle=None, patience: int = 10,
                 min_delta: float = 0.0, model_dir: Optional[str] = None,
                 history_save_fn: Optional[Callable[[dict], None]] = None,
                 client_patience: Optional[int] = None, client_min_delta: float = 0.0,
                 **api_kw):
        # silo mode: every client participates every round (silo_fedavg.py:55)
        config = config.replace(
            client_num_per_round=min(config.client_num_in_total, dataset.num_clients),
            client_num_in_total=min(config.client_num_in_total, dataset.num_clients))
        self.api = api_cls(dataset, config, bundle, **api_kw)
        self.patience = patience
        self.min_delta = min_delta
        self.model_dir = model_dir
        self.history_save_fn = history_save_fn
        self.client_patience = client_patience
        self.client_min_delta = client_min_delta
        n = self.api.dataset.num_clients
        self._client_best = np.full(n, -np.inf)
        self._client_stall = np.zeros(n, np.int64)
        self._client_on = np.ones(n, bool)
        self.history: dict[str, list] = defaultdict(list)
        self.best_metric = -np.inf
        self.best_round = -1

    @staticmethod
    def _validation_metric(m: dict) -> float:
        """The early-stopping metric of an eval (the fork stops on
        validation accuracy, silo_fedavg.py:87-95): its accuracy, or -loss
        only when accuracy is absent (not when it is 0.0)."""
        acc = m.get("acc")
        if acc is not None:
            return float(acc)
        return -float(m.get("loss", np.inf))

    def _eval_client(self, idx: int) -> dict:
        ds, api = self.api.dataset, self.api
        x, y, m = api._to_device(ds.train_x[idx], ds.train_y[idx], ds.train_mask[idx],
                                 cast=False)
        sums = api._eval(api.variables, x, y, m)
        return finalize_metrics({k: v.item() for k, v in sums.items()})

    def _save(self, name: str, round_idx: int, extra: Optional[dict] = None) -> None:
        """Write ``model_dir/name``: the API's variables and server state
        at ``round_idx``."""
        save_checkpoint(os.path.join(self.model_dir, name), self.api.variables,
                        self.api.server_state, round_idx, extra=extra)

    def _client_evals(self, r: int) -> bool:
        """Each active client's train accuracy into its history, and its
        exit check; returns whether a client exited this round."""
        exited = False
        for c in range(self.api.dataset.num_clients):
            if not self._client_on[c]:
                # an exited client costs no eval; None keeps the lists aligned
                self.history[f"Client.{c}/Train/Acc"].append(None)
                continue
            cm = self._eval_client(c)
            self.history[f"Client.{c}/Train/Acc"].append(cm.get("acc"))
            if not self.client_patience:
                continue
            cv = self._validation_metric(cm)
            if cv > self._client_best[c] + self.client_min_delta:
                self._client_best[c] = cv
                self._client_stall[c] = 0
                continue
            self._client_stall[c] += 1
            if self._client_stall[c] >= self.client_patience:
                self._client_on[c] = False
                exited = True
                self.history[f"Client.{c}/stopped_round"].append(r)
                log.info("client %d early-exits at round %d (best %g)", c, r,
                         self._client_best[c])
        return exited

    def train(self) -> dict:
        cfg = self.api.config
        stall = 0
        for r in range(cfg.comm_round):
            # float(): with async_rounds the round returns a device scalar,
            # and this history is host data
            train_loss = float(self.api.run_round(r))
            gm = self.api.evaluate_global()
            val = self._validation_metric(gm)
            self.history["round"].append(r)
            self.history["GLOBAL/Train/Loss"].append(train_loss)
            self.history["GLOBAL/Test/Acc"].append(gm.get("acc"))
            self.history["GLOBAL/Test/Loss"].append(gm.get("loss"))
            if r % cfg.frequency_of_the_test == 0 and self._client_evals(r):
                if not self._client_on.any():
                    # everyone exited: stop instead of training no-op rounds
                    log.info("all clients early-exited at round %d", r)
                    self.api.set_client_active(None)
                    break
                self.api.set_client_active(self._client_on.astype(np.float32))
            if val > self.best_metric + self.min_delta:
                self.best_metric, self.best_round, stall = val, r, 0
                if self.model_dir:
                    self._save("model_best.ckpt", r, extra={"val": val})
            else:
                stall += 1
                if stall >= self.patience:
                    log.info("early stop at round %d (best %g @ %d)", r, self.best_metric,
                             self.best_round)
                    break
        if self.model_dir:
            self._save("model_last.ckpt", r)
        if self.history_save_fn:
            self.history_save_fn(dict(self.history))
        self.history["best_round"] = self.best_round
        self.history["best_metric"] = self.best_metric
        return dict(self.history)


def SiloFedAvg(dataset, config, **kw) -> SiloRunner:
    return SiloRunner(dataset, config, FedAvgAPI, **kw)


def SiloFedOpt(dataset, config, **kw) -> SiloRunner:
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI

    return SiloRunner(dataset, config, FedOptAPI, **kw)


def SiloFedProx(dataset, config, **kw) -> SiloRunner:
    from fedml_tpu_torch.algorithms.fedprox import FedProxAPI

    return SiloRunner(dataset, config, FedProxAPI, **kw)


def SiloFedNova(dataset, config, **kw) -> SiloRunner:
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI

    return SiloRunner(dataset, config, FedNovaAPI, **kw)


def SiloFedAGC(dataset, config, **kw) -> SiloRunner:
    from fedml_tpu_torch.algorithms.fedagc import FedAGCAPI

    return SiloRunner(dataset, config, FedAGCAPI, **kw)
