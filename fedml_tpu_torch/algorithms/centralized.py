"""Centralized (non-FL) baseline over the same federated dataset
(counterpart of ``fedml_tpu/algorithms/centralized.py``; reference
fedml_api/centralized/centralized_trainer.py:9-104 and
CI-script-fedavg.sh:43-47): the other half of the federated == centralized
gate.

The federation's records are merged into one logical client
(:func:`merge_clients`), placed on the device once, and trained each round
by the same local trainer the clients use (``parallel/local.py``), with
its per-epoch shuffles drawn from ``core/rng.client_generator(seed, round,
0)``. The JAX package's ``StreamingCentralizedTrainer`` (the native batch
pipeline) is not ported.

Fields that only the federated loop reads (checkpoints, profiles, metric
logging, the cohort schedule, packing, elastic rounds) raise here when set
away from their defaults, where the JAX trainer ignores them
(:data:`FEDERATED_ONLY_FIELDS`).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core.config import DEFAULTS, FedConfig, check_ported
from fedml_tpu_torch.core.rng import client_generator
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.data.batching import pad_to_multiple
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.parallel.local import (finalize_metrics, local_train_kwargs, make_eval_fn,
                                            make_local_train_fn)
from fedml_tpu_torch.utils.dtypes import host_bf16_cast


def merge_clients(dataset: FedDataset, batch_size: int):
    """The stacked per-client arrays flattened back into one masked pool:
    the real records in client order, padded to a multiple of
    ``batch_size`` by repeating the first ones (mask 0)."""
    C, n_pad = dataset.train_mask.shape
    flat_x = dataset.train_x.reshape((C * n_pad,) + dataset.train_x.shape[2:])
    flat_y = dataset.train_y.reshape((C * n_pad,) + dataset.train_y.shape[2:])
    flat_m = dataset.train_mask.reshape(-1)
    keep = flat_m > 0
    x, y = flat_x[keep], flat_y[keep]
    n = pad_to_multiple(len(x), batch_size)
    pad = n - len(x)
    if pad:
        x = np.concatenate([x, x[:pad]])
        y = np.concatenate([y, y[:pad]])
    m = np.concatenate([np.ones(len(flat_m[keep]), np.float32), np.zeros(pad, np.float32)])
    return x, y, m


#: fields the centralized loop does not read; set away from its default,
#: each raises at construction
FEDERATED_ONLY_FIELDS = (
    "checkpoint_dir", "resume_from", "profile_dir", "enable_wandb", "pack_lanes",
    "packed_conv", "async_rounds", "stream_aggregate", "cohort_chunk", "cohort_policy", "failure_prob",
    "host_pipeline_depth", "host_pipeline_workers", "norm_bound", "stddev", "attack_type",
    "poison_frac", "group_num", "group_comm_round")


def check_centralized(config: FedConfig) -> None:
    """Raise ``NotImplementedError`` naming every field of ``config`` that
    the centralized loop would ignore: the port's unported fields, the
    federated-only ones and ``device_data="off"`` (the merged pool always
    lives on the device)."""
    check_ported(config)
    bad = [f"{name}={getattr(config, name)!r}" for name in FEDERATED_ONLY_FIELDS
           if getattr(config, name) != DEFAULTS[name]]
    if config.device_data == "off":
        bad.append("device_data='off'")
    if bad:
        raise NotImplementedError("the centralized trainer does not read " + ", ".join(bad)
                                  + " (only the federated loop does)")


class CentralizedTrainer:
    def __init__(self, dataset: FedDataset, config: FedConfig,
                 bundle: Optional[ModelBundle] = None,
                 device: Optional[Union[str, torch.device]] = None):
        check_centralized(config)
        self.device = default_device(device)
        self.dataset = dataset
        self.config = config
        self.bundle = bundle or create_model(
            config.model, dataset.class_num, input_shape=dataset.train_x.shape[2:] or None)
        self.task = get_task(dataset.task, dataset.class_num)
        self.variables = self.bundle.init(config.seed, self.device)
        x, y, mask = merge_clients(dataset, config.batch_size)
        self._train = make_local_train_fn(self.bundle, self.task, **local_train_kwargs(config))
        self._eval = make_eval_fn(self.bundle, self.task)
        # the merged pool goes to the device once
        self._dev = (host_bf16_cast(x, config.dtype).to(self.device),
                     torch.from_numpy(y).to(self.device), torch.from_numpy(mask).to(self.device))
        self._count = int(mask.sum())
        self._dev_test = None

    def evaluate_global(self) -> dict:
        if self._dev_test is None:
            ds = self.dataset
            self._dev_test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                                   for a in (ds.test_x, ds.test_y, ds.test_mask))
        sums = self._eval(self.variables, *self._dev_test)
        return finalize_metrics({k: v.item() for k, v in sums.items()})

    def train(self) -> dict:
        c = self.config
        history = {"round": [], "Test/Acc": [], "Test/Loss": []}
        dx, dy, dm = self._dev
        for r in range(c.comm_round):
            res = self._train(self.variables, dx, dy, dm, self._count,
                              generator=client_generator(c.seed, r, 0))
            self.variables = res.variables
            if r % c.frequency_of_the_test == 0 or r == c.comm_round - 1:
                m = self.evaluate_global()
                history["round"].append(r)
                history["Test/Acc"].append(m.get("acc"))
                history["Test/Loss"].append(m.get("loss"))
        return history
