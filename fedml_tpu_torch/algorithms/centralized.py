"""Centralized (non-FL) baseline over the same federated dataset
(counterpart of ``fedml_tpu/algorithms/centralized.py``; reference
fedml_api/centralized/centralized_trainer.py:9-104 and
CI-script-fedavg.sh:43-47): the other half of the federated == centralized
gate.

The federation's records are merged into one logical client
(:func:`merge_clients`), placed on the device once, and trained each round
by the same local trainer the clients use (``parallel/local.py``), with
its per-epoch shuffles drawn from ``core/rng.client_generator(seed, round,
0)``. :class:`StreamingCentralizedTrainer` streams the merged records
through the native host batcher instead (``native/HostPipeline``), one
step a batch, and with a ``('batch',)`` mesh steps through
``parallel/dataparallel.make_dp_train_step``, each rank taking its rows of
the seed-deterministic batch.

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
from fedml_tpu_torch.ops.dropout import client_key, step_keys
from fedml_tpu_torch.parallel.local import (finalize_metrics, local_train_kwargs, make_eval_fn,
                                            make_local_train_fn, make_optimizer)
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


class StreamingCentralizedTrainer:
    """Centralized training for datasets that do not fit on the device
    (``fedml_tpu/algorithms/centralized.py:StreamingCentralizedTrainer``):
    the merged real records are batched by the native threaded pipeline
    (``native/HostPipeline``, seeded by ``config.seed``, whole batches
    only), each batch shipped to the device while the previous step runs
    (``data/pipeline.device_stream``), and one SGD step taken a batch.

    ``mesh`` (a ``('batch',)`` mesh, ``parallel/dataparallel.batch_mesh``)
    makes each step data parallel: every rank streams the same batches and
    takes its rows, BatchNorm is synchronized and the gradients are
    all-reduced (``make_dp_train_step``); the device is the mesh's. A
    dropout model's step s takes ``step_keys(client_key(seed, 0, 0), 0,
    s)``."""

    def __init__(self, dataset: FedDataset, config: FedConfig,
                 bundle: Optional[ModelBundle] = None, n_threads: int = 4, depth: int = 6,
                 mesh=None, device: Optional[Union[str, torch.device]] = None):
        from fedml_tpu_torch.parallel.dataparallel import make_dp_train_step

        check_centralized(config)
        self.dataset, self.config, self.mesh = dataset, config, mesh
        self.device = mesh.device if mesh is not None else default_device(device)
        self.bundle = bundle or create_model(
            config.model, dataset.class_num, input_shape=dataset.train_x.shape[2:] or None)
        self.task = get_task(dataset.task, dataset.class_num)
        self.bundle.init(config.seed, self.device)
        self.n_threads, self.depth = n_threads, depth
        x, y, mask = merge_clients(dataset, config.batch_size)
        keep = mask > 0
        self.x, self.y = x[keep], y[keep]
        tx = make_optimizer(config.client_optimizer, config.lr, config.momentum, config.wd)
        self._step = make_dp_train_step(
            self.bundle, self.task, tx, mesh, grad_clip=config.grad_clip,
            compute_dtype=torch.bfloat16 if config.dtype == "bfloat16" else None)
        self._rows = (mesh.block(config.batch_size, mesh.axis_names[0]) if mesh is not None
                      else slice(None))
        # drop_last fixes the batch size: one all-ones mask, made once
        self._mask = torch.ones(config.batch_size, device=self.device)[self._rows]
        self._eval = make_eval_fn(self.bundle, self.task)
        self._dev_test = None

    @property
    def variables(self) -> dict:
        """A copy of the model's state dict (the module holds it)."""
        return {k: v.detach().clone() for k, v in self.bundle.module.state_dict().items()}

    @variables.setter
    def variables(self, state: dict) -> None:
        self.bundle.module.load_state_dict(state)

    def evaluate_global(self) -> dict:
        if self._dev_test is None:
            ds = self.dataset
            self._dev_test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                                   for a in (ds.test_x, ds.test_y, ds.test_mask))
        sums = self._eval(self.bundle.module, *self._dev_test)
        return finalize_metrics({k: v.item() for k, v in sums.items()})

    def train(self) -> dict:
        from fedml_tpu_torch.data.pipeline import device_stream
        from fedml_tpu_torch.native import HostPipeline

        c = self.config
        history = {"round": [], "Test/Acc": [], "Test/Loss": []}
        x, y = self.x, self.y
        if len(x) < c.batch_size:      # tiny sets: repeat to one batch
            reps = -(-c.batch_size // len(x))
            x = np.concatenate([x] * reps)[:c.batch_size]
            y = np.concatenate([y] * reps)[:c.batch_size]
        base = client_key(c.seed, 0, 0)
        step_no = 0
        with HostPipeline(x, y, c.batch_size, seed=c.seed, n_threads=self.n_threads,
                          depth=self.depth, drop_last=True) as pipe:
            for r in range(c.comm_round):
                for _ in range(c.epochs):
                    for bx, by in device_stream(pipe, device=self.device):
                        key = None
                        if self.bundle.uses_dropout:
                            key = torch.tensor(int(step_keys(base, 0, step_no)),
                                               device=self.device)
                        self._step(bx[self._rows], by[self._rows], self._mask, key)
                        step_no += 1
                if r % c.frequency_of_the_test == 0 or r == c.comm_round - 1:
                    m = self.evaluate_global()
                    history["round"].append(r)
                    history["Test/Acc"].append(m.get("acc"))
                    history["Test/Loss"].append(m.get("loss"))
        return history
