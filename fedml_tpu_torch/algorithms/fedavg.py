"""FedAvg, standalone simulation (counterpart of
``fedml_tpu/algorithms/fedavg.py:FedAvgAPI``, plain round path only).

Each round samples a cohort (numpy, bit-equal to the JAX package), trains
it client by client from the global state on the device, and takes the
sample-weighted mean of the clients' state dicts, BatchNorm running
statistics included. The stacked client dataset is placed on the device
once (unless ``device_data="off"``), as ``_maybe_place_train_data`` does.

Not ported yet, and refused with ``NotImplementedError``: the packed-lanes
schedule (``pack_lanes > 0``), injected failures (``failure_prob > 0``) and
streaming aggregation. The bucketed and grouped schedules of the JAX package
are not needed: running only each client's live steps (parallel/local.py)
already skips the padding they trim. The cross-silo paradigm is a later
port.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core.aggregation import fedavg_aggregate
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import tree_stack
from fedml_tpu_torch.core.rng import client_generator, sample_clients
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.parallel.local import (finalize_metrics, make_eval_fn,
                                            make_local_train_fn)

log = logging.getLogger(__name__)

#: ``order_hook(round_idx, cohort_pos) -> orders``, ``orders[e]`` a
#: LongTensor permutation of n_pad for epoch e
OrderHook = Callable[[int, int], Sequence[torch.Tensor]]


class FedAvgAPI:
    def __init__(self, dataset: FedDataset, config: FedConfig,
                 bundle: Optional[ModelBundle] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[OrderHook] = None):
        if config.pack_lanes > 0:
            raise NotImplementedError("pack_lanes > 0: the packed schedule is not ported yet")
        if config.failure_prob > 0:
            raise NotImplementedError("failure_prob > 0: elastic rounds are not ported yet")
        if config.stream_aggregate != "off":
            raise NotImplementedError("stream_aggregate: streaming rounds are not ported yet")
        self.device = default_device(device)
        self.dataset = dataset
        self.config = config
        self.bundle = bundle or create_model(
            config.model, dataset.class_num, input_shape=dataset.train_x.shape[2:] or None)
        self.task = get_task(dataset.task, dataset.class_num)
        self.order_hook = order_hook
        self.variables = self.bundle.init(config.seed, self.device)
        self._local_train = self.build_local_train()
        self._eval = make_eval_fn(self.bundle, self.task)
        self._dev_train = self._maybe_place_train_data()
        self._dev_test = None
        self._n_total = min(config.client_num_in_total, dataset.num_clients)
        self._cohort = min(config.client_num_per_round, dataset.num_clients)
        self.history: dict[str, list] = {"round": [], "Test/Acc": [], "Test/Loss": []}

    def _to_device(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray, cast: bool = True):
        """Host arrays -> device tensors; ``cast`` puts float inputs in the
        training compute dtype (eval reads the f32 pool, as in JAX)."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if cast and self.config.dtype == "bfloat16" and xt.is_floating_point():
            xt = xt.to(torch.bfloat16)
        return (xt, torch.from_numpy(np.ascontiguousarray(y)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(mask)).to(self.device))

    def _maybe_place_train_data(self):
        """The whole stacked client dataset on the device, once; None with
        ``device_data="off"`` (each round then ships its cohort)."""
        if self.config.device_data == "off":
            return None
        ds = self.dataset
        return self._to_device(ds.train_x, ds.train_y, ds.train_mask)

    def build_local_train(self):
        c = self.config
        return make_local_train_fn(
            self.bundle, self.task, optimizer=c.client_optimizer, lr=c.lr,
            momentum=c.momentum, wd=c.wd, epochs=c.epochs, batch_size=c.batch_size,
            grad_clip=c.grad_clip,
            compute_dtype=torch.bfloat16 if c.dtype == "bfloat16" else None)

    def aggregate(self, stacked_vars: dict, counts: torch.Tensor) -> dict:
        """Sample-weighted average (fedavg_api.py:100-115)."""
        return fedavg_aggregate(stacked_vars, counts)

    def sample(self, round_idx: int) -> np.ndarray:
        return sample_clients(round_idx, self._n_total, self._cohort, self.config.seed)

    def round_counts(self, round_idx: int) -> tuple:
        """(real, executed) training examples one epoch of this round
        processes: the cohort's real record counts, and the batch slots the
        live steps execute (padding in each client's last batch included)."""
        counts = np.asarray(self.dataset.train_counts, np.int64)[self.sample(round_idx)]
        bs = self.config.batch_size
        return int(counts.sum()), int(sum(-(-int(c) // bs) * bs for c in counts))

    def run_round(self, round_idx: int) -> "float | torch.Tensor":
        """Train one round; returns the count-weighted train loss — a float,
        or with ``config.async_rounds`` a 0-dim device tensor (no host sync)."""
        c = self.config
        sampled = self.sample(round_idx)
        counts = np.asarray(self.dataset.train_counts, np.int64)[sampled]
        if self._dev_train is not None:
            tx, ty, tm = self._dev_train
            idx = torch.from_numpy(sampled).to(self.device)
            cx, cy, cm = tx[idx], ty[idx], tm[idx]
        else:
            cx, cy, cm, _ = self.dataset.client_slice(sampled)
            cx, cy, cm = self._to_device(cx, cy, cm)
        results = []
        for i in range(len(sampled)):
            orders = self.order_hook(round_idx, i) if self.order_hook is not None else None
            results.append(self._local_train(
                self.variables, cx[i], cy[i], cm[i], int(counts[i]),
                client_generator(c.seed, round_idx, i), orders))
        w = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        self.variables = self.aggregate(tree_stack([r.variables for r in results]), w)
        losses = torch.stack([r.train_loss for r in results])
        train_loss = (losses * w).sum() / torch.clamp(w.sum(), min=1e-12)
        return train_loss if c.async_rounds else float(train_loss)

    def evaluate_global(self) -> dict:
        if self._dev_test is None:
            ds = self.dataset
            self._dev_test = self._to_device(ds.test_x, ds.test_y, ds.test_mask, cast=False)
        x, y, m = self._dev_test
        sums = self._eval(self.variables, x, y, m)
        return finalize_metrics({k: v.item() for k, v in sums.items()})

    def train(self) -> dict:
        c = self.config
        t0 = time.perf_counter()
        for r in range(c.comm_round):
            loss = self.run_round(r)
            if r % c.frequency_of_the_test == 0 or r == c.comm_round - 1:
                m = self.evaluate_global()
                self.history["round"].append(r)
                self.history["Test/Acc"].append(m.get("acc"))
                self.history["Test/Loss"].append(m.get("loss"))
                log.info("round %d: train loss %.4f, test acc %.4f",
                         r, float(loss), m.get("acc", float("nan")))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.history["rounds_per_sec"] = c.comm_round / max(time.perf_counter() - t0, 1e-12)
        return self.history
