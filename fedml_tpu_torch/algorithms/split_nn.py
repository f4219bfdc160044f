"""SplitNN: split learning with a client/server layer cut (counterpart of
``fedml_tpu/algorithms/split_nn.py``; reference
fedml_api/distributed/split_nn/).

The model's lower layers live on each client, the upper ones on the
server. In the reference, per minibatch the client sends activations
forward and receives their gradients back; here, as in the JAX package,
client forward, server forward, loss, one backward through both stages and
both optimizer updates are one step, on CUDA a replay of one captured
graph (``parallel/capture.py``). The relay ring is kept as the algorithm:
client k trains its epochs when it holds the token, then passes it to
k + 1. Each client keeps its own lower stage and optimizer state (never
aggregated); the server stage and its optimizer state carry across
clients. A client's state is copied into the client net's static tensors
before its epochs and back after.

An epoch's order is a permutation of the client's padded record axis
stable-sorted so the real records lead, and only the live steps
(``ceil(count / batch)``) run, which equals the JAX package's frozen
padding steps. The port draws the orders from ``core/rng.client_generator``
(cohort position = the client's index) or takes them from
``order_hook(round, client)`` (a list of per-epoch permutations).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.config import FedConfig, check_ported
from fedml_tpu_torch.core.rng import client_generator, init_generator
from fedml_tpu_torch.core.tasks import Task, get_task
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.parallel.capture import CapturedStep
from fedml_tpu_torch.parallel.local import make_optimizer, module_state, real_first

log = logging.getLogger(__name__)

#: records an evaluation call takes (eval-mode outputs do not depend on it)
EVAL_BATCH = 1024


class SplitEpoch:
    """One client-epoch of two-stage SGD on the bundles' modules:
    ``epoch(x, y, mask, count, perm) -> mean loss over the live steps``.
    ``c_opt`` / ``s_opt`` are the stages' bound optimizers; ``program`` the
    step (static inputs bx, by, bm)."""

    def __init__(self, client_bundle: ModelBundle, server_bundle: ModelBundle, task: Task,
                 tx_client: optim.Transform, tx_server: optim.Transform, batch_size: int):
        self.client, self.server = client_bundle.module, server_bundle.module
        self.task, self.batch_size = task, batch_size
        self.c_opt = tx_client(self.client.parameters())
        self.s_opt = tx_server(self.server.parameters())
        for opt in (self.c_opt, self.s_opt):
            opt.zero_grad(set_to_none=False)
        self.program: Optional[CapturedStep] = None

    def _step(self, bx, by, bm):
        self.client.train()
        self.server.train()
        for opt in (self.c_opt, self.s_opt):
            opt.zero_grad(set_to_none=False)
        loss = self.task.loss(self.server(self.client(bx)), by, bm)
        loss.backward()
        self.c_opt.step()
        self.s_opt.step()
        return loss.detach()

    def _program(self, x, y, mask) -> CapturedStep:
        if self.program is None:
            bs = self.batch_size
            inputs = [torch.empty((bs,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
                      for a in (x, y, mask)]
            self.program = CapturedStep(
                self._step, inputs,
                lambda: module_state(self.client, self.c_opt) + module_state(self.server,
                                                                            self.s_opt))
        return self.program

    def __call__(self, x, y, mask, count: int, perm: torch.Tensor) -> torch.Tensor:
        bs = self.batch_size
        prog = self._program(x, y, mask)
        order = real_first(perm.to(x.device), mask)
        steps = -(-int(count) // bs)
        total = torch.zeros((), device=x.device)
        for s in range(steps):
            idx = order[s * bs:(s + 1) * bs]
            for src, dst in zip((x, y, mask), prog.inputs):
                torch.index_select(src, 0, idx, out=dst)
            total = total + prog()
        return total / max(steps, 1)


def make_splitnn_epoch_fn(client_bundle: ModelBundle, server_bundle: ModelBundle, task: Task,
                          tx_client: optim.Transform, tx_server: optim.Transform,
                          batch_size: int) -> SplitEpoch:
    """The counterpart of the JAX package's jitted epoch scan: a
    :class:`SplitEpoch` over the two bundles' modules, which hold the
    stages' state."""
    return SplitEpoch(client_bundle, server_bundle, task, tx_client, tx_server, batch_size)


class SplitNNAPI:
    """Relay-ring split learning (reference SplitNNAPI.py:15-39): each
    client holds its own lower stage, never aggregated, and trains
    ``epochs`` epochs when it holds the token; the server validates through
    the last client's stage after each ring."""

    def __init__(self, dataset: FedDataset, config: FedConfig, client_bundle: ModelBundle,
                 server_bundle: ModelBundle, device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[Callable] = None):
        check_ported(config)
        self.dataset, self.config = dataset, config
        self.client_bundle, self.server_bundle = client_bundle, server_bundle
        self.device = default_device(device)
        self.order_hook = order_hook
        self.task = get_task(dataset.task, dataset.class_num)
        # the reference's SGD for both stages, from the config
        if int(dataset.train_x.shape[1]) % config.batch_size:
            raise ValueError("the padded record axis must be a multiple of batch_size")
        tx = make_optimizer(config.client_optimizer, config.lr, config.momentum, config.wd)
        n = dataset.num_clients
        self.client_vars = [client_bundle.init(init_generator(config.seed, 1, i), self.device)
                            for i in range(n)]
        server_bundle.init(init_generator(config.seed, 2), self.device)
        self._epoch = make_splitnn_epoch_fn(client_bundle, server_bundle, self.task, tx, tx,
                                            config.batch_size)
        #: each client's optimizer state (``c_opt.tensors()`` order)
        self.client_opts = [[t.clone() for t in self._epoch.c_opt.initial] for _ in range(n)]
        self._data: dict = {}
        self.history: dict[str, list] = {"epoch_loss": [], "val_acc": []}

    @property
    def server_vars(self) -> dict:
        """A copy of the server stage's state dict (its module holds it)."""
        return {k: v.detach().clone() for k, v in self.server_bundle.module.state_dict().items()}

    @server_vars.setter
    def server_vars(self, state: dict) -> None:
        self.server_bundle.module.load_state_dict(state)

    def _client_tensors(self) -> list:
        sd = self.client_bundle.module.state_dict(keep_vars=True)
        return [sd[k] for k in self.client_vars[0]] + self._epoch.c_opt.tensors()

    @torch.no_grad()
    def _load_client(self, k: int) -> None:
        torch._foreach_copy_(self._client_tensors(),
                             list(self.client_vars[k].values()) + self.client_opts[k])

    @torch.no_grad()
    def _store_client(self, k: int) -> None:
        torch._foreach_copy_(list(self.client_vars[k].values()) + self.client_opts[k],
                             self._client_tensors())

    def _client_data(self, k: int) -> tuple:
        if k not in self._data:
            x, y, m, count = self.dataset.client_slice_cached(k)
            self._data[k] = tuple(torch.from_numpy(np.array(a[0])).to(self.device)
                                  for a in (x, y, m)) + (int(count[0]),)
        return self._data[k]

    def _orders(self, round_idx: int, k: int, n_pad: int) -> list:
        if self.order_hook is not None:
            return list(self.order_hook(round_idx, k))
        g = client_generator(self.config.seed, round_idx, k)
        return [torch.randperm(n_pad, generator=g) for _ in range(self.config.epochs)]

    @torch.no_grad()
    def _eval_client(self, k: int) -> float:
        """Server-side validation through client k's stage on the global
        test pool (the reference validates when a client ends its turn)."""
        d = self.dataset
        sums = {"correct": 0.0, "count": 0.0}
        for s in range(0, len(d.test_x), EVAL_BATCH):
            x, y, m = (torch.from_numpy(np.ascontiguousarray(a[s:s + EVAL_BATCH])).to(self.device)
                       for a in (d.test_x, d.test_y, d.test_mask))
            acts = self.client_bundle.apply_eval(self.client_vars[k], x)
            metrics = self.task.metrics(self.server_bundle.apply_eval(self.server_bundle.module,
                                                                      acts), y, m)
            for key in sums:
                sums[key] += float(metrics[key])
        return sums["correct"] / max(sums["count"], 1.0)

    def run_round(self, round_idx: int) -> list:
        """One ring: every client in turn trains its epochs; returns each
        client's last-epoch loss (device tensors)."""
        losses = []
        for k in range(self.dataset.num_clients):
            x, y, m, count = self._client_data(k)
            self._load_client(k)
            loss = torch.zeros((), device=self.device)
            for perm in self._orders(round_idx, k, x.shape[0]):
                loss = self._epoch(x, y, m, count, perm)
            self._store_client(k)
            losses.append(loss)
        return losses

    def train(self) -> dict:
        c = self.config
        n = self.dataset.num_clients
        for r in range(c.comm_round):
            self.history["epoch_loss"] += [float(v) for v in self.run_round(r)]
            self.history["val_acc"].append(self._eval_client(n - 1))
            log.info("splitnn round %d val_acc %.4f", r, self.history["val_acc"][-1])
        return self.history
