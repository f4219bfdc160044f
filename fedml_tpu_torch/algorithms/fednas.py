"""FedNAS: federated DARTS architecture search (counterpart of
``fedml_tpu/algorithms/fednas.py``; reference fedml_api/distributed/fednas/).

Every sampled client runs a local differentiable search from the global
weights and alphas with fresh optimizer states: each live minibatch step is
an architecture (alpha) step, then a weight step with the new alphas. The
server takes the sample-weighted mean of the weights (BN running
statistics included) and of the alphas, and records the derived genotype
each round.

- **First-order architect** (``unrolled`` off): the alpha gradient of the
  training loss on the same batch.
- **Unrolled architect**: each batch splits into even (train) and odd
  (validation) slots; the alpha gradient is that of the validation loss at
  the weights after one unrolled SGD step,
  ``p - lr * (rho * trace + g + wd * p)`` with the optimizer's real momentum
  trace, differentiated exactly (``torch.autograd.grad(create_graph=True)``
  for ``g``, ``torch.func.functional_call`` at the unrolled weights), not by
  the reference's finite difference. The weight step then takes the train
  half. Through ``bn_impl="pallas"`` the second-order term passes through
  the BN kernel's twice-differentiable wrapper (``ops/batchnorm.py``).

The alpha step's forwards do not move the BN running statistics (JAX
discards them): the step saves them first and puts them back. The weight
optimizer is ``add_decayed_weights(3e-4)`` then SGD momentum 0.9 at
``config.lr``, its gradient clipped at the global norm ``grad_clip or 5``;
the architect is ``add_decayed_weights(arch_wd)`` then Adam(``arch_lr``),
both from ``core/optim.py`` (optax's rules).

As every training step of the port, a search step is one program: on CUDA a
replay of one captured CUDA graph (``parallel/capture.py``), the alpha step,
its buffers' restore, both optimizer updates and the clip inside it. Only
the live steps (``ceil(count / batch)``) run, which equals JAX's frozen
padding steps. The orders are drawn from ``core/rng.client_generator`` or
taken from ``order_hook(round, cohort position)``, as in FedAvg.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.config import FedConfig, check_ported
from fedml_tpu_torch.core.rng import client_generator, init_generator, sample_clients
from fedml_tpu_torch.core.tasks import classification
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.models.darts import (DartsNetwork, DartsSearchNetwork, derive_genotype,
                                          init_alphas)
from fedml_tpu_torch.parallel.capture import CapturedStep
from fedml_tpu_torch.parallel.crosssilo import all_reduce_flat
from fedml_tpu_torch.parallel.local import clip_grads_, module_state, real_first
from fedml_tpu_torch.parallel.mesh import ClientMesh, client_mesh

log = logging.getLogger(__name__)

# the weight optimizer's hyperparameters (reference main_fednas defaults),
# shared by the optimizer and the unrolled architect's inner step
W_MOMENTUM = 0.9
W_WEIGHT_DECAY = 3e-4
#: records an evaluation call takes (eval-mode outputs do not depend on it)
EVAL_BATCH = 256
ALPHA_KEYS = ("normal", "reduce")


class FedNASAPI:
    """Standalone-simulation FedNAS search phase."""

    def __init__(self, dataset: FedDataset, config: FedConfig, channels: int = 8,
                 layers: int = 4, steps: int = 2, multiplier: int = 2, arch_lr: float = 3e-4,
                 arch_wd: float = 1e-3, unrolled: Optional[bool] = None, bn_impl: str = "xla",
                 device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[Callable] = None, capture: bool = True):
        check_ported(config)
        self.dataset, self.config = dataset, config
        self.device = default_device(device)
        self.steps_cfg, self.multiplier, self.bn_impl = steps, multiplier, bn_impl
        #: second-order (unrolled) architect: ``config.unrolled`` unless overridden
        self.unrolled = bool(config.unrolled) if unrolled is None else bool(unrolled)
        if self.unrolled and config.batch_size < 2:
            raise ValueError("the unrolled architect splits each batch into train/val halves; "
                             "batch_size must be >= 2")
        if int(dataset.train_x.shape[1]) % config.batch_size:
            raise ValueError("the padded record axis must be a multiple of batch_size")
        self.order_hook, self.capture = order_hook, capture
        self.module = DartsSearchNetwork(channels, layers, steps, multiplier,
                                         output_dim=dataset.class_num,
                                         in_features=int(dataset.train_x.shape[-1]),
                                         bn_impl=bn_impl)
        self.module.reset_parameters(init_generator(config.seed, 8))
        self.module.to(self.device)
        self.variables = {k: v.detach().clone() for k, v in self.module.state_dict().items()}
        self.alphas = init_alphas(init_generator(config.seed, 7), steps, self.device)
        # the search's live alphas (the architect's parameters, static tensors)
        self._alphas = {k: v.clone().requires_grad_(True) for k, v in self.alphas.items()}
        self._params = dict(self.module.named_parameters())
        self._wopt = optim.chain(optim.add_decayed_weights(W_WEIGHT_DECAY),
                                 optim.sgd(config.lr, W_MOMENTUM))(self._params.values())
        self._aopt = optim.chain(optim.add_decayed_weights(arch_wd),
                                 optim.adam(arch_lr))(self._alphas.values())
        for opt in (self._wopt, self._aopt):
            opt.zero_grad(set_to_none=False)
        #: the running statistics (the state dict's buffers)
        self._buffers = [v for k, v in self.module.state_dict(keep_vars=True).items()
                         if k not in self._params]
        self._program: Optional[CapturedStep] = None
        self.genotypes: list = []
        self.history: list[dict] = []

    # -- the search step -----------------------------------------------------

    def _trace(self) -> list:
        """The weight optimizer's momentum trace (its only per-parameter
        state), in parameter order."""
        return optim.state_tensors(self._wopt.state)[0]

    def _loss(self, x, y, m, params: Optional[dict] = None) -> torch.Tensor:
        logits = (self.module(x, self._alphas) if params is None
                  else functional_call(self.module, params, (x, self._alphas)))
        return classification.loss(logits, y, m)

    def _alpha_grads(self, bx, by, bm) -> tuple:
        """The architect's gradient; an alpha no cell reads (the normal
        ones when every cell reduces) gets zeros, as in JAX."""
        alphas = list(self._alphas.values())
        if not self.unrolled:
            return torch.autograd.grad(self._loss(bx, by, bm), alphas, allow_unused=True,
                                       materialize_grads=True)
        params = list(self._params.values())
        g = torch.autograd.grad(self._loss(bx[0::2], by[0::2], bm[0::2]), params,
                                create_graph=True)
        lr = self.config.lr
        unrolled = {name: p - lr * (W_MOMENTUM * t + gg + W_WEIGHT_DECAY * p)
                    for (name, p), gg, t in zip(self._params.items(), g, self._trace())}
        return torch.autograd.grad(self._loss(bx[1::2], by[1::2], bm[1::2], unrolled), alphas,
                                   allow_unused=True, materialize_grads=True)

    def _step(self, bx, by, bm, saved):
        """One search step: the alpha step (its forwards' running
        statistics put back after it), then the weight step with the new
        alphas, clipped. Returns the weight step's loss."""
        self.module.train()
        torch._foreach_copy_(saved, self._buffers)
        ga = self._alpha_grads(bx, by, bm)
        torch._foreach_copy_(self._buffers, saved)
        torch._foreach_copy_([a.grad for a in self._alphas.values()], list(ga))
        self._aopt.step()
        if self.unrolled:
            bx, by, bm = bx[0::2], by[0::2], bm[0::2]
        loss = self._loss(bx, by, bm)
        params = list(self._params.values())
        torch._foreach_copy_([p.grad for p in params],
                             list(torch.autograd.grad(loss, params)))
        clip_grads_(params, self.config.grad_clip or 5.0)
        self._wopt.step()
        return loss.detach()

    def program(self) -> CapturedStep:
        """The search step program, built at its first use; its static
        inputs are (bx, by, bm) and a copy of the running statistics."""
        if self._program is None:
            d, bs = self.dataset, self.config.batch_size
            inputs = [torch.empty((bs,) + a.shape[2:], device=self.device,
                                  dtype=torch.from_numpy(a[:0, :0]).dtype)
                      for a in (d.train_x, d.train_y, d.train_mask)]
            saved = [b.clone() for b in self._buffers]

            def state():
                return (module_state(self.module, self._wopt) + list(self._alphas.values())
                        + self._aopt.tensors() + [a.grad for a in self._alphas.values()]
                        + saved)

            # one eager warm-up step: a full-width search step is 53,633 (first-order)
            # to 178,552 (unrolled) launches, seconds each when run eagerly
            self._program = CapturedStep(lambda bx, by, bm: self._step(bx, by, bm, saved),
                                         inputs, state, capture=self.capture, warmup_steps=1)
        return self._program

    # -- a client's search -----------------------------------------------------

    def _orders(self, round_idx: int, pos: int, n_pad: int) -> list:
        if self.order_hook is not None:
            return list(self.order_hook(round_idx, pos))
        g = client_generator(self.config.seed, round_idx, pos)
        return [torch.randperm(n_pad, generator=g) for _ in range(self.config.epochs)]

    @torch.no_grad()
    def _load(self, variables: dict, alphas: dict) -> None:
        sd = self.module.state_dict(keep_vars=True)
        torch._foreach_copy_([sd[k] for k in variables] + list(self._alphas.values()),
                             list(variables.values()) + [alphas[k] for k in self._alphas])
        self._wopt.reset()
        self._aopt.reset()

    def local_search(self, round_idx: int, pos: int, x, y, mask, count: int) -> torch.Tensor:
        """One client's search from the global state (loaded into the net
        and the live alphas, fresh optimizer states); returns its mean loss
        over the last epoch. The client's state stays in the net."""
        self._load(self.variables, self.alphas)
        bs = self.config.batch_size
        steps = -(-int(count) // bs)
        prog = self.program()
        total = torch.zeros((), device=self.device)
        for perm in self._orders(round_idx, pos, x.shape[0]):
            order = real_first(perm.to(self.device), mask)
            total = torch.zeros((), device=self.device)
            for s in range(steps):
                idx = order[s * bs:(s + 1) * bs]
                for src, dst in zip((x, y, mask), prog.inputs):
                    torch.index_select(src, 0, idx, out=dst)
                total = total + prog()
        return total / max(steps, 1)

    # -- the round -------------------------------------------------------------

    def sampled(self, round_idx: int) -> np.ndarray:
        d, cfg = self.dataset, self.config
        population = min(cfg.client_num_in_total, d.num_clients)
        return sample_clients(round_idx, population, min(cfg.client_num_per_round, population),
                              seed=cfg.seed)

    def _positions(self, cohort: int) -> range:
        """The cohort positions this process searches (all of them)."""
        return range(cohort)

    def _reduce(self, tensors: list) -> list:
        """The round's partial sums summed over the processes (one here)."""
        return [t.to(torch.float32) for t in tensors]

    def run_round(self, round_idx: int) -> torch.Tensor:
        """One search round: every sampled client's search, then the
        sample-weighted mean of the variables and of the alphas. Returns the
        weighted mean of the clients' last-epoch losses (a device tensor)."""
        sampled = self.sampled(round_idx)
        cx, cy, cm, counts = self.dataset.client_slice(sampled)
        names = list(self.variables)
        sd = self.module.state_dict(keep_vars=True)
        acc = [torch.zeros_like(self.variables[k], dtype=torch.float32) for k in names]
        acc += [torch.zeros_like(self.alphas[k]) for k in ALPHA_KEYS]
        loss_sum = torch.zeros((1,), device=self.device)
        for pos in self._positions(len(sampled)):
            x, y, m = (torch.from_numpy(np.ascontiguousarray(a[pos])).to(self.device)
                       for a in (cx, cy, cm))
            loss = self.local_search(round_idx, pos, x, y, m, int(counts[pos]))
            w = float(counts[pos])
            with torch.no_grad():
                torch._foreach_add_(acc, [sd[k].to(torch.float32) for k in names]
                                    + [self._alphas[k] for k in ALPHA_KEYS], alpha=w)
            loss_sum += w * loss
        reduced = self._reduce(acc + [loss_sum])
        total = max(float(np.asarray(counts, np.float64).sum()), 1e-12)
        self.variables = {k: (r / total).to(self.variables[k].dtype)
                          for k, r in zip(names, reduced)}
        self.alphas = {k: r / total for k, r in zip(ALPHA_KEYS, reduced[len(names):])}
        return reduced[-1][0] / total

    # -- evaluation and the loop ----------------------------------------------

    @torch.no_grad()
    def evaluate(self) -> dict:
        """The search net at the global variables and alphas over the test
        pool, eval mode (running statistics): sums of correct predictions,
        CE and records."""
        d = self.dataset
        self.module.load_state_dict(self.variables)
        self.module.eval()
        sums = {"correct": 0.0, "loss_sum": 0.0, "count": 0.0}
        for s in range(0, len(d.test_x), EVAL_BATCH):
            x, y, m = (torch.from_numpy(np.ascontiguousarray(a[s:s + EVAL_BATCH])).to(self.device)
                       for a in (d.test_x, d.test_y, d.test_mask))
            for k, v in classification.metrics(self.module(x, self.alphas), y, m).items():
                sums[k] += float(v)
        return sums

    def train(self) -> dict:
        cfg = self.config
        last: dict = {}
        t0 = time.time()
        for rnd in range(cfg.comm_round):
            loss = self.run_round(rnd)
            g = derive_genotype(self.alphas, self.steps_cfg, self.multiplier)
            self.genotypes.append(g)
            if rnd % cfg.frequency_of_the_test == 0 or rnd == cfg.comm_round - 1:
                sums = self.evaluate()
                count = max(sums["count"], 1.0)
                last = {"round": rnd, "Test/Acc": sums["correct"] / count,
                        "Test/Loss": sums["loss_sum"] / count, "Train/Loss": float(loss),
                        "genotype": g}
                self.history.append(last)
                log.info("FedNAS round %d acc %.4f genotype %s", rnd, last["Test/Acc"], g)
        if self.history:
            self.history[-1]["rounds_per_sec"] = cfg.comm_round / (time.time() - t0)
        return last

    def build_discrete_network(self, channels: int = 16, layers: int = 8) -> DartsNetwork:
        """FedNAS phase 2: the searched genotype as a fixed network for
        federated training (uninitialised: ``reset_parameters`` draws its
        weights)."""
        g = self.genotypes[-1] if self.genotypes else derive_genotype(
            self.alphas, self.steps_cfg, self.multiplier)
        return DartsNetwork(g, channels=channels, layers=layers,
                            output_dim=self.dataset.class_num,
                            in_features=int(self.dataset.train_x.shape[-1]),
                            bn_impl=self.bn_impl)


class CrossSiloFedNASAPI(FedNASAPI):
    """FedNAS on the client mesh (``parallel/mesh.client_mesh``; one rank
    without a process group): each rank searches its block of the cohort,
    and the weights, the alphas and the loss ride ONE flat SUM all-reduce
    (``parallel/crosssilo.all_reduce_flat``), as the JAX package's weighted
    psums ride one fused all-reduce. The effective cohort must be a
    multiple of the mesh's ``clients`` axis."""

    def __init__(self, dataset: FedDataset, config: FedConfig,
                 mesh: Optional[ClientMesh] = None, device=None, **kw):
        self.mesh = mesh or client_mesh(device=device)
        n_axis = self.mesh.shape["clients"]
        population = min(config.client_num_in_total, dataset.num_clients)
        cohort = min(config.client_num_per_round, population)
        if cohort % n_axis:
            raise ValueError(f"effective cohort size ({cohort}) must be a multiple of the mesh "
                             f"'clients' axis ({n_axis})")
        super().__init__(dataset, config, device=self.mesh.device, **kw)

    def _positions(self, cohort: int) -> range:
        block = self.mesh.block(cohort)
        return range(block.start, block.stop)

    def _reduce(self, tensors: list) -> list:
        return all_reduce_flat(self.mesh, tensors)
