"""Classical vertical federated learning: feature-partitioned parties
(counterpart of ``fedml_tpu/algorithms/vfl.py``; reference
fedml_api/standalone/classical_vertical_fl/).

Per batch, every party computes its logit component U_p = LeakyReLU(x_p @
W_p + b_p) @ H_p (+ the guest's bias), the guest sums them, computes the
BCE loss and the common gradient dL/dU, and every party backprops its own
stack from it. Each party has its own SGD(momentum 0.9, weight decay 0.01)
(``core/optim.py``: ``add_decayed_weights(0.01)`` then ``sgd``). A party's
parameters are a dict of tensors, as the JAX package's pytrees: ``local_w``
[d_p, hidden], ``local_b`` [hidden], ``head_w`` [hidden, 1] and, on the
guest (party 0), ``head_b`` [1].

Three executions of the same math from one init:

1. **fused** (:class:`VFLAPI`): one backward through the summed logit
   routes dL/dU to every party; on CUDA each step is a replay of one
   captured graph (``parallel/capture.py``);
2. **party-sharded** (:func:`make_sharded_vfl_step`): the parties stacked
   with their input width zero-padded (:func:`pad_party_params`), each rank
   of the mesh holding its block of them; the logit contributions are
   summed by one all-reduce over ``torch.distributed`` and each rank
   backprops its parties from the common gradient. One rank (all parties
   on one card) needs no process group;
3. **protocol** (:class:`VFLGuestParty`, :class:`VFLHostParty`,
   :class:`VerticalFederatedLearning`): explicit parties exchanging
   components and the common gradient.

The JAX package's sharded step drifts from its fused one (~9e-4 in loss,
an expected failure of tests/test_vfl.py); the port's is held to the fused
step at 1e-5.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.rng import init_generator
from fedml_tpu_torch.data.vertical import VerticalDataset
from fedml_tpu_torch.parallel.capture import CapturedStep
from fedml_tpu_torch.parallel.crosssilo import all_reduce_flat

PARAM_KEYS = ("local_w", "local_b", "head_w", "head_b")


def _party_optimizer(lr: float) -> optim.Transform:
    """torch.optim.SGD(momentum=0.9, weight_decay=0.01)'s semantics (the
    reference's vfl_models_standalone.py:13,46)."""
    return optim.chain(optim.add_decayed_weights(0.01), optim.sgd(lr, momentum=0.9))


def init_party_params(generator: Optional[torch.Generator], input_dim: int, hidden_dim: int,
                      guest: bool, device=None) -> dict:
    """Uniform(+-1/sqrt(fan_in)) weights, zero biases; ``head_b`` on the
    guest only."""
    lim1, lim2 = 1.0 / np.sqrt(input_dim), 1.0 / np.sqrt(hidden_dim)

    def uniform(shape, lim):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim

    p = {"local_w": uniform((input_dim, hidden_dim), lim1),
         "local_b": torch.zeros(hidden_dim),
         "head_w": uniform((hidden_dim, 1), lim2)}
    if guest:
        p["head_b"] = torch.zeros(1)
    return p if device is None else {k: v.to(device) for k, v in p.items()}


def party_component(params: dict, x: torch.Tensor) -> torch.Tensor:
    """One party's logit contribution U_p [B, 1]."""
    z = F.leaky_relu(x @ params["local_w"] + params["local_b"])
    u = z @ params["head_w"]
    return u + params["head_b"] if "head_b" in params else u


def bce_with_logits(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    l, t = u.to(torch.float32), y.to(torch.float32)
    return torch.mean(torch.clamp_min(l, 0.0) - l * t + torch.log1p(torch.exp(-l.abs())))


def _apply(tx: optim.Transform, params: list, grads: list, state) -> None:
    """One update of ``tx`` on ``params`` in place (its state too)."""
    updates, _ = tx.update(list(grads), state, params)
    with torch.no_grad():
        torch._foreach_add_(params, updates)


class VFLAPI:
    """Fused standalone VFL (execution 1)."""

    def __init__(self, dataset: VerticalDataset, hidden_dim: int = 16, lr: float = 0.01,
                 batch_size: int = 64, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.dataset = dataset
        self.hidden, self.lr, self.batch_size = hidden_dim, lr, batch_size
        self.device = default_device(device)
        self.params = [{k: v.requires_grad_(True) for k, v in init_party_params(
            init_generator(seed, 3, p), d, hidden_dim, p == 0, self.device).items()}
            for p, d in enumerate(dataset.party_dims)]
        self._tx = _party_optimizer(lr)
        self.opts = [self._tx(list(p.values())) for p in self.params]
        for opt in self.opts:
            opt.zero_grad(set_to_none=False)
        self._program: Optional[CapturedStep] = None
        self.history: list[dict] = []

    def _step(self, *batch):
        *xs, y = batch
        for opt in self.opts:
            opt.zero_grad(set_to_none=False)
        loss = bce_with_logits(sum(party_component(p, x) for p, x in zip(self.params, xs))[:, 0],
                               y)
        loss.backward()
        for opt in self.opts:
            opt.step()
        return loss.detach()

    def program(self, batch: int) -> CapturedStep:
        """The fused step over static inputs (each party's [batch, d_p]
        rows, the labels), built at its first use."""
        if self._program is None:
            dev = self.device
            inputs = [torch.empty((batch, d), device=dev) for d in self.dataset.party_dims]
            inputs.append(torch.empty((batch,), device=dev))

            def state():
                return ([t for p in self.params for t in p.values()]
                        + [t for o in self.opts for t in o.tensors()]
                        + [t.grad for p in self.params for t in p.values()])

            self._program = CapturedStep(self._step, inputs, state)
        return self._program

    def step(self, xs: Sequence[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
        """One fused step on a batch (each party's rows, the labels);
        returns its loss (a copy: a replay overwrites the graph's output)."""
        prog = self.program(len(y))
        with torch.no_grad():
            torch._foreach_copy_(prog.inputs, [*xs, y])
        return prog().clone()

    def fit(self, epochs: int = 10, seed: int = 0) -> dict:
        """``epochs`` epochs of shuffled full batches (numpy's
        ``default_rng(seed)`` orders, the JAX package's), each ending in an
        evaluation; returns the last epoch's record."""
        d = self.dataset
        n = len(d.train_y)
        bs = min(self.batch_size, n)
        steps = n // bs
        rng = np.random.default_rng(seed)
        xs_all = [torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                  for p in d.train_parts]
        y_all = torch.from_numpy(np.ascontiguousarray(d.train_y)).to(self.device)
        last: dict = {}
        for ep in range(epochs):
            order = torch.from_numpy(rng.permutation(n)[: steps * bs].reshape(steps, bs))
            order = order.to(self.device)
            losses = torch.stack([self.step([x[order[b]] for x in xs_all], y_all[order[b]])
                                  for b in range(steps)])
            last = {"epoch": ep, "Train/Loss": float(losses.mean()), **self.evaluate()}
            self.history.append(last)
        return last

    @torch.no_grad()
    def predict_logits(self, parts: Sequence[np.ndarray]) -> np.ndarray:
        u = sum(party_component(p, torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
                for p, x in zip(self.params, parts))
        return u[:, 0].cpu().numpy()

    def evaluate(self) -> dict:
        d = self.dataset
        u = self.predict_logits(d.test_parts)
        pred = (u > 0).astype(np.float32)
        return {"Test/Acc": float((pred == d.test_y).mean()),
                "Test/Loss": float(bce_with_logits(torch.from_numpy(u),
                                                   torch.from_numpy(d.test_y)))}


# -- execution 2: the party-sharded step ---------------------------------------------------

def pad_party_params(params_list: Sequence[dict], party_dims: Sequence[int]) -> dict:
    """Every party's parameters stacked ``[P, ...]``, the input widths
    zero-padded to ``max(party_dims)``; ``head_b`` stacked with zeros for
    the hosts and ``head_b_mask`` [P, 1] (1 on the guest) selecting it."""
    P, d_max = len(params_list), max(party_dims)
    hid = params_list[0]["local_w"].shape[1]
    dev = params_list[0]["local_w"].device
    with torch.no_grad():
        local_w = torch.zeros((P, d_max, hid), device=dev)
        for p, prm in enumerate(params_list):
            local_w[p, :party_dims[p]] = prm["local_w"]
        return {
            "local_w": local_w,
            "local_b": torch.stack([p["local_b"] for p in params_list]),
            "head_w": torch.stack([p["head_w"] for p in params_list]),
            "head_b": torch.stack([p.get("head_b", torch.zeros(1, device=dev))
                                   for p in params_list]),
            "head_b_mask": torch.tensor([[1.0]] + [[0.0]] * (P - 1), device=dev),
        }


def make_sharded_vfl_step(mesh, lr: float):
    """``(step, tx)``: ``step(params, opt_state, xs, y) -> loss`` on this
    rank's block of the stacked parties (``pad_party_params`` rows
    ``mesh.block(P)``; ``xs`` their zero-padded inputs [P_rank, B, d_max]),
    ``opt_state = tx.init(list(params.values()))``. The parties' logit
    contributions are summed locally and over the ranks by one all-reduce
    (``parallel/crosssilo.all_reduce_flat``), every rank computes the same
    loss and common gradient dL/dU, and each backprops its parties from it
    and updates them in place. ``head_b_mask`` is structural: no gradient,
    no decay, never updated."""
    tx = _party_optimizer(lr)

    def step(params: dict, opt_state, xs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        leaves = [params[k].detach().requires_grad_(True) for k in PARAM_KEYS]
        w, b, hw, hb = leaves
        z = F.leaky_relu(torch.bmm(xs, w) + b[:, None, :])
        u = torch.bmm(z, hw) + (hb * params["head_b_mask"])[:, None, :]
        (u_total,) = all_reduce_flat(mesh, [u.detach().sum(0)])
        u_total.requires_grad_(True)
        loss = bce_with_logits(u_total[:, 0], y)
        (common,) = torch.autograd.grad(loss, u_total)
        grads = torch.autograd.grad(u, leaves, common.expand_as(u))
        names = list(params)
        by_name = dict(zip(PARAM_KEYS, grads))
        grads = [by_name.get(k, torch.zeros_like(params[k])) for k in names]
        updates, _ = tx.update(grads, opt_state, [params[k] for k in names])
        with torch.no_grad():
            for k, upd in zip(names, updates):
                if k != "head_b_mask":
                    params[k].add_(upd)
        return loss.detach()

    return step, tx


# -- execution 3: the guest/host protocol ------------------------------------------------

class VFLHostParty:
    """Host: no labels; sends logit components, learns from the common
    gradient."""

    def __init__(self, params: dict, lr: float):
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self._tx = _party_optimizer(lr)
        self.opt_state = self._tx.init(list(self.params.values()))
        self._x = None

    def set_batch(self, x) -> None:
        self._x = torch.as_tensor(x, device=self.params["local_w"].device)

    @torch.no_grad()
    def send_components(self) -> torch.Tensor:
        return party_component(self.params, self._x)

    def receive_gradients(self, common_grad: torch.Tensor) -> None:
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        grads = torch.autograd.grad(party_component(leaves, self._x), list(leaves.values()),
                                    common_grad)
        _apply(self._tx, list(self.params.values()), grads, self.opt_state)

    @torch.no_grad()
    def predict(self, x) -> torch.Tensor:
        return party_component(self.params, torch.as_tensor(x, device=self.params["local_w"].device))


class VFLGuestParty:
    """Guest: holds the labels; fuses the components, computes the loss and
    the common gradient dL/dU, updates its own stack."""

    def __init__(self, params: dict, lr: float):
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self._tx = _party_optimizer(lr)
        self.opt_state = self._tx.init(list(self.params.values()))
        self._x = self._y = self._common = None
        self._components: list = []
        self.loss: Optional[float] = None

    def set_batch(self, x, y) -> None:
        dev = self.params["local_w"].device
        self._x, self._y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)

    def receive_components(self, component_list: Sequence[torch.Tensor]) -> None:
        self._components = list(component_list)

    def fit(self) -> None:
        others = sum(self._components) if self._components else 0.0
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        u_total = party_component(leaves, self._x) + others
        loss = bce_with_logits(u_total[:, 0], self._y)
        grads = torch.autograd.grad(loss, [u_total] + list(leaves.values()))
        self._common = grads[0].detach()
        _apply(self._tx, list(self.params.values()), grads[1:], self.opt_state)
        self.loss = float(loss.detach())
        self._components = []

    def send_gradients(self) -> torch.Tensor:
        return self._common

    @torch.no_grad()
    def predict(self, x, component_list: Sequence[torch.Tensor]) -> np.ndarray:
        dev = self.params["local_w"].device
        u = party_component(self.params, torch.as_tensor(x, device=dev)) + sum(component_list)
        return torch.sigmoid(u[:, 0]).cpu().numpy()


class VerticalFederatedLearning:
    """The coordinator (reference vfl.py:21-55 fit/predict)."""

    def __init__(self, guest: VFLGuestParty, hosts: dict):
        self.guest = guest
        self.hosts = dict(hosts)

    def fit(self, X_guest, y, host_X_dict: dict, global_step: int = 0) -> float:
        if set(host_X_dict) != set(self.hosts):
            raise ValueError(f"host_X_dict must cover every host: have {sorted(self.hosts)}, "
                             f"got {sorted(host_X_dict)}")
        self.guest.set_batch(X_guest, y)
        for hid, x in host_X_dict.items():
            self.hosts[hid].set_batch(x)
        self.guest.receive_components([h.send_components() for h in self.hosts.values()])
        self.guest.fit()
        common = self.guest.send_gradients()
        for h in self.hosts.values():
            h.receive_gradients(common)
        return self.guest.loss

    def predict(self, X_guest, host_X_dict: dict) -> np.ndarray:
        comps = [self.hosts[h].predict(x) for h, x in host_X_dict.items()]
        return self.guest.predict(X_guest, comps)


def build_protocol_vfl(dataset: VerticalDataset, hidden_dim: int = 16, lr: float = 0.01,
                       seed: int = 0, device=None) -> VerticalFederatedLearning:
    """The protocol's parties from :class:`VFLAPI`'s init of ``seed``."""
    params = [init_party_params(init_generator(seed, 3, p), d, hidden_dim, p == 0,
                                default_device(device))
              for p, d in enumerate(dataset.party_dims)]
    hosts = {p: VFLHostParty(params[p], lr) for p in range(1, dataset.num_parties)}
    return VerticalFederatedLearning(VFLGuestParty(params[0], lr), hosts)
