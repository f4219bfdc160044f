"""Optimizer update rules (the port's counterpart of the optax transforms
the JAX package calls: ``parallel/local.make_optimizer`` on the clients,
``algorithms/fedopt.make_server_optimizer`` on the server).

``torch.optim`` is not optax, so the port keeps its own rules:

- ``Adam(amsgrad=True)`` takes the max of the raw second moment, optax's
  ``amsgrad`` the max of the bias-corrected one;
- ``Adagrad`` starts its accumulator at 0 and adds 1e-10 outside the root,
  optax's at 0.1 with ``rsqrt(acc + 1e-7)``;
- ``AdamW``'s weight decay defaults to 1e-2, optax's to 1e-4;
- torch has no yogi.

A :class:`Transform` is two plain functions with an explicit state, as an
optax transform is: ``init(params, n_lanes=0) -> state`` and
``update(grads, state, params) -> (updates, state)``, over lists of tensors
in one fixed order. A state is a dict of per-parameter tensor lists
(``mu``, ``nu``, ...) and, for the bias-corrected rules, ``count``, an
int32 step count on the parameters' device; :func:`chain` keeps a tuple of
its members' states. Bias corrections ``1 - decay**count`` are computed in
f32 from the int32 count, as optax computes them.

Lanes: with ``n_lanes = L > 0`` every parameter is lane-folded (lane l's
block is rows ``l*n0 .. (l+1)*n0`` of the leading axis, one contiguous
block; ``ops/packed_conv.py``), every state tensor is folded like its
parameter and ``count`` is ``[L]``, one per lane: a lane's bias
corrections scale only its block. The packed program
(``parallel/packed.py``) re-initialises and freezes each lane's share of
the state through :func:`state_tensors`.

In place: ``update`` writes the new state into the state's own tensors
(the packed program holds views of them) and may overwrite ``grads``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

_INT32_MAX = 2**31 - 1


class Transform(NamedTuple):
    init: Callable[..., object]
    update: Callable[..., tuple]

    def __call__(self, params, n_lanes: int = 0) -> "Optimizer":
        """Bind to ``params`` (a list, or a module's ``parameters()``)."""
        return Optimizer(self, params, n_lanes)


class Optimizer:
    """A transform bound to parameters: holds the state; ``step()`` applies
    the update computed from each parameter's ``.grad``, in place.

    The state is allocated once, at the bind, and every update writes into
    it, so its tensors keep their addresses for the optimizer's life (what
    a captured step, ``parallel/capture.py``, needs). ``reset()`` puts the
    initial state back in place: a trainer binds one optimizer and resets it
    for each client instead of binding a new one."""

    def __init__(self, tx: Transform, params, n_lanes: int = 0):
        self.tx = tx
        self.params = list(params)
        self.state = tx.init(self.params, n_lanes)
        self.initial = [t.clone() for t in self.tensors()]    # reset()'s values

    def tensors(self) -> list:
        """Every state tensor (the folded ones, then the step counts)."""
        folded, counts = state_tensors(self.state)
        return folded + counts

    @torch.no_grad()
    def reset(self) -> None:
        """The initial state, in place: optax's init values (moments and
        momentum 0, adagrad's accumulator 0.1, yogi's moments 1e-6, step
        count 0)."""
        for t, v in zip(self.tensors(), self.initial):
            t.copy_(v)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drop every ``.grad``, or with ``set_to_none=False`` zero it in
        place (allocating it the first time), so the gradients too keep
        their addresses: backward then accumulates into them."""
        if set_to_none:
            for p in self.params:
                p.grad = None
            return
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            torch._foreach_zero_([p.grad for p in self.params])

    @torch.no_grad()
    def step(self) -> None:
        updates, self.state = self.tx.update([p.grad for p in self.params], self.state,
                                             self.params)
        torch._foreach_add_(self.params, updates)


def chain(*txs: Transform) -> Transform:
    def init(params, n_lanes=0):
        return tuple(t.init(params, n_lanes) for t in txs)

    def update(grads, state, params):
        new = []
        for t, s in zip(txs, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


def state_tensors(state) -> tuple[list, list]:
    """``(folded, counts)``: every per-parameter state tensor (folded like
    its parameter) and every step count, in a fixed order."""
    folded, counts = [], []

    def walk(s):
        if isinstance(s, tuple):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for k, v in s.items():
                (counts.append(v) if k == "count" else folded.extend(v))

    walk(state)
    return folded, counts


def _zeros(params, fill: float = 0.0) -> list:
    return [torch.full_like(p, fill, dtype=torch.float32) for p in params]


def _count(params, n_lanes: int) -> torch.Tensor:
    dev = params[0].device if params else None
    return torch.zeros((n_lanes,) if n_lanes else (), dtype=torch.int32, device=dev)


def _increment(count: torch.Tensor) -> None:
    """optax's ``safe_increment``: +1, saturating at the int32 maximum."""
    count.add_((count < _INT32_MAX).to(torch.int32))


def _bias_corrected(ts: Sequence[torch.Tensor], decay: float, count: torch.Tensor) -> list:
    """``t / (1 - decay**count)``, new tensors; per lane when ``count`` is
    ``[L]``."""
    bc = 1.0 - torch.pow(decay, count.to(torch.float32))
    if count.dim() == 0:
        return torch._foreach_div(ts, bc)
    out = torch._foreach_mul(ts, 1.0)
    L = count.numel()
    for lane in range(L):
        torch._foreach_div_([t.view(L, -1)[lane] for t in out], bc[lane])
    return out


def scale_by_learning_rate(lr: float) -> Transform:
    def update(grads, state, params):
        return torch._foreach_mul(grads, -lr), state

    return Transform(lambda params, n_lanes=0: {}, update)


def add_decayed_weights(wd: float) -> Transform:
    """``g + wd * p`` (the decay folds into the gradient)."""
    def update(grads, state, params):
        return torch._foreach_add(grads, params, alpha=wd), state

    return Transform(lambda params, n_lanes=0: {}, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    """Momentum: ``t = g + decay * t``; the update is ``t``, or with
    ``nesterov`` ``g + decay * t`` of the new ``t`` (optax's rule)."""
    def init(params, n_lanes=0):
        return {"trace": _zeros(params)}

    def update(grads, state, params):
        t = state["trace"]
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, grads)
        if not nesterov:
            return list(t), state
        u = torch._foreach_mul(t, decay)
        torch._foreach_add_(u, grads)
        return u, state

    return Transform(init, update)


def _moments(grads, state, b1: float, b2: float) -> None:
    """``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2 nu``, in place."""
    torch._foreach_mul_(state["mu"], b1)
    torch._foreach_add_(state["mu"], grads, alpha=1.0 - b1)
    torch._foreach_mul_(state["nu"], b2)
    torch._foreach_addcmul_(state["nu"], grads, grads, value=1.0 - b2)


def _adam_ratio(mu_hat: list, nu_hat: list, eps: float) -> list:
    """``mu_hat / (sqrt(nu_hat) + eps)``, written over ``mu_hat``."""
    den = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(mu_hat, den)
    return mu_hat


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params, n_lanes=0):
        return {"count": _count(params, n_lanes), "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params):
        _moments(grads, state, b1, b2)
        _increment(state["count"])
        mu_hat = _bias_corrected(state["mu"], b1, state["count"])
        nu_hat = _bias_corrected(state["nu"], b2, state["count"])
        return _adam_ratio(mu_hat, nu_hat, eps), state

    return Transform(init, update)


def scale_by_amsgrad(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """The max is taken over the bias-corrected second moment."""
    def init(params, n_lanes=0):
        return {"count": _count(params, n_lanes), "mu": _zeros(params), "nu": _zeros(params),
                "nu_max": _zeros(params)}

    def update(grads, state, params):
        _moments(grads, state, b1, b2)
        _increment(state["count"])
        mu_hat = _bias_corrected(state["mu"], b1, state["count"])
        nu_hat = _bias_corrected(state["nu"], b2, state["count"])
        torch._foreach_maximum_(state["nu_max"], nu_hat)
        return _adam_ratio(mu_hat, state["nu_max"], eps), state

    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> Transform:
    """Adagrad: ``g * rsqrt(acc + eps)`` with ``acc += g^2``. optax puts 0
    where ``acc`` is 0; with a positive start ``acc`` never is."""
    if not initial_accumulator_value > 0:
        raise ValueError("initial_accumulator_value must be > 0")

    def init(params, n_lanes=0):
        return {"sum_of_squares": _zeros(params, initial_accumulator_value)}

    def update(grads, state, params):
        acc = state["sum_of_squares"]
        torch._foreach_addcmul_(acc, grads, grads)
        inv = torch._foreach_add(acc, eps)
        torch._foreach_rsqrt_(inv)
        return torch._foreach_mul(grads, inv), state

    return Transform(init, update)


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
                  initial_accumulator_value: float = 1e-6) -> Transform:
    """Yogi: ``nu = nu - (1-b2) sign(nu - g^2) g^2``; both moments start at
    ``initial_accumulator_value``."""
    def init(params, n_lanes=0):
        return {"count": _count(params, n_lanes),
                "mu": _zeros(params, initial_accumulator_value),
                "nu": _zeros(params, initial_accumulator_value)}

    def update(grads, state, params):
        torch._foreach_mul_(state["mu"], b1)
        torch._foreach_add_(state["mu"], grads, alpha=1.0 - b1)
        g2 = torch._foreach_mul(grads, grads)
        sign = torch._foreach_sub(state["nu"], g2)
        torch._foreach_sign_(sign)
        torch._foreach_mul_(sign, g2)
        torch._foreach_add_(state["nu"], sign, alpha=-(1.0 - b2))
        _increment(state["count"])
        mu_hat = _bias_corrected(state["mu"], b1, state["count"])
        nu_hat = _bias_corrected(state["nu"], b2, state["count"])
        return _adam_ratio(mu_hat, nu_hat, eps), state

    return Transform(init, update)


# the optax aliases, with optax's defaults

def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Transform:
    if momentum:
        return chain(trace(momentum, nesterov), scale_by_learning_rate(lr))
    return scale_by_learning_rate(lr)


def adam(lr: float) -> Transform:
    return chain(scale_by_adam(), scale_by_learning_rate(lr))


def amsgrad(lr: float) -> Transform:
    return chain(scale_by_amsgrad(), scale_by_learning_rate(lr))


def adamw(lr: float, weight_decay: float = 1e-4) -> Transform:
    """Decoupled decay: ``-lr * (adam + weight_decay * p)``."""
    return chain(scale_by_adam(), add_decayed_weights(weight_decay), scale_by_learning_rate(lr))


def adagrad(lr: float) -> Transform:
    return chain(scale_by_rss(), scale_by_learning_rate(lr))


def yogi(lr: float) -> Transform:
    return chain(scale_by_yogi(), scale_by_learning_rate(lr))
