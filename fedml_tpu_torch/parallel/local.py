"""Per-client local training (counterpart of ``fedml_tpu/parallel/local.py``).

The JAX package scans every minibatch step of a padded client, freezing
params and optimizer state on the dead steps past ``ceil(count / batch)``.
Here only those live steps run, which gives the same result: a frozen step
changes nothing. The last live batch still holds padding records (mask 0);
they enter BatchNorm's batch statistics as they do in JAX, and only the loss
masks them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from fedml_tpu_torch.core.tasks import Task
from fedml_tpu_torch.models import ModelBundle


def make_optimizer(name: str, lr: float, momentum: float = 0.0, wd: float = 0.0
                   ) -> Callable[..., torch.optim.Optimizer]:
    """Client optimizer factory: returns ``make(params)``. ``sgd`` with
    ``weight_decay`` equals optax ``chain(add_decayed_weights(wd),
    sgd(lr, momentum))``: decay folds into the gradient before momentum, and
    the first momentum buffer is the first gradient in both."""
    if name.lower() != "sgd":
        raise NotImplementedError(f"client optimizer {name!r} is not ported yet (sgd only)")

    def make(params):
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=wd)

    return make


class LocalResult(NamedTuple):
    variables: dict              # the client's state dict after training
    train_loss: torch.Tensor     # mean loss over the last epoch
    tau: float                   # optimizer steps taken (FedNova)
    first_loss: Optional[torch.Tensor] = None   # mean loss over the first epoch


def make_batch_sgd_step(bundle: ModelBundle, task: Task, *,
                        grad_clip: Optional[float] = None):
    """ONE minibatch SGD step on ``bundle.module``:
    ``step(module, opt, bx, by, bm) -> loss``. The optional clip scales
    every gradient by ``min(1, clip / max(global_norm, 1e-12))``, as the
    JAX step does (``clip_grad_norm_`` adds 1e-6 instead)."""

    def batch_step(module, opt, bx, by, bm):
        module.train()
        loss = task.loss(module(bx), by, bm)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grad_clip:
            grads = [p.grad for p in module.parameters() if p.grad is not None]
            gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        opt.step()
        return loss.detach()

    return batch_step


def make_local_train_fn(
    bundle: ModelBundle,
    task: Task,
    *,
    optimizer: str = "sgd",
    lr: float = 0.01,
    momentum: float = 0.0,
    wd: float = 0.0,
    epochs: int = 1,
    batch_size: int = 32,
    grad_clip: Optional[float] = None,
    compute_dtype=None,
):
    """Build ``local_train(variables, x, y, mask, count, generator=None,
    orders=None) -> LocalResult``.

    ``x/y/mask`` are one client's padded tensors [n_pad, ...] on the
    training device, with n_pad a multiple of ``batch_size``; ``count`` is
    its real record count. Each epoch draws a permutation of n_pad (from
    ``generator``, or ``orders[e]`` when given — the hook parity tests use
    to inject the JAX package's permutations) and stable-sorts it so the
    real records lead."""
    make_opt = make_optimizer(optimizer, lr, momentum, wd)
    batch_step = make_batch_sgd_step(bundle, task, grad_clip=grad_clip)

    def local_train(variables: dict, x, y, mask, count: int,
                    generator: Optional[torch.Generator] = None,
                    orders: Optional[Sequence[torch.Tensor]] = None) -> LocalResult:
        n_pad = x.shape[0]
        if n_pad % batch_size:
            raise ValueError(f"n_pad={n_pad} is not a multiple of batch_size={batch_size}")
        module = bundle.module
        module.load_state_dict(variables)
        opt = make_opt(module.parameters())
        steps_real = -(-int(count) // batch_size)
        if compute_dtype is not None and x.is_floating_point():
            x = x.to(compute_dtype)
        ep_losses = []
        for e in range(epochs):
            perm = orders[e] if orders is not None else torch.randperm(n_pad, generator=generator)
            perm = perm.to(x.device)
            order = perm[torch.argsort(-mask[perm], stable=True)]
            total = torch.zeros((), device=x.device)
            for s in range(steps_real):
                idx = order[s * batch_size:(s + 1) * batch_size]
                total = total + batch_step(module, opt, x[idx], y[idx], mask[idx])
            ep_losses.append(total / max(steps_real, 1))
        state = {k: v.detach().clone() for k, v in module.state_dict().items()}
        return LocalResult(state, ep_losses[-1], float(epochs * steps_real), ep_losses[0])

    return local_train


def make_eval_fn(bundle: ModelBundle, task: Task, eval_batch_size: int = 256):
    """Build ``evaluate(variables, x, y, mask) -> dict of metric SUMS``
    over batches of ``eval_batch_size``, in eval mode (running stats)."""

    @torch.no_grad()
    def evaluate(variables: dict, x, y, mask) -> dict:
        acc: dict = {}
        for s in range(0, x.shape[0], eval_batch_size):
            sl = slice(s, s + eval_batch_size)
            m = task.metrics(bundle.apply_eval(variables, x[sl]), y[sl], mask[sl])
            acc = m if not acc else {k: acc[k] + m[k] for k in acc}
        return acc

    return evaluate


def finalize_metrics(sums: dict) -> dict:
    """Metric sums -> acc and mean loss."""
    out = {}
    count = float(sums.get("count", 1.0))
    if "correct" in sums:
        out["acc"] = float(sums["correct"]) / max(count, 1.0)
    if "loss_sum" in sums:
        out["loss"] = float(sums["loss_sum"]) / max(count, 1.0)
    return out
