"""Per-client local training (counterpart of ``fedml_tpu/parallel/local.py``).

The JAX package scans every minibatch step of a padded client, freezing
params and optimizer state on the dead steps past ``ceil(count / batch)``.
Here only those live steps run, which gives the same result: a frozen step
changes nothing. The last live batch still holds padding records (mask 0);
they enter BatchNorm's batch statistics as they do in JAX, and only the loss
masks them.

As the JAX package compiles the step, the port runs it as one program: on
CUDA each live step is a replay of one captured CUDA graph per step shape
(``parallel/capture.py``), which holds forward, loss, backward, FedProx's
term, the clip, the optimizer update and the gradients' reset. The
permutation, the real-first sort and the gather of each batch into the
step's static inputs stay eager, as do evaluation and aggregation.
"""

from __future__ import annotations

import itertools
from typing import Iterator, NamedTuple, Optional, Sequence

import torch

from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.tasks import Task, segmentation_scores
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.parallel.capture import CapturedStep


def make_optimizer(name: str, lr: float, momentum: float = 0.0, wd: float = 0.0
                   ) -> optim.Transform:
    """Client optimizer (``fedml_tpu/parallel/local.py:38-58``): the chain
    ``add_decayed_weights(wd)`` (when ``wd``; the decay folds into the
    gradient before momentum or moments) then ``sgd`` (momentum when
    nonzero), ``adam`` (= amsgrad, as the reference's client Adam),
    ``adamw``, ``adagrad`` or ``yogi``, each with optax's defaults
    (``core/optim.py``). ``make_optimizer(...)(params)`` binds it."""
    rules = {"sgd": lambda: optim.sgd(lr, momentum), "adam": lambda: optim.amsgrad(lr),
             "adamw": lambda: optim.adamw(lr), "adagrad": lambda: optim.adagrad(lr),
             "yogi": lambda: optim.yogi(lr)}
    rule = rules.get(name.lower())
    if rule is None:
        raise ValueError(f"unknown optimizer {name!r}")
    return optim.chain(optim.add_decayed_weights(wd), rule()) if wd else rule()


def local_train_kwargs(config) -> dict:
    """The one config -> ``make_local_train_fn`` kwargs mapping; every
    trainer (``FedAvgAPI._local_train_kwargs``, the packed program) goes
    through it, so a new knob cannot be dropped by one call site."""
    return dict(optimizer=config.client_optimizer, lr=config.lr, momentum=config.momentum,
                wd=config.wd, epochs=config.epochs, batch_size=config.batch_size,
                grad_clip=config.grad_clip,
                compute_dtype=torch.bfloat16 if config.dtype == "bfloat16" else None)


class LocalResult(NamedTuple):
    variables: dict              # the client's state dict after training
    train_loss: torch.Tensor     # mean loss over the last epoch
    tau: float                   # live optimizer steps, epochs * ceil(count / batch) (FedNova)
    first_loss: Optional[torch.Tensor] = None   # mean loss over the first epoch


@torch.no_grad()
def prox_term(params: list, anchor: list, prox_mu: float, n_lanes: int = 0) -> torch.Tensor:
    """FedProx: adds ``prox_mu * (w - w_global)``, the gradient of
    ``0.5 * prox_mu * ||w - w_global||^2``, to every parameter's ``.grad``
    and returns that term's value (``[L]``, one per lane, for lane-folded
    parameters)."""
    d = torch._foreach_sub(params, anchor)
    torch._foreach_add_([p.grad for p in params], d, alpha=prox_mu)
    if n_lanes:     # one norm per (lane, parameter), lane-major
        d = [x.view(n_lanes, -1)[lane] for lane in range(n_lanes) for x in d]
    sq = torch.stack(torch._foreach_norm(d)).square().view(max(n_lanes, 1), -1).sum(1)
    return 0.5 * prox_mu * (sq if n_lanes else sq[0])


def make_batch_sgd_step(bundle: ModelBundle, task: Task, *,
                        grad_clip: Optional[float] = None, prox_mu: float = 0.0):
    """ONE minibatch step on ``bundle.module``:
    ``step(module, opt, bx, by, bm, anchor=None) -> loss``, ``opt`` a bound
    optimizer (``make_optimizer(...)(params)``). The gradients are zeroed
    in place first (``opt.zero_grad(set_to_none=False)``), so they keep
    their addresses. With ``prox_mu`` the loss gains
    ``0.5 * prox_mu * ||w - anchor||^2`` over the parameters (``anchor``:
    the global model's, in ``opt.params`` order), before the optional clip
    (:func:`clip_grads_`). Syncs nothing with the host, so it can be
    captured."""

    def batch_step(module, opt, bx, by, bm, anchor=None):
        module.train()
        opt.zero_grad(set_to_none=False)
        loss = task.loss(module(bx), by, bm)
        loss.backward()
        loss = loss.detach()
        if prox_mu:
            loss = loss + prox_term(opt.params, anchor, prox_mu)
        if grad_clip:
            clip_grads_(opt.params, grad_clip)
        opt.step()
        return loss

    return batch_step


@torch.no_grad()
def clip_grads_(params: list, grad_clip: float) -> None:
    """Scale every ``.grad`` by ``min(1, clip / max(global_norm, 1e-12))``,
    in place, as the JAX step clips (``clip_grad_norm_`` adds 1e-6
    instead); syncs nothing with the host."""
    grads = [p.grad for p in params if p.grad is not None]
    gnorm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def module_state(module: torch.nn.Module, opt: optim.Optimizer) -> list:
    """Every tensor a step mutates: the module's parameters and buffers,
    the optimizer's state and the gradients."""
    return (list(module.state_dict(keep_vars=True).values()) + opt.tensors()
            + [p.grad for p in opt.params])


def real_first(perm: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """An epoch's record order: the permutation ``perm`` stable-sorted so
    the real records (``mask`` 1) lead."""
    return perm[torch.argsort(-mask[perm], stable=True)]


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
    prox_mu: float = 0.0,
    compute_dtype=None,
    capture: bool = True,
):
    """Build ``local_train(variables, x, y, mask, count, generator=None,
    orders=None) -> LocalResult``. ``optimizer``: any name of
    :func:`make_optimizer`; ``prox_mu``: FedProx's term, anchored at
    ``variables``.

    ``x/y/mask`` are one client's padded tensors [n_pad, ...] on the
    training device, with n_pad a multiple of ``batch_size``; ``count`` is
    its real record count. Each epoch draws a permutation of n_pad (from
    ``generator``, or ``orders[e]`` when given — the hook parity tests use
    to inject the JAX package's permutations) and stable-sorts it so the
    real records lead.

    The optimizer is bound to ``bundle.module`` once, at the first call,
    and reset for every client; FedProx's anchor is a static copy of the
    global parameters. Each live step gathers its batch into the static
    inputs of the step program for its shape and runs it: on CUDA a replay
    of the captured step, unless ``capture=False`` asks for the eager step
    (``parallel/capture.py``). ``local_train.bound`` holds the optimizer and
    the anchor, ``local_train.programs`` the step programs by shape, and
    ``local_train.stream`` trains a client whose batches stream in through
    the same programs (the streaming round, ``algorithms/streaming_fedavg``)."""
    tx = make_optimizer(optimizer, lr, momentum, wd)
    batch_step = make_batch_sgd_step(bundle, task, grad_clip=grad_clip, prox_mu=prox_mu)
    bound: dict = {}
    programs: dict = {}

    def bind(module) -> optim.Optimizer:
        opt = bound.get("opt")
        if opt is None:
            opt = bound["opt"] = tx(module.parameters())
            opt.zero_grad(set_to_none=False)
            if prox_mu:
                bound["anchor"] = [p.detach().clone() for p in opt.params]
        return opt

    def program(module, opt, x, y, mask) -> CapturedStep:
        key = tuple((tuple(t.shape[1:]), t.dtype) for t in (x, y, mask)) + (x.device,)
        prog = programs.get(key)
        if prog is None:
            inputs = [torch.empty((batch_size, *t.shape[1:]), dtype=t.dtype, device=t.device)
                      for t in (x, y, mask)]
            anchor = bound.get("anchor")
            prog = programs[key] = CapturedStep(
                lambda bx, by, bm: batch_step(module, opt, bx, by, bm, anchor), inputs,
                lambda: module_state(module, opt), capture)
        return prog

    def begin(variables: dict, x, y, mask) -> CapturedStep:
        """Load ``variables``, reset the optimizer (and FedProx's anchor) and
        return the step program of these inputs' shapes."""
        module = bundle.module
        module.load_state_dict(variables)
        opt = bind(module)
        opt.reset()
        if prox_mu:
            with torch.no_grad():
                torch._foreach_copy_(bound["anchor"],
                                     [variables[k] for k, _ in module.named_parameters()])
        return program(module, opt, x, y, mask)

    def end(ep_losses: list, steps_real: int) -> LocalResult:
        state = {k: v.detach().clone() for k, v in bundle.module.state_dict().items()}
        return LocalResult(state, ep_losses[-1], float(epochs * steps_real), ep_losses[0])

    def local_train(variables: dict, x, y, mask, count: int,
                    generator: Optional[torch.Generator] = None,
                    orders: Optional[Sequence[torch.Tensor]] = None) -> LocalResult:
        n_pad = x.shape[0]
        if n_pad % batch_size:
            raise ValueError(f"n_pad={n_pad} is not a multiple of batch_size={batch_size}")
        steps_real = -(-int(count) // batch_size)
        if compute_dtype is not None and x.is_floating_point():
            x = x.to(compute_dtype)
        step = begin(variables, x, y, mask)
        ep_losses = []
        for e in range(epochs):
            perm = orders[e] if orders is not None else torch.randperm(n_pad, generator=generator)
            order = real_first(perm.to(x.device), mask)
            total = torch.zeros((), device=x.device)
            for s in range(steps_real):
                idx = order[s * batch_size:(s + 1) * batch_size]
                for src, dst in zip((x, y, mask), step.inputs):
                    torch.index_select(src, 0, idx, out=dst)
                total = total + step()
            ep_losses.append(total / max(steps_real, 1))
        return end(ep_losses, steps_real)

    def stream_train(variables: dict, batches: Iterator[torch.Tensor], y, mask,
                     orders: torch.Tensor) -> LocalResult:
        """``local_train`` of one client whose records stream in: ``orders``
        ``[epochs, steps * batch_size]`` holds each epoch's real-first order
        (:func:`real_first`) cut to its live steps' records, ``batches``
        yields that order's record batches ``[batch_size, ...]`` on the
        device, epoch after epoch, and ``y``/``mask`` are the client's
        labels and mask on the device, gathered once an epoch. Each batch is
        copied into the same step program ``local_train`` runs, so with the
        same orders both give the same result bit for bit."""
        steps_real = orders.shape[1] // batch_size
        first = next(batches)
        spec = (first.to(compute_dtype)
                if compute_dtype is not None and first.is_floating_point() else first)
        step = begin(variables, spec, y, mask)
        batches = itertools.chain([first], batches)
        ep_losses = []
        for e in range(epochs):
            order = orders[e].to(y.device)
            ye, me = y.index_select(0, order), mask.index_select(0, order)
            total = torch.zeros((), device=y.device)
            for s in range(steps_real):
                rows = slice(s * batch_size, (s + 1) * batch_size)
                for src, dst in zip((next(batches), ye[rows], me[rows]), step.inputs):
                    dst.copy_(src)
                total = total + step()
            ep_losses.append(total / max(steps_real, 1))
        return end(ep_losses, steps_real)

    local_train.stream = stream_train
    local_train.bound = bound
    local_train.programs = programs
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
    """Metric sums -> acc, mean loss, and precision and recall (tag
    prediction); segmentation sums -> Acc / Acc_class / mIoU / FWIoU of
    their confusion matrix, with ``acc`` the pixel accuracy and ``loss``
    1 - mIoU."""
    if "confusion" in sums:
        scores = {k: float(v) for k, v in segmentation_scores(sums["confusion"]).items()}
        return {**scores, "acc": scores["Acc"], "loss": 1.0 - scores["mIoU"]}
    out = {}
    count = float(sums.get("count", 1.0))
    if "correct" in sums:
        out["acc"] = float(sums["correct"]) / max(count, 1.0)
    if "loss_sum" in sums:
        out["loss"] = float(sums["loss_sum"]) / max(count, 1.0)
    if "true_pos" in sums:
        tp, fp, fn = (float(sums[k]) for k in ("true_pos", "false_pos", "false_neg"))
        out["precision"] = tp / max(tp + fp, 1.0)
        out["recall"] = tp / max(tp + fn, 1.0)
    return out
