"""Client-packing schedule (counterpart of ``fedml_tpu/parallel/packed.py``).

The cohort is packed into a few lanes (LPT balancing); each lane runs its
clients back to back, resetting parameters, optimizer state and BatchNorm
statistics to the global model at a client's first step and adding
``w * variables`` into an accumulator at its last. All lanes run together:
one step of the lane-stacked model (``CifarResNet(n_lanes=L)``, the lanes
folded into the channel axis) trains every lane on its own member's batch,
in place of the JAX package's ``vmap`` of the lane program over lanes. That
step is the JAX package's joint form (``make_packed_lanes_train``) whatever
``packed_conv`` says: the flag picks only how the twin lowers its convs
(``ops/packed_conv.py``: ``"off"`` and ``"grouped"`` one grouped conv,
``"blockdiag"`` one block-diagonal GEMM). A model without a twin that takes
the lowerings (``lr``) runs ``"off"``, and a flag set for it is a fallback,
warned once and counted (``packed_fallback_reason``, ``FALLBACKS``), as in
the JAX package.

Exactness: each client replays the plain port path (``parallel/local.py``)
on the same per-epoch orders: the same real-first stable sort, the same
live steps, the plain path's optimizer (any of ``local.make_optimizer``'s,
with every state tensor folded like its parameter and one step count per
lane, so each lane's bias corrections are its own client's), FedProx's
term anchored per lane at the global model, and the clip by the lane's own
global norm.

The algorithm hooks are the JAX lane program's (``make_lane_train``):
``client_transform(global_vars, stacked)`` maps a member's variables at
its emit before they enter the weighted sum, and
``reduce_extras(global_vars, LocalResult, w)`` returns weighted partial
sums, accumulated over the emits; both take stacked clients, here a
singleton axis. A member's ``tau`` is ``epochs * steps_real`` from the
plan. The aggregate equals the plain round's
weighted mean up to float summation order (the grouped conv, the folded BN
sums, the accumulator). The plan is numpy on the host, so the step loop
branches on it per step: steps where no lane is live are skipped, and the
dead-step freeze and the resets touch only the lanes that need them.

The step itself (forward, the per-lane losses summed over a static
``[L]`` live mask, backward, FedProx's term, the per-lane clip, the
optimizer update, the gradients' reset) is one program: on CUDA a replay of
one captured CUDA graph per step shape (``parallel/capture.py``), whatever
lanes are dead. The gather of each step's batches into its static inputs,
the resets, the dead-lane save and restore and the emits stay eager.

The cross-silo mesh form (``plan_packing_mesh``, ``pad_plan``,
``mesh_member_active``, ``make_crosssilo_packed_round``) runs each rank's
lanes over its block of the clients and all-reduces the emitted sums once.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.optim import state_tensors
from fedml_tpu_torch.core.pytree import tree_add
from fedml_tpu_torch.core.tasks import Task
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.ops.dropout import step_keys
from fedml_tpu_torch.ops.packed_conv import stack_variables
from fedml_tpu_torch.parallel.capture import CapturedStep
from fedml_tpu_torch.parallel.crosssilo import mesh_finish
from fedml_tpu_torch.parallel.local import LocalResult, make_optimizer, module_state, prox_term

log = logging.getLogger(__name__)


class PackPlan(NamedTuple):
    """Static lane schedule for one cohort (bit-equal to the JAX package's)."""

    n_lanes: int
    k_max: int
    T: int                 # steps per lane
    epochs: int
    # [n_lanes, T] per-step metadata
    slot: np.ndarray       # which member slot trains this step (0 on dead steps)
    epoch: np.ndarray      # epoch index
    sie: np.ndarray        # step within the epoch
    reset: np.ndarray      # 1.0 at a client's first step
    emit: np.ndarray       # 1.0 at a client's last step
    live: np.ndarray       # 0.0 on dead lane-tail steps
    # [n_lanes, k_max] per-member metadata
    member_pos: np.ndarray   # position in the sampled cohort (0-padded)
    member_valid: np.ndarray  # 1.0 for real members
    steps_real: np.ndarray   # ceil(count/bs) per member (>=1 for real members)

    @property
    def shape_key(self) -> tuple:
        return (self.n_lanes, self.k_max, self.T, self.epochs)

    @property
    def executed_slots(self) -> int:
        """Lanes x steps of the plan (batch slots without the batch factor)."""
        return self.n_lanes * self.T


def plan_packing(counts: np.ndarray, batch_size: int, epochs: int,
                 n_lanes: int, t_quantum: int = 1) -> Optional[PackPlan]:
    """LPT-pack the cohort (client j costs ``epochs * ceil(count_j/bs)``
    consecutive steps) into ``n_lanes`` lanes; T = max lane load rounded up
    to ``t_quantum`` steps. Returns None when the cohort is empty."""
    counts = np.asarray(counts, np.float64)
    steps = np.ceil(np.maximum(counts, 0.0) / batch_size).astype(np.int64)
    members = np.nonzero(steps > 0)[0]
    if members.size == 0 or n_lanes < 1:
        return None
    n_lanes = int(min(n_lanes, members.size))
    cost = epochs * steps[members]
    order = np.argsort(-cost, kind="stable")          # LPT: biggest first
    lanes: list[list[int]] = [[] for _ in range(n_lanes)]
    loads = np.zeros(n_lanes, np.int64)
    for j in order:
        lane = int(np.argmin(loads))
        lanes[lane].append(int(members[j]))
        loads[lane] += cost[j]
    T = int(np.ceil(loads.max() / max(t_quantum, 1)) * max(t_quantum, 1))
    k_max = max(len(mem) for mem in lanes)

    slot = np.zeros((n_lanes, T), np.int32)
    epoch = np.zeros((n_lanes, T), np.int32)
    sie = np.zeros((n_lanes, T), np.int32)
    reset = np.zeros((n_lanes, T), np.float32)
    emit = np.zeros((n_lanes, T), np.float32)
    live = np.zeros((n_lanes, T), np.float32)
    member_pos = np.zeros((n_lanes, k_max), np.int32)
    member_valid = np.zeros((n_lanes, k_max), np.float32)
    steps_real = np.ones((n_lanes, k_max), np.int32)

    for lane, mem in enumerate(lanes):
        t = 0
        for k, pos in enumerate(mem):
            member_pos[lane, k] = pos
            member_valid[lane, k] = 1.0
            s = int(steps[pos])
            steps_real[lane, k] = s
            reset[lane, t] = 1.0
            for e in range(epochs):
                for si in range(s):
                    slot[lane, t] = k
                    epoch[lane, t] = e
                    sie[lane, t] = si
                    live[lane, t] = 1.0
                    t += 1
            emit[lane, t - 1] = 1.0
        # steps t..T-1 stay dead (slot 0, live 0)

    return PackPlan(n_lanes, k_max, T, epochs, slot, epoch, sie, reset, emit,
                    live, member_pos, member_valid, steps_real)


def plan_arrays_tuple(plan: PackPlan) -> tuple:
    """The 9 plan arrays in the one canonical order (slot, epoch, sie,
    reset, emit, live, member_pos, member_valid, steps_real)."""
    return (plan.slot, plan.epoch, plan.sie, plan.reset, plan.emit,
            plan.live, plan.member_pos, plan.member_valid, plan.steps_real)


def mask_plan_arrays(plan: PackPlan, member_active: np.ndarray) -> tuple:
    """Masked plan arrays for per-client lane exit: a member whose
    ``member_active[lane, k]`` is 0 runs its steps with ``live = 0``, its
    ``emit``/``member_valid`` zero out and its ``reset`` is suppressed, so
    the lane carries frozen state through the span to the next active
    member's reset. Shapes are unchanged.

    ``member_active``: [n_lanes, k_max] {0,1} per plan member."""
    act_m = np.asarray(member_active, np.float32)
    # each step's activity = its owning member's (dead lane-tail steps index
    # slot 0 but already carry live == 0)
    step_act = np.take_along_axis(act_m, plan.slot.astype(np.int64), axis=1)
    return (plan.slot, plan.epoch, plan.sie,
            (plan.reset * step_act).astype(plan.reset.dtype),
            (plan.emit * step_act).astype(plan.emit.dtype),
            (plan.live * step_act).astype(plan.live.dtype),
            plan.member_pos,
            (plan.member_valid * act_m).astype(plan.member_valid.dtype),
            plan.steps_real)


def mask_plan(plan: PackPlan, member_active: np.ndarray) -> PackPlan:
    """The plan with :func:`mask_plan_arrays` applied: the members whose
    ``member_active[lane, k]`` is 0 frozen, shapes unchanged."""
    return PackPlan(plan.n_lanes, plan.k_max, plan.T, plan.epochs,
                    *mask_plan_arrays(plan, member_active))


def executed_steps(live: np.ndarray) -> np.ndarray:
    """The plan steps the port executes: those where some lane is live."""
    return np.nonzero(np.asarray(live).max(0) > 0)[0]


class PackedSums(NamedTuple):
    """A packed cohort's weighted partial sums, before any reduction."""
    acc: dict              # name -> sum(w * vars) in f32, the lane state's order
    loss_sum: torch.Tensor     # sum(w * last-epoch mean loss), 0-dim
    extras: Optional[dict]     # reduce_extras summed over the emits (None without the hook)
    total: float               # sum(w) over the emits


class PackedResult(NamedTuple):
    variables: dict        # the aggregate: sum(w * vars) / sum(w), in each leaf's dtype
    train_loss: torch.Tensor   # sum(w * last-epoch mean loss) / sum(w), 0-dim
    extras: Optional[dict]     # reduce_extras summed over the emits (None without the hook)
    total: float               # sum(w) over the emits


def live_loss(lane_loss: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The sum of the live lanes' own mean losses, over the static ``[L]``
    mask ``live`` (1 live, 0 dead): each live lane's gradient is its own, a
    dead lane's is 0, and the program is the same for every dead set. A
    dead lane still trains on a real member's batch, so its loss is finite
    (``core/tasks.py`` clamps the mask sum at 1)."""
    return (lane_loss * live).sum()


# -- the joint lowerings (packed_conv) -----------------------------------------

#: fallbacks counted by ``"fallback:<model>:<lowering>"`` (the JAX package
#: counts them in its registry's "packed" group), and the (model, lowering,
#: reason) keys already warned; ``reset_fallback_warnings`` clears both
FALLBACKS: dict = {}
_FALLBACK_SEEN: set = set()


def reset_fallback_warnings() -> None:
    """Forget the warned keys and the counts (a new federation in one
    process warns and counts from zero)."""
    FALLBACKS.clear()
    _FALLBACK_SEEN.clear()


def packed_fallback_reason(bundle: ModelBundle, packed_conv: str) -> Optional[str]:
    """Why the joint lowering does NOT apply (None = it does), the JAX
    package's reasons word for word: the flag is off; the model has no twin
    that takes the lowerings (``ModelBundle.packed_twin``: ``lr``,
    ``transformer``, EfficientNet, the lanes body); the model drops out and
    its twin has no explicit per-lane key stream
    (``ModelBundle.explicit_dropout``; ``cnn_dropout`` has one). No client
    optimizer disqualifies (its state is folded per lane)."""
    if packed_conv in (None, "", "off"):
        return "packed_conv=off"
    if not bundle.packed_twin:
        return f"model {bundle.name!r} has no packed conv variant"
    if bundle.uses_dropout and not bundle.explicit_dropout:
        return (f"model {bundle.name!r} uses flax-rng dropout and its "
                "packed twin has no explicit per-lane key stream")
    return None


def packed_conv_active(bundle: ModelBundle, packed_conv: str) -> bool:
    """Whether the packed trainer runs the joint lowering ``packed_conv``."""
    return packed_fallback_reason(bundle, packed_conv) is None


def _packed_impl(bundle: ModelBundle, packed_conv: str) -> str:
    """The lowering the twin takes: ``packed_conv``, or ``"off"`` where it
    does not apply; a real fallback (the flag on, the joint lowering
    inapplicable) is warned once per (model, lowering, reason) and counted."""
    reason = packed_fallback_reason(bundle, packed_conv)
    if reason is None:
        return packed_conv
    if packed_conv not in (None, "", "off"):
        ck = f"fallback:{bundle.name}:{packed_conv}"
        FALLBACKS[ck] = FALLBACKS.get(ck, 0) + 1
        key = (bundle.name, packed_conv, reason)
        if key not in _FALLBACK_SEEN:
            _FALLBACK_SEEN.add(key)
            log.warning("packed_conv=%r falls back to packed_conv='off': %s", packed_conv, reason)
    return "off"


class _Lanes:
    """The lane-stacked model for one lane count, its optimizer and its
    per-lane state: each lane's view of every state-dict leaf, in the plain
    model's shapes (``names`` order), flat per-lane views of every
    optimizer state tensor, and each lane's step counts; the step loop
    resets, freezes and reads them in place. ``anchor`` is FedProx's static
    lane-folded copy of the global parameters (None without the term),
    ``programs`` the step programs by shape."""

    def __init__(self, module: torch.nn.Module, n_lanes: int, variables: dict, tx,
                 prox_mu: float = 0.0):
        self.module = module
        self.n_lanes = n_lanes
        L = n_lanes
        module.load_state_dict(stack_variables(variables, n_lanes))
        state = module.state_dict(keep_vars=True)
        self.names = list(state)
        self.param_names = [n for n, _ in module.named_parameters()]
        self.opt = tx(module.parameters(), n_lanes)
        self.opt.zero_grad(set_to_none=False)
        opt_tensors, self.counts = state_tensors(self.opt.state)

        def views(tensors):
            return [[t.detach().view(L, -1)[lane] for t in tensors] for lane in range(L)]

        self.lane_state = [[t.detach().view(L, *variables[n].shape)[lane]
                            for n, t in state.items()] for lane in range(L)]
        self.opt_views = views(opt_tensors)
        self.opt_init_views = views(self.opt.initial[:len(opt_tensors)])
        self.anchor = [p.detach().clone() for p in self.opt.params] if prox_mu else None
        self.programs: dict = {}

    def set_anchor(self, variables: dict) -> None:
        """Every lane's block of the anchor: the global parameters."""
        L = self.n_lanes
        with torch.no_grad():
            for a, n in zip(self.anchor, self.param_names):
                v = variables[n]
                a.view(L, *v.shape).copy_(v.unsqueeze(0).expand(L, *v.shape))

    def reset(self, lane: int, glob: list) -> None:
        """Lane ``lane`` starts a client: the global variables, the
        optimizer's initial state, step count 0."""
        torch._foreach_copy_(self.lane_state[lane], glob)
        if self.opt_views[lane]:      # plain SGD keeps no state
            torch._foreach_copy_(self.opt_views[lane], self.opt_init_views[lane])
        for c in self.counts:
            c[lane] = 0

    def save(self, lane: int) -> tuple:
        return ([v.clone() for v in self.lane_state[lane] + self.opt_views[lane]],
                [c[lane].clone() for c in self.counts])

    def restore(self, lane: int, saved: tuple) -> None:
        torch._foreach_copy_(self.lane_state[lane] + self.opt_views[lane], saved[0])
        for c, v in zip(self.counts, saved[1]):
            c[lane] = v


def make_packed_cohort_train(bundle: ModelBundle, task: Task, n_pad: int, *,
                             optimizer: str = "sgd", lr: float = 0.01, momentum: float = 0.0,
                             wd: float = 0.0, epochs: int = 1, batch_size: int = 32,
                             grad_clip: Optional[float] = None, prox_mu: float = 0.0,
                             compute_dtype=None,
                             client_transform: Optional[Callable] = None,
                             reduce_extras: Optional[Callable] = None,
                             packed_conv: str = "off", capture: bool = True):
    """Build ``packed_train(variables, tx, ty, tm, sampled_rows, weights_pos,
    orders, plan, keys=None) -> PackedResult``; the trainer arguments are
    ``make_local_train_fn``'s (``local.local_train_kwargs``), the hooks the
    JAX lane program's, ``packed_conv`` the twin's conv lowering ("off",
    "grouped", "blockdiag"; a model whose twin does not take it runs "off",
    see ``packed_fallback_reason``).

    The lane-stacked model for L lanes, ``bundle.module.lane_stacked(L,
    packed_impl=...)``, is built at the first plan with L lanes and kept (L
    varies from round to round with the cohort); a trainer has one
    lowering, so its twins and their step programs are keyed by (L,
    lowering). ``packed_train.packed_conv`` is the lowering it runs. ``tx/ty/tm`` are the whole stacked client dataset
    [C_total, n_pad, ...] on the device, or (a streamed chunk of a host
    round) just the chunk's clients as shipped, with ``sampled_rows`` their
    ``arange``; ``sampled_rows`` [cohort] maps a cohort position to its
    stack row; ``weights_pos`` [cohort] the aggregation weights by position;
    ``orders`` [cohort, epochs, n_pad] each position's per-epoch
    permutations of n_pad (the plain path's draws, or injected ones; a
    chunk's position j takes the order of its position in the whole
    cohort). ``keys`` [cohort] are the positions' dropout keys
    (``ops/dropout.client_key``), which a dropout model requires: its lanes
    take each step's ``[L]`` keys, ``step_keys`` of their members' keys,
    epochs and steps, the keys of the plain trainer's steps, so lane l drops
    as its client's plain step does.

    Every executed step runs the lane program's step program for its shape:
    on CUDA a replay of the captured step, unless ``capture=False`` asks for
    the eager step (``parallel/capture.py``). ``packed_train.sums`` takes
    the same arguments and returns the :class:`PackedSums` the aggregate
    divides, which the cross-silo packed round all-reduces first."""
    if n_pad % batch_size:
        raise ValueError(f"n_pad={n_pad} is not a multiple of batch_size={batch_size}")
    lane_stacked = getattr(bundle.module, "lane_stacked", None)
    if lane_stacked is None:
        raise NotImplementedError(f"model {bundle.name!r} has no lane-stacked twin; the packed "
                                  "schedule is ported for the CIFAR ResNets and lr")
    impl = _packed_impl(bundle, packed_conv)

    def twin(L: int) -> torch.nn.Module:
        return lane_stacked(L) if impl == "off" else lane_stacked(L, packed_impl=impl)

    steps_full = n_pad // batch_size
    bs = batch_size
    opt_tx = make_optimizer(optimizer, lr, momentum, wd)
    cache: dict[int, _Lanes] = {}

    def lane_tables(tm, rows, orders, plan, steps):
        """Each executed step's [L, bs] flat indices into the flattened
        [C_total*n_pad] stack, built once per round on the device: the
        member's epoch order (real records first, stable) cut at its step."""
        perm = orders.to(tm.device)                                   # [cohort, E, n_pad]
        mrows = tm[rows].unsqueeze(1).expand(-1, perm.shape[1], -1)   # [cohort, E, n_pad]
        first = torch.argsort(-torch.gather(mrows, 2, perm), dim=2, stable=True)
        flat = torch.gather(perm, 2, first) + rows.view(-1, 1, 1) * n_pad
        flat = flat.view(flat.shape[0], flat.shape[1], steps_full, bs)
        lanes = np.arange(plan.n_lanes)[:, None]
        pos = plan.member_pos[lanes, plan.slot[:, steps]]             # [L, S]
        pick = (torch.as_tensor(a.T.astype(np.int64), device=tm.device)
                for a in (pos, plan.epoch[:, steps], plan.sie[:, steps]))
        return flat[tuple(pick)].view(len(steps), -1)                 # [S, L*bs]

    def lane_step(lanes: _Lanes, bx, by, bm, live, keys=None) -> torch.Tensor:
        """One packed step of every lane; returns the lanes' losses [L]."""
        L, module, opt = lanes.n_lanes, lanes.module, lanes.opt
        module.train()
        opt.zero_grad(set_to_none=False)
        logits = module(bx) if keys is None else module(bx, dropout_key=keys)
        lane_loss = torch.stack([task.loss(logits[lane], by[lane], bm[lane])
                                 for lane in range(L)])
        live_loss(lane_loss, live).backward()
        lane_loss = lane_loss.detach()
        if prox_mu:
            lane_loss = lane_loss + prox_term(opt.params, lanes.anchor, prox_mu, L)
        if grad_clip:
            clip([p.grad for p in opt.params], L)
        opt.step()
        return lane_loss

    def program(lanes: _Lanes, x_flat, y_flat, m_flat) -> CapturedStep:
        L = lanes.n_lanes
        key = tuple((tuple(t.shape[1:]), t.dtype) for t in (x_flat, y_flat, m_flat))
        prog = lanes.programs.get(key)
        if prog is None:
            inputs = [torch.empty((L, bs, *t.shape[1:]), dtype=t.dtype, device=t.device)
                      for t in (x_flat, y_flat, m_flat)]
            inputs.append(torch.ones(L, dtype=torch.float32, device=x_flat.device))
            if bundle.uses_dropout:      # the lanes' dropout keys
                inputs.append(torch.zeros(L, dtype=torch.int64, device=x_flat.device))
            prog = lanes.programs[key] = CapturedStep(
                lambda bx, by, bm, live, keys=None: lane_step(lanes, bx, by, bm, live, keys),
                inputs,
                lambda: module_state(lanes.module, lanes.opt), capture)
        return prog

    @torch.no_grad()
    def clip(grads: list, L: int) -> None:
        """Scale each lane's gradients by its own global norm, as the
        plain step clips one client's."""
        sq = sum(g.reshape(L, -1).to(torch.float32).square().sum(1) for g in grads)
        scale = torch.clamp(grad_clip / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
        for g in grads:
            g.view(L, g.shape[0] // L, *g.shape[1:]).mul_(
                scale.view(L, *([1] * g.dim())).to(g.dtype))

    @torch.no_grad()
    def emit(lanes: _Lanes, lane: int, variables: dict, acc: list, w: float,
             mean_loss: torch.Tensor, tau: float):
        """Add member ``lane``'s ``w``-weighted (transformed) variables to
        ``acc``; returns its weighted extras (or None)."""
        one = {n: v.unsqueeze(0) for n, v in zip(lanes.names, lanes.lane_state[lane])}
        if client_transform is None:
            torch._foreach_add_(acc, lanes.lane_state[lane], alpha=w)
        else:
            out = client_transform(variables, one)
            torch._foreach_add_(acc, [out[n][0] for n in lanes.names], alpha=w)
        if reduce_extras is None:
            return None
        dev = mean_loss.device
        res = LocalResult(one, mean_loss.reshape(1),
                          torch.full((1,), tau, dtype=torch.float32, device=dev))
        return reduce_extras(variables, res, torch.full((1,), w, dtype=torch.float32,
                                                        device=dev))

    def lane_keys(keys, plan, steps, dev) -> torch.Tensor:
        """Each executed step's [L] dropout keys, [S, L] on the device."""
        if keys is None:
            raise ValueError(f"model {bundle.name!r} drops out: the packed round needs its "
                             "positions' dropout keys (ops/dropout.client_key)")
        ck = np.asarray(keys, np.int64)
        lanes = np.arange(plan.n_lanes)[:, None]
        pos = plan.member_pos[lanes, plan.slot[:, steps]]                # [L, S]
        keys = step_keys(ck[pos], plan.epoch[:, steps], plan.sie[:, steps])
        return torch.as_tensor(keys.T.copy(), device=dev)

    def packed_sums(variables: dict, tx, ty, tm, sampled_rows, weights_pos,
                    orders: torch.Tensor, plan: PackPlan, keys=None) -> PackedSums:
        L = plan.n_lanes
        lanes = cache.get(L)
        if lanes is None:
            lanes = cache[L] = _Lanes(twin(L), L, variables, opt_tx, prox_mu)
        dev = tx.device
        glob = [variables[k] for k in lanes.names]
        if prox_mu:
            lanes.set_anchor(variables)
        acc = [torch.zeros_like(v, dtype=torch.float32) for v in glob]
        C = tx.shape[0]
        x_flat = tx.reshape((C * n_pad,) + tuple(tx.shape[2:]))
        if compute_dtype is not None and x_flat.is_floating_point():
            x_flat = x_flat.to(compute_dtype)
        y_flat, m_flat = ty.reshape((C * n_pad,) + tuple(ty.shape[2:])), tm.reshape(-1)
        step = program(lanes, x_flat, y_flat, m_flat)
        bx, by, bm, live_in = step.inputs[:4]
        rows = torch.as_tensor(np.asarray(sampled_rows, np.int64), device=dev)
        steps = executed_steps(plan.live)
        acc_loss = torch.zeros((), device=dev)
        acc_w = 0.0
        acc_extras = None
        if not len(steps):       # every member frozen: nothing to train
            return PackedSums(dict(zip(lanes.names, acc)), acc_loss, acc_extras, acc_w)
        table = lane_tables(tm, rows, orders, plan, steps)
        lanes_ix = np.arange(L)
        member_w = (np.asarray(weights_pos, np.float32)[plan.member_pos]
                    * plan.member_valid)                               # [L, k_max]
        # per executed step: each lane's live flag, and 1 where a lane's
        # loss enters its client's last-epoch sum (live, last epoch)
        live_steps = torch.as_tensor(plan.live[:, steps].T.copy(), device=dev)
        last = torch.as_tensor(((plan.live * (plan.epoch == epochs - 1))[:, steps]).T.copy(),
                               device=dev)
        loss_acc = torch.zeros(L, device=dev)
        key_table = lane_keys(keys, plan, steps, dev) if bundle.uses_dropout else None
        for i, t in enumerate(steps):
            reset = np.nonzero(plan.reset[:, t] > 0)[0]
            if reset.size:
                with torch.no_grad():
                    for lane in reset:
                        lanes.reset(lane, glob)
                    keep = torch.ones(L, device=dev)
                    keep[torch.as_tensor(reset)] = 0.0
                    loss_acc = loss_acc * keep
            dead = np.nonzero(plan.live[:, t] <= 0)[0]
            # a dead lane's step changes nothing of it: not its parameters,
            # optimizer state or BatchNorm running statistics
            frozen = {lane: lanes.save(lane) for lane in dead}
            ix = table[i]
            for src, dst in ((x_flat, bx), (y_flat, by), (m_flat, bm)):
                torch.index_select(src, 0, ix, out=dst.view(L * bs, *dst.shape[2:]))
            live_in.copy_(live_steps[i])
            if key_table is not None:
                step.inputs[4].copy_(key_table[i])
            lane_loss = step()
            with torch.no_grad():
                for lane, saved in frozen.items():
                    lanes.restore(lane, saved)
                loss_acc = loss_acc + lane_loss * last[i]
                for lane in lanes_ix[plan.emit[:, t] > 0]:
                    k = int(plan.slot[lane, t])
                    w = float(member_w[lane, k])
                    sr = max(float(plan.steps_real[lane, k]), 1.0)
                    ex = emit(lanes, lane, variables, acc, w, loss_acc[lane] / sr, epochs * sr)
                    if ex is not None:
                        acc_extras = ex if acc_extras is None else tree_add(acc_extras, ex)
                    acc_w += w
                    acc_loss = acc_loss + loss_acc[lane] / sr * w
        return PackedSums(dict(zip(lanes.names, acc)), acc_loss, acc_extras, acc_w)

    def packed_train(variables: dict, tx, ty, tm, sampled_rows, weights_pos,
                     orders: torch.Tensor, plan: PackPlan, keys=None) -> PackedResult:
        sums = packed_sums(variables, tx, ty, tm, sampled_rows, weights_pos, orders, plan,
                           keys)
        denom = max(sums.total, 1e-12)
        agg = {k: (a / denom).to(variables[k].dtype) for k, a in sums.acc.items()}
        return PackedResult(agg, sums.loss_sum / denom, sums.extras, sums.total)

    packed_train.sums = packed_sums
    packed_train.lanes = cache      # L -> its lane-stacked model and per-lane state
    packed_train.packed_conv = impl
    return packed_train


# -- cross-silo mesh form ------------------------------------------------------

def mesh_member_active(plan: PackPlan, n_devices: int, active_perm: np.ndarray) -> np.ndarray:
    """Per-(lane, member) activity for the mesh plan, whose ``member_pos``
    index local rows of each rank's client block and whose lane axis is
    rank-major ``[D * lanes_dev]``. ``active_perm``: per-client {0,1} in
    plan (rank-major ``perm``) order."""
    ap = np.asarray(active_perm, np.float32)
    D = int(n_devices)
    rows = ap.reshape(D, -1)                       # [D, clients_per_rank]
    lanes_dev = plan.n_lanes // D
    dev = np.repeat(np.arange(D), lanes_dev)       # lane -> rank
    return rows[dev[:, None], plan.member_pos.astype(np.int64)]


def pad_plan(plan: PackPlan, T: int, k_max: int, n_lanes: int) -> PackPlan:
    """A plan padded to shared ``(n_lanes, k_max, T)``: the extra steps,
    members and lanes are dead (live 0, member_valid 0)."""

    def pad2(a, rows, cols, fill=0):
        out = np.full((rows, cols), fill, a.dtype)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    return PackPlan(
        n_lanes, k_max, T, plan.epochs,
        pad2(plan.slot, n_lanes, T), pad2(plan.epoch, n_lanes, T),
        pad2(plan.sie, n_lanes, T), pad2(plan.reset, n_lanes, T),
        pad2(plan.emit, n_lanes, T), pad2(plan.live, n_lanes, T),
        pad2(plan.member_pos, n_lanes, k_max),
        pad2(plan.member_valid, n_lanes, k_max),
        pad2(plan.steps_real, n_lanes, k_max, fill=1),
    )


def plan_packing_mesh(counts: np.ndarray, batch_size: int, epochs: int, n_devices: int,
                      lanes_per_device: int, t_quantum: int = 1):
    """Mesh packing (bit-equal to the JAX package's): deal the clients to
    ranks by capacity-constrained LPT (the biggest client first, to the
    least-loaded rank with a free row), pack each rank's clients into its
    own lanes, and pad every rank's plan to shared shapes.

    Returns ``(perm, plan)`` or None: ``perm`` is the rank-major client
    order (rank d's block = ``perm[d*L:(d+1)*L]``); the plan's lane axis is
    rank-major ``[D*lanes_dev, ...]`` and its ``member_pos`` index local
    rows of a rank's block."""
    counts = np.asarray(counts, np.float64)
    C = len(counts)
    D = int(n_devices)
    if C % D or C // D < 1:
        return None
    L = C // D
    cost = epochs * np.ceil(np.maximum(counts, 0.0) / batch_size)
    order = np.argsort(-cost, kind="stable")
    loads = np.zeros(D)
    dev_clients = [[] for _ in range(D)]
    for j in order:
        free = [d for d in range(D) if len(dev_clients[d]) < L]
        d = min(free, key=lambda i: loads[i])
        dev_clients[d].append(int(j))
        loads[d] += cost[j]
    dev_clients = [np.asarray(m, np.int64) for m in dev_clients]
    plans = []
    for d in range(D):
        p = plan_packing(counts[dev_clients[d]], batch_size, epochs, lanes_per_device,
                         t_quantum=t_quantum)
        if p is None:
            return None
        plans.append(p)
    T = max(p.T for p in plans)
    k_max = max(p.k_max for p in plans)
    n_lanes_dev = max(p.n_lanes for p in plans)
    plans = [pad_plan(p, T, k_max, n_lanes_dev) for p in plans]

    def cat(field):
        return np.concatenate([getattr(p, field) for p in plans], axis=0)

    plan = PackPlan(D * n_lanes_dev, k_max, T, epochs,
                    cat("slot"), cat("epoch"), cat("sie"), cat("reset"), cat("emit"),
                    cat("live"), cat("member_pos"), cat("member_valid"), cat("steps_real"))
    return np.concatenate(dev_clients), plan


def rank_plan(plan: PackPlan, world_size: int, rank: int) -> PackPlan:
    """Rank ``rank``'s lanes of a mesh plan (its block of the lane axis)."""
    n = plan.n_lanes // world_size
    rows = slice(rank * n, (rank + 1) * n)
    return PackPlan(n, plan.k_max, plan.T, plan.epochs,
                    *(a[rows] for a in plan_arrays_tuple(plan)))


def make_crosssilo_packed_round(bundle: ModelBundle, task: Task, n_pad: int, mesh, *,
                                client_transform: Optional[Callable] = None,
                                reduce_extras: Optional[Callable] = None,
                                server_update: Optional[Callable] = None,
                                **lane_kwargs) -> Callable:
    """The mesh form of the packed schedule: each rank runs its lanes
    (``make_packed_cohort_train``'s lane program, the simulation round's)
    over its block of the clients, then one all-reduce of the emitted
    accumulators, the loss sum and the extras, and
    ``apply_server_and_rollback`` (``crosssilo.mesh_finish``).

    Returns ``round_fn(variables, server_state, tx, ty, tm, weights, orders,
    plan, total, rng=None, keys=None) -> (variables, server_state, loss)``:
    ``tx/ty/tm`` this rank's block of the clients in plan order (``perm``)
    on its device, ``weights`` [block] their aggregation weights,
    ``orders`` [block, epochs, n_pad] their per-epoch orders and ``keys``
    [block] their dropout keys (each client's by its original index),
    ``plan`` this rank's lanes (:func:`rank_plan`), ``total`` the total
    weight over every rank, known on the host, ``rng`` the round's server
    randomness. ``round_fn.lanes`` is
    the lane program (its ``.lanes`` cache)."""
    lanes_fn = make_packed_cohort_train(bundle, task, n_pad, client_transform=client_transform,
                                        reduce_extras=reduce_extras, **lane_kwargs)

    def round_fn(variables, server_state, tx, ty, tm, weights, orders, plan, total: float,
                 rng=None, keys=None):
        sums = lanes_fn.sums(variables, tx, ty, tm, np.arange(tx.shape[0]), weights, orders,
                             plan, keys)
        return mesh_finish(mesh, variables, sums.acc, sums.loss_sum, sums.extras, total,
                           server_state, server_update, rng)

    round_fn.lanes = lanes_fn
    return round_fn
