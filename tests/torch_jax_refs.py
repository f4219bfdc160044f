"""The JAX package's random draws, in the port's layout, for the parity tests
of the robust, hierarchical and silo slices (tests/test_torch_robust.py,
test_torch_hierarchical.py, test_torch_silo.py): per-client per-epoch
orders, the server's DP noise, and a leafwise comparison of a port state
dict with flax variables."""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from fedml_tpu.core.rng import server_key
from fedml_tpu_torch.models.convert import torch_to_flax


def _perms(client_key, epochs: int, n: int) -> np.ndarray:
    return np.stack([np.asarray(jax.random.permutation(ek, n)).astype(np.int64)
                     for ek in jax.random.split(client_key, epochs)])


@functools.lru_cache(maxsize=None)
def jax_orders_np(seed: int, epochs: int, round_idx: int, cohort: int, n: int,
                  group_rounds: int = 0, group_round: int = 0) -> tuple:
    """``[cohort]`` arrays ``[epochs, n]``: the permutations the JAX API's
    clients draw in a round, from ``split(fold_in(key(seed), r), cohort)``
    (``group_rounds > 0``: hierarchical FL's
    ``split(split(rk, group_rounds)[group_round], cohort)``)."""
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    if group_rounds:
        rk = jax.random.split(rk, group_rounds)[group_round]
    return tuple(_perms(ck, epochs, n) for ck in jax.random.split(rk, cohort))


def order_hook(seed: int, epochs: int, cohort: int, n_pad: int, group_rounds: int = 0):
    """An ``order_hook`` for the port's API that returns the JAX API's
    orders (cohort position ``i``, the record axis ``n``, and the group
    round for hierarchical FL)."""
    def hook(r, i, n=n_pad, group_round=None):
        arr = jax_orders_np(seed, epochs, r, cohort, n, group_rounds, group_round or 0)[i]
        return [torch.from_numpy(o) for o in arr]
    return hook


def flax_shape(name: str, shape: tuple) -> tuple:
    if name.endswith("weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if name.endswith("weight") and len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def to_port_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith("weight") and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if name.endswith("weight") and a.ndim == 2:
        return a.T
    return a


def jax_normal(key, i: int, name: str, shape: tuple) -> torch.Tensor:
    """``normal(fold_in(key, i))`` of the flax leaf ``i`` (``add_dp_noise``'s
    draw), in the port's layout of leaf ``name``."""
    a = np.asarray(jax.random.normal(jax.random.fold_in(key, i), flax_shape(name, shape)))
    return torch.from_numpy(np.array(to_port_layout(name, a), order="C"))


def noise_hook(seed: int):
    """A ``noise_hook`` for the port's API that returns the JAX API's DP
    noise: ``normal(fold_in(server_key(fold_in(key(seed), r)), i))``."""
    def hook(r, i, name, shape):
        sk = server_key(jax.random.fold_in(jax.random.key(seed), r))
        return jax_normal(sk, i, name, shape)
    return hook


def assert_vars_close(got: dict, want_flax: dict, rtol: float, atol: float, msg: str = "",
                      bn_name=None) -> None:
    """Every leaf of the port's state dict against the flax variables."""
    got = torch_to_flax(got, bn_name=bn_name)
    want = jax.tree.map(np.asarray, want_flax)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{msg} {path}")


# -- the model zoo: a train-mode forward and its gradient against JAX's ------------

class FixedMasks:
    """A stand-in for ``jax.random.bernoulli`` while a JAX model is traced:
    each call returns the next numpy keep mask of its shape (drawn here from
    ``seed``) and records it, so the port can be handed the same masks in
    call order (``ops/dropout.injected_masks``: the port numbers its call
    sites in forward order)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.masks: list = []

    def __call__(self, key, p=0.5, shape=None, mode=None):
        m = self.rng.random(tuple(shape)) < p
        self.masks.append(m)
        return jax.numpy.asarray(m)


#: the reference's own conditioning: its outputs under this many random
#: relative perturbations of size PERTURBATION of every weight and input
PERTURBATIONS = 3
PERTURBATION = 1e-6


def _noise_bound(d_port: float, d_self: float, ref: np.ndarray) -> float:
    """``d_port`` over its bound: ten times the reference's largest
    distance under PERTURBATIONS random relative perturbations of size
    PERTURBATION of its weights and input, plus 1e-4 of the tensor's norm
    and 1e-5 a sqrt(element) (an element-wise atol of 1e-5)."""
    return d_port / (10.0 * d_self + 1e-4 * float(np.linalg.norm(ref)) + 1e-5 * ref.size ** 0.5)


@functools.lru_cache(maxsize=None)
def jax_zoo_step(name: str, shape: tuple, n: int, kw: tuple = (), task: str = "classification",
                 classes: int = 10, seed: int = 0):
    """The JAX package's ``name`` at ``shape`` on a seeded batch of ``n``
    (the last record masked), jitted, from the port's seeded init: (inputs,
    flax variables, dropout masks in call order, and for the batch and for
    PERTURBATIONS perturbed copies of the weights and batch: the loss,
    logits, parameter gradients and updated batch statistics)."""
    from fedml_tpu.core.tasks import get_task as jax_task
    from fedml_tpu.models import create_model as jax_create

    rng = np.random.default_rng(seed)
    if task == "nwp":
        x = rng.integers(0, classes, (n,) + shape).astype(np.int32)
        y = rng.integers(0, classes, (n,) + shape).astype(np.int32)
    else:
        x = rng.normal(size=(n,) + shape).astype(np.float32)
        y = rng.integers(0, classes, (n,)).astype(np.int32)
    m = np.ones(n, np.float32)
    m[-1] = 0.0
    jb = jax_create(name, classes, input_shape=shape, **dict(kw))
    # the port's seeded init as the flax variables (the JAX package's own
    # init traces for seconds a net; the weights are the same either way)
    from fedml_tpu_torch.models import create_model

    jv = torch_to_flax(create_model(name, classes, input_shape=shape, **dict(kw)).init(seed, "cpu"))
    jt = jax_task(task, classes)
    masks = FixedMasks(seed + 1)
    rngs = {"dropout": jax.random.key(seed + 2)} if jb.uses_dropout else {}

    def loss(p, xs):
        mutable = ["batch_stats"] if "batch_stats" in jv else []
        out, upd = jb.module.apply({**jv, "params": p}, xs, train=True, mutable=mutable,
                                   rngs=rngs)
        return jt.loss(out, jax.numpy.asarray(y), jax.numpy.asarray(m)), (out, upd)

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    real = jax.random.bernoulli
    jax.random.bernoulli = masks
    try:
        runs = []
        for i in range(1 + PERTURBATIONS):
            r = np.random.default_rng(seed + 100 + i)

            def perturb(a):
                a = np.asarray(a)
                if i == 0 or not np.issubdtype(a.dtype, np.floating):
                    return a
                return a * (1 + PERTURBATION * r.standard_normal(a.shape)).astype(a.dtype)

            (l, (out, upd)), g = step(jax.tree.map(perturb, jv["params"]),
                                      jax.numpy.asarray(perturb(x)))
            runs.append((float(l), np.asarray(out), jax.tree.map(np.asarray, g),
                         jax.tree.map(np.asarray, dict(upd).get("batch_stats", {}))))
    finally:
        jax.random.bernoulli = real
    return x, y, m, jax.tree.map(np.asarray, jv), tuple(masks.masks), runs


def assert_zoo_step_matches(name: str, shape: tuple, n: int, bn_impl: str, kw: dict = {},
                            task: str = "classification", classes: int = 10) -> dict:
    """The port's ``name`` (``bn_impl``, the kernel's plain version on the
    CPU) from JAX's variables, on the same batch and the same dropout
    masks: the logits, every parameter gradient and the updated BN
    statistics within ``_noise_bound`` of JAX's (L2 per tensor), the loss
    within ten times JAX's own largest move plus rtol 1e-5. Returns the
    worst ratio per kind."""
    from fedml_tpu_torch.core.tasks import get_task
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.convert import flax_to_torch
    from fedml_tpu_torch.ops.dropout import injected_masks

    x, y, m, jv, masks, runs = jax_zoo_step(name, shape, n, tuple(sorted(kw.items())), task,
                                            classes)
    (jl, jo, jg, js), others = runs[0], runs[1:]
    bn = "PallasBatchNorm" if bn_impl == "pallas" else None
    bundle = create_model(name, classes, input_shape=shape, bn_impl=bn_impl, **kw)
    bundle.module.load_state_dict(flax_to_torch(jv, bn_name=bn))
    bundle.module.train()
    key = torch.zeros((), dtype=torch.int64)
    with injected_masks({i: torch.from_numpy(mk) for i, mk in enumerate(masks)}):
        out = (bundle.module(torch.from_numpy(x), dropout_key=key) if bundle.uses_dropout
               else bundle.module(torch.from_numpy(x)))
    loss = get_task(task, classes).loss(out, torch.from_numpy(y), torch.from_numpy(m))
    loss.backward()
    own = max(abs(o[0] - jl) for o in others)
    assert abs(loss.item() - jl) <= 10 * own + 1e-5 * abs(jl), (loss.item(), jl, own)
    worst = {}

    def check(kind, k, got, ref, refs):
        d_self = max(float(np.linalg.norm(r - ref)) for r in refs)
        r = _noise_bound(float(np.linalg.norm(got - ref)), d_self, ref)
        worst[kind] = max(worst.get(kind, 0.0), r)
        assert r <= 1.0, (f"{name} {bn_impl} {kind} {k}: |port - jax| = "
                          f"{np.linalg.norm(got - ref):.3g}, jax's own {d_self:.3g}, "
                          f"|jax| {np.linalg.norm(ref):.3g}")

    check("logits", "", out.detach().numpy(), jo, [o[1] for o in others])
    want = flax_to_torch({"params": jg}, bn_name=bn)
    wants = [flax_to_torch({"params": o[2]}, bn_name=bn) for o in others]
    grads = {k: p.grad for k, p in bundle.module.named_parameters()}
    assert set(grads) == set(want)
    for k in want:
        check("grads", k, grads[k].numpy(), want[k].numpy(), [w[k].numpy() for w in wants])
    stats = flax_to_torch({"batch_stats": js}, bn_name=bn)
    statss = [flax_to_torch({"batch_stats": o[3]}, bn_name=bn) for o in others]
    for k in stats:
        check("bn_stats", k, bundle.module.get_buffer(k).numpy(), stats[k].numpy(),
              [s[k].numpy() for s in statss])
    return worst
