"""The port's optimizer rules (``fedml_tpu_torch/core/optim.py``) against
the optax transforms the JAX package calls.

Each client rule of ``parallel/local.make_optimizer`` and each server rule
of ``algorithms/fedopt.make_server_optimizer`` runs 8 steps of f32
gradients made by numpy from a seed, next to its optax counterpart, on the
same parameters: a conv-shaped, a matrix and a vector leaf. The gradients
shrink by half every step, so amsgrad's max over the bias-corrected second
moment binds, and the client cases run with and without weight decay.
Tolerance rtol 1e-6 / atol 1e-7 on the parameters after every step.

One case records why the port keeps its own rules:
``torch.optim.Adam(amsgrad=True)`` does not match ``optax.amsgrad``.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.fedopt import make_server_optimizer as jax_server_optimizer
from fedml_tpu.parallel.local import make_optimizer as jax_make_optimizer
from fedml_tpu_torch.algorithms.fedopt import make_server_optimizer
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.parallel.local import make_optimizer

SHAPES = [(6, 4, 3, 3), (12, 7), (9,)]
STEPS = 8


def _data(seed: int):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 0.5 ** k).astype(np.float32) for s in SHAPES]
             for k in range(STEPS)]
    return params, grads


def _run_both(otx, ttx, seed: int):
    """Step both transforms; yields (optax params, port params) after each step."""
    p0, grads = _data(seed)
    jp = [jnp.asarray(p) for p in p0]
    js = otx.init(jp)
    tp = [torch.tensor(p) for p in p0]
    ts = ttx.init(tp)
    for g in grads:
        u, js = otx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update([torch.tensor(x) for x in g], ts, tp)
        torch._foreach_add_(tp, tu)
        yield jp, tp, ts


def _assert_close(jp, tp):
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9), ("adam", 0.0),
                                           ("adamw", 0.0), ("adagrad", 0.0), ("yogi", 0.0)])
def test_client_optimizer_matches_optax(name, momentum, wd):
    for jp, tp, _ in _run_both(jax_make_optimizer(name, 0.05, momentum, wd),
                               make_optimizer(name, 0.05, momentum, wd), seed=1):
        _assert_close(jp, tp)


@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9), ("adam", 0.0),
                                           ("adagrad", 0.0), ("yogi", 0.0)])
def test_server_optimizer_matches_optax(name, momentum):
    for jp, tp, _ in _run_both(jax_server_optimizer(name, 0.1, momentum),
                               make_server_optimizer(name, 0.1, momentum), seed=2):
        _assert_close(jp, tp)


def test_amsgrad_max_binds_and_count_is_int32():
    """With shrinking gradients the bias-corrected second moment falls, so
    nu_max is no longer the current nu_hat: the case that tells the port's
    amsgrad from torch's."""
    *_, (jp, tp, ts) = list(_run_both(optax.amsgrad(0.05), optim.amsgrad(0.05), seed=3))
    st = ts[0]
    assert st["count"].dtype == torch.int32 and int(st["count"]) == STEPS
    nu_hat = [n / (1 - 0.999 ** STEPS) for n in st["nu"]]
    assert any(bool((m > h * (1 + 1e-3)).any()) for m, h in zip(st["nu_max"], nu_hat))


def test_torch_adam_amsgrad_is_not_optax_amsgrad():
    """torch's amsgrad takes the max of the raw second moment, optax's of
    the bias-corrected one: the two part well beyond this file's
    tolerance, which is why the port does not use ``torch.optim``."""
    p0, grads = _data(4)
    jp = [jnp.asarray(p) for p in p0]
    otx = optax.amsgrad(0.05)
    js = otx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = torch.optim.Adam(tp, lr=0.05, amsgrad=True)
    for g in grads:
        u, js = otx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        opt.step()
    err = max(float(np.abs(np.asarray(a) - b.detach().numpy()).max()) for a, b in zip(jp, tp))
    assert err > 1e-3


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "adagrad", "yogi"])
def test_lane_folded_state_steps_each_lane_as_its_own_client(name):
    """L = 2 lanes folded into the leading axis, with a per-lane step count
    [L]: lane 1 starts two steps after lane 0 (re-initialised at a later
    reset, as the packed program does), so their bias corrections differ.
    Each lane's block equals the same transform stepped on that lane alone."""
    L = 2
    tx = make_optimizer(name, 0.05, 0.9 if name == "sgd" else 0.0, 0.01)
    p0, grads = _data(5)
    folded = [torch.tensor(np.concatenate([p, p + 0.5])) for p in p0]
    fs = tx.init(folded, n_lanes=L)
    tensors, counts = optim.state_tensors(fs)
    init = [t.clone() for t in tensors]
    singles = [[torch.tensor(p) for p in p0], [torch.tensor(p + 0.5) for p in p0]]
    ss = [tx.init(singles[0]), None]
    for k, g in enumerate(grads):
        if k == 2:      # lane 1's client starts here: parameters, state and count reset
            for f, p in zip(folded, singles[1]):
                f.view(L, -1)[1].copy_(p.reshape(-1))
            for t, t0 in zip(tensors, init):
                t.view(L, -1)[1].copy_(t0.view(L, -1)[1])
            for c in counts:
                c[1] = 0
            ss[1] = tx.init(singles[1])
        g2 = [torch.tensor(np.concatenate([x, 2 * x])) for x in g]
        u, fs = tx.update(g2, fs, folded)
        torch._foreach_add_(folded, u)
        for lane in range(L):
            if ss[lane] is None:
                continue
            gl = [torch.tensor(x * (1 + lane)) for x in g]
            ul, ss[lane] = tx.update(gl, ss[lane], singles[lane])
            torch._foreach_add_(singles[lane], ul)
        for lane in ([0] if k < 2 else [0, 1]):    # lane 1 idles before its client
            for f, sgl in zip(folded, singles[lane]):
                np.testing.assert_allclose(f.view(L, -1)[lane].numpy(), sgl.reshape(-1).numpy(),
                                           rtol=1e-6, atol=1e-7)
    if counts:
        assert [int(c) for c in counts[0]] == [STEPS, STEPS - 2]


def test_bound_optimizer_steps_from_grads():
    """``make_optimizer(...)(params)`` binds the rule: ``step()`` applies
    the update computed from each ``.grad``; ``zero_grad()`` clears them."""
    p0, grads = _data(6)
    params = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = make_optimizer("adam", 0.05)(params)
    otx = jax_make_optimizer("adam", 0.05)
    jp = [jnp.asarray(p) for p in p0]
    js = otx.init(jp)
    for g in grads[:3]:
        opt.zero_grad()
        assert all(p.grad is None for p in params)
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        opt.step()
        u, js = otx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
    _assert_close(jp, [p.detach() for p in params])


@pytest.mark.parametrize("bad", ["rmsprop", "lamb"])
def test_unknown_names_raise(bad):
    """As in the JAX package: the optimizer factories refuse an unknown
    name, so an API given one fails when it is constructed; names are
    case-blind."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    for build in (make_optimizer, make_server_optimizer, jax_make_optimizer,
                  jax_server_optimizer):
        with pytest.raises(ValueError):
            build(bad, 0.1)
    ds = make_synthetic_classification("names", (4,), 3, 2, records_per_client=4, batch_size=2)
    cfg = FedConfig(client_num_in_total=2, client_num_per_round=2, batch_size=2)
    with pytest.raises(ValueError):
        FedAvgAPI(ds, cfg.replace(client_optimizer=bad), device="cpu")
    with pytest.raises(ValueError):
        FedOptAPI(ds, cfg.replace(server_optimizer=bad), device="cpu")
    assert FedOptAPI(ds, cfg.replace(client_optimizer="Adam", server_optimizer="YOGI"),
                     device="cpu").server_state["opt"]


@pytest.mark.parametrize("momentum", [0.9, 0.5])
def test_nesterov_sgd_matches_optax(momentum):
    """``sgd(lr, momentum, nesterov=True)``: FedGKT's client and server rule
    (``optax.sgd(lr, momentum=0.9, nesterov=True)``, fedml_tpu/algorithms/
    fedgkt.py:66-75)."""
    for jp, tp, _ in _run_both(optax.sgd(0.05, momentum=momentum, nesterov=True),
                               optim.sgd(0.05, momentum, nesterov=True), seed=3):
        _assert_close(jp, tp)


@pytest.mark.parametrize("nesterov", [False, True])
def test_trace_matches_optax(nesterov):
    for jp, tp, ts in _run_both(optax.trace(0.9, nesterov=nesterov),
                                optim.trace(0.9, nesterov), seed=4):
        _assert_close(jp, tp)
