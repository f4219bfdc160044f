"""FedGKT and its split ResNet pair: the port against the JAX package.

- ``kl_distill`` and ``masked_ce`` against JAX's at rtol 1e-6 (masked rows,
  two temperatures); ``_gkt_optimizer`` (nesterov SGD with and without
  weight decay, and the amsgrad branch) over 8 steps at rtol 1e-6 / atol
  1e-7 (tests/test_torch_optim.py's).
- Both halves at CI depth from the JAX package's own init
  (``models/convert.flax_to_torch``), under ``bn_impl`` "xla" and "pallas"
  (K1/K2's plain version on the CPU): a train-mode forward, the gradient of
  CE + KL (and, for the client, of its feature map) and the updated BN
  statistics, f32, rtol 1e-4 / atol 1e-5. The default pair (resnet8 /
  resnet56_server) has 7 and 38 train-mode BNs, the K1/K2 launches of a
  client and a server step; ``gkt_blocks_from_names`` equals JAX's.
- The stacked client init: ``vmap(init)`` over the clients' keys converts
  with ``stacked=True`` to ``[C, ...]`` tensors whose slice i is client i's
  state dict, and back bit for bit.
- One FedGKT round against JAX's, held from JAX's state: round 0 from
  JAX's init (kl_w 0 for the clients), and round 1 from JAX's state after
  round 0 (client and server weights, optimizer states and server logits;
  kl_w = alpha), with JAX's orders injected (each client's from
  ``split(split(fold_in(round_key, 1), C)[i], epochs)``, the server's from
  ``split(fold_in(round_key, 2), epochs_server)``): client and server
  variables, client logits, features and new server logits rtol 1e-4 /
  atol 1e-5, losses rtol 1e-5, and the evaluation's sums after the round
  rtol 1e-5 (its per-client test shards bit-equal to JAX's). Each round
  starts from JAX's state because chained BN rounds
  at batch 4 jump between outcomes at 1e-7 perturbations (ROADMAP §3).
- a one-rank ``server_mesh`` trains the round of no mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.fedgkt import FedGKTAPI as JaxFedGKTAPI
from fedml_tpu.algorithms.fedgkt import _gkt_optimizer as jax_gkt_optimizer
from fedml_tpu.algorithms.fedgkt import kl_distill as jax_kl_distill
from fedml_tpu.algorithms.fedgkt import masked_ce as jax_masked_ce
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import round_key
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models.gkt import create_gkt_pair as jax_create_gkt_pair
from fedml_tpu.models.gkt import gkt_blocks_from_names as jax_gkt_blocks
from fedml_tpu_torch.algorithms.fedgkt import (FedGKTAPI, _gkt_optimizer, kl_distill,
                                               masked_ce)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.gkt import create_gkt_pair, gkt_blocks_from_names
from fedml_tpu_torch.models.norm import PallasBatchNorm

SEED = 5
DATA = dict(name="gkt", input_shape=(8, 8, 3), classes=3, num_clients=4, records_per_client=8,
            partition_method="hetero", partition_alpha=0.5, batch_size=4, seed=3)
RUN = dict(model="lr", dataset="gkt", client_num_in_total=4, client_num_per_round=4,
           comm_round=2, epochs=2, epochs_server=2, batch_size=4, lr=0.05, seed=SEED,
           frequency_of_the_test=1, temperature=2.0, alpha_distill=0.5)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- the losses and the optimizer -------------------------------------------------


@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_kl_distill_and_masked_ce_match_jax(temperature):
    rng = np.random.default_rng(0)
    s, t = (rng.normal(size=(6, 5)).astype(np.float32) * 3 for _ in range(2))
    y = rng.integers(0, 5, 6).astype(np.int32)
    m = np.array([1, 1, 0, 1, 0, 1], np.float32)
    got = kl_distill(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(m), temperature)
    want = jax_kl_distill(jnp.asarray(s), jnp.asarray(t), jnp.asarray(m), temperature)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = masked_ce(torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(jax_masked_ce(jnp.asarray(s), jnp.asarray(y),
                                                               jnp.asarray(m))), rtol=1e-6)


@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("sgd", 5e-4), ("adam", 0.0)])
def test_gkt_optimizer_matches_optax(name, wd):
    rng = np.random.default_rng(1)
    shapes = [(6, 4, 3, 3), (12, 7), (9,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    otx, ttx = jax_gkt_optimizer(name, 0.05, wd), _gkt_optimizer(name, 0.05, wd)
    jp = [jnp.asarray(p) for p in params]
    js = otx.init(jp)
    tp = [torch.tensor(p) for p in params]
    ts = ttx.init(tp)
    for k in range(8):
        g = [(rng.normal(size=s) * 0.5 ** k).astype(np.float32) for s in shapes]
        u, js = otx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update([torch.tensor(x) for x in g], ts, tp)
        torch._foreach_add_(tp, tu)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


# -- the nets --------------------------------------------------------------------


@pytest.mark.parametrize("names", [("resnet8", "resnet56_server"), ("resnet4", "resnet32_server"),
                                   ("resnet20", "resnet110_server"), ("r2", "r8")])
def test_gkt_blocks_from_names_match_jax(names):
    assert gkt_blocks_from_names(*names) == jax_gkt_blocks(*names)


def test_default_pair_has_7_and_38_train_mode_bns():
    pair = create_gkt_pair(10, bn_impl="pallas")
    count = [sum(isinstance(m, PallasBatchNorm) and m.use_kernel for m in half.module.modules())
             for half in (pair.client, pair.server)]
    assert count == [7, 38] and pair.feature_shape == (32, 32, 16)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("half", ["client", "server"])
def test_gkt_half_forward_backward_matches_jax(half, bn_impl):
    rng = np.random.default_rng(2)
    jpair = jax_create_gkt_pair(3, input_shape=(8, 8, 3), client_blocks=1,
                                server_blocks_per_stage=1)
    jb = getattr(jpair, half)
    x = rng.normal(size=(6,) + tuple(jb.input_shape)).astype(np.float32)
    y = rng.integers(0, 3, 6).astype(np.int32)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    m = np.array([1, 1, 1, 1, 1, 0], np.float32)
    r = rng.normal(size=(6, 8, 8, 16)).astype(np.float32) * 1e-2
    jvars = jb.init(jax.random.key(SEED))

    def loss_of(logits, feats, xp):
        out = xp["ce"](logits, y, m) + 0.5 * xp["kl"](logits, t, m, 2.0)
        return out if feats is None else out + (feats * xp["r"]).sum()

    def jloss(params):
        out, upd = jb.apply_train({**jvars, "params": params}, jnp.asarray(x))
        logits, feats = out if half == "client" else (out, None)
        return loss_of(logits, feats, {"ce": jax_masked_ce, "kl": jax_kl_distill,
                                       "r": jnp.asarray(r)}), (out, upd)

    (jl, (jout, jupd)), jg = jax.value_and_grad(jloss, has_aux=True)(jvars["params"])
    bn = "PallasBatchNorm" if bn_impl == "pallas" else None
    pair = create_gkt_pair(3, input_shape=(8, 8, 3), client_blocks=1, server_blocks_per_stage=1,
                           bn_impl=bn_impl)
    module = getattr(pair, half).module
    module.load_state_dict(flax_to_torch(_np(jvars), bn_name=bn))
    module.train()
    out = module(torch.from_numpy(x))
    logits, feats = out if half == "client" else (out, None)
    tl = loss_of(logits, feats, {"ce": lambda a, b, c: masked_ce(a, torch.from_numpy(b),
                                                                 torch.from_numpy(c)),
                                 "kl": lambda a, b, c, T: kl_distill(a, torch.from_numpy(b),
                                                                     torch.from_numpy(c), T),
                                 "r": torch.from_numpy(r)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for got, want in zip(out if half == "client" else (out,),
                         jout if half == "client" else (jout,)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = flax_to_torch({"params": _np(jg)}, bn_name=bn)
    for k, g in grads.items():
        np.testing.assert_allclose(module.get_parameter(k).grad.numpy(), g.numpy(), **TOL,
                                   err_msg=k)
    for k, v in flax_to_torch({"batch_stats": _np(jupd["batch_stats"])}, bn_name=bn).items():
        np.testing.assert_allclose(module.get_buffer(k).numpy(), v.numpy(), **TOL, err_msg=k)


def test_stacked_client_init_converts_slice_by_slice():
    jpair = jax_create_gkt_pair(3, input_shape=(8, 8, 3), client_blocks=1,
                                server_blocks_per_stage=1)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(SEED), 1), 3)
    stacked = _np(jax.vmap(jpair.client.init)(keys))
    got = flax_to_torch(stacked, stacked=True)
    for i in range(3):
        one = flax_to_torch(jax.tree.map(lambda a: a[i], stacked))
        assert set(one) == set(got)
        for k, v in one.items():
            assert torch.equal(got[k][i], v), k
    back = torch_to_flax(got, stacked=True)
    for (pa, a), (pb, b) in zip(*(jax.tree_util.tree_flatten_with_path(t)[0]
                                  for t in (stacked, back))):
        assert pa == pb and np.array_equal(a, b)


# -- the rounds ------------------------------------------------------------------


def _jax_round(japi, rnd):
    """One round of the JAX API, as its ``train`` runs it."""
    d, cfg = japi.dataset, japi.config
    x, y, mask, counts = (jnp.asarray(a) for a in (d.train_x, d.train_y, d.train_mask,
                                                    d.train_counts))
    kl_w = jnp.float32(0.0 if rnd == 0 else cfg.alpha_distill)
    rkey = round_key(japi.root_key, rnd)
    japi.client_vars, japi.client_opt, feats, clogits, closs = japi._client_phase(
        japi.client_vars, japi.client_opt, x, y, mask, counts, japi.server_logits, kl_w,
        jax.random.fold_in(rkey, 1))
    japi.server_vars, japi.server_opt, japi.server_logits, sloss = japi._server_phase(
        japi.server_vars, japi.server_opt, feats, y, mask, clogits, jax.random.fold_in(rkey, 2))
    return feats, clogits, closs, sloss


def _perms(key, epochs, n):
    return [torch.from_numpy(np.asarray(jax.random.permutation(k, n)).astype(np.int64))
            for k in jax.random.split(key, epochs)]


def _hooks(japi):
    C, n_pad, cfg = japi.C, japi.n_pad, japi.config

    def clients(r, i):
        rk = round_key(japi.root_key, r)
        return _perms(jax.random.split(jax.random.fold_in(rk, 1), C)[i], cfg.epochs, n_pad)

    def server(r):
        return _perms(jax.random.fold_in(round_key(japi.root_key, r), 2), cfg.epochs_server,
                      C * n_pad)

    return clients, server


def _opt_state(trace_tree, names, bn, stacked=False):
    """A flax momentum tree -> tensors in the order of ``names``."""
    flat = flax_to_torch({"params": _np(trace_tree)}, bn_name=bn, stacked=stacked)
    return [flat[k] for k in names]


def _load_from_jax(api, japi, bn):
    """Every piece of JAX's state into the port's API."""
    api.client_vars = flax_to_torch(_np(japi.client_vars), bn_name=bn, stacked=True)
    api.server_vars = flax_to_torch(_np(japi.server_vars), bn_name=bn)
    # nesterov SGD without decay: optax's state is (EmptyState, (TraceState, EmptyState))
    cnames = [k for k, _ in api.pair.client.module.named_parameters()]
    snames = [k for k, _ in api.pair.server.module.named_parameters()]
    api.client_opt = _opt_state(japi.client_opt[1][0].trace, cnames, bn, stacked=True)
    torch._foreach_copy_(api._sopt.tensors(), _opt_state(japi.server_opt[1][0].trace, snames, bn))
    api.server_logits = torch.from_numpy(np.array(japi.server_logits))


@pytest.mark.parametrize("rnd,bn_impl", [(0, "xla"), (1, "pallas")])
def test_fedgkt_round_matches_jax(rnd, bn_impl):
    jds, ds = jax_synthetic(**DATA), make_synthetic_classification(**DATA)
    japi = JaxFedGKTAPI(jds, JaxFedConfig(**RUN), client_blocks=1, server_blocks_per_stage=1)
    for r in range(rnd):
        _jax_round(japi, r)
    bn = "PallasBatchNorm" if bn_impl == "pallas" else None
    clients, server = _hooks(japi)
    api = FedGKTAPI(ds, FedConfig(**RUN), create_gkt_pair(
        3, (8, 8, 3), client_blocks=1, server_blocks_per_stage=1, bn_impl=bn_impl),
        device="cpu", order_hook=clients, server_order_hook=server)
    _load_from_jax(api, japi, bn)
    feats, clogits, closs, sloss = _jax_round(japi, rnd)
    got_closs, got_sloss = api.run_round(rnd)
    np.testing.assert_allclose(got_closs.numpy(), np.asarray(closs), rtol=1e-5)
    np.testing.assert_allclose(float(got_sloss), float(sloss), rtol=1e-5)
    np.testing.assert_allclose(api._feats.numpy(), np.asarray(feats), **TOL)
    np.testing.assert_allclose(api._clogits.numpy(), np.asarray(clogits), **TOL)
    np.testing.assert_allclose(api.server_logits.numpy(), np.asarray(japi.server_logits), **TOL)
    for got, want, stacked in ((api.client_vars, japi.client_vars, True),
                               (api.server_vars, japi.server_vars, False)):
        want = flax_to_torch(_np(want), bn_name=bn, stacked=stacked)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)
    for a, b in zip(api._build_test_shards(), japi._test_shards):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sums = api.evaluate()
    jsums = japi._eval_fn(japi.client_vars, japi.server_vars,
                          *(jnp.asarray(a) for a in japi._test_shards))
    for k in ("correct", "loss_sum", "count"):
        np.testing.assert_allclose(sums[k], float(jsums[k]), rtol=1e-5, err_msg=k)


def test_train_history_and_shapes():
    ds = make_synthetic_classification(**DATA)
    api = FedGKTAPI(ds, FedConfig(**RUN), client_blocks=1, server_blocks_per_stage=1,
                    device="cpu")
    last = api.train()
    assert [h["round"] for h in api.history] == [0, 1] and last is api.history[-1]
    assert set(last) == {"round", "Test/Acc", "Test/Loss", "Train/ClientLoss",
                         "Train/ServerLoss"}
    assert all(np.isfinite(v) for v in last.values())
    assert api.server_logits.shape == (4, ds.train_x.shape[1], 3)
    assert api.round_steps() == (2 * int(sum(-(-c // 4) for c in ds.train_counts)),
                                 2 * -(-int(ds.train_counts.sum()) // 4))


def test_server_mesh_is_refused():
    """The data-parallel server is ported: a mesh larger than the process
    group is refused, and a one-rank server mesh trains the round of no
    mesh (more ranks: tests/test_torch_dataparallel.py)."""
    from fedml_tpu_torch.parallel.dataparallel import batch_mesh

    ds = make_synthetic_classification(**DATA)
    with pytest.raises(ValueError, match="ranks"):
        FedGKTAPI(ds, FedConfig(**RUN), server_mesh=batch_mesh(2, device="cpu"), device="cpu")
    runs = []
    for mesh in (None, batch_mesh(1, device="cpu")):
        api = FedGKTAPI(ds, FedConfig(**RUN), client_blocks=1, server_blocks_per_stage=1,
                        server_mesh=mesh, device="cpu")
        runs.append((api.run_round(0), api.server_vars))
    (l0, v0), (l1, v1) = runs
    assert torch.equal(l0[0], l1[0]) and torch.equal(l0[1], l1[1])
    assert all(torch.equal(v0[k], v1[k]) for k in v0)
