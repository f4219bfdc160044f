"""The joint packed conv lowerings (``packed_conv`` ``"blockdiag"`` and
``"grouped"``) against the JAX package's ``ops/packed_conv.py`` and its
``conv_impl="packed"`` twins, at tests/test_packed_conv.py's sizes and
tolerances.

- The lowerings on the JAX layout (``lane_major``): forward rtol/atol 1e-4
  and both gradients 1e-3 at C = 16 against the JAX functions (C = 32, 64
  against the port's per-lane ``conv_vmap``); stride 2, 1x1 and the cnn's
  5x5 SAME forward 1e-4.
- ``block_diag_weight`` / ``block_diag_unstack``: a bit-exact round trip,
  zero off-diagonal blocks, and the block weight bit-equal to JAX's; the
  patch columns (``patches``, and ``F.unfold`` over the channels-first view)
  bit-equal to JAX's ``_patches``.
- The ResNet-20 and ``cnn`` twins under each lowering against JAX's packed
  twins, lanes of different weights converted by ``models/convert.py``:
  train-mode logits and BN statistics rtol 1e-4 / atol 1e-5.
- Two packed rounds of resnet20 (8x8x3, 8 clients, 4 lanes, lr 0.005), JAX's
  orders injected: the port's ``blockdiag`` and ``grouped`` rounds against
  JAX's same-lowering rounds at 2 x W_RTOL / 4 x W_ATOL, losses rtol 1e-2
  (tests/test_packed_conv.py:155-192), chained at ``E2E_SEED`` and, at
  JAX's seed 0, each round from JAX's weights before it (the note at
  ``E2E_SEED`` says why); ``grouped`` equal to ``off`` bit
  for bit (one conv call). FedOpt (server sgd, momentum) under ``blockdiag``
  against JAX's at W_RTOL / 2 x W_ATOL (tests/test_packed_everywhere.py:
  183-207); each zoo algorithm and client adam under ``blockdiag`` against
  ``off`` (:183-224's bounds); FedProx's reported loss with its prox term
  (rtol 1e-4, tests/test_packed_conv.py:232).
- The one-rank cross-silo packed mesh and a streamed packed host round
  under ``blockdiag``: the mesh against the simulation round (relative norm
  1e-5, tests/test_crosssilo.py:40) and against its ``off`` round (W_RTOL /
  W_ATOL, tests/test_packed_conv.py:261, port only, so cheap); the streamed
  round against the batch host round (rtol 1e-5 / atol 1e-6).
- ``packed_status``, ``packed_fallback_reason`` and the once-only fallback
  warning equal to the JAX package's for resnet20, the lanes body, ``cnn``,
  ``lr`` and ``transformer``; dropout models and ``"auto"`` refused naming
  their ROADMAP items (8 and 12).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.ops import packed_conv as jpc
from fedml_tpu.parallel import packed as jax_packed
from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
from fedml_tpu_torch.algorithms.fedprox import FedProxAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.ops import packed_conv as pc
from fedml_tpu_torch.parallel import packed

# tests/test_packed_conv.py's equivalence scale
W_RTOL, W_ATOL = 1e-2, 1.5e-3
IMPLS = ("blockdiag", "grouped")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models: one intra-op thread keeps the suite's parallel workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# -- the lowerings ----------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_conv_forward_and_grads_match_jax(impl):
    rng = np.random.RandomState(16)
    K, N, hw, ci, co = 4, 2, 8, 16, 16
    xs = rng.randn(K, N, hw, hw, ci).astype(np.float32)
    ws = (rng.randn(K, 3, 3, ci, co) * 0.1).astype(np.float32)
    fn = {"blockdiag": jpc.conv_blockdiag, "grouped": jpc.conv_grouped}[impl]
    want, (gx_j, gw_j) = jax.value_and_grad(
        lambda x, w: jnp.sum(fn(x, w) ** 2), argnums=(0, 1))(xs, ws)
    x, w = _t(xs).requires_grad_(), _t(ws).requires_grad_()
    y = pc.lane_major(impl, x, w)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(fn(xs, ws)), rtol=1e-4, atol=1e-4)
    y.square().sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_j), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw_j), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ci,hw", [(32, 8), (64, 4)])
@pytest.mark.parametrize("impl", IMPLS)
def test_wider_convs_match_the_per_lane_reference(impl, ci, hw):
    """The flagship's wider stages against the port's per-lane convs (the
    JAX test runs these widths on its slow lane)."""
    rng = np.random.RandomState(ci)
    x = _t(rng.randn(4, 2, hw, hw, ci)).requires_grad_()
    w = _t(rng.randn(4, 3, 3, ci, ci) * 0.1).requires_grad_()
    y = pc.lane_major(impl, x, w)
    gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
    ref = pc.lane_major("vmap", xr, wr)
    rx, rw = torch.autograd.grad(ref.square().sum(), (xr, wr))
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gw.numpy(), rw.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_stride2_1x1_and_5x5_match_jax(impl):
    rng = np.random.RandomState(7)
    xs = rng.randn(3, 2, 8, 8, 16).astype(np.float32)
    fn = {"blockdiag": jpc.conv_blockdiag, "grouped": jpc.conv_grouped}[impl]
    for ks, s in ((3, 2), (1, 2), (1, 1), (5, 1)):
        ws = (rng.randn(3, ks, ks, 16, 8) * 0.1).astype(np.float32)
        np.testing.assert_allclose(pc.lane_major(impl, _t(xs), _t(ws), s).numpy(),
                                   np.asarray(fn(xs, ws, s)), rtol=1e-4, atol=1e-4,
                                   err_msg=f"{impl} k={ks} s={s}")


def _fold(ws: np.ndarray) -> torch.Tensor:
    """Stacked HWIO [K, kh, kw, Ci, Co] -> the twin's folded OIHW leaf."""
    k, kh, kw, ci, co = ws.shape
    return _t(ws.transpose(0, 4, 3, 1, 2).reshape(k * co, ci, kh, kw))


def test_block_weight_round_trip_is_bit_exact_and_equal_to_jax():
    rng = np.random.RandomState(0)
    for (k, kh, ci, co) in ((4, 3, 16, 16), (8, 3, 32, 8), (2, 1, 64, 64)):
        ws = rng.randn(k, kh, kh, ci, co).astype(np.float32)
        w = _fold(ws)
        wbd = pc.block_diag_weight(w, k)
        assert wbd.shape == (k * ci * kh * kh, k * co)
        np.testing.assert_array_equal(wbd.numpy(), np.asarray(jpc.block_diag_weight(ws)))
        assert torch.equal(pc.block_diag_unstack(wbd, k, kh, kh, ci, co), w)
        dense = wbd.numpy().reshape(k, ci * kh * kh, k, co)
        for i in range(k):
            for j in range(k):
                if i != j:
                    assert not dense[i, :, j, :].any()


def test_blockdiag_output_is_the_gemm_output():
    """No copy between the GEMM and the BatchNorm: after ``aten.mm`` the
    lowering runs views only, so the BN (K1 on the card) reads the GEMM's
    row-major [rows, L*Co] buffer itself."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    x, w = torch.randn(2, 8, 8, 3 * 4), torch.randn(3 * 5, 4, 3, 3)
    with Ops() as mode:
        y = pc.conv_blockdiag(x, w, 3)
    after = mode.ops[mode.ops.index("mm") + 1:]
    assert "mm" in mode.ops and set(after) <= {"view", "_unsafe_view"}, mode.ops
    assert y.shape == (2, 8, 8, 15) and y.is_contiguous()


def test_block_weight_gradient_reaches_only_the_diagonal():
    w = torch.randn(3 * 4, 2, 3, 3, requires_grad=True)
    g = torch.autograd.grad(pc.block_diag_weight(w, 3).sum(), w)[0]
    assert torch.equal(g, torch.ones_like(w))       # each kernel entry once, no cross-lane term


@pytest.mark.parametrize("ks,s", [(3, 1), (3, 2), (1, 2), (5, 1)])
def test_patch_columns_equal_jax(ks, s):
    """Column l*R + c*kh*kw + tap of the folded layout's patches is JAX's
    lane-l patch feature c*kh*kw + tap, bit for bit (a gather moves values)."""
    rng = np.random.RandomState(ks * 10 + s)
    K, N, hw, ci = 3, 2, 8, 4
    xs = rng.randn(K, N, hw, hw, ci).astype(np.float32)
    want = np.asarray(jpc._patches(xs, ks, ks, s, "SAME"))            # [K, N, Ho, Wo, R]
    x = _t(xs.transpose(1, 2, 3, 0, 4).reshape(N, hw, hw, K * ci))
    got = pc.patches(x, ks, ks, s).numpy()                              # [N, Ho, Wo, K*R]
    np.testing.assert_array_equal(got.reshape(*got.shape[:3], K, -1).transpose(3, 0, 1, 2, 4),
                                  want)
    (pt, pb), (pl, pr) = pc.same_pads(hw, ks, s), pc.same_pads(hw, ks, s)
    cols = F.unfold(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)), ks, stride=s)
    np.testing.assert_array_equal(cols.transpose(1, 2).reshape(got.shape).numpy(), got)


# -- the twins ----------------------------------------------------------------------

def _jax_stack(trees):
    return jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *trees)


def _port_fold(trees) -> dict:
    states = [flax_to_torch(jax.tree.map(np.asarray, t)) for t in trees]
    return {k: torch.cat([s[k] for s in states]) for k in states[0]}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("model,shape", [("resnet20", (8, 8, 3)), ("cnn", (12, 12, 1))])
def test_twin_matches_the_jax_packed_twin(model, shape, impl):
    K = 3
    jb = jax_create_model(model, 4, input_shape=shape)
    trees = [jb.init(jax.random.PRNGKey(lane), 2) for lane in range(K)]
    x = np.random.RandomState(0).randn(K, 2, *shape).astype(np.float32)
    logits_j, new_j = jb.packed_variant(impl).apply_train(_jax_stack(trees), x,
                                                          jax.random.PRNGKey(2))
    twin = create_model(model, 4, input_shape=shape).module.lane_stacked(K, packed_impl=impl)
    twin.load_state_dict(_port_fold(trees))
    twin.train()
    logits = twin(_t(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), rtol=1e-4,
                               atol=1e-5)
    if "batch_stats" in new_j:
        want = _port_fold([jax.tree.map(lambda a, i=lane: a[i], new_j) for lane in range(K)])
        for k, v in twin.named_buffers():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


# -- end to end: two packed rounds against the JAX package's --------------------------

def _data(fn):
    # tests/test_packed_conv.py:_conv_ds
    return fn("packedconv-t", (8, 8, 3), 4, 8, records_per_client=24, partition_method="hetero",
              partition_alpha=0.4, batch_size=4, seed=3)


# The chained two-round parity's seed (FedConfig.seed: the initial weights
# and the orders). Two rounds of batch-4 BN training amplify one-ULP
# differences, and at some seeds they jump between outcomes.
# tests/torch_packed_conv_seeds.py prints, as shares of the end-to-end bound,
# on a CPU: at seed 0 the port's blockdiag lies 3.04x from JAX's after two
# rounds (0.216x after one), and 1e-7 (relative) perturbations of the
# initial weights move the port's own rounds up to 2.87x (blockdiag, 16
# draws) and 3.19x (off), their first rounds into the same 0.21x cluster;
# JAX's own blockdiag lies 3.53x, 2.13x, 1.19x from its off at seeds 1, 2,
# 4. The jump is one tensor, BasicBlock_6.BatchNorm_0's running mean (stage
# 3's entry BN, 16 rows a channel), which off shows too. At seed 3 every pair
# lies within 0.002x and the perturbed rounds within 0.022x. JAX's seed 0 is
# held round by round (test_each_round_matches_jax_from_its_start): each
# round from JAX's weights before it, so no jump compounds.
E2E_SEED = 3


def _run_cfg(**kw) -> dict:
    # tests/test_packed_conv.py:_conv_cfg (lr 0.005: its docstring's margin)
    return {**dict(model="resnet20", dataset="x", client_num_in_total=8, client_num_per_round=8,
                   comm_round=2, batch_size=4, epochs=1, lr=0.005, momentum=0.0, seed=0,
                   frequency_of_the_test=1000, pack_lanes=4, device_data="on"), **kw}


def _jax_orders(seed: int, round_idx: int, cohort: int, n_pad: int, epochs: int = 1):
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    return [[torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
             for ek in jax.random.split(ck, epochs)]
            for ck in jax.random.split(rk, cohort)]


def _port_api(ds, cfg: dict, jvars, cls=FedAvgAPI):
    n_pad, cohort = ds.train_x.shape[1], cfg["client_num_per_round"]
    orders = {}

    def hook(r, i):
        if r not in orders:
            orders[r] = _jax_orders(cfg["seed"], r, cohort, n_pad, cfg["epochs"])
        return orders[r][i]

    api = cls(ds, FedConfig(**cfg), create_model(cfg["model"], ds.class_num,
                                                 input_shape=ds.train_x.shape[2:]),
              device="cpu", order_hook=hook)
    api.variables = flax_to_torch(jax.tree.map(np.asarray, jvars))
    return api


def _assert_vars(api, want_vars, rtol, atol, what=""):
    want = flax_to_torch(jax.tree.map(np.asarray, want_vars))
    assert want.keys() == api.variables.keys()
    for k, v in want.items():
        np.testing.assert_allclose(api.variables[k].numpy(), v.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def jax_rounds():
    """JAX's two packed rounds under each lowering, from its initial weights."""
    jds = _data(jax_synthetic)
    out = {}
    for impl in IMPLS:
        bundle = jax_create_model("resnet20", jds.class_num, input_shape=jds.train_x.shape[2:])
        japi = JaxFedAvgAPI(jds, JaxFedConfig(**_run_cfg(packed_conv=impl, seed=E2E_SEED)),
                            bundle)
        init = jax.tree.map(np.asarray, japi.variables)
        losses = [float(japi.run_round(r)) for r in range(2)]
        out[impl] = (init, losses, jax.tree.map(np.asarray, japi.variables),
                     japi.packed_status())
    return out


@pytest.fixture(scope="module")
def port_rounds(jax_rounds):
    """The port's two packed rounds under each lowering and ``off``."""
    ds = _data(make_synthetic_classification)
    init = jax_rounds["blockdiag"][0]
    out = {}
    for impl in ("off", *IMPLS):
        api = _port_api(ds, _run_cfg(packed_conv=impl, seed=E2E_SEED), init)
        losses = [float(api.run_round(r)) for r in range(2)]
        out[impl] = (api, losses)
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_packed_rounds_match_jax_same_lowering(impl, jax_rounds, port_rounds):
    """Hetero cohort over 4 lanes (ragged lanes, dead steps, LPT tails)."""
    _, j_losses, j_vars, j_status = jax_rounds[impl]
    api, losses = port_rounds[impl]
    assert api.packed_status() == j_status == {"scheduled": True, "packed_conv_active": True,
                                               "reason": None}
    assert api._packed_train.packed_conv == impl
    np.testing.assert_allclose(losses, j_losses, rtol=1e-2)
    _assert_vars(api, j_vars, 2 * W_RTOL, 4 * W_ATOL, impl)


@pytest.fixture(scope="module")
def jax_rounds_seed0():
    """JAX's two packed rounds under each lowering at its tests' seed 0:
    the weights before each round and after the last, and the losses."""
    jds = _data(jax_synthetic)
    out = {}
    for impl in IMPLS:
        bundle = jax_create_model("resnet20", jds.class_num, input_shape=jds.train_x.shape[2:])
        japi = JaxFedAvgAPI(jds, JaxFedConfig(**_run_cfg(packed_conv=impl, seed=0)), bundle)
        states, losses = [jax.tree.map(np.asarray, japi.variables)], []
        for r in range(2):
            losses.append(float(japi.run_round(r)))
            states.append(jax.tree.map(np.asarray, japi.variables))
        out[impl] = (states, losses)
    return out


@pytest.mark.parametrize("round_idx", [0, 1])
@pytest.mark.parametrize("impl", IMPLS)
def test_each_round_matches_jax_from_its_start(impl, round_idx, jax_rounds_seed0):
    """JAX's seed 0, each round from JAX's weights before it, against JAX's
    round at the end-to-end bound (the chained rounds' note says why)."""
    states, losses = jax_rounds_seed0[impl]
    api = _port_api(_data(make_synthetic_classification),
                    _run_cfg(packed_conv=impl, seed=0), states[round_idx])
    loss = float(api.run_round(round_idx))
    np.testing.assert_allclose(loss, losses[round_idx], rtol=1e-2)
    _assert_vars(api, states[round_idx + 1], 2 * W_RTOL, 4 * W_ATOL, f"{impl} round {round_idx}")


def test_grouped_round_equals_off_bit_for_bit(port_rounds):
    (off, l_off), (grouped, l_grouped) = port_rounds["off"], port_rounds["grouped"]
    assert off.packed_status()["reason"] == "packed_conv=off"
    assert l_off == l_grouped
    for k, v in off.variables.items():
        assert torch.equal(grouped.variables[k], v), k


# tests/test_packed_everywhere.py's FedOpt arm: a stateful server (momentum)
FEDOPT_SGD_KW = dict(server_optimizer="sgd", server_momentum=0.9, server_lr=0.05)


def test_fedopt_blockdiag_round_matches_jax():
    def data(fn):     # tests/test_packed_everywhere.py:_ds(shape=(8, 8, 3), records=12, seed=3)
        return fn("pe", (8, 8, 3), 4, 8, records_per_client=12, partition_method="hetero",
                  partition_alpha=0.4, batch_size=4, seed=3)

    cfg = _run_cfg(dataset="pe", comm_round=1, packed_conv="blockdiag", **FEDOPT_SGD_KW)
    jds = data(jax_synthetic)
    japi = JaxFedOptAPI(jds, JaxFedConfig(**cfg),
                        jax_create_model("resnet20", 4, input_shape=(8, 8, 3)))
    api = _port_api(data(make_synthetic_classification), cfg, japi.variables, FedOptAPI)
    assert api.packed_status() == japi.packed_status()
    np.testing.assert_allclose(float(api.run_round(0)), float(japi.run_round(0)), rtol=1e-2)
    _assert_vars(api, japi.variables, W_RTOL, 2 * W_ATOL, "fedopt")


@pytest.mark.parametrize("algo", ["fedopt", "fedprox", "fednova", "fedagc", "client-adam"])
def test_zoo_blockdiag_round_matches_off(algo):
    """Each algorithm's packed round under blockdiag against the same round
    under off (tests/test_packed_everywhere.py:183-224, port only): one
    heterogeneous round, W_RTOL / 2 x W_ATOL and losses rtol 1e-2; client
    adam at that file's loose bounds (amsgrad's ~±lr steps flip on one-ULP
    gradient differences): losses rtol 5e-3, weights atol 0.05."""
    from fedml_tpu_torch.algorithms.fedagc import FedAGCAPI
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI

    cls, kw = {"fedopt": (FedOptAPI, FEDOPT_SGD_KW), "fedprox": (FedProxAPI, dict(fedprox_mu=0.5)),
               "fednova": (FedNovaAPI, dict(momentum=0.9)), "fedagc": (FedAGCAPI, {}),
               "client-adam": (FedAvgAPI, dict(client_optimizer="adam", lr=0.002))}[algo]
    ds = make_synthetic_classification("pe", (8, 8, 3), 4, 8, records_per_client=12,
                                       partition_method="hetero", partition_alpha=0.4,
                                       batch_size=4, seed=3)

    def run(impl):
        api = cls(ds, FedConfig(**_run_cfg(dataset="pe", comm_round=1, packed_conv=impl, **kw)),
                  create_model("resnet20", 4, input_shape=(8, 8, 3)), device="cpu")
        assert api._packed_train.packed_conv == impl
        return api, float(api.run_round(0))

    (off, l_off), (bd, l_bd) = run("off"), run("blockdiag")
    adam = algo == "client-adam"
    np.testing.assert_allclose(l_bd, l_off, rtol=5e-3 if adam else 1e-2)
    for k, v in off.variables.items():
        np.testing.assert_allclose(bd.variables[k].numpy(), v.numpy(), rtol=0 if adam else W_RTOL,
                                   atol=0.05 if adam else 2 * W_ATOL, err_msg=k)


def test_fedprox_blockdiag_loss_reports_the_prox_term():
    """tests/test_packed_conv.py:232: lr tiny and mu large, so the term
    dominates the reported loss; the blockdiag round reports the off
    round's loss."""
    ds = make_synthetic_classification("packedconv-prox", (8, 8, 3), 4, 8, records_per_client=16,
                                       partition_method="homo", partition_alpha=0.5,
                                       batch_size=4, seed=2)

    def run(impl):
        cfg = _run_cfg(comm_round=1, lr=1e-5, fedprox_mu=5.0, packed_conv=impl)
        api = FedProxAPI(ds, FedConfig(**cfg), create_model("resnet20", 4, input_shape=(8, 8, 3)),
                         device="cpu")
        return float(api.run_round(0))

    np.testing.assert_allclose(run("blockdiag"), run("off"), rtol=1e-4)


def _rel_norm(a: dict, b: dict) -> float:
    pa, pb = split_params(a)[0], split_params(b)[0]
    return float(tree_global_norm(tree_sub(pa, pb))) / max(float(tree_global_norm(pb)), 1e-9)


def test_mesh_blockdiag_round_matches_the_simulation_and_off():
    """The one-rank packed mesh under blockdiag: held to the simulation's
    blockdiag round (the f32 mesh gate's bound) and to its own off round at
    tests/test_packed_conv.py:261's scale, two rounds each."""
    ds = make_synthetic_classification("packedconv-cs", (8, 8, 3), 4, 4, records_per_client=16,
                                       partition_method="homo", partition_alpha=0.5,
                                       batch_size=4, seed=1)
    cfg = _run_cfg(client_num_in_total=4, client_num_per_round=4, lr=0.01, pack_lanes=2)

    def build(cls, impl):
        return cls(ds, FedConfig(**{**cfg, "packed_conv": impl}),
                   create_model("resnet20", 4, input_shape=(8, 8, 3)), device="cpu")

    mesh, sim, off = (build(CrossSiloFedAvgAPI, "blockdiag"), build(FedAvgAPI, "blockdiag"),
                      build(CrossSiloFedAvgAPI, "off"))
    assert mesh._packed_mesh is not None and off._packed_mesh is not None
    assert mesh._packed_mesh["round_fn"].lanes.packed_conv == "blockdiag"
    assert mesh.packed_status()["packed_conv_active"] and not off.packed_status()["packed_conv_active"]
    for api in (sim, off):
        api.variables = {k: v.clone() for k, v in mesh.variables.items()}
    for r in range(2):
        loss = mesh.run_round(r)
        np.testing.assert_allclose(loss, sim.run_round(r), rtol=1e-5)
        np.testing.assert_allclose(loss, off.run_round(r), rtol=1e-2)
        assert _rel_norm(mesh.variables, sim.variables) < 1e-5
    for k, v in off.variables.items():
        np.testing.assert_allclose(mesh.variables[k].numpy(), v.numpy(), rtol=W_RTOL,
                                   atol=W_ATOL, err_msg=k)


def test_streamed_packed_chunks_take_the_lowering():
    """A host round streamed in packed chunks under blockdiag: every
    chunk's lane program runs the lowering, and two chunks of 2 clients
    give the round of one chunk of 4 (the streamed packed chunks' tolerance:
    a client's lane and lane count change the GEMM's blocking)."""
    ds = make_synthetic_classification("packedconv-stream", (8, 8, 3), 4, 6,
                                       records_per_client=12, partition_method="hetero",
                                       partition_alpha=0.5, batch_size=4, seed=4)
    cfg = _run_cfg(client_num_in_total=6, client_num_per_round=4, comm_round=1, pack_lanes=2,
                   device_data="off", packed_conv="blockdiag")
    apis = [FedAvgAPI(ds, FedConfig(**{**cfg, **kw}),
                      create_model("resnet20", 4, input_shape=(8, 8, 3)), device="cpu")
            for kw in ({"stream_aggregate": "deterministic", "cohort_chunk": 4},
                       {"stream_aggregate": "deterministic", "cohort_chunk": 2})]
    whole, chunked = apis
    chunked.variables = {k: v.clone() for k, v in whole.variables.items()}
    np.testing.assert_allclose(chunked.run_round(0), whole.run_round(0), rtol=1e-5)
    assert whole._stream_packed.packed_conv == chunked._stream_packed.packed_conv == "blockdiag"
    assert chunked.stream_stats["chunks"] == 2
    for k, v in whole.variables.items():
        np.testing.assert_allclose(chunked.variables[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# -- fallbacks and refusals --------------------------------------------------------------

def _both(model, shape, **kw):
    return (jax_create_model(model, 4, input_shape=shape, **kw),
            create_model(model, 4, input_shape=shape, **kw))


@pytest.mark.parametrize("model,shape,kw", [
    ("resnet20", (8, 8, 3), {}), ("resnet20", (8, 8, 3), {"conv_impl": "lanes"}),
    ("cnn", (12, 12, 1), {}), ("lr", (6,), {}), ("transformer", None, {})])
@pytest.mark.parametrize("impl", ["off", *IMPLS])
def test_fallback_reasons_equal_jax(model, shape, kw, impl):
    """JAX's reasons for every client optimizer: none disqualifies, so the
    port's take no optimizer."""
    jb, pb = _both(model, shape, **kw)
    for opt in ("sgd", "adam", "yogi"):
        assert (packed.packed_fallback_reason(pb, impl)
                == jax_packed.packed_fallback_reason(jb, impl, opt))
        assert packed.packed_conv_active(pb, impl) == jax_packed.packed_conv_active(jb, impl, opt)


def test_dropout_models_are_refused_naming_their_roadmap_item():
    """Dropout models since the port has dropout: ``cnn_dropout`` (explicit
    per-lane keys) packs, as JAX's does; a dropout model whose twin has no
    explicit key stream gets JAX's third fallback reason word for word (the
    port has no such model with a twin, so the bundle is made here)."""
    assert jax_packed.packed_fallback_reason(jax_create_model("cnn_dropout", 4),
                                             "blockdiag") is None
    assert packed.packed_fallback_reason(create_model("cnn_dropout", 4), "blockdiag") is None
    jb, pb = jax_create_model("cnn", 4), create_model("cnn", 4)
    jb.uses_dropout = pb.uses_dropout = True
    assert (packed.packed_fallback_reason(pb, "blockdiag")
            == jax_packed.packed_fallback_reason(jb, "blockdiag", "sgd")
            == "model 'cnn' uses flax-rng dropout and its packed twin has no explicit "
               "per-lane key stream")


@pytest.mark.parametrize("model,shape", [("cnn", (12, 12, 1)), ("lr", (6,))])
@pytest.mark.parametrize("impl", ["off", "blockdiag"])
def test_packed_status_equals_jax(model, shape, impl):
    def data(fn):
        return fn("pe", shape, 4, 8, records_per_client=8, partition_method="hetero",
                  partition_alpha=0.4, batch_size=4, seed=5)

    cfg = _run_cfg(model=model, dataset="pe", comm_round=1, packed_conv=impl)
    japi = JaxFedAvgAPI(data(jax_synthetic), JaxFedConfig(**cfg),
                        jax_create_model(model, 4, input_shape=shape))
    api = FedAvgAPI(data(make_synthetic_classification), FedConfig(**cfg),
                    create_model(model, 4, input_shape=shape), device="cpu")
    assert api.packed_status() == japi.packed_status()
    assert api._packed_train.packed_conv == ("off" if model == "lr" else impl)
    assert np.isfinite(float(api.run_round(0)))


def test_fallback_is_warned_once_and_counted(caplog):
    packed.reset_fallback_warnings()
    bundle = create_model("lr", 4, input_shape=(6,))
    from fedml_tpu_torch.core.tasks import get_task

    with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.parallel.packed"):
        for _ in range(2):
            train = packed.make_packed_cohort_train(bundle, get_task("classification", 4), 8,
                                                    batch_size=4, packed_conv="blockdiag")
            assert train.packed_conv == "off"
    warned = [r for r in caplog.records if "falls back" in r.getMessage()]
    assert len(warned) == 1 and "has no packed conv variant" in warned[0].getMessage()
    assert packed.FALLBACKS == {"fallback:lr:blockdiag": 2}
    packed.reset_fallback_warnings()
    assert packed.FALLBACKS == {}


def test_auto_is_refused_naming_its_roadmap_item():
    JaxFedConfig(packed_conv="auto")          # a value the JAX package takes
    with pytest.raises(NotImplementedError, match="item 12"):
        FedConfig(packed_conv="auto")
    with pytest.raises(ValueError):
        FedConfig(packed_conv="bogus")
