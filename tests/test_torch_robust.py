"""Robust aggregation, the poisoned federation and FedAvg-robust: the port
against the JAX package.

- The aggregation functions on converted leaves (flax trees with BatchNorm
  statistics and an integer leaf): ``clip_update_by_norm``, ``add_dp_noise``
  (the JAX draws ``normal(fold_in(key, i))`` injected, so leaf ``i`` of
  the flattened flax tree is the port's leaf in ``flax_leaf_order``),
  ``robust_aggregate``, ``mixing_average`` and ``hierarchical_aggregate``:
  rtol 1e-6 / atol 1e-7 (one f32 rounding apart at most); statistics never
  clipped or noised, the integer leaf untouched. The port's own draws:
  ``server_generator`` is pure in (seed, round) and the noise has the
  asked standard deviation.
- ``load_poisoned_dataset`` (synthetic edge cases, the southwest archives and
  the generic pickle), ``stamp_trigger`` and ``backdoor_success_rate``:
  bit-equal to JAX's.
- One and two rounds of ``FedAvgRobustAPI`` (clip, noise, ``poison_frac``
  0.5) against JAX's, with JAX's orders and normals injected, on ``lr`` and
  on a narrow CifarResNet with ``bn_impl="pallas"`` (the plain BN on the
  CPU, the JAX Pallas BN in interpret mode): variables rtol 1e-4 / atol
  1e-5, losses rtol 1e-5 (tests/test_torch_algorithms.py's);
  ``evaluate_backdoor`` against JAX's from the same weights (rtol 1e-6).
  The attacker's rows placed on the device carry the trigger.
- The port's packed robust round against its plain one (the same server
  generator): rtol 1e-4 / atol 1e-5, loss rtol 1e-5
  (tests/test_torch_packed.py's); the one-rank mesh round
  (``CrossSiloFedAvgRobustAPI``) against the simulation: relative norm
  below 1e-5 (tests/test_crosssilo.py:40).
- ``check_ported`` accepts the six fields of this slice.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.robust import FedAvgRobustAPI as JaxFedAvgRobustAPI
from fedml_tpu.algorithms.robust import stamp_trigger as jax_stamp_trigger
from fedml_tpu.core import aggregation as jagg
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data import edge_cases as jedge
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.robust import (CrossSiloFedAvgRobustAPI, FedAvgRobustAPI,
                                               stamp_trigger)
from fedml_tpu_torch.core import aggregation as agg
from fedml_tpu_torch.core.config import FedConfig, unported_fields
from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
from fedml_tpu_torch.core.rng import server_generator
from fedml_tpu_torch.data import edge_cases
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_leaf_order, flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from torch_jax_refs import assert_vars_close, jax_normal, noise_hook, order_hook

SEED = 0
EPOCHS = 2
AGG_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the aggregation functions on converted leaves ------------------------------


def _flax_tree(rng, scale=1.0, step=True):
    t = {"params": {
        "Conv_0": {"kernel": (rng.normal(size=(3, 3, 4, 6)) * scale).astype(np.float32)},
        "PallasBatchNorm_0": {"scale": (1 + rng.normal(size=6) * scale).astype(np.float32),
                              "bias": (rng.normal(size=6) * scale).astype(np.float32)},
        "Dense_0": {"kernel": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
                    "bias": (rng.normal(size=5) * scale).astype(np.float32)}},
        "batch_stats": {"PallasBatchNorm_0": {
            "mean": (rng.normal(size=6) * scale).astype(np.float32),
            "var": (1 + rng.random(6) * scale).astype(np.float32)}}}
    if step:
        t["params"]["Dense_0"]["step"] = np.array([3, 7], np.int32)
    return t


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _port_stack(trees):
    return {k: torch.stack([flax_to_torch(t)[k] for t in trees]) for k in flax_to_torch(trees[0])}


def _assert_tree(got: dict, want_flax, **tol):
    want = flax_to_torch(jax.tree.map(np.asarray, want_flax))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **(tol or AGG_TOL))


def test_flax_leaf_order_is_the_jax_flatten_order():
    tree = _flax_tree(np.random.default_rng(0))
    want = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = flax_leaf_order(flax_to_torch(tree))
    assert len(got) == len(want)
    for name, path in zip(got, want):
        keys = [p.key for p in path]
        assert name.split(".")[:-1] == keys[1:-1], (name, keys)
        assert name.rsplit(".", 1)[1] == ("weight" if keys[-1] == "kernel" else keys[-1])


@pytest.mark.parametrize("clip,scale", [(0.05, 0.1), (1e3, 0.1), (0.5, 1e-3)])
def test_clip_update_by_norm_matches_jax(clip, scale):
    rng = np.random.default_rng(1)
    g = _flax_tree(rng, step=False)
    local = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * scale).astype(np.float32), g)
    want = jagg.clip_update_by_norm(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, local), clip)
    got = agg.clip_update_by_norm(flax_to_torch(g), flax_to_torch(local), clip)
    _assert_tree(got, want)
    # the statistics take the local values (through g + (l - g)), unclipped
    for k in ("PallasBatchNorm_0.mean", "PallasBatchNorm_0.var"):
        np.testing.assert_allclose(got[k].numpy(), flax_to_torch(local)[k].numpy(), rtol=1e-6)


def test_clip_of_a_stack_clips_each_client_by_its_own_norm():
    rng = np.random.default_rng(2)
    g = _flax_tree(rng, step=False)
    locals_ = [jax.tree.map(lambda a, s=s: (a + rng.normal(size=a.shape) * s).astype(np.float32),
                            g) for s in (1e-3, 0.3, 1.0)]
    got = agg.clip_update_by_norm(flax_to_torch(g), _port_stack(locals_), 0.2, batch_dims=1)
    for i, loc in enumerate(locals_):
        want = jagg.clip_update_by_norm(jax.tree.map(jnp.asarray, g),
                                        jax.tree.map(jnp.asarray, loc), 0.2)
        _assert_tree({k: v[i] for k, v in got.items()}, want)


def test_add_dp_noise_matches_jax_with_its_draws():
    """JAX's draws injected; statistics and the integer leaf untouched."""
    tree = _flax_tree(np.random.default_rng(3))
    key = jax.random.key(7)
    want = jagg.add_dp_noise(jax.tree.map(jnp.asarray, tree), 0.05, key)
    port = flax_to_torch(tree)
    got = agg.add_dp_noise(port, 0.05, noise=lambda i, name, shape: jax_normal(key, i, name,
                                                                                  shape))
    _assert_tree(got, want)
    for k in ("PallasBatchNorm_0.mean", "PallasBatchNorm_0.var", "Dense_0.step"):
        assert torch.equal(got[k], port[k]), k
    assert not torch.equal(got["Conv_0.weight"], port["Conv_0.weight"])


def test_add_dp_noise_from_the_server_generator():
    """The port's own draws: pure in (seed, round), one ``randn`` a weight
    leaf in the JAX leaf order, of standard deviation ``stddev``."""
    zeros = {"Conv_0.weight": torch.zeros(64, 32, 3, 3), "Dense_0.bias": torch.zeros(500),
             "PallasBatchNorm_0.mean": torch.zeros(64), "Dense_0.step": torch.zeros(2, dtype=torch.int32)}
    a = agg.add_dp_noise(zeros, 0.1, server_generator(3, 5, "cpu"))
    b = agg.add_dp_noise(zeros, 0.1, server_generator(3, 5, "cpu"))
    c = agg.add_dp_noise(zeros, 0.1, server_generator(3, 6, "cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv_0.weight"], c["Conv_0.weight"])
    assert torch.equal(a["PallasBatchNorm_0.mean"], zeros["PallasBatchNorm_0.mean"])
    g = server_generator(3, 5, "cpu")          # the draws, in flax order
    first = torch.randn((64, 32, 3, 3), generator=g)
    assert torch.equal(a["Conv_0.weight"], 0.1 * first)
    assert torch.equal(a["Dense_0.bias"], 0.1 * torch.randn(500, generator=g))
    n = a["Conv_0.weight"].reshape(-1)
    assert abs(float(n.std()) - 0.1) < 0.02 * 0.1 and abs(float(n.mean())) < 5 * 0.1 / n.numel() ** 0.5


@pytest.mark.parametrize("norm_bound,stddev", [(0.2, 0.01), (None, 0.01), (0.2, None)])
def test_robust_aggregate_matches_jax(norm_bound, stddev):
    rng = np.random.default_rng(4)
    g = _flax_tree(rng, step=False)
    locals_ = [jax.tree.map(lambda a, s=s: (a + rng.normal(size=a.shape) * s).astype(np.float32),
                            g) for s in (0.01, 0.2, 0.5)]
    counts = np.array([5.0, 9.0, 2.0], np.float32)
    key = jax.random.key(11)
    want = jagg.robust_aggregate(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, _stack(locals_)), jnp.asarray(counts),
                                 norm_bound=norm_bound, dp_stddev=stddev, rng=key)
    got = agg.robust_aggregate(flax_to_torch(g), _port_stack(locals_), torch.tensor(counts),
                               norm_bound=norm_bound, dp_stddev=stddev,
                               rng=lambda i, name, shape: jax_normal(key, i, name, shape))
    _assert_tree(got, want)
    # the statistics are the plain weighted mean, never noised
    mean = jagg.fedavg_aggregate(jax.tree.map(jnp.asarray, _stack(locals_)), jnp.asarray(counts))
    np.testing.assert_allclose(got["PallasBatchNorm_0.var"].numpy(),
                               np.asarray(mean["batch_stats"]["PallasBatchNorm_0"]["var"]),
                               rtol=1e-6)
    if stddev is not None:
        with pytest.raises(ValueError, match="rng"):
            agg.robust_aggregate(flax_to_torch(g), _port_stack(locals_), torch.tensor(counts),
                                 dp_stddev=stddev)


def test_mixing_average_matches_jax():
    rng = np.random.default_rng(5)
    trees = [_flax_tree(rng, step=False) for _ in range(4)]
    row = np.array([0.5, 0.25, 0.0, 0.25], np.float32)
    want = jagg.mixing_average(jax.tree.map(jnp.asarray, _stack(trees)), jnp.asarray(row))
    _assert_tree(agg.mixing_average(_port_stack(trees), torch.tensor(row)), want)


@pytest.mark.parametrize("counts", [[3, 5, 2, 7, 1, 4], [3, 0, 2, 0, 1, 0]])
def test_hierarchical_aggregate_matches_jax(counts):
    """Group models and the global model; a group of zero mass (second
    case) gives JAX's zero group model and no global weight."""
    rng = np.random.default_rng(6)
    trees = [_flax_tree(rng, step=False) for _ in range(6)]
    w = np.asarray(counts, np.float32)
    gids = np.arange(6) % 2
    jg, jglob = jagg.hierarchical_aggregate(jax.tree.map(jnp.asarray, _stack(trees)),
                                            jnp.asarray(w), jnp.asarray(gids), 2)
    pg, pglob = agg.hierarchical_aggregate(_port_stack(trees), torch.tensor(w), gids, 2)
    _assert_tree(pglob, jglob)
    for gi in range(2):
        _assert_tree({k: v[gi] for k, v in pg.items()}, jax.tree.map(lambda a: a[gi], jg))


# -- the poisoned federation ------------------------------------------------------------

EDGE_DATA = dict(name="edge", input_shape=(32, 32, 3), classes=10, num_clients=4,
                 records_per_client=10, test_records=20, partition_method="hetero",
                 partition_alpha=0.5, batch_size=4, seed=SEED)


def _assert_federations_equal(got, want):
    for f in ("attacker_clients", "target_class"):
        assert getattr(got, f) == getattr(want, f)
    for f in ("edge_test_x", "edge_test_y", "edge_test_true_y"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("train_x", "train_y", "train_mask", "train_counts", "test_x", "test_y"):
        a, b = getattr(got.dataset, f), getattr(want.dataset, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.dataset.name == want.dataset.name


@pytest.mark.parametrize("kw", [dict(), dict(attacker_clients=[0, 2], poison_frac=0.3,
                                              target_class=9, seed=3),
                                dict(poison_frac=0.0)])
def test_load_poisoned_dataset_is_bit_equal(kw, tmp_path):
    got = edge_cases.load_poisoned_dataset(make_synthetic_classification(**EDGE_DATA),
                                           data_dir=str(tmp_path), **kw)
    want = jedge.load_poisoned_dataset(jax_synthetic(**EDGE_DATA), data_dir=str(tmp_path), **kw)
    _assert_federations_equal(got, want)


@pytest.mark.parametrize("case", ["southwest", "generic"])
def test_load_poisoned_dataset_from_archives_is_bit_equal(case, tmp_path):
    rng = np.random.default_rng(8)
    root = tmp_path / "edge_case_examples"
    if case == "southwest":
        sw = root / "southwest_cifar10"
        sw.mkdir(parents=True)
        for name, n in zip(jedge._SOUTHWEST_FILES["edge-case"], (12, 5)):
            with open(sw / name, "wb") as f:
                pickle.dump(rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8), f)
    else:
        root.mkdir()
        with open(root / "edge_case.pkl", "wb") as f:
            pickle.dump({"x": rng.normal(size=(20, 32, 32, 3)), "y_true": rng.integers(0, 9, 20)},
                        f)
    got = edge_cases.load_poisoned_dataset(make_synthetic_classification(**EDGE_DATA),
                                           data_dir=str(tmp_path))
    want = jedge.load_poisoned_dataset(jax_synthetic(**EDGE_DATA), data_dir=str(tmp_path))
    _assert_federations_equal(got, want)


def test_stamp_trigger_and_success_rate_are_bit_equal():
    rng = np.random.default_rng(9)
    for x in (rng.normal(size=(3, 8, 8, 3)).astype(np.float32),
              rng.normal(size=(4, 30)).astype(np.float32)):
        got, want = stamp_trigger(x, 1.5, 2), jax_stamp_trigger(x, 1.5, 2)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert not np.array_equal(got, x)          # a copy, the input untouched
    logits = rng.normal(size=(50, 10))
    assert edge_cases.backdoor_success_rate(logits, 3) == jedge.backdoor_success_rate(logits, 3)
    assert edge_cases.backdoor_success_rate(np.zeros((0, 10)), 3) == 0.0


# -- FedAvg-robust against the JAX API --------------------------------------------------

LR_DATA = dict(name="robust-lr", input_shape=(12,), classes=3, num_clients=6,
               records_per_client=12, partition_method="hetero", partition_alpha=0.5,
               batch_size=4, seed=SEED)
LR_RUN = dict(model="lr", client_num_in_total=6, client_num_per_round=4, comm_round=2,
              batch_size=4, epochs=EPOCHS, lr=0.2, momentum=0.9, frequency_of_the_test=1,
              seed=SEED, device_data="off", norm_bound=0.3, stddev=0.01, poison_frac=0.5)
RES_DATA = dict(name="robust-res", input_shape=(8, 8, 3), classes=10, num_clients=4,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=SEED)
RES_RUN = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=3,
               comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05, momentum=0.9,
               frequency_of_the_test=1, seed=SEED, device_data="on", norm_bound=0.5,
               stddev=1e-3, poison_frac=0.5)


def _res_bundles():
    jb = JaxModelBundle(name="cifar-small",
                        module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                        input_shape=(8, 8, 3), has_batch_stats=True)
    return jb, ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                      bn_impl="pallas"), (8, 8, 3))


def _robust_pair(model: str):
    data, run = (LR_DATA, LR_RUN) if model == "lr" else (RES_DATA, RES_RUN)
    jds = jax_synthetic(**data)
    if model == "lr":
        jb, pb = jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:]), None
    else:
        jb, pb = _res_bundles()
    japi = JaxFedAvgRobustAPI(jds, JaxFedConfig(**run, pack_lanes=0), jb, attacker_idx=1,
                              target_class=2)
    ds = make_synthetic_classification(**data)
    cohort = run["client_num_per_round"]
    api = FedAvgRobustAPI(ds, FedConfig(**run), pb, device="cpu", attacker_idx=1,
                          target_class=2,
                          order_hook=order_hook(SEED, EPOCHS, cohort, ds.train_x.shape[1]),
                          noise_hook=noise_hook(SEED))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    return japi, api


@pytest.mark.parametrize("model", ["lr", "cifar-small"])
def test_one_and_two_rounds_match_jax(model):
    japi, api = _robust_pair(model)
    assert np.array_equal(api.dataset.train_x, japi.dataset.train_x)     # the same poison
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, 1e-4, 1e-5, f"round {r}")
    np.testing.assert_allclose(api.evaluate_global()["loss"], japi.evaluate_global()["loss"],
                               rtol=1e-5)
    # the backdoor eval from the same weights
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    np.testing.assert_allclose(api.evaluate_backdoor()["backdoor_success"],
                               japi.evaluate_backdoor()["backdoor_success"], rtol=1e-6)


def test_the_attackers_resident_rows_carry_the_trigger():
    ds = make_synthetic_classification(**RES_DATA)
    api = FedAvgRobustAPI(ds, FedConfig(**RES_RUN), _res_bundles()[1], device="cpu",
                          attacker_idx=1, target_class=2)
    n_poison = int(int(ds.train_mask[1].sum()) * 0.5)
    tx, ty, _ = api._dev_train
    assert torch.all(tx[1, :n_poison, :3, :3, :] == 2.5)
    assert torch.all(ty[1, :n_poison] == 2) and n_poison > 0
    assert torch.equal(tx[0], torch.from_numpy(ds.train_x[0]))     # other clients clean
    assert not np.all(ds.train_x[1, :n_poison, :3, :3, :] == 2.5)  # the caller's copy too


def _params_rel(a: dict, b: dict) -> float:
    pa, pb = split_params(a)[0], split_params(b)[0]
    return float(tree_global_norm(tree_sub(pa, pb))) / float(tree_global_norm(pb))


def test_packed_round_matches_the_plain_round():
    """Clip at each lane's emit, noise from the shared server generator."""
    ds = make_synthetic_classification(**RES_DATA)
    plain = FedAvgRobustAPI(ds, FedConfig(**RES_RUN), _res_bundles()[1], device="cpu")
    packed = FedAvgRobustAPI(ds, FedConfig(**RES_RUN, pack_lanes=2), _res_bundles()[1],
                             device="cpu")
    assert packed.packed_status()["scheduled"] and packed._packed_train is not None
    plan = packed._packed_plan(packed.sample(0))
    assert plan.k_max >= 2          # a lane emits two members: the clip is per member
    packed.variables = {k: v.clone() for k, v in plain.variables.items()}
    for r in range(2):
        np.testing.assert_allclose(packed.run_round(r), plain.run_round(r), rtol=1e-5)
        for k, v in plain.variables.items():
            np.testing.assert_allclose(packed.variables[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"round {r} {k}")


def test_one_rank_mesh_matches_the_simulation():
    ds = make_synthetic_classification(**RES_DATA)
    run = {**RES_RUN, "client_num_per_round": 4}
    sim = FedAvgRobustAPI(ds, FedConfig(**run), _res_bundles()[1], device="cpu")
    init = {k: v.clone() for k, v in sim.variables.items()}
    loss_sim = float(sim.run_round(0))
    for kw in (dict(pack_lanes=2), dict()):
        mesh = CrossSiloFedAvgRobustAPI(ds, FedConfig(**run, **kw), _res_bundles()[1],
                                        device="cpu")
        assert (mesh._packed_mesh is not None) == bool(kw)
        mesh.variables = {k: v.clone() for k, v in init.items()}
        np.testing.assert_allclose(float(mesh.run_round(0)), loss_sim, rtol=1e-5)
        assert _params_rel(mesh.variables, sim.variables) < 1e-5


def test_zero_weight_round_draws_nothing():
    ds = make_synthetic_classification(**RES_DATA)
    drawn = []

    def hook(r, i, name, shape):
        drawn.append(name)
        return torch.zeros(shape)

    for lanes in (0, 2):
        api = FedAvgRobustAPI(ds, FedConfig(**RES_RUN, pack_lanes=lanes), _res_bundles()[1],
                              device="cpu", noise_hook=hook)
        api.set_client_active(np.zeros(ds.num_clients, np.float32))
        before = {k: v.clone() for k, v in api.variables.items()}
        api.run_round(0)
        assert all(torch.equal(api.variables[k], v) for k, v in before.items())
    assert drawn == []


def test_check_ported_accepts_this_slices_fields():
    cfg = FedConfig(norm_bound=1.0, stddev=0.1, poison_frac=0.1, group_num=2,
                    group_comm_round=2, attack_type="edge_case")
    assert unported_fields(cfg) == {}
    assert "rounds_per_step" in unported_fields(FedConfig(rounds_per_step=2))
