"""Hierarchical FL: the port's ``HierarchicalFedAvgAPI`` and
``CrossSiloHierarchicalFedAvgAPI`` against the JAX package's.

- One and two rounds at ``group_num = 2``, ``group_comm_round = 2`` against
  the JAX simulator, with JAX's per-client keys ``split(split(rng, GR)[r],
  C)[i]`` injected as orders, on ``lr`` (sampled cohorts, the record axis
  cut to the bucket) and on a narrow CifarResNet with ``bn_impl="pallas"``:
  variables rtol 1e-4 / atol 1e-5, losses rtol 1e-5
  (tests/test_torch_algorithms.py's).
- ``group_comm_round = 1`` equals flat FedAvg within relative 1e-5 (the
  reference CI's property, tests/test_algorithms.py:166): group round 0
  draws the flat round's orders, so it holds with mini-batches too.
- The one-rank mesh (``G = 1``) and a 2 x 2 mesh of four spawned gloo ranks
  against the simulator: rtol 1e-5 / atol 1e-6 (tests/test_crosssilo_zoo.py
  :182-199), the 2 x 2 mesh also against the JAX simulator.
- The JAX API's checks, ``packed_status`` and the ignored options.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.hierarchical import HierarchicalFedAvgAPI as JaxHierarchicalFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.hierarchical import (CrossSiloHierarchicalFedAvgAPI,
                                                     HierarchicalFedAvgAPI)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel.mesh import hierarchical_mesh
from test_torch_crosssilo import _spawn_ranks
from torch_jax_refs import assert_vars_close, jax_orders_np, order_hook

SEED = 0
EPOCHS = 2
G, GR = 2, 2
# seed 3: round 0's cohort is cut to 16 of the 24 records, round 1's is not
LR_SEED = 3
LR_DATA = dict(name="hier-lr", input_shape=(10,), classes=4, num_clients=8,
               records_per_client=12, partition_method="hetero", partition_alpha=0.5,
               batch_size=4, seed=LR_SEED)
LR_RUN = dict(model="lr", client_num_in_total=8, client_num_per_round=4, comm_round=2,
              batch_size=4, epochs=EPOCHS, lr=0.2, momentum=0.9, frequency_of_the_test=1,
              seed=LR_SEED, group_num=G, group_comm_round=GR, bucket_quantum_batches=1)
RES_DATA = dict(name="hier-res", input_shape=(8, 8, 3), classes=10, num_clients=4,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=SEED)
RES_RUN = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=4,
               comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05, momentum=0.9,
               frequency_of_the_test=1, seed=SEED, group_num=G, group_comm_round=GR)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bundles(model: str, jds):
    if model == "lr":
        return jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:]), None
    return (JaxModelBundle(name="cifar-small",
                           module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                           input_shape=(8, 8, 3), has_batch_stats=True),
            ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                        (8, 8, 3)))


def _rel(a: dict, b: dict) -> float:
    pa, pb = split_params(a)[0], split_params(b)[0]
    return float(tree_global_norm(tree_sub(pa, pb))) / max(float(tree_global_norm(pb)), 1e-9)


@pytest.mark.parametrize("model", ["lr", "cifar-small"])
def test_rounds_match_jax(model):
    data, run = (LR_DATA, LR_RUN) if model == "lr" else (RES_DATA, RES_RUN)
    jds = jax_synthetic(**data)
    jb, pb = _bundles(model, jds)
    japi = JaxHierarchicalFedAvgAPI(jds, JaxFedConfig(**run), jb)
    ds = make_synthetic_classification(**data)
    api = HierarchicalFedAvgAPI(ds, FedConfig(**run), pb, device="cpu",
                                order_hook=order_hook(run["seed"], EPOCHS,
                                                      run["client_num_per_round"],
                                                      ds.train_x.shape[1], GR))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    if model == "lr":        # the host round cuts the record axis to the bucket
        assert api._round_bucket(api.sample(0), None) == 16 < ds.train_x.shape[1]
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, 1e-4, 1e-5, f"round {r}")


def test_one_group_round_equals_flat_fedavg():
    ds = make_synthetic_classification("algo", (8,), 3, 6, records_per_client=12,
                                       partition_method="homo", batch_size=6, seed=0)
    run = dict(model="lr", client_num_in_total=6, client_num_per_round=6, comm_round=3,
               batch_size=6, lr=0.2, seed=11, frequency_of_the_test=100, device_data="off")
    flat = FedAvgAPI(ds, FedConfig(**run), device="cpu")
    hier = HierarchicalFedAvgAPI(ds, FedConfig(**run, group_num=3, group_comm_round=1),
                                 device="cpu")
    flat.train()
    hier.train()
    assert _rel(hier.variables, flat.variables) < 1e-5


def test_one_rank_mesh_matches_the_simulator():
    ds = make_synthetic_classification(**RES_DATA)
    run = {**RES_RUN, "group_num": 1}
    sim = HierarchicalFedAvgAPI(ds, FedConfig(**run), _bundles("res", None)[1], device="cpu")
    mesh = CrossSiloHierarchicalFedAvgAPI(ds, FedConfig(**run), _bundles("res", None)[1],
                                          device="cpu")
    assert mesh.mesh.shape == {"group": 1, "clients": 1} and mesh.mesh.group is None
    mesh.variables = {k: v.clone() for k, v in sim.variables.items()}
    for r in range(2):
        np.testing.assert_allclose(float(mesh.run_round(r)), float(sim.run_round(r)),
                                   rtol=1e-5)
    for k, v in sim.variables.items():
        np.testing.assert_allclose(mesh.variables[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_two_by_two_gloo_mesh_matches_the_simulators(tmp_path):
    """Four spawned ranks, two groups of two; each rank trains two of the
    eight clients. Every rank ends each round with the same variables,
    equal to the port's simulator and to JAX's."""
    run = {**LR_RUN, "client_num_per_round": 8, "bucket_quantum_batches": 8}
    jds = jax_synthetic(**LR_DATA)
    japi = JaxHierarchicalFedAvgAPI(jds, JaxFedConfig(**run), _bundles("lr", jds)[0])
    init = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    ds = make_synthetic_classification(**LR_DATA)
    C, n_pad = ds.num_clients, ds.train_x.shape[1]
    orders = {(r, j, n_pad, g): jax_orders_np(LR_SEED, EPOCHS, r, C, n_pad, GR, g)[j]
              for r in range(2) for j in range(C) for g in range(GR)}
    spec = dict(data=LR_DATA, run=run, model="lr", init={k: v.numpy() for k, v in init.items()},
                orders=orders, rounds=2, groups=G)
    ranks = _spawn_ranks(4, spec, tmp_path)
    sim = HierarchicalFedAvgAPI(ds, FedConfig(**run), device="cpu",
                                order_hook=order_hook(LR_SEED, EPOCHS, C, n_pad, GR))
    sim.variables = {k: v.clone() for k, v in init.items()}
    sim_losses = [float(sim.run_round(r)) for r in range(2)]
    jax_losses = [float(japi.run_round(r)) for r in range(2)]
    l0, v0 = ranks[0]
    for lr_, vr in ranks[1:]:
        assert lr_ == l0 and all(np.array_equal(v0[k], vr[k]) for k in v0)   # one replica
    np.testing.assert_allclose(l0, sim_losses, rtol=1e-5)
    np.testing.assert_allclose(l0, jax_losses, rtol=1e-5)
    for k, v in sim.variables.items():
        np.testing.assert_allclose(v0[k], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert_vars_close({k: torch.from_numpy(v) for k, v in v0.items()}, japi.variables, 1e-5,
                      1e-6, "2x2 mesh")


def test_mesh_checks_are_jax_s():
    ds = make_synthetic_classification(**LR_DATA)
    with pytest.raises(ValueError, match="must divide the device count"):
        CrossSiloHierarchicalFedAvgAPI(ds, FedConfig(**LR_RUN), device="cpu")
    with pytest.raises(ValueError, match="group"):
        CrossSiloHierarchicalFedAvgAPI(ds, FedConfig(**LR_RUN), device="cpu",
                                       mesh=hierarchical_mesh(1, 1, device="cpu"))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        hierarchical_mesh(2, 1, device="cpu")
    mesh = CrossSiloHierarchicalFedAvgAPI(ds, FedConfig(**{**LR_RUN, "group_num": 1}),
                                          device="cpu")
    assert mesh.mesh.clients.world_size == 1 and mesh.mesh.groups.group is None


def test_packed_status_and_ignored_options_are_jax_s(caplog):
    """As the JAX package: ``packed_status`` names the packed schedule
    (while the host round runs), ``failure_prob`` is ignored with a
    warning, the data stays on the host and the round does not stream."""
    jds = jax_synthetic(**RES_DATA)
    ds = make_synthetic_classification(**RES_DATA)
    for lanes in (0, 2):
        run = {**RES_RUN, "pack_lanes": lanes}
        jb, pb = _bundles("res", jds)
        want = JaxHierarchicalFedAvgAPI(jds, JaxFedConfig(**run), jb).packed_status()
        assert HierarchicalFedAvgAPI(ds, FedConfig(**run), pb, device="cpu").packed_status() \
            == want
    run = {**RES_RUN, "pack_lanes": 2, "failure_prob": 0.5, "device_data": "on",
           "stream_aggregate": "deterministic"}
    with caplog.at_level(logging.WARNING):
        api = HierarchicalFedAvgAPI(ds, FedConfig(**run), _bundles("res", jds)[1], device="cpu")
        api.run_round(0)
    text = caplog.text
    assert "failure_prob=0.5 ignored" in text and "device_data='on' ignored" in text
    assert "stream_aggregate='deterministic' ignored" in text
    assert api._dev_train is None and api._packed_train is None
    assert "failed_clients" not in api.history
