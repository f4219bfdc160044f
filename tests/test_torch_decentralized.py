"""Decentralized FL (DSGD and PushSum gossip): the port against the JAX
package's ``DecentralizedFedAPI``.

- ``mix_stacked`` against JAX's on the same stacked leaves and matrix:
  rtol 1e-6 / atol 1e-7 (one f32 product each, summed in another order).
- Two rounds of DSGD (the symmetric topology) and PushSum (the asymmetric
  one, column-stochastic) against JAX's, with JAX's node orders injected
  (``order_hook`` with cohort N), on ``lr`` and on a narrow CifarResNet
  with ``bn_impl="pallas"`` (the plain BN on the CPU, JAX's Pallas BN in
  interpret mode): every node's variables and the consensus rtol 1e-4 /
  atol 1e-5, losses rtol 1e-5, ``ps_weights`` rtol 1e-6
  (tests/test_torch_algorithms.py's bounds); ``consensus_distance`` and
  ``evaluate_node`` from the same state rtol 1e-5.
- The mesh form without a process group equals the simulator bit for bit
  (the same product on the same rows); two spawned gloo ranks with N = 4
  within rtol 1e-4 / atol 1e-5 of the simulator, the JAX test's own bound
  (tests/test_silo_decentralized.py:196-213); N not a multiple of the
  ranks raises.
- The ignored options (``device_data``, ``pack_lanes``) warn, as the JAX
  package's do.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.decentralized import DecentralizedFedAPI as JaxDecentralizedFedAPI
from fedml_tpu.algorithms.decentralized import mix_stacked as jax_mix_stacked
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.distributed.topology import AsymmetricTopologyManager as JaxAsymmetric
from fedml_tpu.distributed.topology import SymmetricTopologyManager as JaxSymmetric
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.decentralized import (DecentralizedFedAPI,
                                                      MeshDecentralizedFedAPI)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.distributed.topology import (AsymmetricTopologyManager,
                                                  SymmetricTopologyManager)
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel.gossip import mix_stacked
from fedml_tpu_torch.parallel.mesh import ClientMesh
from test_torch_crosssilo import _spawn_ranks
from torch_jax_refs import assert_vars_close, jax_orders_np, order_hook

SEED, EPOCHS = 0, 2
LR_DATA = dict(name="gossip-lr", input_shape=(10,), classes=4, num_clients=6,
               records_per_client=12, partition_method="hetero", partition_alpha=0.5,
               batch_size=4, seed=SEED)
LR_RUN = dict(model="lr", client_num_in_total=6, client_num_per_round=6, comm_round=2,
              batch_size=4, epochs=EPOCHS, lr=0.1, momentum=0.9, frequency_of_the_test=1,
              seed=SEED)
RES_DATA = dict(name="gossip-res", input_shape=(8, 8, 3), classes=10, num_clients=4,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=SEED)
RES_RUN = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=4,
               comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05, momentum=0.9,
               frequency_of_the_test=1, seed=SEED)


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


def _topologies(mode: str, n: int):
    if mode == "dsgd":
        pair = JaxSymmetric(n, 2, seed=3), SymmetricTopologyManager(n, 2, seed=3)
    else:
        pair = JaxAsymmetric(n, 1, 2, seed=3), AsymmetricTopologyManager(n, 1, 2, seed=3)
    for t in pair:
        t.generate_topology()
    return pair


def _node(flax_nodes, i: int):
    return jax.tree.map(lambda x: np.asarray(x)[i], flax_nodes)


def test_mix_stacked_matches_jax():
    rng = np.random.default_rng(1)
    W = SymmetricTopologyManager(5, 2, seed=1)
    W.generate_topology()
    Wf = W.mixing_matrix.astype(np.float32)
    leaves = {"conv.weight": rng.normal(size=(5, 4, 3, 3, 3)).astype(np.float32),
              "bn.mean": rng.normal(size=(5, 4)).astype(np.float32),
              "linear.bias": rng.normal(size=(5, 7)).astype(np.float32)}
    got = mix_stacked({k: torch.from_numpy(v) for k, v in leaves.items()}, torch.from_numpy(Wf))
    want = jax_mix_stacked({k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(Wf))
    for k in leaves:
        assert got[k].dtype == torch.float32 and got[k].shape == leaves[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model, mode", [("lr", "dsgd"), ("lr", "pushsum"),
                                         ("cifar-small", "dsgd"), ("cifar-small", "pushsum")])
def test_rounds_match_jax(model, mode):
    data, run = (LR_DATA, LR_RUN) if model == "lr" else (RES_DATA, RES_RUN)
    n = data["num_clients"]
    jds = jax_synthetic(**data)
    jb, pb = _bundles(model, jds)
    jtopo, topo = _topologies(mode, n)
    japi = JaxDecentralizedFedAPI(jds, JaxFedConfig(**run), jb, topology=jtopo, mode=mode)
    ds = make_synthetic_classification(**data)
    api = DecentralizedFedAPI(ds, FedConfig(**run), pb, topology=topo, mode=mode, device="cpu",
                              order_hook=order_hook(SEED, EPOCHS, n, ds.train_x.shape[1]))
    np.testing.assert_array_equal(api.W.numpy(), np.asarray(japi.W))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    api.init_nodes()
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        for i in range(n):
            assert_vars_close({k: v[i] for k, v in api.node_vars.items()},
                              _node(japi.node_vars, i), 1e-4, 1e-5, f"round {r} node {i}")
        assert_vars_close(api.variables, japi.variables, 1e-4, 1e-5, f"round {r} consensus")
        np.testing.assert_allclose(api.ps_weights.numpy(), np.asarray(japi.ps_weights),
                                   rtol=1e-6)
    if mode == "pushsum":     # the mass moved, and none was lost
        assert not np.allclose(api.ps_weights.numpy(), 1.0)
        np.testing.assert_allclose(float(api.ps_weights.sum()), n, rtol=1e-5)
    np.testing.assert_allclose(api.consensus_distance(), japi.consensus_distance(), rtol=1e-5)
    for i in (0, n - 1):
        got, want = api.evaluate_node(i), japi.evaluate_node(i)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["acc"] == want["acc"]


def test_consensus_distance_and_evaluate_node_from_one_state():
    """From JAX's node state after a round, the port's diagnostics read the
    same numbers."""
    jds = jax_synthetic(**LR_DATA)
    jtopo, topo = _topologies("pushsum", LR_DATA["num_clients"])
    japi = JaxDecentralizedFedAPI(jds, JaxFedConfig(**LR_RUN), _bundles("lr", jds)[0],
                                  topology=jtopo, mode="pushsum")
    japi.run_round(0)
    api = DecentralizedFedAPI(make_synthetic_classification(**LR_DATA), FedConfig(**LR_RUN),
                              topology=topo, mode="pushsum", device="cpu")
    n = LR_DATA["num_clients"]
    nodes = [flax_to_torch(_node(japi.node_vars, i)) for i in range(n)]
    api.node_vars = {k: torch.stack([nd[k] for nd in nodes]) for k in nodes[0]}
    api.ps_weights = torch.from_numpy(np.array(japi.ps_weights))
    api._update_consensus()
    assert_vars_close(api.variables, japi.variables, 1e-6, 1e-7, "consensus")
    np.testing.assert_allclose(api.consensus_distance(), japi.consensus_distance(), rtol=1e-5)
    for i in range(n):
        got, want = api.evaluate_node(i), japi.evaluate_node(i)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["acc"] == want["acc"]


@pytest.mark.parametrize("mode", ["dsgd", "pushsum"])
def test_groupless_mesh_equals_the_simulator_bit_for_bit(mode):
    ds = make_synthetic_classification(**RES_DATA)
    topo = _topologies(mode, RES_DATA["num_clients"])[1]
    sim = DecentralizedFedAPI(ds, FedConfig(**RES_RUN), _bundles("res", None)[1], topology=topo,
                              mode=mode, device="cpu")
    mesh = MeshDecentralizedFedAPI(ds, FedConfig(**RES_RUN), _bundles("res", None)[1],
                                   topology=topo, mode=mode, device="cpu")
    assert mesh.mesh.world_size == 1 and mesh.mesh.group is None
    mesh.variables = {k: v.clone() for k, v in sim.variables.items()}
    mesh.init_nodes()
    for r in range(2):
        assert float(mesh.run_round(r)) == float(sim.run_round(r))
        for k, v in sim.node_vars.items():
            assert torch.equal(mesh.node_vars[k], v), k
        assert torch.equal(mesh.ps_weights, sim.ps_weights)
        for k, v in sim.variables.items():
            assert torch.equal(mesh.variables[k], v), k


@pytest.mark.parametrize("mode", ["dsgd", "pushsum"])
def test_two_gloo_ranks_match_the_simulator(mode, tmp_path):
    """Two spawned ranks of two nodes each: every rank ends each round with
    every node's state, equal across ranks and to the simulator's."""
    data = dict(LR_DATA, num_clients=4, name="gossip-lr4")
    run = dict(LR_RUN, client_num_in_total=4, client_num_per_round=4)
    ds = make_synthetic_classification(**data)
    N, n_pad = ds.num_clients, ds.train_x.shape[1]
    topo = _topologies(mode, N)[1]
    sim = DecentralizedFedAPI(ds, FedConfig(**run), topology=topo, mode=mode, device="cpu",
                              order_hook=order_hook(SEED, EPOCHS, N, n_pad))
    init = {k: v.clone() for k, v in sim.variables.items()}
    orders = {(r, j, n_pad): jax_orders_np(SEED, EPOCHS, r, N, n_pad)[j]
              for r in range(2) for j in range(N)}
    spec = dict(data=data, run=run, model="lr", init={k: v.numpy() for k, v in init.items()},
                orders=orders, rounds=2, gossip={"mode": mode, "W": topo.topology})
    ranks = _spawn_ranks(2, spec, tmp_path)
    sim_losses = [float(sim.run_round(r)) for r in range(2)]
    (l0, v0), (l1, v1) = ranks
    assert l0 == l1 and all(np.array_equal(v0[k], v1[k]) for k in v0)
    np.testing.assert_allclose(l0, sim_losses, rtol=1e-5)
    for k, v in sim.node_vars.items():
        np.testing.assert_allclose(v0[f"node.{k}"], v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(v0["ps_weights"], sim.ps_weights.numpy(), rtol=1e-5, atol=1e-6)


def test_nodes_not_a_multiple_of_the_ranks_raise():
    ds = make_synthetic_classification(**dict(LR_DATA, num_clients=3))
    two = ClientMesh(2, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple"):
        MeshDecentralizedFedAPI(ds, FedConfig(**dict(LR_RUN, client_num_in_total=3,
                                                      client_num_per_round=3)),
                                device="cpu", mesh=two)


def test_ignored_options_warn_as_jax_s(caplog):
    run = dict(RES_RUN, pack_lanes=2, device_data="on")
    with caplog.at_level(logging.WARNING):
        api = DecentralizedFedAPI(make_synthetic_classification(**RES_DATA), FedConfig(**run),
                                  _bundles("res", None)[1], device="cpu")
        api.run_round(0)
    assert "device_data='on' ignored" in caplog.text and "pack_lanes=2 ignored" in caplog.text
    assert api._dev_train is None and api._packed_train is None
    assert api.round_counts(0)[0] == int(api.dataset.train_counts.sum())
