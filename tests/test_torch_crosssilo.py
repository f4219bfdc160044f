"""The port's cross-silo paradigm (``CrossSiloFedAvgAPI`` over
``torch.distributed``) against the JAX package's (``shard_map`` + ``psum``
over a ``client_mesh``), and against the port's own simulation round.

- The numpy planning is bit-equal: ``plan_packing_mesh``, ``pad_plan`` and
  ``mesh_member_active`` (1, 2 and 4 ranks, ragged counts),
  ``_chunk_buckets`` and ``_mesh_group_plan``; so are ``_sample_failures``'
  live masks, and the config's new fields (defaults and checks).
- One and two rounds of each mesh schedule against JAX's
  ``CrossSiloFedAvgAPI(mesh=client_mesh(1))`` with JAX's per-client orders
  injected (``permutation(split(split(fold_in(key(seed), r), C)[j],
  epochs)[e], n)``, n the grouped round's cut axis): the packed mesh and the
  grouped round on a small CifarResNet with the fused BN (the JAX Pallas BN
  in interpret mode), the resident-sharded round on ``lr``. Variables rtol
  1e-4 / atol 1e-5, losses rtol 1e-5 (tests/test_torch_packed.py's).
- The port's packed and resident mesh rounds against its simulation round
  at full participation: relative global norm of the parameters' difference
  below 1e-5 (tests/test_crosssilo.py:40).
- One round of each ``CrossSilo*`` algorithm against the JAX package's.
- Elastic rounds: rounds with failed clients against JAX's (the resident
  and grouped mesh rounds, the host slice, the simulation round), the
  packed mesh and the packed simulation
  round with a failure and an exit against the plain mesh, and an
  all-failed round that keeps the weights and FedOpt's server state.
- Two ranks over gloo: spawned children that import torch only (a
  ``file://`` store under ``tmp_path``, a bounded join), held against the
  port's one-rank round (resident and packed mesh) and against JAX's
  ``client_mesh(2)`` (resident) at rtol 1e-5 / atol 1e-6
  (tests/test_crosssilo.py:240).
"""

import functools
import multiprocessing
import queue

import jax
import numpy as np
import pytest
import torch

import torch_crosssilo_ranks
from fedml_tpu.algorithms import fedavg as jax_fedavg
from fedml_tpu.algorithms.fedagc import CrossSiloFedAGCAPI as JaxCSFedAGC
from fedml_tpu.algorithms.fednova import CrossSiloFedNovaAPI as JaxCSFedNova
from fedml_tpu.algorithms.fedopt import CrossSiloFedOptAPI as JaxCSFedOpt
from fedml_tpu.algorithms.fedprox import CrossSiloFedProxAPI as JaxCSFedProx
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu.parallel import packed as jax_packed
from fedml_tpu.parallel.mesh import client_mesh as jax_client_mesh
from fedml_tpu_torch.algorithms import fedavg
from fedml_tpu_torch.algorithms.fedagc import CrossSiloFedAGCAPI
from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.algorithms.fednova import CrossSiloFedNovaAPI
from fedml_tpu_torch.algorithms.fedopt import CrossSiloFedOptAPI
from fedml_tpu_torch.algorithms.fedprox import CrossSiloFedProxAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.optim import state_tensors
from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel import packed
from fedml_tpu_torch.parallel.mesh import ClientMesh, client_mesh

SEED = 0
EPOCHS = 2
PLAN_FIELDS = ("n_lanes", "k_max", "T", "epochs", "slot", "epoch", "sie", "reset", "emit",
               "live", "member_pos", "member_valid", "steps_real")
# the small CifarResNet's federation: 4 ragged hetero clients, full
# participation; a quantum of one batch gives the grouped schedule
# something to cut (n_pad 24, counts 14-19)
RES_DATA = dict(name="xsilo-parity", input_shape=(8, 8, 3), classes=10, num_clients=4,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=SEED)
RES_RUN = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=4,
               comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05, momentum=0.9,
               frequency_of_the_test=1, seed=SEED, device_data="on", bucket_quantum_batches=1)
# lr: 8 ragged clients (hetero), full participation
LR_DATA = dict(name="xsilo-lr", input_shape=(10,), classes=4, num_clients=8,
               records_per_client=12, partition_method="hetero", partition_alpha=0.5,
               batch_size=6, seed=SEED)
LR_RUN = dict(model="lr", client_num_in_total=8, client_num_per_round=8, comm_round=2,
              batch_size=6, epochs=EPOCHS, lr=0.2, momentum=0.9, frequency_of_the_test=10,
              seed=SEED, device_data="on")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small models: one intra-op thread each keeps the
    suite's parallel workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _jax_orders_np(round_idx: int, clients: int, n: int, seed: int = SEED) -> tuple:
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    return tuple(np.stack([np.asarray(jax.random.permutation(ek, n)).astype(np.int64)
                           for ek in jax.random.split(ck, EPOCHS)])
                 for ck in jax.random.split(rk, clients))


def _hook(clients: int, n_pad: int, seed: int = SEED):
    def hook(r, j, n=n_pad):
        return [torch.from_numpy(o) for o in _jax_orders_np(r, clients, n, seed)[j]]
    return hook


def _res_bundles(bn="pallas"):
    jb = JaxModelBundle(name="cifar-small",
                        module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl=bn),
                        input_shape=(8, 8, 3), has_batch_stats=True)
    return jb, ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl=bn),
                           (8, 8, 3))


def _pair(jax_cls, cls, data, run, lr: bool = False, **kw):
    """The JAX API on ``client_mesh(1)`` and the port's, from the JAX
    variables, with JAX's orders injected."""
    jds = jax_synthetic(**data)
    ds = make_synthetic_classification(**data)
    cfg = {**run, **kw}
    if lr:
        jb = jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:])
        pb = None
    else:
        jb, pb = _res_bundles()
    japi = jax_cls(jds, JaxFedConfig(**cfg), jb, mesh=jax_client_mesh(1))
    api = cls(ds, FedConfig(**cfg), pb, device="cpu",
              order_hook=_hook(ds.num_clients, ds.train_x.shape[1], cfg["seed"]))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    return japi, api


def _assert_vars_close(api, japi, what="", rtol=1e-4, atol=1e-5, bn_name="PallasBatchNorm"):
    got = torch_to_flax(api.variables, bn_name=bn_name)
    want = jax.tree.map(np.asarray, japi.variables)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{what} {path}")


def _rel_norm(a: dict, b: dict) -> float:
    pa, pb = split_params(a)[0], split_params(b)[0]
    return float(tree_global_norm(tree_sub(pa, pb))) / max(float(tree_global_norm(pb)), 1e-9)


# -- numpy planning, bit-equal ---------------------------------------------------


@pytest.mark.parametrize("counts,bs,epochs,D,lanes", [
    ([37, 5, 80, 16, 3, 64, 22, 9], 8, 2, 1, 2),
    ([37, 5, 80, 16, 3, 64, 22, 9], 8, 2, 2, 1),
    ([37, 5, 80, 16, 3, 64, 22, 9], 8, 1, 4, 2),
    ([1562, 3, 800, 0, 64, 1000, 127, 128], 64, 1, 2, 2),    # a zero-count client
    ([1562, 3, 800, 0, 64, 1000, 127, 128], 64, 1, 4, 1),
    ([12, 40, 7], 8, 3, 2, 1),                                 # does not split: None
])
def test_mesh_plan_is_bit_equal(counts, bs, epochs, D, lanes):
    want = jax_packed.plan_packing_mesh(np.array(counts), bs, epochs, D, lanes, t_quantum=1)
    got = packed.plan_packing_mesh(np.array(counts), bs, epochs, D, lanes, t_quantum=1)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    for f in PLAN_FIELDS:
        a, b = getattr(want[1], f), getattr(got[1], f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    active = np.random.default_rng(D + epochs).integers(0, 2, size=len(counts))
    np.testing.assert_array_equal(
        packed.mesh_member_active(got[1], D, active[got[0]]),
        jax_packed.mesh_member_active(want[1], D, active[want[0]]))
    # a rank's lanes are its block of the lane axis; their members are its rows
    for r in range(D):
        rp = packed.rank_plan(got[1], D, r)
        assert rp.n_lanes == got[1].n_lanes // D
        assert rp.member_pos.max() < len(counts) // D


@pytest.mark.parametrize("T,k_max,n_lanes", [(20, 4, 2), (30, 5, 3), (41, 6, 4)])
def test_pad_plan_is_bit_equal(T, k_max, n_lanes):
    counts = np.array([37, 5, 80, 16, 9])
    base = packed.plan_packing(counts, 8, 2, 2)
    jbase = jax_packed.plan_packing(counts, 8, 2, 2)
    got, want = packed.pad_plan(base, T, k_max, n_lanes), jax_packed.pad_plan(jbase, T, k_max,
                                                                                n_lanes)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.live[:, base.T:].sum() == 0 and got.member_valid[base.n_lanes:].sum() == 0


@pytest.mark.parametrize("maxes,G,q,n_pad", [
    ([3, 5, 9, 17, 17, 40, 64, 64], 3, 8, 64),
    ([3, 5, 9, 17, 17, 40, 64, 64], 8, 8, 64),
    ([1, 1, 2], 5, 4, 16),
    ([0, 0, 0, 0], 2, 8, 32),
    ([7, 70, 700], 2, 64, 640),                 # the last chunk capped at n_pad
])
def test_chunk_buckets_is_bit_equal(maxes, G, q, n_pad):
    assert fedavg._chunk_buckets(np.array(maxes, np.float64), G, q, n_pad) == \
        jax_fedavg._chunk_buckets(np.array(maxes, np.float64), G, q, n_pad)


class _Stub:
    """The attributes ``_mesh_group_plan`` reads, for either package."""

    def __init__(self, cfg, ds, D):
        self.config, self.dataset = cfg, ds
        self.mesh = type("M", (), {"shape": {"clients": D}, "world_size": D})()


@pytest.mark.parametrize("D,groups,quantum", [(1, 3, 1), (2, 3, 1), (4, 6, 1), (2, 2, 2),
                                              (1, 1, 1), (2, 3, 8)])
def test_mesh_group_plan_is_bit_equal(D, groups, quantum):
    data = {**LR_DATA, "num_clients": 16, "records_per_client": 20}
    run = {**LR_RUN, "client_num_in_total": 16, "client_num_per_round": 16, "batch_size": 4,
           "bucket_groups": groups, "bucket_quantum_batches": quantum}
    jds, ds = jax_synthetic(**data), make_synthetic_classification(**data)
    want = jax_fedavg.CrossSiloFedAvgAPI._mesh_group_plan(
        _Stub(JaxFedConfig(**run), jds, D), 16)
    got = CrossSiloFedAvgAPI._mesh_group_plan(_Stub(FedConfig(**run), ds, D), 16)
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for (gi, gb), (wi, wb) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gb == wb


def _jax_failure_stub(**run):
    class Stub(jax_fedavg.FedAvgAPI):
        def __init__(self):
            self.config, self.history = JaxFedConfig(**run), {}
    return Stub()


@pytest.mark.parametrize("p", [0.0, 0.3, 0.9])
def test_failure_masks_are_bit_equal(p):
    run = {**LR_RUN, "failure_prob": p, "seed": 7}
    jstub = _jax_failure_stub(**run)
    api = FedAvgAPI(make_synthetic_classification(**LR_DATA), FedConfig(**run), device="cpu")
    for r in range(6):
        want = jstub._sample_failures(r, 8)
        got = api._sample_failures(r, 8)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert api.history.get("failed_clients") == jstub.history.get("failed_clients")


@pytest.mark.parametrize("field,good,bad", [
    ("device_data_max_bytes", 1_000, None),
    ("bucket_quantum_batches", 0, None),
    ("bucket_groups", 6, 0),
    ("rounds_per_step", 4, 0),
    ("cohort_vmap_width", 2, None),
    ("stream_aggregate", "deterministic", "sometimes"),
])
def test_config_fields_match_jax(field, good, bad):
    assert getattr(FedConfig(), field) == getattr(JaxFedConfig(), field)
    assert getattr(FedConfig(**{field: good}), field) == getattr(JaxFedConfig(**{field: good}),
                                                                 field)
    if bad is not None:
        with pytest.raises(ValueError):
            JaxFedConfig(**{field: bad})
        with pytest.raises(ValueError):
            FedConfig(**{field: bad})


def test_mesh_checks():
    ds = make_synthetic_classification(**RES_DATA)
    with pytest.raises(NotImplementedError):
        CrossSiloFedAvgAPI(ds, FedConfig(**RES_RUN, rounds_per_step=2), device="cpu")
    two = ClientMesh(2, 0, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the mesh 'clients' axis"):
        CrossSiloFedAvgAPI(ds, FedConfig(**{**RES_RUN, "client_num_per_round": 3}),
                           _res_bundles()[1], mesh=two)
    with pytest.raises(ValueError):
        client_mesh(2, device="cpu")          # no process group: one rank
    mesh = client_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group, mesh.device.type) == (1, 0, None, "cpu")
    assert two.block(6) == slice(0, 3) and ClientMesh(2, 1, None, two.device).block(6) == \
        slice(3, 6)



# -- the mesh schedules against JAX's ----------------------------------------------


@pytest.fixture(scope="module")
def packed_pair():
    return _pair(jax_fedavg.CrossSiloFedAvgAPI, CrossSiloFedAvgAPI, RES_DATA, RES_RUN,
                 pack_lanes=2)


@pytest.fixture(scope="module")
def grouped_pair():
    return _pair(jax_fedavg.CrossSiloFedAvgAPI, CrossSiloFedAvgAPI, RES_DATA, RES_RUN,
                 bucket_groups=3)


@pytest.fixture(scope="module")
def lr_pair():
    return _pair(jax_fedavg.CrossSiloFedAvgAPI, CrossSiloFedAvgAPI, LR_DATA, LR_RUN, lr=True)


@pytest.mark.parametrize("pair", ["packed_pair", "grouped_pair", "lr_pair"])
def test_one_and_two_mesh_rounds_match_jax(pair, request):
    japi, api = request.getfixturevalue(pair)
    schedule = {"packed_pair": "_packed_mesh", "grouped_pair": "_group_plan",
                "lr_pair": "_dev_sharded"}[pair]
    for attr in ("_packed_mesh", "_group_plan", "_dev_sharded"):
        assert (getattr(japi, attr) is not None) == (attr == schedule), attr
        assert (getattr(api, attr) is not None) == (attr == schedule), attr
    if pair == "packed_pair":
        pj, pt = japi._packed_mesh, api._packed_mesh
        np.testing.assert_array_equal(pt["perm"], pj["perm"])
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(pt["plan"], f), getattr(pj["plan"], f))
    if pair == "grouped_pair":
        for (gi, gb), (wi, wb) in zip(api._group_plan, japi._group_plan):
            np.testing.assert_array_equal(gi, wi)
            assert gb == wb
        assert min(b for _, b in api._group_plan) < api.dataset.train_x.shape[1]
    bn = None if pair == "lr_pair" else "PallasBatchNorm"
    for r in range(2):
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
        if pair == "packed_pair":
            assert api.round_counts(r) == japi.round_counts(r)
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        _assert_vars_close(api, japi, f"round {r}", bn_name=bn)
    ev_j, ev_t = japi.evaluate_global(), api.evaluate_global()
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(ev_t["acc"], ev_j["acc"], rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(pack_lanes=2), dict()], ids=["packed", "resident"])
def test_mesh_round_matches_the_simulation_round(kw):
    ds = make_synthetic_classification(**RES_DATA)
    sim = FedAvgAPI(ds, FedConfig(**RES_RUN), _res_bundles()[1], device="cpu")
    cs = CrossSiloFedAvgAPI(ds, FedConfig(**RES_RUN, **kw), _res_bundles()[1], device="cpu")
    assert cs.packed_status()["scheduled"] == bool(kw)
    cs.variables = {k: v.clone() for k, v in sim.variables.items()}
    for r in range(2):
        np.testing.assert_allclose(cs.run_round(r), sim.run_round(r), rtol=1e-5)
        assert _rel_norm(cs.variables, sim.variables) < 1e-5


@pytest.mark.parametrize("jax_cls,cls,kw", [
    (JaxCSFedOpt, CrossSiloFedOptAPI, dict(server_optimizer="adam", server_lr=0.01)),
    (JaxCSFedProx, CrossSiloFedProxAPI, dict(fedprox_mu=0.1)),
    (JaxCSFedNova, CrossSiloFedNovaAPI, dict()),
    (JaxCSFedAGC, CrossSiloFedAGCAPI, dict()),
], ids=["fedopt-adam", "fedprox", "fednova", "fedagc"])
def test_crosssilo_zoo_round_matches_jax(jax_cls, cls, kw):
    # heterogeneous tau and binding clips: ragged lr clients, 2 epochs
    japi, api = _pair(jax_cls, cls, LR_DATA, LR_RUN, lr=True, **kw)
    assert api._dev_sharded is not None
    np.testing.assert_allclose(api.run_round(0), japi.run_round(0), rtol=1e-5)
    _assert_vars_close(api, japi, cls.__name__, bn_name=None)


def test_packed_mesh_zoo_matches_the_plain_mesh():
    """FedOpt's and FedNova's hooks in the lane program of the packed mesh
    against the plain mesh round from the same variables and orders."""
    ds = make_synthetic_classification(**RES_DATA)
    for cls, kw in ((CrossSiloFedOptAPI, dict(server_optimizer="adam", server_lr=0.01)),
                    (CrossSiloFedNovaAPI, {})):
        plain = cls(ds, FedConfig(**RES_RUN, **kw), _res_bundles()[1], device="cpu")
        pk = cls(ds, FedConfig(**RES_RUN, pack_lanes=2, **kw), _res_bundles()[1],
                 device="cpu")
        pk.variables = {k: v.clone() for k, v in plain.variables.items()}
        np.testing.assert_allclose(pk.run_round(0), plain.run_round(0), rtol=1e-5)
        for k, v in plain.variables.items():
            np.testing.assert_allclose(pk.variables[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{cls.__name__} {k}")


# -- elastic rounds ------------------------------------------------------------------

ELASTIC = dict(failure_prob=0.3, seed=3)    # rounds 0 and 1 lose 4 and 2 of the 8 clients


def test_elastic_rounds_match_jax():
    """A round with a failed client (weight 0) on the plain mesh and on
    the simulation round, against the JAX package's."""
    jstub = _jax_failure_stub(**{**LR_RUN, **ELASTIC})
    for r in range(2):
        assert 0 < jstub._sample_failures(r, 8).sum() < 8
    japi, api = _pair(jax_fedavg.CrossSiloFedAvgAPI, CrossSiloFedAvgAPI, LR_DATA, LR_RUN,
                      lr=True, **ELASTIC)
    jsim = jax_fedavg.FedAvgAPI(jax_synthetic(**LR_DATA),
                                JaxFedConfig(**{**LR_RUN, **ELASTIC, "device_data": "off",
                                                "bucket_quantum_batches": 0}),
                                jax_create_model("lr", 4, input_shape=(10,)))
    ds = make_synthetic_classification(**LR_DATA)
    sim = FedAvgAPI(ds, FedConfig(**{**LR_RUN, **ELASTIC}), device="cpu",
                    order_hook=_hook(8, ds.train_x.shape[1], ELASTIC["seed"]))
    sim.variables = flax_to_torch(jax.tree.map(np.asarray, jsim.variables))
    for r in range(2):
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        _assert_vars_close(api, japi, f"mesh round {r}", bn_name=None)
        assert sim.round_counts(r)[0] == jsim.round_counts(r)[0]
        np.testing.assert_allclose(sim.run_round(r), jsim.run_round(r), rtol=1e-5)
        _assert_vars_close(sim, jsim, f"sim round {r}", bn_name=None)
    assert api.history["failed_clients"] == japi.history["failed_clients"] == [4, 2]


@pytest.mark.parametrize("schedule", ["grouped", "host-slice"])
def test_elastic_grouped_and_host_slice_rounds_match_jax(schedule):
    """Failed clients on the grouped round and on the host slice (partial
    participation), against the JAX package's."""
    kw = (dict(bucket_groups=3, bucket_quantum_batches=1) if schedule == "grouped"
          else dict(client_num_per_round=4, bucket_quantum_batches=1))
    japi, api = _pair(jax_fedavg.CrossSiloFedAvgAPI, CrossSiloFedAvgAPI, LR_DATA, LR_RUN,
                      lr=True, **ELASTIC, **kw)
    if schedule == "host-slice":    # orders by cohort position
        api.order_hook = _hook(4, api.dataset.train_x.shape[1], ELASTIC["seed"])
    assert (api._group_plan is not None) == (japi._group_plan is not None) == \
        (schedule == "grouped")
    for r in range(2):
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        _assert_vars_close(api, japi, f"{schedule} round {r}", bn_name=None)
    assert api.history["failed_clients"] == japi.history["failed_clients"]
    assert sum(api.history["failed_clients"]) > 0


def test_elastic_packed_rounds_freeze_and_match_the_plain_rounds():
    """A failure and an exit on the packed mesh and the packed simulation
    round: the frozen clients' lane spans run only where another lane is
    live, and each round equals the plain mesh round with the same masks
    from the same variables (each round starts from the plain round's
    state, so one round's float-order difference does not carry into the
    next)."""
    ds = make_synthetic_classification(**RES_DATA)
    run = {**RES_RUN, "failure_prob": 0.25, "seed": 25}
    plain = CrossSiloFedAvgAPI(ds, FedConfig(**run), _res_bundles()[1], device="cpu")
    pk = CrossSiloFedAvgAPI(ds, FedConfig(**run, pack_lanes=2), _res_bundles()[1],
                            device="cpu")
    sim = FedAvgAPI(ds, FedConfig(**run, pack_lanes=2), _res_bundles()[1], device="cpu")
    live = [pk._sample_failures(r, 4, record=False) for r in range(2)]
    assert all(0 < lv.sum() < 4 for lv in live), live
    full = pk.round_counts(0)[1]
    for r in range(2):
        if r == 1:      # client 0 exits from round 1 on
            for api in (plain, pk, sim):
                api.set_client_active(np.array([0, 1, 1, 1]))
        for api in (pk, sim):
            api.variables = {k: v.clone() for k, v in plain.variables.items()}
        want = plain.run_round(r)
        for api in (pk, sim):
            np.testing.assert_allclose(api.run_round(r), want, rtol=1e-5)
            for k, v in plain.variables.items():
                np.testing.assert_allclose(api.variables[k].numpy(), v.numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=f"{type(api).__name__} {r} {k}")
        assert pk.round_counts(r)[1] == full          # the JAX package's static count
        sampled, live = sim._round_plan(r)
        masked = sim._masked_packed_plan(sampled, live)
        assert masked.live.sum() < sim._packed_plan(sampled).live.sum()


def test_elastic_packed_seed2_cohort_with_jax_orders():
    """The seed-2 cohort of the case above, with the JAX package's orders
    injected. The case above runs at seed 25 because at one torch thread,
    with the port's own orders, the seed-2 plain mesh round parts from the
    packed one by up to 37x the variables' tolerance (float order over a
    different shuffle draw, not a replay fault; at 8 threads, or with JAX's
    orders, the rounds agree). This case keeps the seed-2 cohort covered at
    one thread (the module's fixture), so the move to seed 25 cannot hide a
    replay fault: a failure in each round and an exit in round 1, the packed
    mesh round held to the plain mesh round from the same variables."""
    ds = make_synthetic_classification(**RES_DATA)
    run = {**RES_RUN, "failure_prob": 0.25, "seed": 2}
    hook = _hook(4, ds.train_x.shape[1], seed=2)
    plain = CrossSiloFedAvgAPI(ds, FedConfig(**run), _res_bundles()[1], device="cpu",
                               order_hook=hook)
    pk = CrossSiloFedAvgAPI(ds, FedConfig(**run, pack_lanes=2), _res_bundles()[1],
                            device="cpu", order_hook=hook)
    assert torch.get_num_threads() == 1 and pk._packed_mesh is not None
    live = [pk._sample_failures(r, 4, record=False) for r in range(2)]
    assert all(0 < lv.sum() < 4 for lv in live), live
    for r in range(2):
        if r == 1:      # client 0 exits from round 1 on
            for api in (plain, pk):
                api.set_client_active(np.array([0, 1, 1, 1]))
        pk.variables = {k: v.clone() for k, v in plain.variables.items()}
        want = plain.run_round(r)
        np.testing.assert_allclose(pk.run_round(r), want, rtol=1e-5)
        for k, v in plain.variables.items():
            np.testing.assert_allclose(pk.variables[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"round {r} {k}")


def test_all_failed_round_keeps_weights_and_server_state():
    for cls, kw in ((CrossSiloFedOptAPI, dict(server_optimizer="adam", server_lr=0.01)),
                    (CrossSiloFedOptAPI, dict(server_optimizer="adam", server_lr=0.01,
                                              pack_lanes=2))):
        api = cls(make_synthetic_classification(**RES_DATA), FedConfig(**RES_RUN, **kw),
                  _res_bundles()[1], device="cpu")
        api.run_round(0)
        before = {k: v.clone() for k, v in api.variables.items()}
        tensors, counts = state_tensors(api.server_state["opt"])
        state = [t.clone() for t in tensors + counts]
        api.set_client_active(np.zeros(4))
        assert api.run_round(1) == 0.0 and api.round_counts(1)[0] == 0
        assert all(torch.equal(api.variables[k], v) for k, v in before.items())
        tensors, counts = state_tensors(api.server_state["opt"])
        assert all(torch.equal(a, b) for a, b in zip(tensors + counts, state))
        api.set_client_active(None)
        api.run_round(2)
        assert not all(torch.equal(api.variables[k], v) for k, v in before.items())


def test_partial_participation_runs_the_host_slice():
    """Partial participation declines residency (logged for
    device_data='on') and ships each round's cohort, its axis cut to the
    bucket: equal to the JAX package's host round."""
    run = {**LR_RUN, "client_num_per_round": 4, "bucket_quantum_batches": 1}
    jds = jax_synthetic(**LR_DATA)
    japi = jax_fedavg.CrossSiloFedAvgAPI(jds, JaxFedConfig(**run),
                                         jax_create_model("lr", 4, input_shape=(10,)),
                                         mesh=jax_client_mesh(1))
    ds = make_synthetic_classification(**LR_DATA)
    api = CrossSiloFedAvgAPI(ds, FedConfig(**run), device="cpu",
                             order_hook=_hook(4, ds.train_x.shape[1]))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    assert api._dev_sharded is None and api._packed_mesh is None and api._group_plan is None
    assert api._round_bucket(api.sample(0), None) == japi._round_bucket(api.sample(0), None)
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        _assert_vars_close(api, japi, f"round {r}", bn_name=None)


# -- two ranks over gloo ---------------------------------------------------------------

JOIN_S = 120


def _spawn_ranks(world: int, spec: dict, tmp_path) -> list:
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = tmp_path / "store"
    procs = [ctx.Process(target=torch_crosssilo_ranks.run_rank,
                         args=(r, world, str(store), spec, out)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            got = out.get(timeout=JOIN_S)
            assert len(got) == 3, f"rank {got[0]} failed: {got[1]}"
            results[got[0]] = got[1:]
    except queue.Empty:
        pytest.fail(f"a rank did not report within {JOIN_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    return [results[r] for r in range(world)]


@pytest.mark.parametrize("schedule", ["resident", "packed"])
def test_two_gloo_ranks(schedule, tmp_path):
    """Two spawned ranks over gloo end each round with the same variables,
    equal to the port's one-rank round; the resident schedule is also held
    to JAX's ``client_mesh(2)``. The packed case deals the clients over the
    two ranks (``plan_packing_mesh``, one lane a rank) and each rank trains
    only its block."""
    if schedule == "resident":
        data, run = LR_DATA, LR_RUN
        jds = jax_synthetic(**data)
        japi = jax_fedavg.CrossSiloFedAvgAPI(
            jds, JaxFedConfig(**run),
            jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:]),
            mesh=jax_client_mesh(2))
        init = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    else:
        data, run, japi = RES_DATA, {**RES_RUN, "pack_lanes": 2}, None
        init = CrossSiloFedAvgAPI(make_synthetic_classification(**data), FedConfig(**run),
                                  _res_bundles()[1], device="cpu").variables
    ds = make_synthetic_classification(**data)
    C, n_pad = ds.num_clients, ds.train_x.shape[1]
    init = {k: v.numpy() for k, v in init.items()}
    orders = {(r, j, n_pad): _jax_orders_np(r, C, n_pad)[j] for r in range(2) for j in range(C)}
    spec = dict(data=data, run=run, model="lr" if japi else "cifar-small", init=init,
                orders=orders, rounds=2)
    ranks = _spawn_ranks(2, spec, tmp_path)
    one = CrossSiloFedAvgAPI(ds, FedConfig(**run), None if japi else _res_bundles()[1],
                             device="cpu", order_hook=_hook(C, n_pad))
    one.variables = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    one_losses = [float(one.run_round(r)) for r in range(2)]
    (l0, v0), (l1, v1) = ranks
    assert l0 == l1 and all(np.array_equal(v0[k], v1[k]) for k in v0)   # one replica
    np.testing.assert_allclose(l0, one_losses, rtol=1e-5)
    for k, v in one.variables.items():
        np.testing.assert_allclose(v0[k], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    if japi is None:
        return
    np.testing.assert_allclose(l0, [float(japi.run_round(r)) for r in range(2)], rtol=1e-5)
    got = torch_to_flax({k: torch.from_numpy(v) for k, v in v0.items()})
    want = jax.tree.map(np.asarray, japi.variables)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=str(path))
