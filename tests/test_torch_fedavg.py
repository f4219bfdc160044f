"""The port's FedAvg main path against the JAX package's, end to end.

4 hetero clients, 2 per round, a small CifarResNet with the fused BN on
both sides. The JAX side runs unbucketed (``bucket_quantum_batches=0``),
unpacked and host-fed (``device_data="off"``), so each client's scan spans
the full n_pad, and the port is handed JAX's own per-client, per-epoch
permutations:
``permutation(split(split(fold_in(key(seed), r), cohort)[i], epochs)[e], n_pad)``
(fedavg.py:314-318, local.py:194 and 233 of the JAX package). Everything
else — sampling, data, the real-records-first sort, the live steps, SGD
with momentum, BN statistics, the weighted mean — is the port's own.

Tolerance: aggregated variables rtol 1e-4 / atol 1e-5 (the gradient
tolerance of tests/test_torch_resnet.py; a few SGD steps at lr 0.05 carry
f32 summation-order noise forward), losses and eval metrics rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import sample_clients as jax_sample_clients
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.rng import sample_clients
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet

SEED = 0
EPOCHS = 2
DATA = dict(name="fedavg-parity", input_shape=(8, 8, 3), classes=10, num_clients=4,
            records_per_client=16, test_records=40, partition_method="hetero",
            partition_alpha=0.5, batch_size=8, seed=SEED)
RUN = dict(model="cifar-small", dataset="fedavg-parity", client_num_in_total=4,
           client_num_per_round=2, comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05,
           momentum=0.9, frequency_of_the_test=1, seed=SEED, device_data="off")


def _jax_orders(round_idx: int, cohort: int, n_pad: int):
    rk = jax.random.fold_in(jax.random.key(SEED), round_idx)
    return [[torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
             for ek in jax.random.split(ck, EPOCHS)]
            for ck in jax.random.split(rk, cohort)]


def _apis():
    jds = jax_synthetic(**DATA)
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**RUN, bucket_quantum_batches=0, pack_lanes=0),
                        jbundle)

    ds = make_synthetic_classification(**DATA)
    n_pad = ds.train_x.shape[1]
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                         (8, 8, 3))
    api = FedAvgAPI(ds, FedConfig(**RUN), bundle, device="cpu",
                    order_hook=lambda r, i: _jax_orders(r, 2, n_pad)[i])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    return jds, japi, ds, api


def _assert_vars_close(api, japi):
    got = torch_to_flax(api.variables, bn_name="PallasBatchNorm")
    want = jax.tree.map(np.asarray, japi.variables)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))


@pytest.fixture(scope="module")
def apis():
    return _apis()


def test_dataset_is_bit_equal(apis):
    jds, _, ds, _ = apis
    for f in ("train_x", "train_y", "train_mask", "train_counts", "test_x", "test_y",
              "test_mask"):
        a, b = getattr(jds, f), getattr(ds, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    # hetero really is ragged, so the padded last batches are exercised
    assert len(set(ds.train_counts.tolist())) > 1


def test_one_and_two_rounds_match_jax(apis):
    _, japi, _, api = apis
    for r in range(2):
        np.testing.assert_array_equal(api.sample(r), jax_sample_clients(r, 4, 2, SEED))
        loss_j = japi.run_round(r)
        loss_t = api.run_round(r)
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
        _assert_vars_close(api, japi)
    ev_j, ev_t = japi.evaluate_global(), api.evaluate_global()
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(ev_t["acc"], ev_j["acc"], rtol=1e-5)


def test_lanes_round_matches_jax():
    """One round of a small lanes model (16x16 images, so stage 1's convs
    and stage 2's first take conv3x3_lanes, here its plain version) against
    the JAX FedAvg of the NHWC model with XLA convs, from the same
    variables (the two trees are equal) and with JAX's orders. The JAX
    package pins its own lanes model to its XLA model at 5e-3
    (tests/test_conv_lanes.py:104-122); the port's plain K3/K4 sum in f32,
    so it stays at this file's tolerances."""
    data = {**DATA, "input_shape": (16, 16, 3), "name": "fedavg-lanes"}
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16)),
        input_shape=(16, 16, 3), has_batch_stats=True)
    japi = JaxFedAvgAPI(jax_synthetic(**data),
                        JaxFedConfig(**RUN, bucket_quantum_batches=0, pack_lanes=0), jbundle)
    ds = make_synthetic_classification(**data)
    n_pad = ds.train_x.shape[1]
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), conv_impl="lanes"),
                         (16, 16, 3))
    api = FedAvgAPI(ds, FedConfig(**RUN), bundle, device="cpu",
                    order_hook=lambda r, i: _jax_orders(r, 2, n_pad)[i])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    np.testing.assert_allclose(api.run_round(0), japi.run_round(0), rtol=1e-5)
    got = torch_to_flax(api.variables)
    want = jax.tree.map(np.asarray, japi.variables)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("total,per_round,seed",
                         [(32, 8, 0), (32, 8, 3), (10, 10, 0), (1000, 17, 5)])
def test_sample_clients_is_bit_equal(total, per_round, seed):
    for r in range(5):
        np.testing.assert_array_equal(sample_clients(r, total, per_round, seed),
                                      jax_sample_clients(r, total, per_round, seed))


def test_async_rounds_return_a_device_scalar_and_train_runs():
    ds = make_synthetic_classification(**DATA)
    cfg = FedConfig(**{**RUN, "async_rounds": True, "device_data": "auto", "epochs": 1})
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                         (8, 8, 3))
    api = FedAvgAPI(ds, cfg, bundle, device="cpu")
    loss = api.run_round(0)
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0 and torch.isfinite(loss)
    real, executed = api.round_counts(0)
    assert real == int(ds.train_counts[api.sample(0)].sum()) and executed >= real
    h = api.train()
    assert np.isfinite(h["Test/Loss"]).all() and h["rounds_per_sec"] > 0


@pytest.mark.parametrize("field,value", [("packed_conv", "grouped"), ("failure_prob", 0.1),
                                         ("stream_aggregate", "deterministic")])
def test_unported_schedules_raise(field, value):
    """These schedules are ported now, and each case trains a round:
    ``packed_conv`` a packed round under the grouped lowering
    (tests/test_torch_packed_conv.py holds it to the JAX package's),
    ``failure_prob`` one in which failed clients aggregate with weight 0
    (tests/test_torch_crosssilo.py holds the rounds to the JAX package's),
    ``stream_aggregate`` a streamed host round (tests/test_torch_streaming.py
    holds those to the JAX package's)."""
    ds = make_synthetic_classification(**DATA)
    packed = {"pack_lanes": 2, "device_data": "on"} if field == "packed_conv" else {}
    cfg = FedConfig(**{**RUN, field: value, **packed})
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                         (8, 8, 3))
    api = FedAvgAPI(ds, cfg, bundle, device="cpu")
    assert np.isfinite(api.run_round(0))
    if field == "failure_prob":
        assert len(api.history["failed_clients"]) == 1
    elif field == "stream_aggregate":
        assert api.stream_stats["mode"] == "deterministic" and api.stream_stats["chunks"] == 1
    else:
        assert api.packed_status() == {"scheduled": True, "packed_conv_active": True,
                                       "reason": None}


def test_entry_points_default_to_cuda():
    """Without a card, an entry point that was not asked for the CPU raises
    instead of falling back to it."""
    from fedml_tpu_torch import default_device

    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        FedAvgAPI(make_synthetic_classification(**DATA), FedConfig(**RUN))
    assert default_device("cpu").type == "cpu"
