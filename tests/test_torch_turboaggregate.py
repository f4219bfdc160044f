"""TurboAggregate: the port's finite-field MPC and ``TurboAggregateAPI``
against the JAX package's.

- Every field primitive (``modpow``, ``modular_inv``, ``lagrange_coeffs``,
  ``_lcc_points``, BGW and LCC encode and decode, ``additive_shares``,
  ``quantize``, ``dequantize``, ``secure_weighted_sum``) bit-equal to JAX's
  on the same inputs and the same generator; the decoders refuse too few
  shares.
- ``secure_aggregate`` equals the plain weighted mean of the same client
  states within the quantization's 2^-20 (tests/test_turboaggregate.py:105
  holds 1e-4).
- Two rounds of ``TurboAggregateAPI`` against JAX's, with JAX's orders
  injected, on ``lr`` (the host round's record axis cut to the bucket) and
  on a narrow CifarResNet with ``bn_impl="pallas"``: variables rtol 1e-4 /
  atol 1e-5 plus one quantum (2^-20), losses rtol 1e-5.
- ``pack_lanes``, ``device_data`` and ``failure_prob`` are ignored with the
  JAX package's warnings; ``packed_status`` is JAX's.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import turboaggregate as jta
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms import turboaggregate as ta
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import tree_stack, tree_weighted_mean
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from torch_jax_refs import assert_vars_close, order_hook

P = int(ta.P_DEFAULT)
QUANTUM = 2.0 ** -20
SEED, EPOCHS = 0, 2
# seed 3: round 0's cohort is cut to 16 of the 24 records
LR_DATA = dict(name="ta-lr", input_shape=(10,), classes=4, num_clients=8,
               records_per_client=12, partition_method="hetero", partition_alpha=0.5,
               batch_size=4, seed=3)
LR_RUN = dict(model="lr", client_num_in_total=8, client_num_per_round=4, comm_round=2,
              batch_size=4, epochs=EPOCHS, lr=0.2, momentum=0.9, frequency_of_the_test=1,
              seed=3, bucket_quantum_batches=1)
RES_DATA = dict(name="ta-res", input_shape=(8, 8, 3), classes=10, num_clients=4,
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


def _field(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64)


def test_modpow_inverse_and_lagrange_are_jax_s():
    rng = np.random.default_rng(0)
    a = rng.integers(1, P, size=50, dtype=np.int64)
    for exp in (0, 1, 2, 7, 12345, P - 2):
        assert np.array_equal(ta.modpow(a, exp, ta.P_DEFAULT), jta.modpow(a, exp, jta.P_DEFAULT))
    inv = ta.modular_inv(a)
    assert np.array_equal(inv, jta.modular_inv(a)) and np.all(np.mod(a * inv, P) == 1)
    alphas, betas = _field(rng, 5), np.arange(-3, 4, dtype=np.int64)
    assert np.array_equal(ta.lagrange_coeffs(alphas, betas), jta.lagrange_coeffs(alphas, betas))
    for N, K, T in [(8, 3, 1), (5, 2, 2), (10, 4, 3)]:
        for got, want in zip(ta._lcc_points(N, K, T, ta.P_DEFAULT),
                             jta._lcc_points(N, K, T, jta.P_DEFAULT)):
            assert np.array_equal(got, want)


def test_bgw_is_jax_s():
    X = _field(np.random.default_rng(1), 4, 6)
    got = ta.bgw_encode(X, 7, 2, rng=np.random.default_rng(11))
    want = jta.bgw_encode(X, 7, 2, rng=np.random.default_rng(11))
    assert np.array_equal(got, want)
    for idx in ([0, 1, 2], [2, 4, 6], [1, 3, 5]):
        rec = ta.bgw_decode(got[idx], idx)
        assert np.array_equal(rec, jta.bgw_decode(want[idx], idx)) and np.array_equal(rec, X)
    with pytest.raises(ValueError):
        ta.bgw_decode(got[[0, 1, 2]], [0, 1])
    with pytest.raises(ValueError):
        ta.bgw_encode(X, 7, 2)          # no generator: no OS-entropy shares


def test_lcc_is_jax_s():
    X = _field(np.random.default_rng(2), 6, 5)
    K, T, N = 3, 1, 8
    got = ta.lcc_encode(X, N, K, T, rng=np.random.default_rng(12))
    want = jta.lcc_encode(X, N, K, T, rng=np.random.default_rng(12))
    assert np.array_equal(got, want)
    for idx in ([0, 1, 2, 3], [4, 5, 6, 7], [0, 2, 4, 6]):
        rec = ta.lcc_decode(got[idx], N, K, T, idx)
        assert np.array_equal(rec, jta.lcc_decode(want[idx], N, K, T, idx))
        assert np.array_equal(rec.reshape(X.shape), X)
    with pytest.raises(ValueError):
        ta.lcc_decode(got[[0, 1, 2]], N, K, T, [0, 1, 2])


def test_additive_shares_and_quantization_are_jax_s():
    rng = np.random.default_rng(3)
    x = _field(rng, 12)
    got = ta.additive_shares(x, 5, rng=np.random.default_rng(13))
    assert np.array_equal(got, jta.additive_shares(x, 5, rng=np.random.default_rng(13)))
    assert np.array_equal(np.mod(got.sum(axis=0), P), x)
    v = np.concatenate([rng.normal(0, 1, 100), [0.0, -0.0, 1023.9, -1023.9, QUANTUM / 2]])
    for bits in (12, 20):
        q = ta.quantize(v, bits)
        assert np.array_equal(q, jta.quantize(v, bits))
        assert np.array_equal(ta.dequantize(q, bits), jta.dequantize(q, bits))
    np.testing.assert_allclose(ta.dequantize(ta.quantize(v)), v, atol=QUANTUM)


@pytest.mark.parametrize("group_size", [1, 2, 3])
def test_secure_weighted_sum_is_jax_s(group_size):
    rng = np.random.default_rng(5)
    vec = rng.normal(0, 1, (8, 40))
    w = rng.uniform(0.5, 2.0, 8)
    w = w / w.sum()
    got = ta.secure_weighted_sum(vec, w, group_size=group_size, seed=6)
    assert np.array_equal(got, jta.secure_weighted_sum(vec, w, group_size=group_size, seed=6))
    np.testing.assert_allclose(got, (vec * w[:, None]).sum(axis=0), atol=1e-4)


def _bundles(model: str, jds):
    if model == "lr":
        return jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:]), None
    return (JaxModelBundle(name="cifar-small",
                           module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                           input_shape=(8, 8, 3), has_batch_stats=True),
            ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                        (8, 8, 3)))


def test_secure_aggregate_is_the_weighted_mean():
    api = TurboAggregateAPI(make_synthetic_classification(**RES_DATA), FedConfig(**RES_RUN),
                            _bundles("res", None)[1], device="cpu")
    gen = torch.Generator().manual_seed(0)
    clients = [{k: v + 0.1 * torch.randn(v.shape, generator=gen) for k, v in
                api.variables.items()} for _ in range(4)]
    wn = np.array([3, 9, 1, 5], np.float32)
    got = api.secure_aggregate(clients, wn)
    want = tree_weighted_mean(tree_stack(clients), torch.from_numpy(wn))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=2 * QUANTUM, err_msg=k)
    stats = api.mpc_stats
    assert stats["clients"] == 4 and stats["floats"] == sum(v.numel() for v in want.values())
    assert 0 < stats["max_abs_xw"] < stats["field_limit"] < 1024


@pytest.mark.parametrize("model", ["lr", "cifar-small"])
def test_rounds_match_jax(model):
    data, run = (LR_DATA, LR_RUN) if model == "lr" else (RES_DATA, RES_RUN)
    jds = jax_synthetic(**data)
    jb, pb = _bundles(model, jds)
    japi = jta.TurboAggregateAPI(jds, JaxFedConfig(**run), jb)
    ds = make_synthetic_classification(**data)
    api = TurboAggregateAPI(ds, FedConfig(**run), pb, device="cpu",
                            order_hook=order_hook(run["seed"], EPOCHS,
                                                  run["client_num_per_round"],
                                                  ds.train_x.shape[1]))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    if model == "lr":        # the host round cuts the record axis to the bucket
        assert api._round_bucket(api.sample(0), None) == 16 < ds.train_x.shape[1]
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, 1e-4, 1e-5 + QUANTUM, f"round {r}")


def test_ignored_options_and_packed_status_are_jax_s(caplog):
    jds = jax_synthetic(**RES_DATA)
    ds = make_synthetic_classification(**RES_DATA)
    for lanes in (0, 2):
        run = {**RES_RUN, "pack_lanes": lanes}
        want = jta.TurboAggregateAPI(jds, JaxFedConfig(**run), _bundles("res", jds)[0])
        got = TurboAggregateAPI(ds, FedConfig(**run), _bundles("res", jds)[1], device="cpu")
        assert got.packed_status() == want.packed_status()
    run = {**RES_RUN, "pack_lanes": 2, "device_data": "on", "failure_prob": 0.5}
    with caplog.at_level(logging.WARNING):
        api = TurboAggregateAPI(ds, FedConfig(**run), _bundles("res", jds)[1], device="cpu")
        api.run_round(0)
    text = caplog.text
    assert "pack_lanes=2 ignored" in text and "device_data='on' ignored" in text
    assert "failure_prob=0.5 ignored" in text
    assert api._dev_train is None and api._packed_train is None
    assert "failed_clients" not in api.history
