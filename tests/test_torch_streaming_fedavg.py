"""Streaming FedAvg, the native host batcher and ``device_stream``: the
port against its own host round and the JAX package.

- The streamed round (``stream_aggregate="off"``) equals the port's host
  FedAvg round bit for bit with the same orders, with and without
  zero-weight failures, on ``lr``, on a narrow CifarResNet with
  ``bn_impl="pallas"`` and on ``cnn_dropout`` (both rounds key a client's
  masks by its cohort position) (the host round on the whole record axis,
  ``bucket_quantum_batches=0``, which is the axis whose orders the
  streamed clients take, as in the JAX package).
- Against JAX's ``StreamingFedAvgAPI`` with JAX's orders injected: losses
  rtol 1e-5, variables rtol 1e-4 / atol 1e-5
  (tests/test_torch_algorithms.py's bounds).
- ``"deterministic"`` within rtol 1e-6 / atol 1e-7 of ``"off"``
  (tests/test_fedsched.py:35), with ``stream_stats``.
- The round pipeline at depth 2 equals depth 0 bit for bit on a
  cross-device dataset with failures (tests/test_host_pipeline.py:67),
  and a cross-device dataset's ``materialized_rows`` equals the JAX
  package's at both depths: each live client once while cached.
- ``HostPipeline``: native and Python forms stream the same batches in
  explicit-order mode, bad orders are refused, and the seeded native stream
  is bit-equal to the JAX package's native one; ``device_stream`` on the
  CPU yields the pipeline's batches; ``client_slice_cached`` is
  single-flight under threads and read-only.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import native as jax_native
from fedml_tpu.algorithms.streaming_fedavg import StreamingFedAvgAPI as JaxStreamingFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.crossdevice import make_synthetic_crossdevice as jax_crossdevice
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch import native
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.streaming_fedavg import StreamingFedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.crossdevice import make_synthetic_crossdevice
from fedml_tpu_torch.data.pipeline import HostPipeline, device_stream
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from torch_jax_refs import assert_vars_close, order_hook

SEED, EPOCHS = 7, 2
LR_DATA = dict(name="stream-lr", input_shape=(12,), classes=3, num_clients=6,
               records_per_client=21, partition_method="hetero", partition_alpha=0.5,
               batch_size=4, seed=4)
LR_RUN = dict(model="lr", client_num_in_total=6, client_num_per_round=3, comm_round=2,
              epochs=EPOCHS, batch_size=4, lr=0.2, momentum=0.9, seed=SEED,
              frequency_of_the_test=100, device_data="off", bucket_quantum_batches=0)
RES_DATA = dict(name="stream-res", input_shape=(8, 8, 3), classes=10, num_clients=4,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=0)
RES_RUN = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=3,
               comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05, momentum=0.9,
               frequency_of_the_test=100, seed=SEED, device_data="off",
               bucket_quantum_batches=0)
DROP_DATA = dict(name="stream-drop", input_shape=(28, 28, 1), classes=62, num_clients=4,
                 records_per_client=12, partition_method="hetero", partition_alpha=0.5,
                 batch_size=4, seed=1)
DROP_RUN = dict(LR_RUN, model="cnn_dropout", client_num_in_total=4, client_num_per_round=3,
                lr=0.05)
XDEV_CLIENTS, XDEV_DIM = 150, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_bundle(model: str, ds):
    if model in ("lr", "cnn_dropout"):
        return create_model(model, ds.class_num, input_shape=ds.train_x.shape[2:])
    return ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                       (8, 8, 3))


def _pair(model: str, cls=StreamingFedAvgAPI, **kw):
    data, run = {"lr": (LR_DATA, LR_RUN), "cnn_dropout": (DROP_DATA, DROP_RUN)}.get(
        model, (RES_DATA, RES_RUN))
    ds = make_synthetic_classification(**data)
    cfg = FedConfig(**{**run, **kw})
    host = FedAvgAPI(ds, cfg, _port_bundle(model, ds), device="cpu")
    streamed = cls(ds, cfg, _port_bundle(model, ds), device="cpu")
    streamed.variables = {k: v.clone() for k, v in host.variables.items()}
    return host, streamed


@pytest.mark.parametrize("model, failure_prob", [("lr", 0.0), ("lr", 0.4),
                                                 ("cifar-small", 0.0), ("cifar-small", 0.4),
                                                 ("cnn_dropout", 0.0), ("cnn_dropout", 0.4)])
def test_streamed_round_equals_the_host_round_bit_for_bit(model, failure_prob):
    host, streamed = _pair(model, failure_prob=failure_prob)
    for r in range(2):
        assert float(streamed.run_round(r)) == float(host.run_round(r))
        for k, v in host.variables.items():
            assert torch.equal(streamed.variables[k], v), (r, k)
    if failure_prob:
        assert streamed.history["failed_clients"] == host.history["failed_clients"]
        assert sum(host.history["failed_clients"]) > 0
    # the streamed steps are the live ones of the live clients
    sampled, live = streamed._round_plan(0)
    counts = np.asarray(streamed.dataset.train_counts)[sampled]
    counts = counts if live is None else counts[live > 0]
    bs = streamed.config.batch_size
    assert streamed.round_counts(0) == (counts.sum(), sum(-(-int(c) // bs) * bs for c in counts))


def _jax_bundle(model: str, jds):
    if model == "lr":
        return jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:])
    return JaxModelBundle(name="cifar-small",
                          module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                          input_shape=(8, 8, 3), has_batch_stats=True)


@pytest.mark.parametrize("model", ["lr", "cifar-small"])
def test_rounds_match_jax(model):
    data, run = (LR_DATA, LR_RUN) if model == "lr" else (RES_DATA, RES_RUN)
    jds = jax_synthetic(**data)
    japi = JaxStreamingFedAvgAPI(jds, JaxFedConfig(**run), _jax_bundle(model, jds))
    ds = make_synthetic_classification(**data)
    api = StreamingFedAvgAPI(ds, FedConfig(**run), _port_bundle(model, ds), device="cpu",
                             order_hook=order_hook(SEED, EPOCHS, run["client_num_per_round"],
                                                   ds.train_x.shape[1]))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, 1e-4, 1e-5, f"round {r}")


@pytest.mark.parametrize("model", ["lr", "cifar-small"])
def test_deterministic_fold_is_within_fedsched_s_bound_of_off(model):
    data, run = (LR_DATA, LR_RUN) if model == "lr" else (RES_DATA, RES_RUN)
    ds = make_synthetic_classification(**data)
    off = StreamingFedAvgAPI(ds, FedConfig(**run), _port_bundle(model, ds), device="cpu")
    det = StreamingFedAvgAPI(ds, FedConfig(**run, stream_aggregate="deterministic"),
                             _port_bundle(model, ds), device="cpu")
    det.variables = {k: v.clone() for k, v in off.variables.items()}
    for r in range(2):
        np.testing.assert_allclose(det.run_round(r), off.run_round(r), rtol=1e-6, atol=1e-7)
        for k, v in off.variables.items():
            np.testing.assert_allclose(det.variables[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    assert off.stream_stats is None
    assert det.stream_stats == {
        "mode": "deterministic", "cohort": run["client_num_per_round"],
        "chunks": run["client_num_per_round"],
        "accumulator_bytes": sum(v.numel() * 4 for v in off.variables.values()) + 8}


def _xdev_cfg(cls, depth: int, **kw):
    return cls(model="lr", dataset="xdev-stream", client_num_in_total=XDEV_CLIENTS,
               client_num_per_round=4, comm_round=4, batch_size=4, epochs=1, lr=0.2, seed=1,
               frequency_of_the_test=10_000, host_pipeline_depth=depth, failure_prob=0.4, **kw)


def _xdev(make):
    return make("xdev-stream", XDEV_DIM, 5, XDEV_CLIENTS, batch_size=4, mean_records=9.0,
                max_records=25, seed=2)


def test_pipeline_depth_two_equals_depth_zero_and_materializes_as_jax():
    ds, jds = _xdev(make_synthetic_crossdevice), _xdev(jax_crossdevice)
    rows, jrows, runs = [], [], []
    for depth in (0, 2):
        for d in (ds, jds):
            d.__dict__.pop("_client_lru", None)
            d.materialized_rows = 0
        api = StreamingFedAvgAPI(ds, _xdev_cfg(FedConfig, depth),
                                 create_model("lr", ds.class_num, input_shape=(XDEV_DIM,)),
                                 device="cpu")
        try:
            runs.append(([float(api.run_round(r)) for r in range(4)],
                         {k: v.clone() for k, v in api.variables.items()}))
        finally:
            api.close()
        japi = JaxStreamingFedAvgAPI(jds, _xdev_cfg(JaxFedConfig, depth),
                                     jax_create_model("lr", jds.class_num,
                                                      input_shape=(XDEV_DIM,)))
        try:
            for r in range(4):
                japi.run_round(r)
        finally:
            japi.close()
        rows.append(ds.materialized_rows)
        jrows.append(jds.materialized_rows)
    (l0, v0), (l2, v2) = runs
    assert l0 == l2 and all(torch.equal(v0[k], v2[k]) for k in v0)
    assert rows == jrows and rows[0] == rows[1] > 0


def test_host_pipeline_native_and_python_forms_agree():
    assert native.available()          # g++ is on the path here and on the card
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    orders = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [0, 7, 0, 7, 8, 8, 9, 9]], np.int64)
    want = [x[orders[0, :4]], x[orders[0, 4:]], x[orders[1, :4]], x[orders[1, 4:]]] * 2
    for form in (True, False):
        with HostPipeline(x, None, 4, orders=orders, native=form, depth=3) as pipe:
            assert pipe.native is form and pipe.batches_per_epoch == 2
            for w in want:
                bx, by = pipe.next_batch()
                assert by is None and np.array_equal(bx, w)
    short = np.array([[9, 8, 7, 6, 5]], np.int64)          # a short last batch
    with HostPipeline(x, np.arange(10), 4, orders=short) as pipe:
        got = [pipe.next_batch() for _ in range(2)]
    assert [len(b[0]) for b in got] == [4, 1] and np.array_equal(got[1][1], [5])


@pytest.mark.parametrize("orders", [[[0, 9]], [[-1, 0]], [], [0, 1]])
def test_host_pipeline_refuses_bad_orders(orders):
    with pytest.raises(ValueError):
        HostPipeline(np.zeros((4, 2), np.float32), None, 2, orders=np.array(orders, np.int64))


@pytest.mark.parametrize("drop_last", [False, True])
def test_seeded_native_stream_is_jax_s(drop_last):
    x = np.arange(103 * 4, dtype=np.float32).reshape(103, 4)
    y = np.arange(103, dtype=np.int32)
    with HostPipeline(x, y, 16, seed=3, n_threads=3, depth=4, drop_last=drop_last) as ours, \
            jax_native.HostPipeline(x, y, 16, seed=3, n_threads=1, drop_last=drop_last) as theirs:
        assert ours.native and theirs._handle is not None
        assert ours.batches_per_epoch == theirs.batches_per_epoch
        for _ in range(3 * ours.batches_per_epoch):
            (a, b), (c, d) = ours.next_batch(), theirs.next_batch()
            assert np.array_equal(a, c) and np.array_equal(b, d)
            assert np.array_equal(a, x[b])


def test_device_stream_passes_batches_through_on_the_cpu():
    x = np.arange(60, dtype=np.float32).reshape(15, 4)
    y = np.arange(15)
    orders = np.array([[14, 2, 7, 0, 3, 9, 11, 5]], np.int64)
    with HostPipeline(x, y, 3, orders=orders) as pipe:
        got = list(device_stream(pipe, n_batches=4, prefetch=2, device="cpu"))
    o = orders[0]
    assert len(got) == 4
    for (bx, by), idx in zip(got, (o[:3], o[3:6], o[6:], o[:3])):     # epochs of 3 batches
        assert bx.device.type == "cpu" and torch.equal(bx, torch.from_numpy(x[idx]))
        assert torch.equal(by, torch.from_numpy(y[idx]))


def test_client_slice_cached_is_single_flight_and_read_only():
    ds = _xdev(make_synthetic_crossdevice)
    calls, start = [], threading.Barrier(8)
    real = ds._materialize

    def slow(ids):
        calls.append(tuple(int(i) for i in ids))
        time.sleep(0.05)
        return real(ids)

    ds._materialize = slow
    out = [None] * 8

    def worker(i):
        start.wait()
        out[i] = ds.client_slice_cached(17)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [(17,)] and all(o is out[0] for o in out)
    assert ds.materialized_rows == out[0][0].shape[1]
    with pytest.raises(ValueError):
        out[0][0][0, 0, 0] = 1.0
    x, y, m = ds.client_arrays(17)              # served from the cache
    assert calls == [(17,)] and np.array_equal(x, out[0][0][0])
    for k in range(3):                          # the LRU evicts past its cap
        ds.client_slice_cached(100 + k, cap=2)
    assert list(ds._client_lru) == [101, 102]
