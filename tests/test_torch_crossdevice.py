"""The port's cross-device data and host round against the JAX package's.

- ``data/crossdevice.py``: the synthetic cross-device datasets are numpy
  and bit-equal to the JAX package's, single-label and multilabel (the
  documented draw order), counts, cohorts and the test pool; the virtual
  client stack refuses data access, and ``materialized_rows`` stays
  O(rounds x cohort x n_pad).
- The ``tag_prediction`` task (sigmoid BCE summed over tags, float
  multi-hot labels) against the JAX package's loss and metrics at rtol
  1e-6, and ``finalize_metrics``' precision and recall.
- The host round (``device_data="off"``) at the JAX package's default
  ``bucket_quantum_batches=8``: the cohort's record axis is cut to the
  round's bucket and each client's orders permute the cut axis, so with
  JAX's orders injected (``permutation(split(split(fold_in(key(seed), r),
  cohort)[i], epochs)[e], bucket)``) the rounds match JAX's at the
  streaming tolerance, rtol 1e-6 / atol 1e-7 (tests/test_fedsched.py:35),
  on classification and on multilabel tags; a virtual dataset never goes
  to the device, even with ``device_data="on"``.
"""

import functools
import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core import tasks as jax_tasks
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data import crossdevice as jax_xdev
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core import tasks
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data import crossdevice as xdev
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.parallel.local import finalize_metrics

RTOL, ATOL = 1e-6, 1e-7
FIELDS = ("train_counts", "test_x", "test_y", "test_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("multilabel", [False, True], ids=["single-label", "multilabel"])
def test_synthetic_crossdevice_is_bit_equal(multilabel):
    args = ("xdev", 24, 7, 5000)
    kw = dict(batch_size=4, mean_records=9.0, max_records=30, test_records=300,
              multilabel=multilabel, seed=3)
    ours, theirs = xdev.make_synthetic_crossdevice(*args, **kw), \
        jax_xdev.make_synthetic_crossdevice(*args, **kw)
    assert ours.task == theirs.task == ("tag_prediction" if multilabel else "classification")
    assert ours.train_x.shape == theirs.train_x.shape and ours.num_clients == 5000
    for f in FIELDS:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("train_x", "train_y", "train_mask"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a.shape, a.dtype, a.nbytes) == (b.shape, b.dtype, b.nbytes), f
    ids = np.array([0, 17, 4999, 17, 2500])
    for a, b in zip(ours.client_slice(ids), theirs.client_slice(ids)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.client_arrays(17), theirs.client_arrays(17)):
        np.testing.assert_array_equal(a, b)


def test_stackoverflow_lr_full_widths_and_cohorts_match_jax():
    ours = xdev.load_stackoverflow_lr_full(client_num_in_total=300, batch_size=10)
    theirs = jax_xdev.load_stackoverflow_lr_full(client_num_in_total=300, batch_size=10)
    assert (xdev.WORD_DIM, xdev.TAG_DIM) == (10000, 500)
    assert ours.train_x.shape == (300, 70, xdev.WORD_DIM) and ours.class_num == xdev.TAG_DIM
    np.testing.assert_array_equal(ours.train_counts, theirs.train_counts)
    ids = np.array([5, 299])
    for a, b in zip(ours.client_slice(ids), theirs.client_slice(ids)):
        np.testing.assert_array_equal(a, b)


def test_virtual_stack_refuses_data_access_and_counts_rows():
    ds = xdev.make_synthetic_crossdevice("xdev", 8, 3, 100_000, batch_size=4, max_records=20)
    assert ds.virtual and ds.train_x.nbytes == 100_000 * 20 * 8 * 4
    for arr in (ds.train_x, ds.train_y, ds.train_mask):
        with pytest.raises(RuntimeError, match="client_slice"):
            arr[0]
        with pytest.raises(RuntimeError, match="client_slice"):
            np.asarray(arr)
        with pytest.raises(RuntimeError, match="client_slice"):
            arr.astype(np.float16)
    cfg = FedConfig(model="lr", client_num_in_total=100_000, client_num_per_round=6,
                    comm_round=3, batch_size=4, lr=0.1, device_data="on")
    api = FedAvgAPI(ds, cfg, create_model("lr", 3, input_shape=(8,)), device="cpu")
    assert api._dev_train is None
    rounds = 3
    for r in range(rounds):
        assert np.isfinite(api.run_round(r))
    n_pad = ds.train_x.shape[1]
    assert 0 < ds.materialized_rows <= rounds * 6 * n_pad


def test_tag_task_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((13, 50)) * 4).astype(np.float32)
    targets = (rng.random((13, 50)) < 0.1).astype(np.float32)
    mask = (rng.random(13) < 0.8).astype(np.float32)
    args = [torch.from_numpy(a) for a in (logits, targets, mask)]
    np.testing.assert_allclose(float(tasks.tag_loss(*args)),
                               float(jax_tasks.tag_loss(logits, targets, mask)), rtol=RTOL)
    mt, mj = tasks.tag_metrics(*args), jax_tasks.tag_metrics(logits, targets, mask)
    assert sorted(mt) == sorted(mj)
    for k in mt:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL, err_msg=k)
    fin = finalize_metrics({k: float(v) for k, v in mt.items()})
    assert set(fin) == {"loss", "precision", "recall"}
    assert tasks.get_task("tag_prediction") is tasks.tag_prediction


@functools.lru_cache(maxsize=None)
def _jax_orders(round_idx: int, cohort: int, n: int, seed: int) -> tuple:
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    return tuple(np.asarray(jax.random.permutation(jax.random.split(ck, 1)[0], n))
                 .astype(np.int64)[None] for ck in jax.random.split(rk, cohort))


def _hook(cohort: int, n_pad: int, seed: int):
    def hook(r, i, n=n_pad):
        return [torch.from_numpy(o) for o in _jax_orders(r, cohort, n, seed)[i]]
    return hook


def _assert_close(api, japi, msg):
    got = torch_to_flax(api.variables)
    want = jax.tree.map(np.asarray, japi.variables)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("multilabel", [False, True], ids=["classification", "tags"])
def test_host_round_cuts_to_the_bucket_like_jax(multilabel):
    """Three host rounds at the default quantum (8 batches of 4: the cut
    axis is 96 or 32 of n_pad 128 in these rounds) against JAX's host
    rounds, failures included."""
    n, cohort, dim, classes = 240, 12, 16, 6
    kw = dict(batch_size=4, mean_records=9.0, max_records=128, multilabel=multilabel, seed=5)
    ds = xdev.make_synthetic_crossdevice("xdev-host", dim, classes, n, **kw)
    jds = jax_xdev.make_synthetic_crossdevice("xdev-host", dim, classes, n, **kw)
    run = dict(model="lr", client_num_in_total=n, client_num_per_round=cohort, comm_round=4,
               batch_size=4, epochs=1, lr=0.1, seed=0, failure_prob=0.2,
               frequency_of_the_test=10_000)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**run),
                        jax_create_model("lr", classes, input_shape=(dim,)))
    api = FedAvgAPI(ds, FedConfig(**run), create_model("lr", classes, input_shape=(dim,)),
                    device="cpu", order_hook=_hook(cohort, 128, 0))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    buckets = []
    for r in range(1, 4):
        sampled, live = api._round_plan(r)
        buckets.append(api._round_bucket(sampled, live))
        assert buckets[-1] == japi._round_plan(r)[2]
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=RTOL, atol=ATOL)
        _assert_close(api, japi, f"round {r}")
    assert None not in buckets and min(buckets) < 128
    assert api.history["failed_clients"] == japi.history["failed_clients"]
    ev, jev = api.evaluate_global(), japi.evaluate_global()
    for k in jev:
        np.testing.assert_allclose(ev[k], jev[k], rtol=1e-5, err_msg=k)
    api.close()
    japi.close()


def test_virtual_dataset_on_device_data_on_warns(caplog):
    ds = xdev.make_synthetic_crossdevice("xdev", 8, 3, 1000, batch_size=4, max_records=20)
    cfg = FedConfig(model="lr", client_num_in_total=1000, client_num_per_round=4,
                    batch_size=4, device_data="on", stream_aggregate="deterministic")
    with caplog.at_level(logging.WARNING):
        api = FedAvgAPI(ds, cfg, create_model("lr", 3, input_shape=(8,)), device="cpu")
    assert api._dev_train is None and "virtual cross-device dataset" in caplog.text
    assert "stream_aggregate" not in caplog.text     # streaming applies: not resident
