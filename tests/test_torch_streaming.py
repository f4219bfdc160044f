"""The port's streamed host rounds (``stream_aggregate``, ``cohort_chunk``)
against the JAX package's, and against the port's own batch round.

- Streamed ``lr`` rounds on a synthetic cross-device federation, with JAX's
  per-client orders injected by cohort position (a chunk's client j takes
  position ``start + j``): unchunked, chunked, chunked with failures, and
  packed chunks through the lane-stacked ``lr``. Tolerances are the JAX
  package's own for these comparisons (tests/test_fedsched.py:35, :337):
  losses and variables rtol 1e-6 / atol 1e-7, packed variables rtol 1e-5 /
  atol 1e-6.
- The unchunked deterministic streamed round equals the port's batch host
  round bit for bit (with failures too): the fold is
  ``core/pytree.weighted_sum`` over the same normalized f32 weights; and
  ``weighted_sum`` is ``tree_weighted_mean``'s arithmetic.
- "arrival" folds the same chunk order: equal to "deterministic".
- ``stream_stats["accumulator_bytes"]`` is the model's f32 bytes + 8,
  whatever the chunking.
- The lane-stacked ``lr`` equals L separate ``lr`` models (logits and
  gradients), and a packed streamed round equals the unpacked streamed
  round at the packed tolerance.
- One streamed packed round of a small CifarResNet (widths 8/16/16, the
  fused BN; the JAX Pallas BN in interpret mode) against JAX's, at
  tests/test_torch_packed.py's tolerance (variables rtol 1e-4 / atol 1e-5,
  loss rtol 1e-5).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.crossdevice import make_synthetic_crossdevice as jax_crossdevice
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import tree_weighted_mean, weighted_sum
from fedml_tpu_torch.core.tasks import classification_loss
from fedml_tpu_torch.data.crossdevice import make_synthetic_crossdevice
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.ops.packed_conv import stack_variables

RTOL, ATOL = 1e-6, 1e-7          # tests/test_fedsched.py:35
PACKED_RTOL, PACKED_ATOL = 1e-5, 1e-6   # tests/test_fedsched.py:337
N_CLIENTS, COHORT, DIM, CLASSES = 240, 12, 16, 6
DATA = dict(batch_size=4, mean_records=9.0, max_records=21, seed=5)
RUN = dict(model="lr", client_num_in_total=N_CLIENTS, client_num_per_round=COHORT,
           comm_round=3, batch_size=4, epochs=1, lr=0.1, seed=0, frequency_of_the_test=10_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def datasets():
    return (make_synthetic_crossdevice("xdev-stream", DIM, CLASSES, N_CLIENTS, **DATA),
            jax_crossdevice("xdev-stream", DIM, CLASSES, N_CLIENTS, **DATA))


@functools.lru_cache(maxsize=None)
def _jax_orders(round_idx: int, cohort: int, n: int, epochs: int, seed: int) -> tuple:
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    return tuple(np.stack([np.asarray(jax.random.permutation(ek, n)).astype(np.int64)
                           for ek in jax.random.split(ck, epochs)])
                 for ck in jax.random.split(rk, cohort))


def _hook(cohort: int, n_pad: int, epochs: int = 1, seed: int = 0):
    def hook(r, i, n=n_pad):
        return [torch.from_numpy(o) for o in _jax_orders(r, cohort, n, epochs, seed)[i]]
    return hook


def _lr_pair(datasets, **kw):
    ds, jds = datasets
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**RUN, **kw),
                        jax_create_model("lr", CLASSES, input_shape=(DIM,)))
    api = FedAvgAPI(ds, FedConfig(**RUN, **kw), create_model("lr", CLASSES, input_shape=(DIM,)),
                    device="cpu", order_hook=_hook(COHORT, ds.train_x.shape[1]))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    return api, japi


def _port(datasets, init=None, **kw) -> tuple:
    """The port's losses, variables and stream stats over rounds 1..3."""
    ds = datasets[0]
    api = FedAvgAPI(ds, FedConfig(**RUN, **kw), create_model("lr", CLASSES, input_shape=(DIM,)),
                    device="cpu", order_hook=_hook(COHORT, ds.train_x.shape[1]))
    if init is not None:
        api.variables = {k: v.clone() for k, v in init.items()}
    try:
        losses = [api.run_round(r) for r in range(1, 4)]
        return losses, api.variables, api.stream_stats
    finally:
        api.close()


CASES = {
    "unchunked": dict(stream_aggregate="deterministic"),
    "chunked": dict(stream_aggregate="deterministic", cohort_chunk=5),
    "chunked-failures": dict(stream_aggregate="deterministic", cohort_chunk=5,
                             failure_prob=0.3),
    "packed-chunks": dict(stream_aggregate="deterministic", cohort_chunk=5, pack_lanes=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_rounds_match_jax(datasets, case):
    kw = CASES[case]
    api, japi = _lr_pair(datasets, **kw)
    vtol = (dict(rtol=PACKED_RTOL, atol=PACKED_ATOL) if "pack_lanes" in kw
            else dict(rtol=RTOL, atol=ATOL))
    for r in range(1, 4):
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=RTOL, atol=ATOL)
        got = torch_to_flax(api.variables)
        want = jax.tree.map(np.asarray, japi.variables)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_allclose(b, a, err_msg=f"{case} round {r}", **vtol)
    stats, jstats = api.stream_stats, japi.stream_stats
    assert stats == jstats
    if "failure_prob" in kw:
        assert api.history["failed_clients"] == japi.history["failed_clients"]
        assert sum(api.history["failed_clients"]) > 0
    api.close()
    japi.close()


@pytest.mark.parametrize("failure_prob", [0.0, 0.3])
def test_unchunked_stream_is_the_batch_round_bit_for_bit(datasets, failure_prob):
    init = FedAvgAPI(datasets[0], FedConfig(**RUN), device="cpu").variables
    l0, v0, s0 = _port(datasets, init, failure_prob=failure_prob)
    l1, v1, s1 = _port(datasets, init, failure_prob=failure_prob,
                       stream_aggregate="deterministic")
    assert s0 is None and s1["chunks"] == 1
    assert l0 == l1
    assert all(torch.equal(v0[k], v1[k]) for k in v0)


def test_weighted_sum_is_tree_weighted_means_arithmetic():
    g = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn(7, 5, 3, generator=g),
               "b": torch.randn(7, 3, generator=g).to(torch.bfloat16)}
    counts = torch.tensor([3.0, 0.0, 11.0, 1.0, 5.0, 2.0, 9.0])
    mean = tree_weighted_mean(stacked, counts)
    w_norm = (counts.numpy() / np.maximum(np.float32(counts.numpy().sum()),
                                          np.float32(1e-12))).astype(np.float32)
    for k, x in stacked.items():
        got = (torch.zeros(x.shape[1:]) + weighted_sum(x, torch.from_numpy(w_norm))).to(x.dtype)
        assert torch.equal(got, mean[k]), k


def test_arrival_folds_the_same_chunk_order(datasets):
    init = FedAvgAPI(datasets[0], FedConfig(**RUN), device="cpu").variables
    ld, vd, _ = _port(datasets, init, stream_aggregate="deterministic", cohort_chunk=5)
    la, va, sa = _port(datasets, init, stream_aggregate="arrival", cohort_chunk=5)
    assert sa["mode"] == "arrival" and la == ld
    assert all(torch.equal(vd[k], va[k]) for k in vd)


def test_accumulator_is_one_f32_model(datasets):
    model_bytes = DIM * CLASSES * 4 + CLASSES * 4 + 8
    sizes = set()
    for kw in (dict(), dict(cohort_chunk=5), dict(cohort_chunk=5, pack_lanes=2)):
        stats = _port(datasets, stream_aggregate="deterministic", **kw)[2]
        sizes.add(stats["accumulator_bytes"])
        assert stats["chunks"] == (3 if kw else 1) and stats["cohort"] == COHORT
    assert sizes == {model_bytes}


def test_lane_stacked_lr_is_separate_models():
    L, n = 3, 5
    models = [create_model("lr", CLASSES, input_shape=(DIM,)).module for _ in range(L)]
    g = torch.Generator().manual_seed(1)
    for m in models:
        m.reset_parameters(g)
    twin = models[0].lane_stacked(L)
    twin.load_state_dict({k: torch.cat([m.state_dict()[k] for m in models])
                          for k in twin.state_dict()})
    x = torch.randn(L, n, DIM, generator=g)
    y = torch.randint(0, CLASSES, (L, n), generator=g)
    mask = torch.ones(L, n)
    logits = twin(x)
    assert logits.shape == (L, n, CLASSES)
    sum(classification_loss(logits[l], y[l], mask[l]) for l in range(L)).backward()
    for lane, m in enumerate(models):
        out = m(x[lane])
        classification_loss(out, y[lane], mask[lane]).backward()
        torch.testing.assert_close(logits[lane], out, rtol=1e-6, atol=1e-7)
        for name, p in m.named_parameters():
            tp = dict(twin.named_parameters())[name]
            torch.testing.assert_close(tp.grad.view(L, *p.shape)[lane], p.grad, rtol=1e-6,
                                       atol=1e-7)
    assert twin.state_dict().keys() == stack_variables(models[0].state_dict(), L).keys()


def test_packed_lr_stream_tracks_the_unpacked_stream(datasets):
    init = FedAvgAPI(datasets[0], FedConfig(**RUN), device="cpu").variables
    lp, vp, sp = _port(datasets, init, stream_aggregate="deterministic", cohort_chunk=5,
                       pack_lanes=2)
    lu, vu, _ = _port(datasets, init, stream_aggregate="deterministic", cohort_chunk=5)
    assert sp["packed_lanes"] == 2
    np.testing.assert_allclose(lp, lu, rtol=RTOL, atol=ATOL)
    for k in vu:
        np.testing.assert_allclose(vp[k].numpy(), vu[k].numpy(), rtol=PACKED_RTOL,
                                   atol=PACKED_ATOL, err_msg=k)


RES_DATA = dict(name="stream-res", input_shape=(8, 8, 3), classes=10, num_clients=5,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=0)
RES_RUN = dict(model="cifar-small", client_num_in_total=5, client_num_per_round=4,
               comm_round=1, batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=0,
               frequency_of_the_test=10, device_data="off", stream_aggregate="deterministic",
               cohort_chunk=3, pack_lanes=2)


def test_streamed_packed_resnet_round_matches_jax():
    """Chunks of 3 and 1 clients (the second a one-lane chunk) of a small
    CifarResNet, packed, against the JAX package's streamed packed round."""
    jb = JaxModelBundle(name="cifar-small",
                        module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = JaxFedAvgAPI(jax_synthetic(**RES_DATA), JaxFedConfig(**RES_RUN), jb)
    ds = make_synthetic_classification(**RES_DATA)
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                         (8, 8, 3))
    api = FedAvgAPI(ds, FedConfig(**RES_RUN), bundle, device="cpu",
                    order_hook=_hook(4, ds.train_x.shape[1], epochs=2))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    assert api.packed_status()["scheduled"]
    np.testing.assert_allclose(api.run_round(0), japi.run_round(0), rtol=1e-5)
    assert api.stream_stats == japi.stream_stats
    assert api.round_counts(0)[0] == japi.round_counts(0)[0]
    got = torch_to_flax(api.variables, bn_name="PallasBatchNorm")
    want = jax.tree.map(np.asarray, japi.variables)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))
    assert sorted(api._stream_packed.lanes) == [1, 2]
    api.close()
    japi.close()
