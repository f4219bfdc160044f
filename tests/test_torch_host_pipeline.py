"""The port's host round pipeline (``fedml_tpu_torch/data/pipeline.py``:
``CohortPrefetcher``, ``materialize_cohort``, ``ship``/``receive``) and its
use by ``FedAvgAPI`` (``host_pipeline_depth``).

- Pipelined rounds equal serial rounds bit for bit: host rounds (bucketed,
  unbucketed, async, with failures) and streamed rounds (chunked, packed
  chunks), since each round's (or chunk's) inputs are a pure function of
  the seed and the round, and per-client materialization fanned out over
  threads builds the same arrays. A pipelined round also equals the JAX
  package's pipelined round (rtol 1e-6 / atol 1e-7,
  tests/test_fedsched.py:35, with JAX's orders injected).
- The prefetcher's semantics are the JAX package's: out-of-order pops
  build on demand and drop speculation outside the window; speculation
  stops at ``max_round`` and a caller's pops past it raise the bound; a
  build's exception re-raises at the consuming pop (no hang); ``close``
  drains, is idempotent, and the API builds a new prefetcher after it;
  ``train()`` builds exactly its rounds.
- ``round_stats`` equals the JAX package's; rounds record stage rows.
- ``materialized_rows`` loses no update under concurrent materialization.
"""

import functools
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.crossdevice import make_synthetic_crossdevice as jax_crossdevice
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.utils.metrics import round_stats as jax_round_stats
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.rng import sample_clients
from fedml_tpu_torch.data.crossdevice import make_synthetic_crossdevice
from fedml_tpu_torch.data.pipeline import CohortPrefetcher, materialize_cohort, receive, ship
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.metrics import round_stats

N_CLIENTS, COHORT, DIM, CLASSES = 150, 4, 8, 5
DATA = dict(batch_size=4, mean_records=9.0, max_records=60, seed=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ds():
    return make_synthetic_crossdevice("xdev-pipe", DIM, CLASSES, N_CLIENTS, **DATA)


def _cfg(depth, rounds=3, **kw):
    kw = {"client_num_per_round": COHORT, **kw}
    return FedConfig(model="lr", client_num_in_total=N_CLIENTS, comm_round=rounds, batch_size=4,
                     epochs=1, lr=0.2, seed=1, frequency_of_the_test=10_000,
                     host_pipeline_depth=depth, **kw)


def _run(ds, cfg, start=0):
    api = FedAvgAPI(ds, cfg, create_model("lr", CLASSES, input_shape=(DIM,)), device="cpu")
    torch.manual_seed(0)
    api.variables = {k: torch.randn(v.shape) for k, v in api.variables.items()}
    try:
        losses = [float(api.run_round(r)) for r in range(start, cfg.comm_round)]
        return losses, api.variables, list(api._stage_rows)
    finally:
        api.close()


PIPE_CASES = {
    "bucketed": {}, "unbucketed": {"bucket_quantum_batches": 0},
    "bucketed-async": {"async_rounds": True}, "failures": {"failure_prob": 0.3},
    "streamed-chunks": {"stream_aggregate": "deterministic", "cohort_chunk": 3},
    "streamed-packed": {"stream_aggregate": "deterministic", "cohort_chunk": 3,
                        "pack_lanes": 2, "client_num_per_round": 7},
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_is_bit_identical_to_serial(ds, case):
    kw = dict(PIPE_CASES[case])
    l0, v0, rows0 = _run(ds, _cfg(0, **kw))
    l2, v2, rows2 = _run(ds, _cfg(2, host_pipeline_workers=3, **kw))
    assert l0 == l2
    assert all(torch.equal(v0[k], v2[k]) for k in v0)
    assert len(rows0) == len(rows2) == 3
    assert round_stats(rows0, 0)["overlap_frac"] == 0.0


@functools.lru_cache(maxsize=None)
def _jax_orders(round_idx: int, n: int) -> tuple:
    rk = jax.random.fold_in(jax.random.key(1), round_idx)
    return tuple(np.asarray(jax.random.permutation(jax.random.split(ck, 1)[0], n))
                 .astype(np.int64)[None] for ck in jax.random.split(rk, COHORT))


def test_pipelined_round_matches_jaxs(ds):
    jds = jax_crossdevice("xdev-pipe", DIM, CLASSES, N_CLIENTS, **DATA)
    cfg = dict(model="lr", client_num_in_total=N_CLIENTS, client_num_per_round=COHORT,
               comm_round=3, batch_size=4, epochs=1, lr=0.2, seed=1,
               frequency_of_the_test=10_000, host_pipeline_depth=2)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**cfg), jax_create_model("lr", CLASSES,
                                                                   input_shape=(DIM,)))
    api = FedAvgAPI(ds, FedConfig(**cfg), create_model("lr", CLASSES, input_shape=(DIM,)),
                    device="cpu",
                    order_hook=lambda r, i, n=ds.train_x.shape[1]: [
                        torch.from_numpy(o) for o in _jax_orders(r, n)[i]])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    for r in range(3):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-6, atol=1e-7)
        got, want = torch_to_flax(api.variables), jax.tree.map(np.asarray, japi.variables)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert api._prefetcher is not None
    api.close()
    japi.close()


def test_materialize_cohort_fanned_out_equals_serial(ds):
    from concurrent.futures import ThreadPoolExecutor

    ids = sample_clients(3, N_CLIENTS, 11, 0)
    want = materialize_cohort(ds, ids)
    with ThreadPoolExecutor(4) as pool:
        got = materialize_cohort(ds, ids, pool, n_chunks=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_ship_and_receive_hand_off_on_the_cpu():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = torch.ones(2, dtype=torch.bfloat16)
    s = ship([a, b], torch.device("cpu"))
    assert s.event is None
    x, y = receive(s)
    assert torch.equal(x, torch.from_numpy(a)) and torch.equal(y, b)


def test_background_exception_surfaces_no_hang(ds):
    """A materializer crash in round 3's build is held in its future and
    raised by run_round(3); rounds 0-2 train meanwhile."""
    api = FedAvgAPI(ds, _cfg(2, rounds=6), create_model("lr", CLASSES, input_shape=(DIM,)),
                    device="cpu")

    def cohort(r):
        return set(sample_clients(r, N_CLIENTS, COHORT, seed=1).tolist())

    only_r3 = cohort(3) - set().union(*[cohort(r) for r in (0, 1, 2, 4, 5)])
    assert only_r3
    marker = min(only_r3)
    inner = ds._materialize

    def poisoned(ids):
        if marker in np.asarray(ids).tolist():
            raise ValueError("injected materializer crash")
        return inner(ids)

    ds._materialize = poisoned
    try:
        for r in range(3):
            assert np.isfinite(float(api.run_round(r)))
        with pytest.raises(ValueError, match="injected materializer crash"):
            api.run_round(3)
    finally:
        ds._materialize = inner
        api.close()


def test_close_drains_and_api_stays_usable(ds):
    api = FedAvgAPI(ds, _cfg(2, rounds=4), create_model("lr", CLASSES, input_shape=(DIM,)),
                    device="cpu")
    l0 = float(api.run_round(0))
    pf = api._prefetcher
    assert pf is not None and pf._inflight
    api.close()
    assert not pf._inflight
    api.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.pop(1)
    l1 = float(api.run_round(1))
    assert np.isfinite(l0) and np.isfinite(l1) and api._prefetcher is not pf
    api.close()


def test_prefetcher_out_of_order_pop_and_eviction():
    def build(r, _pool):
        return r * 10, {"materialize_ms": 0.0, "h2d_ms": 0.0}

    with CohortPrefetcher(build, depth=2, workers=1) as pf:
        assert pf.pop(5)[0] == 50 and sorted(pf._inflight) == [6, 7]
        assert pf.pop(0)[0] == 0 and sorted(pf._inflight) == [1, 2]


def test_prefetcher_speculation_bound_is_adaptive():
    def build(r, _pool):
        return r, {"materialize_ms": 0.0, "h2d_ms": 0.0}

    with CohortPrefetcher(build, depth=2, workers=1, max_round=3) as pf:
        pf.prime(0, wait=True)
        assert sorted(pf._inflight) == [0, 1]
        pf.pop(1)
        assert sorted(pf._inflight) == [2]
        pf.pop(3)
        assert pf.max_round == 4
        pf.pop(2)
        assert sorted(pf._inflight) == [3]
        pf.pop(4)
        pf.pop(5)
        assert pf.max_round is None and sorted(pf._inflight) == [6, 7]


def test_train_does_not_speculate_past_schedule(ds):
    rounds, n_pad = 3, ds.train_x.shape[1]
    for depth in (0, 2):
        ds.materialized_rows = 0
        api = FedAvgAPI(ds, _cfg(depth, rounds=rounds),
                        create_model("lr", CLASSES, input_shape=(DIM,)), device="cpu")
        api.train()
        api.close()
        assert ds.materialized_rows == rounds * COHORT * n_pad, depth


def test_round_stats_match_jax_and_rows_are_recorded(ds):
    serial = [{"materialize_ms": 40.0, "h2d_ms": 10.0, "compute_ms": 50.0, "wait_ms": 50.0}] * 4
    piped = [{"materialize_ms": 40.0, "h2d_ms": 10.0, "compute_ms": 50.0, "wait_ms": 5.0}] * 4
    for rows, depth in ((serial, 0), (piped, 2), ([], 3)):
        assert round_stats(rows, depth) == jax_round_stats(rows, depth)
    assert round_stats(piped, 2)["overlap_frac"] == 0.9
    _, _, rows = _run(ds, _cfg(0, rounds=2))
    assert len(rows) == 2 and all(r["materialize_ms"] > 0 for r in rows)
    assert set(rows[0]) == {"materialize_ms", "h2d_ms", "wait_ms", "round", "compute_ms"}


def test_materialized_rows_lose_no_update_under_threads():
    ds = make_synthetic_crossdevice("xdev-race", 4, 3, 500, batch_size=2, max_records=6)
    n_pad = ds.train_x.shape[1]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [ds.client_slice(np.array([i, i + 1]))
                                                        for _ in range(20)])
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ds.materialized_rows == 16 * 20 * 2 * n_pad
