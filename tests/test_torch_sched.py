"""The port's cohort scheduler (``fedml_tpu_torch/data/sched.py``) against
the JAX package's (``fedml_tpu/data/sched.py``): both are numpy, so every
plan must be bit-equal, over 25 rounds of each policy, under population
snapshots, partial snapshots (cold starts and ids outside the profile),
empty ones, and through ``CohortScheduler``'s ledger and lag rule. The API
level: ``FedAvgAPI.sample`` is the scheduler's plan, and
``set_cohort_profiler`` freezes it to a static snapshot."""

import logging

import numpy as np
import pytest

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data import sched as jax_sched
from fedml_tpu.data.crossdevice import make_synthetic_crossdevice as jax_crossdevice
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.rng import sample_clients
from fedml_tpu_torch.data import sched
from fedml_tpu_torch.data.crossdevice import make_synthetic_crossdevice
from fedml_tpu_torch.models import create_model

ROUNDS = 25


def _snapshots(mod, n: int):
    """The same snapshots built by each module: a population prior from
    counts, a partial profile with participation, a two-id profile and an
    empty one."""
    rng = np.random.default_rng(11)
    counts = rng.integers(1, 90, n)
    ids = np.sort(rng.choice(n, n // 3, replace=False)).astype(np.int64)
    partial = mod.ProfileSnapshot(ids=ids,
                                  ema_train_ms=rng.gamma(2.0, 10.0, ids.size).astype(np.float32),
                                  participation=rng.integers(0, 9, ids.size).astype(np.int32))
    tiny = mod.ProfileSnapshot(ids=np.array([3, 7], np.int64),
                               ema_train_ms=np.array([1.0, 2.0], np.float32),
                               participation=np.array([4, 5], np.int32))
    empty = mod.ProfileSnapshot(ids=np.empty(0, np.int64), ema_train_ms=np.empty(0, np.float32),
                                participation=np.empty(0, np.int32))
    return {"counts": mod.snapshot_from_counts(counts, 0.7,
                                               participation=rng.integers(0, 5, n)),
            "partial": partial, "tiny": tiny, "empty": empty, "none": None}


def test_constants_match_jax():
    assert sched.COHORT_POLICIES == jax_sched.COHORT_POLICIES
    assert (sched.SCHED_LAG, sched.OVERSAMPLE, sched.FAIR_FRACTION) == \
        (jax_sched.SCHED_LAG, jax_sched.OVERSAMPLE, jax_sched.FAIR_FRACTION)
    assert sched.CohortScheduler.LEDGER_CAP == jax_sched.CohortScheduler.LEDGER_CAP


@pytest.mark.parametrize("policy", sched.COHORT_POLICIES)
@pytest.mark.parametrize("snap", ["counts", "partial", "tiny", "empty", "none"])
def test_plans_are_bit_equal(policy, snap):
    n, cohort, seed = 1000, 20, 4
    ours, theirs = _snapshots(sched, n)[snap], _snapshots(jax_sched, n)[snap]
    if ours is not None:
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for r in range(ROUNDS):
        got = sched.plan_cohort(r, n, cohort, seed, policy, ours)
        want = jax_sched.plan_cohort(r, n, cohort, seed, policy, theirs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{policy} {snap} round {r}")
        if policy == "uniform" or ours is None or ours.n_seen == 0:
            np.testing.assert_array_equal(got, sample_clients(r, n, cohort, seed))


def test_lookup_and_full_participation_match_jax():
    snap, jsnap = _snapshots(sched, 500)["partial"], _snapshots(jax_sched, 500)["partial"]
    pool = np.arange(0, 600, 3, dtype=np.int64)       # ids past the population too
    for a, b in zip(sched._lookup(snap, pool), jax_sched._lookup(jsnap, pool)):
        np.testing.assert_array_equal(a, b)
    for policy in sched.COHORT_POLICIES:
        np.testing.assert_array_equal(sched.plan_cohort(2, 30, 30, 0, policy, snap),
                                      jax_sched.plan_cohort(2, 30, 30, 0, policy, jsnap))
    with pytest.raises(ValueError, match="cohort_policy"):
        sched.plan_cohort(0, 10, 2, 0, "fastest")
    with pytest.raises(ValueError, match="cohort_policy"):
        sched.CohortScheduler("fastest", 0, 10, 2)


def _warnings(caplog) -> int:
    return sum(r.name == "fedml_tpu_torch.data.sched" and "no profiler signal" in r.message
               for r in caplog.records)


class _Profiler:
    def __init__(self, snap):
        self.snap = snap

    def snapshot(self):
        return self.snap


@pytest.mark.parametrize("policy", ["speed", "fair"])
def test_scheduler_ledger_and_lag_replay_jax(policy, caplog):
    """Both schedulers fed the same boundary snapshots plan the same
    cohorts, round by round, through the lag rule and the ledger (a plan,
    once made, replays whatever the signal does next)."""
    n, cohort = 1000, 20
    ours = {k: v for k, v in _snapshots(sched, n).items() if v is not None}
    theirs = {k: v for k, v in _snapshots(jax_sched, n).items() if v is not None}
    feed = [None, "partial", None, "tiny", "counts", None, "partial"]
    src, jsrc = {"p": None}, {"p": None}
    a = sched.CohortScheduler(policy, 3, n, cohort, profile_source=lambda: src["p"])
    b = jax_sched.CohortScheduler(policy, 3, n, cohort, profile_source=lambda: jsrc["p"])
    assert a.wants_notify and b.wants_notify
    with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.data.sched"):
        for r in range(ROUNDS):
            key = feed[r % len(feed)]
            src["p"] = None if key is None else _Profiler(ours[key])
            jsrc["p"] = None if key is None else _Profiler(theirs[key])
            np.testing.assert_array_equal(a.sample(r), b.sample(r), err_msg=f"round {r}")
            a.notify_round_done(r)
            b.notify_round_done(r)
    assert _warnings(caplog) == 1
    for r in range(ROUNDS):           # the ledger replays every plan
        np.testing.assert_array_equal(a.sample(r), b.sample(r))
    a.set_static_profile(ours["counts"])
    b.set_static_profile(theirs["counts"])
    assert not a.wants_notify
    for r in range(ROUNDS):
        np.testing.assert_array_equal(a.sample(r), b.sample(r))


def test_default_scheduler_has_no_live_signal(caplog):
    """The port has no pulse plane: a live policy cold-starts uniform and
    warns once; a static snapshot is the signal."""
    s = sched.CohortScheduler("speed", 0, 1000, 20)
    with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.data.sched"):
        for r in range(3):
            np.testing.assert_array_equal(s.sample(r), sample_clients(r, 1000, 20, 0))
            s.notify_round_done(r)
    assert _warnings(caplog) == 1
    s.set_static_profile(sched.snapshot_from_counts(np.arange(1, 1001)))
    assert not np.array_equal(s.sample(1), sample_clients(1, 1000, 20, 0))


@pytest.mark.parametrize("policy", sched.COHORT_POLICIES)
def test_api_samples_the_jax_apis_cohorts(policy):
    """``FedAvgAPI.sample`` under each policy, with a static count prior
    set through ``set_cohort_profiler``, equals the JAX API's over 20
    rounds; so do ``round_counts``' real examples."""
    n, cohort = 400, 9
    kw = dict(batch_size=4, mean_records=9.0, max_records=24, seed=1)
    run = dict(model="lr", client_num_in_total=n, client_num_per_round=cohort,
               comm_round=20, batch_size=4, lr=0.1, seed=2, cohort_policy=policy)
    jds = jax_crossdevice("sched", 8, 3, n, **kw)
    ds = make_synthetic_crossdevice("sched", 8, 3, n, **kw)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**run), jax_create_model("lr", 3, input_shape=(8,)))
    api = FedAvgAPI(ds, FedConfig(**run), create_model("lr", 3, input_shape=(8,)), device="cpu")
    japi.set_cohort_profiler(jax_sched.snapshot_from_counts(jds.train_counts, 2.0))
    api.set_cohort_profiler(sched.snapshot_from_counts(ds.train_counts, 2.0))
    for r in range(20):
        np.testing.assert_array_equal(api.sample(r), japi._round_plan(r)[0])
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
    api.close()
    japi.close()
