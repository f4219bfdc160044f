"""The packed round (``pack_lanes=2``, ``packed_conv="off"``) under the
algorithm zoo and the client optimizers.

- Each algorithm's packed round against the port's plain round of the same
  algorithm on the same orders, the standard of tests/test_packed_zoo.py
  (Test/Loss rtol 5e-5, Test/Acc atol 1e-6), and the variables at
  tests/test_torch_packed.py's rtol 1e-4 / atol 1e-5. 3 clients over 2
  lanes, so one lane trains two clients back to back.
- The FedOpt, FedProx, FedNova and FedAGC packed rounds against the JAX
  packed rounds (``vmap`` of the lane program with the hooks, the Pallas
  BN in interpret mode) on the 4-client, 3-a-round cohort where JAX's own
  packed and plain rounds agree, with JAX's orders injected: variables
  rtol 1e-4 / atol 1e-5, losses rtol 1e-5.
- A packed round with client adam: the lane's second client starts from
  fresh moments and a zero step count; a lane program that carried the
  first client's over is caught.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedagc import FedAGCAPI as JaxFedAGCAPI
from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNovaAPI
from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.algorithms.fedprox import FedProxAPI as JaxFedProxAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.fedagc import FedAGCAPI
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
from fedml_tpu_torch.algorithms.fedprox import FedProxAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel import packed

SEED = 0
DATA = dict(name="packed-zoo", input_shape=(8, 8, 3), classes=10, num_clients=4,
            records_per_client=16, test_records=40, partition_method="hetero",
            partition_alpha=0.5, batch_size=8, seed=SEED)
RUN = dict(model="cifar-small", dataset="packed-zoo", client_num_in_total=4,
           client_num_per_round=3, comm_round=2, batch_size=8, epochs=2, lr=0.05,
           momentum=0.9, frequency_of_the_test=1, seed=SEED, device_data="on", pack_lanes=2)
CASES = {
    "fedopt-adam": (FedOptAPI, dict(server_optimizer="adam", server_lr=0.01)),
    "fedopt-yogi": (FedOptAPI, dict(server_optimizer="yogi", server_lr=0.05)),
    "fedprox": (FedProxAPI, dict(fedprox_mu=0.5, grad_clip=0.5)),
    "fednova": (FedNovaAPI, {}),
    "fedagc": (FedAGCAPI, {}),
    "client-adam": (FedAvgAPI, dict(client_optimizer="adam", lr=0.01, wd=1e-3)),
    # one epoch: yogi's sign(nu - g^2) makes two 2-epoch rounds of the plain
    # round itself move 9.2e-5 when its start moves by 1e-7 (relative,
    # random), past this file's atol; at one epoch both rounds hold at 2.4e-7
    "client-yogi": (FedAvgAPI, dict(client_optimizer="yogi", lr=0.01, epochs=1)),
}


def jax_orders(round_idx: int, cohort: int, n_pad: int):
    """The JAX package's per-client, per-epoch permutations of a round."""
    rk = jax.random.fold_in(jax.random.key(SEED), round_idx)
    return [[torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
             for ek in jax.random.split(ck, RUN["epochs"])]
            for ck in jax.random.split(rk, cohort)]


def assert_vars_close(got: dict, want_flax: dict, msg=""):
    got = torch_to_flax(got, bn_name="PallasBatchNorm")
    want = jax.tree.map(np.asarray, want_flax)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=f"{msg} {path}")


def _bundle():
    return ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                       (8, 8, 3))


def _api(cls, **kw):
    return cls(make_synthetic_classification(**DATA), FedConfig(**{**RUN, **kw}), _bundle(),
               device="cpu")


def _pair(cls, extra):
    plain, pk = _api(cls, pack_lanes=0, **extra), _api(cls, **extra)
    pk.variables = {k: v.clone() for k, v in plain.variables.items()}
    return plain, pk


def _assert_state_close(a: dict, b: dict):
    for k, v in b.items():
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_packed_round_matches_the_plain_round(case):
    cls, extra = CASES[case]
    plain, pk = _pair(cls, extra)
    assert pk.packed_status() == {"scheduled": True, "packed_conv_active": False,
                                  "reason": "packed_conv=off"}
    assert pk._packed_plan(pk.sample(0)).k_max == 2       # a lane trains two clients
    hp, hs = pk.train(), plain.train()
    np.testing.assert_allclose(hp["Test/Loss"], hs["Test/Loss"], rtol=5e-5)
    np.testing.assert_allclose(hp["Test/Acc"], hs["Test/Acc"], atol=1e-6)
    _assert_state_close(pk.variables, plain.variables)
    if cls is FedOptAPI:
        for a, b in zip(packed_state(pk), packed_state(plain)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


def packed_state(api):
    from fedml_tpu_torch.core.optim import state_tensors

    tensors, counts = state_tensors(api.server_state["opt"])
    return tensors + counts


def test_every_algorithm_is_scheduled():
    for cls in (FedOptAPI, FedProxAPI, FedNovaAPI, FedAGCAPI):
        assert _api(cls).packed_status()["scheduled"] is True, cls.__name__


def test_an_unmirrored_subclass_runs_the_plain_round(caplog):
    class Custom(FedAvgAPI):
        def aggregate(self, variables, stacked_vars, counts, infos, rng, server_state):
            return super().aggregate(variables, stacked_vars, counts, infos, rng, server_state)

    with caplog.at_level("WARNING"):
        api = _api(Custom)
    assert api.packed_status() == {"scheduled": False, "packed_conv_active": False,
                                   "reason": "Custom has no packed-lane algorithm mirror"}
    assert api._packed_train is None and "without crosssilo hooks" in caplog.text


JAX_CASES = {"fedopt-adam": (FedOptAPI, JaxFedOptAPI, CASES["fedopt-adam"][1]),
             "fedprox": (FedProxAPI, JaxFedProxAPI, CASES["fedprox"][1]),
             "fednova": (FedNovaAPI, JaxFedNovaAPI, {}),
             "fedagc": (FedAGCAPI, JaxFedAGCAPI, {})}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_packed_round_matches_jax_packed_round(case):
    cls, jcls, kw = JAX_CASES[case]
    jds = jax_synthetic(**DATA)
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = jcls(jds, JaxFedConfig(**RUN, **kw), jbundle)
    n_pad = jds.train_x.shape[1]
    api = cls(make_synthetic_classification(**DATA), FedConfig(**RUN, **kw), _bundle(),
              device="cpu", order_hook=lambda r, i: jax_orders(r, 3, n_pad)[i])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    assert api.packed_status() == japi.packed_status()
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, f"round {r}")
    if cls is not FedOptAPI:
        return
    mu = api.server_state["opt"][0]["mu"]
    jmu = japi.server_state["opt"][0].mu
    want = flax_to_torch({"params": jax.tree.map(np.asarray, jmu)})
    for name, m in zip(api._param_names, mu):
        np.testing.assert_allclose(m.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def test_second_client_of_a_lane_starts_with_fresh_adam_state(monkeypatch):
    """Client adam (amsgrad), one round: the packed aggregate equals the
    plain one, where each client builds its own optimizer. The same round
    with a lane reset that restores the parameters but keeps the moments
    and the step count of the lane's first client does not."""
    extra = dict(client_optimizer="adam", lr=0.01)
    plain, pk = _pair(FedAvgAPI, extra)
    plan = pk._packed_plan(pk.sample(0))
    assert plan.k_max == 2 and plan.member_valid.sum(1).max() == 2
    plain.run_round(0)
    start = {k: v.clone() for k, v in pk.variables.items()}
    pk.run_round(0)
    _assert_state_close(pk.variables, plain.variables)
    lanes = pk._packed_train.lanes[plan.n_lanes]
    counts = lanes.counts[0]
    # the lane with two clients counts only its second client's steps
    two = int(np.argmax(plan.member_valid.sum(1)))
    second = int(plan.steps_real[two, 1]) * RUN["epochs"]
    assert int(counts[two]) == second

    def keep_state(self, lane, glob):
        torch._foreach_copy_(self.lane_state[lane], glob)

    monkeypatch.setattr(packed._Lanes, "reset", keep_state)
    pk.variables = start
    pk._packed_train = pk.build_packed_train()
    pk.run_round(0)
    diff = max(float((pk.variables[k] - v).abs().max()) for k, v in plain.variables.items())
    assert diff > 1e-3
