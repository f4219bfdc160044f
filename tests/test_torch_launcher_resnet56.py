"""The launcher's ResNet-56 line against the JAX launcher's, on the CPU.

chip_smoke.py's phase 13 (b) runs ``--algorithm fedavg --dataset cifar10
--model resnet56 --batch_size 64 --lr 0.1 --momentum 0.9`` through the
launcher's bundle (plain BatchNorm, as the JAX launcher's ``_bundle_for``
builds it) on the CIFAR-10 stand-in, and evaluates far above chance loss.
Here the same line, cut to 2 clients, 1 a round, 2 rounds, goes through
both launchers' ``_load`` and ``_bundle_for`` from the JAX model's initial
weights, with JAX's per-epoch orders injected through ``order_hook``:

- the port's eval of the JAX run's final variables equals the JAX run's
  last Test/Loss and Test/Acc (rtol 1e-5): the eval path agrees even on
  running statistics that make the loss blow up;
- both runs' eval losses blow up alike: every eval round above 10 ln 10
  (ten times chance loss) with Test/Acc at most 0.2 (chance is 0.1). Their
  values are compared as an order of magnitude, not at a tolerance,
  because of the next point;
- a ResNet-56 step is ill-conditioned in f32: the same batch with its rows
  permuted (the same gradient in exact arithmetic) moves the port's
  gradient by more than 1e-3 relative, while the loss agrees within 1e-6.
  So a few steps at lr 0.1 and momentum 0.9 carry f32 rounding into the
  running statistics that the eval reads, in either framework: the port's
  own run, with only the rows inside each batch permuted (the same batches,
  the same sums in another order), blows up as well, to another value.

The readings are printed (``pytest -s``).
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.experiments import _bundle_for as jax_bundle_for
from fedml_tpu.experiments import _load as jax_load
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.rng import sample_clients
from fedml_tpu_torch.experiments import _bundle_for, _load
from fedml_tpu_torch.models.convert import flax_to_torch

RUN = dict(model="resnet56", dataset="cifar10", client_num_in_total=2, client_num_per_round=1,
           comm_round=2, batch_size=64, lr=0.1, momentum=0.9, frequency_of_the_test=1, seed=0)


def _jax_orders(round_idx: int, n_pad: int):
    rk = jax.random.fold_in(jax.random.key(RUN["seed"]), round_idx)
    ck = jax.random.split(rk, RUN["client_num_per_round"])[0]
    ek = jax.random.split(ck, 1)[0]
    return [torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))]


def _rows_permuted_in_batches(perm: torch.Tensor, count: int, batch: int) -> torch.Tensor:
    """The batches that ``perm`` gives a client of ``count`` real records
    (real records first, as the local trainer sorts them), each with its
    rows in another order."""
    mask = (perm < count).float()       # a client's real records are its first rows
    order = perm[torch.argsort(-mask, stable=True)]
    g = torch.Generator().manual_seed(3)
    blocks = [b[torch.randperm(len(b), generator=g)] for b in order.split(batch)]
    return torch.cat(blocks)


def _port_run(ds, init, order_hook):
    cfg = FedConfig(**RUN)
    api = FedAvgAPI(ds, cfg, _bundle_for(cfg, ds), device="cpu", order_hook=order_hook)
    api.variables = {k: v.clone() for k, v in init.items()}
    return api, api.train()


@pytest.fixture(scope="module")
def runs():
    jc = JaxFedConfig(**RUN, device_data="off", bucket_quantum_batches=0)
    jds = jax_load(jc)
    japi = JaxFedAvgAPI(jds, jc, jax_bundle_for(jc, jds))
    init = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    want = japi.train()
    final = flax_to_torch(jax.tree.map(np.asarray, japi.variables))

    ds = _load(FedConfig(**RUN))
    n_pad = ds.train_x.shape[1]
    api, got = _port_run(ds, init, lambda r, i: _jax_orders(r, n_pad))

    def reordered(r, i):
        client = sample_clients(r, RUN["client_num_in_total"], RUN["client_num_per_round"],
                                RUN["seed"])[i]
        return [_rows_permuted_in_batches(p, int(ds.train_counts[client]), RUN["batch_size"])
                for p in _jax_orders(r, n_pad)]

    _, again = _port_run(ds, init, reordered)
    print(f"\nJAX  Test/Loss {want['Test/Loss']} Test/Acc {want['Test/Acc']}"
          f"\nport Test/Loss {got['Test/Loss']} Test/Acc {got['Test/Acc']}"
          f"\nport, rows permuted in each batch: Test/Loss {again['Test/Loss']} "
          f"Test/Acc {again['Test/Acc']}")
    return want, got, api, final, again


def test_eval_of_the_jax_run_s_variables_matches_jax(runs):
    want, _, api, final, _ = runs
    mine = api.variables
    try:
        api.variables = final
        m = api.evaluate_global()
    finally:
        api.variables = mine
    print(f"\nport eval of JAX's final variables: {m}")
    np.testing.assert_allclose(m["loss"], want["Test/Loss"][-1], rtol=1e-5)
    np.testing.assert_allclose(m["acc"], want["Test/Acc"][-1], rtol=1e-5)


def test_both_eval_histories_blow_up_alike(runs):
    want, got, _, _, again = runs
    assert got["round"] == want["round"] == again["round"] == [0, 1]
    assert got["Test/Loss"] != again["Test/Loss"]
    for h in (want, got, again):
        assert all(loss > 10 * math.log(10) for loss in h["Test/Loss"]), h["Test/Loss"]
        assert all(acc <= 0.2 for acc in h["Test/Acc"]), h["Test/Acc"]


def test_a_resnet56_step_is_ill_conditioned_in_f32(runs):
    api = runs[2]
    ds = api.dataset
    x = torch.from_numpy(np.ascontiguousarray(ds.train_x[0, :64]))
    y = torch.from_numpy(ds.train_y[0, :64]).long()
    perm = torch.from_numpy(np.random.default_rng(1).permutation(64))
    grads, losses = [], []
    for order in (torch.arange(64), perm):
        module = _bundle_for(api.config, ds).module
        module.load_state_dict(api.bundle.init(0, "cpu"))
        module.train()
        loss = F.cross_entropy(module(x[order]), y[order])
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in module.named_parameters()})
    rel = max(float((grads[0][k] - grads[1][k]).norm() / grads[1][k].norm()) for k in grads[0])
    print(f"\nrows permuted: loss {losses}, largest relative gradient change {rel:.3e}")
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    assert rel > 1e-3
