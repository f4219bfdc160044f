"""The captured local step's contract, on the CPU (``parallel/capture.py``;
on CPU tensors a step program runs its body eagerly, the same body that
CUDA captures).

- (a) A persistent optimizer after ``reset()`` gives bit-identical
  variables to a freshly bound one, for every client rule, over two
  clients back to back, plain and packed.
- (b) Across two clients and two rounds, every tensor a captured step
  reads or writes keeps its address: parameters, BN buffers, optimizer
  state and step counts, gradients, static inputs, FedProx's anchor.
- (c) On a packed cohort with a dead lane, the loss summed over a static
  live mask gives bit-identical variables to the sum over the live subset.
- (d) One and two rounds of FedAvg, FedProx and a clipped FedAvg through
  the step programs match the JAX API at tests/test_torch_algorithms.py's
  tolerances (variables rtol 1e-4 / atol 1e-5, losses rtol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedprox import FedProxAPI as JaxFedProxAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.fedprox import FedProxAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.optim import state_tensors
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel import packed
from fedml_tpu_torch.parallel.capture import CapturedStep
from fedml_tpu_torch.parallel.local import make_optimizer
from test_torch_algorithms import DATA, RUN, assert_vars_close, jax_orders

# client rules at the learning rates of tests/test_torch_algorithms.py
RULES = {"sgd": dict(client_optimizer="sgd", lr=0.05, momentum=0.9),
         "adam": dict(client_optimizer="adam", lr=0.01, momentum=0.0),
         "adamw": dict(client_optimizer="adamw", lr=0.01, momentum=0.0),
         "adagrad": dict(client_optimizer="adagrad", lr=0.02, momentum=0.0),
         "yogi": dict(client_optimizer="yogi", lr=0.01, momentum=0.0)}


def _bundle():
    return ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                       (8, 8, 3))


def _api(cls=FedAvgAPI, pack_lanes: int = 0, **extra):
    ds = make_synthetic_classification(**DATA)
    cfg = FedConfig(**{**RUN, "device_data": "on", "pack_lanes": pack_lanes, **extra})
    return cls(ds, cfg, _bundle(), device="cpu")


def _same(a: dict, b: dict, msg: str = "") -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{msg} {k}"


@pytest.mark.parametrize("lanes", [0, 2])
@pytest.mark.parametrize("rule", list(RULES))
def test_optimizer_reset_equals_a_fresh_bind(rule, lanes):
    torch.manual_seed(0)
    params = [torch.randn(4 * max(lanes, 1), 3, requires_grad=True),
              torch.randn(2 * max(lanes, 1), requires_grad=True)]
    cfg = RULES[rule]
    tx = make_optimizer(cfg["client_optimizer"], cfg["lr"], cfg["momentum"])
    opt = tx(params, lanes)
    addresses = [t.data_ptr() for t in opt.tensors()]
    for _ in range(3):
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step()
    opt.reset()
    fresh = tx([p.detach().clone() for p in params], lanes)
    assert [t.data_ptr() for t in opt.tensors()] == addresses
    for got, want in zip(opt.tensors(), fresh.tensors()):
        assert torch.equal(got, want)
    folded, counts = state_tensors(opt.state)
    assert all(int(c.abs().sum()) == 0 for c in counts)


@pytest.mark.parametrize("lanes", [0, 2])
@pytest.mark.parametrize("rule", list(RULES))
def test_persistent_trainer_matches_a_fresh_one(rule, lanes):
    """Round 1 trained by the trainer that trained round 0 (its optimizer
    reset for every client, its step programs reused) against round 1 from
    the same variables by a new API's trainer, bound at its first client."""
    used = _api(pack_lanes=lanes, **RULES[rule])
    if lanes:
        assert used.packed_status()["scheduled"]
    used.run_round(0)
    fresh = _api(pack_lanes=lanes, **RULES[rule])
    fresh.variables = {k: v.clone() for k, v in used.variables.items()}
    loss_used, loss_fresh = used.run_round(1), fresh.run_round(1)
    assert loss_used == loss_fresh
    _same(used.variables, fresh.variables, f"{rule}, lanes {lanes}")


def _addresses(api) -> dict:
    """Every tensor the step programs of ``api`` read or write, by role."""
    if api._packed_train is not None:
        (lanes,) = api._packed_train.lanes.values()
        module, opt, anchor, programs = lanes.module, lanes.opt, lanes.anchor, lanes.programs
    else:
        trainer = api._local_train
        module, programs = api.bundle.module, trainer.programs
        opt, anchor = trainer.bound["opt"], trainer.bound.get("anchor")
    (prog,) = programs.values()
    return {"module": [t.data_ptr() for t in module.state_dict().values()],
            "optimizer": [t.data_ptr() for t in opt.tensors()],
            "grads": [p.grad.data_ptr() for p in opt.params],
            "inputs": [t.data_ptr() for t in prog.inputs],
            "anchor": [t.data_ptr() for t in anchor]}


@pytest.mark.parametrize("lanes", [0, 2])
def test_step_tensors_keep_their_addresses(lanes):
    """The invariant a captured graph needs: what the step touches stays
    where it was, across clients and rounds (FedProx, so the anchor is
    there too)."""
    api = _api(FedProxAPI, pack_lanes=lanes, fedprox_mu=0.5, client_num_per_round=3)
    api.run_round(0)
    first = _addresses(api)
    assert all(first.values())
    api.run_round(1)
    assert _addresses(api) == first


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_masked_live_loss_equals_the_live_subset_sum(rule, monkeypatch):
    """3 members in 2 lanes: a lane runs dead steps. The static-mask sum
    and the sum over the live lanes alone give the same bits."""
    def run():
        api = _api(pack_lanes=2, client_num_per_round=3, **RULES[rule])
        plan = api._packed_plan(api.sample(0))
        assert plan.k_max == 2 and plan.live.min() == 0
        return api.run_round(0), api.variables

    loss_mask, vars_mask = run()
    monkeypatch.setattr(packed, "live_loss", lambda lane_loss, live: lane_loss[live > 0].sum())
    loss_subset, vars_subset = run()
    assert loss_mask == loss_subset
    _same(vars_mask, vars_subset)


def test_a_cpu_step_program_runs_its_body():
    calls = []
    x = torch.zeros(2)
    prog = CapturedStep(lambda t: calls.append(1) or t + 1, [x], lambda: [])
    assert not prog.captures
    assert torch.equal(prog(), torch.ones(2)) and torch.equal(prog(), torch.ones(2))
    assert len(calls) == 2 and prog.graph is None and prog.replays == 0


def test_capture_collects_cycles_first_and_keeps_the_collector_off(monkeypatch):
    """A dead trainer's graphs sit in reference cycles; one destroyed by
    the cyclic collector while a capture is under way invalidates that
    capture (seen on the H100 in a run of chip_smoke.py). ``_capture``
    collects the cycles before it begins and keeps the collector off until
    it ends; here with stand-ins for the CUDA stream and graph."""
    import contextlib
    import gc

    from fedml_tpu_torch.parallel import capture

    events, capturing = [], [False]

    class Dead:            # cyclic garbage that records when it is collected
        def __init__(self):
            self.me = self

        def __del__(self):
            events.append(("collected while capturing", capturing[0]))

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def instantiate(self):
            pass

    class GraphCapture:
        def __init__(self, graph, stream=None):
            pass

        def __enter__(self):
            capturing[0] = True
            events.append(("collector on while capturing", gc.isenabled()))

        def __exit__(self, *exc):
            capturing[0] = False

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(capture.torch.cuda, "Stream", Stream)
    monkeypatch.setattr(capture.torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(capture.torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(capture.torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(capture.torch.cuda, "graph", GraphCapture)
    was_on = gc.isenabled()
    Dead()
    x = torch.zeros(2)
    prog = CapturedStep(lambda t: t + 1, [x], lambda: [x])
    prog._capture()
    assert events == [("collected while capturing", False), ("collector on while capturing", False)]
    assert gc.isenabled() == was_on and torch.equal(prog.output, torch.ones(2))


CASES = {"fedavg": (FedAvgAPI, JaxFedAvgAPI, {}),
         "fedprox": (FedProxAPI, JaxFedProxAPI, dict(fedprox_mu=0.5)),
         "fedavg-clip": (FedAvgAPI, JaxFedAvgAPI, dict(grad_clip=0.5))}


@pytest.mark.parametrize("case", list(CASES))
def test_rounds_through_the_step_programs_match_jax(case):
    cls, jcls, extra = CASES[case]
    run = {**RUN, **extra}
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = jcls(jax_synthetic(**DATA), JaxFedConfig(**run, bucket_quantum_batches=0,
                                                    pack_lanes=0), jbundle)
    ds = make_synthetic_classification(**DATA)
    n_pad = ds.train_x.shape[1]
    api = cls(ds, FedConfig(**run), _bundle(), device="cpu",
              order_hook=lambda r, i: jax_orders(r, 2, n_pad)[i])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, f"{case} round {r}")
    (prog,) = api._local_train.programs.values()
    assert not prog.captures and prog.replays == 0
