"""The port's client-packing schedule against the JAX package's, and
against the port's own plain round.

- The numpy plan (``plan_packing``, ``plan_arrays_tuple``,
  ``mask_plan_arrays``) is bit-equal to the JAX functions.
- ``stack_variables``/``unstack_variables`` round-trip bit for bit.
- The lane-stacked small CifarResNet (lanes folded into the channel axis)
  equals L separate calls of the plain model, forward, backward and
  BatchNorm statistics, at tests/test_torch_resnet.py's tolerances.
- A packed port round equals the plain port round on the same orders (the
  replay gate), and one and two packed rounds equal the JAX packed round
  (``vmap`` of the lane program over the Pallas BN kernel in interpret mode)
  with JAX's orders injected as in tests/test_torch_fedavg.py: variables
  rtol 1e-4 / atol 1e-5, losses and eval metrics rtol 1e-5.
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
from fedml_tpu.parallel import packed as jax_packed
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.tasks import classification_loss
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.ops import batchnorm as bn_ops
from fedml_tpu_torch.ops.packed_conv import stack_variables, unstack_variables
from fedml_tpu_torch.parallel import local
from fedml_tpu_torch.parallel import packed

SEED = 0
EPOCHS = 2
DATA = dict(name="packed-parity", input_shape=(8, 8, 3), classes=10, num_clients=4,
            records_per_client=16, test_records=40, partition_method="hetero",
            partition_alpha=0.5, batch_size=8, seed=SEED)
RUN = dict(model="cifar-small", dataset="packed-parity", client_num_in_total=4,
           client_num_per_round=3, comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05,
           momentum=0.9, frequency_of_the_test=1, seed=SEED, device_data="on", pack_lanes=2)
# 3 clients over 2 lanes: one lane trains two clients back to back, and the
# lanes' loads differ (hetero counts), so a lane runs dead steps. HARD adds
# weight decay and a clip that binds, so the dead-step freeze and the
# per-lane clip matter.
HARD = dict(wd=5e-3, grad_clip=0.5)
PLAN_FIELDS = ("n_lanes", "k_max", "T", "epochs", "slot", "epoch", "sie", "reset", "emit",
               "live", "member_pos", "member_valid", "steps_real")


def _small(bn_impl="pallas", n_lanes=0):
    return CifarResNet(1, 10, widths=(8, 16, 16), bn_impl=bn_impl, n_lanes=n_lanes)


def _bundle(bn_impl="pallas"):
    return ModelBundle("cifar-small", _small(bn_impl), (8, 8, 3))


def _jax_orders(round_idx: int, cohort: int, n_pad: int):
    rk = jax.random.fold_in(jax.random.key(SEED), round_idx)
    return [[torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
             for ek in jax.random.split(ck, EPOCHS)]
            for ck in jax.random.split(rk, cohort)]


def _assert_same_plan(got, want):
    for f in PLAN_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _assert_same_executed_plan(got, want):
    """The port plans without JAX's t_quantum (the all-dead steps it adds
    bucket jit shapes; the port skips them): the same plan over the steps
    where some lane is live."""
    steps = packed.executed_steps(want.live)
    np.testing.assert_array_equal(packed.executed_steps(got.live), steps)
    assert got.T == len(steps) and (got.n_lanes, got.k_max) == (want.n_lanes, want.k_max)
    for f in ("slot", "epoch", "sie", "reset", "emit", "live"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f)[:, steps], err_msg=f)
    for f in ("member_pos", "member_valid", "steps_real"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("counts,bs,epochs,n_lanes,t_quantum", [
    ([37, 5, 80, 16, 3, 64, 22, 9], 8, 3, 3, 1),
    ([37, 5, 80, 16, 3, 64, 22, 9], 8, 1, 2, 2),
    ([1562, 3, 800, 0, 64, 1000, 127, 128], 64, 1, 2, 2),   # a zero-count client
    ([12, 40], 8, 2, 5, 1),                                   # more lanes than members
    ([7], 4, 3, 2, 2),
    ([16, 16, 16, 16], 8, 2, 4, 2),                           # equal loads
    ([0, 0], 8, 1, 2, 1),                                     # nothing to train: None
])
def test_plan_is_bit_equal(counts, bs, epochs, n_lanes, t_quantum):
    want = jax_packed.plan_packing(np.array(counts), bs, epochs, n_lanes, t_quantum)
    got = packed.plan_packing(np.array(counts), bs, epochs, n_lanes, t_quantum)
    if want is None:
        assert got is None
        return
    _assert_same_plan(got, want)
    assert got.shape_key == want.shape_key and got.executed_slots == want.executed_slots
    for a, b in zip(packed.plan_arrays_tuple(got), jax_packed.plan_arrays_tuple(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    active = np.random.default_rng(len(counts) + epochs).integers(
        0, 2, size=want.member_pos.shape).astype(np.float32)
    for a, b in zip(packed.mask_plan_arrays(got, active),
                    jax_packed.mask_plan_arrays(want, active)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the port skips only steps where no lane is live
    steps = packed.executed_steps(got.live)
    assert got.live[:, steps].max(0).min() == 1.0 and got.live.sum() == got.live[:, steps].sum()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stack_unstack_round_trip_is_bit_exact(k):
    variables = create_model("resnet20", 10, bn_impl="pallas").init(0, device="cpu")
    stacked = stack_variables(variables, k)
    model = create_model("resnet20", 10, bn_impl="pallas").module.lane_stacked(k)
    model.load_state_dict(stacked, strict=True)      # the twin's layout, leaf for leaf
    for lane in range(k):
        back = unstack_variables(model.state_dict(), lane, k)
        assert back.keys() == variables.keys()
        for name, v in variables.items():
            assert back[name].dtype == v.dtype and torch.equal(back[name], v), name
    # distinct lanes fold at l * n0 of the leading axis
    lanes = [create_model("resnet20", 10).init(s, device="cpu") for s in range(k)]
    folded = {n: torch.cat([v[n] for v in lanes]) for n in lanes[0]}
    for lane in range(k):
        assert all(torch.equal(unstack_variables(folded, lane, k)[n], lanes[lane][n])
                   for n in folded)


@pytest.mark.parametrize("bn_impl", ["pallas", "xla"])
def test_lane_stacked_resnet_matches_separate_models(bn_impl):
    """L = 3 lanes of different weights and masks: the twin's train-mode
    logits, per-lane losses, per-lane gradients and running statistics, and
    its eval logits, against the plain model run lane by lane."""
    L = 3
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(L, 8, 16, 16, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, size=(L, 8)).astype(np.int64))
    m = torch.tensor(np.array([[1] * 8, [1] * 6 + [0] * 2, [1] * 3 + [0] * 5], np.float32))
    plain, logits_p, losses_p = [], [], []
    for lane in range(L):
        model = _small(bn_impl)
        model.reset_parameters(torch.Generator().manual_seed(10 + lane))
        plain.append(model)
    twin = plain[0].lane_stacked(L)
    twin.load_state_dict({k: torch.cat([p.state_dict()[k] for p in plain])
                          for k in plain[0].state_dict()})
    for lane, model in enumerate(plain):
        model.train()
        logits_p.append(model(x[lane]))
        losses_p.append(classification_loss(logits_p[-1], y[lane], m[lane]))
        losses_p[-1].backward()
    twin.train()
    logits = twin(x)
    assert logits.shape == (L, 8, 10)
    losses = torch.stack([classification_loss(logits[lane], y[lane], m[lane])
                          for lane in range(L)])
    losses.sum().backward()        # each lane's gradient is its own
    grads = {k: p.grad for k, p in twin.named_parameters()}
    for lane, model in enumerate(plain):
        np.testing.assert_allclose(logits[lane].detach().numpy(), logits_p[lane].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(losses[lane].detach()), float(losses_p[lane].detach()),
                                   rtol=1e-5)
        lane_grads = unstack_variables(grads, lane, L)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(lane_grads[k].numpy(), p.grad.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        lane_state = unstack_variables(twin.state_dict(), lane, L)
        for k, b in model.named_buffers():
            np.testing.assert_allclose(lane_state[k].numpy(), b.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    twin.eval()
    with torch.no_grad():
        out = twin(x)
        for lane, model in enumerate(plain):
            model.eval()
            np.testing.assert_allclose(out[lane].numpy(), model(x[lane]).numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_resnet56_packed_step_is_one_bn_call_per_layer_over_all_lanes(monkeypatch):
    """Each of ResNet-56's 57 train-mode BNs is one fused call over
    [rows, L*C] (on the card: one K1 and one K2 launch for all lanes)."""
    seen = []
    fwd, bwd = bn_ops.bn_relu_fwd_plain, bn_ops.bn_relu_bwd_plain
    monkeypatch.setattr(bn_ops, "bn_relu_fwd_plain",
                        lambda x, *a: seen.append(("fwd", tuple(x.shape))) or fwd(x, *a))
    monkeypatch.setattr(bn_ops, "bn_relu_bwd_plain",
                        lambda x, *a: seen.append(("bwd", tuple(x.shape))) or bwd(x, *a))
    model = create_model("resnet56", 10, bn_impl="pallas").module.lane_stacked(2)
    model(torch.zeros(2, 2, 32, 32, 3)).square().sum().backward()
    for kind in ("fwd", "bwd"):
        shapes = [s for k, s in seen if k == kind]
        assert len(shapes) == 57
        assert set(shapes) == {(2048, 32), (512, 64), (128, 128)}


def _port(bundle_impl="pallas", order_hook=None, **kw):
    ds = make_synthetic_classification(**DATA)
    return FedAvgAPI(ds, FedConfig(**{**RUN, **kw}), _bundle(bundle_impl), device="cpu",
                     order_hook=order_hook)


@pytest.mark.parametrize("extra", [{}, HARD], ids=["sgd", "decay-clip"])
def test_packed_round_replays_the_plain_round(extra):
    plain, pk = _port(pack_lanes=0, **extra), _port(**extra)
    pk.variables = {k: v.clone() for k, v in plain.variables.items()}
    assert pk.packed_status() == {"scheduled": True, "packed_conv_active": False,
                                  "reason": "packed_conv=off"}
    plan = pk._packed_plan(pk.sample(0))
    assert plan.n_lanes == 2 and plan.live.min() == 0.0     # a lane has dead steps
    for r in range(2):
        np.testing.assert_allclose(pk.run_round(r), plain.run_round(r), rtol=1e-5)
        for k, v in plain.variables.items():
            np.testing.assert_allclose(pk.variables[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert pk.round_counts(0)[0] == plain.round_counts(0)[0]


def test_dead_steps_freeze_the_lane():
    """After its last client the shorter lane runs dead steps; its
    parameters, momentum and BN statistics stay as that client left them
    (weight decay and momentum would move them otherwise)."""
    api = _port(**HARD)
    plan = api._packed_plan(api.sample(0))
    lane = int(np.argmin(plan.live.sum(1)))
    assert plan.live[lane].min() == 0.0
    k = int(plan.slot[lane, np.nonzero(plan.emit[lane])[0][-1]])
    pos = int(plan.member_pos[lane, k])
    start = {n: v.clone() for n, v in api.variables.items()}
    api.run_round(0)
    lanes = api._packed_train.lanes[plan.n_lanes]
    got = unstack_variables(lanes.module.state_dict(), lane, plan.n_lanes)
    c = api.config
    bundle = _bundle()
    train = local.make_local_train_fn(bundle, api.task, lr=c.lr, momentum=c.momentum, wd=c.wd,
                                      epochs=c.epochs, batch_size=c.batch_size,
                                      grad_clip=c.grad_clip)
    tx, ty, tm = api._dev_train
    row = int(api.sample(0)[pos])
    ref = train(start, tx[row], ty[row], tm[row], int(api.dataset.train_counts[row]),
                orders=list(api._round_orders(0, len(api.sample(0)))[pos]))
    for n, v in ref.variables.items():
        np.testing.assert_allclose(got[n].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=n)


def test_device_data_off_runs_the_plain_round(caplog):
    with caplog.at_level("WARNING"):
        off = _port(device_data="off")
    assert "device_data='off'" in caplog.text
    assert off.packed_status()["scheduled"] is False
    plain = _port(pack_lanes=0, device_data="off")
    off.variables = {k: v.clone() for k, v in plain.variables.items()}
    assert off.run_round(0) == plain.run_round(0)
    assert all(torch.equal(off.variables[k], v) for k, v in plain.variables.items())


@pytest.mark.parametrize("field,value", [("packed_conv", "blockdiag"),
                                         ("packed_conv", "auto")])
def test_joint_lowerings_raise(field, value):
    with pytest.raises(NotImplementedError):
        _port(**{field: value})


def test_lanes_conv_has_no_lane_stacked_twin():
    with pytest.raises(NotImplementedError):
        create_model("resnet20", 10, conv_impl="lanes").module.lane_stacked(2)


@pytest.fixture(scope="module", params=[{}, HARD], ids=["sgd", "decay-clip"])
def apis(request):
    extra = request.param
    jds = jax_synthetic(**DATA)
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**RUN, **extra), jbundle)
    n_pad = jds.train_x.shape[1]
    api = _port(order_hook=lambda r, i: _jax_orders(r, 3, n_pad)[i], **extra)
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    return japi, api


def test_one_and_two_packed_rounds_match_jax(apis):
    japi, api = apis
    assert api.packed_status() == japi.packed_status()
    for r in range(2):
        np.testing.assert_array_equal(api.sample(r), jax_sample_clients(r, 4, 3, SEED))
        _assert_same_executed_plan(api._packed_plan(api.sample(r)),
                                   japi._packed_plan(api.sample(r)))
        assert api.round_counts(r)[0] == japi.round_counts(r)[0]
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        got = torch_to_flax(api.variables, bn_name="PallasBatchNorm")
        want = jax.tree.map(np.asarray, japi.variables)
        la, ta = jax.tree_util.tree_flatten_with_path(want)
        lb, tb = jax.tree_util.tree_flatten_with_path(got)
        assert ta == tb
        for (path, a), (_, b) in zip(la, lb):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=f"round {r} {path}")
    ev_j, ev_t = japi.evaluate_global(), api.evaluate_global()
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(ev_t["acc"], ev_j["acc"], rtol=1e-5)


def test_packed_rounds_track_the_jax_plain_round():
    """6 clients, 3 a round: cohorts in which a lane trains two clients in
    both rounds (k_max 2). On this cohort the two JAX rounds, packed and
    plain, part by 4.05x this tolerance in round 1 (BasicBlock_2/Conv_1,
    4.0e-5 absolute): float-order sensitivity of a 2-round comparison at
    atol 1e-5 (ROADMAP.md §3), which the 4-client data of
    test_one_and_two_packed_rounds_match_jax does not show. The port's
    packed round is held here against the JAX plain round, the schedule's
    replay target, over both rounds."""
    data = {**DATA, "num_clients": 6}
    run = {**RUN, "client_num_in_total": 6}
    jds = jax_synthetic(**data)
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**{**run, "pack_lanes": 0,
                                             "bucket_quantum_batches": 0}), jbundle)
    n_pad = jds.train_x.shape[1]
    api = FedAvgAPI(make_synthetic_classification(**data), FedConfig(**run), _bundle(),
                    device="cpu", order_hook=lambda r, i: _jax_orders(r, 3, n_pad)[i])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    for r in range(2):
        assert api._packed_plan(api.sample(r)).k_max == 2
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        want = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
        for k, v in want.items():
            np.testing.assert_allclose(api.variables[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"round {r} {k}")
