"""The port's algorithm zoo (FedOpt, FedProx, FedNova, FedAGC) and client
optimizers against the JAX package.

- The exact-math properties of tests/test_algorithms.py, on the port's
  ``lr`` model at the same sizes: FedOpt(server sgd, lr 1) == FedAvg, the
  server momentum persists, FedProx(mu=0) == FedAvg and a large mu pins to
  the global model, FedNova == FedAvg under homogeneous tau and differs
  under heterogeneous tau, FedAGC == FedAvg when the clip never binds and a
  tight clip shrinks the update.
- One and two plain rounds of each algorithm, and of FedAvg with the client
  optimizers adam (amsgrad), adagrad and yogi, against the JAX API on a
  small CifarResNet with the fused BN, from the same variables and with the
  JAX package's per-client orders injected, as tests/test_torch_fedavg.py
  does: variables rtol 1e-4 / atol 1e-5, losses rtol 1e-5.
- ``unitwise_norm`` and ``agc_clip_update`` against the JAX functions on
  converted leaves (the port's unit axis is the first, flax's the last),
  and on a lane-folded state viewed per lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedagc import FedAGCAPI as JaxFedAGCAPI
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNovaAPI
from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.algorithms.fedprox import FedProxAPI as JaxFedProxAPI
from fedml_tpu.core import aggregation as jagg
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.algorithms.fedagc import FedAGCAPI
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
from fedml_tpu_torch.algorithms.fedprox import FedProxAPI
from fedml_tpu_torch.core import aggregation as agg
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel.local import make_local_train_fn

# -- exact-math properties on lr (tests/test_algorithms.py's sizes) ----------


def _ds(clients=6, dim=8, classes=3, seed=0, **kw):
    base = dict(records_per_client=12, partition_method="homo", batch_size=6, seed=seed)
    return make_synthetic_classification("algo", (dim,), classes, clients, **{**base, **kw})


def _cfg(ds, **kw):
    base = dict(model="lr", client_num_in_total=ds.num_clients,
                client_num_per_round=ds.num_clients, comm_round=3, epochs=1, batch_size=6,
                lr=0.2, seed=11, frequency_of_the_test=100)
    return FedConfig(**{**base, **kw})


def _run(cls, ds, cfg, **attrs):
    api = cls(ds, cfg, device="cpu")
    for k, v in attrs.items():
        setattr(api, k, v)
    api.train()
    return api


def _params(api):
    return split_params(api.variables)[0]


def _rel_diff(a, b):
    d = float(tree_global_norm(tree_sub(_params(a), _params(b))))
    return d / max(float(tree_global_norm(_params(b))), 1e-9)


def _move(api, w0):
    return float(tree_global_norm(tree_sub(_params(api), w0)))


def test_lr_model_is_the_default_and_matches_jax():
    ds = _ds()
    api = FedAvgAPI(ds, FedConfig(client_num_in_total=6, client_num_per_round=6), device="cpu")
    assert api.bundle.name == "lr" and set(api.variables) == {"linear.weight", "linear.bias"}
    jb = jax_create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
    jvars = jb.init(jax.random.key(0))
    api.variables = flax_to_torch(jax.tree.map(np.asarray, jvars))
    x = ds.test_x[:7]
    np.testing.assert_allclose(api.bundle.apply_eval(api.variables, torch.tensor(x)).numpy(),
                               np.asarray(jb.apply_eval(jvars, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_fedopt_server_sgd_lr1_equals_fedavg():
    ds = _ds()
    avg = _run(FedAvgAPI, ds, _cfg(ds))
    opt = _run(FedOptAPI, ds, _cfg(ds, server_optimizer="sgd", server_lr=1.0))
    assert _rel_diff(opt, avg) < 1e-6


def test_fedopt_server_momentum_state_persists():
    ds = _ds()
    api = _run(FedOptAPI, ds, _cfg(ds, server_optimizer="sgd", server_lr=1.0,
                                   server_momentum=0.9))
    trace = api.server_state["opt"][0]["trace"]
    assert float(torch.sqrt(sum(t.square().sum() for t in trace))) > 0


def test_fedadam_runs():
    ds = _ds()
    api = FedOptAPI(ds, _cfg(ds, server_optimizer="adam", server_lr=0.01), device="cpu")
    hist = api.train()
    assert np.isfinite(hist["Test/Loss"][-1])
    assert int(api.server_state["opt"][0]["count"]) == 3


def test_fedprox_mu_zero_equals_fedavg():
    ds = _ds()
    avg = _run(FedAvgAPI, ds, _cfg(ds))
    prox = _run(FedProxAPI, ds, _cfg(ds, fedprox_mu=0.0))
    assert _rel_diff(prox, avg) < 1e-6


def test_fedprox_large_mu_pins_to_global():
    ds = _ds()
    avg = FedAvgAPI(ds, _cfg(ds, comm_round=1), device="cpu")
    w0 = {k: v.clone() for k, v in _params(avg).items()}
    avg.train()
    prox = _run(FedProxAPI, ds, _cfg(ds, comm_round=1, fedprox_mu=2.0))
    assert _move(prox, w0) < _move(avg, w0)


def test_fednova_homogeneous_tau_equals_fedavg():
    ds = _ds()
    avg = _run(FedAvgAPI, ds, _cfg(ds))
    nova = _run(FedNovaAPI, ds, _cfg(ds))
    assert _rel_diff(nova, avg) < 1e-5


def test_fednova_heterogeneous_sizes_run():
    ds = _ds(records_per_client=20, partition_method="hetero", partition_alpha=0.3,
             batch_size=4, seed=2)
    hist = FedNovaAPI(ds, _cfg(ds, batch_size=4), device="cpu").train()
    assert np.isfinite(hist["Test/Loss"][-1])


def test_fednova_differs_from_fedavg_under_hetero_tau():
    ds = _ds(clients=4, records_per_client=24, partition_method="hetero", partition_alpha=0.2,
             batch_size=4, seed=5)
    assert ds.train_counts.max() > ds.train_counts.min()
    cfg = _cfg(ds, batch_size=4, comm_round=1)
    assert _rel_diff(_run(FedNovaAPI, ds, cfg), _run(FedAvgAPI, ds, cfg)) > 1e-6


def test_fedagc_loose_clip_equals_fedavg():
    ds = _ds()
    avg = _run(FedAvgAPI, ds, _cfg(ds))
    agc = _run(FedAGCAPI, ds, _cfg(ds), clipping=1e6)       # never binds
    assert _rel_diff(agc, avg) < 1e-6


def test_fedagc_tight_clip_shrinks_update():
    ds = _ds()
    avg = FedAvgAPI(ds, _cfg(ds, comm_round=1), device="cpu")
    w0 = {k: v.clone() for k, v in _params(avg).items()}
    avg.train()
    agc = _run(FedAGCAPI, ds, _cfg(ds, comm_round=1), clipping=1e-4)
    assert _move(agc, w0) < _move(avg, w0)


def test_local_step_count_respects_real_records():
    """A 4-record client at batch 4 takes exactly one step an epoch."""
    ds = _ds(clients=2, records_per_client=4, batch_size=4)
    bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
    lt = make_local_train_fn(bundle, get_task("classification"), lr=0.1, epochs=2, batch_size=4)
    v = bundle.init(0, device="cpu")
    res = lt(v, torch.tensor(ds.train_x[0]), torch.tensor(ds.train_y[0]),
             torch.tensor(ds.train_mask[0]), int(ds.train_counts[0]),
             generator=torch.Generator().manual_seed(0))
    assert res.tau == 2 * int(np.ceil(ds.train_counts[0] / 4))


def test_zero_weight_round_keeps_weights_and_server_state():
    """A round whose cohort holds no records changes nothing: not the
    weights, not FedOpt's server state."""
    ds = _ds()
    ds.train_counts[:] = 0
    ds.train_mask[:] = 0
    api = FedOptAPI(ds, _cfg(ds, server_optimizer="adam", server_lr=0.1, comm_round=1),
                    device="cpu")
    before = {k: v.clone() for k, v in api.variables.items()}
    state = api.server_state
    api.run_round(0)
    assert all(torch.equal(api.variables[k], v) for k, v in before.items())
    assert api.server_state is state and int(state["opt"][0]["count"]) == 0


# -- plain rounds against the JAX API on a small CifarResNet ------------------

SEED = 0
EPOCHS = 2
DATA = dict(name="zoo-parity", input_shape=(8, 8, 3), classes=10, num_clients=4,
            records_per_client=16, test_records=40, partition_method="hetero",
            partition_alpha=0.5, batch_size=8, seed=SEED)
RUN = dict(model="cifar-small", dataset="zoo-parity", client_num_in_total=4,
           client_num_per_round=2, comm_round=2, batch_size=8, epochs=EPOCHS, lr=0.05,
           momentum=0.9, frequency_of_the_test=1, seed=SEED, device_data="off")
CASES = {
    "fedopt-adam": ("FedOptAPI", dict(server_optimizer="adam", server_lr=0.01)),
    "fedavgm": ("FedOptAPI", dict(server_optimizer="sgd", server_lr=1.0, server_momentum=0.9)),
    "fedopt-yogi": ("FedOptAPI", dict(server_optimizer="yogi", server_lr=0.01)),
    "fedprox": ("FedProxAPI", dict(fedprox_mu=0.5)),
    "fednova": ("FedNovaAPI", {}),
    "fedagc": ("FedAGCAPI", {}),
    "client-adam": ("FedAvgAPI", dict(client_optimizer="adam", lr=0.01, momentum=0.0)),
    "client-adagrad": ("FedAvgAPI", dict(client_optimizer="adagrad", lr=0.02, momentum=0.0)),
    "client-yogi": ("FedAvgAPI", dict(client_optimizer="yogi", lr=0.01, momentum=0.0,
                                      wd=1e-3)),
}
PORT = {c.__name__: c for c in (FedAvgAPI, FedOptAPI, FedProxAPI, FedNovaAPI, FedAGCAPI)}
JAX = {"FedAvgAPI": JaxFedAvgAPI, "FedOptAPI": JaxFedOptAPI, "FedProxAPI": JaxFedProxAPI,
       "FedNovaAPI": JaxFedNovaAPI, "FedAGCAPI": JaxFedAGCAPI}


def jax_orders(round_idx: int, cohort: int, n_pad: int):
    """The JAX package's per-client, per-epoch permutations of a round."""
    rk = jax.random.fold_in(jax.random.key(SEED), round_idx)
    return [[torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
             for ek in jax.random.split(ck, EPOCHS)]
            for ck in jax.random.split(rk, cohort)]


def assert_vars_close(got: dict, want_flax: dict, msg=""):
    got = torch_to_flax(got, bn_name="PallasBatchNorm")
    want = jax.tree.map(np.asarray, want_flax)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=f"{msg} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_one_and_two_rounds_match_jax(case):
    algo, extra = CASES[case]
    run = {**RUN, **extra}
    jds = jax_synthetic(**DATA)
    jbundle = JaxModelBundle(
        name="cifar-small", module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
        input_shape=(8, 8, 3), has_batch_stats=True)
    japi = JAX[algo](jds, JaxFedConfig(**run, bucket_quantum_batches=0, pack_lanes=0), jbundle)
    ds = make_synthetic_classification(**DATA)
    n_pad = ds.train_x.shape[1]
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                         (8, 8, 3))
    api = PORT[algo](ds, FedConfig(**run), bundle, device="cpu",
                     order_hook=lambda r, i: jax_orders(r, 2, n_pad)[i])
    api.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    for r in range(2):
        np.testing.assert_allclose(api.run_round(r), japi.run_round(r), rtol=1e-5)
        assert_vars_close(api.variables, japi.variables, f"round {r}")
    ev_j, ev_t = japi.evaluate_global(), api.evaluate_global()
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)


# -- unit-wise norm and the AGC clip ------------------------------------------


def _flax_tree(rng, scale=1.0):
    return {"params": {
        "Conv_0": {"kernel": (rng.normal(size=(3, 3, 4, 6)) * scale).astype(np.float32)},
        "PallasBatchNorm_0": {"scale": (1 + rng.normal(size=6) * scale).astype(np.float32),
                              "bias": (rng.normal(size=6) * scale).astype(np.float32)},
        "Dense_0": {"kernel": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
                    "bias": (rng.normal(size=5) * scale).astype(np.float32)}}}


def _perturbed(g, rng, scale):
    return jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * scale).astype(np.float32), g)


def test_unitwise_norm_matches_jax_on_converted_leaves():
    rng = np.random.default_rng(0)
    tree = _flax_tree(rng)
    port = flax_to_torch(tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(p.key for p in path[1:]).replace("kernel", "weight")
        want = np.asarray(jagg.unitwise_norm(jnp.asarray(leaf)))
        got = agg.unitwise_norm(port[name]).numpy()
        # the unit axis is flax's last and the port's first: same values
        np.testing.assert_allclose(np.sort(got.reshape(-1)), np.sort(want.reshape(-1)),
                                   rtol=1e-6, err_msg=name)
        if leaf.ndim >= 2:
            np.testing.assert_allclose(got.reshape(-1), want.reshape(-1), rtol=1e-6)


@pytest.mark.parametrize("clipping,scale", [(1e-2, 0.05), (1e-1, 0.05), (1e2, 0.05),
                                            (1e-2, 1e-5)])
def test_agc_clip_update_matches_jax(clipping, scale):
    rng = np.random.default_rng(1)
    g = _flax_tree(rng)
    local = _perturbed(g, rng, scale)
    want = jagg.agc_clip_update(jax.tree.map(jnp.asarray, g["params"]),
                                jax.tree.map(jnp.asarray, local["params"]), clipping)
    got = agg.agc_clip_update(flax_to_torch(g), flax_to_torch(local), clipping)
    want_t = flax_to_torch({"params": jax.tree.map(np.asarray, want)})
    for k, v in want_t.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_agc_on_a_lane_folded_state_is_per_lane():
    """Two lanes folded into the leading axis (the packed twin's layout):
    a conv weight [L*Co, ...] keeps one norm per output unit, and a vector
    [L*C] viewed as [L, C] has one norm per lane, not one across lanes.
    The packed round clips a member through this per-lane view; it equals
    JAX's clip of each lane on its own."""
    L = 2
    rng = np.random.default_rng(2)
    g = _flax_tree(rng)
    locals_ = [_perturbed(g, rng, s) for s in (0.05, 0.5)]
    gt = flax_to_torch(g)
    lanes = [flax_to_torch(loc) for loc in locals_]
    folded = {k: torch.cat([lane[k] for lane in lanes]) for k in gt}
    conv = folded["Conv_0.weight"]
    np.testing.assert_allclose(
        agg.unitwise_norm(conv).reshape(L, -1).numpy(),
        np.stack([agg.unitwise_norm(lane["Conv_0.weight"]).reshape(-1).numpy()
                  for lane in lanes]), rtol=1e-6)
    vec = folded["Dense_0.bias"].view(L, -1)
    per_lane = agg.unitwise_norm(vec, batch_dims=1).reshape(-1).numpy()
    want = [float(jagg.unitwise_norm(jnp.asarray(loc["params"]["Dense_0"]["bias"])))
            for loc in locals_]
    np.testing.assert_allclose(per_lane, want, rtol=1e-6)
    assert not np.allclose(per_lane, float(agg.unitwise_norm(folded["Dense_0.bias"])))
    stacked = {k: v.view(L, *gt[k].shape) for k, v in folded.items()}
    got = agg.agc_clip_update(gt, stacked, 1e-2, batch_dims=1)
    for lane, loc in enumerate(locals_):
        want = jagg.agc_clip_update(jax.tree.map(jnp.asarray, g["params"]),
                                    jax.tree.map(jnp.asarray, loc["params"]), 1e-2)
        want_t = flax_to_torch({"params": jax.tree.map(np.asarray, want)})
        for k, v in want_t.items():
            np.testing.assert_allclose(got[k][lane].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"lane {lane} {k}")


def test_is_weight_path_excludes_bn_statistics():
    assert agg.is_weight_path("Conv_0.weight") and agg.is_weight_path("PallasBatchNorm_0.scale")
    assert not agg.is_weight_path("PallasBatchNorm_0.mean")
    assert not agg.is_weight_path("BasicBlock_0.BatchNorm_1.var")
    assert agg.is_weight_path("mean_head.weight")


def test_pytree_helpers_match_jax():
    """The leafwise helpers against the JAX package's on the same leaves;
    ``split_params`` is the port's counterpart of the params/batch_stats
    collections."""
    from fedml_tpu.core import pytree as jpt
    from fedml_tpu_torch.core import pytree as pt

    rng = np.random.default_rng(3)
    a, b = _flax_tree(rng), _flax_tree(rng)
    a["batch_stats"] = {"PallasBatchNorm_0": {"mean": rng.normal(size=6).astype(np.float32),
                                              "var": rng.random(6).astype(np.float32)}}
    ta, tb = flax_to_torch(a), flax_to_torch({"params": b["params"]})
    params, buffers = pt.split_params(ta)
    assert set(buffers) == {"PallasBatchNorm_0.mean", "PallasBatchNorm_0.var"}
    assert set(params) == set(tb) and list(params) == [k for k in ta if k not in buffers]
    ja, jb = (jax.tree.map(jnp.asarray, t["params"]) for t in (a, b))
    for got, want in ((pt.tree_add(params, tb), jpt.tree_add(ja, jb)),
                      (pt.tree_sub(params, tb), jpt.tree_sub(ja, jb)),
                      (pt.tree_scale(params, 0.3), jpt.tree_scale(ja, 0.3)),
                      (pt.tree_zeros_like(params), jpt.tree_zeros_like(ja))):
        want = flax_to_torch({"params": jax.tree.map(np.asarray, want)})
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(pt.tree_dot(params, tb)), float(jpt.tree_dot(ja, jb)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pt.tree_global_norm(params)),
                               float(jpt.tree_global_norm(ja)), rtol=1e-6)
    nested = pt.tree_add({"pd": tb, "na": torch.tensor(1.0)}, {"pd": tb, "na": torch.tensor(2.0)})
    assert float(nested["na"]) == 3.0 and torch.equal(nested["pd"]["Dense_0.bias"],
                                                      2 * tb["Dense_0.bias"])
