"""The port's data parallelism with synchronized BatchNorm against the
JAX package's (``fedml_tpu/parallel/dataparallel.py``): the data-parallel
step, ``bn_axis`` sync-BN, ``StreamingCentralizedTrainer(mesh=...)`` and
``FedGKTAPI(server_mesh=...)``.

Several ranks run as spawned gloo processes (``tests/torch_mesh_ranks.py``);
each holds its rows of the global batch. Tolerances are the JAX tests'
(``tests/test_dataparallel.py``): the DP step's loss at rtol 1e-5 and every
variable (parameters and BN statistics) at rtol 2e-4 / atol 1e-5 against
JAX's single-device full-batch step; ``bn_axis`` statistics at rtol 1e-4 /
atol 1e-6 against the global batch's (what JAX's ``shard_map`` sync-BN
gives); the streaming trainer's accuracy at rtol 1e-5 and loss at 1e-4; the
GKT server's variables at rtol 2e-4 / atol 1e-5. ``bn_impl="pallas"`` at
more than one rank gathers the batch and runs the kernel BN (its plain
version on CPU tensors) on all of it.

Ranks may hold different numbers of real rows: the padded DP cases give the
last ranks nothing but padding, and the GKT server's last batch of an epoch
(32 records in batches of 6) leaves rank 1 only padding, as ``real_first``
orders it. Under sync-BN the backward crosses ranks, so only the gradient
of the global mean itself matches JAX there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from fedml_tpu.algorithms.centralized import StreamingCentralizedTrainer as JaxStreaming
from fedml_tpu.algorithms.fedgkt import FedGKTAPI as JaxFedGKTAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.tasks import get_task as jax_get_task
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.parallel.local import make_optimizer as jax_make_optimizer
from fedml_tpu_torch.algorithms.centralized import StreamingCentralizedTrainer
from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.gkt import create_gkt_pair
from fedml_tpu_torch.parallel.dataparallel import (batch_mesh, make_dp_eval_fn,
                                                   make_dp_train_step, place_batch)
from fedml_tpu_torch.parallel.local import make_optimizer
from test_torch_fedgkt import DATA, RUN, _hooks, _jax_round, _load_from_jax

BN = {"xla": None, "pallas": "PallasBatchNorm"}
DP_CASES = [(2, "xla"), (4, "xla"), (2, "pallas")]
#: the padded cases: the first half of the batch real, so rank 1 of 2 and
#: ranks 2, 3 of 4 hold padding only
PAD_CASES = [(2, "xla"), (4, "pallas")]
MASKS = {"full": np.ones((16,), np.float32),
         "half": np.repeat(np.float32([1, 0]), 8)}
#: tests/test_torch_fedgkt.py's data in batches of 6: the server's last
#: batch of an epoch holds 32 % 6 = 2 real rows, all on rank 0 of 2
GKT_DATA = dict(DATA, batch_size=6)
GKT_RUN = dict(RUN, batch_size=6)
STREAM_DATA = dict(name="cen-dp", input_shape=(10,), classes=4, num_clients=4,
                   records_per_client=32, partition_method="homo", batch_size=16, seed=0)
STREAM_RUN = dict(model="lr", dataset="cen-dp", client_num_in_total=4, client_num_per_round=4,
                  comm_round=3, batch_size=16, epochs=1, lr=0.2, seed=9,
                  frequency_of_the_test=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _setup(n: int = 16, seed: int = 0):
    """tests/test_dataparallel.py's ``_setup``: resnet20 on 8x8x3, SGD 0.1
    with momentum 0.9, a batch of n."""
    bundle = jax_create_model("resnet20", 10, input_shape=(8, 8, 3))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    m = MASKS["full"]
    variables = jax.tree.map(np.asarray, bundle.init(jax.random.key(seed)))
    return bundle, variables, x, y, m


def _init(bn_impl: str) -> dict:
    return {k: v.numpy() for k, v in flax_to_torch(_setup()[1], bn_name=BN[bn_impl]).items()}


@functools.lru_cache(maxsize=None)
def _jax_step_fn():
    """JAX's single-device full-batch step, jitted once, the mask its
    argument."""
    bundle, _, x, y, _ = _setup()
    task = jax_get_task("classification", 10)
    tx = jax_make_optimizer("sgd", 0.1, momentum=0.9)

    def single(variables, m):
        def loss_fn(p):
            v = dict(variables)
            v["params"] = p
            logits, nv = bundle.apply_train(v, jnp.asarray(x), jax.random.key(42))
            return task.loss(logits, jnp.asarray(y), m), nv

        (loss, nv), g = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        ups, _ = tx.update(g, tx.init(variables["params"]), variables["params"])
        nv = dict(nv)
        nv["params"] = optax.apply_updates(variables["params"], ups)
        return nv, loss

    return jax.jit(single)


@functools.lru_cache(maxsize=None)
def _jax_single_step(mask: str) -> tuple:
    nv, loss = _jax_step_fn()(_setup()[1], jnp.asarray(MASKS[mask]))
    return float(loss), jax.tree.map(np.asarray, nv)


def _single_step(bn_impl: str, mask: str = "full") -> tuple:
    loss, nv = _jax_single_step(mask)
    return loss, flax_to_torch(nv, bn_name=BN[bn_impl])


@functools.lru_cache(maxsize=None)
def _global_batch_stats() -> dict:
    """The BN statistics after one train-mode pass over the global batch:
    what JAX's shard_map sync-BN gives (test_bn_axis_shard_map_syncs_stats)."""
    bundle, variables, _, _, _ = _setup()
    x = np.random.default_rng(1).normal(size=(16, 8, 8, 3)).astype(np.float32)
    _, nv = bundle.apply_train(variables, jnp.asarray(x), jax.random.key(7))
    return x, flax_to_torch({"batch_stats": jax.tree.map(np.asarray, nv["batch_stats"])})


@functools.lru_cache(maxsize=None)
def _gkt_setup():
    """JAX's GKT API before round 0, its orders, and the port's state
    loaded from it (numpy), at tests/test_torch_fedgkt.py's sizes."""
    jds = jax_synthetic(**GKT_DATA)
    japi = JaxFedGKTAPI(jds, JaxFedConfig(**GKT_RUN), client_blocks=1, server_blocks_per_stage=1)
    clients, server = _hooks(japi)
    api = FedGKTAPI(make_synthetic_classification(**GKT_DATA), FedConfig(**GKT_RUN),
                    create_gkt_pair(3, (8, 8, 3), client_blocks=1, server_blocks_per_stage=1,
                                    bn_impl="pallas"), device="cpu")
    _load_from_jax(api, japi, "PallasBatchNorm")
    state = dict(client_vars={k: v.numpy() for k, v in api.client_vars.items()},
                 server_vars={k: v.numpy() for k, v in api.server_vars.items()},
                 client_opt=[t.numpy() for t in api.client_opt],
                 server_opt=[t.detach().numpy().copy() for t in api._sopt.tensors()],
                 server_logits=api.server_logits.numpy())
    spec = dict(data=GKT_DATA, run=GKT_RUN, bn_impl="pallas", state=state,
                client_orders=[[o.numpy() for o in clients(0, i)] for i in range(japi.C)],
                server_orders=[o.numpy() for o in server(0)])
    return japi, spec


@functools.lru_cache(maxsize=None)
def _jax_streaming():
    jds = jax_synthetic(**STREAM_DATA)
    jtr = JaxStreaming(jds, JaxFedConfig(**STREAM_RUN), jax_create_model(
        "lr", jds.class_num, input_shape=jds.train_x.shape[2:]))
    init = {k: v.numpy() for k, v in flax_to_torch(jax.tree.map(np.asarray,
                                                                jtr.variables)).items()}
    return jtr, init


def _cases(world: int) -> list:
    _, _, x, y, m = _setup()
    cases = [(f"dp-{bn}", "dp_step", dict(init=_init(bn), x=x, y=y, m=m, bn_impl=bn, lr=0.1,
                                         momentum=0.9))
             for w, bn in DP_CASES if w == world]
    cases += [(f"dp-{bn}-half", "dp_step", dict(init=_init(bn), x=x, y=y, m=MASKS["half"],
                                                bn_impl=bn, lr=0.1, momentum=0.9))
              for w, bn in PAD_CASES if w == world]
    cases.append(("bn_axis", "bn_axis", dict(init=_init("xla"), x=_global_batch_stats()[0])))
    if world == 2:
        cases.append(("stream", "stream_centralized", dict(data=STREAM_DATA, run=STREAM_RUN,
                                                           init=_jax_streaming()[1])))
        cases.append(("gkt", "gkt", _gkt_setup()[1]))
    return cases


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    worlds = {w: ranks.Spawn(w, _cases(w), tmp) for w in (2, 4)}
    yield worlds
    for w in worlds.values():
        w.results()


@pytest.mark.parametrize("world,bn_impl", DP_CASES)
def test_dp_step_equals_single_device_full_batch(world, bn_impl, spawned):
    ref_loss, ref = _single_step(bn_impl)
    for r, res in enumerate(ranks.result(spawned[world], f"dp-{bn_impl}")):
        assert np.isclose(res["loss"], ref_loss, rtol=1e-5), (res["loss"], ref_loss)
        assert set(res["state"]) == set(ref)
        for k, want in ref.items():
            np.testing.assert_allclose(res["state"][k], want.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world,bn_impl", PAD_CASES)
def test_dp_step_with_padding_ranks_equals_single_device(world, bn_impl, spawned):
    """The first half of the batch real: the last ranks' rows are all
    padding, yet their rows' share of the sync-BN backward still counts."""
    ref_loss, ref = _single_step(bn_impl, "half")
    for r, res in enumerate(ranks.result(spawned[world], f"dp-{bn_impl}-half")):
        assert np.isclose(res["loss"], ref_loss, rtol=1e-5), (res["loss"], ref_loss)
        for k, want in ref.items():
            np.testing.assert_allclose(res["state"][k], want.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_bn_axis_syncs_the_batch_statistics(world, spawned):
    want = _global_batch_stats()[1]
    for r, res in enumerate(ranks.result(spawned[world], "bn_axis")):
        for k, v in want.items():
            np.testing.assert_allclose(res["state"][k], v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")


def test_streaming_trainer_mesh_matches_jax(spawned):
    jtr, _ = _jax_streaming()
    jh = jtr.train()
    for res in ranks.result(spawned[2], "stream"):
        np.testing.assert_allclose(res["history"]["Test/Acc"], jh["Test/Acc"], rtol=1e-5)
        np.testing.assert_allclose(res["history"]["Test/Loss"], jh["Test/Loss"], rtol=1e-4)
        want = flax_to_torch(jax.tree.map(np.asarray, jtr.variables))
        for k, v in want.items():
            np.testing.assert_allclose(res["state"][k], v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_gkt_server_mesh_matches_jax(spawned):
    japi, _ = _gkt_setup()
    _, _, closs, sloss = _jax_round(japi, 0)
    want = flax_to_torch(jax.tree.map(np.asarray, japi.server_vars), bn_name="PallasBatchNorm")
    for r, res in enumerate(ranks.result(spawned[2], "gkt")):
        np.testing.assert_allclose(res["closs"], np.asarray(closs), rtol=1e-5)
        np.testing.assert_allclose(res["sloss"], float(sloss), rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(res["server_vars"][k], v.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(res["server_logits"], np.asarray(japi.server_logits),
                                   rtol=2e-4, atol=1e-5)


def test_one_rank_mesh_is_the_plain_step_and_eval_sums_match():
    """At one rank the DP step is the single-device step bit for bit (the
    bundle runs as given), and the eval sums are the plain ones."""
    _, variables, x, y, m = _setup()
    task = get_task("classification", 10)
    outs = []
    for mesh in (None, batch_mesh(1, device="cpu")):
        bundle = create_model("resnet20", 10, input_shape=(8, 8, 3), bn_impl="pallas")
        bundle.module.load_state_dict(flax_to_torch(variables, bn_name="PallasBatchNorm"))
        step = make_dp_train_step(bundle, task, make_optimizer("sgd", 0.1, 0.9), mesh,
                                  grad_clip=1.0)
        args = place_batch(batch_mesh(1, device="cpu"), x, y, m)
        outs.append((step(*args), bundle.module.state_dict()))
    (l0, s0), (l1, s1) = outs
    assert torch.equal(l0, l1) and all(torch.equal(s0[k], s1[k]) for k in s0)
    sums = make_dp_eval_fn(bundle, task, batch_mesh(1, device="cpu"))(*args)
    want = task.metrics(bundle.apply_eval(bundle.module, args[0]), args[1], args[2])
    for k in want:
        np.testing.assert_allclose(sums[k].numpy(), want[k].detach().numpy(), rtol=1e-6)


def test_one_rank_streaming_mesh_equals_no_mesh():
    ds = make_synthetic_classification(**STREAM_DATA)
    hist = []
    for mesh in (None, batch_mesh(1, device="cpu")):
        tr = StreamingCentralizedTrainer(ds, FedConfig(**STREAM_RUN), create_model(
            "lr", ds.class_num, input_shape=ds.train_x.shape[2:]), mesh=mesh, device="cpu")
        tr.variables = {k: torch.from_numpy(v) for k, v in _jax_streaming()[1].items()}
        hist.append((tr.train(), tr.variables))
    (h0, v0), (h1, v1) = hist
    assert h0 == h1 and all(torch.equal(v0[k], v1[k]) for k in v0)
