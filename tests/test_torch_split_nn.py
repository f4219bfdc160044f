"""SplitNN: the port against the JAX package.

Both sides start from the JAX package's initial weights (converted by path,
``models/convert.flax_to_torch``) and take JAX's per-client, per-epoch
orders (``permutation(fold_in(fold_in(round_key, k), e), n_pad)``). f32,
rtol 1e-5 / atol 1e-6 (the launcher's and FedAvg's round bound).

- ``create_split_cnn`` (8 x 8 x 1 images, the cut at the flatten) and
  ``create_split_mlp`` (synthetic_1_1's flat features): forward of both
  stages against the JAX modules.
- ``make_splitnn_epoch_fn``: one client-epoch (one backward through both
  stages a minibatch, the real records first, the padding steps not run)
  against JAX's jitted epoch scan: both stages' weights and optimizer
  momentum, the mean loss.
- ``SplitNNAPI``: two rings of the relay over 3 clients, 2 epochs each:
  every client's own lower stage (never aggregated), the server stage, the
  history's per-client epoch losses and the validation accuracy through
  the last client's stage, rtol 1e-4 / atol 1e-5, at lr 0.02
  (tests/test_split_nn.py's): the server stage trains through all 12
  client-epochs with no average between them, so f32 summation order
  accumulates (at lr 0.05 the mlp's losses read 1.7e-5 apart after the
  second ring, and its server weights 4.6e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.split_nn import SplitNNAPI as JaxSplitNNAPI
from fedml_tpu.algorithms.split_nn import make_splitnn_epoch_fn as jax_epoch_fn
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import round_key
from fedml_tpu.core.tasks import get_task as jax_get_task
from fedml_tpu.data import load_dataset as jax_load_dataset
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models.split import create_split_cnn as jax_split_cnn
from fedml_tpu.models.split import create_split_mlp as jax_split_mlp
from fedml_tpu.parallel.local import make_optimizer as jax_make_optimizer
from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, make_splitnn_epoch_fn
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.split import create_split_cnn, create_split_mlp
from fedml_tpu_torch.parallel.local import make_optimizer
from torch_jax_refs import assert_vars_close

TOL = dict(rtol=1e-5, atol=1e-6)
IMAGES = dict(name="split", input_shape=(8, 8, 1), classes=4, num_clients=3,
              records_per_client=20, partition_method="hetero", batch_size=8, seed=2)
RUN = dict(batch_size=8, lr=0.02, momentum=0.9, wd=5e-4, epochs=2, comm_round=2, seed=0)


def _datasets(kind: str):
    if kind == "cnn":
        return jax_synthetic(**IMAGES), make_synthetic_classification(**IMAGES)
    kw = dict(num_clients=3, batch_size=8, seed=0)
    return jax_load_dataset("synthetic_1_1", **kw), load_dataset("synthetic_1_1", **kw)


def _pairs(kind: str, ds):
    shape = ds.train_x.shape[2:]
    if kind == "cnn":
        return (jax_split_cnn(ds.class_num, shape, features=4, hidden=16),
                create_split_cnn(ds.class_num, shape, features=4, hidden=16))
    return (jax_split_mlp(ds.class_num, shape, cut_dim=16),
            create_split_mlp(ds.class_num, shape, cut_dim=16))


def _jax_perms(seed: int, r: int, k: int, epochs: int, n: int) -> list:
    ck = jax.random.fold_in(round_key(jax.random.key(seed), r), k)
    return [torch.from_numpy(np.asarray(jax.random.permutation(jax.random.fold_in(ck, e), n))
                             .astype(np.int64)) for e in range(epochs)]


def _flax(tree) -> dict:
    return flax_to_torch(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_stages_forward_match_jax(kind):
    jds, ds = _datasets(kind)
    (jc, js), (tc, ts) = _pairs(kind, jds)
    cv, sv = jc.init(jax.random.key(0)), js.init(jax.random.key(1))
    x = jds.train_x[0, :8]
    acts = jc.apply_eval(cv, jnp.asarray(x))
    logits = js.apply_eval(sv, acts)
    got_acts = tc.apply_eval(_flax(cv), torch.from_numpy(x))
    np.testing.assert_allclose(got_acts.numpy(), np.asarray(acts), **TOL)
    np.testing.assert_allclose(ts.apply_eval(_flax(sv), got_acts).numpy(), np.asarray(logits),
                               rtol=1e-5, atol=1e-5)
    assert ts.input_shape == js.input_shape


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_epoch_fn_matches_jax(kind):
    jds, ds = _datasets(kind)
    (jc, js), (tc, ts) = _pairs(kind, jds)
    cv, sv = jc.init(jax.random.key(0)), js.init(jax.random.key(1))
    jtx = jax_make_optimizer("sgd", 0.05, 0.9, 5e-4)
    epoch = jax_epoch_fn(jc, js, jax_get_task("classification"), jtx, jtx, 8)
    k = 1                                 # a client whose records leave a padded last batch
    key = jax.random.key(3)
    x, y, m, count = jds.train_x[k], jds.train_y[k], jds.train_mask[k], jds.train_counts[k]
    assert count % 8, "the case needs a partial last batch"
    cv1, sv1, copt, sopt, loss = epoch(cv, sv, jtx.init(cv["params"]), jtx.init(sv["params"]),
                                       x, y, m, jnp.float32(count), key)
    tc.module.load_state_dict(_flax(cv))
    ts.module.load_state_dict(_flax(sv))
    tx = make_optimizer("sgd", 0.05, 0.9, 5e-4)
    tepoch = make_splitnn_epoch_fn(tc, ts, get_task("classification"), tx, tx, 8)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, x.shape[0])).astype(np.int64))
    got = tepoch(*(torch.from_numpy(a) for a in (x, y, m)), int(count), perm)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
    assert_vars_close(tc.module.state_dict(), cv1, msg="client", **TOL)
    assert_vars_close(ts.module.state_dict(), sv1, msg="server", **TOL)
    # the momentum traces (sgd's only state), in parameter order
    for opt, params, jopt in ((tepoch.c_opt, tc.module, copt), (tepoch.s_opt, ts.module, sopt)):
        trace = _flax({"params": jopt[1][0].trace})
        for (name, _), t in zip(params.named_parameters(), opt.tensors()):
            np.testing.assert_allclose(t.numpy(), trace[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_splitnn_api_matches_jax(kind):
    jds, ds = _datasets(kind)
    jpair, tpair = _pairs(kind, jds)
    japi = JaxSplitNNAPI(jds, JaxFedConfig(**RUN), *jpair)
    api = SplitNNAPI(ds, FedConfig(**RUN), *tpair, device="cpu",
                     order_hook=lambda r, k: _jax_perms(RUN["seed"], r, k, RUN["epochs"],
                                                        ds.train_x.shape[1]))
    api.client_vars = [_flax(v) for v in japi.client_vars]
    api.server_vars = _flax(japi.server_vars)
    want = japi.train()
    got = api.train()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["epoch_loss"], want["epoch_loss"], **tol)
    np.testing.assert_allclose(got["val_acc"], want["val_acc"], atol=1e-6)
    assert len(got["epoch_loss"]) == 2 * 3 and len(got["val_acc"]) == 2
    for k in range(3):
        assert_vars_close(api.client_vars[k], japi.client_vars[k], msg=f"client {k}", **tol)
    assert_vars_close(api.server_vars, japi.server_vars, msg="server", **tol)
    # each client's stage is its own: none equals another after training
    assert not torch.equal(api.client_vars[0]["Dense_0.weight" if kind == "mlp"
                                               else "Conv_0.weight"],
                           api.client_vars[1]["Dense_0.weight" if kind == "mlp"
                                               else "Conv_0.weight"])
