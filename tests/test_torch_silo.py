"""The silo harness (``SiloRunner`` and its factories) against the JAX
package's, on ``lr`` with JAX's orders injected.

- Histories of SiloFedAvg, SiloFedOpt, SiloFedNova and SiloFedAGC: the
  ``GLOBAL/...`` series rtol 1e-5 (tests/test_torch_fedavg.py's loss
  tolerance), every ``Client.<c>/Train/Acc`` within atol 1e-6, the same
  ``best_round``.
- The global early stop (``patience`` / ``min_delta``), the per-client exit
  (``client_patience``: the same ``Client.<c>/stopped_round`` entries, the
  exited clients' ``None`` entries) and the all-exit stop: the same rounds
  as JAX's.
- ``model_best.ckpt`` and ``model_last.ckpt``: the same round and ``val``
  as JAX's, variables rtol 1e-4 / atol 1e-5 (tests/test_torch_algorithms.
  py's); a checkpoint restores bit for bit.
- Client exit on the packed round (``pack_lanes=2``, the exited clients'
  lane spans frozen) against the plain round: histories rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import silo as jax_silo
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from fedml_tpu_torch.algorithms import silo
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.utils.checkpoint import load_checkpoint
from torch_jax_refs import assert_vars_close, order_hook

SEED = 0
EPOCHS = 1
DATA = dict(name="silo", input_shape=(8,), classes=3, num_clients=5, records_per_client=12,
            partition_method="hetero", partition_alpha=0.5, batch_size=6, seed=SEED)
RUN = dict(model="lr", client_num_in_total=5, client_num_per_round=5, comm_round=6,
           batch_size=6, epochs=EPOCHS, lr=0.3, seed=SEED, frequency_of_the_test=1,
           device_data="on")
GLOBAL = ("GLOBAL/Train/Loss", "GLOBAL/Test/Acc", "GLOBAL/Test/Loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(factory: str, tmp_path=None, run=None, **kw):
    """The JAX runner and the port's, the port's from JAX's variables."""
    run = {**RUN, **(run or {})}
    jds = jax_synthetic(**DATA)
    jkw, pkw = dict(kw), dict(kw)
    if tmp_path is not None:
        jkw["model_dir"], pkw["model_dir"] = str(tmp_path / "jax"), str(tmp_path / "port")
    jr = getattr(jax_silo, factory)(jds, JaxFedConfig(**run, pack_lanes=0),
                                    bundle=jax_create_model("lr", jds.class_num,
                                                            input_shape=jds.train_x.shape[2:]),
                                    **jkw)
    ds = make_synthetic_classification(**DATA)
    port = getattr(silo, factory)(ds, FedConfig(**run), device="cpu",
                                  order_hook=order_hook(SEED, EPOCHS, ds.num_clients,
                                                        ds.train_x.shape[1]), **pkw)
    port.api.variables = flax_to_torch(jax.tree.map(np.asarray, jr.api.variables))
    return jr, port


def _assert_histories_close(got: dict, want: dict, rtol=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in GLOBAL:
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)
        elif k.endswith("/Train/Acc"):
            assert [a is None for a in got[k]] == [a is None for a in v], k
            np.testing.assert_allclose([a for a in got[k] if a is not None],
                                       [a for a in v if a is not None], atol=1e-6, err_msg=k)
        elif k == "best_metric":
            np.testing.assert_allclose(got[k], v, rtol=1e-6)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("factory", ["SiloFedAvg", "SiloFedOpt", "SiloFedNova", "SiloFedAGC"])
def test_histories_match_jax(factory):
    jr, port = _pair(factory, run=dict(comm_round=3))
    _assert_histories_close(port.train(), jr.train())


@pytest.mark.parametrize("kw", [dict(patience=1, min_delta=0.05),
                                dict(client_patience=1, client_min_delta=0.02),
                                dict(client_patience=1, client_min_delta=1.0)],
                         ids=["early-stop", "client-exit", "all-exit"])
def test_stops_and_exits_match_jax(kw):
    jr, port = _pair("SiloFedAvg", **kw)
    want, got = jr.train(), port.train()
    _assert_histories_close(got, want)
    assert len(got["round"]) < RUN["comm_round"] or any("stopped_round" in k for k in got)
    if kw.get("client_min_delta") == 1.0:       # every client left at its second eval
        assert got["round"] == [0, 1] and port.api._client_active is None


def test_checkpoints_match_jax(tmp_path):
    jr, port = _pair("SiloFedAvg", tmp_path, patience=2)
    _assert_histories_close(port.train(), jr.train())
    for name in ("model_best.ckpt", "model_last.ckpt"):
        got = load_checkpoint(str(tmp_path / "port" / name))
        want = jax_load_checkpoint(str(tmp_path / "jax" / name))
        assert got["round_idx"] == want["round_idx"], name
        assert set(got["extra"]) == set(want["extra"])
        for k, v in want["extra"].items():
            np.testing.assert_allclose(got["extra"][k], v, rtol=1e-6)
        assert_vars_close(got["variables"], want["variables"], 1e-4, 1e-5, name)
    last = load_checkpoint(str(tmp_path / "port" / "model_last.ckpt"))
    assert all(torch.equal(last["variables"][k], v) for k, v in port.api.variables.items())
    fresh = FedAvgAPI(make_synthetic_classification(**DATA), FedConfig(**RUN), device="cpu")
    assert fresh.restore(str(tmp_path / "port" / "model_best.ckpt")) == jr.best_round
    best = load_checkpoint(str(tmp_path / "port" / "model_best.ckpt"))["variables"]
    assert all(torch.equal(fresh.variables[k], v) for k, v in best.items())


def test_client_exit_freezes_lanes_on_the_packed_round():
    """The packed round with exits against the plain round: the exited
    clients weigh 0 and their lane spans freeze, the histories agree."""
    ds = make_synthetic_classification(**DATA)
    hook = order_hook(SEED, EPOCHS, ds.num_clients, ds.train_x.shape[1])
    kw = dict(client_patience=1, client_min_delta=0.02, device="cpu", order_hook=hook)
    plain = silo.SiloFedAvg(ds, FedConfig(**RUN), **kw)
    packed = silo.SiloFedAvg(ds, FedConfig(**RUN, pack_lanes=2), **kw)
    assert packed.api._packed_train is not None
    packed.api.variables = {k: v.clone() for k, v in plain.api.variables.items()}
    got, want = packed.train(), plain.train()
    assert any("stopped_round" in k for k in want)
    _assert_histories_close(got, want)
