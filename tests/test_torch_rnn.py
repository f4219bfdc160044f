"""The recurrent models (``rnn``: CharLSTM, ``rnn_stackoverflow``:
StackOverflowNWP) against the JAX package on the CPU.

From the same weights (the JAX package's init, ``models/convert``: flax
``OptimizedLSTMCell``'s eight leaves by path), on integer token inputs:
the logits at every position rtol 1e-5 / atol 1e-5 and the gradient of the
``nwp`` task's loss (padding tokens and one masked record) rtol 1e-4 /
atol 1e-6, f32; then one ``FedAvgAPI`` round of ``rnn`` on the synthetic
shakespeare federation against JAX's, with JAX's orders injected: the
variables rtol 1e-4 / atol 1e-6 and the loss rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.tasks import get_task as jax_task
from fedml_tpu.data import load_dataset as jax_load_dataset
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from torch_jax_refs import assert_vars_close, order_hook


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,vocab", [("rnn", 90), ("rnn_stackoverflow", 10004)])
def test_rnn_logits_and_nwp_step_match_jax(name, vocab):
    rng = np.random.default_rng(0)
    x = rng.integers(0, vocab, (3, 8)).astype(np.int32)
    y = rng.integers(0, vocab, (3, 8)).astype(np.int32)
    y[:, -2:] = 0                                        # padding tokens
    m = np.array([1.0, 1.0, 0.0], np.float32)
    jb = jax_create_model(name, vocab, seq_len=8)
    jv = jb.init(jax.random.key(0), batch_size=3)
    jt = jax_task("nwp", vocab)

    def loss(p):
        out = jb.module.apply({"params": p}, jnp.asarray(x), train=True)
        return jt.loss(out, jnp.asarray(y), jnp.asarray(m)), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jv["params"])
    tb = create_model(name, vocab, seq_len=8)
    assert tb.task == "nwp"
    tb.module.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, jv)))
    tb.module.train()
    out = tb.module(torch.from_numpy(x))
    tl = get_task("nwp", vocab).loss(out, torch.from_numpy(y), torch.from_numpy(m))
    tl.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    want = flax_to_torch({"params": jax.tree.map(np.asarray, jg)})
    grads = {k: p.grad for k, p in tb.module.named_parameters()}
    assert set(grads) == set(want) and len([k for k in want if "LSTMCell" in k]) % 12 == 0
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_rnn_round_matches_jax():
    kw = dict(client_num_in_total=4, batch_size=4, seed=0)
    cfg = dict(model="rnn", dataset="shakespeare", client_num_in_total=4,
               client_num_per_round=2, comm_round=1, batch_size=4, epochs=1, lr=0.5, seed=0,
               device_data="on")
    jds, tds = jax_load_dataset("shakespeare", **kw), load_dataset("shakespeare", **kw)
    np.testing.assert_array_equal(jds.train_x, tds.train_x)
    jds = jax.tree.map(lambda a: a, jds)
    seq = tds.train_x.shape[2]
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**cfg), jax_create_model("rnn", 90, seq_len=seq))
    tapi = FedAvgAPI(tds, FedConfig(**cfg), create_model("rnn", 90, seq_len=seq), device="cpu",
                     order_hook=order_hook(0, 1, 2, int(tds.train_x.shape[1])))
    tapi.variables = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    jl, tl = float(japi.run_round(0)), float(tapi.run_round(0))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_vars_close(tapi.variables, japi.variables, 1e-4, 1e-6, "rnn round")
