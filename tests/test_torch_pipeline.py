"""The port's GPipe pipeline and its 3-D (dp, pp, sp) form against the JAX
package's (``fedml_tpu/parallel/pipeline.py``).

The steps run on four spawned gloo ranks (``tests/torch_mesh_ranks.py``)
from JAX's initial variables at the sizes of ``tests/test_pipeline.py``
(VOCAB 31, DIM 16, HEADS 2, LAYERS 4, T 8, SGD 0.1 with momentum 0.9,
``attn_impl="xla"``). After one step each stage's blocks are put back in
order and held against the single-device step, the loss at rtol 1e-5 and
the parameters at that file's rtol 2e-4 / atol 2e-5 (3e-4 / 3e-5 for the
3-D step); the 2-D steps also against JAX's own pipeline step. JAX's own
3-D test is an xfail (``tests/test_pipeline.py:105``, a ``shard_map``
autodiff fault of the reference), so the 3-D step is held against JAX's
single-device step only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu.ops.xent import masked_cross_entropy as jax_xent
from fedml_tpu.parallel import pipeline as jpp
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.parallel import pipeline as tpp
from fedml_tpu_torch.parallel.local import make_optimizer

VOCAB, DIM, HEADS, LAYERS, T = 31, 16, 2, 4, 8
MODEL = dict(vocab_size=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS, max_len=T, attn_impl="xla")
#: (mesh, n_micro, sp_mode): the 2-D steps, then the 3-D ones
STEPS = [((2, 2), 2, None), ((1, 4), 4, None), ((1, 2, 2), 2, "ring"), ((1, 2, 2), 2, "ulysses")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _setup(b: int):
    jm = JaxTransformerLM(**MODEL)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32)))
    gen = np.random.default_rng(0)
    x = gen.integers(0, VOCAB, size=(b, T)).astype(np.int64)
    y = gen.integers(0, VOCAB, size=(b, T)).astype(np.int64)
    m = (gen.random((b, T)) < 0.9).astype(np.float32)
    return jm, variables, x, y, m


def _batch_size(mesh, n_micro) -> int:
    return 2 * mesh[0] * n_micro


def _name(mesh, n_micro, mode) -> str:
    return f"pp-{mesh}-{n_micro}-{mode}"


def _cases() -> list:
    cases = [("errors", "pp_errors", {})]
    for mesh, n_micro, mode in STEPS:
        _, variables, x, y, m = _setup(_batch_size(mesh, n_micro))
        cases.append((_name(mesh, n_micro, mode), "pp_step", dict(
            model=MODEL, init={k: v.numpy() for k, v in flax_to_torch(variables).items()},
            x=x, y=y, m=m, mesh=mesh, n_micro=n_micro, mode=mode, lr=0.1, momentum=0.9)))
    return cases


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    w = ranks.Spawn(4, _cases(), tmp_path_factory.mktemp("pp"))
    yield w
    w.results()


@functools.lru_cache(maxsize=None)
def _reference_step(b: int) -> tuple:
    """tests/test_pipeline.py's ``_reference_step``: loss and parameters."""
    jm, variables, x, y, m = _setup(b)
    tx = optax.sgd(0.1, momentum=0.9)

    def loss_fn(params):
        per = jax_xent(jm.apply({"params": params}, jnp.asarray(x, jnp.int32)),
                       jnp.asarray(y, jnp.int32), jnp.asarray(m), impl="xla")
        return jnp.sum(per) / jnp.maximum(jnp.sum(m), 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    return float(loss), flax_to_torch({"params": jax.tree.map(
        np.asarray, optax.apply_updates(variables["params"], updates))})


def _jax_pipeline_step(mesh, n_micro) -> tuple:
    jm, variables, x, y, m = _setup(_batch_size(mesh, n_micro))
    jmesh = jpp.pp_mesh(*mesh)
    tx = optax.sgd(0.1, momentum=0.9)
    params = jpp.place_pp_params(jpp.stack_pipeline_params(variables, LAYERS), jmesh)
    step = jpp.make_pp_lm_train_step(jm, tx, jmesh, n_micro=n_micro, attn_impl="xla")
    params, _, loss = step(params, tx.init(params), jnp.asarray(x, jnp.int32),
                           jnp.asarray(y, jnp.int32), jnp.asarray(m))
    return float(loss), flax_to_torch(jax.tree.map(
        np.asarray, jpp.unstack_pipeline_params(params, LAYERS)))


def _gathered(per_rank: list) -> dict:
    """Every stage's blocks, back in layer order, as one state dict; the
    replicas of a stage (its dp and sp ranks) must agree bit for bit."""
    by_stage = {}
    for res in per_rank:
        first = by_stage.setdefault(res["stage"], res)
        for g in ("outer", "blocks"):
            for k, v in res[g].items():
                np.testing.assert_array_equal(v, first[g][k], err_msg=f"replicas differ: {k}")
    stages = [by_stage[s] for s in sorted(by_stage)]
    blocks = {k: torch.from_numpy(np.concatenate([s["blocks"][k] for s in stages]))
              for k in stages[0]["blocks"]}
    outer = {k: torch.from_numpy(v) for k, v in stages[0]["outer"].items()}
    return tpp.unstack_pipeline_params({"outer": outer, "blocks": blocks}, LAYERS)


@pytest.mark.parametrize("mesh,n_micro,mode", STEPS, ids=lambda v: str(v))
def test_pipeline_step_matches_single_device(mesh, n_micro, mode, spawned):
    refs = [_reference_step(_batch_size(mesh, n_micro))]
    if mode is None:
        refs.append(_jax_pipeline_step(mesh, n_micro))
    tol = dict(rtol=2e-4, atol=2e-5) if mode is None else dict(rtol=3e-4, atol=3e-5)
    per_rank = ranks.result(spawned, _name(mesh, n_micro, mode))
    got = _gathered(per_rank)
    for ref_loss, ref in refs:
        for res in per_rank:
            np.testing.assert_allclose(res["loss"], ref_loss, rtol=1e-5)
        assert set(got) == set(ref)
        for k, want in ref.items():
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), **tol, err_msg=k)


def test_pipeline_refusals(spawned):
    msgs = ranks.result(spawned, "errors")[0]
    assert "not divisible by pp" in msgs["layers"]
    assert "dropout must be 0" in msgs["dropout"]
    assert "not divisible by n_micro" in msgs["n_micro"]


def test_stack_unstack_roundtrip_matches_jax_grouping():
    variables = _setup(8)[1]
    state = flax_to_torch(variables)
    pp = tpp.stack_pipeline_params(state, LAYERS)
    jstack = jpp.stack_pipeline_params(variables, LAYERS)
    assert set(pp["outer"]) == set(flax_to_torch({"params": jstack["outer"]}))
    jblocks = flax_to_torch({"params": jax.tree.map(np.asarray, jstack["blocks"])}, stacked=True)
    for k, v in pp["blocks"].items():
        assert v.shape[0] == LAYERS
        np.testing.assert_array_equal(v.numpy(), jblocks[k].numpy(), err_msg=k)
    rt = tpp.unstack_pipeline_params(pp, LAYERS)
    assert set(rt) == set(state) and all(torch.equal(rt[k], state[k]) for k in state)


def test_one_stage_pipeline_matches_single_device():
    """At one rank (S = 1, M = 2): the schedule's two ticks and its
    explicit backward equal the single-device step."""
    mesh = tpp.pp_mesh(1, 1, "cpu")
    module = TransformerLM(**MODEL)
    _, variables, x, y, m = _setup(8)
    module.load_state_dict(flax_to_torch(variables))
    params = tpp.place_pp_params(tpp.stack_pipeline_params(module.state_dict(), LAYERS), mesh)
    opt = make_optimizer("sgd", 0.1, 0.9)(tpp.pipeline_parameters(params))
    step = tpp.make_pp_lm_train_step(module, mesh, n_micro=2, attn_impl="xla", xent_impl="xla")
    loss = step(params, opt, *(torch.from_numpy(a) for a in (x, y, m)))
    ref_loss, ref = _reference_step(8)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    got = tpp.unstack_pipeline_params(params, LAYERS)
    for k, want in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), want.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
