"""The port's tensor (Megatron) and expert parallelism and its MoE LM
against the JAX package's (``fedml_tpu/parallel/tensor.py``,
``fedml_tpu/models/moe.py``).

TP and EP steps run on spawned gloo ranks (``tests/torch_mesh_ranks.py``)
at (dp, tp|ep) = (1, 2) and (2, 2), from JAX's initial variables and at
the sizes of ``tests/test_tensor_parallel.py``; after one step the
parameters, gathered from the shards (``parallel/tensor.gather_params``),
are held against JAX's single-device step at that file's tolerance, rtol
2e-4 / atol 1e-5, and the shards' shapes against JAX's
per-device shard shapes. The port's ``qkv`` shard holds its rank's heads of
each of q, k and v, where JAX's holds a contiguous column block, so only
the gathered parameters compare, not the shards. The MoE LM's logits and
gradients compare at the transformer's tolerances (rtol 1e-5 / atol 1e-5,
gradients rtol 1e-4 / atol 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_ranks as ranks
from fedml_tpu.models.moe import MoeTransformerLM as JaxMoeLM
from fedml_tpu.models.moe import top_k_probs as jax_top_k_probs
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu.ops.xent import masked_cross_entropy as jax_xent
from fedml_tpu.parallel import tensor as jtp
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.moe import MoeTransformerLM, top_k_probs
from fedml_tpu_torch.ops.xent import masked_cross_entropy
from fedml_tpu_torch.parallel import tensor as ttp

TP_MODEL = dict(vocab_size=16, dim=16, heads=4, layers=2, max_len=8, attn_impl="xla")
MOE_MODEL = dict(vocab_size=16, dim=16, heads=2, layers=1, num_experts=4, max_len=8,
                 attn_impl="xla")
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _setup(moe: bool):
    """JAX's module, initial variables (numpy) and batch, as
    tests/test_tensor_parallel.py builds them."""
    seed = 1 if moe else 0
    jm = JaxMoeLM(**MOE_MODEL) if moe else JaxTransformerLM(**TP_MODEL)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(seed),
                                                 jnp.zeros((1, 8), jnp.int32)))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 16, (8, 8)).astype(np.int64)
    y = rng.integers(0, 16, (8, 8)).astype(np.int64)
    return jm, variables, x, y, np.ones((8, 8), np.float32)


def _opt(moe: bool) -> dict:
    return dict(lr=0.1) if moe else dict(lr=0.1, momentum=0.9)


def _case(moe: bool, mesh) -> tuple:
    _, variables, x, y, m = _setup(moe)
    model = {k: v for k, v in (MOE_MODEL if moe else TP_MODEL).items()}
    return (f"{'ep' if moe else 'tp'}-{mesh}", "tp_step",
            dict(model=model, moe=moe, init={k: v.numpy() for k, v in
                                             flax_to_torch(variables).items()},
                 x=x, y=y, m=m, mesh=mesh, **_opt(moe)))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    worlds = {w: ranks.Spawn(w, [_case(moe, mesh) for moe in (False, True) for mesh in MESHES
                                 if mesh[0] * mesh[1] == w], tmp) for w in (2, 4)}
    yield worlds
    for w in worlds.values():
        w.results()


@functools.lru_cache(maxsize=None)
def _single_step(moe: bool):
    """JAX's single-device step (``_make_single_step``): loss and updated
    parameters in the port's names."""
    jm, variables, x, y, m = _setup(moe)
    o = _opt(moe)
    tx = optax.sgd(o["lr"], momentum=o.get("momentum"))

    def loss_fn(p):
        per = jax_xent(jm.apply({"params": p}, jnp.asarray(x, jnp.int32)),
                       jnp.asarray(y, jnp.int32), jnp.asarray(m))
        return jnp.sum(per) / jnp.sum(m)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    ups, _ = tx.update(g, tx.init(variables["params"]), variables["params"])
    return float(loss), flax_to_torch({"params": jax.tree.map(
        np.asarray, optax.apply_updates(variables["params"], ups))})


def _jax_shard_shapes(moe: bool, n: int) -> dict:
    """JAX's per-device shard shape of every leaf on a (1, n) mesh, under
    the port's state-dict name and in the port's layout."""
    _, variables, *_ = _setup(moe)
    mesh = (jtp.ep_mesh if moe else jtp.tp_mesh)(1, n)
    placed = (jtp.shard_params_ep if moe else jtp.shard_params_tp)(variables, mesh)
    zeros = jax.tree.map(lambda a: np.zeros(a.addressable_shards[0].data.shape, np.float32),
                         placed)
    return {k: tuple(v.shape) for k, v in flax_to_torch(zeros).items()}


@pytest.mark.parametrize("moe", [False, True], ids=["tp", "ep"])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_step_gathers_to_the_single_device_step(moe, mesh, spawned):
    ref_loss, ref = _single_step(moe)
    shard_shapes = _jax_shard_shapes(moe, mesh[1])
    per_rank = ranks.result(spawned[mesh[0] * mesh[1]], _case(moe, mesh)[0])
    for r, res in enumerate(per_rank):
        assert np.isclose(res["loss"], ref_loss, rtol=1e-5), (res["loss"], ref_loss)
        assert set(res["state"]) == set(ref)
        for k, want in ref.items():
            np.testing.assert_allclose(res["state"][k], want.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        assert res["shapes"] == shard_shapes


def _flax_paths(variables) -> list:
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(variables)[0]]


@pytest.mark.parametrize("moe", [False, True], ids=["tp", "ep"])
def test_specs_match_jax_on_every_path(moe):
    variables = _setup(moe)[1]
    paths = _flax_paths(variables)
    for path in paths:
        assert ttp.tp_spec(path) == tuple(jtp.tp_spec(path)), path
        assert ttp.ep_spec(path) == tuple(jtp.ep_spec(path)), path
    sharded = [p for p in paths if (ttp.ep_spec if moe else ttp.tp_spec)(p)]
    assert len(sharded) == (4 if moe else 6 * TP_MODEL["layers"])


def test_megatron_rules():
    assert ttp.tp_spec("['params']['block0']['attn']['qkv']['kernel']") == (None, "tp")
    assert ttp.tp_spec("['params']['block0']['attn']['out']['kernel']") == ("tp", None)
    assert ttp.tp_spec("['params']['block0']['Dense_0']['kernel']") == (None, "tp")
    assert ttp.tp_spec("['params']['block0']['Dense_1']['kernel']") == ("tp", None)
    assert ttp.tp_spec("['params']['tok_embed']['embedding']") == ()
    assert ttp.ep_spec("['params']['block0']['moe']['w_up']") == ("ep",)
    assert ttp.ep_spec("['params']['block0']['moe']['router']['kernel']") == ()


@pytest.mark.parametrize("top_k", [1, 3, 8])
def test_top_k_probs_matches_jax(top_k):
    logits = np.random.default_rng(0).normal(size=(2, 4, 8)).astype(np.float32)
    got = top_k_probs(torch.from_numpy(logits), top_k).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_top_k_probs(jnp.asarray(logits), top_k)),
                               rtol=1e-6, atol=1e-7)
    assert np.all((got > 0).sum(-1) == top_k)


def test_moe_lm_logits_and_grads_match_jax():
    jm, variables, x, y, m = _setup(True)
    tm = MoeTransformerLM(**MOE_MODEL)
    tm.load_state_dict(flax_to_torch(variables), strict=True)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x, jnp.int32))
        per = jax_xent(logits, jnp.asarray(y, jnp.int32), jnp.asarray(m), impl="xla")
        return jnp.sum(per) / jnp.sum(m), logits

    (jloss, jlogits), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    logits = tm(torch.from_numpy(x))
    loss = masked_cross_entropy(logits, torch.from_numpy(y), torch.from_numpy(m),
                                impl="xla").sum() / float(m.sum())
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = flax_to_torch({"params": jax.tree.map(np.asarray, jg)})
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_converter_copies_the_3d_expert_weights_as_they_are():
    variables = _setup(True)[1]
    state = flax_to_torch(variables)
    moe = variables["params"]["block0"]["moe"]
    for name in ("w_up", "w_dn", "b_up", "b_dn"):
        assert np.array_equal(state[f"block0.moe.{name}"].numpy(), moe[name])
    assert state["block0.moe.w_up"].shape == (4, 16, 64)
    np.testing.assert_array_equal(state["block0.moe.router.weight"].numpy(),
                                  moe["router"]["kernel"].T)
    back = torch_to_flax(state)
    jax.tree.map(np.testing.assert_array_equal, back, variables)
    # the port's own init draws the same shapes, so flax trees load as they are
    assert {k: tuple(v.shape) for k, v in MoeTransformerLM(**MOE_MODEL).state_dict().items()} \
        == {k: tuple(v.shape) for k, v in state.items()}
