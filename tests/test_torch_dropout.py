"""Dropout (``ops/dropout.py``) and the models that use it, against the JAX
package on the CPU.

The port's masks are its own counter hash of (key, call site, element),
not threefry, so parity with the JAX package holds through the masks: the
test hands the port the masks the JAX package draws.

- ``cnn_dropout`` with JAX's ``seed_dropout`` masks (``bernoulli(fold_in(
  key, 0xD120 + site), 1 - rate, shape)``): logits rtol 1e-5 / atol 1e-6,
  gradients rtol 1e-4 / atol 1e-5 (f32, no BN: well conditioned).
- Its lane-stacked twin, each lane from its own weights, against the JAX
  package's packed body (``conv_impl="packed"``) with ``lane_dropout``'s
  masks under 2 lane keys, at the same tolerances, and the port's own
  ``lane_dropout`` equal to ``seed_dropout`` lane by lane, bit for bit.
- The transformer with flax ``nn.Dropout`` masks (drawn through
  ``jax.random.bernoulli`` in call order, handed to the port's call sites
  2i, 2i + 1): logits rtol 1e-4 / atol 1e-5, gradients rtol 1e-4 / atol
  1e-5 (tests/test_torch_transformer.py's); under remat the recomputed
  blocks draw the same masks (gradients equal to the plain run's).
  EfficientNet's flax masks are held in ``tests/test_torch_zoo_effnet.py``.
- A train-mode apply without a key raises, as JAX's does.
- The trainers: one step key a step, a function of the client's key, the
  epoch and the step; the packed ``cnn_dropout`` round (off and blockdiag)
  equals its clients' plain training lane by lane (rtol 1e-4 / atol 1e-5,
  the JAX package's bound for its dropout packed parity,
  tests/test_packed_everywhere.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.cnn import CNNDropOut as JaxCNNDropOut
from fedml_tpu.ops.packed_conv import DROPOUT_KEY_SALT as JAX_SALT
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops import dropout as dr
from torch_jax_refs import FixedMasks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the derivation ----------------------------------------------------------------

def test_salt_is_the_jax_packages():
    assert dr.DROPOUT_KEY_SALT == JAX_SALT


def test_lane_masks_are_the_per_client_masks_bit_for_bit():
    keys = torch.tensor([3, 2**62 + 5, 17], dtype=torch.int64)
    xs = torch.randn(3, 4, 5, 6)
    lanes = dr.lane_dropout(xs, keys, 0.25, 1, False)
    for lane in range(3):
        assert torch.equal(lanes[lane], dr.seed_dropout(xs[lane], keys[lane], 0.25, 1, False))


def test_masks_keep_their_rate_and_differ_by_key_and_site():
    k = torch.tensor(dr.step_keys(7, 0, 0))
    m = dr.keep_mask(k, 0, (200_000,), 0.25)
    assert abs(float(m.float().mean()) - 0.75) < 0.005
    assert not torch.equal(m, dr.keep_mask(k, 1, (200_000,), 0.25))
    assert not torch.equal(m, dr.keep_mask(k + 1, 0, (200_000,), 0.25))
    assert torch.equal(m, dr.keep_mask(k.clone(), 0, (200_000,), 0.25))
    x = torch.ones(200_000)
    y = dr.seed_dropout(x, k, 0.25, 0, False)
    assert torch.equal(y, torch.where(m, x / 0.75, torch.zeros(())))
    assert dr.seed_dropout(x, None, 0.25, 0, True) is x and dr.seed_dropout(x, None, 0.0, 0, False) is x


def test_step_keys_are_63_bit_and_vectorize():
    one = [int(dr.step_keys(5, e, s)) for e in range(2) for s in range(3)]
    many = dr.step_keys(np.full(6, 5), np.repeat([0, 1], 3), np.tile([0, 1, 2], 2))
    assert list(many) == one and len(set(one)) == 6 and all(0 <= k < 2**63 for k in one)
    # a client's key: (seed, round, cohort position, group round), each part counts
    keys = {dr.client_key(*t) for t in [(0, 1, 2), (1, 1, 2), (0, 2, 2), (0, 1, 3),
                                        (0, 1, 2, 1), (0, 2**40, 2)]}
    assert len(keys) == 6 and all(0 <= k < 2**63 for k in keys)
    assert dr.client_key(0, 1, 2) == dr.client_key(0, 1, 2, 0)


@pytest.mark.parametrize("build", [
    lambda: dr.seed_dropout(torch.ones(3), None, 0.5, 0, False),
    lambda: dr.lane_dropout(torch.ones(2, 3), None, 0.5, 0, False),
    lambda: create_model("cnn_dropout", 4).module.train()(torch.zeros(1, 28, 28, 1)),
    lambda: TransformerLM(20, dim=16, heads=2, layers=1, dropout=0.1).train()(
        torch.zeros(1, 4, dtype=torch.int64)),
    lambda: create_model("efficientnet-b0", 4).module.train()(torch.zeros(2, 16, 16, 3)),
])
def test_train_mode_without_a_key_raises(build):
    with pytest.raises(ValueError, match="dropout key"):
        build()


# -- cnn_dropout and its twin against JAX --------------------------------------------

def _seed_masks(key, n_lanes: int = 0, n: int = 4):
    """JAX's seed_dropout / lane_dropout masks of cnn_dropout's two sites."""
    keys = [key] if not n_lanes else list(jax.random.split(key, n_lanes))
    out = {}
    for site, (rate, shape) in enumerate(((0.25, (n, 12, 12, 64)), (0.5, (n, 128)))):
        ms = [np.asarray(jax.random.bernoulli(jax.random.fold_in(k, JAX_SALT + site),
                                              1.0 - rate, shape)) for k in keys]
        out[site] = np.stack(ms) if n_lanes else ms[0]
    return keys, out


def _grads(module):
    return {k: p.grad.numpy() for k, p in module.named_parameters()}


def test_cnn_dropout_matches_jax_with_its_masks():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 28, 28, 1)).astype(np.float32)
    jb = jax_create_model("cnn_dropout", 10)
    jv = jb.init(jax.random.key(0))
    (key,), masks = _seed_masks(jax.random.key(7))

    def f(p):
        out = jb.module.apply({"params": p}, jnp.asarray(x), train=True, dropout_rng=key)
        return jnp.sum(out ** 2), out

    (_, jout), jg = jax.value_and_grad(f, has_aux=True)(jv["params"])
    tb = create_model("cnn_dropout", 10)
    assert tb.uses_dropout and tb.explicit_dropout
    tb.module.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, jv)))
    tb.module.train()
    with dr.injected_masks({s: torch.from_numpy(m) for s, m in masks.items()}):
        out = tb.module(torch.from_numpy(x), dropout_key=torch.tensor(0))
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    want = flax_to_torch({"params": jax.tree.map(np.asarray, jg)})
    for k, g in _grads(tb.module).items():
        np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("impl", ["off", "blockdiag"])
def test_cnn_dropout_twin_matches_jax_packed_body(impl):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 28, 28, 1)).astype(np.float32)
    jb = jax_create_model("cnn_dropout", 10)
    lanes = [jax.tree.map(np.asarray, jb.init(jax.random.key(s))) for s in (0, 1)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *lanes)
    keys, masks = _seed_masks(jax.random.key(9), n_lanes=2)
    jm = JaxCNNDropOut(10, conv_impl="packed",
                       packed_impl="blockdiag" if impl == "blockdiag" else "grouped")

    def f(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True, dropout_rng=jnp.stack(keys))
        return jnp.sum(out ** 2), out

    (_, jout), jg = jax.value_and_grad(f, has_aux=True)(stacked["params"])
    per_lane = [flax_to_torch(v) for v in lanes]
    twin = create_model("cnn_dropout", 10).module.lane_stacked(2, packed_impl=impl)
    twin.load_state_dict({k: torch.cat([s[k] for s in per_lane]) for k in per_lane[0]})
    twin.train()
    with dr.injected_masks({s: torch.from_numpy(m) for s, m in masks.items()}):
        out = twin(torch.from_numpy(x), dropout_key=torch.zeros(2, dtype=torch.int64))
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    want = flax_to_torch({"params": jax.tree.map(np.asarray, jg)}, stacked=True)
    for k, g in _grads(twin).items():
        np.testing.assert_allclose(g, want[k].numpy().reshape(g.shape), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# -- the transformer with flax's masks --------------------------------------------

SMALL = dict(vocab_size=40, dim=32, heads=2, layers=2, max_len=32, dropout=0.1)


def _jax_transformer_step(tokens):
    from fedml_tpu.models.transformer import TransformerLM as JaxLM

    jm = JaxLM(**SMALL)
    jv = jm.init(jax.random.key(0), jnp.asarray(tokens))
    masks = FixedMasks(3)

    def f(p):
        out = jm.apply({"params": p}, jnp.asarray(tokens), train=True,
                       rngs={"dropout": jax.random.key(1)})
        return jnp.sum(out.astype(jnp.float32) ** 2) * 1e-3, out

    real = jax.random.bernoulli
    jax.random.bernoulli = masks
    try:
        (_, out), g = jax.value_and_grad(f, has_aux=True)(jv["params"])
    finally:
        jax.random.bernoulli = real
    return jv, masks.masks, np.asarray(out), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_dropout_matches_jax_with_flax_masks(remat):
    tokens = np.random.default_rng(2).integers(0, 40, (3, 16)).astype(np.int32)
    jv, masks, jout, jg = _jax_transformer_step(tokens)
    assert len(masks) == 2 * SMALL["layers"]
    tm = TransformerLM(**SMALL, remat=remat)
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, jv)))
    tm.train()
    with dr.injected_masks({s: torch.from_numpy(m) for s, m in enumerate(masks)}):
        out = tm(torch.from_numpy(tokens), dropout_key=torch.tensor(0))
        (out.square().sum() * 1e-3).backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4, atol=1e-5)
    want = flax_to_torch({"params": jg})
    for k, g in _grads(tm).items():
        np.testing.assert_allclose(g, want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_remat_redraws_the_same_masks():
    """Under keys (no injection): the recomputed blocks of ``remat=True``
    draw the masks of the forward, so the gradients are the plain run's."""
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 40, (2, 16)))
    key = torch.tensor(dr.step_keys(11, 0, 3))
    grads = []
    for remat in (False, True):
        tm = TransformerLM(**SMALL, remat=remat)
        tm.reset_parameters(torch.Generator().manual_seed(0))
        tm.train()
        tm(tokens, dropout_key=key).square().sum().backward()
        grads.append(_grads(tm))
    for k in grads[0]:
        np.testing.assert_array_equal(grads[1][k], grads[0][k], err_msg=k)


def test_transformer_bundle_takes_the_key_through_apply_train():
    tb = create_model("transformer", 40, seq_len=8, dim=16, heads=2, layers=1, dropout=0.2)
    assert tb.uses_dropout and not tb.explicit_dropout
    state = tb.init(0, "cpu")
    x = torch.zeros(2, 8, dtype=torch.int64)
    a, _ = tb.apply_train(state, x, torch.tensor(5))
    b, _ = tb.apply_train(state, x, torch.tensor(5))
    c, _ = tb.apply_train(state, x, torch.tensor(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    e = tb.apply_eval(state, x)
    assert e.shape == a.shape


# -- the trainers ---------------------------------------------------------------------

def _dropout_ds():
    return make_synthetic_classification("femnist-dropout", (28, 28, 1), 62, 2,
                                         records_per_client=24, batch_size=8, seed=3)


def test_each_step_takes_its_own_key():
    """The plain trainer writes ``step_keys(key, epoch, step)`` into the
    step's key input before every step, ``key`` the client's
    ``client_key(seed, round, position)``; without a key it refuses."""
    ds = _dropout_ds()
    cfg = FedConfig(model="cnn_dropout", client_num_in_total=2, client_num_per_round=2,
                    comm_round=1, batch_size=8, epochs=2, lr=0.05, device_data="on")
    api = FedAvgAPI(ds, cfg, create_model("cnn_dropout", 62), device="cpu")
    seen = []
    module = api.bundle.module
    real_forward = type(module).forward

    def spy(self, x, dropout_key=None):
        seen.append(int(dropout_key))
        return real_forward(self, x, dropout_key)

    type(module).forward = spy
    try:
        orders, keys = api._round_orders(0, 2), api._round_keys(0, 2)
        api._local_train(api.variables, *(t[0] for t in api._dev_train),
                         int(ds.train_counts[0]), orders=orders[0], key=int(keys[0]))
        with pytest.raises(ValueError, match="dropout key"):
            api._local_train(api.variables, *(t[0] for t in api._dev_train),
                             int(ds.train_counts[0]), orders=orders[0])
    finally:
        type(module).forward = real_forward
    ck = dr.client_key(cfg.seed, 0, 0)
    assert keys[0] == ck
    steps = -(-int(ds.train_counts[0]) // 8)
    assert seen == [int(dr.step_keys(ck, e, s)) for e in range(2) for s in range(steps)]


@pytest.mark.parametrize("impl", ["off", "blockdiag"])
def test_packed_dropout_lanes_equal_their_clients(impl):
    ds = _dropout_ds()
    cfg = FedConfig(model="cnn_dropout", client_num_in_total=2, client_num_per_round=2,
                    comm_round=1, batch_size=8, epochs=2, lr=0.05, momentum=0.9,
                    pack_lanes=2, packed_conv=impl, device_data="on")
    api = FedAvgAPI(ds, cfg, create_model("cnn_dropout", 62), device="cpu")
    assert api.packed_status()["packed_conv_active"] == (impl != "off")
    init = {k: v.clone() for k, v in api.variables.items()}
    sampled = api.sample(0)
    orders, keys = api._round_orders(0, 2), api._round_keys(0, 2)
    plan = api._masked_packed_plan(sampled, None)
    tx, ty, tm = api._dev_train
    for pos in range(2):
        w = np.eye(2, dtype=np.float32)[pos]
        packed = api._packed_train(init, tx, ty, tm, sampled, w, orders, plan, keys).variables
        c = int(sampled[pos])
        plain = api._local_train(init, tx[c], ty[c], tm[c], int(ds.train_counts[c]),
                                 orders=orders[pos], key=int(keys[pos])).variables
        for k, v in plain.items():
            np.testing.assert_allclose(packed[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{impl} client {c} {k}")


def test_flax_variables_of_cnn_dropout_round_trip():
    state = create_model("cnn_dropout", 62).init(0, "cpu")
    back = flax_to_torch(torch_to_flax(state))
    assert all(torch.equal(back[k], state[k]) for k in state)
