"""The port's CIFAR ResNet against the JAX package's, weights converted.

A small CifarResNet (1 block per stage, widths 8/16/16, 8 images of 16x16)
is built with the JAX package's constructor, its init converted to the port,
and both run the train-mode forward, the masked classification loss and its
gradients, the batch-stat update and the eval forward on the same inputs.
At batch 8 the JAX stem and first stage run the Pallas BN kernel (interpret
mode); the smaller later stages take its XLA fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.core.tasks import classification_loss as jax_loss
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.core.tasks import classification_loss
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet, Conv


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (pa, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, pa
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bn_impl", ["pallas", "xla"])
def test_converter_round_trip_is_bit_exact(bn_impl):
    jb = jax_create_model("resnet20", 10, bn_impl=bn_impl)
    variables = _np_tree(jb.init(jax.random.key(0)))
    state = flax_to_torch(variables)
    # the converted state loads strictly into the port's model of that impl
    tb = create_model("resnet20", 10, bn_impl=bn_impl)
    tb.module.load_state_dict(state, strict=True)
    bn = "PallasBatchNorm" if bn_impl == "pallas" else "BatchNorm"
    _assert_trees_equal(torch_to_flax(tb.module.state_dict(), bn_name=bn), variables)
    # either flax BN class loads into either impl through bn_name
    other = "BatchNorm" if bn_impl == "pallas" else "PallasBatchNorm"
    renamed = flax_to_torch(variables, bn_name=other)
    assert all(("BatchNorm_" not in k) or (f"{other}_" in k) for k in renamed)
    _assert_trees_equal(torch_to_flax(renamed, bn_name=bn), variables)


def test_port_init_matches_flax_initialisers():
    """lecun_normal fan-in scale, zero biases, BN ones/zeros: the port's
    fresh weights have the statistics of flax's (not its bits)."""
    tb = create_model("resnet56", 10, bn_impl="pallas")
    state = tb.init(0, device="cpu")
    w = state["BasicBlock_20.Conv_1.weight"]            # 64 -> 64, 3x3
    std = np.sqrt(1.0 / (64 * 9))
    assert abs(float(w.std()) - std) / std < 0.05
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
    assert torch.equal(state["Dense_0.bias"], torch.zeros(10))
    assert torch.equal(state["PallasBatchNorm_0.var"], torch.ones(16))
    # the same seed draws the same weights
    assert torch.equal(tb.init(0, device="cpu")["Conv_0.weight"], state["Conv_0.weight"])


@pytest.mark.parametrize("bn_impl", ["pallas", "xla"])
def test_small_resnet_matches_jax(bn_impl):
    jmod = JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl=bn_impl)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)
    m = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    variables = _np_tree(jmod.init(jax.random.key(1), jnp.asarray(x), train=False))

    def loss_j(params):
        logits, upd = jmod.apply({**variables, "params": params}, x, train=True,
                                 mutable=["batch_stats"])
        return jax_loss(logits, y, m), (logits, upd)

    (l_j, (logits_j, upd_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        variables["params"])
    eval_j = jmod.apply({**variables, **upd_j}, x, train=False)

    model = CifarResNet(1, 10, widths=(8, 16, 16), bn_impl=bn_impl)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model.train()
    logits_t = model(torch.tensor(x))
    l_t = classification_loss(logits_t, torch.tensor(y), torch.tensor(m))
    l_t.backward()
    bn = "PallasBatchNorm" if bn_impl == "pallas" else "BatchNorm"

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    grads_t = torch_to_flax({k: p.grad for k, p in model.named_parameters()}, bn_name=bn)
    la, _ = jax.tree_util.tree_flatten_with_path(_np_tree(g_j))
    lb, _ = jax.tree_util.tree_flatten_with_path(grads_t["params"])
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))
    stats_t = torch_to_flax(dict(model.named_buffers()), bn_name=bn)["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(_np_tree(upd_j["batch_stats"]))[0],
                                 jax.tree_util.tree_flatten_with_path(stats_t)[0]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))
    model.eval()
    with torch.no_grad():
        eval_t = model(torch.tensor(x))
    np.testing.assert_allclose(eval_t.numpy(), np.asarray(eval_j), rtol=1e-5, atol=1e-5)


def test_stride2_conv_pads_like_flax_same():
    """flax SAME at 3x3 stride 2 on an even size pads (0, 1); PyTorch's
    symmetric padding=1 reads other pixels and gives other outputs."""
    import flax.linen as nn

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jconv = nn.Conv(6, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    variables = _np_tree(jconv.init(jax.random.key(0), x))
    y_j = np.asarray(jconv.apply(variables, x))
    conv = Conv(4, 6, 3, stride=2)
    w = torch.tensor(variables["params"]["kernel"].transpose(3, 2, 0, 1).copy())
    conv.weight.data.copy_(w)
    y_t = conv(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)
    sym = F.conv2d(torch.tensor(x).permute(0, 3, 1, 2), w, stride=2, padding=1)
    assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), y_j, atol=1e-3)
    # 1x1 stride-2 projections pad nothing
    jproj = nn.Conv(6, (1, 1), strides=(2, 2), use_bias=False)
    pv = _np_tree(jproj.init(jax.random.key(1), x))
    proj = Conv(4, 6, 1, stride=2)
    proj.weight.data.copy_(torch.tensor(pv["params"]["kernel"].transpose(3, 2, 0, 1).copy()))
    np.testing.assert_allclose(proj(torch.tensor(x)).detach().numpy(),
                               np.asarray(jproj.apply(pv, x)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("conv_impl,bn_impl,error", [("packed", "xla", NotImplementedError),
                                                     ("lanes", "pallas", ValueError)])
def test_unported_conv_impls_raise(conv_impl, bn_impl, error):
    """``packed`` is not ported; ``lanes`` runs the plain BN on its own
    layout and, as in the JAX package (models/resnet.py:226-229), refuses
    the BN kernel."""
    with pytest.raises(error):
        create_model("resnet56", 10, conv_impl=conv_impl, bn_impl=bn_impl)


def test_small_lanes_resnet_matches_jax():
    """A lanes CifarResNet (stages of width <= 32 on [N, C, H*W]; at 16x16
    stage 1's and stage 2's first conv pass ``supported()`` and run the JAX
    Pallas kernel in interpret mode, the rest its XLA fallback) against the
    JAX lanes model, at the tolerances of test_small_resnet_matches_jax.
    The variables come from the NHWC model's init: the trees are equal."""
    jmod = JaxCifarResNet(1, 10, widths=(8, 16, 16), conv_impl="lanes")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(8,)).astype(np.int32)
    m = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    variables = _np_tree(JaxCifarResNet(1, 10, widths=(8, 16, 16)).init(
        jax.random.key(1), jnp.asarray(x), train=False))

    def loss_j(params):
        logits, upd = jmod.apply({**variables, "params": params}, x, train=True,
                                 mutable=["batch_stats"])
        return jax_loss(logits, y, m), (logits, upd)

    (l_j, (logits_j, upd_j)), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        variables["params"])
    eval_j = jax.jit(lambda v: jmod.apply(v, x, train=False))({**variables, **upd_j})

    model = CifarResNet(1, 10, widths=(8, 16, 16), conv_impl="lanes")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model.train()
    logits_t = model(torch.tensor(x))
    l_t = classification_loss(logits_t, torch.tensor(y), torch.tensor(m))
    l_t.backward()

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    grads_t = torch_to_flax({k: p.grad for k, p in model.named_parameters()})
    la, _ = jax.tree_util.tree_flatten_with_path(_np_tree(g_j))
    lb, _ = jax.tree_util.tree_flatten_with_path(grads_t["params"])
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))
    stats_t = torch_to_flax(dict(model.named_buffers()))["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(_np_tree(upd_j["batch_stats"]))[0],
                                 jax.tree_util.tree_flatten_with_path(stats_t)[0]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))
    model.eval()
    with torch.no_grad():
        eval_t = model(torch.tensor(x))
    np.testing.assert_allclose(eval_t.numpy(), np.asarray(eval_j), rtol=1e-5, atol=1e-5)


def test_lanes_state_dict_equals_nhwc():
    """Same keys, shapes and module order as the NHWC model, so the
    converter and FedAvg's state handling need no change
    (tests/test_conv_lanes.py:80-87 pins the same for the JAX trees)."""
    nhwc = create_model("resnet20", 10).module.state_dict()
    lanes = create_model("resnet20", 10, conv_impl="lanes").module.state_dict()
    assert [(k, tuple(v.shape)) for k, v in lanes.items()] == \
        [(k, tuple(v.shape)) for k, v in nhwc.items()]


def test_resnet56_lanes_routes_36_convs_through_the_kernel(monkeypatch):
    """chip_smoke.py's lanes launch counts rest on this: at 32x32, stage 1's
    18 convs (16->16), stage 2's first (16->32 at 32x32) and its 17 others
    (32->32 at 16x16) take conv3x3_lanes; stage 3 (C = 64) stays NHWC."""
    from collections import Counter

    from fedml_tpu_torch.ops import conv_lanes

    seen = Counter()
    real = conv_lanes.conv3x3_lanes

    def counting(xf, weight, h, w):
        seen[(xf.shape[1], weight.shape[0], h, w)] += 1
        return real(xf, weight, h, w)

    monkeypatch.setattr(conv_lanes, "conv3x3_lanes", counting)
    model = create_model("resnet56", 10, conv_impl="lanes").module
    with torch.no_grad():
        model.eval()(torch.zeros(1, 32, 32, 3))
    assert seen == {(16, 16, 32, 32): 18, (16, 32, 32, 32): 1, (32, 32, 16, 16): 17}


def test_resnet56_has_57_train_mode_batchnorms():
    """chip_smoke.py's launch-count check rests on this: 1 stem BN, 2 per
    block over 27 blocks, 2 projection BNs."""
    from fedml_tpu_torch.models.norm import PallasBatchNorm

    m = create_model("resnet56", 10, bn_impl="pallas").module
    assert sum(isinstance(x, PallasBatchNorm) for x in m.modules()) == 57


def test_bundle_apply_train_and_eval_match_jax_bundle():
    """``ModelBundle.apply_train`` on a state dict returns the logits and
    the updated running stats without touching its input; on the module it
    updates in place; ``apply_eval`` reads the running stats. All three
    against the JAX bundle (rtol 1e-5 / atol 1e-5, as above)."""
    from fedml_tpu.models import ModelBundle as JaxModelBundle
    from fedml_tpu_torch.models import ModelBundle

    jb = JaxModelBundle("small", JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                        (8, 8, 3), has_batch_stats=True)
    variables = _np_tree(jb.init(jax.random.key(3)))
    x = np.random.default_rng(5).normal(size=(4, 8, 8, 3)).astype(np.float32)
    logits_j, new_j = jb.apply_train(variables, x, jax.random.key(0))
    eval_j = jb.apply_eval(new_j, x)

    tb = ModelBundle("small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"), (8, 8, 3))
    state = flax_to_torch(variables)
    before = {k: v.clone() for k, v in state.items()}
    logits_t, new_t = tb.apply_train(state, torch.tensor(x))
    assert all(torch.equal(state[k], before[k]) for k in state)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    want = jax.tree.map(np.asarray, new_j)["batch_stats"]
    got = torch_to_flax(new_t, bn_name="PallasBatchNorm")["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=str(path))
    with torch.no_grad():
        np.testing.assert_allclose(tb.apply_eval(new_t, torch.tensor(x)).numpy(),
                                   np.asarray(eval_j), rtol=1e-5, atol=1e-5)
        tb.module.load_state_dict(state)
        logits_m, module = tb.apply_train(tb.module, torch.tensor(x))
    assert module is tb.module
    np.testing.assert_allclose(logits_m.numpy(), logits_t.detach().numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(module.state_dict()["PallasBatchNorm_0.mean"], new_t["PallasBatchNorm_0.mean"])
