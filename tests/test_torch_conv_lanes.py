"""The port's spatial-in-lanes conv (K3/K4/K7) against the JAX package's.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_conv_lanes.py does; the port's tensors lie on the CPU, so its
wrappers take the plain PyTorch versions (the CUDA kernels are held against
these on the card by chip_smoke.py). Tolerances are those of
tests/test_conv_lanes.py: forward 2e-5, gradients rtol 1e-4 / atol 1e-4
(dW atol 1e-4 of its largest entry). Layout helpers and weight matrices
are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import conv_lanes as jcl
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.ops import conv_lanes as cl

SHAPES = [(16, 16, 32, 32), (32, 32, 16, 16), (16, 32, 32, 32), (32, 64, 16, 16)]


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _oihw(k_hwio: np.ndarray) -> torch.Tensor:
    """A flax HWIO kernel through the weight converter."""
    return flax_to_torch({"params": {"Conv_0": {"kernel": k_hwio}}})["Conv_0.weight"]


def test_weight_matrix_and_layouts_are_bit_equal():
    k = _rand((3, 3, 12, 20), seed=1)
    w = _oihw(k)
    w2 = cl._w2(w)
    np.testing.assert_array_equal(w2.numpy(), np.asarray(jcl._w2(k)))
    dw2 = _rand((20, 9 * 12), seed=2)
    np.testing.assert_array_equal(cl._w2_inv(torch.tensor(dw2), 12, 20).numpy(),
                                  _oihw(np.asarray(jcl._w2_inv(dw2, 12, 20))).numpy())
    assert torch.equal(cl._w2_inv(w2, 12, 20), w)

    x = _rand((2, 6, 8, 5), seed=3)                     # NHWC
    xf = cl.to_lanes(torch.tensor(x))
    np.testing.assert_array_equal(xf.numpy(), np.asarray(jcl.to_lanes(x)))
    np.testing.assert_array_equal(cl.from_lanes(xf, 6, 8).numpy(),
                                  np.asarray(jcl.from_lanes(jnp.asarray(xf.numpy()), 6, 8)))
    for offset in (0, 1):
        np.testing.assert_array_equal(
            cl.subsample2(xf, 6, 8, offset).numpy(),
            np.asarray(jcl.subsample2(jnp.asarray(xf.numpy()), 6, 8, offset)))
    with pytest.raises(ValueError):
        cl.subsample2(torch.zeros(1, 1, 15), 3, 5)
    for args in [(16, 32, 32), (8, 16, 16), (12, 16, 16), (16, 8, 8), (16, 64, 64), (8, 16, 24)]:
        assert cl.supported(*args) == jcl.supported(*args), args
    for hw in (64, 1024, 4096, 8192):
        assert cl._tile(hw) == jcl._tile(hw)


@pytest.mark.parametrize("ci,co,h,w", SHAPES)
def test_fwd_matches_jax_kernel(ci, co, h, w):
    x = _rand((3, ci, h * w), seed=ci + co)
    k = _rand((3, 3, ci, co), seed=1, scale=0.1)
    want = np.asarray(jcl.conv3x3_lanes(jnp.asarray(x), jnp.asarray(k), h, w))
    got = cl.conv3x3_lanes(torch.tensor(x), _oihw(k), h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ci,co,h,w", SHAPES[:2])
def test_wgrad_matches_jax_kernel(ci, co, h, w):
    x = _rand((2, ci, h * w), seed=5)
    dy = _rand((2, co, h * w), seed=6)
    want = np.asarray(jcl._conv_wgrad(jnp.asarray(x), jnp.asarray(dy), h, w))
    got = cl.conv_wgrad_plain(torch.tensor(x), torch.tensor(dy), h, w)
    assert got.dtype == torch.float32 and got.shape == (co, 9 * ci)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_grads_match_jax():
    h = w = 32
    x = _rand((2, 16, h * w))
    k = _rand((3, 3, 16, 16), seed=1, scale=0.1)
    gx_j, gk_j = jax.jit(jax.grad(lambda x, k: jnp.sum(jnp.sin(jcl.conv3x3_lanes(x, k, h, w))),
                                  (0, 1)))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.tensor(x, requires_grad=True)
    wt = _oihw(k).requires_grad_(True)
    torch.sin(cl.conv3x3_lanes(xt, wt, h, w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    gk = _oihw(np.asarray(gk_j)).numpy()
    np.testing.assert_allclose(wt.grad.numpy(), gk, rtol=1e-4, atol=1e-4 * np.abs(gk).max())


def test_stride2_through_subsample_matches_same_stride2():
    h = w = 32
    x = _rand((2, 16, h * w))
    k = _rand((3, 3, 16, 32), seed=3, scale=0.1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x).reshape(2, 16, h, w), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NCHW", "HWIO", "NCHW"))
    got = cl.subsample2(cl.conv3x3_lanes(torch.tensor(x), _oihw(k), h, w), h, w, offset=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, 32, -1),
                               rtol=2e-5, atol=2e-5)


# (kernel_size, stride, Ci, Co, H, W); the last two fail supported() and
# take the plain conv on both sides
MODULE_CASES = [(3, 1, 16, 16, 16, 16), (3, 2, 8, 16, 16, 16), (1, 1, 16, 8, 16, 16),
                (1, 2, 8, 16, 16, 16), (3, 1, 12, 8, 16, 16), (3, 2, 16, 16, 8, 8)]


@pytest.mark.parametrize("k,s,ci,co,h,w", MODULE_CASES)
def test_conv_module_matches_jax(k, s, ci, co, h, w):
    x = _rand((2, ci, h * w), seed=7)
    jconv = jcl.Conv(co, hw=(h, w), kernel_size=k, strides=s)
    params = jax.tree.map(np.asarray, jconv.init(jax.random.key(0), jnp.asarray(x)))
    kern = params["params"]["kernel"]

    def loss_j(kern, x):
        return jnp.sum(jnp.sin(jconv.apply({"params": {"kernel": kern}}, x)))

    y_j = np.asarray(jax.jit(jconv.apply)(params, jnp.asarray(x)))
    gk_j, gx_j = jax.jit(jax.grad(loss_j, (0, 1)))(jnp.asarray(kern), jnp.asarray(x))

    conv = cl.Conv(ci, co, k, s)
    conv.weight.data.copy_(torch.tensor(kern.transpose(3, 2, 0, 1).copy()))
    xt = torch.tensor(x, requires_grad=True)
    y_t = conv(xt, (h, w))
    torch.sin(y_t).sum().backward()
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    gk = np.asarray(gk_j).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(conv.weight.grad.numpy(), gk, rtol=1e-4,
                               atol=1e-4 * np.abs(gk).max())


def test_bf16_weight_grad_is_rounded_to_the_compute_dtype():
    """As the JAX vjp casts dW to the kernel's dtype: with bf16 compute the
    f32 parameter's gradient is K4's f32 sum rounded to bf16."""
    h = w = 16
    x = torch.tensor(_rand((2, 8, h * w), seed=8)).to(torch.bfloat16)
    conv = cl.Conv(8, 8, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    y = conv(x, (h, w))
    assert y.dtype == torch.bfloat16
    dy = torch.tensor(_rand(tuple(y.shape), seed=9)).to(torch.bfloat16)
    y.backward(dy)
    want = cl._w2_inv(cl.conv_wgrad_plain(x, dy, h, w), 8, 8).to(torch.bfloat16).float()
    assert conv.weight.grad.dtype == torch.float32
    assert torch.equal(conv.weight.grad, want)


@pytest.mark.parametrize("ci,co", [(12, 8), (4, 20)])
def test_variant_plain_versions_match_their_definitions(ci, co):
    """K7: ``copy`` = the first Co channels; ``patches`` = the first Co rows
    of the patch matrix (row r: tap r // Ci, channel r % Ci, zero outside
    the image); ``kernel`` = K3 (lanes_probe.py:111-123)."""
    n, h, w = 2, 5, 7
    x = _rand((n, ci, h * w), seed=10)
    w2 = torch.tensor(_rand((co, 9 * ci), seed=11))
    xt = torch.tensor(x)
    img = x.reshape(n, ci, h, w)
    want = np.zeros((n, co, h, w), np.float32)
    for r in range(co):
        (dy, dx), c = cl.TAPS[r // ci], r % ci
        for yy in range(h):
            for xx in range(w):
                if 0 <= yy + dy < h and 0 <= xx + dx < w:
                    want[:, r, yy, xx] = img[:, c, yy + dy, xx + dx]
    got = cl.conv_variant("patches", xt, w2, h, w)
    np.testing.assert_array_equal(got.numpy(), want.reshape(n, co, h * w))
    if co <= ci:
        np.testing.assert_array_equal(cl.conv_variant("copy", xt, w2, h, w).numpy(), x[:, :co])
    assert torch.equal(cl.conv_variant("kernel", xt, w2, h, w), cl.conv_fwd_plain(xt, w2, h, w))
    with pytest.raises(ValueError):
        cl.conv_variant("dot", xt, w2, h, w)


def test_cuda_wrappers_refuse_cpu_tensors_and_plain_paths_do_not_count():
    cl.reset_launches()
    x = torch.zeros(1, 8, 16)
    w2 = torch.zeros(8, 72)
    with pytest.raises(ValueError, match="CUDA"):
        cl.conv_fwd_cuda(x, w2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cl.conv_wgrad_cuda(x, x, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cl.conv_variant_cuda("copy", x, w2, 4, 4)
    cl.conv_fwd(x, w2, 4, 4)
    cl.conv_wgrad(x, x, 4, 4)
    cl.conv_variant("patches", x, w2, 4, 4)
    assert cl.LAUNCHES == {"conv_fwd": 0, "conv_wgrad": 0, "conv_variant": 0}
