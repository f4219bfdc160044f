"""The port's fused BN(+ReLU) against the JAX package's Pallas kernel.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_batchnorm.py does; the port's tensors lie on the CPU, so its
wrapper takes the plain PyTorch forward and the closed-form backward (the
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py). Tolerances are those of tests/test_batchnorm.py: y 2e-5,
mean 1e-6, var 1e-5, gradients rtol 1e-5 / atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.norm import PallasBatchNorm as JaxPallasBatchNorm
from fedml_tpu.ops import batchnorm as jbn
from fedml_tpu.ops.batchnorm import fused_bn_relu as jax_fused_bn_relu
from fedml_tpu_torch.models.norm import PallasBatchNorm
from fedml_tpu_torch.ops import batchnorm as tbn

# the first two shapes tile, so the JAX side really runs the Pallas kernel;
# the third is ragged (the JAX side takes its XLA fallback)
SHAPES = [((4, 32, 32, 16), True), ((2, 2048, 8), False), ((5, 100, 24), True)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(C,)).astype(np.float32),
            rng.normal(size=(C,)).astype(np.float32))


@pytest.mark.parametrize("shape,relu", SHAPES)
def test_forward_and_grads_match_jax_kernel(shape, relu):
    x, g, b = _inputs(shape)

    y_j, m_j, v_j = jax.jit(lambda x, g, b: jax_fused_bn_relu(x, g, b, 1e-5, relu))(x, g, b)
    grads_j = jax.jit(jax.grad(
        lambda x, g, b: jnp.sum(jnp.sin(jax_fused_bn_relu(x, g, b, 1e-5, relu)[0])),
        argnums=(0, 1, 2)))(x, g, b)

    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    y_t, m_t, v_t = tbn.fused_bn_relu(xt, gt, bt, 1e-5, relu)
    torch.sin(y_t).sum().backward()

    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=2e-5)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    assert not m_t.requires_grad and not v_t.requires_grad
    for t, j in zip((xt.grad, gt.grad, bt.grad), grads_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("relu", [True, False])
def test_plain_backward_is_the_gradient_of_the_plain_forward(relu):
    """The closed-form backward equals autograd through the plain forward
    (f32 on the CPU: rtol 1e-5 / atol 1e-5)."""
    x, g, b = _inputs((3, 7, 5, 12), seed=1)
    dy = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    xt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    y, _, _, _ = tbn.bn_relu_fwd_plain(xt.reshape(-1, 12), gt, bt, 1e-5, relu)
    y.backward(torch.tensor(dy).reshape(-1, 12))
    with torch.no_grad():
        x2 = torch.tensor(x).reshape(-1, 12)
        y2, mean, rstd, _ = tbn.bn_relu_fwd_plain(x2, torch.tensor(g), torch.tensor(b), 1e-5, relu)
        dx, dg, db = tbn.bn_relu_bwd_plain(x2, y2, torch.tensor(dy).reshape(-1, 12),
                                           torch.tensor(g), mean, rstd, relu)
    for a, r in ((dx.reshape(x.shape), xt.grad), (dg, gt.grad), (db, bt.grad)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,relu", [((4, 32, 32, 16), True), ((4, 32, 32, 16), False),
                                        ((2, 16, 16, 32), True)])
def test_bf16_backward_matches_jax_kernel(shape, relu):
    """K2's bf16 numerics: the same bf16 x, y and dy and the same f32 mean
    and rstd through the plain backward (what the one-pass kernel computes:
    f32 sums, dx rounded once to bf16) and through the JAX package's fused
    BN VJP, whose Pallas kernel runs in interpret mode. dx within one bf16
    ulp (the sums run in other orders); dgamma and dbeta at the tolerances
    above."""
    x, g, b = _inputs(shape, seed=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    dyb = jnp.asarray(np.random.default_rng(5).normal(size=shape), jnp.bfloat16)
    y_j, mean_j, rstd_j, res = jbn._fwd(xb, jnp.asarray(g), jnp.asarray(b), 1e-5, relu)
    assert res[-1] is not None, "the JAX side must run its Pallas kernel"
    dx_j, dg_j, db_j = jbn._fused_bwd(1e-5, relu, res, (dyb, None, None))

    C = shape[-1]

    def t(a):
        return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).reshape(-1, C)

    dx_t, dg_t, db_t = tbn.bn_relu_bwd_plain(
        t(xb).to(torch.bfloat16), t(y_j).to(torch.bfloat16), t(dyb).to(torch.bfloat16),
        torch.tensor(g), t(mean_j)[0], t(rstd_j)[0], relu)
    assert dx_t.dtype == torch.bfloat16 and dx_j.dtype == jnp.bfloat16
    got = dx_t.float().numpy()
    want = np.asarray(dx_j.astype(jnp.float32)).reshape(-1, C)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.finfo(np.float32).tiny)
    assert np.all(np.abs(got - want) <= 2.0 ** (np.floor(np.log2(mag)) - 7))
    np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(db_t.numpy(), np.asarray(db_j), rtol=1e-5, atol=1e-3)


# ResNet-56's three widths at a small batch; 8x8x64 at batch 4, since at
# batch 2 its 128 rows fold into 64 lane rows, which the JAX side does not
# tile (it would take its XLA fallback, not the Pallas kernel)
BF16_FWD_SHAPES = [(2, 32, 32, 16), (2, 16, 16, 32), (4, 8, 8, 64)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", BF16_FWD_SHAPES)
def test_bf16_forward_matches_jax_kernel(shape, relu):
    """K1's bf16 numerics: the same bf16 x through the plain forward (what
    the one-pass kernel computes: f32 statistics, y in f32 rounded once to
    bf16) and through the JAX package's forward, whose Pallas kernel runs in
    interpret mode. y within one bf16 ulp (the statistics are summed in
    other orders, and the kernel's variance is E[x^2] - mean^2); mean and
    rstd at 1e-6 / 1e-5."""
    x, g, b = _inputs(shape, seed=6)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_j, mean_j, rstd_j, res = jbn._fwd(xb, jnp.asarray(g), jnp.asarray(b), 1e-5, relu)
    assert res[-1] is not None, "the JAX side must run its Pallas kernel"

    C = shape[-1]
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).reshape(-1, C).to(torch.bfloat16)
    y_t, mean_t, rstd_t, _ = tbn.bn_relu_fwd_plain(xt, torch.tensor(g), torch.tensor(b),
                                                   1e-5, relu)
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    got = y_t.float().numpy()
    want = np.asarray(y_j.astype(jnp.float32)).reshape(-1, C)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.finfo(np.float32).tiny)
    assert np.all(np.abs(got - want) <= 2.0 ** (np.floor(np.log2(mag)) - 7))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-6)
    np.testing.assert_allclose(rstd_t.numpy(), np.asarray(rstd_j), atol=1e-5)


@pytest.mark.parametrize("fuse_relu", [True, False])
def test_norm_module_running_stats_match_pallas_batchnorm(fuse_relu):
    """Two train steps update the running mean/var as flax does (momentum
    0.9 on the biased variance), then eval mode normalises with them."""
    x, _, _ = _inputs((4, 8, 8, 16), seed=3)
    x2 = 2.0 * x + 0.5
    mod_j = JaxPallasBatchNorm(use_running_average=False, fuse_relu=fuse_relu)
    variables = mod_j.init(jax.random.key(0), x)
    mod_t = PallasBatchNorm(16, fuse_relu=fuse_relu).train()
    for inp in (x, x2):
        y_j, upd = mod_j.apply(variables, inp, mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        y_t = mod_t(torch.tensor(inp))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), atol=2e-5)
        np.testing.assert_allclose(mod_t.mean.numpy(),
                                   np.asarray(variables["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(mod_t.var.numpy(),
                                   np.asarray(variables["batch_stats"]["var"]), atol=1e-5)
    ev_j = JaxPallasBatchNorm(use_running_average=True, fuse_relu=fuse_relu).apply(variables, x)
    ev_t = mod_t.eval()(torch.tensor(x))
    np.testing.assert_allclose(ev_t.detach().numpy(), np.asarray(ev_j), atol=2e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel wrapper by mistake: the wrapper
    raises instead of launching, and counts nothing."""
    x, g, b = (torch.tensor(a) for a in _inputs((64, 16)))
    before = dict(tbn.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bn_fwd_cuda(x, g, b)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bn_bwd_cuda(x, x, x, g, g, g)
    assert tbn.LAUNCHES == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from fedml_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_kernel_build_raises_on_a_failed_compile(monkeypatch, tmp_path):
    """A compiler that exits non-zero raises, and leaves no partial library."""
    import shutil

    from fedml_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="exited 1"):
        build.build()
    assert list(tmp_path.iterdir()) == []
