"""The port's fused cross-entropy (K5's plain version on CPU tensors)
against the JAX package's Pallas kernel in interpret mode.

Tolerances are the JAX package's own (tests/test_ops_sequence.py): 1e-5
for the masked 64x96 case and the closed-form gradient, 1e-4 for the odd
vocab of 1003.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import xent as tx

jx = importlib.import_module("fedml_tpu.ops.xent")


def test_masked_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(64, 96)).astype(np.float32)
    labels = rng.integers(0, 96, size=(64,)).astype(np.int32)
    mask = rng.integers(0, 2, size=(64,)).astype(np.float32)
    want = jx.masked_cross_entropy(logits, labels, mask, impl="pallas", interpret=True,
                                   block_n=16, block_v=32)
    got = tx.masked_cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                  torch.tensor(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_odd_vocab_matches_pallas_interpret():
    """V = 1003: the TPU kernel pads V to a block multiple with -1e30
    columns; the port needs no padding (atol 1e-4)."""
    rng = np.random.default_rng(7)
    v = 1003
    logits = rng.normal(size=(8, v)).astype(np.float32)
    labels = rng.integers(0, v, size=(8,)).astype(np.int32)
    want = jx.masked_cross_entropy(logits, labels, impl="pallas", interpret=True,
                                   block_n=8, block_v=256)
    got = tx.masked_cross_entropy(torch.tensor(logits), torch.tensor(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_closed_form_gradient_matches_jax():
    """softmax - onehot, scaled by the incoming cotangent (atol 1e-5)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(16, 12)).astype(np.float32)
    labels = rng.integers(0, 12, size=(16,)).astype(np.int32)
    w = rng.normal(size=(16,)).astype(np.float32)

    def f(lg):
        return jnp.sum(jx.masked_cross_entropy(lg, labels, impl="pallas", interpret=True) * w)

    want = jax.grad(f)(logits)
    lt = torch.tensor(logits, requires_grad=True)
    (tx.masked_cross_entropy(lt, torch.tensor(labels)) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), atol=1e-5)


def test_sequence_shaped_input_and_mask():
    """[B, T, V] logits with a [B, T] mask give [B, T] losses, equal to
    the JAX XLA path (atol 1e-5)."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 8, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.7).astype(np.float32)
    want = jx.masked_cross_entropy(logits, labels, mask, impl="xla")
    got = tx.masked_cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                  torch.tensor(mask))
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bf16_logits_give_f32_loss_and_bf16_gradient():
    """JAX casts dlogits to the logits' dtype; the loss stays f32."""
    rng = np.random.default_rng(5)
    logits = torch.tensor(rng.normal(size=(6, 20)).astype(np.float32)).to(torch.bfloat16)
    labels = torch.tensor(rng.integers(0, 20, size=(6,)))
    lt = logits.clone().requires_grad_(True)
    per = tx.masked_cross_entropy(lt, labels)
    assert per.dtype == torch.float32
    per.sum().backward()
    assert lt.grad.dtype == torch.bfloat16
    want = torch.softmax(logits.float(), -1) - torch.nn.functional.one_hot(labels, 20)
    np.testing.assert_array_equal(lt.grad.float().numpy(), want.to(torch.bfloat16).float().numpy())


def test_cpu_tensors_never_reach_the_kernel():
    tx.reset_launches()
    logits, labels = torch.zeros(4, 7), torch.zeros(4, dtype=torch.int32)
    for impl in ("auto", "pallas", "xla"):
        tx.masked_cross_entropy(logits, labels, impl=impl)
    assert tx.LAUNCHES["xent"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tx.xent_cuda(logits, labels)
