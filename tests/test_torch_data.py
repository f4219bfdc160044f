"""The port's numpy data path is bit-equal to the JAX package's, and its
state-dict math and task functions agree with the JAX versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import partition as jpart
from fedml_tpu.core.pytree import tree_weighted_mean as jax_weighted_mean
from fedml_tpu.core.tasks import classification_loss as jax_loss
from fedml_tpu.core.tasks import classification_metrics as jax_metrics
from fedml_tpu.data import batching as jbatch
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.parallel.local import finalize_metrics as jax_finalize
from fedml_tpu_torch.core import partition as tpart
from fedml_tpu_torch.core.pytree import tree_stack, tree_weighted_mean
from fedml_tpu_torch.core.tasks import classification_loss, classification_metrics
from fedml_tpu_torch.data import batching as tbatch
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.parallel.local import finalize_metrics


def _assert_maps_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("alpha,clients,seed", [(0.5, 32, 0), (0.1, 10, 3), (100.0, 7, 1)])
def test_hetero_partition_is_bit_equal(alpha, clients, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 3000).astype(np.int32)
    _assert_maps_equal(tpart.partition("hetero", labels, clients, 10, alpha, seed=seed),
                       jpart.partition("hetero", labels, clients, 10, alpha, seed=seed))


@pytest.mark.parametrize("n,clients", [(1000, 32), (17, 4)])
def test_homo_partition_is_bit_equal(n, clients):
    _assert_maps_equal(tpart.homo_partition(n, clients, seed=2),
                       jpart.homo_partition(n, clients, seed=2))


def test_partition_refuses_unported_methods():
    with pytest.raises(ValueError):
        tpart.partition("hetero-fix", np.zeros(10, np.int32), 2, 10, 0.5)


def test_pad_and_stack_and_eval_pool_are_bit_equal():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(n, 4, 4, 3)).astype(np.float32) for n in (5, 13, 1, 8)]
    ys = [rng.integers(0, 10, len(x)).astype(np.int32) for x in xs]
    for a, b in zip(tbatch.pad_and_stack_clients(xs, ys, 4),
                    jbatch.pad_and_stack_clients(xs, ys, 4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tbatch.pad_eval_pool(xs[1], ys[1], 8), jbatch.pad_eval_pool(xs[1], ys[1], 8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,label_noise", [("hetero", 0.0), ("homo", 0.2)])
def test_synthetic_cifar_shaped_data_is_bit_equal(method, label_noise):
    kw = dict(name="cifar10-bench", input_shape=(32, 32, 3), classes=10, num_clients=8,
              records_per_client=20, test_records=100, partition_method=method,
              partition_alpha=0.5, batch_size=8, seed=4, label_noise=label_noise)
    a, b = make_synthetic_classification(**kw), jax_synthetic(**kw)
    for f in ("train_x", "train_y", "train_mask", "train_counts", "test_x", "test_y",
              "test_mask"):
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.class_num == b.class_num and a.num_clients == b.num_clients


def test_weighted_mean_matches_jax():
    """f32 weights normalised in f32, leaves summed in f32 and cast back:
    rtol 1e-6 for f32 leaves; a bf16 leaf rounds the same way (exact)."""
    rng = np.random.default_rng(1)
    leaves = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
              "b": rng.normal(size=(5, 7)).astype(np.float32)}
    w = np.array([3, 0, 10, 1, 7], np.float32)
    want = jax_weighted_mean({k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(w))
    got = tree_weighted_mean(
        tree_stack([{k: torch.tensor(v[i]) for k, v in leaves.items()} for i in range(5)]),
        torch.tensor(w))
    for k in leaves:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    bf = tree_weighted_mean({"c": torch.tensor(leaves["b"]).to(torch.bfloat16)}, torch.tensor(w))
    assert bf["c"].dtype == torch.bfloat16
    bf_j = jax_weighted_mean({"c": jnp.asarray(leaves["b"]).astype(jnp.bfloat16)}, jnp.asarray(w))
    np.testing.assert_array_equal(bf["c"].float().numpy(), np.asarray(bf_j["c"], np.float32))


def test_classification_loss_and_metrics_match_jax():
    """Masked mean loss and metric sums in f32: rtol 1e-6."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    m = (rng.random(16) > 0.3).astype(np.float32)
    lt = classification_loss(torch.tensor(logits), torch.tensor(y), torch.tensor(m))
    np.testing.assert_allclose(float(lt), float(jax_loss(logits, y, m)), rtol=1e-6)
    mt = classification_metrics(torch.tensor(logits), torch.tensor(y), torch.tensor(m))
    mj = jax_metrics(logits, y, m)
    assert sorted(mt) == sorted(mj)
    for k in mt:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6)
    assert finalize_metrics({k: float(v) for k, v in mt.items()}) == pytest.approx(
        jax_finalize({k: float(v) for k, v in mj.items()}), rel=1e-6)
