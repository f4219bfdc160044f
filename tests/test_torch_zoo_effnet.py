"""EfficientNet, the ResNet-56 width and no-norm variants and ResNet-18-GN
against the JAX package on the CPU, as ``tests/test_torch_zoo.py`` holds
the MobileNets and VGG (same helper, same noise-relative tolerance,
``torch_jax_refs.assert_zoo_step_matches``): a train-mode forward, the
gradient of the loss and the updated BN statistics, under ``bn_impl``
"xla" and "pallas", at 16 x 16 and batch 4 (EfficientNet) or 2.

EfficientNet drops in train mode (stochastic depth on its residual blocks,
dropout before the head). The JAX package draws those masks from flax's
``'dropout'`` stream; here its ``jax.random.bernoulli`` hands out masks
drawn in the test, in call order, and the port is handed the same masks
at its call sites (``ops/dropout.injected_masks``), so parity holds
through the masks. ResNet-18-GN checks flax's GroupNorm (epsilon 1e-6,
contiguous groups) in the same step.
"""

import pytest
import torch

from torch_jax_refs import assert_zoo_step_matches, jax_zoo_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name,n", [("efficientnet-b0", 4), ("efficientnet-b2", 4),
                                    ("resnet56_w64", 2), ("resnet56_nonorm", 2),
                                    ("resnet18_gn", 2)])
def test_zoo_net_step_matches_jax(name, n, bn_impl):
    assert_zoo_step_matches(name, (16, 16, 3), n, bn_impl)


def test_efficientnet_masks_are_its_dropout_sites():
    """b0 at 16 x 16: the JAX net drew one mask a residual block with a
    nonzero drop rate, per sample, and one for the head, in forward order:
    the port's call sites."""
    from fedml_tpu_torch.models import create_model

    masks = jax_zoo_step("efficientnet-b0", (16, 16, 3), 4)[4]
    module = create_model("efficientnet-b0", 10).module
    assert len(masks) == module.dropout_sites == 10
    assert all(m.shape == (4, 1, 1, 1) for m in masks[:-1]) and masks[-1].shape == (4, 1280)
