"""The BN zoo's MobileNets and VGG, and the shared layers, against the JAX
package on the CPU.

- ``mobilenet``, ``mobilenet_v3`` (small and large) at 16 x 16 and batch 4,
  ``vgg11`` at 32 x 32 (its five pools) and batch 2, full width, under
  ``bn_impl`` "xla" and "pallas" (K1/K2's plain version on the CPU), from
  the same weights: a
  train-mode forward, the gradient of the classification loss (one record
  masked) and the updated BN statistics (``torch_jax_refs.
  assert_zoo_step_matches``). The tolerance follows the reference's own
  conditioning: per tensor, the port's L2 distance from JAX may be no more
  than ten times JAX's own largest distance when every weight and input
  moves by a random 1e-6 (relative; 3 draws), plus 1e-4 of the tensor's
  norm and 1e-5 a sqrt(element); the loss the same way, with a 1e-5
  relative floor. Why: at initialization these nets' gradients are
  ill-conditioned (BN over 4 to 16 rows in the deep stages): one such draw
  moves JAX's own mobilenet BN gradients by up to 5.7e-2 (relative L2),
  and a mobilenet_v3 BN bias whose gradient is ~0 by ~1.5. The port's own
  distance there is 0.6x to 4.5x JAX's (the latter on a near-zero BN bias
  gradient of efficientnet-b2), so the gate's factor is 10.
- flax SAME padding at stride 2 (asymmetric, (0, 1) for a 3x3 and (1, 2)
  for a 5x5 on an even size), depthwise and VALID: ``models/layers.Conv``
  against ``flax.linen.Conv``, rtol 1e-5 / atol 1e-6.

The weights are the port's seeded init in both packages
(``models/convert.torch_to_flax``; the JAX package's own init of a net
traces for seconds). EfficientNet, the ResNet-56 variants and ResNet-18-GN
are in ``tests/test_torch_zoo_effnet.py``, the registry in
``tests/test_torch_zoo_registry.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.layers import Conv, same_pads
from torch_jax_refs import assert_zoo_step_matches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name,shape,n,kw", [
    ("mobilenet", (16, 16, 3), 4, {}),
    ("mobilenet_v3", (16, 16, 3), 4, {"mode": "small"}),
    ("mobilenet_v3", (16, 16, 3), 4, {"mode": "large"}),
    ("vgg11", (32, 32, 3), 2, {}),
])
def test_zoo_net_step_matches_jax(name, shape, n, kw, bn_impl):
    assert_zoo_step_matches(name, shape, n, bn_impl, kw)


@pytest.mark.parametrize("size,k,stride,groups,padding", [
    (16, 3, 2, 1, "SAME"), (16, 5, 2, 1, "SAME"), (15, 3, 2, 1, "SAME"),
    (16, 3, 2, 6, "SAME"), (16, 5, 2, 6, "SAME"), (7, 5, 1, 6, "SAME"),
    (12, 3, 1, 1, "VALID"), (16, 1, 2, 1, "SAME")])
def test_same_padding_matches_flax(size, k, stride, groups, padding):
    rng = np.random.default_rng(size * k + stride)
    x = rng.normal(size=(2, size, size + 1, 6)).astype(np.float32)
    jm = fnn.Conv(6, (k, k), strides=(stride, stride), padding=padding,
                  feature_group_count=groups, use_bias=True)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    v = jax.tree.map(lambda a: a + 0.1, v)              # a nonzero bias
    conv = Conv(6, 6, k, use_bias=True, stride=stride, groups=groups, padding=padding)
    conv.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, v)))
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_same_pads_are_asymmetric_at_stride_2():
    assert same_pads(32, 3, 2) == (0, 1) and same_pads(32, 5, 2) == (1, 2)
    assert same_pads(16, 1, 2) == (0, 0) and same_pads(7, 3, 1) == (1, 1)
