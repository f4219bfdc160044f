"""FedNAS's unrolled (second-order) architect: the port against the JAX
package, at tests/test_torch_fednas.py's sizes, state and orders (this
file holds the JAX package's second-order compile, ~55 s on the CPU, apart
from the first-order file's).

- One unrolled ``FedNASAPI`` round (each client's 2 search steps: the
  alpha gradient of the odd slots' loss at the weights after one SGD step
  on the even slots, through the real momentum trace, then the weight step
  on the even slots) under ``bn_impl`` "xla" and "pallas" (K1/K2's plain
  versions on the CPU, through the BN wrapper's differentiable backward):
  variables and alphas rtol 1e-4 / atol 1e-5, the loss rtol 1e-5, the
  genotype equal.
- The alpha gradient of each architect through ``bn_impl="pallas"`` equals
  the plain BN's (autograd through plain torch ops) at rtol 1e-4 / atol
  1e-4 of its largest entry (the two BNs' op orders part the states of a
  step by f32 rounding; the unrolled gradient reads them at ~2e-5 of its
  scale): the first-order one, and the unrolled one, which differentiates
  the BN backward itself.
- The unrolled architect moves the alphas otherwise than the first-order
  one from the same state (the second-order term is live).
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fednas import FedNASAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models.convert import alphas_to_flax
from test_torch_fednas import (DATA, RUN, SIZE, assert_round_matches, jax_round, port_round)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def unrolled():
    return jax_round(unrolled=True)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
def test_unrolled_round_matches_jax(unrolled, bn_impl):
    api, loss = port_round(unrolled, bn_impl, unrolled=True)
    assert api.unrolled
    assert_round_matches(api, loss, unrolled, bn_impl)


def _alpha_grads(bn_impl: str, unrolled_arch: bool) -> list:
    """The architect's gradient on client 0's first batch, from one seed's
    weights, after a weight step has filled the momentum trace."""
    ds = make_synthetic_classification(**DATA)
    api = FedNASAPI(ds, FedConfig(**RUN), **SIZE, bn_impl=bn_impl, unrolled=unrolled_arch,
                    device="cpu")
    if bn_impl == "pallas":
        ref = FedNASAPI(ds, FedConfig(**RUN), **SIZE, device="cpu")
        api.variables = {k.replace("BatchNorm", "PallasBatchNorm"): v
                         for k, v in ref.variables.items()}
    batch = [torch.from_numpy(a[0, :4]) for a in (ds.train_x, ds.train_y, ds.train_mask)]
    api._load(api.variables, api.alphas)
    prog = api.program()
    for src, dst in zip(batch, prog.inputs):
        dst.copy_(src)
    prog()                                    # a step: the trace is nonzero
    return [g.detach().numpy() for g in api._alpha_grads(*batch)]


@pytest.mark.parametrize("unrolled_arch", [False, True])
def test_alpha_gradient_through_the_bn_kernel_wrapper_equals_the_plain_bn(unrolled_arch):
    plain, kernel = _alpha_grads("xla", unrolled_arch), _alpha_grads("pallas", unrolled_arch)
    for a, b in zip(kernel, plain):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_unrolled_moves_the_alphas_otherwise(unrolled):
    first, _ = port_round(unrolled, "xla", unrolled=False)
    second, _ = port_round(unrolled, "xla", unrolled=True)
    a, b = alphas_to_flax(first.alphas), alphas_to_flax(second.alphas)
    assert max(np.abs(a[k] - b[k]).max() for k in a) > 1e-7
