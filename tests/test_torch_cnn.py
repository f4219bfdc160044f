"""The ``cnn`` model (CNNOriginalFedAvg) against the JAX package's.

- Forward on flat 784-vectors, on 28x28x1 images and on 12x12x1 images,
  from the JAX model's weights converted by ``models/convert.py``: rtol
  1e-5 / atol 1e-5 (f32; the convs sum in another order).
- The lane-stacked twin equals L separate models, each lane from its own
  weights: logits rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5
  (tests/test_torch_packed.py's gradient tolerance; the grouped conv sums
  in another order).
- The packed ``cnn`` round (``pack_lanes=2``) replays the plain round in
  f32: losses rtol 1e-5, variables rtol 1e-4 / atol 1e-5, the tolerance of
  tests/test_torch_packed.py's packed-vs-plain rounds.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch


@pytest.mark.parametrize("shape", [(784,), (28, 28, 1), (12, 12, 1)])
def test_forward_matches_jax(shape):
    jb = jax_create_model("cnn", 10, input_shape=shape)
    jv = jb.init(jax.random.key(1))
    x = np.random.default_rng(0).normal(size=(5,) + shape).astype(np.float32)
    want = np.asarray(jb.apply_eval(jv, x))
    bundle = create_model("cnn", 10, input_shape=shape)
    state = flax_to_torch(jax.tree.map(np.asarray, jv))
    assert sorted(state) == sorted(bundle.module.state_dict())
    bundle.module.load_state_dict(state)
    got = bundle.module(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lane_stacked_twin_equals_separate_models():
    shape = (12, 12, 1)
    models = [create_model("cnn", 7, input_shape=shape).module for _ in range(2)]
    for i, m in enumerate(models):
        m.reset_parameters(torch.Generator().manual_seed(i))
    twin = models[0].lane_stacked(2)
    twin.load_state_dict({k: torch.cat([m.state_dict()[k] for m in models])
                          for k in models[0].state_dict()})
    x = torch.randn(2, 6, *shape, generator=torch.Generator().manual_seed(9))
    out = twin(x)
    assert out.shape == (2, 6, 7)
    out.square().sum().backward()
    for lane, m in enumerate(models):
        ref = m(x[lane])
        np.testing.assert_allclose(out[lane].detach().numpy(), ref.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        ref.square().sum().backward()
        for (name, p), (_, tp) in zip(m.named_parameters(), twin.named_parameters()):
            g = tp.grad.reshape(2, -1, *p.shape[1:])[lane]
            np.testing.assert_allclose(g.numpy(), p.grad.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_packed_round_replays_the_plain_round():
    ds = make_synthetic_classification("cnn-pack", (12, 12, 1), 5, 4, records_per_client=12,
                                       partition_method="hetero", partition_alpha=0.5,
                                       batch_size=4, seed=1)
    run = dict(model="cnn", dataset="cnn-pack", client_num_in_total=4, client_num_per_round=3,
               comm_round=2, batch_size=4, epochs=2, lr=0.05, momentum=0.9, seed=0,
               device_data="on")
    plain = FedAvgAPI(ds, FedConfig(**run), device="cpu")
    pk = FedAvgAPI(ds, FedConfig(**run, pack_lanes=2), device="cpu")
    pk.variables = {k: v.clone() for k, v in plain.variables.items()}
    assert pk.packed_status()["scheduled"]
    for r in range(2):
        np.testing.assert_allclose(pk.run_round(r), plain.run_round(r), rtol=1e-5)
        for k, v in plain.variables.items():
            np.testing.assert_allclose(pk.variables[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_cnn_dropout_raises():
    with pytest.raises(NotImplementedError, match="dropout"):
        create_model("cnn_dropout", 62)
