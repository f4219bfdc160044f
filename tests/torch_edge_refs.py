"""The edge slices' shared set-up for the parity tests of the FedAvg edge
and FedBuff (tests/test_torch_fedavg_edge.py, tests/test_torch_fedbuff.py):
JAX's equivalence set-up (tests/test_fedavg_edge.py:41-60), the two
packages' bundles of ``lr`` and the CI-size CifarResNet, the leafwise and
history comparisons at JAX's tolerances, and a probe for free ports."""

import jax
import numpy as np
import torch

from fedml_tpu.models import ModelBundle as JaxModelBundle
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.models.convert import torch_to_flax
from fedml_tpu_torch.models.resnet import CifarResNet

#: JAX's tolerance of the edge's weights (tests/test_fedavg_edge.py:70-77)
TOL = dict(rtol=1e-5, atol=1e-6)


def equiv(model: str):
    """JAX's equivalence set-up (full-batch epochs, one client a worker) for
    ``lr`` on 8 features or the CI ResNet on 8x8x3 images: (data kwargs,
    run kwargs, workers)."""
    shape, classes = ((8,), 3) if model == "lr" else ((8, 8, 3), 10)
    data = dict(name=f"edge-eq-{model}", input_shape=shape, classes=classes, num_clients=8,
                records_per_client=12, partition_method="hetero", partition_alpha=0.5,
                batch_size=12, seed=4)
    n_pad = make_synthetic_classification(**data).train_x.shape[1]
    workers = 4 if model == "lr" else 2
    run = dict(model=model, dataset=data["name"], client_num_in_total=8,
               client_num_per_round=workers, comm_round=4 if model == "lr" else 2,
               batch_size=int(n_pad), lr=0.2 if model == "lr" else 0.05, momentum=0.9,
               epochs=2, frequency_of_the_test=1, seed=11, device_data="off")
    return data, run, workers


def port_bundle(model: str):
    if model == "lr":
        return create_model("lr", 3, input_shape=(8,))
    return ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                       (8, 8, 3))


def jax_bundle(model: str):
    if model == "lr":
        return jax_create_model("lr", 3, input_shape=(8,))
    return JaxModelBundle(name="cifar-small",
                          module=JaxCifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                          input_shape=(8, 8, 3), has_batch_stats=True)


def to_flax(model: str, variables: dict) -> dict:
    bn = None if model == "lr" else "PallasBatchNorm"
    return torch_to_flax({k: torch.as_tensor(v) for k, v in variables.items()}, bn_name=bn)


def assert_tree_close(got: dict, want: dict, **tol):
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol, err_msg=str(path))


def assert_history_close(got: list, acc: list, loss: list, rounds: list):
    assert [h["round"] for h in got] == rounds
    np.testing.assert_allclose([h["acc"] for h in got], acc, rtol=1e-6)
    np.testing.assert_allclose([h["loss"] for h in got], loss, rtol=1e-4)


def same(a, b):
    assert a.test_history == b.test_history
    for k in a.variables:
        np.testing.assert_array_equal(a.variables[k], b.variables[k], err_msg=k)


def free_base(n: int) -> int:
    """A base port whose block of ``n`` ports was free when probed."""
    import socket

    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n < 65000:
            return base
