"""The port's model registry against the JAX package's, on the CPU.

- Every name of the JAX package's registry builds in the port, with the
  JAX package's parameter paths and shapes (``jax.eval_shape`` of its
  init), under ``bn_impl`` "xla" and "pallas" (``PallasBatchNorm_i`` paths
  renamed), and ``flax_to_torch(torch_to_flax(state))`` is bit-exact: the
  depthwise ``[k, k, 1, C]`` kernels, conv biases, GroupNorm ``scale`` /
  ``bias``, ``Embed_0.embedding`` and the eight LSTM leaves map by path.
- The BN counts of the zoo nets (one K1 and one K2 a BN and step under
  ``bn_impl="pallas"``) are the JAX nets' (``chip_smoke.ZOO_BNS``), and the
  timed arms' K1 calls by (rows, C, relu) are ``chip_smoke.ZOO_BN_SHAPES``
  (rows scaled from batch 2 to 64), their channels the JAX nets' BNs'.
"""

import collections
import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models import known_models as jax_known_models
from fedml_tpu_torch.models import create_model, known_models
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax


def _kw(name):
    return {"seq_len": 8} if name.startswith(("rnn", "transformer")) else {}


@functools.lru_cache(maxsize=None)
def _jax_shapes(name: str, kw: tuple = ()) -> dict:
    """``jax.eval_shape`` of the JAX package's init of ``name``."""
    jb = jax_create_model(name, 10, **_kw(name), **dict(kw))
    return jax.eval_shape(lambda k: jb.init(k), jax.random.key(0))


def _state(name: str, bn_impl: str) -> dict:
    """The port's state dict of ``name`` filled with seeded normals (a
    net's own init draws truncated normals, seconds for EfficientNet-b7)."""
    g = torch.Generator().manual_seed(0)
    module = create_model(name, 10, bn_impl=bn_impl, **_kw(name)).module
    return {k: torch.randn(v.shape, generator=g) for k, v in module.state_dict().items()}


def _paths(flax: dict) -> dict:
    return {"/".join(str(p.key) for p in path): tuple(np.shape(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(flax)[0]}


@pytest.mark.parametrize("name", jax_known_models())
def test_every_jax_model_builds_with_its_parameter_paths(name):
    assert name in known_models()
    want = _paths(_jax_shapes(name))
    # under bn_impl="pallas" the BN paths are PallasBatchNorm_i: the same
    # tree once renamed, and the same bit-exact round trip
    for bn_impl, bn in (("xla", None), ("pallas", "PallasBatchNorm")):
        state = _state(name, bn_impl)
        flax = torch_to_flax(state, bn_name=bn and "BatchNorm")
        assert _paths(flax) == want
        back = flax_to_torch(flax, bn_name=bn)
        assert set(back) == set(state)
        assert all(torch.equal(back[k], state[k]) for k in state)


@pytest.mark.parametrize("name,kw,bns", [
    ("mobilenet", {}, 27), ("mobilenet_v3", {"mode": "small"}, 34),
    ("mobilenet_v3", {"mode": "large"}, 46), ("vgg11", {}, 8), ("vgg16", {}, 13),
    ("vgg19", {}, 16), ("efficientnet-b0", {}, 49), ("efficientnet-b2", {}, 69),
    ("efficientnet-b7", {}, 163), ("resnet56_w64", {}, 57), ("resnet56_nonorm", {}, 0)])
def test_zoo_bn_counts_match_jax(name, kw, bns):
    from fedml_tpu_torch.models.norm import PallasBatchNorm

    shapes = _jax_shapes(name, tuple(kw.items()))
    jax_bns = len(jax.tree.leaves(shapes.get("batch_stats", {}))) // 2
    module = create_model(name, 10, bn_impl="pallas", **kw).module
    kernel = sum(isinstance(m, PallasBatchNorm) and m.use_kernel for m in module.modules())
    assert jax_bns == kernel == bns


@pytest.mark.parametrize("name", chip_smoke.ZOO_TIMED)
def test_zoo_bn_shapes_match_chip_smoke(name):
    """The shapes chip_smoke holds K1/K2 to on the card are the net's."""
    bundle = create_model(name, 10, input_shape=(32, 32, 3), bn_impl="pallas")
    bundle.init(0, "cpu")
    got = chip_smoke.record_bn_shapes(bundle, batch=2)
    want = chip_smoke.ZOO_BN_SHAPES[name]
    assert {(n * 32, C, relu): k for (n, C, relu), k in got.items()} == want
    stats = _jax_shapes(name).get("batch_stats", {})
    jax_channels = collections.Counter(
        leaf.shape[-1] for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]
        if path[-1].key == "mean")
    channels = collections.Counter()
    for (_, C, _), k in want.items():
        channels[C] += k
    assert channels == jax_channels
