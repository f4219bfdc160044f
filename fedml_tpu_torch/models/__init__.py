"""Model zoo registry (counterpart of ``fedml_tpu/models/__init__.py``).

``create_model(name, ...)`` returns a :class:`ModelBundle`: the
``nn.Module`` plus functions over flat state dicts (``variables``:
parameters and BatchNorm running statistics), so the algorithms handle a
model's state as data.

``bn_impl`` keeps the JAX package's values so launch lines carry over:
``"xla"`` is the plain PyTorch BatchNorm (autograd through torch ops);
``"pallas"`` is the hand-written fused BN(+ReLU) kernel pair
(``ops/batchnorm.py``), which runs its plain version for CPU tensors. The
port's BN nets take it (the CIFAR ResNets and their width variants,
MobileNet v1 / v3, VGG, EfficientNet, deeplab_lite, unet); the JAX
package's zoo nets run flax's BatchNorm alone.

Dropout is explicit-key (``ops/dropout.py``): a model with dropout takes
``forward(x, dropout_key=...)``, the step's int64 key (``[L]`` lane keys
for a lane-stacked twin), and raises in train mode without one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.func import functional_call

_REGISTRY: dict[str, Callable[..., "ModelBundle"]] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


@dataclass
class ModelBundle:
    name: str
    module: nn.Module
    input_shape: tuple            # single-example shape, no batch dim
    task: str = "classification"  # the task family it is built for (core/tasks.py)
    #: the module drops out in train mode and takes ``dropout_key``
    uses_dropout: bool = False
    #: its dropout is the JAX package's explicit-key ``seed_dropout``
    #: (``cnn_dropout``), so its lane-stacked twin replays each lane's masks
    #: from the lane's key; a dropout model without it (flax-rng dropout in
    #: the JAX package: EfficientNet, the transformer) keeps the per-lane
    #: fallback under ``packed_conv`` (``parallel/packed.packed_fallback_reason``)
    explicit_dropout: bool = False

    @property
    def packed_twin(self) -> bool:
        """Whether the module's lane-stacked twin takes the joint packed
        lowerings, ``module.lane_stacked(L, packed_impl=...)`` (the JAX
        bundle's ``packed_variant`` is not None): the NHWC CIFAR ResNets and
        ``cnn``."""
        return bool(getattr(self.module, "packed_twin", False))

    def init(self, seed: Union[int, torch.Generator] = 0,
             device: Optional[Union[str, torch.device]] = None) -> dict:
        """Draw fresh weights from ``seed`` into the module, move it to
        ``device`` and return a copy of its state dict."""
        from fedml_tpu_torch import default_device

        g = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
        self.module.to("cpu")
        self.module.reset_parameters(g)
        self.module.to(default_device(device))
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def apply_train(self, variables: Union[dict, nn.Module], x: torch.Tensor, rng=None):
        """Train-mode forward; returns ``(logits, new_state)``. Given a
        state dict, the module runs functionally on it and ``new_state``
        holds the updated running statistics (the input dict is not
        changed). Given the module itself, it runs in place and
        ``new_state`` is the module. ``rng`` is the step's dropout key (an
        int64 tensor, ``ops/dropout.py``), passed to a dropout model as
        ``dropout_key`` and unused by the others."""
        kwargs = {"dropout_key": rng} if self.uses_dropout else {}
        if isinstance(variables, nn.Module):
            variables.train()
            return variables(x, **kwargs), variables
        buffers = {name for name, _ in self.module.named_buffers()}
        state = {k: (v.clone() if k in buffers else v) for k, v in variables.items()}
        self.module.train()
        logits = functional_call(self.module, state, (x,), kwargs)
        return logits, state

    def apply_eval(self, variables: Union[dict, nn.Module], x: torch.Tensor) -> torch.Tensor:
        module = variables if isinstance(variables, nn.Module) else self.module
        module.eval()
        if isinstance(variables, nn.Module):
            return module(x)
        return functional_call(module, variables, (x,))


def create_model(model_name: str, output_dim: int,
                 input_shape: Optional[Sequence[int]] = None, **kw) -> ModelBundle:
    """Factory keyed by the reference's --model flag values. Every factory
    takes ``input_shape`` (None: its default); ``lr`` sizes its layer by it."""
    _import_zoo()
    if model_name not in _REGISTRY:
        raise KeyError(f"unknown or unported model {model_name!r}; known: {sorted(_REGISTRY)}")
    bundle = _REGISTRY[model_name](output_dim=output_dim, input_shape=input_shape, **kw)
    if input_shape is not None:
        bundle.input_shape = tuple(input_shape)
    return bundle


def _import_zoo() -> None:
    from fedml_tpu_torch.models import (cnn, efficientnet, linear, mobilenet,  # noqa: F401
                                        resnet, resnet_gn, rnn, segmentation, transformer, vgg)


def known_models() -> list[str]:
    """Every registered model name (the JAX package's ``known_models``)."""
    _import_zoo()
    return sorted(_REGISTRY)
