"""Model zoo registry (counterpart of ``fedml_tpu/models/__init__.py``).

``create_model(name, ...)`` returns a :class:`ModelBundle`: the
``nn.Module`` plus functions over flat state dicts (``variables``:
parameters and BatchNorm running statistics), so the algorithms handle a
model's state as data.

``bn_impl`` keeps the JAX package's values so launch lines carry over:
``"xla"`` is the plain PyTorch BatchNorm (autograd through torch ops);
``"pallas"`` is the hand-written fused BN(+ReLU) kernel pair
(``ops/batchnorm.py``), which runs its plain version for CPU tensors.
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
        ``new_state`` is the module. ``rng`` is unused: the ported models
        have no dropout."""
        if isinstance(variables, nn.Module):
            variables.train()
            return variables(x), variables
        buffers = {name for name, _ in self.module.named_buffers()}
        state = {k: (v.clone() if k in buffers else v) for k, v in variables.items()}
        self.module.train()
        logits = functional_call(self.module, state, (x,))
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
    from fedml_tpu_torch.models import (cnn, linear, resnet, segmentation,  # noqa: F401
                                        transformer)

    if model_name not in _REGISTRY:
        raise KeyError(f"unknown or unported model {model_name!r}; known: {sorted(_REGISTRY)}")
    bundle = _REGISTRY[model_name](output_dim=output_dim, input_shape=input_shape, **kw)
    if input_shape is not None:
        bundle.input_shape = tuple(input_shape)
    return bundle
