"""The LM train step (counterpart of ``fedml_tpu/parallel/sequence.py``),
at world size 1.

``make_sp_lm_train_step`` on a (dp=1, sp=1) mesh: the whole sequence sits
on one device, the module takes the plain ``attention`` call (kernel K6),
and the loss runs through ``masked_cross_entropy`` (kernel K5), as the JAX
step does with ``ring_size=1``. No collective runs.

Not ported yet, and refused with ``NotImplementedError``: ring and Ulysses
attention and any mesh larger than 1x1; they need ``torch.distributed``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from fedml_tpu_torch.core.optim import Optimizer
from fedml_tpu_torch.ops.xent import masked_cross_entropy

_UNPORTED = ("sequence parallelism (ring/Ulysses attention over an 'sp' axis) is not "
             "ported yet")


def ring_attention(q, k, v, *, axis_name: str, axis_size: int, causal: bool = True,
                   sm_scale=None, impl: str = "auto"):
    raise NotImplementedError(_UNPORTED)


def ulysses_attention(q, k, v, *, axis_name: str, axis_size: int, causal: bool = True,
                      sm_scale=None, impl: str = "auto"):
    raise NotImplementedError(_UNPORTED)


def sequence_attention(q, k, v, *, axis_name: str, axis_size: int, mode: str = "ring", **kw):
    raise NotImplementedError(_UNPORTED)


def sp_mesh(n_dp: int, n_sp: int) -> tuple[int, int]:
    """The (dp, sp) mesh shape; only (1, 1) is ported."""
    if (n_dp, n_sp) != (1, 1):
        raise NotImplementedError(f"a ({n_dp}, {n_sp}) mesh: {_UNPORTED}")
    return n_dp, n_sp


def make_sp_lm_train_step(module: nn.Module, mesh: tuple[int, int] = (1, 1), *,
                          attn_impl: str = "auto") -> Callable:
    """Build the LM train step ``step(opt, x, y, mask) -> loss``.

    ``module`` is a ``TransformerLM``; ``opt`` an optimizer bound to its
    parameters (``make_optimizer(...)(module.parameters())``), which holds
    the variables and the optimizer state that the JAX step threads through
    and donates: here both are updated in place. ``x``/``y`` are
    ``[B, T]`` token ids, ``mask`` ``[B, T]``. The loss is the masked
    cross-entropy summed over tokens over ``max(sum(mask), 1)``; the
    returned loss is a detached 0-dim tensor (no host sync)."""
    sp_mesh(*mesh)

    def step(opt: Optimizer, x, y, mask) -> torch.Tensor:
        total = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
        module.train()
        logits = module(x, pos_offset=0)
        per = masked_cross_entropy(logits, y, mask, impl=attn_impl)
        loss = per.sum() / total
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    return step
