"""Lane-stacked state dicts (counterpart of the stacked-tree helpers of
``fedml_tpu/ops/packed_conv.py``).

The port's lane-stacked models (``CifarResNet(n_lanes=L)``) fold the L
lanes into the leading axis of every leaf: a conv weight ``[Co, Ci, k, k]``
becomes ``[L*Co, Ci, k, k]`` (the weight of a grouped conv with ``groups=L``),
a BatchNorm leaf ``[C]`` becomes ``[L*C]`` (channel ``l*C + c`` of the folded
activations), a Dense weight ``[out, in]`` becomes ``[L*out, in]``. Lane l's
leaf is therefore rows ``l*n0 .. (l+1)*n0`` of the leading axis, in memory
one contiguous block. The joint lowerings of the JAX module (block-diagonal
and grouped convs for ``packed_conv != "off"``) are not ported.
"""

from __future__ import annotations

import torch


def stack_variables(variables: dict, k: int) -> dict:
    """Standard state dict -> lane-stacked state dict holding ``k``
    identical copies (each lane starts from the same global model)."""
    out = {}
    for name, v in variables.items():
        if v.dim() == 0:
            raise ValueError(f"{name}: a 0-dim leaf has no axis to fold lanes into")
        out[name] = v.repeat(k, *([1] * (v.dim() - 1)))
    return out


def unstack_variables(stacked: dict, lane: int, k: int) -> dict:
    """Lane-stacked state dict of ``k`` lanes -> lane ``lane``'s standard
    state dict (bit-exact inverse of :func:`stack_variables`, a view)."""
    if not 0 <= lane < k:
        raise IndexError(f"lane {lane} out of range for {k} lanes")
    return {name: v.reshape(k, v.shape[0] // k, *v.shape[1:])[lane]
            for name, v in stacked.items()}
