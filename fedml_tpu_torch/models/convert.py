"""Weight conversion between flax variables and the port's state dicts.

Flax variables are nested dicts of numpy arrays
(``{"params": {...}, "batch_stats": {...}}``); the port's state dict is
flat, keyed by the same module path joined with dots. The map is:

- a 4-D ``kernel`` (a conv's, HWIO)  <->  ``weight`` OIHW;
- a 2-D ``kernel`` (a Dense's, [in, out], whatever its owner is called:
  ``Dense_i``, ``qkv``, ``out``, ``lm_head``)  <->  ``weight`` [out, in];
- every other leaf (``bias``, ``scale``, ``embedding``, and ``mean``,
  ``var`` in batch_stats)  <->  the tensor of the same name. The BN
  modules are ``BatchNorm_i`` or ``PallasBatchNorm_i``.

Both directions only transpose, so a round trip is bit-exact.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

_BN = re.compile(r"^(Pallas)?BatchNorm_(\d+)$")


def _walk(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rename_bn(path: tuple, bn_name: Optional[str]) -> tuple:
    if bn_name is None:
        return path
    return tuple(_BN.sub(rf"{bn_name}_\2", p) for p in path)


def flax_to_torch(variables: dict, bn_name: Optional[str] = None) -> dict:
    """Flax variables -> the port's state dict. ``bn_name``
    ("PallasBatchNorm" or "BatchNorm") renames every BN path so a tree of
    either flax BN class loads into a model of either ``bn_impl``."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            path = _rename_bn(path, bn_name)
            a = np.asarray(leaf)
            name = path[-1]
            if name == "kernel" and a.ndim == 4:
                a, name = a.transpose(3, 2, 0, 1), "weight"
            elif name == "kernel" and a.ndim == 2:
                a, name = a.T, "weight"
            elif name == "kernel":
                raise ValueError(f"kernel {'/'.join(path)} is neither 2-D nor 4-D")
            out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(a, order="C"))
    return out


def torch_to_flax(state: dict, bn_name: Optional[str] = None) -> dict:
    """The port's state dict -> flax variables of numpy arrays."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        path = _rename_bn(tuple(key.split(".")), bn_name)
        a = t.detach().cpu().numpy()
        name = path[-1]
        coll = "params"
        if name == "weight" and a.ndim == 4:
            a, name = a.transpose(2, 3, 1, 0), "kernel"
        elif name == "weight" and a.ndim == 2:
            a, name = a.T, "kernel"
        elif name == "weight":
            raise ValueError(f"weight {key} is neither 2-D nor 4-D")
        elif name in ("mean", "var"):
            coll = "batch_stats"
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out
