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

A depthwise conv's kernel (HWIO ``[k, k, 1, C]``, DARTS) maps like any
conv's, to ``[C, 1, k, k]``. An affine-free BN (flax ``use_scale=False,
use_bias=False``) has no ``scale``/``bias`` leaves, and the port's
``PallasBatchNorm(affine=False)`` keeps them out of its state dict. DARTS'
architecture weights are no flax variables: :func:`alphas_to_torch` /
:func:`alphas_to_flax` carry them.

Both directions only transpose, so a round trip is bit-exact.

``stacked=True`` maps a tree whose every leaf carries a leading stack axis
(FedGKT's client nets: ``vmap(init)`` over one key a client gives leaves
``[C, ...]``) to a state dict of ``[C, ...]`` tensors and back: the axis is
kept and each slice is mapped as above, so client i's state dict is slice
i of every entry.
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


def flax_to_torch(variables: dict, bn_name: Optional[str] = None,
                  stacked: bool = False) -> dict:
    """Flax variables -> the port's state dict. ``bn_name``
    ("PallasBatchNorm" or "BatchNorm") renames every BN path so a tree of
    either flax BN class loads into a model of either ``bn_impl``;
    ``stacked`` keeps a leading stack axis (module note)."""
    out = {}
    s = int(stacked)
    lead = tuple(range(s))
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            path = _rename_bn(path, bn_name)
            a = np.asarray(leaf)
            name = path[-1]
            if name == "kernel" and a.ndim == 4 + s:
                a, name = a.transpose(*lead, *(d + s for d in (3, 2, 0, 1))), "weight"
            elif name == "kernel" and a.ndim == 2 + s:
                a, name = np.swapaxes(a, s, s + 1), "weight"
            elif name == "kernel":
                raise ValueError(f"kernel {'/'.join(path)} is neither 2-D nor 4-D")
            out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(a, order="C"))
    return out


def torch_to_flax(state: dict, bn_name: Optional[str] = None, stacked: bool = False) -> dict:
    """The port's state dict -> flax variables of numpy arrays (``stacked``:
    every entry carries a leading stack axis, which is kept)."""
    out: dict = {"params": {}, "batch_stats": {}}
    s = int(stacked)
    lead = tuple(range(s))
    for key, t in state.items():
        path = _rename_bn(tuple(key.split(".")), bn_name)
        a = t.detach().cpu().numpy()
        name = path[-1]
        coll = "params"
        if name == "weight" and a.ndim == 4 + s:
            a, name = a.transpose(*lead, *(d + s for d in (2, 3, 1, 0))), "kernel"
        elif name == "weight" and a.ndim == 2 + s:
            a, name = np.swapaxes(a, s, s + 1), "kernel"
        elif name == "weight":
            raise ValueError(f"weight {key} is neither 2-D nor 4-D")
        elif name in ("mean", "var"):
            coll = "batch_stats"
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[name] = np.array(a, order="C")      # a copy: no view of the tensor
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


def flax_path(key: str, ndim: int) -> tuple:
    """The flax path (collection first) of a state-dict entry of ``ndim``
    dimensions, as :func:`torch_to_flax` places it."""
    path = tuple(key.split("."))
    name = path[-1]
    if name == "weight" and ndim in (2, 4):
        return ("params",) + path[:-1] + ("kernel",)
    return ("batch_stats" if name in ("mean", "var") else "params",) + path


def flax_leaf_order(state: dict) -> list:
    """The state dict's names in the order ``jax.tree_util`` flattens the
    flax variables they map to (every dict level by sorted key), so a leaf's
    position here is its index in the JAX package's flattened tree."""
    return sorted(state, key=lambda k: flax_path(k, state[k].dim()))


def alphas_to_torch(alphas: dict) -> dict:
    """DARTS alphas (``{"normal", "reduce"}`` arrays ``[k, 8]``) as tensors."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in alphas.items()}


def alphas_to_flax(alphas: dict) -> dict:
    """The port's alphas as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in alphas.items()}
