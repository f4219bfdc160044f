"""Lossy wire codecs of the edge transports (counterpart of
``fedml_tpu/core/compression.py``), in numpy.

- ``"q8"``: per-leaf affine uint8 quantization of float leaves, 4x smaller
  than f32; the error is at most half a step of the leaf's value range.
- ``"topk:R"``: magnitude top-k sparsification keeping fraction R of each
  float leaf (int32 indices + f32 values). For update deltas with error
  feedback at the sender; destructive on full weights.
- ``"raw"``: exact passthrough (the default everywhere).

A frame carries the codec and each leaf's encoding in its JSON header, so
decoding needs nothing else. Integer and bool leaves, and float leaves of
fewer than :data:`MIN_LOSSY_ELEMENTS` elements (biases, BN scales: few
bytes, large effect), ride raw inside a lossy frame. Leaves are numpy
arrays (a tensor leaf is copied to the host, a bf16 one widened to f32);
decoding gives numpy arrays, bit for bit the JAX package's on the same
arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.core.serialization import _flatten, _unflatten, frame_pack, frame_unpack

MAGIC = b"FTPC1"

#: leaves smaller than this are stored raw even under a lossy codec
MIN_LOSSY_ELEMENTS = 64


def parse_codec(codec: str) -> tuple[str, float]:
    """'raw' -> ('raw', 0), 'q8' -> ('q8', 0), 'topk:0.05' -> ('topk', .05);
    raises ``ValueError`` on anything else."""
    if codec in ("raw", "q8"):
        return codec, 0.0
    if codec.startswith("topk:"):
        ratio = float(codec.split(":", 1)[1])
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
        return "topk", ratio
    raise ValueError(f"unknown wire codec {codec!r} (raw | q8 | topk:<ratio>)")


def _host(x) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor (numpy has no bf16) widened
    to f32, exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


def _encode_leaf(x: np.ndarray, kind: str, ratio: float) -> tuple[dict, bytes]:
    """(meta, payload) of one leaf: lossy for float leaves of at least
    MIN_LOSSY_ELEMENTS elements, raw otherwise."""
    lossy = kind != "raw" and np.issubdtype(x.dtype, np.floating) and x.size >= MIN_LOSSY_ELEMENTS
    meta = {"shape": list(x.shape), "dtype": x.dtype.name}
    if not lossy:
        meta["enc"] = "raw"
        return meta, np.ascontiguousarray(x).tobytes()
    if kind == "q8":
        xf = np.asarray(x, np.float32)
        lo, hi = float(xf.min()), float(xf.max())
        scale = (hi - lo) / 255.0 or 1.0
        meta.update(enc="q8", lo=lo, scale=scale)
        return meta, np.rint((xf - lo) / scale).astype(np.uint8).tobytes()
    flat = np.asarray(x, np.float32).reshape(-1)
    k = max(1, int(round(ratio * flat.size)))
    idx = np.argpartition(np.abs(flat), -k)[-k:].astype(np.int32)
    idx.sort()
    meta.update(enc="topk", k=int(k))
    return meta, idx.tobytes() + flat[idx].tobytes()


def _decode_leaf(meta: dict, buf: bytes) -> np.ndarray:
    shape, dtype, enc = tuple(meta["shape"]), np.dtype(meta["dtype"]), meta["enc"]
    if enc == "raw":
        # a copy: frombuffer's view is read-only and pins the whole frame
        return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    if enc == "q8":
        q = np.frombuffer(buf, dtype=np.uint8).astype(np.float32)
        return (meta["lo"] + q * meta["scale"]).astype(dtype).reshape(shape)
    if enc == "topk":
        k = meta["k"]
        idx = np.frombuffer(buf[: 4 * k], dtype=np.int32)
        out = np.zeros(int(np.prod(shape)) if shape else 1, np.float32)
        out[idx] = np.frombuffer(buf[4 * k:], dtype=np.float32)
        return out.astype(dtype).reshape(shape)
    raise ValueError(f"unknown leaf encoding {enc!r}")


def encode_tree(tree: Any, codec: str) -> bytes:
    """Serialize a tree (``core/serialization``'s: dicts, lists, tuples,
    None) of arrays under ``codec``; :func:`decode_tree` needs nothing
    else."""
    kind, ratio = parse_codec(codec)
    leaves: list = []
    structure = _flatten(tree, leaves)
    metas, payloads = [], []
    for leaf in leaves:
        m, b = _encode_leaf(_host(leaf), kind, ratio)
        metas.append(m)
        payloads.append(b)
    header = {"codec": codec, "tree": structure, "leaves": metas,
              "lens": [len(b) for b in payloads]}
    return frame_pack(MAGIC, header, *payloads)


def decode_tree(buf: bytes) -> Any:
    header, off = frame_unpack(MAGIC, buf)
    leaves = []
    for meta, n in zip(header["leaves"], header["lens"]):
        leaves.append(_decode_leaf(meta, buf[off: off + n]))
        off += n
    return _unflatten(header["tree"], leaves)


def is_compressed_frame(buf: bytes) -> bool:
    return buf[: len(MAGIC)] == MAGIC
