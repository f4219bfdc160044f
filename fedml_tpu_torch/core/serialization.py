"""State-dict <-> bytes (counterpart of ``fedml_tpu/core/serialization.py``).

A frame is ``MAGIC | u64 header_len | JSON header | payloads``
(:func:`frame_pack`, byte for byte the JAX package's). A tree is nested
dicts (string keys), lists, tuples and None over tensors or numpy arrays:
its header holds the structure with each leaf replaced by its index (the
JAX package's ``__d__``/``__l__``/``__t__``/``__n__`` containers), and each
leaf's shape, dtype and place in the payload; the payload is the leaves'
raw bytes back to back, with a CRC-32 over them. Each leaf's dtype is kept
(bfloat16 included, as its raw 16-bit words), so a round trip is exact. A
tensor comes back a CPU tensor, a numpy array a numpy array.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any

import numpy as np
import torch

_MAGIC = b"FTPT1"

_TORCH_DTYPES = {str(dt).removeprefix("torch."): dt for dt in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool)}


def frame_pack(magic: bytes, header: Any, *payloads: bytes) -> bytes:
    """``MAGIC | u64 header_len | JSON | payloads``: the framing used
    wherever a JSON header fronts raw buffers (checkpoint files)."""
    hbytes = json.dumps(header).encode("utf-8")
    return b"".join([magic, struct.pack("<Q", len(hbytes)), hbytes, *payloads])


def frame_unpack(magic: bytes, buf: bytes) -> tuple[Any, int]:
    """Returns (header, payload_offset); raises on a foreign or torn buffer."""
    if buf[: len(magic)] != magic:
        raise ValueError(f"bad magic: expected {magic!r}")
    off = len(magic)
    if len(buf) < off + 8:
        raise ValueError("truncated frame: missing header length")
    (hlen,) = struct.unpack("<Q", buf[off: off + 8])
    off += 8
    if len(buf) < off + hlen:
        raise ValueError("truncated frame: incomplete header")
    header = json.loads(buf[off: off + hlen].decode("utf-8"))
    return header, off + hlen


def _leaf_bytes(leaf) -> tuple[str, str, list, bytes]:
    """(kind, dtype name, shape, raw bytes) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name not in _TORCH_DTYPES:
            raise TypeError(f"unsupported tensor dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return "torch", name, list(t.shape), raw
    a = np.asarray(leaf)
    if a.dtype == object:
        raise TypeError(f"unsupported leaf {type(leaf).__name__}")
    # the shape of ``a``: ascontiguousarray makes a 0-d array 1-d
    return "numpy", a.dtype.str, list(a.shape), np.ascontiguousarray(a).tobytes()


def _flatten(x, leaves: list):
    if isinstance(x, dict):
        for k in x:
            if not isinstance(k, str):
                raise TypeError(f"trees require string dict keys, got {type(k).__name__} {k!r}")
        return {"__d__": {k: _flatten(v, leaves) for k, v in x.items()}}
    if isinstance(x, tuple):
        return {"__t__": [_flatten(v, leaves) for v in x]}
    if isinstance(x, list):
        return {"__l__": [_flatten(v, leaves) for v in x]}
    if x is None:
        return {"__n__": 0}
    leaves.append(x)
    return len(leaves) - 1


def _unflatten(j, leaves: list):
    if isinstance(j, dict):
        if "__d__" in j:
            return {k: _unflatten(v, leaves) for k, v in j["__d__"].items()}
        if "__t__" in j:
            return tuple(_unflatten(v, leaves) for v in j["__t__"])
        if "__l__" in j:
            return [_unflatten(v, leaves) for v in j["__l__"]]
        if "__n__" in j:
            return None
    return leaves[j]


def tree_to_bytes(tree: Any) -> bytes:
    """Serialize a tree of tensors / numpy arrays to a self-describing frame."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    specs, parts = [], []
    for leaf in leaves:
        kind, dtype, shape, raw = _leaf_bytes(leaf)
        specs.append({"kind": kind, "dtype": dtype, "shape": shape, "nbytes": len(raw)})
        parts.append(raw)
    payload = b"".join(parts)
    header = {"tree": structure, "leaves": specs, "crc32": zlib.crc32(payload)}
    return frame_pack(_MAGIC, header, payload)


def tree_from_bytes(buf: bytes) -> Any:
    header, off = frame_unpack(_MAGIC, buf)
    payload = memoryview(buf)[off:]
    total = sum(s["nbytes"] for s in header["leaves"])
    if len(payload) < total:
        raise ValueError(f"truncated frame: payload has {len(payload)} of {total} bytes")
    got = zlib.crc32(payload[:total])
    if got != header["crc32"]:
        raise ValueError(f"frame payload corrupt: crc32 {got:#010x} != {header['crc32']:#010x}")
    leaves, pos = [], 0
    for s in header["leaves"]:
        raw = payload[pos: pos + s["nbytes"]]
        pos += s["nbytes"]
        if s["kind"] == "torch":
            dt = _TORCH_DTYPES[s["dtype"]]
            flat = (torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dt) if len(raw)
                    else torch.empty(0, dtype=dt))
            leaves.append(flat.reshape(s["shape"]))
        else:
            leaves.append(np.frombuffer(raw, np.dtype(s["dtype"])).reshape(s["shape"]).copy())
    return _unflatten(header["tree"], leaves)
