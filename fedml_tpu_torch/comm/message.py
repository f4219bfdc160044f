"""Typed message envelope of the edge transports (counterpart of
``fedml_tpu/comm/message.py``).

A message is a dict of ``msg_type/sender/receiver`` plus arbitrary payload
keys (the reference's message.py:5-74). On the wire (:meth:`Message.to_bytes`)
JSON-native values ride in the frame's header and every other value (a
state dict of numpy arrays or tensors, a numpy scalar) rides as one blob
after it: a ``core/serialization`` tree frame, or under a lossy codec a
``core/compression`` frame. Frames are self-describing, so a receiver
decodes raw and compressed blobs alike. The port ships its models as flat
state dicts of host numpy arrays; a frame of the port does not cross to the
JAX package (whose variables are flax trees), and the reverse.

The JAX package's envelope keys of the reliable wire, the gateway, the
tracer and the flight recorder (``__wire_*``, ``__tenant__``,
``__trace_ctx__``, ``__flight_*``) belong to features not ported yet
(ROADMAP §1 items 11b and 12) and are left out.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fedml_tpu_torch.core.serialization import (frame_pack, frame_unpack, tree_from_bytes,
                                                tree_to_bytes)

_MAGIC = b"FMSG1"

# canonical arg keys (reference message.py:15-35)
MSG_ARG_KEY_TYPE = "msg_type"
MSG_ARG_KEY_SENDER = "sender"
MSG_ARG_KEY_RECEIVER = "receiver"
MSG_ARG_KEY_MODEL_PARAMS = "model_params"
MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
MSG_ARG_KEY_TRAIN_CORRECT = "train_correct"
MSG_ARG_KEY_TRAIN_ERROR = "train_error"
MSG_ARG_KEY_TRAIN_NUM = "train_num_sample"


class Message:
    """msg_type/sender/receiver envelope with arbitrary payload keys."""

    MSG_ARG_KEY_TYPE = MSG_ARG_KEY_TYPE
    MSG_ARG_KEY_SENDER = MSG_ARG_KEY_SENDER
    MSG_ARG_KEY_RECEIVER = MSG_ARG_KEY_RECEIVER
    MSG_ARG_KEY_MODEL_PARAMS = MSG_ARG_KEY_MODEL_PARAMS
    MSG_ARG_KEY_NUM_SAMPLES = MSG_ARG_KEY_NUM_SAMPLES
    MSG_ARG_KEY_CLIENT_INDEX = MSG_ARG_KEY_CLIENT_INDEX

    #: per-message codec override (None = the transport's). A protocol sets
    #: it where one direction must not share the link's codec: full-weight
    #: downlinks ride raw while topk compresses delta uplinks.
    codec: "str | None" = None

    def __init__(self, msg_type: "int | str" = 0, sender_id: int = 0, receiver_id: int = 0):
        self.msg_params: Dict[str, Any] = {MSG_ARG_KEY_TYPE: msg_type,
                                           MSG_ARG_KEY_SENDER: sender_id,
                                           MSG_ARG_KEY_RECEIVER: receiver_id}

    def init_from_params(self, msg_params: Dict[str, Any]) -> "Message":
        self.msg_params = dict(msg_params)
        return self

    def get_sender_id(self) -> int:
        return self.msg_params[MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[MSG_ARG_KEY_RECEIVER]

    def get_type(self):
        return self.msg_params[MSG_ARG_KEY_TYPE]

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    add = add_params

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.msg_params

    def __repr__(self) -> str:
        keys = [k for k in self.msg_params
                if k not in (MSG_ARG_KEY_TYPE, MSG_ARG_KEY_SENDER, MSG_ARG_KEY_RECEIVER)]
        return (f"Message(type={self.get_type()!r}, {self.get_sender_id()}->"
                f"{self.get_receiver_id()}, payload={keys})")

    def to_bytes(self, codec: str = "raw") -> bytes:
        """``frame_pack`` of a header (JSON-native values inline, each other
        value as ``{"__blob__": i}``) and the blobs, each encoded under
        ``codec`` (``core/compression.py``: raw | q8 | topk:<ratio>)."""
        from fedml_tpu_torch.core.compression import encode_tree

        header: Dict[str, Any] = {}
        blobs: list[bytes] = []
        for k, v in self.msg_params.items():
            if _is_jsonable(v):
                header[k] = v
            else:
                header[k] = {"__blob__": len(blobs)}
                blobs.append(tree_to_bytes(v) if codec == "raw" else encode_tree(v, codec))
        return frame_pack(_MAGIC, {"h": header, "lens": [len(b) for b in blobs]}, *blobs)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Message":
        from fedml_tpu_torch.core.compression import decode_tree, is_compressed_frame

        meta, off = frame_unpack(_MAGIC, buf)
        blobs = []
        for n in meta["lens"]:
            blobs.append(buf[off: off + n])
            off += n
        params: Dict[str, Any] = {}
        for k, v in meta["h"].items():
            if isinstance(v, dict) and set(v) == {"__blob__"}:
                blob = blobs[v["__blob__"]]
                params[k] = (decode_tree(blob) if is_compressed_frame(blob)
                             else tree_from_bytes(blob))
            else:
                params[k] = v
        msg = cls()
        msg.msg_params = params
        return msg


def _is_jsonable(v: Any) -> bool:
    """Whether ``v`` rides in the JSON header; numpy scalars, arrays and
    tensors go through a blob, which keeps their dtype."""
    if isinstance(v, (np.generic, np.ndarray, torch.Tensor)):
        return False
    if isinstance(v, (str, int, float, bool)) or v is None:
        return True
    if isinstance(v, (list, tuple)):
        return all(_is_jsonable(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _is_jsonable(x) for k, x in v.items())
    return False
