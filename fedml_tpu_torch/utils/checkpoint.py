"""Checkpoint/resume (counterpart of ``fedml_tpu/utils/checkpoint.py``).

Any training state (variables, server state, round index and free-form
``extra``) round-trips through one file: the JAX package's ``FTCKPT1``
frame, whose header holds ``round_idx`` and ``extra`` and whose payload is
the state as a ``core/serialization`` tree. The write goes to ``<path>.tmp``
and is then renamed over ``path``, so a crash never leaves a torn
checkpoint. The JAX package's sharded orbax form has no counterpart yet:
``orbax=True`` raises.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from fedml_tpu_torch.core.serialization import (frame_pack, frame_unpack, tree_from_bytes,
                                                tree_to_bytes)

_MAGIC = b"FTCKPT1"

ORBAX_UNPORTED = ("orbax checkpoints (the JAX package's sharded form) are not ported "
                  "(ROADMAP §1 item 5); use the single-file form")


def save_checkpoint(path: str, variables: Any, server_state: Any = None,
                    round_idx: int = 0, extra: Optional[dict] = None) -> None:
    payload = tree_to_bytes({"variables": variables, "server_state": server_state or {}})
    buf = frame_pack(_MAGIC, {"round_idx": round_idx, "extra": extra or {}}, payload)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """``{"variables", "server_state", "round_idx", "extra"}``; tensors on
    the CPU."""
    with open(path, "rb") as f:
        buf = f.read()
    meta, off = frame_unpack(_MAGIC, buf)
    tree = tree_from_bytes(buf[off:])
    return {"variables": tree["variables"], "server_state": tree["server_state"],
            "round_idx": meta["round_idx"], "extra": meta["extra"]}
