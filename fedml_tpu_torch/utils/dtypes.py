"""Host-side dtype policy (counterpart of ``fedml_tpu/utils/dtypes.py``)."""

from __future__ import annotations

import numpy as np
import torch


def host_bf16_cast(x: np.ndarray, config_dtype: str) -> torch.Tensor:
    """``x`` as a CPU tensor, cast to bf16 on the host when training in
    bf16, so the copy to the device moves half the bytes. Non-float data and
    f32 configs keep their dtype (no copy). The cast rounds to nearest even,
    as the JAX package's ``ml_dtypes`` cast does."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if config_dtype == "bfloat16" and t.is_floating_point():
        return t.to(torch.bfloat16)
    return t
