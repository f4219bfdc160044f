"""Grid-barrier words of the cooperative kernels (``csrc/grid_barrier.cuh``).

K1 (``bn_fwd_onepass``), K2 (``bn_bwd_onepass``) and the bf16 K4
(``conv_wgrad_mma``) meet their grid once per call on two zeroed int32 words of the device and leave them
zero. Launches on one stream run in order, so the kernels of one (device,
stream) share a pair.
"""

from __future__ import annotations

import torch

_WORDS: dict[tuple[int, int], torch.Tensor] = {}


def barrier_words(device: torch.device, stream: int) -> torch.Tensor:
    """The two barrier words of ``stream`` on ``device`` (a CUDA tensor)."""
    key = (device.index, stream)
    if key not in _WORDS:
        _WORDS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _WORDS[key]
