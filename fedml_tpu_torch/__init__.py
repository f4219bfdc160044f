"""fedml_tpu_torch — the PyTorch/CUDA counterpart of ``fedml_tpu``.

The package mirrors ``fedml_tpu``'s module paths and public names so each
piece has an obvious counterpart; inside it uses PyTorch's idiom
(``nn.Module``s, explicit devices and generators, ``torch.autograd.Function``
for hand-written kernels). Every TPU kernel on a ported path is a CUDA kernel
written by hand for Hopper (``fedml_tpu_torch/ops/csrc``), with a plain
PyTorch version beside it that runs only for tensors on the CPU.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device"]


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
