"""Fused masked softmax cross-entropy: kernel K5.

Counterpart of ``fedml_tpu/ops/xent.py``. One pass over each row of
logits computes the rowmax, the log-sum-exp and the gold-label logit, so
the ``[N, V]`` probabilities are never written. The CUDA kernel lives in
``csrc/xent.cu`` (see the note there); it masks V's ragged tail itself,
so no ``-1e30`` padding copy is made.

Which path runs is decided by where the tensor lies: a CPU tensor takes the
plain PyTorch version (``_xla_xent``'s log-softmax); a CUDA tensor launches
the kernel, or raises. ``impl="xla"`` always takes the plain version.

The backward is the closed form ``ct * (softmax(logits) - onehot(label))``
in f32, cast to the logits' dtype, as in the JAX package: there is no
backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops.attention import _uses_kernel

#: calls of the kernel wrapper (one per launch); read by chip_smoke.py
LAUNCHES = {"xent": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_BYTES = {torch.int32: 4, torch.int64: 8}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch version --------------------------------------------------

def xent_plain(logits, labels):
    """Per-row CE of ``logits [N, V]`` against integer ``labels [N]``, f32."""
    logz = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


# -- CUDA kernel wrapper ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from fedml_tpu_torch.ops.build import load_library

    lib = load_library("xent")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fedml_xent_fwd.argtypes = [p, p, i, p, ll, i, i, p]
    lib.fedml_xent_fwd.restype = i
    lib.fedml_xent_error_string.argtypes = [i]
    lib.fedml_xent_error_string.restype = ctypes.c_char_p
    return lib


def xent_cuda(logits, labels):
    """K5 on the card: contiguous float32 or bfloat16 ``[N, V]`` logits,
    contiguous int32 or int64 ``[N]`` labels -> ``[N]`` f32 losses."""
    if not (logits.is_cuda and labels.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if logits.dim() != 2 or logits.dtype not in _DTYPES or not logits.is_contiguous():
        raise ValueError(f"logits must be a contiguous float32 or bfloat16 [N, V] tensor; "
                         f"got {tuple(logits.shape)} {logits.dtype}")
    n, v = logits.shape
    if (labels.device != logits.device or labels.dtype not in _LABEL_BYTES
            or tuple(labels.shape) != (n,) or not labels.is_contiguous()):
        raise ValueError(f"labels must be a contiguous int32 or int64 [{n}] tensor on "
                         f"{logits.device}; got {tuple(labels.shape)}, {labels.dtype}, "
                         f"{labels.device}")
    if n < 1 or not 1 <= v < 2 ** 31:
        raise ValueError(f"the kernel takes N >= 1 and 1 <= V < 2^31; got {n}, {v}")
    with torch.cuda.device(logits.device):
        out = torch.empty(n, dtype=torch.float32, device=logits.device)
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        LAUNCHES["xent"] += 1
        code = _lib().fedml_xent_fwd(logits.data_ptr(), labels.data_ptr(),
                                     _LABEL_BYTES[labels.dtype], out.data_ptr(), n, v,
                                     _DTYPES[logits.dtype], stream)
    if code != 0:
        msg = _lib().fedml_xent_error_string(code).decode()
        raise RuntimeError(f"xent launch failed: CUDA error {code} ({msg})")
    return out


# -- the autograd op --------------------------------------------------------

class CrossEntropy(torch.autograd.Function):
    """Per-row CE whose forward is K5 on CUDA tensors (the plain version on
    CPU tensors, or always with ``use_kernel=False``) and whose backward is
    the closed form (``_xent_with_vjp``'s ``bwd``)."""

    @staticmethod
    def forward(ctx, logits, labels, use_kernel):
        fwd = xent_cuda if (use_kernel and logits.is_cuda) else xent_plain
        ctx.save_for_backward(logits, labels)
        return fwd(logits, labels)

    @staticmethod
    def backward(ctx, ct):
        logits, labels = ctx.saved_tensors
        # softmax - onehot, built in place: subtracting 1.0 at the label
        # column and 0.0 elsewhere gives the same f32 values
        g = torch.softmax(logits.to(torch.float32), dim=-1)
        g[torch.arange(g.shape[0], device=g.device), labels.long()] -= 1.0
        g.mul_(ct[:, None])
        return g.to(logits.dtype), None, None


def masked_cross_entropy(logits, labels, mask=None, *, impl: str = "auto",
                         block_n: int = 64, block_v: int = 2048):
    """Per-example CE loss ``[...]`` in f32; masked entries are zeroed.

    ``logits [..., V]``, integer ``labels [...]``, optional ``mask [...]``.
    Differentiable w.r.t. ``logits`` (closed-form backward).
    ``block_n``/``block_v`` are the TPU kernel's tile sizes, kept for the
    signature; the CUDA kernel walks whole rows."""
    del block_n, block_v
    shape = labels.shape
    v = logits.shape[-1]
    flat_logits = logits.reshape(-1, v).contiguous()
    flat_labels = labels.reshape(-1)
    if flat_labels.dtype not in _LABEL_BYTES:
        flat_labels = flat_labels.to(torch.int32)
    per = CrossEntropy.apply(flat_logits, flat_labels.contiguous(), _uses_kernel(impl))
    per = per.reshape(shape)
    if mask is not None:
        per = per * mask.to(per.dtype)
    return per
