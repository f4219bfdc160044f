"""Blockwise (flash) attention: kernel K6.

Counterpart of ``fedml_tpu/ops/attention.py``. Shapes: ``q`` is
``[B, H, Tq, D]``, ``k, v`` are ``[B, H, Tk, D]``. Causal masking uses
GLOBAL positions ``q_offset + i >= k_offset + j``, so the same code serves
one-shot attention (offsets 0) and the chunks a ring step would hand it.
A partial result is ``(o, m, l)``: the unnormalized f32 output, the f32
rowmax and the f32 rowsum; a row that saw only masked keys keeps
``m = NEG_INF``, ``l = 0`` and ``o = 0``.

The CUDA kernel lives in ``csrc/attention.cu`` (see the note there). Which
path runs is decided by where the tensor lies: a CPU tensor takes the plain
PyTorch version in this module; a CUDA tensor launches the kernel, or
raises. ``impl="xla"`` always takes the plain version; ``"pallas"`` and
``"auto"`` mean the kernel on CUDA tensors.

As in the JAX package there is no backward kernel: the backward recomputes
the plain partial and differentiates it (the flash-attention trade: no
``[Tq, Tk]`` tensor is saved by the forward). The recompute runs over
slices of the ``B*H`` axis, so at most ``BACKWARD_SCORE_ELEMENTS`` score
entries are live at a time.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -1e30

#: calls of the kernel wrapper (one per launch); read by chip_smoke.py
LAUNCHES = {"attention": 0}

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)

#: score entries ([slice of B*H] x Tq x Tk) one backward recompute slice holds
BACKWARD_SCORE_ELEMENTS = 1 << 28

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _uses_kernel(impl: str) -> bool:
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
    return impl != "xla"


# -- plain PyTorch version --------------------------------------------------

def block_partial_plain(q, k, v, q_offset: int, k_offset: int, causal: bool,
                        sm_scale: float):
    """One Q shard against one K/V chunk -> unnormalized ``(o, m, l)``
    (``_xla_block_partial``): f32 scores from q and k, the causal mask at
    global positions, ``p = 0`` where ``s <= NEG_INF / 2``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    s = s * sm_scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = k_offset + torch.arange(tk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= NEG_INF / 2, torch.zeros((), device=s.device), p)
    l = p.sum(-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return o, m, l


# -- CUDA kernel wrapper ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from fedml_tpu_torch.ops.build import load_library

    lib = load_library("attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fedml_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, ll, ll, i,
                                        ctypes.c_float, i, p]
    lib.fedml_attention_fwd.restype = i
    lib.fedml_attention_error_string.argtypes = [i]
    lib.fedml_attention_error_string.restype = ctypes.c_char_p
    return lib


def block_partial_cuda(q, k, v, q_offset: int, k_offset: int, causal: bool,
                       sm_scale: float):
    """K6 on the card: contiguous ``[B, H, T, D]`` q, k, v of one dtype
    (float32 or bfloat16), D in ``HEAD_DIMS``. bfloat16 runs the
    tensor-core kernel, float32 the CUDA-core one; each picks its own tiles
    (see ``csrc/attention.cu``)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if q.dim() != 4 or q.dtype not in _DTYPES:
        raise ValueError(f"q must be a float32 or bfloat16 [B, H, Tq, D] tensor; "
                         f"got {tuple(q.shape)} {q.dtype}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype or t.dim() != 4
                or tuple(t.shape) != (b, h, tk, d)):
            raise ValueError(f"{name} must be a {q.dtype} [{b}, {h}, Tk, {d}] tensor on "
                             f"{q.device}; got {tuple(t.shape)}, {t.dtype}, {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"the bfloat16 kernel copies 16-byte rows; {name} is not "
                             f"16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}; got {d}")
    if b * h < 1 or b * h > 65535 or tq < 1 or tk < 1:
        raise ValueError(f"the kernel takes 1 <= B*H <= 65535 and Tq, Tk >= 1; "
                         f"got B*H={b * h}, Tq={tq}, Tk={tk}")
    with torch.cuda.device(q.device):
        o = torch.empty((b, h, tq, d), dtype=torch.float32, device=q.device)
        m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        l = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LAUNCHES["attention"] += 1
        code = _lib().fedml_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), b * h, tq, tk, d, int(q_offset), int(k_offset), int(causal),
            float(sm_scale), _DTYPES[q.dtype], stream)
    if code != 0:
        msg = _lib().fedml_attention_error_string(code).decode()
        raise RuntimeError(f"attention launch failed: CUDA error {code} ({msg})")
    return o, m, l


# -- the autograd op --------------------------------------------------------

class BlockPartial(torch.autograd.Function):
    """The partial ``(o, m, l)`` whose forward is K6 on CUDA tensors (the
    plain version on CPU tensors, or always with ``use_kernel=False``) and
    whose backward differentiates the plain version, recomputed
    (``_partial_with_vjp``'s ``bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, sm_scale, use_kernel):
        fwd = block_partial_cuda if (use_kernel and q.is_cuda) else block_partial_plain
        o, m, l = fwd(q.contiguous(), k.contiguous(), v.contiguous(), q_offset, k_offset,
                      causal, sm_scale)
        ctx.save_for_backward(q, k, v)
        ctx.args = (q_offset, k_offset, causal, sm_scale)
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        q, k, v = ctx.saved_tensors
        b, h, tq, d = q.shape
        tk = k.shape[2]
        bh = b * h
        per = max(1, min(bh, BACKWARD_SCORE_ELEMENTS // max(tq * tk, 1)))
        flat = [t.reshape(bh, 1, *t.shape[2:]) for t in (q, k, v, do, dm, dl)]
        grads = [[], [], []]
        for s in range(0, bh, per):
            qs, ks, vs, dos, dms, dls = (t[s:s + per].transpose(0, 1) for t in flat)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in (qs, ks, vs)]
                outs = block_partial_plain(*leaves, *ctx.args)
                gs = torch.autograd.grad(outs, leaves, (dos, dms, dls))
            for acc, g in zip(grads, gs):
                acc.append(g.transpose(0, 1))
        dq, dk, dv = (torch.cat(g).reshape(t.shape) for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None, None, None


def attention_block_partial(q, k, v, *, q_offset: int = 0, k_offset: int = 0,
                            causal: bool = True, sm_scale: Optional[float] = None,
                            impl: str = "auto", block_q: int = 128, block_k: int = 128):
    """Attention of a Q shard against one K/V chunk -> partial result
    ``(o_unnormalized, rowmax m, rowsum l)``, each f32. Merge partials from
    several chunks with :func:`merge_partials`, finish with
    :func:`normalize_partial`. Differentiable (recompute-style backward).

    ``block_q``/``block_k`` are the TPU kernel's tile sizes, kept for the
    signature; the CUDA kernel picks its own tiles."""
    del block_q, block_k
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return BlockPartial.apply(q, k, v, int(q_offset), int(k_offset), bool(causal),
                              float(sm_scale), _uses_kernel(impl))


def merge_partials(a, b):
    """Online-softmax merge of two partial results (associative)."""
    oa, ma, la = a
    ob, mb, lb = b
    m = torch.maximum(ma, mb)
    zero = torch.zeros((), device=m.device)
    wa = torch.where(ma <= NEG_INF / 2, zero, torch.exp(ma - m))
    wb = torch.where(mb <= NEG_INF / 2, zero, torch.exp(mb - m))
    return oa * wa[..., None] + ob * wb[..., None], m, la * wa + lb * wb


def normalize_partial(o, m, l, out_dtype=None):
    """Finish: divide the accumulated unnormalized output by the rowsum (a
    divisor of 1 where ``l == 0``)."""
    den = torch.where(l == 0.0, torch.ones((), device=l.device), l)[..., None]
    out = o / den
    return out.to(out_dtype) if out_dtype is not None else out


def attention(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None,
              impl: str = "auto", block_q: int = 128, block_k: int = 128):
    """Full fused attention, ``[B, H, T, D] -> [B, H, T, D]`` in q's dtype."""
    o, m, l = attention_block_partial(q, k, v, causal=causal, sm_scale=sm_scale, impl=impl,
                                      block_q=block_q, block_k=block_k)
    return normalize_partial(o, m, l, out_dtype=q.dtype)
