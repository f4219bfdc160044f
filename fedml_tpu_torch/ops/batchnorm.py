"""Fused train-mode BatchNorm(+ReLU): kernels K1 (forward) and K2 (backward).

Counterpart of ``fedml_tpu/ops/batchnorm.py``. The CUDA kernels live in
``csrc/batchnorm.cu`` (see the note there): each of K1 and K2 is one
cooperative launch that reads its inputs once, keeps its rows on chip
across a grid barrier and sums the per-block partials in a fixed order.
Each launches with a plan (grid, threads, rows kept on chip) made once per
shape, dtype, alignment and device and cached here.
Numerics follow flax ``nn.BatchNorm(use_running_average=False)``: biased
variance over all leading axes, f32 statistics, scale and bias applied in
f32, output cast back to the input dtype, and no gradient through the
returned ``mean``/``var``.

Which path runs is decided by where the tensor lies: a CPU tensor takes the
plain PyTorch version in this module; a CUDA tensor launches the kernel, or
raises. Unlike the TPU kernel the CUDA kernels take any row count, so there
is no row-tiling fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fedml_tpu_torch.ops.grid_barrier import barrier_words

#: calls of each kernel wrapper (one launch per BN forward or backward);
#: read by chip_smoke.py
LAUNCHES = {"bn_fwd": 0, "bn_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain PyTorch versions -------------------------------------------------

def bn_relu_fwd_plain(x2d, gamma, beta, eps: float = 1e-5, relu: bool = True):
    """Plain forward over the rows of ``x2d`` [n, C] (counterpart of
    ``_xla_bn_relu``). Returns (y, mean, rstd, var)."""
    x32 = x2d.to(torch.float32)
    mean = x32.mean(0)
    var = ((x32 - mean) ** 2).mean(0)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd * gamma.to(torch.float32) + beta.to(torch.float32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2d.dtype), mean, rstd, var


def bn_relu_bwd_plain(x2d, y, dy, gamma, mean, rstd, relu: bool = True):
    """Closed-form backward (ops/batchnorm.py:231-241 of the JAX package).
    Returns (dx, dgamma, dbeta)."""
    g = dy.to(torch.float32)
    if relu:
        g = g * (y.to(torch.float32) > 0.0)
    xhat = (x2d.to(torch.float32) - mean) * rstd
    n = x2d.shape[0]
    dbeta = g.sum(0)
    dgamma = (g * xhat).sum(0)
    dx = (gamma.to(torch.float32) * rstd) * (g - dbeta / n - xhat * dgamma / n)
    return dx.to(dy.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


# -- CUDA kernel wrappers ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from fedml_tpu_torch.ops.build import load_library

    lib = load_library("batchnorm")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fedml_bn_plan_ints.argtypes = []
    lib.fedml_bn_plan_ints.restype = i
    lib.fedml_bn_plan.argtypes = [i, ll, i, i, i, p]
    lib.fedml_bn_plan.restype = i
    lib.fedml_bn_fwd.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, ctypes.c_float, i, i, p, p]
    lib.fedml_bn_fwd.restype = i
    lib.fedml_bn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, ll, i, i, i, p, p]
    lib.fedml_bn_bwd.restype = i
    lib.fedml_cuda_error_string.argtypes = [i]
    lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().fedml_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"{name} must match x ({like.shape}, {like.dtype}, {like.device}); "
                         f"got {tuple(t.shape)}, {t.dtype}, {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_channel(name: str, t: torch.Tensor, x2d: torch.Tensor) -> None:
    C = x2d.shape[1]
    if (t.device != x2d.device or t.dtype != torch.float32 or tuple(t.shape) != (C,)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 [{C}] tensor on "
                         f"{x2d.device}; got {tuple(t.shape)}, {t.dtype}, {t.device}")


def _check_x(x2d: torch.Tensor) -> None:
    if not x2d.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if x2d.dim() != 2 or x2d.dtype not in _DTYPES or not x2d.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 or bfloat16 [n, C] tensor; "
                         f"got {tuple(x2d.shape)} {x2d.dtype}")
    n, C = x2d.shape
    if n < 1 or not 1 <= C <= 1024:
        raise ValueError(f"the kernel takes n >= 1 rows and 1 <= C <= 1024; got {n}, {C}")


#: the plan fields of K1 and K2 (csrc/batchnorm.cu Geom), in order
PLAN_FIELDS = ("V", "vpr", "threads", "R", "cols", "cap", "blocks", "scratch_off",
               "coef_off")
_PLAN_BLOCKS = PLAN_FIELDS.index("blocks")


@functools.lru_cache(maxsize=None)
def _plan(backward: bool, n: int, C: int, dtype: int, aligned: bool, device: int):
    """K1's (``backward`` False) or K2's launch plan (an occupancy query and
    the grid) for one shape on one device, computed once: a ctypes int
    array passed to every launch."""
    lib = _lib()
    if lib.fedml_bn_plan_ints() != len(PLAN_FIELDS):
        raise RuntimeError("csrc/batchnorm.cu's Geom does not match PLAN_FIELDS")
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    with torch.cuda.device(device):
        _check(lib.fedml_bn_plan(int(backward), n, C, dtype, int(aligned), plan),
               "bn_bwd plan" if backward else "bn_fwd plan")
    return plan


def _plan_for(backward: bool, *rows: torch.Tensor):
    """The plan for the [n, C] tensors of one call (``rows[0]`` is x)."""
    x2d = rows[0]
    n, C = x2d.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in rows)
    return _plan(backward, n, C, _DTYPES[x2d.dtype], aligned, x2d.device.index)


def _plan_dict(plan, n: int) -> dict:
    out = dict(zip(PLAN_FIELDS, plan))
    out["rows_per_block"] = -(-n // out["blocks"])
    return out


def fwd_plan(x2d) -> dict:
    """K1's plan for a CUDA tensor's shape (aligned tensors), with
    ``rows_per_block``: more than ``cap`` means rows are read again from
    device memory in the second pass."""
    return _plan_dict(_plan_for(False, x2d), x2d.shape[0])


def bwd_plan(x2d, relu: bool = True) -> dict:
    """K2's plan for a CUDA tensor's shape (aligned tensors), as
    ``fwd_plan``."""
    return _plan_dict(_plan_for(True, *([x2d] * (4 if relu else 3))), x2d.shape[0])


def bn_fwd_cuda(x2d, gamma, beta, eps: float = 1e-5, relu: bool = True):
    """K1 on the card, one launch. Returns (y, mean, rstd, var)."""
    _check_x(x2d)
    _check_channel("gamma", gamma, x2d)
    _check_channel("beta", beta, x2d)
    n, C = x2d.shape
    with torch.cuda.device(x2d.device):
        y = torch.empty_like(x2d)
        mean, rstd, var = (torch.empty(C, dtype=torch.float32, device=x2d.device)
                           for _ in range(3))
        plan = _plan_for(False, x2d, y)
        partial = torch.empty((plan[_PLAN_BLOCKS], 2, C), dtype=torch.float32, device=x2d.device)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        barrier = barrier_words(x2d.device, stream)
        LAUNCHES["bn_fwd"] += 1
        code = _lib().fedml_bn_fwd(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), var.data_ptr(), partial.data_ptr(),
            barrier.data_ptr(), n, C, float(eps), int(relu), _DTYPES[x2d.dtype], plan, stream)
    _check(code, "bn_fwd")
    return y, mean, rstd, var


def bn_bwd_cuda(x2d, y, dy, gamma, mean, rstd, relu: bool = True):
    """K2 on the card, one launch. Returns (dx, dgamma, dbeta)."""
    _check_x(x2d)
    _check_rows("dy", dy, x2d)
    if relu:
        _check_rows("y", y, x2d)
    for name, t in (("gamma", gamma), ("mean", mean), ("rstd", rstd)):
        _check_channel(name, t, x2d)
    n, C = x2d.shape
    with torch.cuda.device(x2d.device):
        dx = torch.empty_like(dy)
        dgamma = torch.empty(C, dtype=torch.float32, device=x2d.device)
        dbeta = torch.empty(C, dtype=torch.float32, device=x2d.device)
        plan = _plan_for(True, x2d, dy, dx, *([y] if relu else []))
        partial = torch.empty((plan[_PLAN_BLOCKS], 2, C), dtype=torch.float32, device=x2d.device)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        barrier = barrier_words(x2d.device, stream)
        LAUNCHES["bn_bwd"] += 1
        code = _lib().fedml_bn_bwd(
            x2d.data_ptr(), y.data_ptr() if relu else None, dy.data_ptr(),
            gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), partial.data_ptr(), barrier.data_ptr(),
            n, C, int(relu), _DTYPES[x2d.dtype], plan, stream)
    _check(code, "bn_bwd")
    return dx, dgamma, dbeta


# -- the autograd ops -------------------------------------------------------

def _bn_relu_bwd_graph(x2d, y, dy, gamma, eps: float, relu: bool):
    """The closed-form backward as a differentiable function of ``x2d``,
    ``dy`` and ``gamma``: ``bn_relu_bwd_plain`` with ``mean``/``rstd``
    recomputed from ``x2d`` (the forward's saved ones are constants to
    autograd). The ReLU mask ``y > 0`` is piecewise constant, as in JAX's
    autodiff of flax BN."""
    x32 = x2d.to(torch.float32)
    mean = x32.mean(0)
    xc = x32 - mean
    return bn_relu_bwd_plain(x2d, y, dy, gamma, mean, torch.rsqrt((xc * xc).mean(0) + eps), relu)


class BNReLUBackward(torch.autograd.Function):
    """K2 (or its plain version for CPU tensors) as a function of
    ``(x2d, dy, gamma)``, so a gradient taken with ``create_graph=True``
    can be differentiated again. Its own backward, the vjp of the BN
    backward, is plain PyTorch on :func:`_bn_relu_bwd_graph`: JAX's
    counterpart is XLA's autodiff of flax BN, no Pallas kernel."""

    @staticmethod
    def forward(ctx, x2d, y, dy, gamma, mean, rstd, eps, relu):
        bwd = bn_bwd_cuda if dy.is_cuda else bn_relu_bwd_plain
        dx, dgamma, dbeta = bwd(x2d, y, dy, gamma, mean, rstd, relu)
        ctx.save_for_backward(x2d, y, dy, gamma)
        ctx.eps, ctx.relu = eps, relu
        return dx, dgamma, dbeta

    @staticmethod
    def backward(ctx, ddx, ddgamma, ddbeta):
        x2d, y, dy, gamma = ctx.saved_tensors
        want = (ctx.needs_input_grad[0], ctx.needs_input_grad[2], ctx.needs_input_grad[3])
        leaves = [t.detach().requires_grad_(w) for t, w in zip((x2d, dy, gamma), want)]
        with torch.enable_grad():
            outs = _bn_relu_bwd_graph(leaves[0], y.detach(), leaves[1], leaves[2], ctx.eps,
                                      ctx.relu)
            pairs = [(o, g) for o, g in zip(outs, (ddx, ddgamma, ddbeta))
                     if g is not None and o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                             [g for _, g in pairs], allow_unused=True)
                         if pairs and wrt else [None] * len(wrt))
        gx, gdy, ggamma = (next(grads) if w else None for w in want)
        return gx, None, gdy, ggamma, None, None, None, None


class FusedBNReLU(torch.autograd.Function):
    """BN(+ReLU) over the rows of [n, C] whose backward is K2 (or its plain
    version for CPU tensors), through :class:`BNReLUBackward`, so it is
    twice differentiable."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, relu):
        fwd = bn_fwd_cuda if x2d.is_cuda else bn_relu_fwd_plain
        y, mean, rstd, var = fwd(x2d, gamma, beta, eps, relu)
        ctx.save_for_backward(x2d, y, gamma, mean, rstd)
        ctx.eps, ctx.relu = eps, relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, y, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = BNReLUBackward.apply(x2d, y, dy.contiguous(), gamma, mean, rstd,
                                                 ctx.eps, ctx.relu)
        return dx, dgamma, dbeta, None, None


def fused_bn_relu(x, gamma, beta, eps: float = 1e-5, relu: bool = True):
    """Train-mode BN(+ReLU) over all leading axes of ``x`` (channels last).

    Returns ``(y, mean, var)``: ``y`` in ``x.dtype``; ``mean``/``var`` the
    BIASED f32 batch statistics, which carry no gradient. Twice
    differentiable: the first backward is K2, the second plain PyTorch."""
    C = x.shape[-1]
    y, mean, var = FusedBNReLU.apply(x.reshape(-1, C), gamma, beta, float(eps), bool(relu))
    return y.reshape(x.shape), mean, var
