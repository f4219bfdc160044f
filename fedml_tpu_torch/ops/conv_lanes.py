"""Spatial-in-lanes 3x3 convolution: kernels K3 (forward, also the dgrad),
K4 (weight gradient) and K7 (K3's probe variants).

Counterpart of ``fedml_tpu/ops/conv_lanes.py`` and of the probe kernel in
``tools/lanes_probe.py``. Activations travel as ``[N, C, H*W]`` (the "lanes
layout"); a SAME-padded stride-1 3x3 conv is

    Y[n] = W2[Co, 9*Ci] @ P[n][9*Ci, H*W],

with P the patch matrix, row ``tap*Ci + c`` for ``tap = (dy+1)*3 + (dx+1)``
holding channel c shifted by (dy, dx), zero outside the image. The CUDA
kernels live in ``csrc/conv_lanes.cu`` (see the note there); they build P
tile by tile in shared memory and never write it to device memory. The
plain versions in this module build P explicitly and multiply in f32.

Which path runs is decided by where the tensor lies: a CPU tensor takes the
plain PyTorch version; a CUDA tensor launches the kernel, or raises. The
kernels take any shape; ``supported()`` only decides which convs of a model
take them, so that the same convs do as in the JAX package (``Conv``).

Weights are the port's OIHW ``[Co, Ci, 3, 3]`` (``Conv_i.weight``, the
transpose of flax's HWIO ``kernel``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.initializers import lecun_normal_
from fedml_tpu_torch.ops.grid_barrier import barrier_words

TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

#: the TPU kernel's largest pixel tile; kept for ``supported()``
MAX_TILE = 2048

#: calls of each kernel wrapper (one per launch of its kernel); read by
#: chip_smoke.py
LAUNCHES = {"conv_fwd": 0, "conv_wgrad": 0, "conv_variant": 0}

#: K7's modes: the full conv, the patch build alone, one slice copy
VARIANT_MODES = {"kernel": 0, "patches": 1, "copy": 2}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(c_in: int, h: int, w: int) -> bool:
    """The shapes the JAX package sends to its kernel (sublane-aligned
    C_in, whole lane tiles, one tile per image); a model's other 3x3 convs
    take ``_xla_conv_nchw``, as they do there."""
    hw = h * w
    return c_in % 8 == 0 and hw % 128 == 0 and hw <= MAX_TILE


def _tile(hw: int) -> int:
    """The TPU kernel's pixel tile for an image of ``hw`` pixels."""
    t = hw
    while t > MAX_TILE:
        t //= 2
    return t


def _w2(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Co, Ci, 3, 3] -> [Co, 9*Ci], columns tap-major."""
    co, ci = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(co, 9 * ci)


def _w2_inv(dw2: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """[Co, 9*Ci] -> OIHW [Co, Ci, 3, 3] (inverse of ``_w2``)."""
    return dw2.reshape(co, 3, 3, ci).permute(0, 3, 1, 2).contiguous()


def subsample2(xf: torch.Tensor, h: int, w: int, offset: int = 0) -> torch.Tensor:
    """Stride-2 subsample in lanes layout: [N, C, H*W] -> [N, C, H*W/4].

    ``offset=1`` after the stride-1 3x3 conv gives flax's SAME stride-2
    conv for even H, W (SAME at stride 2 pads (0, 1), so its windows sit
    at the odd positions); 1x1 stride-2 convs keep ``offset=0``."""
    if h % 2 or w % 2:
        raise ValueError(f"the stride-2 lanes path needs even H and W; got {h}x{w}")
    n, c, _ = xf.shape
    return (xf.reshape(n, c, h, w)[:, :, offset::2, offset::2]
            .reshape(n, c, (h // 2) * (w // 2)))


def to_lanes(x_nhwc: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x_nhwc.shape
    return x_nhwc.permute(0, 3, 1, 2).reshape(n, c, h * w)


def from_lanes(xf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    n, c, _ = xf.shape
    return xf.reshape(n, c, h, w).permute(0, 2, 3, 1)


# -- plain PyTorch versions -------------------------------------------------

def patches_plain(xf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The f32 patch matrix [N, 9*Ci, H*W], row ``tap*Ci + c``."""
    n, ci, _ = xf.shape
    xp = F.pad(xf.to(torch.float32).reshape(n, ci, h, w), (1, 1, 1, 1))
    return torch.cat([xp[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w].reshape(n, ci, h * w)
                      for dy, dx in TAPS], 1)


def conv_fwd_plain(xf, w2, h: int, w: int):
    """K3: [N, Ci, H*W] x [Co, 9*Ci] -> [N, Co, H*W] in xf's dtype, f32 sums."""
    y = torch.einsum("ok,nkp->nop", w2.to(torch.float32), patches_plain(xf, h, w))
    return y.to(xf.dtype)


def conv_wgrad_plain(xf, dyf, h: int, w: int):
    """K4: dW2 [Co, 9*Ci] f32 = sum over images and pixels of dY P^T."""
    return torch.einsum("nop,nkp->ok", dyf.to(torch.float32), patches_plain(xf, h, w))


def conv_variant_plain(mode: str, xf, w2, h: int, w: int):
    """K7: ``kernel`` is K3; ``patches`` the first Co rows of the patch
    matrix; ``copy`` the first Co channels of the image (Co = w2 rows)."""
    co = w2.shape[0]
    if mode == "kernel":
        return conv_fwd_plain(xf, w2, h, w)
    if mode == "patches":
        return patches_plain(xf, h, w)[:, :co].to(xf.dtype)
    if mode == "copy":
        return xf[:, :co].clone()
    raise ValueError(f"unknown variant {mode!r}; one of {sorted(VARIANT_MODES)}")


# -- CUDA kernel wrappers ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from fedml_tpu_torch.ops.build import load_library

    lib = load_library("conv_lanes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fedml_conv_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.fedml_conv_fwd.restype = i
    lib.fedml_conv_wgrad_blocks.argtypes = [i, i, i, i, i, i]
    lib.fedml_conv_wgrad_blocks.restype = i
    lib.fedml_conv_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.fedml_conv_wgrad.restype = i
    lib.fedml_conv_error_string.argtypes = [i]
    lib.fedml_conv_error_string.restype = ctypes.c_char_p
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().fedml_conv_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check_act(name: str, t: torch.Tensor, h: int, w: int) -> None:
    if not t.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if t.dim() != 3 or t.dtype not in _DTYPES or not t.is_contiguous() or t.shape[2] != h * w:
        raise ValueError(f"{name} must be a contiguous float32 or bfloat16 [N, C, {h}*{w}] "
                         f"tensor; got {tuple(t.shape)} {t.dtype}")


def _check_like(name: str, t: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    if (t.device != like.device or t.dtype != like.dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {like.dtype} {list(shape)} tensor on "
                         f"{like.device}; got {tuple(t.shape)}, {t.dtype}, {t.device}")


def _fwd_launch(counter: str, mode: str, xf, w2, h: int, w: int):
    _check_act("xf", xf, h, w)
    n, ci, hw = xf.shape
    co = w2.shape[0]
    _check_like("w2", w2, xf, (co, 9 * ci))
    if (mode == "patches" and co > 9 * ci) or (mode == "copy" and co > ci):
        raise ValueError(f"variant {mode!r} takes at most {9 * ci if mode == 'patches' else ci} "
                         f"output rows; got {co}")
    with torch.cuda.device(xf.device):
        y = torch.empty((n, co, hw), dtype=xf.dtype, device=xf.device)
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        LAUNCHES[counter] += 1
        code = _lib().fedml_conv_fwd(xf.data_ptr(), w2.data_ptr(), y.data_ptr(), n, ci, co, h, w,
                                     VARIANT_MODES[mode], _DTYPES[xf.dtype], stream)
    _check(code, counter)
    return y


def conv_fwd_cuda(xf, w2, h: int, w: int):
    """K3 on the card; w2 in xf's dtype. bfloat16 runs the tensor-core
    kernel, float32 the CUDA-core one (see ``csrc/conv_lanes.cu``)."""
    return _fwd_launch("conv_fwd", "kernel", xf, w2, h, w)


def conv_variant_cuda(mode: str, xf, w2, h: int, w: int):
    """K7 on the card (``mode`` in ``VARIANT_MODES``)."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"unknown variant {mode!r}; one of {sorted(VARIANT_MODES)}")
    return _fwd_launch("conv_variant", mode, xf, w2, h, w)


def conv_wgrad_cuda(xf, dyf, h: int, w: int):
    """K4 on the card: dW2 [Co, 9*Ci] f32. bfloat16 runs the tensor-core
    kernel (one cooperative launch on the stream's barrier words), float32
    the CUDA-core partials and finalize (see ``csrc/conv_lanes.cu``)."""
    _check_act("xf", xf, h, w)
    n, ci, hw = xf.shape
    co = dyf.shape[1]
    _check_like("dyf", dyf, xf, (n, co, hw))
    lib = _lib()
    dtype = _DTYPES[xf.dtype]
    with torch.cuda.device(xf.device):
        blocks = lib.fedml_conv_wgrad_blocks(n, ci, co, h, w, dtype)
        if blocks < 1:
            raise ValueError(f"K4 cannot stage Ci={ci}, W={w} in shared memory")
        dw2 = torch.empty((co, 9 * ci), dtype=torch.float32, device=xf.device)
        partial = torch.empty((blocks, co, 9 * ci), dtype=torch.float32, device=xf.device)
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        barrier = barrier_words(xf.device, stream)
        LAUNCHES["conv_wgrad"] += 1
        code = lib.fedml_conv_wgrad(xf.data_ptr(), dyf.data_ptr(), partial.data_ptr(),
                                    dw2.data_ptr(), barrier.data_ptr(), n, ci, co, h, w, dtype,
                                    stream)
    _check(code, "conv_wgrad")
    return dw2


def conv_fwd(xf, w2, h: int, w: int):
    return (conv_fwd_cuda if xf.is_cuda else conv_fwd_plain)(xf, w2, h, w)


def conv_wgrad(xf, dyf, h: int, w: int):
    return (conv_wgrad_cuda if xf.is_cuda else conv_wgrad_plain)(xf, dyf, h, w)


def conv_variant(mode: str, xf, w2, h: int, w: int):
    return (conv_variant_cuda if xf.is_cuda else conv_variant_plain)(mode, xf, w2, h, w)


# -- the autograd op --------------------------------------------------------

class Conv3x3Lanes(torch.autograd.Function):
    """Forward K3; backward dx = K3 of dY with the spatially flipped,
    channel-transposed kernel (the exact transpose of a stride-1 SAME 3x3
    conv) and dW from K4, cast to the weight's dtype as the JAX vjp does."""

    @staticmethod
    def forward(ctx, xf, weight, h, w):
        ctx.save_for_backward(xf, weight)
        ctx.hw = (h, w)
        return conv_fwd(xf, _w2(weight).to(xf.dtype), h, w)

    @staticmethod
    def backward(ctx, dyf):
        xf, weight = ctx.saved_tensors
        h, w = ctx.hw
        dyf = dyf.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = torch.flip(weight, (2, 3)).transpose(0, 1)
            dx = conv_fwd(dyf, _w2(wt).to(dyf.dtype), h, w)
        if ctx.needs_input_grad[1]:
            co, ci = weight.shape[:2]
            dw = _w2_inv(conv_wgrad(xf, dyf, h, w), ci, co).to(weight.dtype)
        return dx, dw, None, None


def conv3x3_lanes(xf: torch.Tensor, weight: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """SAME-padded stride-1 3x3 conv in lanes layout: xf [N, Ci, H*W],
    weight OIHW [Co, Ci, 3, 3] -> [N, Co, H*W]."""
    return Conv3x3Lanes.apply(xf.contiguous(), weight, h, w)


def _xla_conv_nchw(xf, weight, h: int, w: int):
    """The conv the JAX package leaves to XLA (shapes outside
    ``supported()``): a plain SAME stride-1 3x3 conv on the lanes layout."""
    n, ci, hw = xf.shape
    y = F.conv2d(xf.reshape(n, ci, h, w), weight, padding=1)
    return y.to(xf.dtype).reshape(n, weight.shape[0], hw)


class Conv(nn.Module):
    """flax-named drop-in for ``nn.Conv(features, (k, k), strides, 'SAME',
    use_bias=False)`` on the lanes layout, so a lanes model has the NHWC
    model's parameter names. ``weight`` is OIHW; the input's spatial size
    comes with each call. k=3 runs K3 where ``supported()`` holds (stride 2
    = the stride-1 conv subsampled at the odd positions); k=1 is a plain
    einsum, as in the JAX package."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        if kernel_size not in (1, 3) or stride not in (1, 2):
            raise ValueError(f"lanes Conv takes kernel_size 1 or 3 and stride 1 or 2; "
                             f"got {kernel_size}, {stride}")
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))

    def reset_parameters(self, generator=None) -> None:
        o, i, kh, kw = self.weight.shape
        lecun_normal_(self.weight, i * kh * kw, generator)

    def forward(self, xf: torch.Tensor, hw: tuple) -> torch.Tensor:
        h, w = hw
        kd = self.weight.to(xf.dtype)
        if kd.shape[-1] == 1:
            if self.stride == 2:
                xf, h, w = subsample2(xf, h, w), h // 2, w // 2
            return torch.einsum("oi,nip->nop", kd[:, :, 0, 0], xf)
        if supported(xf.shape[1], h, w):
            y = conv3x3_lanes(xf, kd, h, w)
        else:
            y = _xla_conv_nchw(xf, kd, h, w)
        if self.stride == 2:
            y = subsample2(y, h, w, offset=1)
        return y
