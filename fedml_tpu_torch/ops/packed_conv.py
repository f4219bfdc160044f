"""Lane-stacked state dicts and the joint packed conv lowerings
(counterpart of ``fedml_tpu/ops/packed_conv.py``).

The port's lane-stacked models (``CifarResNet(n_lanes=L)``) fold the L
lanes into the leading axis of every leaf: a conv weight ``[Co, Ci, k, k]``
becomes ``[L*Co, Ci, k, k]`` (the weight of a grouped conv with ``groups=L``),
a BatchNorm leaf ``[C]`` becomes ``[L*C]`` (channel ``l*C + c`` of the folded
activations), a Dense weight ``[out, in]`` becomes ``[L*out, in]``. Lane l's
leaf is therefore rows ``l*n0 .. (l+1)*n0`` of the leading axis, in memory
one contiguous block.

The conv lowerings run on the folded activations, NHWC ``[N, H, W, L*Ci]``
with lane l's channel c at ``l*Ci + c``, and give ``[N, Ho, Wo, L*Co]``:

- ``"blockdiag"`` (:func:`conv_blockdiag`): the JAX module's im2col
  block-diagonal GEMM, ``Y[P, L*Co] = P2[P, L*R] @ W_bd[L*R, L*Co]`` with
  P = N*Ho*Wo and R = Ci*kh*kw in channel-major order (``c*kh*kw + tap``).
  The patch matrix is one gather of strided windows of the (SAME-padded)
  NHWC buffer, so its column ``l*R + c*kh*kw + tap`` is lane l's channel c at
  that tap, the order of ``lax.conv_general_dilated_patches`` (and of
  ``F.unfold`` over the channels-first view). ``W_bd`` is built inside the
  forward by a broadcast multiply with ``eye(L)``, so autograd sends gradient
  only to the diagonal blocks: each lane's kernel learns from its own lane.
  The product is one ``torch.matmul``, as the JAX package's is one
  ``lax.dot_general`` in XLA outside any Pallas kernel, and its output is
  the row-major ``[rows, L*Co]`` buffer the BatchNorm kernel takes, with no
  copy between. The price is the JAX module's: the GEMM streams L x the
  useful FLOPs (the off-diagonal zeros) and the patch matrix moves up to
  kh*kw x the activation bytes, forward and backward.
- ``"grouped"`` (:func:`conv_grouped`): one ``groups=L`` conv over the
  folded channels. That is the conv the port's ``"off"`` has always run
  (JAX's ``off`` is a ``vmap`` of the per-lane conv, which XLA lowers to the
  same grouped conv), so ``"grouped"`` and ``"off"`` are one call and train
  bit for bit alike; only ``packed_status`` tells them apart.
- :func:`conv_vmap` runs the L lanes one by one, the per-lane reference the
  tests hold both lowerings against.

BatchNorm on a packed twin: the twin's BN runs over ``[rows, L*C]``, per
channel and therefore per lane, through K1/K2 with ``bn_impl="pallas"`` (one
launch of each for all lanes) and through the plain BN otherwise, whatever
the conv lowering. The JAX package builds its packed twin only for
``bn_impl="xla"`` (its Pallas BN takes one lane's rows); the port's plain BN
is that twin's per-lane ``packed_conv.BatchNorm``.

:func:`lane_major` runs a lowering on the JAX layout, activations
``[K, N, H, W, Ci]`` and stacked HWIO kernels ``[K, kh, kw, Ci, Co]``, for
the parity tests. ``"auto"`` (fedplan's per-stage plan, scored on XLA HLO)
is not ported (ROADMAP §1 item 12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedml_tpu_torch.models.layers import same_pads


def stack_variables(variables: dict, k: int) -> dict:
    """Standard state dict -> lane-stacked state dict holding ``k``
    identical copies (each lane starts from the same global model)."""
    out = {}
    for name, v in variables.items():
        if v.dim() == 0:
            raise ValueError(f"{name}: a 0-dim leaf has no axis to fold lanes into")
        out[name] = v.repeat(k, *([1] * (v.dim() - 1)))
    return out


def unstack_variables(stacked: dict, lane: int, k: int) -> dict:
    """Lane-stacked state dict of ``k`` lanes -> lane ``lane``'s standard
    state dict (bit-exact inverse of :func:`stack_variables`, a view)."""
    if not 0 <= lane < k:
        raise IndexError(f"lane {lane} out of range for {k} lanes")
    return {name: v.reshape(k, v.shape[0] // k, *v.shape[1:])[lane]
            for name, v in stacked.items()}


# -- block weight stack/unstack -----------------------------------------------

def _w2p(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Co, Ci, kh, kw]`` -> ``[Co, Ci*kh*kw]`` in patch order
    (``c*kh*kw + tap``): a view."""
    return w.reshape(w.shape[0], -1)


def _w2p_inv(w2: torch.Tensor, kh: int, kw: int, ci: int, co: int) -> torch.Tensor:
    """``[Co, Ci*kh*kw]`` -> OIHW ``[Co, Ci, kh, kw]`` (inverse of :func:`_w2p`)."""
    return w2.reshape(co, ci, kh, kw)


def block_diag_weight(w: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """Lane-folded kernels ``[L*Co, Ci, kh, kw]`` -> the block weight
    ``W_bd[L*R, L*Co]`` (R = Ci*kh*kw): lane l's im2col kernel in diagonal
    block l, structural zeros elsewhere. ``W_bd[j*R + r, k*Co + o] =
    w2[k, o, r] * eye[k, j]``, a broadcast multiply (not a scatter), so the
    gradient reaches only the diagonal blocks."""
    L = n_lanes
    w2s = _w2p(w).reshape(L, w.shape[0] // L, -1)                  # [L, Co, R]
    eye = torch.eye(L, dtype=w2s.dtype, device=w2s.device)
    wbd = eye.T[:, None, :, None] * w2s.permute(2, 0, 1)[None]      # [L, R, L, Co]
    return wbd.reshape(L * w2s.shape[2], L * w2s.shape[1])


def block_diag_unstack(wbd: torch.Tensor, k: int, kh: int, kw: int, ci: int,
                       co: int) -> torch.Tensor:
    """Block weight ``[L*R, L*Co]`` -> lane-folded kernels ``[L*Co, Ci, kh,
    kw]``: the bit-exact inverse of :func:`block_diag_weight` (the diagonal
    blocks; the rest is discarded by contract)."""
    b = wbd.reshape(k, ci * kh * kw, k, co)
    lanes = torch.arange(k, device=wbd.device)
    diag = b[lanes, :, lanes, :]                                    # [L, R, Co]
    return torch.cat([_w2p_inv(d.T, kh, kw, ci, co) for d in diag])


# -- the lowerings --------------------------------------------------------------

def _pads(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str) -> tuple:
    """((top, bottom), (left, right)) of NHWC ``x`` under ``padding``."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride)


def patches(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
            padding: str = "SAME") -> torch.Tensor:
    """NHWC ``[N, H, W, C]`` -> the im2col patches ``[N, Ho, Wo, C*kh*kw]``
    (column ``c*kh*kw + i*kw + j``): the padded buffer's strided windows,
    gathered by one copy."""
    (ht, hb), (wl, wr) = _pads(x, kh, kw, stride, padding)
    if ht or hb or wl or wr:
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)             # [N, Ho, Wo, C, kh, kw]
    return win.reshape(*win.shape[:3], -1)


def conv_blockdiag(x: torch.Tensor, w: torch.Tensor, n_lanes: int, stride: int = 1,
                   padding: str = "SAME") -> torch.Tensor:
    """L lanes' convs as ONE block-diagonal GEMM (module note). ``x`` NHWC
    ``[N, H, W, L*Ci]``, ``w`` ``[L*Co, Ci, kh, kw]``; returns the
    contiguous ``[N, Ho, Wo, L*Co]`` in x's dtype."""
    kh, kw = w.shape[2], w.shape[3]
    p = patches(x, kh, kw, stride, padding)
    wbd = block_diag_weight(w.to(x.dtype), n_lanes)
    y = torch.matmul(p.reshape(-1, p.shape[3]), wbd)                # [N*Ho*Wo, L*Co]
    return y.view(*p.shape[:3], wbd.shape[1])


def conv_grouped(x: torch.Tensor, w: torch.Tensor, n_lanes: int, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """L lanes' convs as one ``groups=L`` conv (module note; ``n_lanes=0``
    or 1 is the plain conv), channels-last. Same signature and contract as
    :func:`conv_blockdiag`."""
    (ht, hb), (wl, wr) = _pads(x, w.shape[2], w.shape[3], stride, padding)
    xc = x.permute(0, 3, 1, 2)           # channels_last memory
    if (ht, wl) == (hb, wr):
        pad = (ht, wl)
    else:
        xc = F.pad(xc, (wl, wr, ht, hb))
        pad = 0
    y = F.conv2d(xc, w.to(x.dtype), stride=stride, padding=pad, groups=max(n_lanes, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def conv_vmap(x: torch.Tensor, w: torch.Tensor, n_lanes: int, stride: int = 1,
              padding: str = "SAME") -> torch.Tensor:
    """The per-lane reference: each lane's conv alone, concatenated along
    the folded channels."""
    xs, ws = x.chunk(n_lanes, dim=3), w.chunk(n_lanes, dim=0)
    return torch.cat([conv_grouped(a, b, 1, stride, padding) for a, b in zip(xs, ws)], dim=3)


_IMPLS = {"blockdiag": conv_blockdiag, "grouped": conv_grouped, "off": conv_grouped,
          "vmap": conv_vmap}


def resolve_impl(impl: str):
    """A lowering name -> its conv function (``"off"`` is the grouped conv,
    see the module note). fedplan's per-stage plans are not ported."""
    if impl not in _IMPLS:
        raise ValueError(f"packed conv lowering must be one of {sorted(_IMPLS)}, got {impl!r}")
    return _IMPLS[impl]


def lane_major(impl: str, xs: torch.Tensor, ws: torch.Tensor, strides: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """A lowering on the JAX module's layout: ``xs`` ``[K, N, H, W, Ci]``,
    ``ws`` ``[K, kh, kw, Ci, Co]`` (stacked HWIO) -> ``[K, N, Ho, Wo, Co]``."""
    k, n, h, w, ci = xs.shape
    kh, kw, co = ws.shape[1], ws.shape[2], ws.shape[4]
    x = xs.permute(1, 2, 3, 0, 4).reshape(n, h, w, k * ci)
    wf = ws.permute(0, 4, 3, 1, 2).reshape(k * co, ci, kh, kw)
    y = resolve_impl(impl)(x, wf, k, strides, padding)
    return y.reshape(*y.shape[:3], k, co).permute(3, 0, 1, 2, 4)
