"""Differentiable collectives over a line of a named mesh
(``parallel/mesh.AxisLine``): the JAX package's ``ppermute``,
``all_to_all`` and ``psum`` inside ``shard_map``, each with the transpose
JAX derives for it, as ``torch.autograd.Function``s.

- :func:`ring_hop`: rank i sends to ``(i + 1) % n`` and receives from
  ``(i - 1) % n`` (``batch_isend_irecv``); the backward is the reverse
  hop. Several tensors travel in one message.
- :func:`all_to_all`: the tiled all-to-all that scatters ``split`` and
  gathers ``concat``; the backward is the inverse all-to-all.
- Megatron's pair: :func:`copy_to_line` (``f``: identity forward, SUM
  all-reduce of the gradients backward) and :func:`reduce_from_line`
  (``g``: SUM all-reduce forward, identity backward).
- :func:`all_reduce_sum`: ``psum``, whose transpose is ``psum``.
- :func:`all_gather_rows`: rows gathered in line order; the backward sums
  the gradients over the line and keeps this rank's rows.

A line of one rank with no group is the identity everywhere; the world
group of one rank still takes its all-reduces (a one-rank NCCL group
enqueues no kernel for them). The step-level reductions that autograd does
not see (gradients, token counts) are ``parallel/crosssilo.all_reduce_flat``
over the line.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from fedml_tpu_torch.parallel.mesh import AxisLine


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> tuple:
    parts = torch.split(flat, [t.numel() for t in like])
    return tuple(p.view(t.shape) for p, t in zip(parts, like))


def _shift(line: AxisLine, tensors: Sequence[torch.Tensor], shift: int) -> tuple:
    """Send ``tensors`` (one dtype) ``shift`` places along the ring of the
    line and receive the ones ``shift`` places behind."""
    n = line.size
    send = _flat([t.contiguous() for t in tensors])
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, line.ranks[(line.index + shift) % n], line.group),
           dist.P2POp(dist.irecv, recv, line.ranks[(line.index - shift) % n], line.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unflat(recv, tensors)


def shift_tensors(line: AxisLine, tensors: Sequence[torch.Tensor], shift: int = 1) -> tuple:
    """The ring hop without autograd (the pipeline's schedule, which runs
    its reverse hops itself): ``shift = 1`` forward, ``-1`` back."""
    if line.size == 1:
        return tuple(tensors)
    return _shift(line, tensors, shift)


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, *tensors):
        ctx.line = line
        return _shift(line, tensors, 1)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(ctx.line, grads, -1))


def ring_hop(line: AxisLine, *tensors: torch.Tensor) -> tuple:
    """``ppermute`` over the ring ``i -> i + 1`` (its transpose backward)."""
    if line.size == 1:
        return tensors
    return _RingHop.apply(line, *tensors)


class Ring:
    """The ring of a line as ``ring_attention`` takes it: this rank's
    ``index`` and one hop of (k, v), ``ring(k, v) -> (k, v)``. The seam
    (``ring_attention(..., hop=)``) takes any object of this form."""

    def __init__(self, line: AxisLine):
        self.line = line
        self.index = line.index

    def __call__(self, *tensors):
        return ring_hop(self.line, *tensors)


def _a2a(line: AxisLine, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
    n = line.size
    shape = list(x.shape)
    parts = torch.stack(torch.chunk(x, n, dim=split))            # [n, ...] by destination
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts.contiguous(), group=line.group)
    shape[split] //= n
    shape[concat] *= n
    return torch.cat(out.unbind(0), dim=concat).reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, split, concat, x):
        ctx.args = (line, split, concat)
        return _a2a(line, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        line, split, concat = ctx.args
        return None, None, None, _a2a(line, g.contiguous(), concat, split)


def all_to_all(line: AxisLine, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split, concat_axis=concat,
    tiled=True)``: chunk j of ``split`` goes to the line's rank j, and the
    chunks received are concatenated along ``concat`` in rank order."""
    if line.size == 1:
        return x
    return _AllToAll.apply(line, split, concat, x)


def _reduce(line: AxisLine, t: torch.Tensor) -> torch.Tensor:
    if line.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=line.group)
    return t


class _CopyToLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, *tensors):
        ctx.line = line
        return tensors

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(None if g is None else _reduce(ctx.line, g.contiguous().clone())
                        for g in grads))


def copy_to_line(line: AxisLine, *tensors: torch.Tensor):
    """Megatron's ``f``: the tensors as they are, whose gradients are
    summed over the line in one backward (one all-reduce a tensor, in
    argument order), so two inputs never race for the line."""
    out = _CopyToLine.apply(line, *tensors) if line.group is not None else tensors
    return out[0] if len(tensors) == 1 else out


class _ReduceFromLine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, x):
        return _reduce(line, x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return None, g


def reduce_from_line(line: AxisLine, x: torch.Tensor) -> torch.Tensor:
    """Megatron's ``g``: the SUM over the line of each rank's partial
    ``x``; the gradient passes as it is."""
    return _ReduceFromLine.apply(line, x) if line.group is not None else x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, x):
        ctx.line = line
        return _reduce(line, x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return None, _reduce(ctx.line, g.contiguous().clone())


def all_reduce_sum(line: AxisLine, x: torch.Tensor) -> torch.Tensor:
    """``psum`` over the line, differentiable (its backward is ``psum``)."""
    return _AllReduceSum.apply(line, x) if line.group is not None else x


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, line, x):
        ctx.line, ctx.rows = line, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(line.size)]
        dist.all_gather(parts, x.contiguous(), group=line.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(ctx.line, g.contiguous().clone())
        i, n = ctx.line.index, ctx.rows
        return None, g[i * n:(i + 1) * n]


def all_gather_rows(line: AxisLine, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in line
    order; the gradient of this rank's rows is the line's sum of theirs."""
    if line.size == 1:
        return x
    return _AllGatherRows.apply(line, x)


def all_reduce_sum_(line: AxisLine, tensors: Sequence[torch.Tensor]) -> None:
    """SUM over the line, without autograd, of every tensor in one flat f32
    buffer, written back in place."""
    from fedml_tpu_torch.parallel.crosssilo import all_reduce_flat

    if line.group is None:
        return
    for dst, r in zip(tensors, all_reduce_flat(line, tensors)):
        dst.copy_(r)
