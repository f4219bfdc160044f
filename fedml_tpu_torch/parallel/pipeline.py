"""GPipe pipeline parallelism for the transformer LM (counterpart of
``fedml_tpu/parallel/pipeline.py``), over a ``('dp', 'pp')`` mesh and its
3-D ``('dp', 'pp', 'sp')`` form.

The L blocks' parameters stack on a leading ``[L]`` axis
(:func:`stack_pipeline_params`); stage s of the ``pp`` axis keeps blocks
``[s*L/S, (s+1)*L/S)`` and every stage keeps the ``outer`` parameters
(embeddings, the final LayerNorm, ``lm_head``) (:func:`place_pp_params`).
A step runs the JAX package's schedule: each ``pp`` rank's ``[B/dp, ...]``
rows split into ``M`` microbatches, and ``M + S - 1`` ticks, on each of
which stage 0 takes the next microbatch's embedding, every other stage
the activation the previous stage sent it, and every stage then takes
part in one ring hop of its output (``lax.ppermute``'s ring). A stage runs
its blocks only on its ``M`` live ticks; on a bubble tick it sends zeros.
Only the last stage runs the head and kernel K5, on its M outputs.

The backward is the same schedule reversed, run explicitly: every tick's
blocks are one autograd graph from a detached input, and on each tick from
the last every stage backpropagates its output's cotangent and takes part
in one reverse hop of its input's (the transpose of ``ppermute``). Every
rank therefore makes the same hops in the same order, forward and back,
and no collective can wait on a rank that skipped it. With ``sp`` the
blocks run ring or Ulysses attention over ``'sp'`` inside each tick.

Gradients: ``outer`` is SUM all-reduced over every axis (the embedding's
lives on stage 0, the head's on the last), ``blocks`` over ``dp`` (and
``sp``) only, as at JAX's ``psum``s; the loss over every axis, the token
count (the last stage's) before the differentiated loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.core.optim import Optimizer
from fedml_tpu_torch.ops.xent import masked_cross_entropy
from fedml_tpu_torch.parallel.collectives import all_reduce_sum_, shift_tensors
from fedml_tpu_torch.parallel.mesh import NamedMesh, bound_axes, named_mesh
from fedml_tpu_torch.parallel.sequence import local_block


def pp_mesh(n_dp: int, n_pp: int, device=None) -> NamedMesh:
    """The 2-D ``('dp', 'pp')`` mesh: batch over dp, layer stages over pp."""
    return named_mesh(("dp", "pp"), (n_dp, n_pp), device)


def pp3d_mesh(n_dp: int, n_pp: int, n_sp: int, device=None) -> NamedMesh:
    """The ``('dp', 'pp', 'sp')`` mesh: batch x pipeline stages x sequence."""
    return named_mesh(("dp", "pp", "sp"), (n_dp, n_pp, n_sp), device)


def stack_pipeline_params(state: dict, layers: int) -> dict:
    """A ``TransformerLM`` state dict regrouped: ``blocks`` maps each
    block parameter's name to the ``[L, ...]`` stack of ``block0`` ...
    ``block{L-1}``'s; everything else goes to ``outer``."""
    outer = {k: v for k, v in state.items() if not k.startswith("block")}
    names = [k[len("block0."):] for k in state if k.startswith("block0.")]
    blocks = {n: torch.stack([state[f"block{i}.{n}"] for i in range(layers)]) for n in names}
    return {"outer": outer, "blocks": blocks}


def unstack_pipeline_params(pp_params: dict, layers: int) -> dict:
    """Inverse of :func:`stack_pipeline_params`: a ``TransformerLM`` state dict."""
    state = dict(pp_params["outer"])
    for n, stack in pp_params["blocks"].items():
        for i in range(layers):
            state[f"block{i}.{n}"] = stack[i]
    return state


def place_pp_params(pp_params: dict, mesh: NamedMesh) -> dict:
    """This rank's parameters, as leaves on the mesh's device that
    gradients accumulate into: every ``outer`` one, and the ``[L/S, ...]``
    slice of the blocks its stage runs."""
    def leaf(t):
        return t.detach().clone().to(mesh.device).requires_grad_(True)

    return {"outer": {k: leaf(v) for k, v in pp_params["outer"].items()},
            "blocks": {k: leaf(v[mesh.block(v.shape[0], "pp")])
                       for k, v in pp_params["blocks"].items()}}


def pipeline_parameters(pp_params: dict) -> list:
    """The leaves of :func:`place_pp_params` in one fixed order (the
    optimizer's): ``outer`` then ``blocks``, each in key order."""
    return [pp_params[g][k] for g in ("outer", "blocks") for k in sorted(pp_params[g])]


def _make_pp_step(module, mesh: NamedMesh, n_micro: Optional[int], attn_impl: str,
                  sp_axis: Optional[str], sp_mode: str, xent_impl: str) -> Callable:
    from fedml_tpu_torch.models.transformer import Block

    S = mesh.shape["pp"]
    n_sp = mesh.shape[sp_axis] if sp_axis else 1
    M = n_micro or S
    if module.layers % S:
        raise ValueError(f"layers ({module.layers}) not divisible by pp ({S})")
    if module.dropout:
        raise ValueError("pipeline step runs eval-mode blocks; dropout must be 0 (reference "
                         "LMs train without dropout)")
    dtype = module.dtype
    block = Block(module.dim, module.heads, module.mlp_ratio, 0.0, attn_impl,
                  sp_axis if n_sp > 1 else None, n_sp, sp_mode, dtype)
    axes = ("dp", "pp") + ((sp_axis,) if sp_axis else ())
    every, data = mesh.line(*axes), mesh.line("dp", *((sp_axis,) if sp_axis else ()))
    ring = mesh.line("pp")
    stage = ring.index
    last = stage == S - 1

    def stage_apply(blocks: dict, h):
        for j in range(next(iter(blocks.values())).shape[0]):
            h = functional_call(block, {k: v[j] for k, v in blocks.items()}, (h,))
        return h

    def embed(outer, xm, pos_start):
        tok, pos = outer["tok_embed.embedding"], outer["pos_embed.embedding"]
        tl = xm.shape[-1]
        h = F.embedding(xm.long(), tok) + pos[pos_start:pos_start + tl][None]
        return h.to(dtype)

    def head(outer, h):
        h = functional_call(module.LayerNorm_0, {"scale": outer["LayerNorm_0.scale"],
                                                 "bias": outer["LayerNorm_0.bias"]}, (h,))
        return F.linear(h.to(torch.float32), outer["lm_head.weight"], outer["lm_head.bias"])

    def step(pp_params: dict, opt: Optimizer, x, y, mask) -> torch.Tensor:
        cols = sp_axis if sp_axis else None
        x, y, mask = (local_block(mesh, t, "dp", cols) for t in (x, y, mask))
        b, tl = x.shape
        if b % M:
            raise ValueError(f"per-dp-shard batch ({b}) not divisible by n_micro ({M}); pick a "
                             "global batch that is a multiple of n_dp * n_micro")
        mb = b // M
        pos_start = mesh.coord(sp_axis) * tl if sp_axis else 0
        total = mask.to(torch.float32).sum() * float(last)
        all_reduce_sum_(every, [total])
        total = torch.clamp(total, min=1.0)
        outer, blocks = pp_params["outer"], pp_params["blocks"]
        opt.zero_grad(set_to_none=False)
        ticks = M + S - 1
        live = [stage <= tk < stage + M for tk in range(ticks)]
        loss = torch.zeros(1, device=x.device)
        with bound_axes(mesh):
            h0 = embed(outer, x.reshape(M, mb, tl), pos_start) if stage == 0 else None
            zeros = torch.zeros((mb, tl, module.dim), dtype=dtype, device=x.device)
            state, ins, outs = zeros, [], []
            for tk in range(ticks):
                sin = out = None
                if live[tk]:
                    src = h0[tk] if stage == 0 else state
                    sin = src.detach().requires_grad_(True)
                    out = stage_apply(blocks, sin)
                ins.append(sin)
                outs.append(out)
                state = shift_tensors(ring, [zeros if out is None else out.detach()])[0]
            g_out = {}
            if last:
                ys = [outs[tk].detach().requires_grad_(True) for tk in range(S - 1, ticks)]
                logits = head(outer, torch.cat(ys).view(b, tl, module.dim))
                per = masked_cross_entropy(logits, y, mask, impl=xent_impl)
                local = per.sum() / total
                local.backward()
                loss = local.detach().reshape(1)
                g_out = {S - 1 + m: t.grad for m, t in enumerate(ys)}
            g_recv, d_h0 = None, []
            for tk in reversed(range(ticks)):
                g = g_out.get(tk) if last else g_recv
                d_in = None
                if live[tk] and g is not None:
                    torch.autograd.backward(outs[tk], g)
                    d_in = ins[tk].grad
                if stage == 0 and live[tk]:
                    d_h0.append(d_in if d_in is not None else torch.zeros_like(zeros))
                send = d_in if (stage > 0 and d_in is not None) else zeros
                if tk > 0:
                    g_recv = shift_tensors(ring, [send], -1)[0]
            if stage == 0:
                torch.autograd.backward(h0, torch.stack(d_h0[::-1]))
        all_reduce_sum_(every, [outer[k].grad for k in sorted(outer)] + [loss])
        all_reduce_sum_(data, [blocks[k].grad for k in sorted(blocks)])
        opt.step()
        return loss[0]

    return step


def make_pp_lm_train_step(module, mesh: NamedMesh, *, n_micro: Optional[int] = None,
                          attn_impl: str = "auto", xent_impl: str = "auto") -> Callable:
    """Build the GPipe train step ``step(pp_params, opt, x, y, mask) ->
    loss`` over a ``('dp', 'pp')`` mesh. ``module`` is the ``TransformerLM``
    whose configuration the stages run (its own weights are not read);
    ``pp_params`` this rank's :func:`place_pp_params` leaves and ``opt`` an
    optimizer bound to :func:`pipeline_parameters` of them, both updated in
    place; ``x``/``y``/``mask`` the global ``[B, T]`` batch, whose ``dp``
    rows split into ``n_micro`` (default S) microbatches. ``module.layers``
    must divide into ``mesh.shape['pp']`` stages."""
    return _make_pp_step(module, mesh, n_micro, attn_impl, None, "ring", xent_impl)


def make_pp_sp_lm_train_step(module, mesh: NamedMesh, *, n_micro: Optional[int] = None,
                             attn_impl: str = "auto", sp_mode: str = "ring",
                             xent_impl: str = "auto") -> Callable:
    """The GPipe step with sequence-parallel attention inside each stage,
    over a ``('dp', 'pp', 'sp')`` mesh: activations are also sequence
    sharded (each rank takes its ``[B/dp, T/sp]`` block), and each block
    runs ring (or Ulysses) attention over ``'sp'`` while microbatches hop
    ``'pp'``. ``module``'s ring fields are overridden, as in the JAX
    package."""
    return _make_pp_step(module, mesh, n_micro, attn_impl, "sp", sp_mode, xent_impl)
