"""Decoder-only transformer LM (counterpart of
``fedml_tpu/models/transformer.py``).

Attention goes through :mod:`fedml_tpu_torch.ops.attention` (kernel K6 on
CUDA tensors). Submodules and parameters keep the flax names
(``tok_embed``, ``pos_embed``, ``block{i}/attn/qkv``, ``attn/out``,
``LayerNorm_0/1``, ``Dense_0/1``, the final ``LayerNorm_0`` and
``lm_head``), so weight conversion is a path map (``models/convert.py``).

Numerics follow flax: ``dtype`` is the compute type of every Dense,
Embed and LayerNorm (parameters stay f32), LayerNorms keep f32 statistics
with epsilon 1e-6, GELU is the tanh form, and ``lm_head`` computes in f32,
so the logits are f32. ``remat=True`` recomputes each block's activations
during the backward (``torch.utils.checkpoint``, non-reentrant), as
``nn.remat`` does; the attention kernel then runs twice per block and step.

``dropout > 0`` drops each block's attention output and MLP output in
train mode (flax ``nn.Dropout`` there, explicit-key ``seed_dropout`` here:
block i's call sites are 2i and 2i + 1, ``ops/dropout.py``);
``forward(x, dropout_key=...)`` takes the step's key, and the recomputed
block under ``remat`` draws the same masks again. The dropout is outside
the attention kernel, as in the JAX package.

With ``ring_axis`` set and ``ring_size > 1`` the module runs sequence
parallel (``parallel/sequence.py``): each attention is
``sequence_attention`` (``sp_mode`` ring or Ulysses) over that axis of
the mesh the step binds (``parallel/mesh.bound_axes``), and ``pos_offset``
places the rank's shard.

``tp_axis`` (set by ``parallel/tensor.shard_params_tp``, None otherwise)
makes a block Megatron tensor parallel over that bound axis: ``qkv`` and
``Dense_0`` hold this rank's output rows (its heads of each of q, k and v;
its slice of the MLP) behind ``f``, ``attn.out`` and ``Dense_1`` its input
columns ahead of ``g`` (``parallel/collectives``), and their biases are
added once, after the all-reduce.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.layers import Dense, Embed, LayerNorm
from fedml_tpu_torch.ops.attention import attention
from fedml_tpu_torch.ops.dropout import seed_dropout
from fedml_tpu_torch.parallel.collectives import copy_to_line, reduce_from_line
from fedml_tpu_torch.parallel.mesh import axis_line


def row_parallel(dense: Dense, x: torch.Tensor, line) -> torch.Tensor:
    """A row-parallel Dense: this rank's partial product over its input
    columns, summed over the line (``g``), then the replicated bias."""
    dt = dense.dtype or torch.promote_types(x.dtype, dense.weight.dtype)
    return reduce_from_line(line, F.linear(x.to(dt), dense.weight.to(dt))) + dense.bias.to(dt)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, attn_impl: str = "auto",
                 ring_axis: Optional[str] = None, ring_size: int = 1, sp_mode: str = "ring",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.attn_impl = dim, heads, attn_impl
        self.ring_axis, self.ring_size, self.sp_mode = ring_axis, ring_size, sp_mode
        self.tp_axis: Optional[str] = None
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, _ = h.shape
        d = self.dim // self.heads
        line = axis_line(self.tp_axis) if self.tp_axis else None
        if line is not None:
            h = copy_to_line(line, h)
        q, k, v = torch.chunk(self.qkv(h), 3, dim=-1)
        width = q.shape[-1]                  # this rank's heads * d

        def heads_first(a):
            return a.reshape(b, t, width // d, d).transpose(1, 2)

        q, k, v = heads_first(q), heads_first(k), heads_first(v)
        if self.ring_axis is not None and self.ring_size > 1:
            from fedml_tpu_torch.parallel.sequence import sequence_attention

            o = sequence_attention(q, k, v, axis_name=self.ring_axis, axis_size=self.ring_size,
                                   causal=True, impl=self.attn_impl, mode=self.sp_mode)
        else:
            o = attention(q, k, v, causal=True, impl=self.attn_impl)
        o = o.transpose(1, 2).reshape(b, t, width)
        return self.out(o) if line is None else row_parallel(self.out, o, line)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, dropout: float = 0.0,
                 attn_impl: str = "auto", ring_axis: Optional[str] = None, ring_size: int = 1,
                 sp_mode: str = "ring", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.tp_axis: Optional[str] = None
        self.site = 0        # the attention output's call site; the MLP's is site + 1
        self.attn = SelfAttention(dim, heads, attn_impl, ring_axis, ring_size, sp_mode, dtype)
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype)
        self.Dense_0 = Dense(dim, mlp_ratio * dim, dtype=dtype)
        self.Dense_1 = Dense(mlp_ratio * dim, dim, dtype=dtype)

    def forward(self, h: torch.Tensor, dropout_key: Optional[torch.Tensor] = None):
        off = not self.training
        a = seed_dropout(self.attn(self.LayerNorm_0(h)), dropout_key, self.dropout, self.site,
                         off)
        h = h + a
        u = self.LayerNorm_1(h)
        line = axis_line(self.tp_axis) if self.tp_axis else None
        if line is not None:
            u = copy_to_line(line, u)
        m = F.gelu(self.Dense_0(u), approximate="tanh")
        m = self.Dense_1(m) if line is None else row_parallel(self.Dense_1, m, line)
        return h + seed_dropout(m, dropout_key, self.dropout, self.site + 1, off)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int, dim: int = 256, heads: int = 8, layers: int = 4,
                 mlp_ratio: int = 4, max_len: int = 4096, dropout: float = 0.0,
                 attn_impl: str = "auto", ring_axis: Optional[str] = None, ring_size: int = 1,
                 sp_mode: str = "ring", remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        # the configuration the pipeline's stages and the sp step read
        self.dim, self.heads, self.mlp_ratio, self.dropout = dim, heads, mlp_ratio, dropout
        self.dtype, self.ring_axis, self.ring_size = dtype, ring_axis, ring_size
        self.tok_embed = Embed(vocab_size, dim, dtype=dtype)
        self.pos_embed = Embed(max_len, dim, dtype=dtype)
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block{i}", Block(dim, heads, mlp_ratio, dropout, attn_impl,
                                               ring_axis, ring_size, sp_mode, dtype))
            getattr(self, f"block{i}").site = 2 * i
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.lm_head = Dense(dim, vocab_size, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh weights from ``generator``, in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, pos_offset: int = 0,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, T] token ids -> [B, T, vocab] f32 logits; ``dropout_key``
        the step's key (train mode with ``dropout > 0``)."""
        t = x.shape[1]
        h = self.tok_embed(x)
        pos = pos_offset + torch.arange(t, device=x.device)
        h = h + self.pos_embed(pos)[None]
        for i in range(self.layers):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, dropout_key, use_reentrant=False)
            else:
                h = block(h, dropout_key)
        return self.lm_head(self.LayerNorm_0(h))


def _bundle(name: str, vocab: int, seq_len: int, **kw) -> ModelBundle:
    sizes = dict(dim=kw.pop("dim", 256), heads=kw.pop("heads", 8),
                 layers=kw.pop("layers", 4), dropout=kw.pop("dropout", 0.0),
                 mlp_ratio=kw.pop("mlp_ratio", 4))
    module = TransformerLM(vocab_size=vocab, max_len=max(4096, seq_len),
                           attn_impl=kw.pop("attn_impl", "auto"),
                           ring_axis=kw.pop("ring_axis", None),
                           ring_size=kw.pop("ring_size", 1),
                           sp_mode=kw.pop("sp_mode", "ring"),
                           remat=kw.pop("remat", False),
                           dtype=kw.pop("dtype", torch.float32), **sizes)
    return ModelBundle(name=name, module=module, input_shape=(seq_len,),
                       uses_dropout=sizes["dropout"] > 0)


@register_model("transformer")
def _transformer(output_dim: int = 90, seq_len: int = 80, **kw):
    return _bundle("transformer", output_dim or 90, seq_len, **kw)


@register_model("transformer_nwp")
def _transformer_nwp(output_dim: int = 10004, seq_len: int = 20, **kw):
    return _bundle("transformer_nwp", output_dim or 10004, seq_len, **kw)
