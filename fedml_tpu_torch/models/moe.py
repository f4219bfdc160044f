"""Mixture-of-experts transformer blocks (counterpart of
``fedml_tpu/models/moe.py``).

The MoE MLP keeps its expert weights stacked on a leading expert axis,
``w_up [E, D, F]``, ``b_up [E, F]``, ``w_dn [E, F, D]``, ``b_dn [E, D]``,
in the flax layout as they are (``models/convert.py`` copies them without
a transpose), beside a replicated f32 ``router`` Dense. Routing is the
dense softmax-weighted top-k dispatch of the JAX package: every expert
computes every token and the router weights combine them, so the layer
has no capacity drop and equals its single-device form under expert
parallelism.

``ep_axis`` (set by ``parallel/tensor.shard_params_ep``, None otherwise)
makes the layer expert parallel over that bound axis: the rank holds
experts ``[r*E/n, (r+1)*E/n)``, its tokens and routing weights enter
through ``f`` (one backward all-reduce of both), and its experts' partial
combine is summed over the axis by ``g`` (``parallel/collectives``).
Attention is the transformer's ``SelfAttention`` (kernel K6 on CUDA
tensors). Not registered under a model name, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.initializers import lecun_normal_
from fedml_tpu_torch.models.layers import Dense, Embed, LayerNorm
from fedml_tpu_torch.models.transformer import SelfAttention
from fedml_tpu_torch.parallel.collectives import copy_to_line, reduce_from_line
from fedml_tpu_torch.parallel.mesh import axis_line


def top_k_probs(router_logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Softmax the router logits, keep each token's top-k experts and
    renormalize the kept weights to sum to 1 (differentiable)."""
    E = router_logits.shape[-1]
    probs = torch.softmax(router_logits, dim=-1)
    if top_k < E:
        kth = torch.sort(probs, dim=-1).values[..., E - top_k, None]
        probs = torch.where(probs >= kth, probs, torch.zeros((), device=probs.device))
        probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    return probs


class MoeMlp(nn.Module):
    """Softmax-routed top-k mixture of expert MLPs (dense dispatch)."""

    def __init__(self, dim: int, num_experts: int = 4, mlp_ratio: int = 4, top_k: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E, D, Fh = num_experts, dim, mlp_ratio * dim
        self.num_experts, self.top_k, self.dtype = num_experts, top_k, dtype
        self.ep_axis: Optional[str] = None
        self.router = Dense(D, E, dtype=torch.float32)
        self.w_up = nn.Parameter(torch.empty(E, D, Fh))
        self.b_up = nn.Parameter(torch.zeros(E, Fh))
        self.w_dn = nn.Parameter(torch.empty(E, Fh, D))
        self.b_dn = nn.Parameter(torch.zeros(E, D))

    def reset_parameters(self, generator=None) -> None:
        """flax ``lecun_normal`` on [E, in, out]: fan-in E * in (the router
        is reset as a submodule)."""
        for w in (self.w_up, self.w_dn):
            lecun_normal_(w, w.shape[0] * w.shape[1], generator)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_dn.zero_()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        probs = top_k_probs(self.router(h.to(torch.float32)), self.top_k)     # [B, T, E]
        dt = self.dtype
        if self.ep_axis is not None:
            line = axis_line(self.ep_axis)
            h, probs = copy_to_line(line, h, probs)
            per = self.w_up.shape[0]
            probs = probs[..., line.index * per:(line.index + 1) * per]
        h = h.to(dt)
        up = torch.einsum("btd,edf->ebtf", h, self.w_up.to(dt)) + self.b_up.to(dt)[:, None, None]
        act = F.gelu(up, approximate="tanh")
        down = (torch.einsum("ebtf,efd->ebtd", act, self.w_dn.to(dt))
                + self.b_dn.to(dt)[:, None, None])
        out = torch.einsum("bte,ebtd->btd", probs.to(dt), down)
        return out if self.ep_axis is None else reduce_from_line(line, out)


class MoeBlock(nn.Module):
    def __init__(self, dim: int, heads: int, num_experts: int = 4, mlp_ratio: int = 4,
                 top_k: int = 2, attn_impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = SelfAttention(dim, heads, attn_impl, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.moe = MoeMlp(dim, num_experts, mlp_ratio, top_k, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.LayerNorm_0(h))
        return h + self.moe(self.LayerNorm_1(h))


class MoeTransformerLM(nn.Module):
    """Decoder-only LM with MoE MLPs, the expert-parallel counterpart of
    ``TransformerLM``: ``forward(x, pos_offset=0)`` -> f32 logits."""

    def __init__(self, vocab_size: int, dim: int = 256, heads: int = 8, layers: int = 4,
                 num_experts: int = 4, mlp_ratio: int = 4, top_k: int = 2, max_len: int = 4096,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = layers
        self.tok_embed = Embed(vocab_size, dim, dtype=dtype)
        self.pos_embed = Embed(max_len, dim, dtype=dtype)
        for i in range(layers):
            self.add_module(f"block{i}", MoeBlock(dim, heads, num_experts, mlp_ratio, top_k,
                                                  attn_impl, dtype))
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype)
        self.lm_head = Dense(dim, vocab_size, dtype=torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh weights from ``generator``, in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        t = x.shape[1]
        h = self.tok_embed(x)
        h = h + self.pos_embed(pos_offset + torch.arange(t, device=x.device))[None]
        for i in range(self.layers):
            h = getattr(self, f"block{i}")(h)
        return self.lm_head(self.LayerNorm_0(h))
