"""Recurrent models for federated NLP (counterpart of
``fedml_tpu/models/rnn.py``), both for the ``nwp`` task (logits at every
position, ``[B, T, V]``) on integer token inputs.

- ``rnn`` (``CharLSTM``): Embed(8) -> 2 x LSTM(256) -> Dense(vocab), char-level
  Shakespeare (sequences of 80).
- ``rnn_stackoverflow`` (``StackOverflowNWP``): Embed(96) -> LSTM(670) ->
  Dense(96) -> Dense(10,004), StackOverflow next-word prediction.

:class:`OptimizedLSTMCell` keeps flax ``OptimizedLSTMCell``'s eight leaves
under their names: input kernels ``ii/if/ig/io`` (no bias) and hidden kernels
``hi/hf/hg/ho`` (with bias), gates i, f, g, o with sigmoid, sigmoid, tanh,
sigmoid, and a zero initial carry. The recurrence is torch ops over the time
axis: the four input projections of every step in one product, then one
product and the gate arithmetic a step, summed as flax sums them (hidden
projection with its bias, plus the input projection). No TPU kernel lies
behind it, and every op captures into the step's CUDA graph.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.models import ModelBundle, register_model
from fedml_tpu_torch.models.initializers import lecun_normal_, reset_submodules
from fedml_tpu_torch.models.layers import Dense, Embed

GATES = ("i", "f", "g", "o")


class _Kernel(nn.Module):
    """One of the cell's dense leaves: ``weight`` [hidden, in] (flax's
    ``kernel``, transposed), with an optional zero ``bias``."""

    def __init__(self, in_features: int, hidden: int, use_bias: bool, orthogonal: bool):
        super().__init__()
        self.orthogonal = orthogonal
        self.weight = nn.Parameter(torch.empty(hidden, in_features))
        self.bias = nn.Parameter(torch.zeros(hidden)) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        if self.orthogonal:     # flax's recurrent_kernel_init
            with torch.no_grad():
                nn.init.orthogonal_(self.weight, generator=generator)
        else:
            lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class OptimizedLSTMCell(nn.Module):
    """flax ``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over ``[B, T, in]``:
    returns every step's hidden state ``[B, T, hidden]``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module(f"i{g}", _Kernel(in_features, hidden, False, False))
            self.add_module(f"h{g}", _Kernel(hidden, hidden, True, True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_i = torch.cat([getattr(self, f"i{g}").weight for g in GATES])      # [4H, in]
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in GATES])      # [4H, H]
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        dt = torch.promote_types(x.dtype, w_i.dtype)
        xi = torch.matmul(x.to(dt), w_i.t())                                 # [B, T, 4H]
        b, t = x.shape[:2]
        h = torch.zeros(b, self.hidden, dtype=dt, device=x.device)
        c = torch.zeros_like(h)
        out = []
        for s in range(t):
            z = torch.addmm(b_h, h, w_h.t()) + xi[:, s]
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class CharLSTM(nn.Module):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8, hidden: int = 256):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim, hidden)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(hidden, hidden)
        self.Dense_0 = Dense(hidden, vocab_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.OptimizedLSTMCell_0(self.Embed_0(x))
        return self.Dense_0(self.OptimizedLSTMCell_1(h))


class StackOverflowNWP(nn.Module):
    """10,000 words and 4 special tokens (pad, bos, eos, oov), per the TFF
    baseline."""

    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96, hidden: int = 670):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim, hidden)
        self.Dense_0 = Dense(hidden, embedding_dim)
        self.Dense_1 = Dense(embedding_dim, vocab_size)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_submodules(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.Dense_0(self.OptimizedLSTMCell_0(self.Embed_0(x))))


@register_model("rnn")
def _rnn(output_dim: int = 90, seq_len: int = 80, **_):
    return ModelBundle(name="rnn", module=CharLSTM(vocab_size=output_dim or 90),
                       input_shape=(seq_len,), task="nwp")


@register_model("rnn_stackoverflow")
def _rnn_so(output_dim: int = 10004, seq_len: int = 20, **_):
    return ModelBundle(name="rnn_stackoverflow",
                       module=StackOverflowNWP(vocab_size=output_dim or 10004),
                       input_shape=(seq_len,), task="nwp")
