"""The port's attention (K6's plain version on CPU tensors) against the JAX
package's Pallas flash kernel in interpret mode and its XLA path.

Tolerances are the JAX package's own for the same comparisons
(tests/test_ops_sequence.py): 1e-4 against the Pallas kernel and for the
custom-VJP gradients, 1e-5 against the XLA math.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import attention as ta

# ``fedml_tpu.ops`` re-exports a function named ``attention``
ja = importlib.import_module("fedml_tpu.ops.attention")


def _qkv(b=2, h=2, t=64, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret(causal):
    """atol 1e-4 (test_pallas_interpret_matches_naive)."""
    q, k, v = _qkv(t=128, d=64)
    want = ja.attention(q, k, v, causal=causal, impl="pallas", interpret=True,
                        block_q=64, block_k=32)
    got = ta.attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_partial_matches_xla(causal):
    """The unnormalized (o, m, l) of one shifted chunk: atol 1e-5
    (test_xla_matches_naive's bound)."""
    q, k, v = _qkv(t=48, seed=1)
    want = ja.attention_block_partial(q[:, :, 16:], k, v, q_offset=16, k_offset=8,
                                      causal=causal, impl="xla")
    got = ta.attention_block_partial(*_t(q[:, :, 16:], k, v), q_offset=16, k_offset=8,
                                     causal=causal, impl="xla")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_chunked_merge_with_a_dead_chunk_matches_pallas():
    """4 K/V chunks with nonzero k_offset merged by merge_partials; the last
    chunk lies wholly in the future of the first query rows (atol 1e-4,
    test_pallas_offsets_match_chunked_reference)."""
    q, k, v = _qkv(t=64)
    n_chunks, tc = 4, 16

    def run(mod, arrays, **kw):
        q, k, v = arrays
        acc = None
        for i in range(n_chunks):
            part = mod.attention_block_partial(
                q, k[:, :, i * tc:(i + 1) * tc], v[:, :, i * tc:(i + 1) * tc],
                q_offset=0, k_offset=i * tc, causal=True, **kw)
            acc = part if acc is None else mod.merge_partials(acc, part)
        return mod.normalize_partial(*acc)

    want = run(ja, (q, k, v), impl="pallas", interpret=True, block_q=32, block_k=8)
    got = run(ta, _t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_shifted_query_window_matches_pallas():
    """q rows 32..63 against the full K/V with q_offset 32 (atol 1e-4)."""
    q, k, v = _qkv(t=64)
    want = ja.normalize_partial(*ja.attention_block_partial(
        q[:, :, 32:], k, v, q_offset=32, k_offset=0, causal=True, impl="pallas",
        interpret=True, block_q=16, block_k=16))
    got = ta.normalize_partial(*ta.attention_block_partial(
        *_t(q[:, :, 32:], k, v), q_offset=32, k_offset=0, causal=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_fully_masked_rows_are_exact():
    """A chunk wholly in the future of every query row gives m = -1e30,
    l = 0 and o = 0 exactly (never NaN), as the Pallas kernel does, and
    merging it changes nothing."""
    q, k, v = _qkv(t=16, d=16)
    o, m, l = ta.attention_block_partial(*_t(q, k, v), q_offset=0, k_offset=16, causal=True)
    want = ja.attention_block_partial(q, k, v, q_offset=0, k_offset=16, causal=True,
                                      impl="pallas", interpret=True, block_q=16, block_k=16)
    assert torch.all(m == ta.NEG_INF) and torch.all(l == 0) and torch.all(o == 0)
    np.testing.assert_array_equal(m.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(l.numpy(), np.asarray(want[2]))
    live = ta.attention_block_partial(*_t(q, k, v), causal=True)
    merged = ta.merge_partials(live, (o, m, l))
    for a, b in zip(merged, live):
        assert torch.equal(a, b)


def test_gradients_match_jax_custom_vjp():
    """dq, dk, dv of sum(attention(q, k, v)^2) through the port's autograd
    Function against JAX's custom VJP over the Pallas forward (atol 1e-4,
    test_pallas_grad_matches_xla_grad)."""
    q, k, v = _qkv(t=32, d=16, seed=7)

    def loss(args):
        return jnp.sum(ja.attention(*args, impl="pallas", interpret=True) ** 2)

    want = jax.grad(loss)((q, k, v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    (ta.attention(*leaves) ** 2).sum().backward()
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4)


def test_sliced_backward_equals_one_slice(monkeypatch):
    """The backward recomputes over slices of B*H; slicing changes no bit
    of the gradients, including the m and l cotangents of a partial."""
    q, k, v = _qkv(b=2, h=3, t=24, d=16, seed=3)
    rng = np.random.default_rng(4)
    cts = _t(rng.normal(size=(2, 3, 24, 16)).astype(np.float32),
             rng.normal(size=(2, 3, 24)).astype(np.float32),
             rng.normal(size=(2, 3, 24)).astype(np.float32))

    def grads():
        leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
        outs = ta.attention_block_partial(*leaves, q_offset=4, k_offset=0)
        return torch.autograd.grad(outs, leaves, cts)

    whole = grads()
    monkeypatch.setattr(ta, "BACKWARD_SCORE_ELEMENTS", 24 * 24 * 2)
    for a, b in zip(grads(), whole):
        assert torch.equal(a, b)


def test_bf16_inputs_keep_f32_partials_and_q_dtype_output():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(t=16, d=16)))
    o, m, l = ta.attention_block_partial(q, k, v)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    out = ta.attention(q, k, v)
    assert out.dtype == torch.bfloat16
    want = ta.attention(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=1e-2, atol=1e-2)


def _tensor_core_partial(q, k, v, q_offset, k_offset, causal, sm_scale):
    """The bf16 CUDA kernel's rounding, in plain PyTorch: bf16 q, k, v;
    scores summed in f32 (a bf16 x bf16 product is exact in f32); the f32
    p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), o = p_hi.v +
    p_lo.v summed in f32; l from the f32 p."""
    q, k, v = (t.to(torch.bfloat16).to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[2])
        kpos = k_offset + torch.arange(k.shape[2])
        s = torch.where(qpos[:, None] >= kpos[None, :], s, torch.full((), ta.NEG_INF))
    m = torch.amax(s, dim=-1)
    p = torch.where(s <= ta.NEG_INF / 2, torch.zeros(()), torch.exp(s - m[..., None]))
    p_hi = p.to(torch.bfloat16).to(torch.float32)
    p_lo = (p - p_hi).to(torch.bfloat16).to(torch.float32)
    o = torch.einsum("bhqk,bhkd->bhqd", p_hi, v) + torch.einsum("bhqk,bhkd->bhqd", p_lo, v)
    return o, m, p.sum(-1)


def _bf16_qkv(t, d, seed):
    """bf16-rounded inputs as f32 numpy arrays, so JAX sees the same values."""
    return tuple(torch.tensor(a).to(torch.bfloat16).to(torch.float32).numpy()
                 for a in _qkv(t=t, d=d, seed=seed))


@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_matches_pallas_interpret(causal):
    """The split-p numerics of the bf16 kernel against the JAX Pallas
    kernel on the same bf16 values (atol 1e-4, as
    test_plain_matches_pallas_interpret)."""
    q, k, v = _bf16_qkv(160, 32, seed=11)
    want = ja.attention(q, k, v, causal=causal, impl="pallas", interpret=True,
                        block_q=32, block_k=32)
    got = ta.normalize_partial(*_tensor_core_partial(*_t(q, k, v), 0, 0, causal, 32 ** -0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("q_offset,k_offset,causal",
                         [(0, 0, True), (0, 0, False), (40, 8, True)])
def test_tensor_core_rounding_within_kernel_tolerance_of_plain(q_offset, k_offset, causal):
    """The same emulation against the plain partial on bf16 inputs, at the
    tolerances chip_smoke.py holds the kernel to: m 1e-5, l rtol 1e-5, o/l
    2e-5. A single bf16 p (2^-9 relative) would miss o/l by far."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(t=192, d=32, seed=12)))
    args = (q_offset, k_offset, causal, 32 ** -0.5)
    o, m, l = _tensor_core_partial(q, k, v, *args)
    po, pm, pl = ta.block_partial_plain(q, k, v, *args)
    np.testing.assert_allclose(m.numpy(), pm.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), pl.numpy(), rtol=1e-5, atol=1e-5)
    den = torch.where(pl == 0, torch.ones_like(pl), pl)[..., None]
    np.testing.assert_allclose((o / den).numpy(), (po / den).numpy(), rtol=0, atol=2e-5)
    # p rounded once to bf16 instead: far outside the o/l tolerance
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * args[3]
    if causal:
        live = (q_offset + torch.arange(192))[:, None] >= (k_offset + torch.arange(192))[None, :]
        s = torch.where(live, s, torch.full((), ta.NEG_INF))
    p = torch.where(s <= ta.NEG_INF / 2, torch.zeros(()), torch.exp(s - pm[..., None]))
    o1 = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), v.float())
    assert float(((o1 - po) / den).abs().max()) > 10 * 2e-5


def test_cpu_tensors_never_reach_the_kernel():
    """Every impl runs the plain version for CPU tensors; the CUDA wrapper
    refuses them instead of falling back."""
    ta.reset_launches()
    q, k, v = _t(*_qkv(t=8, d=16))
    for impl in ("auto", "pallas", "xla"):
        ta.attention(q, k, v, impl=impl)
    assert ta.LAUNCHES["attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ta.block_partial_cuda(q, k, v, 0, 0, True, 0.25)
    with pytest.raises(ValueError, match="impl"):
        ta.attention(q, k, v, impl="triton")
