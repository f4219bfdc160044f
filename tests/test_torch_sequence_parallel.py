"""The port's sequence parallelism against the JAX package's
(``fedml_tpu/parallel/sequence.py``): ring and Ulysses attention, and the
LM train step on a ``('dp', 'sp')`` mesh.

Four ranks run as spawned gloo processes (``tests/torch_mesh_ranks.py``,
every case in one spawn; the sp = 2 attention cases on a (2, 2) mesh whose
rows each run the ring); the JAX side runs ``shard_map`` on the conftest's 8
CPU devices. Tolerances are the JAX tests' own
(``tests/test_ops_sequence.py``): attention and its gradients at atol 1e-4
against JAX's ``shard_map`` ring / Ulysses and against dense attention; the
LM step's loss at 1e-4 and its parameters at rtol 2e-4 / atol 2e-5 against
the single-device step.
Ulysses needs the heads to divide the axis, so its attention cases take 4
heads and its (1, 4) LM step 4 heads at the same width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_ranks as ranks
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu.ops.xent import masked_cross_entropy as jax_xent
from fedml_tpu.parallel.mesh import client_mesh as jax_client_mesh
from fedml_tpu.parallel import sequence as jseq
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.ops.attention import attention
from fedml_tpu_torch.parallel import sequence as tseq
from fedml_tpu_torch.parallel.mesh import bound_axes, named_mesh

VOCAB, DIM, LAYERS, T = 31, 16, 4, 8
ATTN_SHAPE = (2, 16, 8)          # B, T, D of the attention cases
STEP_MESHES = [((2, 2), "ring", 2), ((2, 2), "ulysses", 2), ((1, 4), "ring", 2),
               ((1, 4), "ulysses", 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qkv(heads: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    b, t, d = ATTN_SHAPE
    return tuple(rng.normal(size=(b, heads, t, d)).astype(np.float32) for _ in range(3))


def _heads(mode: str) -> int:
    return 4 if mode == "ulysses" else 2


@functools.lru_cache(maxsize=None)
def _lm_setup(heads: int, seed: int = 7, b: int = 4):
    jm = JaxTransformerLM(vocab_size=VOCAB, dim=DIM, heads=heads, layers=LAYERS, max_len=T,
                          attn_impl="xla")
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32)))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, VOCAB, (b, T)).astype(np.int64)
    y = rng.integers(0, VOCAB, (b, T)).astype(np.int64)
    m = (rng.random((b, T)) < 0.9).astype(np.float32)
    return jm, variables, x, y, m


def _step_case(mesh, mode, heads):
    _, variables, x, y, m = _lm_setup(heads)
    init = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    return (f"step-{mesh}-{mode}", "sp_step",
            dict(model=dict(vocab_size=VOCAB, dim=DIM, heads=heads, layers=LAYERS, max_len=T,
                            attn_impl="xla"),
                 init=init, x=x, y=y, m=m, mesh=mesh, mode=mode, lr=0.1))


def _cases() -> list:
    cases = [(f"attn-{mode}-{sp}", "attn",
              dict(mode=mode, sp=sp, **dict(zip("qkv", _qkv(_heads(mode))))))
             for mode in ("ring", "ulysses") for sp in (2, 4)]
    return cases + [_step_case(*c) for c in STEP_MESHES]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks, started at set-up; each test computes its JAX
    references before it waits for them."""
    w = ranks.Spawn(4, _cases(), tmp_path_factory.mktemp("sp"))
    yield w
    w.results()


def _jax_attention(mode: str, n: int, q, k, v):
    fn = jseq.ring_attention if mode == "ring" else jseq.ulysses_attention
    mesh = jax_client_mesh(n, axis="sp")

    def loss(q, k, v):
        out = shard_map(lambda q, k, v: fn(q, k, v, axis_name="sp", axis_size=n, causal=True,
                                           impl="xla"),
                        mesh=mesh, in_specs=(P(None, None, "sp"),) * 3,
                        out_specs=P(None, None, "sp"), check_vma=False)(q, k, v)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(a) for a in g]


def _dense(q, k, v):
    def naive(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(q.shape[-1])
        t = q.shape[2]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool))[None, None], s, -jnp.inf)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)

    out = naive(q, k, v)
    g = jax.grad(lambda q, k, v: jnp.sum(naive(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(a) for a in g]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attention_matches_jax_shard_map_and_dense(world, mode, spawned):
    q, k, v = _qkv(_heads(mode))
    refs = (_jax_attention(mode, world, q, k, v), _dense(q, k, v))
    per_rank = ranks.result(spawned, f"attn-{mode}-{world}")[:world]     # row x = 0
    got = {k: np.concatenate([r[k] for r in per_rank], axis=2) for k in ("out", "dq", "dk", "dv")}
    for ref_out, ref_grads in refs:
        np.testing.assert_allclose(got["out"], ref_out, atol=1e-4)
        for name, ref in zip(("dq", "dk", "dv"), ref_grads):
            np.testing.assert_allclose(got[name], ref, atol=1e-4, err_msg=name)


class VirtualRing:
    """Virtual rank ``index`` of a ring whose every shard lies in this
    process: hop i hands over the shard of rank ``index - i``."""

    def __init__(self, ks, vs, index):
        self.ks, self.vs, self.index, self.hops = ks, vs, index, 0

    def __call__(self, k, v):
        self.hops += 1
        src = (self.index - self.hops) % len(self.ks)
        return self.ks[src], self.vs[src]


def test_virtual_ring_through_the_hop_seam_matches_the_gloo_ring_and_dense(spawned):
    """The seam chip_smoke's phase 19 uses on one card: 4 virtual ranks in
    one process give the gloo ring's output bit for bit, and dense
    attention's gradients."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(2))
    n = 4
    qs, ks, vs = (torch.chunk(a, n, dim=2) for a in (q, k, v))
    outs = [tseq.ring_attention(qs[i], ks[i], vs[i], axis_name="sp", axis_size=n, impl="xla",
                                hop=VirtualRing(ks, vs, i)) for i in range(n)]
    out = torch.cat(outs, dim=2)
    (out ** 2).sum().backward()
    gloo = ranks.result(spawned, "attn-ring-4")
    np.testing.assert_array_equal(out.detach().numpy(), np.concatenate([r["out"] for r in gloo], 2))
    ref_out, ref_grads = _dense(*_qkv(2))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=1e-4)
    for t, ref in zip((q, k, v), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-4)


def test_chip_smoke_virtual_ulysses_matches_the_gloo_ulysses_and_dense(spawned):
    """Phase 19a's Ulysses layout on one card (``chip_smoke.virtual_ulysses``:
    the all-to-all done by hand over 4 virtual ranks) gives the gloo
    Ulysses' output bit for bit, and dense attention's."""
    import chip_smoke

    q, k, v = (torch.from_numpy(a) for a in _qkv(_heads("ulysses")))
    out = chip_smoke.virtual_ulysses(q, k, v, "xla").numpy()
    gloo = ranks.result(spawned, "attn-ulysses-4")
    np.testing.assert_array_equal(out, np.concatenate([r["out"] for r in gloo], 2))
    np.testing.assert_allclose(out, _dense(*_qkv(_heads("ulysses")))[0], atol=1e-4)


@functools.lru_cache(maxsize=None)
def _reference_step(heads: int) -> tuple:
    """The single-device step's loss and updated parameters (port names)."""
    jm, variables, x, y, m = _lm_setup(heads)

    def loss_fn(params):
        per = jax_xent(jm.apply({"params": params}, jnp.asarray(x)), jnp.asarray(y),
                       jnp.asarray(m), impl="xla")
        return jnp.sum(per) / jnp.maximum(jnp.sum(m), 1.0)

    tx = optax.sgd(0.1)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    upd, _ = tx.update(grads, tx.init(variables["params"]))
    return float(loss), flax_to_torch({"params": jax.tree.map(
        np.asarray, optax.apply_updates(variables["params"], upd))})


@pytest.mark.parametrize("mesh,mode,heads", STEP_MESHES, ids=lambda v: str(v))
def test_sp_lm_step_matches_single_device_and_jax(mesh, mode, heads, spawned):
    ref_loss, ref = _reference_step(heads)
    per_rank = ranks.result(spawned, _step_case(mesh, mode, heads)[0])
    for r, res in enumerate(per_rank):
        assert abs(res["loss"] - ref_loss) < 1e-4
        for key, want in ref.items():
            np.testing.assert_allclose(res["state"][key], want.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"rank {r} {key}")


def test_ulysses_rejects_indivisible_heads():
    q = torch.zeros(1, 3, 8, 4)
    with pytest.raises(ValueError, match="divisible"):
        tseq.ulysses_attention(q, q, q, axis_name="sp", axis_size=4)


def test_axis_of_one_rank_is_plain_attention_bit_for_bit():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2))
    want = attention(q, k, v, causal=True, impl="xla")
    with bound_axes(named_mesh(("sp",), (1,), "cpu")):
        for mode in ("ring", "ulysses"):
            got = tseq.sequence_attention(q, k, v, axis_name="sp", axis_size=1, mode=mode,
                                          impl="xla")
            assert torch.equal(got, want), mode


def test_unknown_mode_unbound_axis_and_oversized_mesh_raise():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="unknown sequence-parallel mode"):
        tseq.sequence_attention(q, q, q, axis_name="sp", axis_size=1, mode="zigzag")
    with pytest.raises(ValueError, match="unbound"):
        tseq.ring_attention(q, q, q, axis_name="sp", axis_size=2)
    with pytest.raises(ValueError, match="ranks"):
        tseq.sp_mesh(2, 2, device="cpu")
    with bound_axes(named_mesh(("sp",), (1,), "cpu")), pytest.raises(ValueError, match="axis_size"):
        tseq.ring_attention(q, q, q, axis_name="sp", axis_size=2)
