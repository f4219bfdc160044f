"""The port's transformer LM path against the JAX package's: the model
(weights converted from flax), the world-size-1 LM train step, the
shakespeare data, the nwp task and one FedAvg round.

Tolerances: logits and losses rtol 1e-5 / atol 1e-5 (f32 on both sides,
summed in other orders), gradients rtol 1e-4 / atol 1e-5 (the gradient
tolerance of tests/test_torch_resnet.py); the LM step's loss to 1e-4 and
its updated parameters at rtol 2e-4 / atol 2e-5, as
test_sp_training_step_grads_match_single_device holds the JAX step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.tasks import nwp_loss as jax_nwp_loss
from fedml_tpu.core.tasks import nwp_metrics as jax_nwp_metrics
from fedml_tpu.data import shakespeare as jshk
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu.ops.xent import masked_cross_entropy as jax_xent
from fedml_tpu.parallel.sequence import make_sp_lm_train_step as jax_lm_step
from fedml_tpu.parallel.sequence import sp_mesh as jax_sp_mesh
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.tasks import nwp_loss, nwp_metrics
from fedml_tpu_torch.data import shakespeare as tshk
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models.transformer import Block, SelfAttention, TransformerLM
from fedml_tpu_torch.ops.xent import masked_cross_entropy
from fedml_tpu_torch.parallel import sequence as tseq
from fedml_tpu_torch.parallel.local import make_optimizer

SMALL = dict(vocab_size=50, dim=32, heads=2, layers=2, max_len=32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed=5, b=4, t=32, vocab=50):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    y = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    mask = (rng.random((b, t)) < 0.9).astype(np.float32)
    return x, y, mask


def _pair(**kw):
    """A flax TransformerLM, its initial variables and the port's module
    loaded with them."""
    jm = JaxTransformerLM(**SMALL, attn_impl="xla")
    variables = _np_tree(jm.init(jax.random.key(0), jnp.zeros((1, 32), jnp.int32)))
    tm = TransformerLM(**SMALL, **kw)
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    return jm, variables, tm


def _assert_grads_close(tm, grads_flax):
    got = torch_to_flax({k: p.grad for k, p in tm.named_parameters()})["params"]
    la, ta = jax.tree_util.tree_flatten_with_path(_np_tree(grads_flax))
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_model_logits_loss_and_grads_match_flax():
    jm, variables, tm = _pair()
    x, y, mask = _batch()

    def loss_fn(params):
        logits = jm.apply({"params": params}, x)
        per = jax_xent(logits, y, mask, impl="xla")
        return jnp.sum(per) / jnp.maximum(jnp.sum(mask), 1.0), logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    logits_t = tm(torch.tensor(x))
    assert logits_t.shape == (4, 32, 50) and logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    per = masked_cross_entropy(logits_t, torch.tensor(y), torch.tensor(mask))
    loss_t = per.sum() / torch.tensor(mask).sum()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    loss_t.backward()
    _assert_grads_close(tm, grads_j)


def test_remat_is_bit_identical():
    """Checkpointed blocks recompute the same activations: loss and
    gradients equal the plain module's bit for bit (test_remat_is_exact)."""
    _, variables, m0 = _pair()
    m1 = TransformerLM(**SMALL, remat=True)
    m1.load_state_dict(flax_to_torch(variables))
    x = torch.tensor(_batch()[0])
    losses = []
    for m in (m0, m1):
        loss = (m(x) ** 2).mean()
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    for (name, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_pos_offset_shifts_the_positional_embedding():
    _, _, tm = _pair()
    x = torch.tensor(_batch(t=8)[0])
    with torch.no_grad():
        a = tm(x, pos_offset=3)
        tm.pos_embed.embedding[:8] = tm.pos_embed.embedding[3:11].clone()
        b = tm(x)
    assert torch.equal(a, b)


def test_world_size_one_lm_step_matches_jax():
    """One SGD step (lr 0.1) of the port's LM step against JAX's
    make_sp_lm_train_step on a 1x1 (dp, sp) mesh."""
    _, variables, tm = _pair()
    x, y, mask = _batch(seed=7)
    jmod = JaxTransformerLM(**SMALL, attn_impl="xla", ring_axis="sp", ring_size=1)
    tx = optax.sgd(0.1)
    jstep = jax_lm_step(jmod, tx, jax_sp_mesh(1, 1), attn_impl="xla")
    new_vars, _, loss_j = jstep(jax.tree.map(jnp.array, variables),
                                tx.init(variables["params"]), x, y, mask, jax.random.key(1))

    step = tseq.make_sp_lm_train_step(tm, tseq.sp_mesh(1, 1, device="cpu"), attn_impl="auto")
    opt = make_optimizer("sgd", 0.1)(tm.parameters())
    loss_t = step(opt, torch.tensor(x), torch.tensor(y), torch.tensor(mask))
    assert loss_t.dim() == 0 and not loss_t.requires_grad
    assert abs(float(loss_t) - float(loss_j)) < 1e-4
    got = torch_to_flax(tm.state_dict())["params"]
    la, ta = jax.tree_util.tree_flatten_with_path(_np_tree(new_vars["params"]))
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5, err_msg=str(path))


@pytest.mark.parametrize("loader,kw", [
    ("load_fed_shakespeare", dict(client_num_in_total=100, batch_size=4, seed=0)),
    ("load_shakespeare", dict(client_num_in_total=20, batch_size=8, seed=3)),
])
def test_shakespeare_synthetic_data_is_bit_equal(loader, kw, tmp_path):
    a = getattr(tshk, loader)(data_dir=str(tmp_path), **kw)
    b = getattr(jshk, loader)(data_dir=str(tmp_path), **kw)
    for f in ("train_x", "train_y", "train_mask", "train_counts", "test_x", "test_y",
              "test_mask"):
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.class_num, a.task, a.name) == (b.class_num, b.task, b.name)


def test_nwp_task_matches_jax():
    """Sequence (per-record [B]) and per-token ([B, T]) masks; rtol 1e-6."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 6, 11)).astype(np.float32)
    y = rng.integers(0, 11, (4, 6)).astype(np.int32)
    for mask in ((rng.random(4) > 0.3).astype(np.float32),
                 (rng.random((4, 6)) > 0.3).astype(np.float32)):
        args = (torch.tensor(logits), torch.tensor(y), torch.tensor(mask))
        np.testing.assert_allclose(float(nwp_loss(*args)),
                                   float(jax_nwp_loss(logits, y, mask)), rtol=1e-6)
        mt, mj = nwp_metrics(*args), jax_nwp_metrics(logits, y, mask)
        assert sorted(mt) == sorted(mj)
        for k in mt:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6)


def test_fedavg_round_matches_jax():
    """One FedAvg round of a small registered ``transformer`` (dim 32, 2
    heads, 2 layers, seq_len 16) on the synthetic fed_shakespeare stream,
    the port handed JAX's shuffle orders (as in test_torch_fedavg.py):
    loss rtol 1e-5, aggregated parameters rtol 1e-4 / atol 1e-5."""
    seed, epochs, cohort = 0, 1, 2
    data = dict(name="nwp-parity", num_clients=4, vocab=90, seq_len=16, batch_size=4,
                seed=seed)
    run = dict(model="transformer", dataset="fed_shakespeare", client_num_in_total=4,
               client_num_per_round=cohort, comm_round=1, batch_size=4, epochs=epochs,
               lr=0.1, momentum=0.9, frequency_of_the_test=1, seed=seed, device_data="off")
    sizes = dict(seq_len=16, dim=32, heads=2, layers=2)
    jds = jshk._synthetic_nwp(**data)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**run, bucket_quantum_batches=0, pack_lanes=0),
                        jax_create_model("transformer", 90, **sizes))
    ds = tshk._synthetic_nwp(**data)
    n_pad = ds.train_x.shape[1]

    def orders(r, i):
        rk = jax.random.fold_in(jax.random.key(seed), r)
        ck = jax.random.split(rk, cohort)[i]
        return [torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
                for ek in jax.random.split(ck, epochs)]

    api = FedAvgAPI(ds, FedConfig(**run), create_model("transformer", 90, **sizes),
                    device="cpu", order_hook=orders)
    api.variables = flax_to_torch(_np_tree(japi.variables))
    np.testing.assert_allclose(api.run_round(0), japi.run_round(0), rtol=1e-5)
    got = torch_to_flax(api.variables)
    la, ta = jax.tree_util.tree_flatten_with_path(_np_tree(japi.variables))
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=str(path))
    ev_j, ev_t = japi.evaluate_global(), api.evaluate_global()
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(ev_t["acc"], ev_j["acc"], rtol=1e-5)


def test_converter_round_trips_a_transformer_tree():
    jb = jax_create_model("transformer_nwp", 100, seq_len=8, dim=32, heads=2, layers=2)
    variables = _np_tree(jb.init(jax.random.key(0), batch_size=1))
    state = flax_to_torch(variables)
    tb = create_model("transformer_nwp", 100, seq_len=8, dim=32, heads=2, layers=2)
    tb.module.load_state_dict(state, strict=True)
    assert state["block0.attn.qkv.weight"].shape == (96, 32)
    assert state["lm_head.weight"].shape == (100, 32)
    assert state["pos_embed.embedding"].shape == (4096, 32)
    back = torch_to_flax(tb.module.state_dict())
    la, ta = jax.tree_util.tree_flatten_with_path(variables)
    lb, tb_ = jax.tree_util.tree_flatten_with_path(back)
    assert ta == tb_
    for (path, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_port_init_matches_flax_initialisers():
    """Embed: normal of variance 1/dim; Dense: lecun normal, zero bias;
    LayerNorm: ones and zeros (statistics, not bits)."""
    tb = create_model("transformer_nwp", 10004, dim=256)
    state = tb.init(0, device="cpu")
    emb = state["tok_embed.embedding"]
    assert abs(float(emb.std()) - 256 ** -0.5) < 0.01 * 256 ** -0.5
    assert float(emb.abs().max()) > 4 * 256 ** -0.5          # not truncated
    qkv = state["block0.attn.qkv.weight"]
    assert abs(float(qkv.std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert float(qkv.abs().max()) <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(state["block0.attn.qkv.bias"], torch.zeros(768))
    assert torch.equal(state["block1.LayerNorm_0.scale"], torch.ones(256))
    assert torch.equal(state["LayerNorm_0.bias"], torch.zeros(256))


def test_bf16_model_computes_in_bf16_with_f32_logits():
    tb = create_model("transformer", 90, seq_len=16, dim=32, heads=2, layers=1,
                      dtype=torch.bfloat16)
    tb.init(0, device="cpu")
    assert all(p.dtype == torch.float32 for p in tb.module.parameters())
    logits = tb.module(torch.zeros(2, 16, dtype=torch.int32))
    assert logits.dtype == torch.float32 and logits.shape == (2, 16, 90)
    h = tb.module.block0.LayerNorm_0(torch.randn(2, 16, 32).to(torch.bfloat16))
    assert h.dtype == torch.bfloat16


_TOKENS = torch.zeros(1, 4, dtype=torch.int64)
_QKV = torch.zeros(1, 2, 4, 16)


@pytest.mark.parametrize("build", [
    lambda: TransformerLM(50, dim=32, heads=2, ring_axis="sp", ring_size=2)(_TOKENS),
    lambda: TransformerLM(50, dim=32, heads=2, dropout=0.1, ring_size=2).train()(_TOKENS),
    lambda: Block(32, 2, ring_axis="sp", ring_size=4)(torch.zeros(1, 4, 32)),
    lambda: SelfAttention(32, 2, ring_axis="sp", ring_size=2)(torch.zeros(1, 4, 32)),
    lambda: create_model("transformer", 90, dropout=0.1, ring_size=2).module.train()(_TOKENS),
    lambda: tseq.sp_mesh(1, 2, device="cpu"),
    lambda: tseq.make_sp_lm_train_step(TransformerLM(**SMALL), tseq.sp_mesh(2, 1, device="cpu")),
    lambda: tseq.ring_attention(_QKV, _QKV, _QKV, axis_name="sp", axis_size=2),
    lambda: tseq.ulysses_attention(_QKV, _QKV, _QKV, axis_name="sp", axis_size=2),
])
def test_unported_sequence_parallelism_and_dropout_raise(build):
    """Sequence parallelism is ported (tests/test_torch_sequence_parallel.py);
    what is left to refuse: an sp axis that no step binds (JAX's unbound
    axis name), a mesh larger than the process group, and a dropout model
    in train mode without its key."""
    with pytest.raises(ValueError):
        build()
