"""Row-sharded embedding tables (elasticdl_tpu_torch/parallel/
sharded_embedding.py) and DeepFM's sharded tables (models/dac_ctr/
{common,deepfm}.py): the lookup over a group of threads bitwise against a
plain take, its gradients against autograd through the take, the module,
and DeepFM with its tables sharded against the replicated port model and
against the JAX package's custom_sharded_model on its 8-device mesh, on
the same weights and batch."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.dac_ctr import deepfm as jdeepfm
from elasticdl_tpu_torch.common.params import flax_leaves, load_flax
from elasticdl_tpu_torch.models.dac_ctr import deepfm
from elasticdl_tpu_torch.parallel.sharded_embedding import (
    ShardedEmbed,
    padded_vocab,
    shard_table_rows,
    sharded_embed_spec,
    sharded_embedding_lookup,
)
from elasticdl_tpu_torch.parallel.shards import run_group
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

torch.set_num_threads(1)

N = 8  # the JAX side's CPU devices (tests/conftest.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _split(x, group):
    b = x.shape[0] // group.size
    return x[group.rank * b:(group.rank + 1) * b]


@pytest.mark.parametrize("n", [2, 4])
def test_lookup_matches_take_bitwise(n):
    rng = np.random.default_rng(0)
    vocab, dim = 61, 5  # padded to a multiple of n
    table = torch.as_tensor(rng.normal(size=(vocab, dim)), dtype=torch.float32)
    ids = torch.as_tensor(np.concatenate(
        [rng.integers(0, vocab, size=(4 * n - 2, 7)),
         [[0] * 7, [vocab - 1] * 7]]))
    blocks = shard_table_rows(table, n)
    assert sum(b.shape[0] for b in blocks) == padded_vocab(vocab, n)

    out = run_group(n, lambda g: sharded_embedding_lookup(
        blocks[g.rank], _split(ids, g), g), axis="data")
    assert torch.equal(torch.cat(out), F.embedding(ids, table))


def test_lookup_gradients_match_take():
    """The backward routes each row gradient to the block that owns it:
    the blocks' gradients joined equal autograd through the plain take
    within 1e-6."""
    rng = np.random.default_rng(1)
    vocab, dim, n = 40, 3, 4
    table = torch.as_tensor(rng.normal(size=(vocab, dim)), dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(0, vocab, size=(16, 4)))
    w = torch.as_tensor(rng.normal(size=(16, 4, dim)), dtype=torch.float32)
    full = table.clone().requires_grad_()
    (F.embedding(ids, full) * w).sum().backward()

    def member(g):
        block = shard_table_rows(table, n)[g.rank].clone().requires_grad_()
        (sharded_embedding_lookup(block, _split(ids, g), g)
         * _split(w, g)).sum().backward()
        return block.grad

    got = torch.cat(run_group(n, member, axis="data"))
    np.testing.assert_allclose(got.numpy(), full.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_sharded_embed_module_and_spec():
    def member(g):
        emb = ShardedEmbed(50, 4, g)
        gen = torch.Generator()
        gen.manual_seed(g.rank)
        emb.init_weights(gen)
        ids = torch.as_tensor(np.random.default_rng(2).integers(
            0, 50, size=(8, 3)))
        return emb.embedding.detach(), emb(_split(ids, g)), ids

    out = run_group(2, member, axis="data")
    table = torch.cat([o[0] for o in out])
    assert table.shape == (padded_vocab(50, 2), 4)
    ids = out[0][2]
    assert torch.equal(torch.cat([o[1] for o in out]),
                       F.embedding(ids, table))
    assert sharded_embed_spec() == ("data", None)
    names = [x.name for x in flax_leaves(deepfm.DeepFMCriteo(vocab=16))]
    specs = deepfm.sharded_param_specs(names)
    assert specs["CTREmbeddings_0/deep"] == ("data", None)
    assert specs["CTREmbeddings_0/wide"] == ("data", None)
    assert specs["DNN_0/Dense_0/kernel"] == ()


def _ctr_batch(vocab, batch=32, seed=3):
    rng = np.random.default_rng(seed)
    return ({"dense": rng.normal(size=(batch, 13)).astype(np.float32),
             "ids": rng.integers(0, vocab, size=(batch, 39)).astype(
                 np.int32)},
            rng.integers(0, 2, batch).astype(np.int64))


def _sharded_step(named, features, labels, vocab, n):
    """Each of n members (threads of one gloo group) holds its block of
    both tables and its batch shard; its loss is weighted by 1/n, so the
    sum is the batch's mean. Returns the loss and the flax-layout
    gradients: the tables' blocks joined (pad rows cut), every other
    parameter's summed over the members."""

    def member(g):
        model = deepfm.custom_sharded_model(g, vocab=vocab)
        model.to_empty(device="cpu")
        mine = dict(named)
        for t in ("wide", "deep"):
            mine[f"CTREmbeddings_0/{t}"] = shard_table_rows(
                torch.as_tensor(named[f"CTREmbeddings_0/{t}"]),
                g.size)[g.rank]
        load_flax(model, mine)
        feats = {k: torch.as_tensor(_split(v, g)) for k, v in
                 features.items()}
        loss = deepfm.loss(_split(labels, g), model(feats)) / g.size
        loss.backward()
        return loss.detach(), {x.name: x.to_flax(x.param.grad)
                               for x in flax_leaves(model)}

    out = run_group(n, member, axis="data")
    grads = {}
    for name in out[0][1]:
        parts = [o[1][name] for o in out]
        grads[name] = (torch.cat(parts)[:vocab]
                       if name.rsplit("/", 1)[-1] in ("wide", "deep")
                       else sum(parts))
    return float(sum(o[0] for o in out)), grads


def test_deepfm_sharded_matches_replicated_and_jax():
    """DeepFM with its tables sharded over 8 members against the
    replicated port model and against the JAX package's
    custom_sharded_model on its 8-device mesh, from the JAX model's
    weights: loss within rtol 1e-5, gradients within 1e-4 of the largest
    (the JAX test's tolerances)."""
    vocab = 157  # padded to 160
    features, labels = _ctr_batch(vocab)
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
    jmodel = jdeepfm.custom_sharded_model(mesh, vocab=vocab)
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: jmodel.init(k, features, training=False)).lower(
        key).compile(compiler_options=FAST_COMPILE)(key)["params"]
    shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), jdeepfm.sharded_param_specs(params),
        is_leaf=lambda v: isinstance(v, P))

    def loss_of(p):
        return jdeepfm.loss(labels, jmodel.apply({"params": p}, features,
                                                 training=True))

    with mesh:
        placed = jax.device_put(params, shardings)
        jloss, jgrads = jax.jit(jax.value_and_grad(loss_of)).lower(
            placed).compile(compiler_options=FAST_COMPILE)(placed)
    named = {k: np.array(v) for k, v in flatten_params(params)[0].items()}
    jgrads = {k: np.asarray(v) for k, v in flatten_params(jgrads)[0].items()}

    rep = deepfm.DeepFMCriteo(vocab=padded_vocab(vocab, N))
    rep.to_empty(device="cpu")
    load_flax(rep, named)
    loss = deepfm.loss(labels, rep({k: torch.as_tensor(v)
                                    for k, v in features.items()}))
    loss.backward()
    loss = loss.item()
    want = {x.name: x.to_flax(x.param.grad) for x in flax_leaves(rep)}

    got_loss, got = _sharded_step(named, features, labels,
                                  padded_vocab(vocab, N), N)
    assert got_loss == pytest.approx(loss, rel=1e-5)
    assert got_loss == pytest.approx(float(jloss), rel=1e-5)
    for name, value in want.items():
        for reference in (value.numpy(), jgrads[name]):
            np.testing.assert_allclose(
                got[name].numpy(), reference, rtol=1e-4,
                atol=1e-4 * np.abs(reference).max(), err_msg=name)
