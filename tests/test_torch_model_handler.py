"""Automatic embedding placement (elasticdl_tpu_torch/common/model_handler.py
and the PS trainer's automatic path) against the JAX package's
model_handler: which tables move, the derived ids feed, the refusal of a
table applied twice, one step's pushed gradients, the export into the stock
model, and the flagship LM's shape (tiny) under the PS, whose tables return
float32 rows. Also the LM's embedding modules against the gathers they
replaced."""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import auto_embedding_test_module as jax_auto
from elasticdl_tpu.common import model_handler as jax_mh
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.layers.embedding import EMBEDDING_COLLECTION
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.ops import optimizers as joptim
from elasticdl_tpu.ps.parameter_server import (
    ParameterServer as JaxParameterServer,
)
from elasticdl_tpu.worker.ps_client import PSClient as JaxPSClient
from elasticdl_tpu.worker.ps_trainer import (
    ParameterServerTrainer as JaxPSTrainer,
)
from elasticdl_tpu_torch.common import model_handler, tensor_utils
from elasticdl_tpu_torch.common.params import params_from_flax
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.ps.parameter_server import ParameterServer
from elasticdl_tpu_torch.worker.ps_client import PSClient
from elasticdl_tpu_torch.worker.ps_trainer import ParameterServerTrainer

torch.set_num_threads(1)

# float32 sums in another order in the two frameworks, as a share of the
# largest value compared.
RTOL = 1e-5


class AutoEmbeddingModel(nn.Module):
    """The torch counterpart of tests/auto_embedding_test_module.py: a
    320-byte item table, a 24-byte flag table, a dense head."""

    def __init__(self):
        super().__init__()
        self.item_emb = nn.Embedding(jax_auto.VOCAB, jax_auto.EMB_DIM)
        self.flag_emb = nn.Embedding(3, 2)
        self.Dense_0 = nn.Linear(jax_auto.EMB_DIM + 2 + jax_auto.DENSE_DIM,
                                 1)

    def forward(self, features):
        item = self.item_emb(features["ids"]).sum(dim=-2)
        flag = self.flag_emb(features["flag"])
        return self.Dense_0(torch.cat([item, flag, features["x"]], dim=-1))


def _mse(labels, predictions):
    labels = torch.as_tensor(labels).to(predictions)
    return torch.mean((predictions.reshape(-1) - labels.reshape(-1)) ** 2)


def _features(n=8, seed=0):
    return jax_auto.feed(jax_auto.make_records(n, seed=seed), "training",
                         None)


def _jax_swapped(model, features, **kw):
    """The tables JAX's wrapper moves to the PS, from a trace alone."""
    wrapped = jax_mh.wrap_model_for_ps(model, **kw)
    shapes = jax.eval_shape(lambda: wrapped.init(
        jax.random.PRNGKey(0), features, training=False))
    return set(shapes.get(EMBEDDING_COLLECTION, {}))


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


@pytest.mark.parametrize("threshold,capacity,moved", [
    (64, 0, {"item_emb"}), (16, 0, {"item_emb", "flag_emb"}),
    (64, 1024, set()), (64, 128, {"item_emb"}),
    (model_handler.DEFAULT_THRESHOLD_BYTES, 0, set()),
])
def test_tables_moved_are_the_jax_wrappers(threshold, capacity, moved):
    features, _ = _features()
    model = model_handler.wrap_model_for_ps(
        AutoEmbeddingModel(), threshold, device_capacity_bytes=capacity)
    got = model_handler.discover_tables(model)
    assert set(got) == moved == _jax_swapped(
        jax_auto.custom_model(), features, threshold_bytes=threshold,
        device_capacity_bytes=capacity)
    for table in moved:
        assert got[table] == (getattr(model, table).embedding_dim,
                              getattr(model, table).num_embeddings)
    # A moved table holds no parameters; the others are untouched.
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert not names & moved and "Dense_0" in names


class _Column(nn.Module):
    """Ids from one column of a [B, F] feature."""

    def __init__(self):
        super().__init__()
        self.t = nn.Embedding(40, 4)

    def forward(self, features):
        return self.t(features["pair"][:, 1]).sum(-1)


class _JaxColumn(fnn.Module):
    @fnn.compact
    def __call__(self, features, training=False):
        return fnn.Embed(40, 4, name="t")(features["pair"][:, 1]).sum(-1)


class _Computed(nn.Module):
    """Ids computed inside the forward: captured per batch."""

    def __init__(self):
        super().__init__()
        self.t = nn.Embedding(17, 4)

    def forward(self, features):
        return self.t((features["ids"] * 3 + 1) % 17).sum(-2)


class _JaxComputed(fnn.Module):
    @fnn.compact
    def __call__(self, features, training=False):
        ids = (features["ids"] * 3 + 1) % 17
        return fnn.Embed(17, 4, name="t")(ids).sum(axis=-2)


def _pair_features(n, seed):
    features, _ = _features(n, seed)
    rng = np.random.default_rng(seed)
    features["pair"] = rng.integers(0, 40, size=(n, 3))
    return features


@pytest.mark.parametrize("case", ["exact", "column", "computed"])
def test_derived_feed_is_the_jax_feed(case):
    torch_model, jax_model = {
        "exact": (AutoEmbeddingModel, jax_auto.custom_model),
        "column": (_Column, _JaxColumn),
        "computed": (_Computed, _JaxComputed),
    }[case]
    sample, other = _pair_features(8, 0), _pair_features(5, 1)
    model = model_handler.wrap_model_for_ps(torch_model(), 16)
    tables = model_handler.discover_tables(model)

    def forward(features):
        return model({k: torch.as_tensor(v) for k, v in features.items()})

    feed = model_handler.derive_embedding_inputs(forward, sample,
                                                 tuple(tables))
    wrapped = jax_mh.wrap_model_for_ps(jax_model(), threshold_bytes=16)
    variables = wrapped.init(jax.random.PRNGKey(0), sample, training=False)
    jax_feed = jax_mh.derive_embedding_inputs(wrapped, dict(variables),
                                              sample)
    got, want = feed(other), jax_feed(other)
    assert sorted(got) == sorted(want) == sorted(tables)
    for table in want:
        np.testing.assert_array_equal(got[table], want[table])


def test_a_table_applied_twice_is_refused():
    class Shared(nn.Module):
        def __init__(self):
            super().__init__()
            self.shared = nn.Embedding(50, 4)
            self.Dense_0 = nn.Linear(4, 1)

        def forward(self, features):
            a = self.shared(features["ids"])
            b = self.shared(features["ids"] % 7)
            return self.Dense_0((a + b).sum(-2))

    features, labels = _features()
    trainer = ParameterServerTrainer(
        Shared(), _mse, optimizers.sgd(0.1), PSClient([None]),
        embedding_threshold_bytes=16, device="cpu")
    with pytest.raises(ValueError, match="more than once per forward"):
        trainer.init_variables_if_needed(features)
    model = model_handler.wrap_model_for_ps(Shared(), 16)
    rows = {"shared": torch.zeros(16, 4)}
    with pytest.raises(ValueError, match="more than once per forward"):
        with model_handler.ps_rows(rows):
            model({"ids": torch.as_tensor(features["ids"])})


def _capture_pushes(client):
    pushes = []
    inner = client.push_gradients

    def push(dense, sparse, version, **kw):
        pushes.append((
            {k: np.array(v) for k, v in dense.items()},
            {t: (np.array(v), np.array(i)) for t, (v, i) in sparse.items()},
        ))
        return inner(dense, sparse, version, **kw)

    client.push_gradients = push
    return pushes


def _jax_first_push(model, loss, optimizer, features, labels, threshold):
    """The JAX PS trainer's first push (automatic placement) through two
    localhost gRPC shards, and its starting dense weights."""
    servers = [JaxParameterServer(i, 2, optimizer_spec=optimizer)
               for i in range(2)]
    try:
        client = JaxPSClient([s.addr for s in servers], worker_id=0,
                             wire_dtype="float32")
        trainer = JaxPSTrainer(
            model, loss, optimizer, client, pipeline_pushes=False,
            prefetch_overlap=False, embedding_threshold_bytes=threshold)
        pushes = _capture_pushes(client)
        trainer.init_variables_if_needed(features)
        named, _ = flatten_params(jax.device_get(
            trainer._variables["params"]))
        loss_value = float(trainer.train_minibatch(features, labels)[2])
        client.close()
    finally:
        for s in servers:
            s.stop()
    return {k: np.asarray(v) for k, v in named.items()}, loss_value, pushes


def _port_first_push(model, loss, optimizer, named, features, labels,
                     threshold):
    shards = [ParameterServer(i, 2, optimizer_spec=optimizer)
              for i in range(2)]
    client = PSClient([s.stub() for s in shards], worker_id=0,
                      wire_dtype="float32")
    trainer = ParameterServerTrainer(
        model, loss, optimizer, client, pipeline_pushes=False,
        prefetch_overlap=False, embedding_threshold_bytes=threshold,
        device="cpu")
    pushes = _capture_pushes(client)
    # The JAX names carry the wrapper's scope; the model's do not.
    scope = model_handler.WRAPPER_SCOPE + "/"
    trainer.load_flax_params({k[len(scope):]: v for k, v in named.items()})
    loss_value = float(trainer.train_minibatch(features, labels)[2])
    return trainer, client, loss_value, pushes


def _assert_same_push(ours, theirs, rtol=RTOL):
    dense, sparse = ours
    j_dense, j_sparse = theirs
    assert sorted(dense) == sorted(j_dense)
    for name in dense:
        _close(dense[name], j_dense[name], name, rtol)
    assert sorted(sparse) == sorted(j_sparse)
    for table in sparse:
        values, ids = tensor_utils.deduplicate_indexed_slices(*sparse[table])
        j_values, j_ids = tensor_utils.deduplicate_indexed_slices(
            np.asarray(j_sparse[table][0], np.float32), j_sparse[table][1])
        np.testing.assert_array_equal(ids, j_ids)
        _close(values, j_values, table, rtol)


def test_auto_placement_step_and_export_match_jax():
    features, labels = _features(16)
    threshold = jax_auto.embedding_threshold_bytes
    optimizer = optimizers.sgd(0.05)
    named, j_loss, j_pushes = _jax_first_push(
        jax_auto.custom_model(), jax_auto.loss, joptim.sgd(0.05), features,
        labels, threshold)
    trainer, client, loss, pushes = _port_first_push(
        AutoEmbeddingModel(), _mse, optimizer, named, features, labels,
        threshold)
    assert sorted(trainer._embedding_dims) == ["item_emb"]
    assert all(k.startswith("inner/") for k in pushes[0][0])
    assert abs(loss - j_loss) <= RTOL * abs(j_loss)
    _assert_same_push(pushes[0], j_pushes[0])
    # The export loads into the stock model, which computes what the PS
    # trainer computes.
    want = trainer.evaluate_minibatch(features)
    exported = trainer.export_variables()["variables"]
    assert exported["item_emb/embedding"].shape == (jax_auto.VOCAB,
                                                    jax_auto.EMB_DIM)
    stock = AutoEmbeddingModel()
    stock.load_state_dict(params_from_flax(exported, stock))
    with torch.no_grad():
        got = stock({k: torch.as_tensor(v) for k, v in features.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    client.close()


LM = dict(vocab=512, d_model=64, n_heads=2, n_layers=2, max_len=64,
          activation_dtype="float32")
# tok_emb 512 x 64 and pos_emb 64 x 64 float32 (128 KiB, 16 KiB) move.
LM_THRESHOLD = 1024


def test_tiny_lm_under_the_ps_matches_jax(monkeypatch):
    tokens = synthetic_lm_tokens(2, 64, vocab=512, seed=0)
    x, y = tokens[:, :-1], tokens[:, 1:]
    # The JAX package's derive_embedding_inputs walks the features as a
    # dict; the LM's are one array (its tokens), taken here as the leaf at
    # () as the port takes them.
    walk = jax_mh.walk_dict
    monkeypatch.setattr(jax_mh, "walk_dict", lambda tree, path=(): (
        iter([((), tree)]) if not hasattr(tree, "items") else walk(tree)))
    named, j_loss, j_pushes = _jax_first_push(
        jlm.custom_model(jlm.LMConfig(**LM)), jlm.loss, jlm.optimizer(),
        x, y, LM_THRESHOLD)
    trainer, client, loss, pushes = _port_first_push(
        tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss, tlm.optimizer(),
        named, x, y, LM_THRESHOLD)
    assert sorted(trainer._embedding_dims) == ["pos_emb", "tok_emb"]
    feed = trainer._embedding_inputs(x)
    np.testing.assert_array_equal(feed["tok_emb"], x)
    np.testing.assert_array_equal(feed["pos_emb"], np.arange(64))
    assert abs(loss - j_loss) <= RTOL * abs(j_loss)
    _assert_same_push(pushes[0], j_pushes[0])
    client.close()


def test_moved_lm_tables_return_float32_rows():
    """Under the PS the LM adds the PS's float32 rows without its
    activation dtype (the JAX swap's behaviour): the same as a stock
    bfloat16 LM whose two tables compute in float32."""
    cfg = tlm.LMConfig(**dict(LM, activation_dtype="bfloat16"))
    stock = tlm.TransformerLM(cfg)
    stock.init_weights(torch.Generator().manual_seed(0))
    tables = {n: getattr(stock, n).weight.detach().clone()
              for n in ("tok_emb", "pos_emb")}
    moved = tlm.TransformerLM(cfg)
    moved.load_state_dict(stock.state_dict())
    model_handler.wrap_model_for_ps(moved, LM_THRESHOLD)
    tokens = torch.as_tensor(synthetic_lm_tokens(2, 32, vocab=512)[:, :32])
    rows = {"tok_emb": tables["tok_emb"][tokens.reshape(-1).long()],
            "pos_emb": tables["pos_emb"][:32]}
    with torch.no_grad(), model_handler.ps_rows(rows):
        got = moved(tokens)
    with torch.no_grad():
        bf16_tables = stock(tokens)
        stock.tok_emb.compute_dtype = stock.pos_emb.compute_dtype = (
            torch.float32)
        want = stock(tokens)
    assert torch.equal(got, want)
    assert not torch.equal(got, bf16_tables)


def test_lm_embedding_modules_equal_the_gathers_they_replaced():
    """The LM's Embed modules give the values and gradients of the direct
    gathers the LM used before (table cast to bfloat16, then gathered;
    positions sliced)."""
    cfg = tlm.LMConfig(vocab=128, d_model=32, n_heads=2, n_layers=2,
                       max_len=16)
    model = tlm.TransformerLM(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(synthetic_lm_tokens(2, 12, vocab=128)[:, :12])

    def before(lm, tokens):
        x = F.embedding(tokens.long(), lm.tok_emb.weight.to(torch.bfloat16))
        pos = lm.pos_emb.weight[:tokens.shape[1]].to(torch.bfloat16)
        return x + pos[None]

    results = []
    for embed in (tlm.embed_input, before):
        model.zero_grad()
        x = embed(model, tokens)
        logits = tlm.head_output(model, model.Block_0(model.Block_1(x)))
        logits.float().square().mean().backward()
        results.append([logits.detach()] + [p.grad.clone()
                                            for p in model.parameters()])
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_jax_lm_embed_is_cast_then_gathered():
    """The JAX LM's Embed computes in the activation dtype, as the port's
    Embed: the same bfloat16 values from the same table."""
    table = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    ids = np.array([[3, 1, 15]])
    want = fnn.Embed(16, 8, dtype=jnp.bfloat16).apply(
        {"params": {"embedding": table}}, ids)
    embed = tlm.Embed(16, 8, torch.bfloat16)
    embed.weight.data = torch.as_tensor(table)
    got = embed(torch.as_tensor(ids))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
