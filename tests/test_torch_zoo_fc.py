"""The feature-column zoo models (census_fc/wide_deep_fc, deepctr/wdl)
against the JAX package's from the same weights: feeds, the forward, the
loss, every gradient and one Adam step; and the Criteo TSV converter
against the JAX package's on a file the test writes.

Tolerances, as a share of the largest value compared: outputs 1e-5,
gradients 1e-4 (float32 summed in another order); parameters after one
step as tests/test_torch_ctr.py bounds them."""

import gzip

import numpy as np
import optax
import pytest
import torch

import jax
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.data.gen import criteo_tsv as jcriteo_tsv
from elasticdl_tpu.models.census_fc import wide_deep_fc as jwide_deep_fc
from elasticdl_tpu.models.deepctr import wdl as jwdl
from elasticdl_tpu_torch.common.params import flax_leaves, params_to_flax
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.data.gen import criteo_tsv
from elasticdl_tpu_torch.data.gen.criteo import iter_criteo_records
from elasticdl_tpu_torch.data.recordfile import RecordFile
from elasticdl_tpu_torch.models.census_fc import wide_deep_fc
from elasticdl_tpu_torch.models.dac_ctr import feature_config as criteo_fc
from elasticdl_tpu_torch.models.deepctr import wdl
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

torch.set_num_threads(1)

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0}

MODELS = {
    "wide_deep_fc": (wide_deep_fc, jwide_deep_fc,
                     lambda: wide_deep_fc.make_records(48, seed=4)),
    "wdl": (wdl, jwdl, lambda: list(iter_criteo_records(48, seed=5))),
}


def _close(got, want, what, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def _nest(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax_forward_gradients_and_one_step(name):
    module, jmod, make_records = MODELS[name]
    records = make_records()
    features, labels = module.feed(records, "training", None)
    jfeatures, jlabels = jmod.feed(records, "training", None)
    assert sorted(features) == sorted(jfeatures)
    for key in jfeatures:
        np.testing.assert_array_equal(features[key], jfeatures[key])
    np.testing.assert_array_equal(labels, jlabels)
    if name == "wdl":
        # Raw Criteo ids, hashed in the model.
        assert features["C3"].dtype == np.int64
        assert features["C3"].max() > wdl.HASH_BUCKETS

    model = module.custom_model().to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    named = params_to_flax(model)
    jmodel = jmod.custom_model()
    tx = jmod.optimizer().to_optax()

    def step(p, feats):
        def loss_of(q):
            logits = jmodel.apply({"params": q}, feats)
            return jmod.loss(labels, logits), logits

        (loss, logits), grads = jax.value_and_grad(loss_of, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, logits, grads, optax.apply_updates(p, updates)

    args = (_nest(named), jfeatures)
    jloss, jlogits, grad_tree, after_tree = jax.jit(step).lower(
        *args).compile(compiler_options=FAST_COMPILE)(*args)
    jgrads = {k: np.asarray(v)
              for k, v in flatten_params(grad_tree)[0].items()}
    want = {k: np.asarray(v)
            for k, v in flatten_params(after_tree)[0].items()}

    logits = model({k: torch.as_tensor(v) for k, v in features.items()})
    loss = module.loss(labels, logits)
    loss.backward()
    _close(logits.detach(), jlogits, "logits", OUT_RTOL)
    assert abs(loss.item() - float(jloss)) <= OUT_RTOL * abs(float(jloss))
    leaves = flax_leaves(model)
    assert sorted(x.name for x in leaves) == sorted(jgrads)
    for leaf in leaves:
        _close(leaf.to_flax(leaf.param.grad), jgrads[leaf.name], leaf.name,
               GRAD_RTOL)

    # One Adam step through the port's LocalTrainer from the same weights.
    spec = module.optimizer()
    trainer = LocalTrainer(module.custom_model(), module.loss, spec,
                           device="cpu")
    trainer.load_flax_params(named)
    trainer.train_minibatch(features, labels)
    after = trainer.export_variables()["variables"]
    lr, eps = spec.hyperparams["learning_rate"], spec.hyperparams["epsilon"]
    for key, value in want.items():
        # Adam's first update is lr * g / (|g| + eps): where a gradient is
        # about 0, its rounding moves the update by up to lr.
        g = np.abs(jgrads[key])
        noise = GRAD_RTOL * g.max()
        bound = 1e-6 + np.minimum(2 * lr, lr * noise * eps / (g + eps) ** 2)
        np.testing.assert_array_less(np.abs(after[key] - value), bound,
                                     err_msg=key)


def _tsv_lines(n, seed=0):
    """DAC lines with missing fields and 8-hex-digit categoricals."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        dense = ["" if rng.random() < 0.1 else str(int(rng.integers(0, 1000)))
                 for _ in range(criteo_fc.NUM_DENSE)]
        cats = ["" if rng.random() < 0.1 else f"{rng.integers(0, 2**32):08x}"
                for _ in range(criteo_fc.NUM_CATEGORICAL)]
        lines.append("\t".join([str(rng.integers(0, 2))] + dense + cats))
    return lines


def _decoded(path):
    with RecordFile(str(path)) as rf:
        return [{k: v.tolist() for k, v in decode_example(r).items()}
                for r in rf.read(0, rf.num_records)]


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_criteo_tsv_convert_matches_jax(tmp_path, suffix):
    """convert() on a TSV file (gzip too) with a blank line and a limit:
    record for record the JAX converter's output, decoded; parse_line's
    missing values and its refusal of a short line."""
    lines = _tsv_lines(30)
    path = str(tmp_path / f"train{suffix}")
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("\n".join(lines[:5] + [""] + lines[5:]) + "\n")
    assert criteo_tsv.main(["--input", path, "--output",
                            str(tmp_path / "port.edlr"), "--limit",
                            "25"]) == 0
    assert jcriteo_tsv.convert(path, str(tmp_path / "jax.edlr"),
                               limit=25) == 25
    records = _decoded(tmp_path / "port.edlr")
    assert len(records) == 25
    assert records == _decoded(tmp_path / "jax.edlr")
    want = [{k: np.asarray(v).tolist() for k, v in
             jcriteo_tsv.parse_line(line).items()} for line in lines[:25]]
    assert records == want
    missing = "\t".join(["1"] + [""] * 13 + [""] * 26)
    parsed = criteo_tsv.parse_line(missing)
    assert parsed["I1"] == np.float32(-1.0) and parsed["C26"] == 0
    with pytest.raises(ValueError, match="fields"):
        criteo_tsv.parse_line("1\t2\t3")
