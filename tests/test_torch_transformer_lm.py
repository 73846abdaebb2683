"""The port's transformer LM against the JAX package's, on a tiny config
with the same weights (moved through the weight bridge,
elasticdl_tpu_torch/common/params.py)."""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu_torch.common.model_utils import Modes, get_model_spec
from elasticdl_tpu.data.example import encode_example as jax_encode_example
from elasticdl_tpu_torch.common.params import params_from_flax, params_to_flax
from elasticdl_tpu_torch.data.example import encode_example
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm

torch.set_num_threads(1)

TINY = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, max_len=16)
# float32 activations: the two frameworks differ only in summation order.
F32_LOGITS_ATOL = 1e-4
F32_LOSS_ATOL = 1e-5
F32_GRAD_RTOL = 1e-4  # of each gradient's largest magnitude
# bfloat16 activations round at different places in the two frameworks
# (fused bias adds, the GELU's internal precision): an 8-bit mantissa.
BF16_LOSS_ATOL = 2e-2


def _tokens(seed=0):
    toks = np.random.default_rng(seed).integers(0, 64, (2, 17))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _flax(activation_dtype):
    jm = jlm.custom_model(
        jlm.LMConfig(**TINY, activation_dtype=activation_dtype)
    )
    x, _ = _tokens()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    named = {k: np.asarray(v) for k, v in flatten_params(params)[0].items()}
    return jm, params, named


def _pair(activation_dtype):
    """(jax model, flax params, flax-named arrays, torch model with the same
    weights)."""
    jm, params, named = _flax(activation_dtype)
    tm = tlm.custom_model(
        tlm.LMConfig(**TINY, activation_dtype=activation_dtype)
    ).to_empty(device="cpu")
    tm.load_state_dict(params_from_flax(named, tm))
    return jm, params, named, tm


def _torch_grads(tm):
    """The torch model's gradients under flax wire names and layouts."""
    grads = copy.deepcopy(tm)
    for p, src in zip(grads.parameters(), tm.parameters()):
        p.data = src.grad
    return params_to_flax(grads)


def _jax_loss_and_grads(jm, params, x, y):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(y, jm.apply({"params": p}, x))
    ))(params)
    named = {k: np.asarray(v) for k, v in flatten_params(grads)[0].items()}
    return float(loss), named


def test_weight_bridge_round_trip():
    _, _, named, tm = _pair("float32")
    back = params_to_flax(tm)
    assert back.keys() == named.keys()
    for name, value in named.items():
        assert back[name].shape == value.shape, name
        np.testing.assert_array_equal(back[name], value)
    assert tm.Block_0.MultiHeadAttention_0.qkv.weight.shape == (96, 32)


def test_float32_logits_loss_and_grads_match_jax():
    jm, params, _, tm = _pair("float32")
    x, y = _tokens()
    jlogits = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    jloss, jgrads = _jax_loss_and_grads(jm, params, x, y)

    logits = tm(torch.tensor(x))
    loss = tlm.loss(torch.tensor(y), logits)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               atol=F32_LOGITS_ATOL)
    assert abs(loss.item() - jloss) < F32_LOSS_ATOL
    grads = _torch_grads(tm)
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(grads[name] - want).max())
        assert err <= F32_GRAD_RTOL * scale, (name, err, scale)


def test_remat_matches_no_remat_and_jax():
    """remat=True (each Block checkpointed) gives the loss and gradients
    of remat=False, and of the JAX package's nn.remat(Block)."""
    jm, params, named, tm = _pair("float32")
    x, y = _tokens()
    cfg = dict(TINY, activation_dtype="float32", remat=True)
    jrm = jlm.custom_model(jlm.LMConfig(**cfg))
    jrparams = {k.replace("Block_", "CheckpointBlock_"): v
                for k, v in params.items()}
    jloss, jgrads = _jax_loss_and_grads(jrm, jrparams, x, y)
    jgrads = {k.replace("CheckpointBlock_", "Block_"): v
              for k, v in jgrads.items()}

    results = []
    for remat in (False, True):
        model = tlm.custom_model(
            tlm.LMConfig(**dict(cfg, remat=remat))
        ).to_empty(device="cpu")
        model.load_state_dict(params_from_flax(named, model))
        calls = []
        model.Block_0.register_forward_pre_hook(lambda *_: calls.append(1))
        loss = tlm.loss(torch.tensor(y), model(torch.tensor(x)))
        loss.backward()
        assert len(calls) == (2 if remat else 1)  # recomputed in backward
        results.append((loss.item(), _torch_grads(model)))
    (loss, grads), (rloss, rgrads) = results
    assert abs(rloss - loss) < 1e-5
    assert abs(rloss - jloss) < 1e-5
    assert rgrads.keys() == grads.keys() == jgrads.keys()
    for name, want in grads.items():
        np.testing.assert_allclose(rgrads[name], want, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(rgrads[name], jgrads[name], atol=1e-5,
                                   err_msg=name)


def test_bfloat16_loss_matches_jax():
    jm, params, _, tm = _pair("bfloat16")
    x, y = _tokens()
    jloss, _ = _jax_loss_and_grads(jm, params, x, y)
    with torch.no_grad():
        logits = tm(torch.tensor(x))
    assert logits.dtype == torch.float32  # the LM head runs in float32
    loss = float(tlm.loss(torch.tensor(y), logits))
    assert abs(loss - jloss) < BF16_LOSS_ATOL


def test_flagship_names_and_shapes_match_jax():
    """The 222M flagship config has flax's exact parameter names and
    shapes (abstract shapes on both sides: nothing is allocated)."""
    cfg = jlm.flagship_config(4096)
    x = jax.ShapeDtypeStruct((1, 4096), np.int32)
    shapes = jax.eval_shape(jlm.custom_model(cfg).init,
                            jax.random.PRNGKey(0), x)["params"]
    want = {k: tuple(v.shape) for k, v in flatten_params(shapes)[0].items()}
    model = tlm.custom_model(tlm.flagship_config(4096))
    torch_shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert len(want) == len(torch_shapes)
    for name, shape in want.items():
        # The key through the bridge (a stand-in array), the shape by its
        # layout rule.
        (key,) = params_from_flax({name: np.zeros(1, np.float32)}, model)
        leaf = name.rsplit("/", 1)[1]
        if leaf == "kernel":
            shape = (int(np.prod(shape[1:])), shape[0])
        elif leaf == "bias":
            shape = (int(np.prod(shape)),)
        assert torch_shapes[key] == shape, name
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s)) for s in want.values())
    assert 220e6 < n_params < 224e6


def test_config_guards():
    with pytest.raises(NotImplementedError):
        tlm.LMConfig(remat=True, remat_policy="dots_saveable")
    with pytest.raises(ValueError):
        tlm.LMConfig(remat_policy="dots_saveable")
    tm = tlm.custom_model(tlm.LMConfig(**TINY)).to_empty(device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        tm(torch.zeros(1, 17, dtype=torch.int64))


def test_model_spec_feed_and_metrics():
    spec = get_model_spec(
        "elasticdl_tpu_torch.models.transformer.transformer_lm"
    )
    records = [encode_example({"tokens": np.arange(9) + i})
               for i in range(3)]
    features, labels = spec.feed(records, Modes.TRAINING, None)
    assert features.shape == labels.shape == (3, 8)
    assert features.dtype == np.int32
    np.testing.assert_array_equal(labels, features + 1)
    assert spec.feed(records, Modes.PREDICTION, None)[1] is None
    metric = spec.build_metrics()["token_ce"]
    logits = np.zeros((3, 8, 64), np.float32)
    metric.update(logits, labels)
    assert abs(metric.result() - np.log(64)) < 1e-5
    assert spec.build_optimizer_spec().to_flags() == jlm.optimizer().to_flags()


@pytest.mark.parametrize("mode", [Modes.TRAINING, Modes.PREDICTION])
def test_feed_matches_jax_feed(mode):
    """Both feeds take the same serialized Example records (written by the
    JAX package's codec) and give equal arrays."""
    tokens = np.random.default_rng(0).integers(0, 64, (4, 17))
    records = [jax_encode_example({"tokens": t.astype(np.int32)})
               for t in tokens]
    features, labels = tlm.feed(records, mode, None)
    jfeatures, jlabels = jlm.feed(records, mode, None)
    assert features.dtype == jfeatures.dtype == np.int32
    np.testing.assert_array_equal(features, jfeatures)
    np.testing.assert_array_equal(features, tokens[:, :-1])
    if mode == Modes.PREDICTION:
        assert labels is None and jlabels is None
    else:
        np.testing.assert_array_equal(labels, jlabels)
