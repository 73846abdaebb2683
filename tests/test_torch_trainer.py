"""The port's LocalTrainer (elasticdl_tpu_torch/worker/trainer.py) against
the JAX package's, and the port's optimizer specs against optax."""

import numpy as np
import pytest
import torch

import jax
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.ops import optimizers as joptim
from elasticdl_tpu.worker.trainer import LocalTrainer as JaxLocalTrainer
from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.params import FlaxLeaf
from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

torch.set_num_threads(1)

TINY = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, max_len=16,
            activation_dtype="float32")
# One float32 step in both frameworks, whose gradients agree to GRAD_RTOL of
# each tensor's largest gradient (test_torch_transformer_lm.py).
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_RTOL = 1e-4


def _adam_step_tolerance(g):
    """Adam's first update is lr * g / (|g| + eps), whose derivative in g is
    lr * eps / (|g| + eps)^2: where a gradient is near 0 (e.g. the key
    bias, which shifts every score of a row equally and so has a gradient
    of exactly 0 up to rounding) the gradients' rounding difference moves
    the update by up to lr. Elsewhere the bound is PARAM_ATOL."""
    spec = jlm.optimizer().hyperparams
    lr, eps = spec["learning_rate"], spec["epsilon"]
    noise = GRAD_RTOL * np.abs(g).max()
    return PARAM_ATOL + np.minimum(
        2 * lr, lr * noise * eps / (np.abs(g) + eps) ** 2
    )


def _named(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree)[0].items()}


def _batch():
    tokens = synthetic_lm_tokens(2, 16, vocab=64, branching=4, seed=0)
    return tokens[:, :-1], tokens[:, 1:]


def test_synthetic_tokens_match_jax_package():
    from elasticdl_tpu.data.gen.synthetic import synthetic_lm_tokens as ref

    np.testing.assert_array_equal(
        synthetic_lm_tokens(3, 20, vocab=50, branching=3, seed=7),
        ref(3, 20, vocab=50, branching=3, seed=7),
    )


def test_one_adam_step_matches_jax_local_trainer():
    x, y = _batch()
    jm = jlm.custom_model(jlm.LMConfig(**TINY))
    jt = JaxLocalTrainer(jm, jlm.loss, jlm.optimizer())
    # Jitted init handed over as a weights-only restore: the trainer's own
    # lazy init runs flax's init eagerly, which is slow on the CPU.
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x)["params"]
    jt.restore_variables({"variables": {"params": params}, "version": 0})
    start = _named(jt._variables["params"])
    grads = _named(jax.jit(jax.grad(lambda p: jlm.loss(
        y, jt._model.apply({"params": p}, x))))(jt._variables["params"]))

    tt = LocalTrainer(tlm.custom_model(tlm.LMConfig(**TINY)), tlm.loss,
                      tlm.optimizer(), device="cpu")
    tt.load_flax_params(start)
    _, jversion, jloss = jt.train_minibatch(x, y)
    accepted, version, loss = tt.train_minibatch(x, y)

    assert accepted and version == jversion == 1
    # The loss stays a 0-d device tensor; the caller decides when to sync.
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert abs(loss.item() - float(jloss)) < LOSS_ATOL
    after = tt.export_variables()["variables"]
    want = _named(jt._variables["params"])
    assert after.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_less(np.abs(after[name] - value),
                                     _adam_step_tolerance(grads[name]),
                                     err_msg=name)
        assert not np.array_equal(after[name], start[name]), name

    outputs = tt.evaluate_minibatch(x)
    assert isinstance(outputs, np.ndarray) and outputs.shape == (2, 16, 64)
    np.testing.assert_allclose(outputs, jt.evaluate_minibatch(x),
                               atol=1e-4)


def test_export_restore_round_trip():
    x, y = _batch()
    model = tlm.custom_model(tlm.LMConfig(**TINY))
    trainer = LocalTrainer(model, tlm.loss, tlm.optimizer(), device="cpu",
                           seed=3)
    trainer.train_minibatch(x, y)
    exported = trainer.export_variables()
    assert set(exported) == {"variables", "opt_state", "rng", "version"}

    other = LocalTrainer(tlm.custom_model(tlm.LMConfig(**TINY)), tlm.loss,
                         tlm.optimizer(), device="cpu", seed=9)
    other.restore_variables(exported)
    assert other.get_model_version() == 1
    np.testing.assert_array_equal(other.evaluate_minibatch(x),
                                  trainer.evaluate_minibatch(x))
    # Same weights and the same Adam moments: the next step agrees.
    _, _, a = trainer.train_minibatch(x, y)
    _, _, b = other.train_minibatch(x, y)
    assert a.item() == b.item()


def test_seeded_init_is_reproducible_and_trains():
    x, y = _batch()

    def run(seed):
        t = LocalTrainer(tlm.custom_model(tlm.LMConfig(**TINY)), tlm.loss,
                         toptim.adam(learning_rate=1e-2), device="cpu",
                         seed=seed)
        return [t.train_minibatch(x, y)[2].item() for _ in range(5)]

    first = run(0)
    assert first == run(0)
    assert first != run(1)
    assert first[-1] < first[0]


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("sgd", {}),
        ("momentum", {}),
        ("momentum", {"nesterov": True}),
        ("adam", {"learning_rate": 3e-4}),
        ("adagrad", {}),
        ("adam", {"amsgrad": True, "learning_rate": 3e-2}),
    ],
)
def test_optimizer_steps_match_optax(name, kwargs):
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32)
             for _ in range(3)]
    jspec = joptim.OptimizerSpec(name, **kwargs)
    tspec = toptim.OptimizerSpec(name, **kwargs)
    assert tspec.to_flags() == jspec.to_flags()

    tx = jspec.to_optax()
    w, state = jax.numpy.asarray(w0), tx.init(jax.numpy.asarray(w0))
    param = torch.nn.Parameter(torch.tensor(w0))
    opt = tspec.to_torch([param])
    for g in grads:
        updates, state = tx.update(jax.numpy.asarray(g), state, w)
        w = w + updates
        param.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(w),
                                   atol=1e-6)


@pytest.mark.parametrize(
    "name,kwargs,reference",
    [
        ("sgd", {}, lambda ps: torch.optim.SGD(ps, lr=0.1)),
        ("momentum", {}, lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                    momentum=0.9)),
        ("momentum", {"nesterov": True}, lambda ps: torch.optim.SGD(
            ps, lr=0.1, momentum=0.9, nesterov=True)),
        ("adam", {}, lambda ps: torch.optim.Adam(ps, lr=0.001)),
    ],
)
def test_sgd_and_adam_keep_torch_optims_arithmetic(name, kwargs, reference):
    """The port's own SGD and Adam (ops/optimizers.py, which import no
    torch._dynamo) step bit for bit as torch.optim's, over several tensors
    and steps, one parameter without a gradient."""
    gen = torch.Generator().manual_seed(0)
    ours = [torch.nn.Parameter(torch.randn(5, 3, generator=gen))
            for _ in range(3)]
    theirs = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    opt = toptim.OptimizerSpec(name, **kwargs).to_torch(ours)
    ref = reference(theirs)
    for _ in range(4):
        for a, b in zip(ours[:2], theirs[:2]):
            g = torch.randn(5, 3, generator=gen)
            a.grad, b.grad = g.clone(), g.clone()
        opt.step()
        ref.step()
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("sgd", {}),
        ("momentum", {}),
        ("adam", {}),
        ("adagrad", {}),
        ("adam", {"amsgrad": True}),
    ],
)
def test_optimizer_state_leaves_match_optax(name, kwargs):
    """The torch optimizer's state in optax's form (what checkpoints store)
    equals optax's state leaves after the same steps, before any step too,
    and loads into a fresh optimizer that then steps identically."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32)
             for _ in range(3)]
    jspec = joptim.OptimizerSpec(name, **kwargs)
    tspec = toptim.OptimizerSpec(name, **kwargs)
    tx = jspec.to_optax()
    w, state = jax.numpy.asarray(w0), tx.init(jax.numpy.asarray(w0))
    param = torch.nn.Parameter(torch.tensor(w0))
    leaves = [FlaxLeaf("w", param, "scale", None)]
    opt = tspec.to_torch([param])

    def check(ours, theirs):
        theirs = jax.tree_util.tree_leaves(theirs)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.dtype == _torch_dtype(b) and a.shape == b.shape
            # rtol: amsgrad's nu_max holds a bias-corrected moment, and
            # optax computes 1 - b2**t in float32 (it cancels), the port
            # in double: up to ~1e-5 relative apart.
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)

    check(toptim.optax_state_leaves(opt, tspec, leaves), state)
    for g in grads[:2]:
        updates, state = tx.update(jax.numpy.asarray(g), state, w)
        w = w + updates
        param.grad = torch.tensor(g)
        opt.step()
    check(toptim.optax_state_leaves(opt, tspec, leaves), state)

    other = torch.nn.Parameter(param.detach().clone())
    other_opt = tspec.to_torch([other])
    toptim.load_optax_state_leaves(
        other_opt, tspec, [FlaxLeaf("w", other, "scale", None)],
        [x.numpy() for x in toptim.optax_state_leaves(opt, tspec, leaves)])
    for p, o in ((param, opt), (other, other_opt)):
        p.grad = torch.tensor(grads[2])
        o.step()
    np.testing.assert_array_equal(other.detach().numpy(),
                                  param.detach().numpy())


def _torch_dtype(array):
    return getattr(torch, np.asarray(array).dtype.name)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no?ne is available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        LocalTrainer(tlm.custom_model(tlm.LMConfig(**TINY)), tlm.loss,
                     tlm.optimizer())
    assert resolve_device("cpu") == torch.device("cpu")
