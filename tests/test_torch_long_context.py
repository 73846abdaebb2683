"""The port's sequence axis (elasticdl_tpu_torch/parallel/{ring_attention,
ulysses,collectives}.py) against the JAX package's: ring, zigzag and
Ulysses attention over a seq group of gloo members run as threads, against
the JAX functions in shard_map on the 8-device CPU mesh, forward and
gradients, causal and not; the LM under context_parallel_model for each
impl, and the 3-D DP x TP x SP step, through AllReduceTrainer against the
JAX LM's replicated step (as tests/test_3d_parallel.py checks the JAX
3-D step).

Tolerance 1e-5 of the largest value compared, float32 throughout: the same
arithmetic summed in another order (blockwise softmax merges, gradients
summed over shards)."""

import functools
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.models.transformer import transformer_lm as jlm
from elasticdl_tpu.parallel.mesh import make_mesh
from elasticdl_tpu.parallel.ring_attention import (
    make_ring_attention,
    make_zigzag_ring_attention,
)
from elasticdl_tpu.parallel.ulysses import make_ulysses_attention
from elasticdl_tpu_torch.common import rpc
from elasticdl_tpu_torch.common.params import flax_leaves
from elasticdl_tpu_torch.master.membership import MembershipManager
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.ops import optimizers as toptim
from elasticdl_tpu_torch.parallel import collectives
from elasticdl_tpu_torch.parallel import ring_attention as ra
from elasticdl_tpu_torch.parallel.shards import run_group
from elasticdl_tpu_torch.parallel.ulysses import ulysses_attention
from elasticdl_tpu_torch.worker.allreduce_trainer import AllReduceTrainer
from elasticdl_tpu_torch.worker.master_client import MasterClient

torch.set_num_threads(1)

RTOL = 1e-5
B, H, S, D, N = 1, 4, 64, 16, 4
# XLA's backend at optimization level 0: the same IEEE arithmetic, compiled
# in a fraction of the time.
FAST_COMPILE = {"xla_backend_optimization_level": 0}
LM = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, max_len=32,
          activation_dtype="float32")


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= RTOL, f"{what}: {err:.3g} of the largest value"


@pytest.fixture(scope="module")
def qkvg():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(B, H, S, D)).astype(np.float32)
            for _ in range(4)]


_JAX = {"ring": make_ring_attention, "zigzag": make_zigzag_ring_attention,
        "ulysses": make_ulysses_attention}
_PORT = {"ring": ra.ring_attention, "zigzag": ra.zigzag_ring_attention,
         "ulysses": ulysses_attention}


def _jax_attention(impl, causal, q, k, v, g):
    mesh = make_mesh({"seq": N}, devices=jax.devices()[:N])
    attn = _JAX[impl](mesh, causal=causal)
    sharding = NamedSharding(mesh, P(None, None, "seq", None))
    args = [jax.device_put(jnp.asarray(x), sharding) for x in (q, k, v)]

    def forward_and_vjp(q, k, v):
        out, vjp = jax.vjp(attn, q, k, v)
        return (out, *vjp(jnp.asarray(g)))

    return [np.asarray(x) for x in jax.jit(forward_and_vjp).lower(
        *args).compile(compiler_options=FAST_COMPILE)(*args)]


def _port_attention(impl, causal, q, k, v, g):
    n = S // N

    def member(group):
        sl = slice(group.rank * n, (group.rank + 1) * n)
        ts = [torch.tensor(x[:, :, sl]).requires_grad_() for x in (q, k, v)]
        out = _PORT[impl](*ts, group, causal=causal)
        (out * torch.tensor(g[:, :, sl])).sum().backward()
        return [out.detach()] + [t.grad for t in ts]

    parts = run_group(N, member)
    return [torch.cat([p[i] for p in parts], dim=2).numpy()
            for i in range(4)]


@pytest.mark.parametrize("impl,causal", [
    ("ring", False), ("ring", True), ("zigzag", True), ("zigzag", False),
    ("ulysses", False), ("ulysses", True)])
def test_attention_matches_jax_shard_map(qkvg, impl, causal):
    want = _jax_attention(impl, causal, *qkvg)
    got = _port_attention(impl, causal, *qkvg)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _close(a, b, f"{impl} causal={causal} {what}")


def test_plain_blockwise_merge_is_exact_attention(qkvg):
    """ring_attention_plain, the kernels' plain version on the card, is the
    JAX module's _block_attend/_merge fold: exact attention."""
    q, k, v, _ = (torch.tensor(x) for x in qkvg)
    for causal in (False, True):
        want = jlm_reference(qkvg, causal)
        _close(ra.ring_attention_plain(q, k, v, N, causal), want,
               f"plain causal={causal}")


def jlm_reference(qkvg, causal):
    from elasticdl_tpu.ops.flash_attention import reference_attention

    return np.asarray(reference_attention(*map(jnp.asarray, qkvg[:3]),
                                          causal=causal))


def test_differentiable_collectives():
    """all_gather's transpose is a reduce-scatter, reduce_scatter's an
    all-gather, ring_shift's the step back, copy_to's an all-reduce and
    reduce_from's the identity: each against the dense function of the
    stacked inputs."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(N, 2, 8)).astype(np.float32)
    ws = rng.normal(size=(N, 2, 8 * N)).astype(np.float32)
    w1 = rng.normal(size=(N, 2, 8)).astype(np.float32)

    def member(group):
        r = group.rank
        x = torch.tensor(xs[r]).requires_grad_()
        gathered = collectives.all_gather(x, group, dim=1)
        scattered = collectives.reduce_scatter(
            torch.tensor(ws[r]) * gathered, group, dim=1)
        shifted = collectives.ring_shift(x * 2, group)
        copied = collectives.copy_to(x, group)
        reduced = collectives.reduce_from(x * 3, group)
        loss = ((scattered * torch.tensor(w1[r])).sum() + shifted.sum()
                + (copied * torch.tensor(w1[r])).sum() + reduced.sum())
        loss.backward()
        return x.grad.numpy()

    got = np.stack(run_group(N, member))
    # Dense: scattered_r = chunk r of sum_j ws[j] * concat(xs).
    x = torch.tensor(xs).requires_grad_()
    full = torch.cat(list(x), dim=1)
    summed = sum(torch.tensor(ws[j]) * full for j in range(N))
    scattered = summed.chunk(N, dim=1)
    loss = sum((scattered[r] * torch.tensor(w1[r])).sum()
               for r in range(N))
    # ring_shift: every x_r * 2 lands on one member once.
    loss = loss + (x * 2).sum()
    loss.backward()
    want = x.grad.numpy().copy()
    # copy_to (the model axis' replicated convention): the all-reduce of
    # every member's gradient w1_j; reduce_from: identity, 3 each.
    want += w1.sum(0)[None] + 3.0
    _close(got, want, "collective gradients")


# ---------- the LM through AllReduceTrainer ----------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trainer(local, **kw):
    membership = MembershipManager(coordinator_port=_free_port())
    servicer = MasterServicer(TaskDispatcher({}), None, membership)
    mc = MasterClient(rpc.InProcessStub(servicer, rpc.MASTER_SERVICE), 0,
                      worker_host="127.0.0.1")
    t = AllReduceTrainer(
        tlm.custom_model(tlm.LMConfig(**LM)), tlm.loss, toptim.sgd(0.1),
        mc, device="cpu", param_specs_fn=tlm.param_specs,
        context_parallel_model_fn=functools.partial(
            tlm.context_parallel_model, config=tlm.LMConfig(**LM)), **kw)
    t._local_devices = local
    return t


@pytest.fixture(scope="module")
def lm_reference():
    """The JAX LM's loss and gradients at its initial weights on one batch
    (flax init from PRNGKey(0)), replicated."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, LM["vocab"], (4, LM["max_len"] + 1))
    features, labels = tokens[:, :-1], tokens[:, 1:]
    model = jlm.custom_model(jlm.LMConfig(**LM))
    params = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(0)}, x, training=False)).lower(
        features).compile(compiler_options=FAST_COMPILE)(features)["params"]

    def loss_of(p):
        return jlm.loss(labels, model.apply({"params": p}, features,
                                            training=True))

    loss, grads = jax.jit(jax.value_and_grad(loss_of)).lower(
        params).compile(compiler_options=FAST_COMPILE)(params)
    named = {k: np.asarray(v) for k, v in flatten_params(params)[0].items()}
    want = {k: np.asarray(v) for k, v in flatten_params(grads)[0].items()}
    return features, labels, named, float(loss), want


def _step_against_jax(trainer, lm_reference):
    features, labels, named, loss, want = lm_reference
    try:
        trainer.load_flax_params(named)
        _, _, got_loss = trainer.train_minibatch(features, labels)
        grads = {x.name: x.to_flax(x.param.grad).detach().numpy()
                 for x in flax_leaves(trainer._model)}
        _close(float(got_loss), loss, "loss")
        for name, g in want.items():
            _close(grads[name], g, name)
        return trainer.world_fingerprint
    finally:
        trainer.close()


@pytest.mark.parametrize("impl", ["zigzag", "ring", "ulysses"])
def test_lm_under_context_parallel_model(lm_reference, impl):
    t = _trainer(2, context_parallel_size=2, context_parallel_impl=impl)
    assert _step_against_jax(t, lm_reference) == "data=1,seq=2"


def test_3d_dp_tp_sp_step_matches_replicated(lm_reference):
    """data 2 x model 2 x seq 2 (zigzag, heads split over the model axis)
    in one process of 8 shards."""
    t = _trainer(8, model_parallel_size=2, context_parallel_size=2)
    assert _step_against_jax(t, lm_reference) == "data=2,model=2,seq=2"


def test_ulysses_under_a_model_axis_drops_the_seq_axis(lm_reference):
    """As in JAX: the hook rejects ulysses with a head axis, and the world
    runs without sequence parallelism."""
    t = _trainer(4, model_parallel_size=2, context_parallel_size=2,
                 context_parallel_impl="ulysses")
    assert _step_against_jax(t, lm_reference) == "data=2,model=2"
    with pytest.raises(ValueError, match="ulysses"):
        tlm.context_parallel_model(None, head_axis="model", impl="ulysses")
