"""Rematerialization of a block in the backward pass under the named
policies of jax.checkpoint_policies (the JAX package's nn.remat(Block,
policy=...) and jax.checkpoint(stage_fn, policy=...)).

The policies that are policies themselves:
- None and "nothing_saveable": keep the block's input, recompute the
  rest;
- "everything_saveable": keep everything, which is the block without
  remat;
- "dots_saveable" (alias "checkpoint_dots"): keep the output of every
  product XLA sees as a dot_general, recompute the rest;
- "dots_with_no_batch_dims_saveable" (alias
  "checkpoint_dots_with_no_batch_dims"): keep the outputs of the products
  without a batch dim.
The products are every Dense (`linear`: no batch dim) and the Switch-MoE
expert products (`bmm`: the expert is a batch dim). The flash kernels are
no dot: they are recomputed under every policy but everything_saveable,
as the Pallas call is under JAX's. The names that make a policy from
arguments (`FACTORIES`) are refused when the config is built; the JAX
package accepts them there and fails when it traces the step.

The policies are written out here: the block's forward runs without
autograd, a tape (thread-local) keeping the outputs of the products the
policy saves; its backward runs the forward again under autograd, each
kept product handing back its output instead of computing it, its own
backward taking the input and weight gradients from its recomputed inputs
(a dot's transpose), and the gradients come from that graph. Every product
takes its gradients by one written-out backward, kept or not, with remat
or without, so a policy changes what is recomputed and not the
arithmetic. The backward
runs on the thread that called backward (parallel/collectives.py:
with_backward), so a block whose recompute communicates (a tensor-parallel
shard's) runs it on its shard's thread, and the random state of the
forward is restored for the recompute. torch.utils.checkpoint, with or
without its selective policies, imports torch._dynamo when it is called,
and that import costs a worker process seconds of its start (PERF.md).
"""

import contextlib
import threading

import torch
import torch.nn.functional as F

from elasticdl_tpu_torch.parallel.collectives import with_backward

# Policy -> whether it keeps a product, by whether the product has a batch
# dim (everything_saveable keeps all there is: it needs no recompute).
_KEEPS = {
    None: lambda batch_dims: False,
    "nothing_saveable": lambda batch_dims: False,
    "everything_saveable": None,
    "dots_saveable": lambda batch_dims: True,
    "checkpoint_dots": lambda batch_dims: True,
    "dots_with_no_batch_dims_saveable": lambda batch_dims: not batch_dims,
    "checkpoint_dots_with_no_batch_dims": lambda batch_dims: not batch_dims,
}
POLICIES = tuple(_KEEPS)
# jax.checkpoint_policies' names that take arguments and return a policy.
FACTORIES = ("offload_dot_with_no_batch_dims",
             "save_and_offload_only_these_names", "save_any_names_but_these",
             "save_anything_except_these_names", "save_from_both_policies",
             "save_only_these_names")


def validate_remat_policy(remat, remat_policy):
    """Config-time validation shared by the dense and MoE LM configs."""
    if remat_policy is None:
        return
    if not remat:
        raise ValueError(
            "remat_policy is set but remat=False — the policy would be "
            "silently ignored; enable remat or drop the policy"
        )
    if remat_policy in FACTORIES:
        raise ValueError(
            f"remat_policy {remat_policy!r} is a factory in "
            f"jax.checkpoint_policies (it takes arguments and returns a "
            f"policy), not a policy; name one of {POLICIES[1:]}"
        )
    if remat_policy not in _KEEPS:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r} (see "
            f"jax.checkpoint_policies)"
        )


# ---------- the products, through the tape ----------

_local = threading.local()


class _Tape:
    __slots__ = ("keeps", "outputs", "index", "replay")

    def __init__(self, keeps):
        self.keeps = keeps
        self.outputs = []
        self.index = 0
        self.replay = False


@contextlib.contextmanager
def _taping(tape):
    prior = getattr(_local, "tape", None)
    _local.tape = tape
    try:
        yield
    finally:
        _local.tape = prior


def linear(x, weight, bias=None):
    """F.linear: a product without a batch dim."""
    return _product(_Linear, (x, weight, bias), False)


def bmm(a, b):
    """torch.bmm: a product with a batch dim."""
    return _product(_Bmm, (a, b), True)


def _product(fn, args, batch_dims):
    tape = getattr(_local, "tape", None)
    if tape is None:
        return fn.apply(*args, None)
    if not tape.replay:
        out = fn.apply(*args, None)
        tape.outputs.append(out if tape.keeps(batch_dims) else None)
        return out
    kept = tape.outputs[tape.index]
    tape.outputs[tape.index] = None
    tape.index += 1
    return fn.apply(*args, kept)


class _Linear(torch.autograd.Function):
    """F.linear with its backward written out (aten's addmm formulas), so
    that a product whose output was kept (`kept`, handed back instead of
    computed) and one computed take their gradients by the same
    arithmetic, with or without remat."""

    @staticmethod
    def forward(ctx, x, weight, bias, kept):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        if kept is not None:
            return kept.view_as(kept)
        return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = g2.mm(weight).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = g2.t().mm(x.reshape(-1, x.shape[-1]))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dw, db, None


class _Bmm(torch.autograd.Function):
    """torch.bmm with its backward written out (see _Linear)."""

    @staticmethod
    def forward(ctx, a, b, kept):
        ctx.save_for_backward(a, b)
        if kept is not None:
            return kept.view_as(kept)
        return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = g.bmm(b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        db = a.transpose(1, 2).bmm(g) if ctx.needs_input_grad[1] else None
        return da, db, None


# ---------- remat of a block ----------


def remat_call(fn, x, policy, params):
    """fn(x) with its activations rematerialized under `policy`; `params`
    are the tensors fn reads that take gradients (a module's
    parameters)."""
    if policy == "everything_saveable":
        return fn(x)
    return _keeping(fn, x, _KEEPS[policy],
                    [p for p in params if p.requires_grad])


def _rng_states(device):
    cuda = device.type == "cuda"
    return (torch.get_rng_state(),
            torch.cuda.get_rng_state(device) if cuda else None)


@contextlib.contextmanager
def _restored_rng(states, device):
    cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[device] if cuda else [],
                               device_type=device.type):
        torch.set_rng_state(states[0])
        if cuda:
            torch.cuda.set_rng_state(states[1], device)
        yield


def _keeping(fn, x, keeps, params):
    tape = _Tape(keeps)
    states = _rng_states(x.device)

    def forward(x, *params):
        with _taping(tape):
            return fn(x)

    def backward(*grads):
        tape.replay = True
        with torch.enable_grad(), _restored_rng(states, x.device):
            xd = x.detach().requires_grad_(x.requires_grad)
            with _taping(tape):
                out = fn(xd)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        inputs = ([xd] if xd.requires_grad else []) + params
        got = list(torch.autograd.grad(
            [o for o, _ in pairs], inputs, [g for _, g in pairs],
            allow_unused=True))
        tape.outputs = None
        dx = got.pop(0) if xd.requires_grad else None
        return (dx, *got)

    return with_backward(forward, backward, x, *params)
