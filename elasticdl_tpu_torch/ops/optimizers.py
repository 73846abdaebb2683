"""Optimizer descriptors (counterpart of elasticdl_tpu/ops/optimizers.py).

Same names, defaults and `to_flags()` as the JAX package's OptimizerSpec, so
a spec means the same thing on either side of the wire. `to_torch(params)`
builds the optimizer whose steps match the JAX package's `to_optax()`
transform step for step:

- sgd and momentum/nesterov: SGD below keeps torch.optim.SGD's arithmetic
  (dampening 0), the same trace as optax.sgd: t = g + momentum * t; update
  g + momentum * t under nesterov.
- adam: Adam below runs torch.optim.Adam's multi-tensor arithmetic, which
  equals optax.adam (bias-corrected moments, eps outside the square root).
- adam with amsgrad: AMSGrad below, as optax.amsgrad (scale_by_amsgrad):
  the max is taken of the bias-corrected second moment, where
  torch.optim.Adam(amsgrad=True) takes it before correction.
- adagrad: Adagrad below, as optax.adagrad (scale_by_rss): the accumulator
  starts at initial_accumulator_value and the update is
  lr * g * rsqrt(acc + eps), where torch.optim.Adagrad starts at 0 and
  divides by sqrt(acc) + eps.

The optimizers are the port's own (`Optimizer`: param_groups, state,
zero_grad, step), not torch.optim's: torch.optim.Optimizer imports
torch._dynamo when it is built, zeroed or stepped, and that import held
a worker process's start 8.8 s on an H100 host (PERF.md), for a compiler
the port never runs. SGD and Adam keep torch's foreach arithmetic (the
same kernels on the card, the per-tensor ops on the CPU).

`optax_state_leaves` and `load_optax_state_leaves` carry a torch
optimizer's state in optax's form: the leaves of `to_optax().init(params)`
in jax's flatten order, each moment in the flax layout of its parameter.
That is how worker checkpoints (common/save_utils.py) store it, so a
checkpoint restores in either package.
"""

import collections

import torch


class Optimizer:
    """What the port uses of torch.optim.Optimizer: one param group of
    `defaults`, per-parameter `state`, `zero_grad` and `step`."""

    def __init__(self, params, defaults):
        self.defaults = dict(defaults)
        self.state = collections.defaultdict(dict)
        self.param_groups = [{**self.defaults, "params": list(params)}]

    def zero_grad(self, set_to_none=True):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.detach_()
                    p.grad.zero_()

    def _with_grads(self, group):
        return [p for p in group["params"] if p.grad is not None]


class SGD(Optimizer):
    """torch.optim.SGD's multi-tensor step (dampening 0, no weight decay):
    buf = momentum * buf + g (g itself at the first step), then
    p -= lr * (g + momentum * buf under nesterov, else buf)."""

    def __init__(self, params, lr, momentum=0.0, nesterov=False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = self._with_grads(group)
            if not params:
                continue
            grads = [p.grad for p in params]
            momentum = group["momentum"]
            if momentum != 0:
                bufs = [self.state[p].get("momentum_buffer") for p in params]
                if all(b is not None for b in bufs):
                    torch._foreach_mul_(bufs, momentum)
                    torch._foreach_add_(bufs, grads, alpha=1.0)
                else:
                    for i, p in enumerate(params):
                        if bufs[i] is None:
                            bufs[i] = grads[i].detach().clone()
                            self.state[p]["momentum_buffer"] = bufs[i]
                        else:
                            bufs[i].mul_(momentum).add_(grads[i], alpha=1.0)
                grads = (torch._foreach_add(grads, bufs, alpha=momentum)
                         if group["nesterov"] else bufs)
            torch._foreach_add_(params, grads, alpha=-group["lr"])


class Adam(Optimizer):
    """torch.optim.Adam's multi-tensor step (no weight decay, no
    amsgrad): the moments by lerp and addcmul, the bias corrections from
    the step count (a float32 CPU tensor per parameter, as torch keeps
    it), p -= lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)."""

    def __init__(self, params, lr, betas, eps):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = self._with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            steps = [st["step"] for st in states]
            exp_avgs = [st["exp_avg"] for st in states]
            exp_avg_sqs = [st["exp_avg_sq"] for st in states]
            torch._foreach_add_(steps, 1)
            torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
            torch._foreach_mul_(exp_avg_sqs, b2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - b2)
            counts = [step.item() for step in steps]
            step_size = [(group["lr"] / (1 - b1**n)) * -1 for n in counts]
            bc2_sqrt = [(1 - b2**n) ** 0.5 for n in counts]
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcdiv_(params, exp_avgs, denom, step_size)


class Adagrad(Optimizer):
    """optax.adagrad: acc += g^2; p -= lr * g * rsqrt(acc + eps), with
    the rescale 0 where acc is 0."""

    def __init__(self, params, lr, initial_accumulator_value, eps):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps,
        ))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        p, group["initial_accumulator_value"]
                    )
                acc = state["sum_of_squares"]
                acc.add_(p.grad * p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                                    torch.zeros_like(acc))
                p.sub_(group["lr"] * (scale * p.grad))
        return loss


class AMSGrad(Optimizer):
    """optax.amsgrad: Adam's bias-corrected moments m_hat, v_hat;
    v_max = max(v_max, v_hat); p -= lr * m_hat / (sqrt(v_max) + eps)."""

    def __init__(self, params, lr, betas, eps):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for key in ("mu", "nu", "nu_max"):
                        state[key] = torch.zeros_like(p)
                state["step"] += 1
                count = state["step"]
                g = p.grad
                mu, nu, nu_max = state["mu"], state["nu"], state["nu_max"]
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * (g * g))
                mu_hat = mu / (1 - b1**count)
                torch.maximum(nu_max, nu / (1 - b2**count), out=nu_max)
                p.sub_(group["lr"] * (mu_hat / (nu_max.sqrt() + group["eps"])))
        return loss


def _optax_state_fields(spec):
    """The torch state keys holding each field of optax's state, in the
    order of optax's state NamedTuple ("step" is optax's int32 count)."""
    if spec.name == "sgd":
        return ()
    if spec.name == "momentum":
        return ("momentum_buffer",)  # TraceState.trace
    if spec.name == "adagrad":
        return ("sum_of_squares",)  # ScaleByRssState
    if spec.hyperparams["amsgrad"]:
        return ("step", "mu", "nu", "nu_max")  # ScaleByAmsgradState
    return ("step", "exp_avg", "exp_avg_sq")  # ScaleByAdamState


def _initial_state(spec, field, param):
    """optax's initial value of a per-parameter field (torch creates its
    state at the first step)."""
    if field == "sum_of_squares":
        return torch.full_like(
            param, spec.hyperparams["initial_accumulator_value"]
        )
    return torch.zeros_like(param)


def optax_state_leaves(optimizer, spec, leaves):
    """The optimizer's state as optax's state leaves (tensors on the
    parameters' device; the count as a 0-d int32 tensor). `leaves` are the
    parameters as common/params.flax_leaves lists them."""
    out = []
    state = optimizer.state  # read once: a ZeRO-1 optimizer gathers it
    for field in _optax_state_fields(spec):
        if field == "step":
            steps = {int(state.get(x.param, {}).get("step", 0))
                     for x in leaves}
            if len(steps) > 1:
                raise ValueError(f"parameters at different steps: {steps}")
            out.append(torch.tensor(steps.pop() if steps else 0,
                                    dtype=torch.int32))
            continue
        for x in leaves:
            value = state.get(x.param, {}).get(field)
            if value is None:
                value = _initial_state(spec, field, x.param.detach())
            out.append(x.to_flax(value))
    return out


def load_optax_state_leaves(optimizer, spec, leaves, values):
    """The inverse of optax_state_leaves: replaces the optimizer's state
    with `values` (optax's state leaves, numpy or tensors)."""
    values = list(values)
    expected = sum(1 if f == "step" else len(leaves)
                   for f in _optax_state_fields(spec))
    if len(values) != expected:
        raise ValueError(
            f"{spec.name} state has {expected} leaves, got {len(values)}"
        )
    state = {x.param: {} for x in leaves}
    it = iter(values)
    for field in _optax_state_fields(spec):
        if field == "step":
            count = int(next(it))
            for x in leaves:
                # Adam keeps a float32 CPU tensor (as torch.optim.Adam
                # does), AMSGrad an int.
                state[x.param]["step"] = (
                    count if spec.hyperparams["amsgrad"]
                    else torch.tensor(float(count))
                )
            continue
        for x in leaves:
            state[x.param][field] = x.from_flax(next(it)).to(
                x.param.device, x.param.dtype
            )
    optimizer.state.clear()
    optimizer.state.update(state)


# name -> (constructor kwargs accepted, default values)
_SUPPORTED = {
    "sgd": {"learning_rate": 0.1},
    "momentum": {"learning_rate": 0.1, "momentum": 0.9, "nesterov": False},
    "adam": {
        "learning_rate": 0.001,
        "beta_1": 0.9,
        "beta_2": 0.999,
        "epsilon": 1e-8,
        "amsgrad": False,
    },
    "adagrad": {"learning_rate": 0.1, "initial_accumulator_value": 0.1,
                "epsilon": 1e-7},
}


class OptimizerSpec:
    def __init__(self, name, **hyperparams):
        name = name.lower()
        if name not in _SUPPORTED:
            raise ValueError(
                f"unsupported optimizer {name!r}; choose from "
                f"{sorted(_SUPPORTED)}"
            )
        unknown = set(hyperparams) - set(_SUPPORTED[name])
        if unknown:
            raise ValueError(f"unknown {name} hyperparams: {sorted(unknown)}")
        self.name = name
        self.hyperparams = {**_SUPPORTED[name], **hyperparams}

    @property
    def learning_rate(self):
        return self.hyperparams["learning_rate"]

    def to_torch(self, params) -> Optimizer:
        h = self.hyperparams
        if self.name == "sgd":
            return SGD(params, lr=h["learning_rate"])
        if self.name == "momentum":
            return SGD(
                params,
                lr=h["learning_rate"],
                momentum=h["momentum"],
                nesterov=h["nesterov"],
            )
        if self.name == "adam":
            cls = AMSGrad if h["amsgrad"] else Adam
            return cls(
                params,
                lr=h["learning_rate"],
                betas=(h["beta_1"], h["beta_2"]),
                eps=h["epsilon"],
            )
        if self.name == "adagrad":
            return Adagrad(
                params,
                lr=h["learning_rate"],
                initial_accumulator_value=h["initial_accumulator_value"],
                eps=h["epsilon"],
            )
        raise AssertionError(self.name)

    def to_flags(self):
        """(name, hyperparams) for re-instantiation inside a PS process."""
        return self.name, dict(self.hyperparams)

    def __repr__(self):
        return f"OptimizerSpec({self.name}, {self.hyperparams})"


def sgd(learning_rate=0.1):
    return OptimizerSpec("sgd", learning_rate=learning_rate)


def momentum(learning_rate=0.1, momentum_value=0.9, nesterov=False):
    return OptimizerSpec(
        "momentum",
        learning_rate=learning_rate,
        momentum=momentum_value,
        nesterov=nesterov,
    )


def adam(learning_rate=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
         amsgrad=False):
    return OptimizerSpec(
        "adam",
        learning_rate=learning_rate,
        beta_1=beta_1,
        beta_2=beta_2,
        epsilon=epsilon,
        amsgrad=amsgrad,
    )


def adagrad(learning_rate=0.1, initial_accumulator_value=0.1, epsilon=1e-7):
    return OptimizerSpec(
        "adagrad",
        learning_rate=learning_rate,
        initial_accumulator_value=initial_accumulator_value,
        epsilon=epsilon,
    )
