"""Optimizer descriptors (counterpart of elasticdl_tpu/ops/optimizers.py).

Same names, defaults and `to_flags()` as the JAX package's OptimizerSpec, so
a spec means the same thing on either side of the wire. `to_torch(params)`
builds the torch optimizer whose steps match the JAX package's
`to_optax()` transform step for step:

- sgd and momentum/nesterov: torch.optim.SGD (dampening 0) keeps the same
  trace as optax.sgd: t = g + momentum * t; update g + momentum * t under
  nesterov.
- adam: torch.optim.Adam equals optax.adam (bias-corrected moments, eps
  outside the square root).
- adam with amsgrad and adagrad are not ported yet: optax's amsgrad takes
  the max of the bias-corrected second moment where torch takes it before
  correction, and optax's adagrad starts its accumulator at
  initial_accumulator_value and scales by rsqrt(acc + eps) where torch
  divides by sqrt(acc) + eps. Both raise NotImplementedError.
"""

import torch

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

    def to_torch(self, params) -> torch.optim.Optimizer:
        h = self.hyperparams
        if self.name == "sgd":
            return torch.optim.SGD(params, lr=h["learning_rate"])
        if self.name == "momentum":
            return torch.optim.SGD(
                params,
                lr=h["learning_rate"],
                momentum=h["momentum"],
                nesterov=h["nesterov"],
            )
        if self.name == "adam" and not h["amsgrad"]:
            return torch.optim.Adam(
                params,
                lr=h["learning_rate"],
                betas=(h["beta_1"], h["beta_2"]),
                eps=h["epsilon"],
            )
        raise NotImplementedError(
            f"{self!r} has no torch counterpart that matches optax yet"
        )

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
