"""Trainer abstraction + the local (single-process) PyTorch trainer
(counterpart of elasticdl_tpu/worker/trainer.py).

The step runs eagerly: forward, backward and the optimizer update in one
method (`_step`), on the trainer's device. The JAX package's compile cache,
tracked_jit and StepCostModel are XLA machinery and have no counterpart.

Exported state has the JAX trainer's form, so common/save_utils.py writes
the JAX package's checkpoint: flax-named weights, the model's non-parameter
state as flax's `batch_stats` collection (the BatchNorm running statistics:
torch buffers, which the optimizer never sees; the training forward updates
them and module.eval() freezes them, as flax's mutable collection and
use_running_average do), and the optimizer state as optax's state leaves
(ops/optimizers.optax_state_leaves).
"""

import time
from abc import ABC, abstractmethod

import numpy as np
import torch

from elasticdl_tpu_torch.common.device import resolve_device
from elasticdl_tpu_torch.common.log_utils import get_logger
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    load_flax,
    params_to_flax,
    state_to_flax,
)
from elasticdl_tpu_torch.common.save_utils import restore_trainer_checkpoint
from elasticdl_tpu_torch.layers.init import materialize
from elasticdl_tpu_torch.ops.optimizers import (
    load_optax_state_leaves,
    optax_state_leaves,
)

logger = get_logger("worker.trainer")


class Trainer(ABC):
    """What the worker loop needs from any training strategy."""

    @abstractmethod
    def init_variables_if_needed(self, features):
        ...

    @abstractmethod
    def train_minibatch(self, features, labels):
        """Returns (accepted: bool, model_version: int, loss).

        `loss` is a 0-d tensor on the trainer's device, not converted to a
        Python float: converting would wait for the device on every step.
        Callers materialize it (float()) only when they log it."""

    @abstractmethod
    def evaluate_minibatch(self, features, model_version=-1):
        """Forward pass; returns model outputs (numpy)."""

    def predict_minibatch(self, features):
        return self.evaluate_minibatch(features)

    @abstractmethod
    def get_model_version(self) -> int:
        ...

    def export_variables(self):
        """Checkpointable state; override where meaningful."""
        return None


class TorchTrainer(Trainer):
    """Shared PyTorch machinery: lazy materialization of the model on the
    device at the first batch, and the fused train step."""

    def __init__(self, model, loss_fn, optimizer_spec, seed=0, device=None):
        self._device = resolve_device(device)
        self._model = model
        self._loss_fn = loss_fn
        self._optimizer_spec = optimizer_spec
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._optimizer = None
        self._version = 0
        # time.time() when the model was built on its device (None before).
        self.built_at = None
        # Checkpoint path to restore from right after lazy init (worker-side
        # resume for strategies whose state lives in the worker).
        self.restore_on_init = None

    # ---------- init ----------

    def _materialize(self):
        """Moves the model to the device (allocating and initializing it from
        the seed if it has no storage yet: init_weights sets the buffers too,
        which to_empty leaves uninitialized) and builds the optimizer."""
        if any(p.is_meta for p in self._model.parameters()):
            materialize(self._model, self._device)
            self._model.init_weights(self._generator)
        else:
            self._model.to(self._device)
        self._optimizer = self._optimizer_spec.to_torch(
            self._model.parameters()
        )
        n_params = sum(p.numel() for p in self._model.parameters())
        self.built_at = time.time()
        logger.info("Initialized model with %d parameters", n_params)

    def init_variables_if_needed(self, features):
        if self._optimizer is not None:
            return
        self._materialize()
        if self.restore_on_init:
            path, self.restore_on_init = self.restore_on_init, None
            restore_trainer_checkpoint(self, path)

    def load_flax_params(self, named, state=None):
        """Loads flax-named weights ({wire name: array}, as the JAX package's
        pytree_utils.flatten_params names them) through the weight bridge,
        and the `batch_stats` state ({"batch_stats/...": array}) where
        given."""
        if self._optimizer is None:
            self._materialize()
        load_flax(self._model, named, state)

    # ---------- step ----------

    def _to_device(self, batch):
        """An array, or a dict of them (the CTR models' features), on the
        trainer's device."""
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return torch.as_tensor(np.asarray(batch)).to(
            self._device, non_blocking=True
        )

    def _step(self, features, labels):
        """fwd + bwd + optimizer update."""
        self._model.train()
        loss = self._loss_fn(labels, self._model(features))
        self._optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._optimizer.step()
        return loss.detach()

    # ---------- Trainer interface ----------

    def train_minibatch(self, features, labels):
        self.init_variables_if_needed(features)
        loss = self._step(self._to_device(features), self._to_device(labels))
        self._version += 1
        return True, self._version, loss

    def evaluate_minibatch(self, features, model_version=-1):
        self.init_variables_if_needed(features)
        self._model.eval()
        with torch.no_grad():
            outputs = self._model(self._to_device(features))
        return outputs.cpu().numpy()

    def get_model_version(self):
        return self._version

    def export_variables(self):
        """{"variables": {flax wire name: numpy array}, "opt_state": optax's
        state leaves (tensors left on the device: callers that persist them
        copy per leaf), "rng": the generator's state, "version"}; the
        weights and state are None before the first batch. A model with
        non-parameter state (buffers) adds "state": {"batch_stats/<path>/
        mean" or "var": numpy array}."""
        ready = self._optimizer is not None
        exported = {
            "variables": params_to_flax(self._model) if ready else None,
            "opt_state": self.optimizer_state_leaves(),
            "rng": self._generator.get_state().numpy(),
            "version": self._version,
        }
        state = state_to_flax(self._model) if ready else None
        if state:
            exported["state"] = state
        return exported

    def optimizer_state_leaves(self):
        """The optimizer's state as optax's state leaves, without copying
        the weights to the host (None before the first batch)."""
        if self._optimizer is None:
            return None
        return optax_state_leaves(self._optimizer, self._optimizer_spec,
                                  flax_leaves(self._model))

    def restore_variables(self, exported):
        if self._optimizer is None:
            self._materialize()
        load_flax(self._model, exported["variables"], exported.get("state"))
        self._optimizer = self._optimizer_spec.to_torch(
            self._model.parameters()
        )
        if exported.get("opt_state") is not None:
            load_optax_state_leaves(
                self._optimizer, self._optimizer_spec,
                flax_leaves(self._model), exported["opt_state"],
            )
        else:
            logger.warning(
                "Checkpoint has no optimizer state; re-initializing it"
            )
        if exported.get("rng") is not None:
            self._generator.set_state(torch.from_numpy(exported["rng"]))
        self._version = exported["version"]


class LocalTrainer(TorchTrainer):
    """Single-device training: the minimum end-to-end strategy (reference
    DistributionStrategy.LOCAL)."""
