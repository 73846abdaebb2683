"""PS-side optimizer: applies gradients to the host-resident store through
the host library (counterpart of elasticdl_tpu/ps/optimizer.py:43-261).

Optimizer slots are companion slabs with the table's row mapping, so a
sparse update is one indexed kernel call. Every parameter of one push shares
one optimizer step (Adam's bias correction), opened by begin_apply. A
thread-local LR multiplier carries the staleness modulation of async SGD.

`numpy_rule` is the plain reference of the library's update rules, which the
tests hold the library against; the main path never calls it.
"""

import threading

import numpy as np

from elasticdl_tpu_torch import native
from elasticdl_tpu_torch.ops.optimizers import OptimizerSpec


class LearningRateModulator:
    """Per-call LR multiplier, set by the servicer thread handling a push
    (thread-local, so concurrent pushes with different staleness don't
    race)."""

    def __init__(self):
        self._local = threading.local()

    def set_multiplier(self, m):
        self._local.multiplier = m

    def get(self, base_lr):
        return base_lr * getattr(self._local, "multiplier", 1.0)


class PSOptimizer:
    """Applies dense and sparse (indexed) gradients in place.

    Dense state lives in `self._dense_slots[param_name][slot]` numpy arrays;
    sparse state lives as companion slabs inside each EmbeddingTable.
    """

    # slot name -> initial value, per optimizer family
    _SLOTS = {
        "sgd": {},
        "momentum": {"velocity": 0.0},
        "adam": {"m": 0.0, "v": 0.0},
        "adagrad": {"accumulator": None},  # filled from hyperparam
    }

    def __init__(self, spec: OptimizerSpec):
        self._spec = spec
        self._h = spec.hyperparams
        self._name = spec.name
        self._lib = native.lib()
        self._dense_slots = {}
        self._step = 0  # global step for Adam bias correction
        self._apply_step = None  # step shared by all params of one push
        self._step_lock = threading.Lock()
        self.lr_modulator = LearningRateModulator()
        slots = dict(self._SLOTS[self._name])
        if self._name == "adagrad":
            slots["accumulator"] = self._h["initial_accumulator_value"]
        if self._name == "adam" and self._h["amsgrad"]:
            slots["max_sq"] = 0.0
        self._slot_inits = slots

    @property
    def spec(self):
        return self._spec

    def begin_apply(self):
        """Advance the global step once per gradient push; every parameter
        applied in that push shares it."""
        with self._step_lock:
            self._step += 1
            self._apply_step = self._step
            return self._apply_step

    def end_apply(self):
        """Close the push opened by begin_apply; standalone apply_* calls
        return to bump-per-call stepping."""
        with self._step_lock:
            self._apply_step = None

    def _cur_step(self):
        if self._apply_step is not None:
            return self._apply_step
        with self._step_lock:
            self._step += 1
            return self._step

    def _lr(self):
        return self.lr_modulator.get(self._h["learning_rate"])

    # ---------- dense ----------

    def _dense_slot(self, name, slot, shape):
        slots = self._dense_slots.setdefault(name, {})
        if slot not in slots:
            slots[slot] = np.full(
                shape, self._slot_inits[slot], dtype=np.float32
            )
        return slots[slot]

    def apply_dense(self, name, param, grad):
        """In-place update of `param` (numpy float32) with `grad`."""
        grad = np.ascontiguousarray(grad, dtype=np.float32)
        if grad.shape != param.shape:
            raise ValueError(
                f"gradient shape {grad.shape} != param shape "
                f"{param.shape} for {name!r}"
            )
        lib, h = self._lib, self._h
        lr = self._lr()
        n = param.size
        g, p = native.f32p(grad), native.f32p(param)
        if self._name == "sgd":
            lib.edl_sgd(g, p, lr, n)
        elif self._name == "momentum":
            vel = self._dense_slot(name, "velocity", param.shape)
            lib.edl_momentum(g, p, native.f32p(vel), lr, h["momentum"],
                             int(h["nesterov"]), n)
        elif self._name == "adam":
            m = self._dense_slot(name, "m", param.shape)
            v = self._dense_slot(name, "v", param.shape)
            ms = (native.f32p(self._dense_slot(name, "max_sq", param.shape))
                  if h["amsgrad"] else native.NULL_F32)
            lib.edl_adam(g, p, native.f32p(m), native.f32p(v), ms, lr,
                         self._cur_step(), h["beta_1"], h["beta_2"],
                         h["epsilon"], n)
        elif self._name == "adagrad":
            accum = self._dense_slot(name, "accumulator", param.shape)
            lib.edl_adagrad(g, p, native.f32p(accum), lr, h["epsilon"], n)
        else:
            raise AssertionError(self._name)

    # ---------- sparse (embedding tables) ----------

    def apply_sparse(self, table, ids, grads):
        """Indexed update of embedding `table` rows for `ids` with
        [len(ids), dim] `grads`. Ids are deduplicated by the caller."""
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        ids = np.asarray(ids, dtype=np.int64)
        lib, h = self._lib, self._h
        lr = self._lr()
        with table.lock:
            rows = table.rows_for_ids(ids)
            k, dim = grads.shape
            g, r = native.f32p(grads), native.i64p(rows)
            slab = native.f32p(table.slab)
            if self._name == "sgd":
                lib.edl_sgd_indexed(g, r, k, dim, slab, lr)
            elif self._name == "momentum":
                vel = table.create_slot("velocity", 0.0)
                lib.edl_momentum_indexed(
                    g, r, k, dim, slab, native.f32p(vel), lr,
                    h["momentum"], int(h["nesterov"]),
                )
            elif self._name == "adam":
                m = table.create_slot("m", 0.0)
                v = table.create_slot("v", 0.0)
                ms = (native.f32p(table.create_slot("max_sq", 0.0))
                      if h["amsgrad"] else native.NULL_F32)
                lib.edl_adam_indexed(
                    g, r, k, dim, slab, native.f32p(m), native.f32p(v), ms,
                    lr, self._cur_step(), h["beta_1"], h["beta_2"],
                    h["epsilon"],
                )
            elif self._name == "adagrad":
                accum = table.create_slot(
                    "accumulator", h["initial_accumulator_value"]
                )
                lib.edl_adagrad_indexed(
                    g, r, k, dim, slab, native.f32p(accum), lr,
                    h["epsilon"],
                )
            else:
                raise AssertionError(self._name)


def numpy_rule(spec: OptimizerSpec, p, g, lr, step, slot_of):
    """The plain reference of one update, in place on float32 arrays `p`
    (the parameter or one table row) with gradient `g`; `slot_of(name,
    init)` returns the slot array beside `p`, `step` is Adam's 1-based
    step."""
    h = spec.hyperparams
    if spec.name == "sgd":
        p -= lr * g
    elif spec.name == "momentum":
        vel = slot_of("velocity", 0.0)
        vel *= h["momentum"]
        vel += g
        p -= lr * (g + h["momentum"] * vel) if h["nesterov"] else lr * vel
    elif spec.name == "adam":
        m, v = slot_of("m", 0.0), slot_of("v", 0.0)
        m *= h["beta_1"]
        m += (1 - h["beta_1"]) * g
        v *= h["beta_2"]
        v += (1 - h["beta_2"]) * g * g
        lr_t = lr * np.sqrt(1 - h["beta_2"] ** step) / (
            1 - h["beta_1"] ** step
        )
        if h["amsgrad"]:
            ms = slot_of("max_sq", 0.0)
            np.maximum(ms, v, out=ms)
            p -= lr_t * m / (np.sqrt(ms) + h["epsilon"])
        else:
            p -= lr_t * m / (np.sqrt(v) + h["epsilon"])
    elif spec.name == "adagrad":
        accum = slot_of("accumulator", h["initial_accumulator_value"])
        accum += g * g
        p -= lr * g / (np.sqrt(accum) + h["epsilon"])
    else:
        raise AssertionError(spec.name)
