"""Worker-side checkpoint save/restore (counterpart of
elasticdl_tpu/common/save_utils.py:34-145).

The file is the JAX package's `.npz`, so a checkpoint restores in either
package:
- the weights under their flax wire names in the "params" collection
  ("params/Block_0/Dense_0/kernel", flax layouts);
- the model's non-parameter state under its collection's name
  ("batch_stats/BatchNorm_0/mean", ".../var"), as the JAX package writes
  every collection of its variables tree;
- `__version__`, the model version (int64);
- `__opt__NNNNNN`, the optimizer state as optax's state leaves in jax's
  flatten order (ops/optimizers.optax_state_leaves), and `__opt_spec__`,
  the optimizer's name;
- `__torch_rng__`, the trainer's generator state. The JAX package stores a
  jax PRNG key under `__rng__` instead; each package restores only its own
  and ignores the other's (the JAX restore skips keys that name no
  parameter).
Train-end model exports carry the weights only.
"""

import os

import numpy as np

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("common.save_utils")

_PARAMS_PREFIX = "params/"
_OPT_PREFIX = "__opt__"
_OPT_SPEC_KEY = "__opt_spec__"
_VERSION_KEY = "__version__"
_RNG_KEY = "__torch_rng__"
_JAX_RNG_KEY = "__rng__"


def _normalize(path):
    """np.savez appends '.npz' itself; normalize so the logged path, the
    saved file, and a later restore all agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _host(value):
    """A tensor or array as a numpy array (0-d kept 0-d)."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def save_trainer_checkpoint(trainer, path, include_training_state=True):
    exported = trainer.export_variables()
    if exported is None or exported.get("variables") is None:
        # E.g. a relaunched worker that only picked up the train-end export
        # task: failing here reports the task back to the master, which
        # re-queues it for a worker that actually holds trained state.
        raise ValueError("trainer has no exportable state")
    path = _normalize(path)
    arrays = {
        _PARAMS_PREFIX + name: np.asarray(value)
        for name, value in exported["variables"].items()
    }
    arrays.update(exported.get("state") or {})
    if include_training_state and exported.get("opt_state") is not None:
        for i, leaf in enumerate(exported["opt_state"]):
            arrays["%s%06d" % (_OPT_PREFIX, i)] = _host(leaf)
        spec = getattr(trainer, "_optimizer_spec", None)
        if spec is not None:
            arrays[_OPT_SPEC_KEY] = np.bytes_(spec.name.encode())
    if include_training_state and exported.get("rng") is not None:
        arrays[_RNG_KEY] = np.asarray(exported["rng"])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # Uncompressed, as the JAX package writes it: compressing a few GB of
    # float32 costs far more time than it saves on disk.
    np.savez(
        path[: -len(".npz")],
        **{_VERSION_KEY: np.int64(exported["version"])},
        **arrays,
    )
    logger.info("Saved model checkpoint to %s", path)


def restore_trainer_checkpoint(trainer, path):
    """Restore into an ALREADY-INITIALIZED trainer (its model and optimizer
    define the shapes to fill)."""
    with np.load(_normalize(path)) as data:
        named = {
            k[len(_PARAMS_PREFIX):]: data[k]
            for k in data.files
            if k.startswith(_PARAMS_PREFIX)
        }
        # Every other collection ("batch_stats/..."); meta keys start "__".
        state = {
            k: data[k]
            for k in data.files
            if not k.startswith((_PARAMS_PREFIX, "__"))
        }
        opt_leaves = [
            data[k]
            for k in sorted(data.files)
            if k.startswith(_OPT_PREFIX)
        ]
        saved_spec = (
            bytes(data[_OPT_SPEC_KEY]).decode()
            if _OPT_SPEC_KEY in data.files
            else None
        )
        rng = data[_RNG_KEY] if _RNG_KEY in data.files else None
        version = int(data[_VERSION_KEY])
        if rng is None and _JAX_RNG_KEY in data.files:
            logger.info("Checkpoint carries a jax PRNG key; keeping this "
                        "trainer's generator state")
    cur_leaves = trainer.optimizer_state_leaves() or []
    cur_spec = getattr(trainer, "_optimizer_spec", None)
    opt_state = None
    if opt_leaves:
        # Structural match alone can't tell adam moments from another
        # optimizer's identically-shaped slots, so the spec name is
        # compared too when both sides carry one.
        spec_ok = (
            saved_spec is None
            or cur_spec is None
            or saved_spec == cur_spec.name
        )
        compatible = spec_ok and len(cur_leaves) == len(opt_leaves) and all(
            tuple(cur.shape) == tuple(saved.shape)
            and str(cur.dtype).replace("torch.", "") == saved.dtype.name
            for cur, saved in zip(cur_leaves, opt_leaves)
        )
        if compatible:
            opt_state = opt_leaves
        else:
            logger.warning(
                "Checkpoint optimizer state (%d leaves) does not match the "
                "current optimizer's structure/shapes (%d leaves; optimizer "
                "spec changed?); re-initializing optimizer state",
                len(opt_leaves),
                len(cur_leaves),
            )
    trainer.restore_variables({
        "variables": named, "state": state, "opt_state": opt_state,
        "rng": rng,
        "version": version,
    })
    logger.info("Restored model checkpoint from %s (version %d)", path,
                version)


class ExportModelCallback:
    """Train-end callback writing the final model."""

    def __init__(self, output_path):
        self._path = output_path

    def on_train_end(self, trainer):
        # A model export, not a resume point: ship weights only (Adam
        # moments would triple the artifact).
        save_trainer_checkpoint(
            trainer, self._path, include_training_state=False
        )
