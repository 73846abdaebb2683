"""Model-zoo spec loading (counterpart of elasticdl_tpu/common/model_utils.py).

A model definition module exports
  custom_model() -> torch.nn.Module
  loss(labels, predictions) -> 0-d tensor
  optimizer() -> ops.optimizers.OptimizerSpec
  feed(records, mode, metadata) -> (features, labels)  numpy batch
  eval_metrics_fn() -> {name: metric}     (see common/evaluation_utils)
optional:
  callbacks, prediction_outputs_processor, create_data_reader
"""

import importlib
import importlib.util
import os


class Modes:
    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


def load_module(module_ref):
    """Import a model-def module from a dotted path or a .py file path."""
    if os.path.isfile(module_ref) and module_ref.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(module_ref))[0], module_ref
        )
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
    return importlib.import_module(module_ref)


_REQUIRED = ["custom_model", "loss", "optimizer", "feed"]
_OPTIONAL = [
    "eval_metrics_fn",
    "callbacks",
    "prediction_outputs_processor",
    "create_data_reader",
]


class ModelSpec:
    def __init__(self, module):
        self.module = module
        missing = [n for n in _REQUIRED if not hasattr(module, n)]
        if missing:
            raise ValueError(
                f"model def {module.__name__!r} is missing {missing}; "
                f"required: {_REQUIRED}"
            )
        for name in _REQUIRED + _OPTIONAL:
            setattr(self, name, getattr(module, name, None))

    def build_model(self):
        return self.custom_model()

    def build_optimizer_spec(self):
        return self.optimizer()

    def build_metrics(self):
        return self.eval_metrics_fn() if self.eval_metrics_fn else {}


def get_model_spec(model_def):
    """model_def: dotted module path
    ('elasticdl_tpu_torch.models.transformer.transformer_lm') or a path to
    a .py file."""
    return ModelSpec(load_module(model_def))
