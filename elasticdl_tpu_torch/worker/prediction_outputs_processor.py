"""User hook for handling prediction outputs (counterpart of
elasticdl_tpu/worker/prediction_outputs_processor.py)."""

from abc import ABC, abstractmethod


class BasePredictionOutputsProcessor(ABC):
    @abstractmethod
    def process(self, predictions, worker_id):
        ...
