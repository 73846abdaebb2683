"""Example codec: dict[str, np.ndarray] <-> bytes via the Example message
(counterpart of elasticdl_tpu/data/example.py:14-40; the bytes are the JAX
package's, so record files move between the two)."""

import numpy as np

from elasticdl_tpu_torch.common import tensor_utils
from elasticdl_tpu_torch.proto import messages as pb


def encode_example(features: dict) -> bytes:
    ex = pb.Example()
    for name, value in features.items():
        ex.features[name] = tensor_utils.ndarray_to_tensor_pb(
            np.asarray(value), name
        )
    return ex.SerializeToString()


def decode_example(data: bytes) -> dict:
    ex = pb.Example.FromString(data)
    return {
        name: tensor_utils.tensor_pb_to_ndarray(t)
        for name, t in ex.features.items()
    }


def batch_examples(records):
    """Decode and stack a list of serialized Examples into a feature batch:
    {name: array of shape [batch, ...]}."""
    decoded = [decode_example(r) for r in records]
    if not decoded:
        return {}
    return {
        name: np.stack([d[name] for d in decoded]) for name in decoded[0]
    }
