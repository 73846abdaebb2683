"""The port's device rule: `None` means the CUDA device, and a missing CUDA
device is an error, never a quiet move to the CPU. Tests pass "cpu"."""

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None, a string or a torch.device) -> torch.device.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and torch sees no CUDA device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "elasticdl_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU"
        )
    return device
