"""elasticdl_tpu_torch: the PyTorch/CUDA port of elasticdl_tpu.

The port keeps the JAX package's module layout and names, so each module's
counterpart sits at the same path under `elasticdl_tpu/`. It imports torch,
numpy and the standard library only, never JAX and nothing of the JAX
package. Entry points take `device=None`, meaning the CUDA device; the CPU is
used only when the caller asks for it (common/device.py).
"""
