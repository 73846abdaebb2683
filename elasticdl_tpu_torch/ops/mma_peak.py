"""Measures the card's rate for the instruction the flash-attention
kernels are built on, mma.sync.aligned.m16n8k8 with TF32 operands and f32
sums, with no memory traffic:

    python3 -m elasticdl_tpu_torch.ops.mma_peak

Each warp issues ITERS rounds of CHAINS independent MMAs in blocks of 8
warps, once with one block per SM (shared memory caps it there, as in the
kernels) and once with as many as fit. Prints one JSON line each:
TFLOP/s (2 * 16 * 8 * 8 per MMA), the 3xTF32 rate that follows (a third
of it), and the data-sheet 495 TFLOP/s dense TF32 peak, which only wgmma
reaches. chip_smoke.py calls `measure` for the one-block-per-SM rate, the
ceiling of the kernels it reports. Needs a CUDA device and nvcc.
"""

import ctypes
import json
import os
import subprocess

import torch

from elasticdl_tpu_torch.ops import _build

ITERS = 4096
CHAINS = 8
WARPS = 8
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kChains>
__global__ void __launch_bounds__(256, 1) mma_loop(float* out, int iters,
                                                   uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7 + i) << 13;
  for (int i = 0; i < 2; ++i) b[i] = (seed + threadIdx.x * 5 + i) << 13;
  float acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
  for (int c = 0; c < kChains; ++c)
    for (int e = 0; e < 4; ++e) sum += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// smem: dynamic shared memory per block, only to cap the blocks per SM.
extern "C" int edl_mma_loop(void* out, int blocks, int threads, int iters,
                            int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mma_loop<%CHAINS%>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mma_loop<%CHAINS%><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (float*)out, iters, 1u);
  return (int)cudaGetLastError();
}
"""


def _library():
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "mma_peak")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "mma_loop.cu")
    lib = os.path.join(out_dir, "mma_loop.so")
    with open(src, "w") as f:
        f.write(SOURCE.replace("%CHAINS%", str(CHAINS)))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).edl_mma_loop
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def measure(fn, smem):
    """One timed run of the MMA loop on every SM: one block per SM when
    `smem` is large, as many as fit when it is 0. Returns the JSON row."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = 8 * sms, 32 * WARPS
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(out.data_ptr(), blocks, threads, ITERS, smem, stream)
        if err:
            raise RuntimeError(f"mma_loop launch failed ({err})")

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        launch()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 5
    mmas = blocks * WARPS * ITERS * CHAINS
    tflops = mmas * 2 * 16 * 8 * 8 / ms / 1e9
    return {
        "device": torch.cuda.get_device_name(0), "sms": sms,
        "blocks_per_sm": 1 if smem else "as many as fit",
        "warps_per_block": WARPS, "chains_per_warp": CHAINS, "ms": ms,
        "mma_tf32_tflops": tflops, "3xtf32_tflops": tflops / 3,
        "datasheet_tf32_tflops": 495.0,
    }


ONE_BLOCK_PER_SM = 200 * 1024  # shared memory that caps it there


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    fn = _library()
    for smem in (ONE_BLOCK_PER_SM, 0):
        print(json.dumps(measure(fn, smem)), flush=True)


if __name__ == "__main__":
    main()
