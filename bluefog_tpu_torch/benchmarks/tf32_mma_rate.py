"""The card's own rate for TF32 ``mma.sync``, the instruction of the f32
forward and dK/dV flash kernels (``csrc/flash_attention_f32.cu``).

The published 495 TFLOP/s of TF32 is ``wgmma``'s.  This probe runs
``mma.sync.m16n8k8`` TF32 products and nothing else: every warp issues
eight independent accumulator chains, 4, 8 and 16 warps a block, four
blocks a SM, timed between CUDA events.  Its rate over three is the most
a 3xTF32 kernel built on ``mma.sync`` can reach.  The kernel is built
with nvcc into ``bluefog_tpu_torch/_build/`` (a plain C interface, loaded
with ctypes), like the package's kernels.

    python -m bluefog_tpu_torch.benchmarks.tf32_mma_rate

prints one JSON line.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from bluefog_tpu_torch.benchmarks.attention_roofline import nvidia_smi
from bluefog_tpu_torch.kernels import _build

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void probe(float* out, int iters, uint32_t seed) {
  float acc[8][4] = {};
  const uint32_t a0 = seed, a1 = seed * 3, a2 = seed * 5, a3 = seed * 7;
  const uint32_t b0 = seed * 11, b1 = seed * 13;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// Milliseconds of one launch of `blocks` blocks of `warps` warps, `iters`
// rounds of 8 products a warp; out holds blocks * warps * 32 floats.
extern "C" float bf_tf32_mma_ms(float* out, int blocks, int warps, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  probe<<<blocks, 32 * warps>>>(out, 16, 1);  // warm up
  cudaEventRecord(e0);
  probe<<<blocks, 32 * warps>>>(out, iters, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}
// The SM clock the card reports as its maximum, kHz.
extern "C" int bf_clock_khz() {
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  return khz;
}
"""
ITERS = 4096
FLOPS_PER_MMA = 2 * 16 * 8 * 8


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("tf32_mma_rate: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "tf32_mma_rate.cu")
    lib_path = os.path.join(_build.BUILD_DIR, "libtf32_mma_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.bf_tf32_mma_ms.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.bf_tf32_mma_ms.restype = ctypes.c_float
    lib.bf_clock_khz.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = lib.bf_clock_khz() * 1e3  # the reported maximum, not the clock under load
    rows = []
    for warps in (4, 8, 16):
        blocks = 4 * sms
        out = torch.empty(blocks * warps * 32, device="cuda")
        ms = lib.bf_tf32_mma_ms(out.data_ptr(), blocks, warps, ITERS)
        if ms <= 0:
            raise RuntimeError(f"tf32_mma_rate: launch of {warps} warps a block failed")
        mmas = blocks * warps * ITERS * 8
        rows.append({"warps_per_block": warps, "blocks": blocks, "ms": ms,
                     "tf32_tflops": mmas * FLOPS_PER_MMA / (ms * 1e-3) / 1e12,
                     "mma_per_sm_per_clk": mmas / sms / (ms * 1e-3 * clock_hz)})
    best = max(r["tf32_tflops"] for r in rows)
    print(json.dumps({
        "metric": "mma.sync.m16n8k8 TF32 rate, products alone", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(), "sms": sms, "clock_hz": clock_hz, "rows": rows,
        "best_tf32_tflops": best, "share_of_495": best / 495.0,
        "three_product_f32_tflops": best / 3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
