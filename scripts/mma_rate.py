"""The card's mma.sync m16n8k8 TF32 rate, the instruction the port's field
kernel (lzzx_nerf_tpu_torch/csrc/fused_field.cu) issues, measured without
anything else in the way.

    python3 scripts/mma_rate.py

Builds a small CUDA program with nvcc (in a temporary directory) whose
warps issue independent mma.sync m16n8k8 TF32 instructions on register
operands, one block per SM at 4-16 warps and 4 or 8 accumulators a warp,
and prints the rate of each: TFLOP/s and mma per microsecond per SM. The
field kernel's own rate (its mma count over its time) is to be read
against the best of these, not against the card's dense TF32 peak, which
only wgmma reaches. Needs nvcc and an sm_90a card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NACC>
__global__ void loop(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  float c[NACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma(c[j], a, a[0], a[1]);
  }
  float s = 0.0f;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC>
void run(int sms, int warps, float* out) {
  const int iters = 4096, reps = 5;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  loop<NACC><<<sms, warps * 32>>>(out, iters);
  cudaEventRecord(e0);
  for (int r = 0; r < reps; ++r) loop<NACC><<<sms, warps * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  ms /= reps;
  const double mmas = (double)sms * warps * iters * NACC;
  printf("warps/SM %2d, %d accumulators: %.4f ms, %.1f TFLOP/s, "
         "%.1f mma per us per SM\n", warps, NACC, ms,
         mmas * 2048.0 / (ms * 1e-3) / 1e12, mmas / sms / (ms * 1e3));
}

int main() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)sms * 512 * sizeof(float)) != cudaSuccess)
    return 1;
  for (int w : {4, 8, 12, 16}) {
    run<4>(sms, w, out);
    run<8>(sms, w, out);
  }
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "mma_rate.cu")
        exe = os.path.join(tmp, "mma_rate")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-o", exe, src], check=True)
        return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
