// A grid-wide barrier for cooperative launches (every block resident), used
// by the one-launch kernels that sum per-block partials across the grid:
// K1 and K2 (batchnorm.cu, bn_fwd_onepass and bn_bwd_onepass) and the bf16
// K4 (conv_lanes.cu, conv_wgrad_mma).
//
// bar points at two zeroed 32-bit words of the device that no other launch
// uses at the same time (the wrappers keep one pair per (device, stream);
// launches on one stream run in order, so kernels may share a pair).
// bar[0] counts arrivals and is reset by the last block, which then bumps
// the generation bar[1] that the others wait on: after the call bar[0] is
// zero again and bar[1] only ever grows (wrapping is harmless).
//
// Thread 0 arrives for its block after __syncthreads with a gpu-scope
// acquire-release add (so the block's writes before the barrier are
// released with it), the last block publishes the new generation with a
// release add, and the waiters poll it with acquire loads; __syncthreads
// then orders the rest of the block after the acquire. No __threadfence
// and no sleep between polls: with them K2 timed slower on an H100 at
// ResNet-56's shapes.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int g0, old, gv;
    asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(g0) : "l"(bar + 1) : "memory");
    const unsigned int blocks = gridDim.x * gridDim.y;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(bar) : "memory");
    if (old == blocks - 1) {
      asm volatile("st.relaxed.gpu.u32 [%0], 0;" ::"l"(bar) : "memory");
      asm volatile("red.release.gpu.add.u32 [%0], 1;" ::"l"(bar + 1) : "memory");
    } else {
      do {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(gv) : "l"(bar + 1) : "memory");
      } while (gv == g0);
    }
  }
  __syncthreads();
}
