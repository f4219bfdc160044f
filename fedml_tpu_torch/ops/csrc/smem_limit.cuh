// Raising a kernel's dynamic shared-memory limit, for every kernel of the
// port that asks for more than the 48 KB default.
//
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize) acts on
// the current device only, so a limit remembered by the caller (once per
// kernel, in a static) would leave a second card at its default. Instead
// the current device's limit is read back with cudaFuncGetAttributes on
// every call that needs more than the default, and raised when it is
// short, never lowered: one kernel serves launches, or cached plans, of
// different sizes, and one made later for a smaller size must not take
// away what an earlier one launches with.
//
// Up to kSmemDefault bytes need no raise on any device for a kernel that
// declares no static shared memory, which holds for every kernel that
// calls this; such a launch skips the query, which a wrapper launching
// per call (K3, K7, K6) would otherwise pay on its host path every time.
#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

constexpr size_t kSmemDefault = 48 * 1024;

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess || (size_t)a.maxDynamicSharedSizeBytes >= bytes) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
