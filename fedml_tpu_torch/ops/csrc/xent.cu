// Fused softmax cross-entropy with integer labels for Hopper: K5.
//
// Replaces the Pallas TPU kernel
//   K5 _xent_kernel    fedml_tpu/ops/xent.py  (launched by _pallas_xent)
//
// Computes, per row r of logits [N, V]:
//   loss_r = m + log(sum_v exp(x_rv - m)) - x_r,label_r,   m = max_v x_rv,
// in f32, streaming the row once and never writing the probabilities.
//
// What bounds it on this card: at the LM path's shape (N = 16384 rows of
// V = 10004 f32 logits) one call reads 656 MB and writes 64 KB, with ~3
// operations per logit, so it is bound by device-memory bytes (~0.2 ms at
// 3.35 TB/s). The design reads each logit exactly once, coalesced.
//
// Design, against the TPU kernel:
// - The TPU kernel gives a grid step a block of rows and loops over V in
//   slices of block_v, padding V up to a whole slice with -1e30 columns in a
//   copy. Here one warp owns one row (8 rows per 256-thread block): lane t
//   reads columns t, t+32, t+64, ..., so each warp load is 32 consecutive
//   elements, and the row's ragged tail is simply where the lane loop ends:
//   no padding copy.
// - Each lane keeps a running (max, sum-exp) in f32 with one exp per logit
//   (the sum is rescaled only when the max grows), and the lane that holds
//   the label column keeps its logit; the warp then merges the 32 pairs
//   with shuffles: m = max(m_a, m_b), s = s_a exp(m_a - m) + s_b exp(m_b - m).
// - A label outside [0, V) matches no column, so the gold logit is 0, as in
//   the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void push(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
xent_kernel(const T* __restrict__ logits, const L* __restrict__ labels, float* __restrict__ out,
            long long N, int V) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= N) return;
  const T* x = logits + row * V;
  const long long label = (long long)labels[row];
  float m = kNegInf, s = 0.f, g = 0.f;
  int c = lane;
  for (; c + 96 < V; c += 128) {
    const float x0 = to_f(x[c]), x1 = to_f(x[c + 32]), x2 = to_f(x[c + 64]),
                x3 = to_f(x[c + 96]);
    push(x0, m, s);
    push(x1, m, s);
    push(x2, m, s);
    push(x3, m, s);
    if (label >= c && label <= c + 96 && (label - c) % 32 == 0)
      g = label == c ? x0 : label == c + 32 ? x1 : label == c + 64 ? x2 : x3;
  }
  for (; c < V; c += 32) {
    const float xc = to_f(x[c]);
    push(xc, m, s);
    if (label == c) g = xc;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, mo);
    s = (s == 0.f ? 0.f : s * expf(m - mn)) + (so == 0.f ? 0.f : so * expf(mo - mn));
    m = mn;
    g += __shfl_xor_sync(0xffffffffu, g, off);
  }
  if (lane == 0) out[row] = m + logf(s) - g;
}

template <typename T>
int launch_labels(const void* logits, const void* labels, int label_bytes, float* out,
                  long long N, int V, cudaStream_t stream) {
  const long long blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  if (label_bytes == 8)
    xent_kernel<T, long long><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const long long*>(labels), out, N, V);
  else
    xent_kernel<T, int><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(logits), static_cast<const int*>(labels), out, N, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. logits [N, V] (dtype 0 = float32, 1 = bfloat16), labels [N] int32
// (label_bytes 4) or int64 (8); out [N] float32. Returns the CUDA error of
// the launch.
int fedml_xent_fwd(const void* logits, const void* labels, int label_bytes, float* out,
                   long long N, int V, int dtype, void* stream) {
  if (N < 1 || V < 1 || (N + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL ||
      (label_bytes != 4 && label_bytes != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_labels<__nv_bfloat16>(logits, labels, label_bytes, out, N, V, s);
  return launch_labels<float>(logits, labels, label_bytes, out, N, V, s);
}

const char* fedml_xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
