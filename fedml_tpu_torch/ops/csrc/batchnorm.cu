// Train-mode BatchNorm(+ReLU) forward (K1) and backward (K2) for Hopper.
//
// Replaces the Pallas TPU kernels in fedml_tpu/ops/batchnorm.py:
//   K1 _fwd_kernel (launched by _fwd), K2 _bwd_kernel (launched by _fused_bwd).
//
// The activation is the row-major [n, C] view of an NHWC tensor (C <= 1024;
// ResNet-56 has C = 16, 32, 64). Both passes do a handful of flops per
// element, so they are bound by device-memory bytes: K1 must read x and
// write y, K2 must read x, dy (and y for the ReLU mask) and write dx.
//
// The TPU kernel carries its per-channel sums across a sequential grid; CUDA
// blocks run in no order, so each kernel is three launches:
//   (a) partials: blocks stride over rows, every thread owns one channel
//       (thread t reads element t of each [R, C] tile, so loads are
//       contiguous across the block) and sums in f32; the block combines its
//       R row-groups in shared memory and writes a [blocks, 2, C] f32 scratch.
//       No float atomics: the result is the same from run to run.
//   (b) finalize: one block sums the partials per channel in f64, split over
//       J threads per channel and combined by a fixed-order tree.
//   (c) an elementwise pass over [n * C] that writes y (K1) or dx (K2).
// Each kernel therefore reads its inputs twice (once for the sums, once for
// the elementwise pass); fusing (a) and (c) through shared memory or L2 is
// left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTargetThreads = 256;
constexpr int kMaxStatBlocks = 1024;
constexpr int kRowsPerThread = 8;
constexpr int kEltThreads = 256;
constexpr long long kMaxEltBlocks = 132 * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Threads of a partials block: R row-groups of C channels each.
int stat_threads(int C) {
  int r = kTargetThreads / C;
  return C * (r > 0 ? r : 1);
}

int stat_blocks(long long n, int C) {
  long long rows_per_block = (long long)(stat_threads(C) / C) * kRowsPerThread;
  long long b = (n + rows_per_block - 1) / rows_per_block;
  if (b < 1) b = 1;
  if (b > kMaxStatBlocks) b = kMaxStatBlocks;
  return (int)b;
}

// Threads of the finalize block: J lanes per channel, J a power of two.
int finalize_threads(int C) {
  int j = 1;
  while (j * 2 * C <= 1024) j *= 2;
  return C * j;
}

int elt_blocks(long long total) {
  long long b = (total + kEltThreads - 1) / kEltThreads;
  if (b < 1) b = 1;
  if (b > kMaxEltBlocks) b = kMaxEltBlocks;
  return (int)b;
}

// (a) of K1: per-block sums of x and x^2 per channel.
template <typename T>
__global__ void fwd_partials(const T* __restrict__ x, float* __restrict__ partial,
                             long long n, int C) {
  extern __shared__ float sh[];
  const int R = blockDim.x / C;
  const int c = threadIdx.x % C;
  const long long step = (long long)gridDim.x * R;
  float s = 0.f, ss = 0.f;
  for (long long r = (long long)blockIdx.x * R + threadIdx.x / C; r < n; r += step) {
    float v = to_f(x[r * C + c]);
    s += v;
    ss += v * v;
  }
  sh[threadIdx.x] = s;
  sh[blockDim.x + threadIdx.x] = ss;
  __syncthreads();
  if (threadIdx.x < C) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < R; ++j) {
      a += sh[j * C + c];
      b += sh[blockDim.x + j * C + c];
    }
    partial[(size_t)blockIdx.x * 2 * C + c] = a;
    partial[(size_t)blockIdx.x * 2 * C + C + c] = b;
  }
}

// Sums the [blocks, 2, C] partials per channel in f64: lane j of channel c
// takes blocks j, j + J, ... in order, then a fixed-order tree over the J
// lanes in shared memory — the same order on every run.
__device__ __forceinline__ void sum_partials(const float* __restrict__ partial, int blocks,
                                             int C, double* sh, double& a, double& b) {
  const int J = blockDim.x / C;
  const int c = threadIdx.x % C, j = threadIdx.x / C;
  double s0 = 0.0, s1 = 0.0;
  for (int blk = j; blk < blocks; blk += J) {
    s0 += partial[(size_t)blk * 2 * C + c];
    s1 += partial[(size_t)blk * 2 * C + C + c];
  }
  sh[threadIdx.x] = s0;
  sh[blockDim.x + threadIdx.x] = s1;
  __syncthreads();
  for (int half = J / 2; half > 0; half /= 2) {
    if (j < half) {
      sh[threadIdx.x] += sh[threadIdx.x + half * C];
      sh[blockDim.x + threadIdx.x] += sh[blockDim.x + threadIdx.x + half * C];
    }
    __syncthreads();
  }
  a = sh[c];
  b = sh[blockDim.x + c];
}

// (b) of K1: mean, biased variance and rstd per channel.
__global__ void fwd_finalize(const float* __restrict__ partial, int blocks, int C,
                             long long n, float eps, float* __restrict__ mean,
                             float* __restrict__ rstd, float* __restrict__ var) {
  extern __shared__ double shd[];
  double s, ss;
  sum_partials(partial, blocks, C, shd, s, ss);
  if (threadIdx.x < C) {
    const int c = threadIdx.x;
    double m = s / (double)n;
    double v = ss / (double)n - m * m;
    if (v < 0.0) v = 0.0;
    mean[c] = (float)m;
    var[c] = (float)v;
    rstd[c] = (float)(1.0 / sqrt(v + (double)eps));
  }
}

// (c) of K1: y = (x - mean) * rstd * gamma + beta, optional ReLU.
template <typename T>
__global__ void fwd_normalize(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd, T* __restrict__ y,
                              long long total, int C, int relu) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const int c = (int)(i % C);
    float v = (to_f(x[i]) - mean[c]) * rstd[c] * gamma[c] + beta[c];
    if (relu) v = fmaxf(v, 0.f);
    y[i] = from_f<T>(v);
  }
}

// (a) of K2: per-block sums of dy and dy * xhat per channel, dy masked by
// y > 0 under ReLU.
template <typename T>
__global__ void bwd_partials(const T* __restrict__ x, const T* __restrict__ y,
                             const T* __restrict__ dy, const float* __restrict__ mean,
                             const float* __restrict__ rstd, float* __restrict__ partial,
                             long long n, int C, int relu) {
  extern __shared__ float sh[];
  const int R = blockDim.x / C;
  const int c = threadIdx.x % C;
  const float m = mean[c], rs = rstd[c];
  const long long step = (long long)gridDim.x * R;
  float db = 0.f, dg = 0.f;
  for (long long r = (long long)blockIdx.x * R + threadIdx.x / C; r < n; r += step) {
    const long long o = r * C + c;
    float g = to_f(dy[o]);
    if (relu && !(to_f(y[o]) > 0.f)) g = 0.f;
    db += g;
    dg += g * ((to_f(x[o]) - m) * rs);
  }
  sh[threadIdx.x] = db;
  sh[blockDim.x + threadIdx.x] = dg;
  __syncthreads();
  if (threadIdx.x < C) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < R; ++j) {
      a += sh[j * C + c];
      b += sh[blockDim.x + j * C + c];
    }
    partial[(size_t)blockIdx.x * 2 * C + c] = a;
    partial[(size_t)blockIdx.x * 2 * C + C + c] = b;
  }
}

// (b) of K2: dbeta and dgamma per channel.
__global__ void bwd_finalize(const float* __restrict__ partial, int blocks, int C,
                             float* __restrict__ dgamma, float* __restrict__ dbeta) {
  extern __shared__ double shd[];
  double db, dg;
  sum_partials(partial, blocks, C, shd, db, dg);
  if (threadIdx.x < C) {
    dbeta[threadIdx.x] = (float)db;
    dgamma[threadIdx.x] = (float)dg;
  }
}

// (c) of K2: dx = gamma * rstd * (dy - dbeta / n - xhat * dgamma / n).
template <typename T>
__global__ void bwd_dx(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ dy, const float* __restrict__ gamma,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       const float* __restrict__ dgamma, const float* __restrict__ dbeta,
                       T* __restrict__ dx, long long total, int C, float n_rows, int relu) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const int c = (int)(i % C);
    float g = to_f(dy[i]);
    if (relu && !(to_f(y[i]) > 0.f)) g = 0.f;
    const float xhat = (to_f(x[i]) - mean[c]) * rstd[c];
    const float v = (gamma[c] * rstd[c]) * (g - dbeta[c] / n_rows - xhat * dgamma[c] / n_rows);
    dx[i] = from_f<T>(v);
  }
}

template <typename T>
int fwd_launch(const void* x, const float* gamma, const float* beta, void* y, float* mean,
               float* rstd, float* var, float* partial, long long n, int C, float eps,
               int relu, cudaStream_t stream) {
  const int nt = stat_threads(C);
  const int blocks = stat_blocks(n, C);
  const T* xt = static_cast<const T*>(x);
  fwd_partials<T><<<blocks, nt, 2 * nt * sizeof(float), stream>>>(xt, partial, n, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int ft = finalize_threads(C);
  fwd_finalize<<<1, ft, 2 * ft * sizeof(double), stream>>>(partial, blocks, C, n, eps, mean,
                                                            rstd, var);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = n * C;
  fwd_normalize<T><<<elt_blocks(total), kEltThreads, 0, stream>>>(
      xt, gamma, beta, mean, rstd, static_cast<T*>(y), total, C, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_launch(const void* x, const void* y, const void* dy, const float* gamma,
               const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
               float* partial, long long n, int C, int relu, cudaStream_t stream) {
  const int nt = stat_threads(C);
  const int blocks = stat_blocks(n, C);
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  bwd_partials<T><<<blocks, nt, 2 * nt * sizeof(float), stream>>>(
      xt, yt, dyt, mean, rstd, partial, n, C, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int ft = finalize_threads(C);
  bwd_finalize<<<1, ft, 2 * ft * sizeof(double), stream>>>(partial, blocks, C, dgamma, dbeta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = n * C;
  bwd_dx<T><<<elt_blocks(total), kEltThreads, 0, stream>>>(
      xt, yt, dyt, gamma, mean, rstd, dgamma, dbeta, static_cast<T*>(dx), total, C,
      (float)n, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the [blocks, 2, C] f32 scratch both kernels need.
int fedml_bn_stat_blocks(long long n, int C) { return stat_blocks(n, C); }

// dtype: 0 = float32, 1 = bfloat16 (x and y). gamma, beta, mean, rstd and
// var are float32 [C]. Returns the first CUDA error of the three launches.
int fedml_bn_fwd(const void* x, const float* gamma, const float* beta, void* y, float* mean,
                 float* rstd, float* var, float* partial, long long n, int C, float eps,
                 int relu, int dtype, void* stream) {
  if (n < 1 || C < 1 || C > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd_launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, var, partial, n, C, eps,
                                     relu, s);
  return fwd_launch<float>(x, gamma, beta, y, mean, rstd, var, partial, n, C, eps, relu, s);
}

// x, y, dy and dx share one dtype (0 = float32, 1 = bfloat16); y is read
// only when relu != 0. dgamma and dbeta are float32 [C].
int fedml_bn_bwd(const void* x, const void* y, const void* dy, const float* gamma,
                 const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
                 float* partial, long long n, int C, int relu, int dtype, void* stream) {
  if (n < 1 || C < 1 || C > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(x, y, dy, gamma, mean, rstd, dx, dgamma, dbeta, partial,
                                     n, C, relu, s);
  return bwd_launch<float>(x, y, dy, gamma, mean, rstd, dx, dgamma, dbeta, partial, n, C,
                           relu, s);
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
