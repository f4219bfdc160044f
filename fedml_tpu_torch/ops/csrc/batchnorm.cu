// Train-mode BatchNorm(+ReLU) forward (K1) and backward (K2) for Hopper.
//
// Replaces the Pallas TPU kernels in fedml_tpu/ops/batchnorm.py:
//   K1 _fwd_kernel (launched by _fwd), K2 _bwd_kernel (launched by _fused_bwd).
//
// The activation is the row-major [n, C] view of an NHWC tensor (C <= 1024;
// ResNet-56 has C = 16, 32, 64). Both passes do a handful of flops per
// element, so they are bound by device-memory bytes: K1 must read x and
// write y, K2 must read x, dy (and y for the ReLU mask) and write dx. At
// ResNet-56's shapes that is 0.3-2.5 us of bytes a call, so what a call
// costs beyond that is latency: launches, round trips, the cross-block sum.
//
// The TPU kernel carries its per-channel sums across a sequential grid; CUDA
// blocks run in no order. No float atomics in either kernel: two calls on
// the same inputs give the same bits.
//
// K1, three launches:
//   (a) partials: blocks stride over rows, every thread owns one channel
//       (thread t reads element t of each [R, C] tile, so loads are
//       contiguous across the block) and sums in f32; the block combines its
//       R row-groups in shared memory and writes a [blocks, 2, C] f32 scratch.
//   (b) finalize: one block sums the partials per channel in f64, split over
//       J threads per channel and combined by a fixed-order tree.
//   (c) an elementwise pass over [n * C] that writes y.
// It reads x twice; K2's one-pass design is its next step.
//
// K2, one cooperative launch (bn_bwd_onepass), like the TPU kernel's two
// phases over chunks it keeps resident:
//   - each block takes a contiguous range of whole rows and reads x, dy and
//     y once, 16 bytes a load where C and the alignment allow (8 bf16, 4
//     f32; else one element), with 4 rows of loads in flight per thread;
//   - it sums dbeta = sum g and dgamma = sum g * xhat per channel in f32 in
//     a fixed order into a [blocks, 2, C] partial, and keeps the masked g
//     and x of up to 88 KB of its rows in shared memory (at ResNet-56's
//     shapes every row: at most 497 rows of 16-64 channels a block);
//   - a grid barrier (grid_barrier.cuh; two words per (device, stream));
//   - every block sums the partials per channel in f64 in the same order,
//     so all hold the same dbeta and dgamma: one barrier, and the partials
//     (<= 132 x 2 x 64 floats at the path's shapes) come from L2;
//   - dx from the rows on chip (rows past a block's capacity are read
//     again, by the same kernel), written once, 16 bytes a store. A
//     thread's channels are fixed by the row layout, so gamma * rstd,
//     dbeta / n and dgamma / n sit in its registers: no per-element
//     division or modulo.
// The grid is one block an SM or fewer, planned once per (n, C, dtype,
// alignment, device) by the wrapper.
//
// What bounds K2: its bytes are 0.3-2.5 us a call at ResNet-56's shapes;
// the rest is latency — the launch, one round trip of loads per block, the
// grid barrier and the f64 sum of the partials. On an H100 the barrier
// timed dearer than the sum, so every block sums all partials itself
// rather than a few blocks summing and a second barrier publishing the
// result. One block an SM rather than two halves the partials and the
// arrivals at the barrier, and timed faster.
//
// The plan sets bn_bwd_onepass's shared-memory limit at the most any plan
// of that instantiation asks for, and only ever raises it: plans are
// cached, so one made later must not lower the limit of an earlier one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "grid_barrier.cuh"

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

// ---------------------------------------------------------------------------
// K2: one cooperative launch
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdBlocksPerSm = 1;
constexpr int kBwdMaxCols = 1024 / kBwdThreads;  // vector columns a thread owns, scalar loads
constexpr int kBwdUnroll = 4;                     // rows of loads in flight per thread
constexpr int kBwdSumLoads = 8;                   // partials in flight per thread in the sum
constexpr size_t kBwdStageBudget = 88 * 1024;     // bytes of rows a block keeps on chip

// Geometry of K2, computed once per (n, C, dtype, alignment, device) on the
// host and passed to the kernel by value; all ints so the wrapper can keep
// it as a plain int array.
struct BwdGeom {
  int V;            // elements per load: 16 bytes' worth (8 bf16, 4 f32), or 1
  int vpr;          // vectors per row, C / V
  int threads;      // block size: R * vpr, or kBwdThreads when vpr > kBwdThreads
  int R;            // rows the block's threads cover at once
  int cols;         // vector columns per thread (> 1 only when vpr > kBwdThreads)
  int cap;          // rows per block kept in shared memory between the passes
  int blocks;       // grid size, all resident at once
  int scratch_off;  // bytes: the f32 / f64 reduction scratch after the stage
  int coef_off;     // bytes: dbeta / n and dgamma / n per channel
};
constexpr int kBwdPlanInts = sizeof(BwdGeom) / sizeof(int);

template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* __restrict__ p, long long vec) {
  return *reinterpret_cast<const Pack<T, V>*>(p + vec * V);
}

// g = dy, zeroed where the ReLU output was not positive (a copy of dy's
// values, so it keeps dy's dtype exactly).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> relu_mask(Pack<T, V> d, const Pack<T, V>& y, int relu) {
  if (relu) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (!(to_f(y.v[v]) > 0.f)) d.v[v] = from_f<T>(0.f);
  }
  return d;
}

// Lanes per entry vector of K2's partial sum: the block's threads over the
// 2C / VE vectors of VE entries of a [2, C] partial row (VE = 4 when C is
// even, so a row is whole float4s), at least one.
__host__ __device__ __forceinline__ int sum_lanes(int threads, int C) {
  const int q = C % 2 == 0 ? C / 2 : 2 * C;
  return threads >= q ? threads / q : 1;
}

// The f64 sums of the gridDim.x partial rows [2, C] (written by other
// blocks before the grid barrier, so read through L2): lane j of entry
// vector q adds blocks j, j + J, ... in order, kBwdSumLoads of them in
// flight, into shd[j][2C]. Returns J.
template <int VE>
__device__ int partial_sums(const float* partial, int C, double* shd) {
  using F = typename std::conditional<VE == 4, float4, float>::type;
  const int E = 2 * C, Q = E / VE, J = sum_lanes(blockDim.x, C), B = gridDim.x;
  for (int i = threadIdx.x; i < J * Q; i += blockDim.x) {
    const int q = i % Q, j = i / Q;
    double s[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) s[e] = 0.0;
    for (int b0 = j; b0 < B; b0 += J * kBwdSumLoads) {
      float v[kBwdSumLoads][VE];
#pragma unroll
      for (int u = 0; u < kBwdSumLoads; ++u) {
        const int b = b0 + u * J;
        F f{};
        if (b < B) f = __ldcg(reinterpret_cast<const F*>(partial + (size_t)b * E) + q);
        if constexpr (VE == 4) {
          v[u][0] = f.x;
          v[u][1] = f.y;
          v[u][2] = f.z;
          v[u][3] = f.w;
        } else {
          v[u][0] = f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdSumLoads; ++u)
#pragma unroll
        for (int e = 0; e < VE; ++e) s[e] += v[u][e];
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) shd[j * E + q * VE + e] = s[e];
  }
  return J;
}

// K2: block b takes rows [n*b/B, n*(b+1)/B). Pass 0 reads x, dy (and y
// under ReLU) once, sums dbeta and dgamma of its rows per channel in f32
// (fixed order: each thread its rows in order, then the block's row groups
// in order) into partial[b], and keeps its first `cap` rows of x and g in
// shared memory. After a grid barrier every block sums the B partials per
// channel in f64 in the same order, so all blocks hold the same dbeta and
// dgamma, and pass 1 writes dx from the rows on chip (re-reading the rows
// past `cap` from device memory). Thread t owns the same vector columns in
// every row, so its channels, their mean / rstd and the coefficients of
// pass 1 sit in registers.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
bn_bwd_onepass(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
               const float* __restrict__ gamma, const float* __restrict__ mean,
               const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ dgamma,
               float* __restrict__ dbeta, float* __restrict__ partial, unsigned int* bar,
               long long n, int C, int relu, BwdGeom g) {
  using P = Pack<T, V>;
  constexpr int MC = V == 1 ? kBwdMaxCols : 1;  // V > 1 gives vpr <= 256: one column
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  P* sx = reinterpret_cast<P*>(smem);                 // [cap][vpr]
  P* sg = sx + (size_t)g.cap * g.vpr;                 // [cap][vpr]
  float* red = reinterpret_cast<float*>(smem + g.scratch_off);
  double* shd = reinterpret_cast<double*>(smem + g.scratch_off);
  float* coef = reinterpret_cast<float*>(smem + g.coef_off);

  const int t = threadIdx.x, vpr = g.vpr;
  const long long r0 = n * blockIdx.x / gridDim.x;
  const long long rows = n * (blockIdx.x + 1) / gridDim.x - r0;
  const long long cap = rows < g.cap ? rows : g.cap;
  const int ro = t / vpr;  // this thread's first row; its columns t % vpr + k * threads
  int col[MC];
  bool live[MC];
  float mk[MC][V], rk[MC][V], sb[MC][V], sgx[MC][V];
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    col[k] = t % vpr + k * g.threads;
    live[k] = k < g.cols && col[k] < vpr;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = col[k] * V + v;
      mk[k][v] = live[k] ? mean[c] : 0.f;
      rk[k][v] = live[k] ? rstd[c] : 0.f;
      sb[k][v] = sgx[k][v] = 0.f;
    }
  }

  // pass 0: kBwdUnroll rows of loads in flight, then sums and the stage
  for (long long rr = ro; rr < rows; rr += kBwdUnroll * g.R) {
    P xv[kBwdUnroll][MC], dv[kBwdUnroll][MC], yv[kBwdUnroll][MC];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const long long r = rr + (long long)u * g.R;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        if (r < rows && live[k]) {
          const long long vec = (r0 + r) * vpr + col[k];
          xv[u][k] = load_pack<T, V>(x, vec);
          dv[u][k] = load_pack<T, V>(dy, vec);
          if (relu) yv[u][k] = load_pack<T, V>(y, vec);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const long long r = rr + (long long)u * g.R;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        if (r < rows && live[k]) {
          const P gp = relu_mask<T, V>(dv[u][k], yv[u][k], relu);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float gv = to_f(gp.v[v]);
            sb[k][v] += gv;
            sgx[k][v] += gv * ((to_f(xv[u][k].v[v]) - mk[k][v]) * rk[k][v]);
          }
          if (r < cap) {
            sx[r * vpr + col[k]] = xv[u][k];
            sg[r * vpr + col[k]] = gp;
          }
        }
      }
    }
  }

  // the block's partial: its R row groups per channel, in order
  const int RC = g.R * C;
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[ro * C + col[k] * V + v] = sb[k][v];
      red[RC + ro * C + col[k] * V + v] = sgx[k][v];
    }
  }
  __syncthreads();
  for (int c = t; c < C; c += g.threads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < g.R; ++j) {
      a += red[j * C + c];
      b += red[RC + j * C + c];
    }
    partial[(size_t)blockIdx.x * 2 * C + c] = a;
    partial[(size_t)blockIdx.x * 2 * C + C + c] = b;
  }

  grid_barrier(bar);

  // the B partials per entry of the flat [2, C] row in f64, the same in
  // every block: partial_sums writes the sums of J lanes, the lanes are
  // added in order here
  const int J = C % 2 == 0 ? partial_sums<4>(partial, C, shd) : partial_sums<1>(partial, C, shd);
  __syncthreads();
  const double inv_n = 1.0 / (double)n;
  for (int c = t; c < C; c += g.threads) {
    double db = 0.0, dg = 0.0;
    for (int j = 0; j < J; ++j) {
      db += shd[j * 2 * C + c];
      dg += shd[j * 2 * C + C + c];
    }
    coef[c] = (float)(db * inv_n);
    coef[C + c] = (float)(dg * inv_n);
    if (blockIdx.x == 0) {
      dbeta[c] = (float)db;
      dgamma[c] = (float)dg;
    }
  }
  __syncthreads();

  // pass 1: dx = gamma * rstd * (g - dbeta / n - xhat * dgamma / n)
  float kk[MC][V], dbn[MC][V], dgn[MC][V];
#pragma unroll
  for (int k = 0; k < MC; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = col[k] * V + v;
      kk[k][v] = live[k] ? gamma[c] * rk[k][v] : 0.f;
      dbn[k][v] = live[k] ? coef[c] : 0.f;
      dgn[k][v] = live[k] ? coef[C + c] : 0.f;
    }
  for (long long r = ro; r < rows; r += g.R) {
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      if (!live[k]) continue;
      const long long vec = (r0 + r) * vpr + col[k];
      P xv, gp;
      if (r < cap) {
        xv = sx[r * vpr + col[k]];
        gp = sg[r * vpr + col[k]];
      } else {
        xv = load_pack<T, V>(x, vec);
        P yv;
        if (relu) yv = load_pack<T, V>(y, vec);
        gp = relu_mask<T, V>(load_pack<T, V>(dy, vec), yv, relu);
      }
      P out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xhat = (to_f(xv.v[v]) - mk[k][v]) * rk[k][v];
        out.v[v] = from_f<T>(kk[k][v] * (to_f(gp.v[v]) - dbn[k][v] - xhat * dgn[k][v]));
      }
      *reinterpret_cast<P*>(dx + vec * V) = out;
    }
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

size_t bwd_reduce_bytes(const BwdGeom& g, int C) {
  const size_t f32 = 2 * (size_t)g.R * C * sizeof(float);
  const size_t f64 = 2 * (size_t)sum_lanes(g.threads, C) * C * sizeof(double);
  return f32 > f64 ? f32 : f64;
}

// Fills the offsets of g for `cap` rows on chip; returns the block's bytes.
size_t bwd_layout(BwdGeom* g, int C, int cap, size_t elt) {
  g->cap = cap;
  g->scratch_off = (int)((2 * (size_t)cap * C * elt + 15) / 16 * 16);
  g->coef_off = g->scratch_off + (int)bwd_reduce_bytes(*g, C);
  return (size_t)g->coef_off + 2 * (size_t)C * sizeof(float);
}

// Raises a kernel's dynamic shared-memory limit on the current device to
// `bytes`, never lowers it: the plans of one instantiation differ in their
// bytes (they depend on C), and a plan made later for a smaller C must not
// take away what an earlier, cached plan launches with.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess || (size_t)a.maxDynamicSharedSizeBytes >= bytes) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// K2's plan: 16-byte loads where C and the alignment allow, a block per
// kBwdThreads threads' worth of whole rows, kBwdBlocksPerSm blocks an SM
// (no more than the card holds at once: a cooperative launch), no more
// blocks than rows or row sweeps, and as many of each block's rows on chip
// as kBwdStageBudget holds.
template <typename T, int V>
cudaError_t bwd_plan_t(long long n, int C, BwdGeom* g) {
  g->V = V;
  g->vpr = C / V;
  g->R = g->vpr <= kBwdThreads ? kBwdThreads / g->vpr : 1;
  g->threads = g->vpr <= kBwdThreads ? g->R * g->vpr : kBwdThreads;
  g->cols = (g->vpr + g->threads - 1) / g->threads;
  const size_t row_bytes = 2 * (size_t)C * sizeof(T);
  const long long budget = kBwdStageBudget / row_bytes > 0 ? kBwdStageBudget / row_bytes : 1;
  const size_t smax = bwd_layout(g, C, (int)budget, sizeof(T));
  auto kernel = bn_bwd_onepass<T, V>;
  cudaError_t e = raise_smem_limit(kernel, smax);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, g->threads, smax);
  if (e != cudaSuccess) return e;
  long long b = (long long)(occ < kBwdBlocksPerSm ? occ : kBwdBlocksPerSm) * sms;
  const long long sweeps = (n + g->R - 1) / g->R;
  if (b > sweeps) b = sweeps;
  if (b > n) b = n;
  if (b < 1) return cudaErrorInvalidValue;
  g->blocks = (int)b;
  const long long per = (n + b - 1) / b;
  bwd_layout(g, C, (int)(per < budget ? per : budget), sizeof(T));
  return cudaSuccess;
}

cudaError_t bwd_plan(long long n, int C, int dtype, int aligned, BwdGeom* g) {
  if (dtype == 1)
    return aligned && C % 8 == 0 ? bwd_plan_t<__nv_bfloat16, 8>(n, C, g)
                                 : bwd_plan_t<__nv_bfloat16, 1>(n, C, g);
  return aligned && C % 4 == 0 ? bwd_plan_t<float, 4>(n, C, g) : bwd_plan_t<float, 1>(n, C, g);
}

template <typename T, int V>
int bwd_launch(const void* x, const void* y, const void* dy, const float* gamma,
               const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
               float* partial, unsigned int* bar, long long n, int C, int relu,
               const BwdGeom& g, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  BwdGeom gg = g;
  void* args[] = {(void*)&xt,     (void*)&yt,     (void*)&dyt,   (void*)&gamma, (void*)&mean,
                  (void*)&rstd,   (void*)&dxt,    (void*)&dgamma, (void*)&dbeta, (void*)&partial,
                  (void*)&bar,    (void*)&n,      (void*)&C,     (void*)&relu,  (void*)&gg};
  const size_t smem = (size_t)g.coef_off + 2 * (size_t)C * sizeof(float);
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)bn_bwd_onepass<T, V>, dim3(g.blocks),
                                              dim3(g.threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the [blocks, 2, C] f32 scratch K1 needs.
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

// K2's plan for n rows of C channels of a dtype (0 = float32, 1 =
// bfloat16) on the current device, into plan[kBwdPlanInts] (the BwdGeom
// fields in order; plan[6] is the block count, the rows of the [blocks, 2,
// C] f32 scratch). aligned != 0 when x, y, dy and dx are 16-byte aligned.
// Returns a CUDA error code.
int fedml_bn_bwd_plan_ints() { return kBwdPlanInts; }

int fedml_bn_bwd_plan(long long n, int C, int dtype, int aligned, int* plan) {
  if (n < 1 || C < 1 || C > 1024) return (int)cudaErrorInvalidValue;
  BwdGeom g;
  cudaError_t e = bwd_plan(n, C, dtype, aligned, &g);
  if (e == cudaSuccess) *reinterpret_cast<BwdGeom*>(plan) = g;
  return (int)e;
}

// K2, one cooperative launch. x, y, dy and dx share one dtype (0 = float32,
// 1 = bfloat16); y is read only when relu != 0. dgamma and dbeta are
// float32 [C]; partial the [blocks, 2, C] f32 scratch; barrier two zeroed
// words that no other launch uses at the same time (zero again after the
// call); plan from fedml_bn_bwd_plan for this n, C, dtype and alignment.
int fedml_bn_bwd(const void* x, const void* y, const void* dy, const float* gamma,
                 const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
                 float* partial, unsigned int* barrier, long long n, int C, int relu, int dtype,
                 const int* plan, void* stream) {
  if (n < 1 || C < 1 || C > 1024) return (int)cudaErrorInvalidValue;
  const BwdGeom& g = *reinterpret_cast<const BwdGeom*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (g.V == 8)
      return bwd_launch<__nv_bfloat16, 8>(x, y, dy, gamma, mean, rstd, dx, dgamma, dbeta,
                                          partial, barrier, n, C, relu, g, s);
    return bwd_launch<__nv_bfloat16, 1>(x, y, dy, gamma, mean, rstd, dx, dgamma, dbeta, partial,
                                        barrier, n, C, relu, g, s);
  }
  if (g.V == 4)
    return bwd_launch<float, 4>(x, y, dy, gamma, mean, rstd, dx, dgamma, dbeta, partial, barrier,
                                n, C, relu, g, s);
  return bwd_launch<float, 1>(x, y, dy, gamma, mean, rstd, dx, dgamma, dbeta, partial, barrier,
                              n, C, relu, g, s);
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
