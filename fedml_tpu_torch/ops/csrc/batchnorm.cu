// Train-mode BatchNorm(+ReLU) forward (K1) and backward (K2) for Hopper.
//
// Replaces the Pallas TPU kernels in fedml_tpu/ops/batchnorm.py:
//   K1 _fwd_kernel (launched by _fwd), K2 _bwd_kernel (launched by _fused_bwd).
//
// The activation is the row-major [n, C] view of an NHWC tensor (C <= 4096;
// ResNet-56 has C = 16, 32, 64, EfficientNet-b7 up to 3840). Both passes do a handful of flops per
// element, so they are bound by device-memory bytes: K1 must read x and
// write y, K2 must read x, dy (and y for the ReLU mask) and write dx. At
// ResNet-56's shapes that is 0.3-2.5 us of bytes a call, so what a call
// costs beyond that is latency: the launch, round trips, the cross-block sum.
//
// The TPU kernel carries its per-channel sums across a sequential grid (and
// keeps the activation resident between its two phases); CUDA blocks run in
// no order. Each kernel here is one cooperative launch that does both
// phases, in the same shape:
//   - each block takes a contiguous range of whole rows and reads its inputs
//     once, 16 bytes a load where C and the alignment allow (8 bf16, 4 f32;
//     else one element), with 4 rows of loads in flight per thread;
//   - it sums its rows per channel in f32 in a fixed order (each thread its
//     rows in order, then the block's row groups in order) into a [blocks,
//     2, C] partial, and keeps as many of its rows as 88 KB of shared memory
//     hold (at ResNet-56's shapes and batch 64, every row);
//   - a grid barrier (grid_barrier.cuh; two words per (device, stream));
//   - every block sums the partials per channel in f64 in the same order,
//     so all hold the same statistics: one barrier, and the partials (<= 132
//     x 2 x 64 floats at the path's shapes) come from L2;
//   - the elementwise output from the rows on chip (rows past a block's
//     capacity are read again, by the same kernel), written once, 16 bytes
//     a store. A thread's channels are fixed by the row layout, so their
//     per-channel coefficients sit in its registers: no per-element
//     division or modulo.
// No float atomics: two calls on the same inputs give the same bits.
//
// Wide rows. A thread owns up to kBnMaxCols scalar columns, or one vector
// column, in its registers (1024 channels at 256 threads, 2048 bf16); a row
// wider than that (EfficientNet's 1152-3840 channels) takes the kernels'
// Wide instantiation, which owns up to kBnWideCols columns a thread with
// one row of loads in flight, as a wide row already gives each thread that
// many loads a row. The plan picks it from the columns a thread needs, so
// every narrower shape runs the same code and plan as before; the sums keep
// their fixed order. The f64 sums of the partials, two f32 coefficients and
// at least one row a block on chip bound C to kBnMaxC in shared memory.
//
// K1 (bn_fwd_onepass) sums x and x^2 and keeps only x on chip, so a block
// holds twice K2's rows per byte; the f64 sums give mean, var = E[x^2] -
// mean^2 (the TPU kernel's formula, clamped at 0) and rstd, which block 0
// writes out, and y = (x - mean) * rstd * gamma + beta (+ReLU) in f32,
// stored in x's dtype. K2 (bn_bwd_onepass) sums dbeta = sum g and dgamma =
// sum g * xhat of the masked g = dy * (y > 0), keeps x and g on chip, and
// writes dx = gamma * rstd * (g - dbeta / n - xhat * dgamma / n).
//
// The grid is one block an SM or fewer (co-resident, as the barrier needs),
// planned once per (kernel, n, C, dtype, alignment, device) by the wrapper.
// What bounds both: their bytes are 0.3-2.5 us a call at ResNet-56's shapes;
// the rest is latency — the launch, one round trip of loads per block, the
// grid barrier and the f64 sum of the partials. On an H100 the barrier
// timed dearer than the sum, so every block sums all partials itself
// rather than a few blocks summing and a second barrier publishing the
// result. One block an SM rather than two halves the partials and the
// arrivals at the barrier, and timed faster (K2).
//
// A plan raises its kernel's shared-memory limit on the current device to
// the most any plan of that instantiation asks for (smem_limit.cuh), and
// never lowers it: plans are cached, so one made later must not lower the
// limit of an earlier one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "grid_barrier.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kBnThreads = 256;
constexpr int kBnBlocksPerSm = 1;
constexpr int kBnMaxCols = 1024 / kBnThreads;  // vector columns a thread owns, scalar loads
constexpr int kBnUnroll = 4;                    // rows of loads in flight per thread
constexpr int kBnMaxC = 4096;                   // channels the kernels take
constexpr int kBnSumLoads = 8;                  // partials in flight per thread in the sum
constexpr size_t kBnStageBudget = 88 * 1024;    // bytes of rows a block keeps on chip

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Geometry of K1 or K2, computed once per (kernel, n, C, dtype, alignment,
// device) on the host and passed to the kernel by value; all ints so the
// wrapper can keep it as a plain int array.
struct Geom {
  int V;            // elements per load: 16 bytes' worth (8 bf16, 4 f32), or 1
  int vpr;          // vectors per row, C / V
  int threads;      // block size: R * vpr, or kBnThreads when vpr > kBnThreads
  int R;            // rows the block's threads cover at once
  int cols;         // vector columns per thread (> 1 only when vpr > kBnThreads)
  int cap;          // rows per block kept in shared memory between the passes
  int blocks;       // grid size, all resident at once
  int scratch_off;  // bytes: the f32 / f64 reduction scratch after the stage
  int coef_off;     // bytes: two per-channel f32 coefficients (K1: mean, rstd;
                    // K2: dbeta / n, dgamma / n)
};
constexpr int kPlanInts = sizeof(Geom) / sizeof(int);

// Vector columns a thread owns: narrow, at most kBnMaxCols scalar or one
// vector column; wide, enough for kBnMaxC channels at kBnThreads threads.
__host__ __device__ constexpr int max_cols(int V, bool wide) {
  return wide ? (kBnMaxC / V + kBnThreads - 1) / kBnThreads : (V == 1 ? kBnMaxCols : 1);
}

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

// Lanes per entry vector of the partial sum: the block's threads over the
// 2C / VE vectors of VE entries of a [2, C] partial row (VE = 4 when C is
// even, so a row is whole float4s), at least one.
__host__ __device__ __forceinline__ int sum_lanes(int threads, int C) {
  const int q = C % 2 == 0 ? C / 2 : 2 * C;
  return threads >= q ? threads / q : 1;
}

// The f64 sums of the gridDim.x partial rows [2, C] (written by other
// blocks before the grid barrier, so read through L2): lane j of entry
// vector q adds blocks j, j + J, ... in order, kBnSumLoads of them in
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
    for (int b0 = j; b0 < B; b0 += J * kBnSumLoads) {
      float v[kBnSumLoads][VE];
#pragma unroll
      for (int u = 0; u < kBnSumLoads; ++u) {
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
      for (int u = 0; u < kBnSumLoads; ++u)
#pragma unroll
        for (int e = 0; e < VE; ++e) s[e] += v[u][e];
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) shd[j * E + q * VE + e] = s[e];
  }
  return J;
}

// Writes the block's partial: its R row groups' two f32 sums per channel,
// added in order, from red[2][R][C] (filled by the caller before).
__device__ __forceinline__ void write_partial(const float* red, float* partial, int C,
                                              const Geom& g) {
  const int RC = g.R * C;
  for (int c = threadIdx.x; c < C; c += g.threads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < g.R; ++j) {
      a += red[j * C + c];
      b += red[RC + j * C + c];
    }
    partial[(size_t)blockIdx.x * 2 * C + c] = a;
    partial[(size_t)blockIdx.x * 2 * C + C + c] = b;
  }
}

// After the grid barrier: the B partials per entry of the flat [2, C] row
// in f64, the same in every block. partial_sums writes the sums of J lanes
// to shd[J][2C]; the lanes are added in order by the caller.
__device__ __forceinline__ int sum_all_partials(const float* partial, int C, double* shd) {
  const int J = C % 2 == 0 ? partial_sums<4>(partial, C, shd) : partial_sums<1>(partial, C, shd);
  __syncthreads();
  return J;
}

// K1: block b takes rows [n*b/B, n*(b+1)/B). Pass 0 reads x once, sums x
// and x^2 of its rows per channel in f32 into partial[b], and keeps its
// first `cap` rows of x in shared memory. After a grid barrier every block
// sums the B partials per channel in f64 in the same order and derives mean,
// var = E[x^2] - mean^2 (clamped at 0) and rstd = 1 / sqrt(var + eps), which
// block 0 writes out; pass 1 writes y from the rows on chip (re-reading the
// rows past `cap` from device memory). Thread t owns the same vector columns
// in every row, so its channels' mean, rstd, gamma and beta sit in registers.
template <typename T, int V, bool Wide>
__global__ void __launch_bounds__(kBnThreads, kBnBlocksPerSm)
bn_fwd_onepass(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean,
               float* __restrict__ rstd, float* __restrict__ var, float* __restrict__ partial,
               unsigned int* bar, long long n, int C, float eps, int relu, Geom g) {
  using P = Pack<T, V>;
  constexpr int MC = max_cols(V, Wide);
  constexpr int UN = Wide ? 1 : kBnUnroll;  // rows of loads in flight
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  P* sx = reinterpret_cast<P*>(smem);  // [cap][vpr]
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
  float s1[MC][V], s2[MC][V];
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    col[k] = t % vpr + k * g.threads;
    live[k] = k < g.cols && col[k] < vpr;
#pragma unroll
    for (int v = 0; v < V; ++v) s1[k][v] = s2[k][v] = 0.f;
  }

  // pass 0: kBnUnroll rows of loads in flight, then sums and the stage
  for (long long rr = ro; rr < rows; rr += UN * g.R) {
    P xv[UN][MC];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const long long r = rr + (long long)u * g.R;
#pragma unroll
      for (int k = 0; k < MC; ++k)
        if (r < rows && live[k]) xv[u][k] = load_pack<T, V>(x, (r0 + r) * vpr + col[k]);
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const long long r = rr + (long long)u * g.R;
#pragma unroll
      for (int k = 0; k < MC; ++k) {
        if (r < rows && live[k]) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xf = to_f(xv[u][k].v[v]);
            s1[k][v] += xf;
            s2[k][v] += xf * xf;
          }
          if (r < cap) sx[r * vpr + col[k]] = xv[u][k];
        }
      }
    }
  }

  const int RC = g.R * C;
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[ro * C + col[k] * V + v] = s1[k][v];
      red[RC + ro * C + col[k] * V + v] = s2[k][v];
    }
  }
  __syncthreads();
  write_partial(red, partial, C, g);

  grid_barrier(bar);

  const int J = sum_all_partials(partial, C, shd);
  for (int c = t; c < C; c += g.threads) {
    double s = 0.0, ss = 0.0;
    for (int j = 0; j < J; ++j) {
      s += shd[j * 2 * C + c];
      ss += shd[j * 2 * C + C + c];
    }
    const double m = s / (double)n;
    double v = ss / (double)n - m * m;
    if (v < 0.0) v = 0.0;
    const float rs = (float)(1.0 / sqrt(v + (double)eps));
    coef[c] = (float)m;
    coef[C + c] = rs;
    if (blockIdx.x == 0) {
      mean[c] = (float)m;
      var[c] = (float)v;
      rstd[c] = rs;
    }
  }
  __syncthreads();

  // pass 1: y = (x - mean) * rstd * gamma + beta, optional ReLU
  float mk[MC][V], rk[MC][V], gk[MC][V], bk[MC][V];
#pragma unroll
  for (int k = 0; k < MC; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = col[k] * V + v;
      mk[k][v] = live[k] ? coef[c] : 0.f;
      rk[k][v] = live[k] ? coef[C + c] : 0.f;
      gk[k][v] = live[k] ? gamma[c] : 0.f;
      bk[k][v] = live[k] ? beta[c] : 0.f;
    }
  for (long long r = ro; r < rows; r += g.R) {
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      if (!live[k]) continue;
      const long long vec = (r0 + r) * vpr + col[k];
      const P xv = r < cap ? sx[r * vpr + col[k]] : load_pack<T, V>(x, vec);
      P out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float o = (to_f(xv.v[v]) - mk[k][v]) * rk[k][v] * gk[k][v] + bk[k][v];
        if (relu) o = fmaxf(o, 0.f);
        out.v[v] = from_f<T>(o);
      }
      *reinterpret_cast<P*>(y + vec * V) = out;
    }
  }
}

// K2: block b takes rows [n*b/B, n*(b+1)/B). Pass 0 reads x, dy (and y
// under ReLU) once, sums dbeta and dgamma of its rows per channel in f32
// into partial[b], and keeps its first `cap` rows of x and g in shared
// memory. After a grid barrier every block sums the B partials per channel
// in f64 in the same order, so all blocks hold the same dbeta and dgamma,
// and pass 1 writes dx from the rows on chip (re-reading the rows past
// `cap` from device memory). Thread t owns the same vector columns in every
// row, so its channels, their mean / rstd and the coefficients of pass 1
// sit in registers.
template <typename T, int V, bool Wide>
__global__ void __launch_bounds__(kBnThreads, kBnBlocksPerSm)
bn_bwd_onepass(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
               const float* __restrict__ gamma, const float* __restrict__ mean,
               const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ dgamma,
               float* __restrict__ dbeta, float* __restrict__ partial, unsigned int* bar,
               long long n, int C, int relu, Geom g) {
  using P = Pack<T, V>;
  constexpr int MC = max_cols(V, Wide);
  constexpr int UN = Wide ? 1 : kBnUnroll;  // rows of loads in flight
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

  // pass 0: kBnUnroll rows of loads in flight, then sums and the stage
  for (long long rr = ro; rr < rows; rr += UN * g.R) {
    P xv[UN][MC], dv[UN][MC], yv[UN][MC];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
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
    for (int u = 0; u < UN; ++u) {
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
  write_partial(red, partial, C, g);

  grid_barrier(bar);

  const int J = sum_all_partials(partial, C, shd);
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

size_t reduce_bytes(const Geom& g, int C) {
  const size_t f32 = 2 * (size_t)g.R * C * sizeof(float);
  const size_t f64 = 2 * (size_t)sum_lanes(g.threads, C) * C * sizeof(double);
  return f32 > f64 ? f32 : f64;
}

// Fills the offsets of g for `cap` rows of `row_bytes` on chip; returns the
// block's bytes.
size_t layout(Geom* g, int C, int cap, size_t row_bytes) {
  g->cap = cap;
  g->scratch_off = (int)(((size_t)cap * row_bytes + 15) / 16 * 16);
  g->coef_off = g->scratch_off + (int)reduce_bytes(*g, C);
  return (size_t)g->coef_off + 2 * (size_t)C * sizeof(float);
}

size_t smem_bytes(const Geom& g, int C) { return (size_t)g.coef_off + 2 * (size_t)C * sizeof(float); }

// A plan of K1 (kept = 1: x on chip) or K2 (kept = 2: x and g): 16-byte
// loads where C and the alignment allow, a block per kBnThreads threads'
// worth of whole rows, kBnBlocksPerSm blocks an SM (no more than the card
// holds at once: a cooperative launch), no more blocks than rows or row
// sweeps, and as many of each block's rows on chip as kBnStageBudget holds.
template <typename T, int V, typename Kernel>
cudaError_t plan_t(Kernel kernel, int kept, long long n, int C, Geom* g) {
  g->V = V;
  g->vpr = C / V;
  g->R = g->vpr <= kBnThreads ? kBnThreads / g->vpr : 1;
  g->threads = g->vpr <= kBnThreads ? g->R * g->vpr : kBnThreads;
  g->cols = (g->vpr + g->threads - 1) / g->threads;
  const size_t row_bytes = kept * (size_t)C * sizeof(T);
  const long long budget = kBnStageBudget / row_bytes > 0 ? kBnStageBudget / row_bytes : 1;
  const size_t smax = layout(g, C, (int)budget, row_bytes);
  cudaError_t e = raise_smem_limit(kernel, smax);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, g->threads, smax);
  if (e != cudaSuccess) return e;
  long long b = (long long)(occ < kBnBlocksPerSm ? occ : kBnBlocksPerSm) * sms;
  const long long sweeps = (n + g->R - 1) / g->R;
  if (b > sweeps) b = sweeps;
  if (b > n) b = n;
  if (b < 1) return cudaErrorInvalidValue;
  g->blocks = (int)b;
  const long long per = (n + b - 1) / b;
  layout(g, C, (int)(per < budget ? per : budget), row_bytes);
  return cudaSuccess;
}

// Whether a plan's threads own more columns than the narrow kernels hold.
__host__ __device__ constexpr bool wide_plan(const Geom& g) { return g.cols > max_cols(g.V, false); }

template <typename T, int V>
cudaError_t plan_v(int backward, long long n, int C, Geom* g) {
  const int vpr = C / V;
  const bool wide = vpr > kBnThreads * max_cols(V, false);
  if (wide)
    return backward ? plan_t<T, V>(bn_bwd_onepass<T, V, true>, 2, n, C, g)
                    : plan_t<T, V>(bn_fwd_onepass<T, V, true>, 1, n, C, g);
  return backward ? plan_t<T, V>(bn_bwd_onepass<T, V, false>, 2, n, C, g)
                  : plan_t<T, V>(bn_fwd_onepass<T, V, false>, 1, n, C, g);
}

cudaError_t plan(int backward, long long n, int C, int dtype, int aligned, Geom* g) {
  if (dtype == 1)
    return aligned && C % 8 == 0 ? plan_v<__nv_bfloat16, 8>(backward, n, C, g)
                                 : plan_v<__nv_bfloat16, 1>(backward, n, C, g);
  return aligned && C % 4 == 0 ? plan_v<float, 4>(backward, n, C, g)
                               : plan_v<float, 1>(backward, n, C, g);
}

cudaError_t launch(const void* kernel, const Geom& g, int C, void** args, cudaStream_t stream) {
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(g.blocks), dim3(g.threads), args,
                                              smem_bytes(g, C), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int V>
int fwd_launch(const void* x, const float* gamma, const float* beta, void* y, float* mean,
               float* rstd, float* var, float* partial, unsigned int* bar, long long n, int C,
               float eps, int relu, const Geom& g, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  Geom gg = g;
  void* args[] = {(void*)&xt,   (void*)&gamma,   (void*)&beta, (void*)&yt,  (void*)&mean,
                  (void*)&rstd, (void*)&var,     (void*)&partial, (void*)&bar, (void*)&n,
                  (void*)&C,    (void*)&eps,     (void*)&relu, (void*)&gg};
  const void* kernel = wide_plan(g) ? (const void*)bn_fwd_onepass<T, V, true>
                                     : (const void*)bn_fwd_onepass<T, V, false>;
  return (int)launch(kernel, g, C, args, stream);
}

template <typename T, int V>
int bwd_launch(const void* x, const void* y, const void* dy, const float* gamma,
               const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
               float* partial, unsigned int* bar, long long n, int C, int relu,
               const Geom& g, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  Geom gg = g;
  void* args[] = {(void*)&xt,     (void*)&yt,     (void*)&dyt,   (void*)&gamma, (void*)&mean,
                  (void*)&rstd,   (void*)&dxt,    (void*)&dgamma, (void*)&dbeta, (void*)&partial,
                  (void*)&bar,    (void*)&n,      (void*)&C,     (void*)&relu,  (void*)&gg};
  const void* kernel = wide_plan(g) ? (const void*)bn_bwd_onepass<T, V, true>
                                     : (const void*)bn_bwd_onepass<T, V, false>;
  return (int)launch(kernel, g, C, args, stream);
}

}  // namespace

extern "C" {

// The plan of K1 (backward = 0) or K2 (backward = 1) for n rows of C
// channels of a dtype (0 = float32, 1 = bfloat16) on the current device,
// into plan[fedml_bn_plan_ints()] (the Geom fields in order; plan[6] is the
// block count, the rows of the [blocks, 2, C] f32 scratch). aligned != 0
// when every [n, C] tensor of the call is 16-byte aligned. Returns a CUDA
// error code.
int fedml_bn_plan_ints() { return kPlanInts; }

// The widest row (channels) the kernels take.
int fedml_bn_max_channels() { return kBnMaxC; }

int fedml_bn_plan(int backward, long long n, int C, int dtype, int aligned, int* plan_out) {
  if (n < 1 || C < 1 || C > kBnMaxC) return (int)cudaErrorInvalidValue;
  Geom g;
  cudaError_t e = plan(backward, n, C, dtype, aligned, &g);
  if (e == cudaSuccess) *reinterpret_cast<Geom*>(plan_out) = g;
  return (int)e;
}

// K1, one cooperative launch. x and y share one dtype (0 = float32, 1 =
// bfloat16); gamma, beta, mean, rstd and var are float32 [C]; partial the
// [blocks, 2, C] f32 scratch; barrier two zeroed words that no other
// launch uses at the same time (zero again after the call); plan from
// fedml_bn_plan(0, ...) for this n, C, dtype and alignment.
int fedml_bn_fwd(const void* x, const float* gamma, const float* beta, void* y, float* mean,
                 float* rstd, float* var, float* partial, unsigned int* barrier, long long n,
                 int C, float eps, int relu, int dtype, const int* plan, void* stream) {
  if (n < 1 || C < 1 || C > kBnMaxC) return (int)cudaErrorInvalidValue;
  const Geom& g = *reinterpret_cast<const Geom*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (g.V == 8)
      return fwd_launch<__nv_bfloat16, 8>(x, gamma, beta, y, mean, rstd, var, partial, barrier,
                                          n, C, eps, relu, g, s);
    return fwd_launch<__nv_bfloat16, 1>(x, gamma, beta, y, mean, rstd, var, partial, barrier, n,
                                        C, eps, relu, g, s);
  }
  if (g.V == 4)
    return fwd_launch<float, 4>(x, gamma, beta, y, mean, rstd, var, partial, barrier, n, C, eps,
                                relu, g, s);
  return fwd_launch<float, 1>(x, gamma, beta, y, mean, rstd, var, partial, barrier, n, C, eps,
                              relu, g, s);
}

// K2, one cooperative launch. x, y, dy and dx share one dtype (0 = float32,
// 1 = bfloat16); y is read only when relu != 0. dgamma and dbeta are
// float32 [C]; partial and barrier as for K1; plan from fedml_bn_plan(1,
// ...) for this n, C, dtype and alignment.
int fedml_bn_bwd(const void* x, const void* y, const void* dy, const float* gamma,
                 const float* mean, const float* rstd, void* dx, float* dgamma, float* dbeta,
                 float* partial, unsigned int* barrier, long long n, int C, int relu, int dtype,
                 const int* plan, void* stream) {
  if (n < 1 || C < 1 || C > kBnMaxC) return (int)cudaErrorInvalidValue;
  const Geom& g = *reinterpret_cast<const Geom*>(plan);
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
