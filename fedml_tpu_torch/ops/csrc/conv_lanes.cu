// Spatial-in-lanes 3x3 convolution for Hopper: K3 (forward, also the dgrad),
// K4 (weight gradient) and K7 (K3's probe variants).
//
// Replaces the Pallas TPU kernels
//   K3 _fwd_kernel     fedml_tpu/ops/conv_lanes.py  (launched by _conv_fwd, also the
//                      dgrad in _vjp_bwd)
//   K4 _wgrad_kernel   fedml_tpu/ops/conv_lanes.py  (launched by _conv_wgrad)
//   K7 _variant_kernel tools/lanes_probe.py         (launched by _conv_variant)
//
// Layout: activations are [N, C, H*W] ("lanes layout"); the weight is the
// tap-major matrix W2[Co, 9*Ci], column tap*Ci + c with tap = (dy+1)*3 + (dx+1):
//   Y[n, o, y, x] = sum_{tap, c} W2[o, tap*Ci + c] * X[n, c, y+dy, x+dx],
// X = 0 outside the image (SAME padding, stride 1). K4 computes
//   dW2[o, tap*Ci + c] = sum_{n, y, x} dY[n, o, y, x] * X[n, c, y+dy, x+dx].
//
// What bounds it on this card: at ResNet-56's shapes (C = 16/32, batch 64)
// one call moves 2-6 MB and does 0.3-0.6 GFLOP, so the least time is the
// bytes (0.6-1.9 us at 3.35 TB/s); the same FLOPs are ~0.3-0.6 us of the
// tensor cores. What a call costs beyond that is latency: staging, the
// launch and, for K4, the cross-block sum.
//
// K3, two kernels behind one entry point (fedml_conv_fwd mode 0); the dtype
// picks one. Neither writes a padded copy to device memory: the TPU kernel
// pads rows (_pad_rows) so that every tap is a static slice; here a block
// stages its image rows, a one-row halo above and below and a one-column
// zero border, into shared memory, so that the 9 taps are plain offsets
// into that tile with no edge masks.
// - bf16 inputs (every path): conv_fwd_mma, on the tensor cores. The TPU
//   kernel is jnp.dot(bf16 W2, bf16 P, preferred_element_type=f32) cast to
//   bf16: exact products, f32 sums, which is mma.sync m16n8k16 bf16 -> f32
//   up to the order of the sums (fixed within a call, so two calls give the
//   same bits). An implicit GEMM: M = pixels, N = Co, a depth of one tap's
//   16 channels. A block (8 warps) covers one image and ~256 pixels of
//   whole rows (~128 when 256 would leave SMs idle, as at 16x16 and batch
//   64) and stages them once as bf16 transposed to [pixel][channel]
//   (Ci padded to 16 with zeros) at a pixel pitch of an odd number of 16
//   bytes, so ldmatrix reads 16 pixels x 16 channels of a tap without bank
//   conflicts. For each 32 output channels it stages that part of W2
//   ([Co, 9*Ci] row-major is B in column-major order; ldmatrix again; the
//   first part with cp.async, in flight while the rows stage), each warp
//   computes pairs of 16-pixel tiles over 9 * CiP / 16 k-steps, and the
//   f32 sums go through a shared [Co][pixel] tile so that Y is written in
//   16-byte stores along pixels. The input is staged once per block for all
//   of Co. What bounds it: the mma work is ~0.3-0.6 us of the card and the
//   bytes 0.6-1.9 us; the rest is latency — the launch, the staging round
//   trips, each warp's chain of 9-18 dependent k-steps of ldmatrix and mma,
//   the copy-out. (On an H100 at the path's shapes, loading the next
//   k-step's fragments ahead of this step's mma timed no faster.)
// - f32 inputs: conv_fwd_kernel<float, kConv>, on the CUDA cores (f32 on the
//   tensor cores would be TF32 and break the f32 parity). A block covers one
//   image, TR whole image rows (TR*W ~ 256 pixels) and 16 output channels
//   (a Co tile per blockIdx.y); it stages rows as f32 and the W2 tile as
//   [9*Ci][16] f32, so each (tap, c) costs one tile load and four float4
//   weight loads (broadcast across the warp) for 16 FMAs; bound by FMAs and
//   shared-memory issue. bf16 shapes whose tensor-core stage does not fit
//   take it too.
// - Shared memory: the host raises a kernel's dynamic shared-memory limit
//   on the current device (smem_limit.cuh, up to the card's 227 KB) where
//   the stage needs more than 48 KB; rows per block shrink until the stage
//   fits, and a shape that does not fit even at one row is refused with
//   cudaErrorInvalidValue.
// - K7 (MODE), the probe that splits K3's time: kConv is K3 itself, the
//   same entry point; kPatches writes the first Co rows of the patch matrix
//   (row r = tap r / Ci, channel r % Ci, zero outside the image) and kCopy
//   the first Co channels of the image, both from the stage of the kernel
//   K3 runs for that dtype and shape, with no dot. In bf16 that is
//   conv_fwd_mma<MODE>: the same geometry, the same rows staged to
//   [pixel][channel] and the same copy-out through the shared [Co
//   chunk][pixel] tile, only without W2 and the mma loop (kPatches gathers
//   its rows from the stage into the tile, kCopy takes the centre tap). So
//   kernel - copy is the mma loop with its W2 staging (K3's ldmatrix reads
//   take the taps as offsets, so it has no gather of its own), and patches
//   - copy the tap gather. Where K3 takes the CUDA-core kernel (f32, or a
//   bf16 stage that does not fit), the probe modes take
//   conv_fwd_kernel<T, MODE> too.
//
// K4, two kernels behind one entry point; the dtype picks one. The TPU
// kernel sums dW2 in one f32 accumulator across a sequential grid; CUDA
// blocks run in no order, so both sum fixed ranges of (image, row tile)
// items into per-block f32 partials and add those in a fixed order: no
// float atomics, the same result on every run.
// - bf16 inputs: conv_wgrad_mma, on the tensor cores. The TPU kernel keeps
//   the patch matrix and dY in bf16 and sums dY.P^T with f32 accumulation,
//   which is exactly mma.sync m16n8k16 bf16 -> f32: dW2[Co, 9*Ci] =
//   dY[Co, positions] . P[9*Ci, positions]^T, M = Co, N = the patch rows,
//   the depth the pixels. An item is 4 image rows of one image, so every
//   path shape gives 256-512 items and 2 blocks on each SM (at most what
//   the card holds at once). A block stages an item as bf16 (16-byte
//   copies where W % 8 == 0): x rows with a one-row halo at a row pitch of
//   W + 8 (W + 1 for other W) whose extra columns are zero (the left and
//   right borders), and
//   dY at the same pitch with zeros in those columns, so that a tap is a
//   plain offset into the staged x and the border positions add nothing.
//   Each warp owns up to 9 m16n8 output tiles; A fragments are 32-bit
//   shared loads of dY, B fragments pairs of 16-bit loads of the staged x
//   (a tap's offset may be odd), row pitches 8 mod 64 elements so that
//   neither conflicts. After its items a block writes its partial, the
//   grid meets at a barrier (a cooperative launch, so every block is
//   resident; two counter words per stream, zero between calls), and
//   every block then adds the partials of some 32-entry groups of dW2 in
//   block order in f64 (the barrier is grid_barrier.cuh's), 16 loads in flight per thread. One launch a call.
//   The mma work is ~1 us of the card; the time is latency: staging
//   (~1-2 us a round trip), the barrier (~2 us) and the partials, 2.4-9.4
//   MB written and read back through L2. (The last block adding every
//   partial alone, as a counter would have it, reads those megabytes
//   through one SM: tens of microseconds.)
// - f32 inputs: conv_wgrad_partials and conv_wgrad_finalize, on the CUDA
//   cores. f32 operands on the tensor cores would be TF32 (10-bit
//   mantissa) and break the f32 parity, so the port's first K4 stays for
//   them: each thread owns 4x4 (o, k) micro-tiles of a block's [Co tile,
//   9*Ci] partial and loops over the staged pixels; a second launch adds
//   the partials in a fixed order in f64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_barrier.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = 256;
constexpr int kCoTile = 16;         // K3: output channels per block
constexpr int kWgCoTile = 32;       // K4: output channels per block
constexpr int kWgradBlocks = 264;   // K4: partials over all Co tiles (2 per SM)
constexpr int kFinLanes = 8;        // K4 finalize: threads per dW2 entry
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most one block may use

enum Mode { kConv = 0, kPatches = 1, kCopy = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stages rows r0-1 .. r0+TR of one image's Ci channels into tile
// [Ci][TR+2][W+2] as f32: staged (r, cc) holds X[c, r0-1+r, cc-1], zero
// outside the image.
template <typename T>
__device__ void stage_rows(const T* __restrict__ xn, float* __restrict__ tile, int Ci, int H,
                           int W, int r0, int TR) {
  const int Wp = W + 2, S = (TR + 2) * Wp;
  const int total = Ci * S;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i / S, rem = i - c * S;
    const int gy = r0 - 1 + rem / Wp, gx = rem % Wp - 1;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f(xn[((long long)c * H + gy) * W + gx]);
    tile[i] = v;
  }
}

// K3 on the CUDA cores (MODE kConv: f32 inputs, and bf16 shapes too large
// for conv_fwd_mma's stage) and K7 (kPatches, kCopy). Grid: (row tiles, Co
// tiles, N).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w2, T* __restrict__ y, int Ci,
                int Co, int H, int W, int TR) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.z, co0 = blockIdx.y * kCoTile, r0 = blockIdx.x * TR;
  const int Wp = W + 2, S = (TR + 2) * Wp, P = TR * W;
  const long long HW = (long long)H * W;
  const T* xn = x + (long long)n * Ci * HW;
  T* yn = y + (long long)n * Co * HW;

  if constexpr (MODE == kCopy) {
    for (int p = threadIdx.x; p < P && r0 + p / W < H; p += blockDim.x) {
      const long long pix = (long long)r0 * W + p;
      for (int o = co0; o < co0 + kCoTile && o < Co; ++o) yn[o * HW + pix] = xn[o * HW + pix];
    }
    return;
  }

  float* wt = reinterpret_cast<float*>(smem4);       // [9*Ci][kCoTile], kConv only
  float* tile = wt + (MODE == kConv ? 9 * Ci * kCoTile : 0);   // [Ci][TR+2][W+2]
  if constexpr (MODE == kConv) {
    const int K = 9 * Ci;
    for (int i = threadIdx.x; i < K * kCoTile; i += blockDim.x) {
      const int k = i / kCoTile, o = co0 + i % kCoTile;
      wt[i] = o < Co ? to_f(w2[(long long)o * K + k]) : 0.f;
    }
  }
  stage_rows(xn, tile, Ci, H, W, r0, TR);
  __syncthreads();

  for (int p = threadIdx.x; p < P && r0 + p / W < H; p += blockDim.x) {
    const int ry = p / W, xx = p - ry * W;
    const long long pix = (long long)r0 * W + p;
    const float* tp = tile + ry * Wp + xx;  // staged (ry, xx) is tap (dy, dx) = (-1, -1)
    if constexpr (MODE == kPatches) {
      for (int o = co0; o < co0 + kCoTile && o < Co; ++o) {
        const int tap = o / Ci, c = o - tap * Ci;
        yn[o * HW + pix] = from_f<T>(tp[c * S + (tap / 3) * Wp + tap % 3]);
      }
    } else {
      float acc[kCoTile];
#pragma unroll
      for (int j = 0; j < kCoTile; ++j) acc[j] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const float* tt = tp + (tap / 3) * Wp + tap % 3;
        const float4* wk = reinterpret_cast<const float4*>(wt) + tap * Ci * (kCoTile / 4);
        for (int c = 0; c < Ci; ++c) {
          const float v = tt[c * S];
#pragma unroll
          for (int q = 0; q < kCoTile / 4; ++q) {
            const float4 w4 = wk[c * (kCoTile / 4) + q];
            acc[4 * q + 0] = fmaf(w4.x, v, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(w4.y, v, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(w4.z, v, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(w4.w, v, acc[4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCoTile; ++j)
        if (co0 + j < Co) yn[(co0 + j) * HW + pix] = from_f<T>(acc[j]);
    }
  }
}

// K4, first launch: block (b, t) sums items [b*items/B, (b+1)*items/B) of
// the (image, row tile) list for output channels t*kWgCoTile .. into
// partial[b][Co][9*Ci]. Grid: (B, Co tiles).
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_partials(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial,
                    int N, int Ci, int Co, int H, int W, int TR) {
  extern __shared__ float4 smem4[];
  const int K = 9 * Ci, P = TR * W, Wp = W + 2, S = (TR + 2) * Wp;
  const int co0 = blockIdx.y * kWgCoTile;
  const int cot = min(kWgCoTile, Co - co0);
  float* acc = reinterpret_cast<float*>(smem4);     // [cot][K]
  float* dys = acc + kWgCoTile * K;                 // [cot][P + 1]
  float* tile = dys + kWgCoTile * (P + 1);          // [Ci][TR+2][W+2]
  const long long HW = (long long)H * W;
  const int row_tiles = (H + TR - 1) / TR;
  const long long items = (long long)N * row_tiles;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  const int mo = (cot + 3) / 4, n_mt = mo * ((K + 3) / 4);

  for (int i = threadIdx.x; i < cot * K; i += blockDim.x) acc[i] = 0.f;
  for (long long it = i0; it < i1; ++it) {
    const int n = (int)(it / row_tiles), r0 = (int)(it % row_tiles) * TR;
    const int rows = min(TR, H - r0);
    __syncthreads();  // the previous item's readers are done with the tiles
    stage_rows(x + (long long)n * Ci * HW, tile, Ci, H, W, r0, TR);
    const T* dyn = dy + ((long long)n * Co + co0) * HW + (long long)r0 * W;
    for (int i = threadIdx.x; i < cot * P; i += blockDim.x) {
      const int o = i / P, p = i - o * P;
      dys[o * (P + 1) + p] = p < rows * W ? to_f(dyn[o * HW + p]) : 0.f;
    }
    __syncthreads();
    for (int mt = threadIdx.x; mt < n_mt; mt += blockDim.x) {
      const int ob = (mt % mo) * 4, kb = (mt / mo) * 4;
      const float* dp[4];
      int off[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dp[j] = dys + min(ob + j, cot - 1) * (P + 1);
        const int k = min(kb + j, K - 1), tap = k / Ci, c = k - tap * Ci;
        off[j] = c * S + (tap / 3) * Wp + tap % 3;
      }
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
      for (int ry = 0; ry < rows; ++ry) {
        for (int xx = 0; xx < W; ++xx) {
          const int p = ry * W + xx, base = ry * Wp + xx;
          float d[4], v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            d[j] = dp[j][p];
            v[j] = tile[off[j] + base];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = fmaf(d[a], v[b], s[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (ob + a < cot && kb + b < K) acc[(ob + a) * K + kb + b] += s[a][b];
    }
  }
  __syncthreads();
  float* out = partial + ((long long)blockIdx.x * Co + co0) * K;
  for (int i = threadIdx.x; i < cot * K; i += blockDim.x) out[i] = acc[i];
}

// K4, second launch: dW2[i] = the sum of the B partials. Each entry is
// summed by kFinLanes threads (lane j takes partials j, j + kFinLanes, ...
// in order, in f64), combined by a fixed-order tree: the same order on
// every run. A block covers 32 consecutive entries, so loads coalesce.
__global__ void __launch_bounds__(32 * kFinLanes)
conv_wgrad_finalize(const float* __restrict__ partial, float* __restrict__ dw2, int blocks,
                    long long M) {
  __shared__ double sh[kFinLanes][32];
  const int lane = threadIdx.x % 32, j = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * 32 + lane;
  double s = 0.0;
  if (i < M) {
#pragma unroll 4
    for (int b = j; b < blocks; b += kFinLanes) s += partial[(long long)b * M + i];
  }
  sh[j][lane] = s;
  __syncthreads();
  for (int half = kFinLanes / 2; half > 0; half /= 2) {
    if (j < half) sh[j][lane] += sh[j + half][lane];
    __syncthreads();
  }
  if (j == 0 && i < M) dw2[i] = (float)sh[0][lane];
}

int initial_rows(int H, int W) {
  int tr = kPixelsPerBlock / W;
  if (tr < 1) tr = 1;
  return tr < H ? tr : H;
}

size_t fwd_smem(int Ci, int W, int TR, int mode) {
  if (mode == kCopy) return 0;
  const size_t tile = (size_t)Ci * (TR + 2) * (W + 2);
  const size_t wt = mode == kConv ? (size_t)9 * Ci * kCoTile : 0;
  return 4 * (tile + wt);
}

size_t wgrad_smem(int Ci, int W, int TR) {
  return 4 * ((size_t)kWgCoTile * 9 * Ci + (size_t)kWgCoTile * (TR * W + 1) +
              (size_t)Ci * (TR + 2) * (W + 2));
}

// Rows per tile: ~kPixelsPerBlock pixels, fewer until the stage fits in
// kMaxSmem; 0 when even one row does not fit.
template <typename F>
int fit_rows(int H, int W, F smem_of) {
  int tr = initial_rows(H, W);
  while (tr > 1 && smem_of(tr) > kMaxSmem) tr = (tr + 1) / 2;
  return smem_of(tr) <= kMaxSmem ? tr : 0;
}

template <typename T, int MODE>
int fwd_launch(const void* x, const void* w2, void* y, int N, int Ci, int Co, int H, int W,
               cudaStream_t stream) {
  const int TR = fit_rows(H, W, [&](int tr) { return fwd_smem(Ci, W, tr, MODE); });
  if (TR == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(Ci, W, TR, MODE);
  auto kernel = conv_fwd_kernel<T, MODE>;
  cudaError_t e = raise_smem_limit(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((H + TR - 1) / TR, (Co + kCoTile - 1) / kCoTile, N);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w2),
                                           static_cast<T*>(y), Ci, Co, H, W, TR);
  return (int)cudaGetLastError();
}

int wgrad_rows(int Ci, int H, int W) {
  return fit_rows(H, W, [&](int tr) { return wgrad_smem(Ci, W, tr); });
}

int wgrad_blocks(int N, int Ci, int Co, int H, int W) {
  const int TR = wgrad_rows(Ci, H, W);
  if (TR == 0) return 0;
  const long long items = (long long)N * ((H + TR - 1) / TR);
  const int co_tiles = (Co + kWgCoTile - 1) / kWgCoTile;
  long long b = kWgradBlocks / co_tiles;
  if (b < 1) b = 1;
  return (int)(items < b ? items : b);
}

template <typename T>
int wgrad_launch(const void* x, const void* dy, float* partial, float* dw2, int N, int Ci, int Co,
                 int H, int W, cudaStream_t stream) {
  const int TR = wgrad_rows(Ci, H, W);
  if (TR == 0) return (int)cudaErrorInvalidValue;
  const int B = wgrad_blocks(N, Ci, Co, H, W);
  const size_t smem = wgrad_smem(Ci, W, TR);
  auto kernel = conv_wgrad_partials<T>;
  cudaError_t e = raise_smem_limit(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, (Co + kWgCoTile - 1) / kWgCoTile);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                           partial, N, Ci, Co, H, W, TR);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long M = (long long)Co * 9 * Ci;
  conv_wgrad_finalize<<<(unsigned)((M + 31) / 32), 32 * kFinLanes, 0, stream>>>(partial, dw2,
                                                                                 B, M);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4, bf16 inputs: tensor cores, one cooperative launch
// ---------------------------------------------------------------------------

constexpr int kWgWarps = kThreads / 32;  // 8
constexpr int kTilesPerWarp = 9;         // m16n8 output tiles one warp accumulates
constexpr int kWgMaxRows = 4;            // image rows per item
constexpr int kXPad = 8;                 // zeros ahead of a channel's staged rows
constexpr int kWgBlocksPerSm = 2;
constexpr int kWgLoads = 16;             // partials one thread has in flight in the sum

// Stage geometry of the bf16 K4, the same on host and device.
struct WgGeom {
  int TR;      // image rows per item
  int Wp;      // staged row pitch: W + 8 (W % 8 == 0) or W + 1; columns >= W are zero
  int KP;      // padded positions per item (TR * Wp rounded up to 16): the mma depth
  int CS;      // staged x elements per channel
  int DP;      // staged dY elements per output channel
  int MT;      // m16 tiles over Co
  int ntiles;  // m16n8 output tiles over [Co, 9*Ci]
  int vec;     // 16-byte copies (W % 8 == 0 and aligned inputs)
};

// n rounded up to a multiple of 8 that is 8 mod 64 elements: a row pitch of
// 4 mod 32 words, so that 8 rows x 4 words of a fragment hit 32 banks.
int bank_pitch(int n) {
  const int p = (n + 7) / 8 * 8;
  return p + (72 - p % 64) % 64;
}

size_t wg_mma_smem(int Ci, const WgGeom& g) {
  const size_t stage = 2 * ((size_t)Ci * g.CS + (size_t)g.MT * 16 * g.DP);
  return stage > 2048 ? stage : 2048;  // the reduction reuses 8 x 32 doubles
}

// False when even one image row does not fit in shared memory.
bool wg_geometry(int Ci, int Co, int H, int W, bool aligned, WgGeom* g) {
  g->vec = W % 8 == 0 && aligned;
  g->Wp = W % 8 == 0 ? W + 8 : W + 1;
  g->MT = (Co + 15) / 16;
  g->ntiles = g->MT * ((9 * Ci + 7) / 8);
  int tr = 128 / W;
  tr = tr < 1 ? 1 : (tr > kWgMaxRows ? kWgMaxRows : tr);
  tr = tr < H ? tr : H;
  for (;; tr = (tr + 1) / 2) {
    g->TR = tr;
    g->KP = (tr * g->Wp + 15) / 16 * 16;
    g->CS = bank_pitch(kXPad + g->KP + 2 * g->Wp + 2);
    g->DP = bank_pitch(g->KP);
    if (wg_mma_smem(Ci, *g) <= kMaxSmem) return true;
    if (tr == 1) return false;
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages one item (image n, rows r0 .. r0+TR-1) in units of U (8 bf16 as a
// uint4, or one): x rows r0-1 .. r0+TR to xt[c][kXPad + R*Wp + X] and dY
// rows r0 .. r0+TR-1 to ds[o][r*Wp + X]; rows outside the image are zeros.
// Four loads are in flight per thread before their stores.
template <typename U>
__device__ void stage_wgrad_item(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ dy, __nv_bfloat16* xt,
                                 __nv_bfloat16* ds, int n, int r0, int Ci, int Co, int H, int W,
                                 const WgGeom& g) {
  constexpr int V = sizeof(U) / 2;
  const int WV = W / V, xr = (g.TR + 2) * WV, dr = g.TR * WV;
  const int nx = Ci * xr, total = nx + Co * dr;
  const long long HW = (long long)H * W;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
    U val[4];
    __nv_bfloat16* dst[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      dst[u] = nullptr;
      val[u] = U{};
      if (i >= total) continue;
      if (i < nx) {
        const int c = i / xr, rem = i - c * xr, R = rem / WV, xv = rem - R * WV;
        const int gy = r0 - 1 + R;
        dst[u] = xt + c * g.CS + kXPad + R * g.Wp + xv * V;
        if (gy >= 0 && gy < H)
          val[u] = *reinterpret_cast<const U*>(x + ((long long)n * Ci + c) * HW +
                                               (long long)gy * W + xv * V);
      } else {
        const int j = i - nx, o = j / dr, rem = j - o * dr, r = rem / WV, xv = rem - r * WV;
        const int gy = r0 + r;
        dst[u] = ds + o * g.DP + r * g.Wp + xv * V;
        if (gy < H)
          val[u] = *reinterpret_cast<const U*>(dy + ((long long)n * Co + o) * HW +
                                               (long long)gy * W + xv * V);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (dst[u]) *reinterpret_cast<U*>(dst[u]) = val[u];
  }
}

// K4 for bf16 x and dY: dW2[Co, 9*Ci] = dY[Co, pixels] . P[9*Ci, pixels]^T.
// Grid (B, chunks), cooperative. Block (b, k) sums items [b*items/B,
// (b+1)*items/B) of the (image, row tile) list on the tensor cores for the
// output tiles of chunk k and writes them to partial[b]; after a grid
// barrier every block adds the B partials of some 32-entry groups of dW2 in
// block order (f64), so the result is the same on every run.
__global__ void __launch_bounds__(kThreads, kWgBlocksPerSm)
conv_wgrad_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
               float* __restrict__ partial, float* __restrict__ dw2, unsigned int* bar, int N,
               int Ci, int Co, int H, int W, WgGeom g) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem4);  // [Ci][CS]
  __nv_bfloat16* ds = xt + Ci * g.CS;                            // [MT*16][DP]
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, t = lane & 3;
  const int K = 9 * Ci;
  const long long M = (long long)Co * K;
  const int row_tiles = (H + g.TR - 1) / g.TR;
  const long long items = (long long)N * row_tiles;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;

  // zero the stage once: pads, columns past W and rows past Co stay zero
  {
    uint4* s4 = reinterpret_cast<uint4*>(smem4);
    const int n16 = (Ci * g.CS + g.MT * 16 * g.DP) / 8;
    for (int i = threadIdx.x; i < n16; i += blockDim.x) s4[i] = make_uint4(0, 0, 0, 0);
  }

  // this thread's output tiles: A rows of dY, and the staged offset of its
  // B column (patch row nt*8 + gq: tap (dy, dx), channel c) at position 0
  float acc[kTilesPerWarp][4];
  int arow[kTilesPerWarp], boff[kTilesPerWarp];
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int ti = (blockIdx.y * kTilesPerWarp + j) * kWgWarps + warp;
    const int mt = ti % g.MT, nrow = (ti / g.MT) * 8 + gq;
    const int tap = nrow / Ci, c = nrow - tap * Ci;
    arow[j] = (mt * 16 + gq) * g.DP + 2 * t;
    boff[j] = nrow < K ? c * g.CS + kXPad + (tap / 3) * g.Wp + tap % 3 - 1 + 2 * t : -1;
  }

  for (long long it = i0; it < i1; ++it) {
    const int n = (int)(it / row_tiles), r0 = (int)(it % row_tiles) * g.TR;
    __syncthreads();  // the previous item's readers are done with the stage
    if (g.vec)
      stage_wgrad_item<uint4>(x, dy, xt, ds, n, r0, Ci, Co, H, W, g);
    else
      stage_wgrad_item<unsigned short>(x, dy, xt, ds, n, r0, Ci, Co, H, W, g);
    __syncthreads();
    for (int q0 = 0; q0 < g.KP; q0 += 16) {
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        if ((blockIdx.y * kTilesPerWarp + j) * kWgWarps + warp >= g.ntiles) break;  // warp-uniform
        const uint32_t* ar = reinterpret_cast<const uint32_t*>(ds + arow[j] + q0);
        const int dp2 = 4 * g.DP;  // 8 rows, in 32-bit words
        const uint32_t a[4] = {ar[0], ar[dp2], ar[4], ar[dp2 + 4]};
        uint32_t b0 = 0, b1 = 0;
        if (boff[j] >= 0) {
          const unsigned short* bp = xs + boff[j] + q0;
          b0 = bp[0] | (uint32_t)bp[1] << 16;
          b1 = bp[8] | (uint32_t)bp[9] << 16;
        }
        mma_bf16(acc[j], a, b0, b1);
      }
    }
  }

  // this block's partial of its tiles: C rows gq, gq+8 (o), columns 2t, 2t+1
  float* pb = partial + (long long)blockIdx.x * M;
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    const int ti = (blockIdx.y * kTilesPerWarp + j) * kWgWarps + warp;
    if (ti >= g.ntiles) break;
    const int o = (ti % g.MT) * 16 + gq, col = (ti / g.MT) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oo = o + h * 8;
      if (oo >= Co) continue;
      float* dst = pb + (long long)oo * K + col;
      if (K % 2 == 0 && col + 1 < K)  // K even: every pair is 8-byte aligned
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      else
        for (int e = 0; e < 2 && col + e < K; ++e) dst[e] = acc[j][2 * h + e];
    }
  }

  grid_barrier(bar);

  // dW2 entry e = the sum over b of partial[b][e]: warp w adds partials w,
  // w + 8, ... in order, then a fixed tree over the 8 warps
  double* red = reinterpret_cast<double*>(smem4);  // [kWgWarps][32]
  const int blocks = gridDim.x * gridDim.y, me = blockIdx.y * gridDim.x + blockIdx.x;
  const long long groups = (M + 31) / 32;
  for (long long grp = me; grp < groups; grp += blocks) {
    const long long e = grp * 32 + lane;
    double s = 0.0;
    if (e < M) {
      // kWgLoads loads in flight, then added in order
      for (int b0 = warp; b0 < (int)gridDim.x; b0 += kWgWarps * kWgLoads) {
        float v[kWgLoads];
#pragma unroll
        for (int u = 0; u < kWgLoads; ++u) {
          const int b = b0 + u * kWgWarps;
          v[u] = b < (int)gridDim.x ? __ldcg(partial + (long long)b * M + e) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kWgLoads; ++u) s += v[u];
      }
    }
    red[warp * 32 + lane] = s;
    __syncthreads();
    for (int half = kWgWarps / 2; half > 0; half /= 2) {
      if (warp < half) red[warp * 32 + lane] += red[(warp + half) * 32 + lane];
      __syncthreads();
    }
    if (warp == 0 && e < M) dw2[e] = (float)red[lane];
    __syncthreads();
  }
}

int wg_chunks(const WgGeom& g) {
  const int per = kWgWarps * kTilesPerWarp;
  return (g.ntiles + per - 1) / per;
}

// Geometry and partial count of the bf16 K4: 2 blocks per SM over the
// chunks, no more than the card holds at once (a cooperative launch) and
// no more than there are items.
cudaError_t wg_mma_plan(int N, int Ci, int Co, int H, int W, bool aligned, WgGeom* g, int* B) {
  if (!wg_geometry(Ci, Co, H, W, aligned, g)) return cudaErrorInvalidValue;
  const size_t smem = wg_mma_smem(Ci, *g);
  cudaError_t e = raise_smem_limit(conv_wgrad_mma, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, conv_wgrad_mma, kThreads, smem);
  if (e != cudaSuccess) return e;
  const int chunks = wg_chunks(*g);
  int b = (occ < kWgBlocksPerSm ? occ : kWgBlocksPerSm) * sms / chunks;
  const long long items = (long long)N * ((H + g->TR - 1) / g->TR);
  if (b > items) b = (int)items;
  if (b < 1) return cudaErrorInvalidValue;
  *B = b;
  return cudaSuccess;
}

int wgrad_mma_launch(const void* x, const void* dy, float* partial, float* dw2,
                     unsigned int* bar, int N, int Ci, int Co, int H, int W,
                     cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0;
  WgGeom g;
  int B = 0;
  cudaError_t e = wg_mma_plan(N, Ci, Co, H, W, aligned, &g, &B);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  void* args[] = {(void*)&xb, (void*)&dyb, (void*)&partial, (void*)&dw2, (void*)&bar,
                  (void*)&N, (void*)&Ci, (void*)&Co, (void*)&H, (void*)&W, (void*)&g};
  e = cudaLaunchCooperativeKernel((const void*)conv_wgrad_mma, dim3(B, wg_chunks(g)),
                                  dim3(kThreads), args, wg_mma_smem(Ci, g), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3, bf16 inputs: tensor cores
// ---------------------------------------------------------------------------

constexpr int kFwThreads = 256;                // 8 warps
constexpr int kFwWarps = kFwThreads / 32;
constexpr int kFwPixels = 256;                 // output pixels a block aims at (whole rows),
constexpr int kFwPixelsSmall = 128;            // or this many when the grid would not fill the SMs
constexpr int kFwCoChunk = 32;                 // output channels per pass: 4 n8 tiles
constexpr int kFwMi = 2;                       // m16 pixel tiles a warp computes at once
constexpr int kFwLoads = 8;                    // staging loads in flight per thread

// Stage geometry of the bf16 K3, the same on host and device.
struct FwGeom {
  int TR;     // image rows per block
  int Wp;     // staged row width: W + 2, the border columns zero
  int CiP;    // Ci rounded up to 16 (zero channels): the mma depth per tap
  int PP;     // staged pixel pitch, bf16: CiP + 8, an odd number of 16-byte units
  int KP;     // staged W2 row pitch, bf16: 9 * CiP + 8, likewise
  int YP;     // output tile row pitch, bf16: TR * W rounded up to whole tile pairs, + 8
  int xpair;  // x loaded two pixels (4 bytes) at a time: W even, x aligned
  int wvec;   // W2 loaded 8 channels (16 bytes) at a time: Ci % 8 == 0, w2 aligned
  int yvec;   // Y stored 8 pixels (16 bytes) at a time: W % 8 == 0, y aligned
};

size_t fw_smem(const FwGeom& g) {
  return 2 * ((size_t)(g.TR + 2) * g.Wp * g.PP + (size_t)kFwCoChunk * g.KP +
              (size_t)kFwCoChunk * g.YP);
}

// Rows per block for ~pixels output pixels; false when even one image row
// does not fit in shared memory.
bool fw_geometry(int Ci, int H, int W, int pixels, uintptr_t x, uintptr_t w2, uintptr_t y,
                 FwGeom* g) {
  g->Wp = W + 2;
  g->CiP = (Ci + 15) / 16 * 16;
  g->PP = g->CiP + 8;
  g->KP = 9 * g->CiP + 8;
  g->xpair = W % 2 == 0 && x % 4 == 0;
  g->wvec = Ci % 8 == 0 && w2 % 16 == 0;
  g->yvec = W % 8 == 0 && y % 16 == 0;
  int tr = pixels / W;
  tr = tr < 1 ? 1 : (tr > H ? H : tr);
  for (;; tr = (tr + 1) / 2) {
    g->TR = tr;
    g->YP = (tr * W + 16 * kFwMi - 1) / (16 * kFwMi) * (16 * kFwMi) + 8;
    if (fw_smem(*g) <= kMaxSmem) return true;
    if (tr == 1) return false;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A 16-byte global -> shared copy that bypasses the registers; src_bytes 0
// writes zeros. cp.async.wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Stages rows r0-1 .. r0+TR of image n transposed, as 32-bit words of two
// channels: word (R*Wp + X)*PP/2 + c/2 holds channels c, c+1 of X[gy =
// r0-1+R, gx = X-1], zero outside the image and for channels >= Ci.
// Consecutive threads read consecutive pixels of one channel pair
// (kFwLoads loads in flight per thread); the transposing stores may meet in
// a bank, which costs little beside the loads' latency.
__device__ void stage_fwd_rows(const __nv_bfloat16* __restrict__ x, uint32_t* st, int n, int r0,
                               int Ci, int H, int W, const FwGeom& g) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int PW = g.PP / 2, pairs = g.CiP / 2, rows = g.TR + 2;
  const long long HW = (long long)H * W;
  for (int i = threadIdx.x; i < rows * 2 * pairs; i += blockDim.x) {  // border columns
    const int cp = i % pairs, e = i / pairs, R = e / 2, X = (e % 2) * (W + 1);
    st[(R * g.Wp + X) * PW + cp] = 0u;
  }
  const int U = g.xpair ? 2 : 1, WU = W / U, total = pairs * rows * WU;
  for (int i0 = threadIdx.x; i0 < total; i0 += kFwLoads * blockDim.x) {
    uint32_t lo[kFwLoads], hi[kFwLoads];
    int dst[kFwLoads];
#pragma unroll
    for (int u = 0; u < kFwLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      lo[u] = hi[u] = 0u;
      dst[u] = -1;
      if (i >= total) continue;
      const int xu = i % WU, e = i / WU, R = e % rows, cp = e / rows;
      const int c = 2 * cp, gy = r0 - 1 + R;
      dst[u] = (R * g.Wp + 1 + xu * U) * PW + cp;
      if (gy < 0 || gy >= H) continue;
      const long long off = ((long long)n * Ci + c) * HW + (long long)gy * W + xu * U;
      if (U == 2) {
        if (c < Ci) lo[u] = *reinterpret_cast<const uint32_t*>(xs + off);
        if (c + 1 < Ci) hi[u] = *reinterpret_cast<const uint32_t*>(xs + off + HW);
      } else {
        if (c < Ci) lo[u] = xs[off];
        if (c + 1 < Ci) hi[u] = xs[off + HW];
      }
    }
#pragma unroll
    for (int u = 0; u < kFwLoads; ++u) {
      if (dst[u] < 0) continue;
      if (U == 2) {  // lo / hi hold two pixels of channel c / c+1
        st[dst[u]] = (lo[u] & 0xffffu) | (hi[u] << 16);
        st[dst[u] + PW] = (lo[u] >> 16) | (hi[u] & 0xffff0000u);
      } else {
        st[dst[u]] = lo[u] | (hi[u] << 16);
      }
    }
  }
}

// Stages rows co0 .. co0+31 of W2 as ws[o][tap*CiP + c], zero for o >= Co
// and c >= Ci. With wvec the copies are cp.async (16 bytes, zero-filled
// past the edges) that the caller waits for; else plain loads and stores.
__device__ void stage_fwd_weights(const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* ws,
                                  int co0, int Ci, int Co, const FwGeom& g) {
  const int K = 9 * Ci;
  if (g.wvec) {
    const int units = g.CiP / 8, total = kFwCoChunk * 9 * units;
    const uint32_t ws_s = smem_addr(ws);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int cu = i % units, e = i / units, tap = e % 9, o = e / 9;
      const bool live = co0 + o < Co && cu * 8 < Ci;
      const __nv_bfloat16* src = live ? w2 + (long long)(co0 + o) * K + tap * Ci + cu * 8 : w2;
      cp_async16(ws_s + 2u * (uint32_t)(o * g.KP + tap * g.CiP + cu * 8), src, live ? 16 : 0);
    }
  } else {
    const int total = kFwCoChunk * 9 * g.CiP;
#pragma unroll 4
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i % g.CiP, e = i / g.CiP, tap = e % 9, o = e / 9;
      ws[o * g.KP + tap * g.CiP + c] = co0 + o < Co && c < Ci
                                           ? w2[(long long)(co0 + o) * K + tap * Ci + c]
                                           : __float2bfloat16(0.f);
    }
  }
}

// K3 for bf16 x and W2: Y[n] = W2 . P[n] as an implicit GEMM on the tensor
// cores, mma.sync m16n8k16 bf16 -> f32 with M = pixels, N = Co and a depth
// of one tap's 16 channels. Grid (row tiles, N). A block stages its rows
// once (transposed to [pixel][channel], so an A fragment, 16 pixels x 16
// channels of one tap, is 16 rows that ldmatrix reads; a tap is a fixed
// offset into the stage), then for each chunk of 32 output channels stages
// that chunk of W2 (B, read by ldmatrix too), and each warp computes pairs
// of 16-pixel tiles over the 9 * CiP / 16 k-steps in a fixed order. The f32
// sums go to bf16 through a shared [Co chunk][pixel] tile, from which rows
// of Y are written contiguously. K7's kPatches / kCopy (MODE) stage the same
// rows and copy out the same way, but fill the tile from the stage: no W2,
// no mma.
template <int MODE>
__global__ void __launch_bounds__(kFwThreads)
conv_fwd_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w2,
             __nv_bfloat16* __restrict__ y, int Ci, int Co, int H, int W, FwGeom g) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem4);  // [(TR+2)*Wp][PP]
  __nv_bfloat16* ws = st + (size_t)(g.TR + 2) * g.Wp * g.PP;    // [32][KP]
  __nv_bfloat16* ys = ws + (size_t)kFwCoChunk * g.KP;            // [32][YP]
  const int n = blockIdx.y, r0 = blockIdx.x * g.TR;
  const int P = g.TR * W, PV = min(g.TR, H - r0) * W;
  const long long HW = (long long)H * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, t = lane & 3;
  const int pairs = ((P + 15) / 16 + kFwMi - 1) / kFwMi;

  if constexpr (MODE == kConv)
    stage_fwd_weights(w2, ws, 0, Ci, Co, g);  // cp.async: in flight while the rows stage
  stage_fwd_rows(x, reinterpret_cast<uint32_t*>(st), n, r0, Ci, H, W, g);

  // ldmatrix rows of this lane: A, pixel a_pix of the tile and channels
  // a_k..a_k+7; B, output channel (lane/16)*8 + lane%8 of the pair and k
  // offset 8 * ((lane/8) & 1)
  const int a_pix = lane % 8 + 8 * ((lane / 8) & 1), a_k = 8 * (lane / 16);
  const uint32_t b_lane =
      smem_addr(ws) + 2u * (uint32_t)(((lane / 16) * 8 + lane % 8) * g.KP + 8 * ((lane / 8) & 1));
  const int ksteps = g.CiP / 16;

  for (int co0 = 0; co0 < Co; co0 += kFwCoChunk) {
    const int oc = min(kFwCoChunk, Co - co0);
    if constexpr (MODE != kConv) {
      __syncthreads();  // the stage is complete; the previous chunk's copy-out read the tile
      // tile row o, pixel q: patch row co0 + o (tap r / Ci, channel r % Ci),
      // or for kCopy channel co0 + o at the centre tap
      for (int i = threadIdx.x; i < oc * P; i += blockDim.x) {
        const int o = i / P, q = i - o * P, ry = q / W, xx = q - ry * W;
        const int r = co0 + o, tap = MODE == kPatches ? r / Ci : 4;
        const int c = MODE == kPatches ? r - tap * Ci : r;
        ys[o * g.YP + q] = st[((ry + tap / 3) * g.Wp + xx + tap % 3) * g.PP + c];
      }
    } else {
      // the previous chunk's ws readers passed the barrier before its copy-out
      if (co0 > 0) stage_fwd_weights(w2, ws, co0, Ci, Co, g);
      cp_async_wait_all();
      __syncthreads();  // the stage and this chunk's W2 are complete
      const int ntiles = min(4, (Co - co0 + 7) / 8);
      for (int mp = warp; mp < pairs; mp += kFwWarps) {
        float acc[kFwMi][4][4];
        uint32_t a_lane[kFwMi];
#pragma unroll
        for (int mi = 0; mi < kFwMi; ++mi) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
          const int q = min((mp * kFwMi + mi) * 16 + a_pix, P - 1);
          a_lane[mi] = smem_addr(st) + 2u * (uint32_t)(((q / W) * g.Wp + q % W) * g.PP + a_k);
        }
        // k-step s is tap s / ksteps, channels 16 * (s % ksteps)
        const int S = 9 * ksteps;
        auto load = [&](int s, uint32_t (&a)[kFwMi][4], uint32_t (&b)[4][2]) {
          const int tap = s / ksteps, kc = s - tap * ksteps;
          const uint32_t toff = 2u * (uint32_t)(((tap / 3) * g.Wp + tap % 3) * g.PP) + 32u * kc;
#pragma unroll
          for (int mi = 0; mi < kFwMi; ++mi) ldmatrix_x4(a[mi], a_lane[mi] + toff);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            if (2 * jp >= ntiles) break;  // warp-uniform
            uint32_t r[4];
            ldmatrix_x4(r, b_lane + 2u * (uint32_t)(jp * 16 * g.KP + tap * g.CiP + kc * 16));
            b[2 * jp][0] = r[0];
            b[2 * jp][1] = r[1];
            b[2 * jp + 1][0] = r[2];
            b[2 * jp + 1][1] = r[3];
          }
        };
        auto mma = [&](const uint32_t (&a)[kFwMi][4], const uint32_t (&b)[4][2]) {
#pragma unroll
          for (int mi = 0; mi < kFwMi; ++mi)
#pragma unroll
            for (int j = 0; j < 4; ++j)  // warp-uniform: no mma past Co or the last pixel
              if (j < ntiles && (mp * kFwMi + mi) * 16 < P)
                mma_bf16(acc[mi][j], a[mi], b[j][0], b[j][1]);
        };
        for (int s = 0; s < S; ++s) {
          uint32_t a[kFwMi][4], b[4][2];
          load(s, a, b);
          mma(a, b);
        }
        // C fragment: pixels gq, gq+8 of the tile, output channels 2t, 2t+1
#pragma unroll
        for (int mi = 0; mi < kFwMi; ++mi) {
          const int q0 = (mp * kFwMi + mi) * 16 + gq;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j >= ntiles) break;
            __nv_bfloat16* yo = ys + (8 * j + 2 * t) * g.YP + q0;
            yo[0] = __float2bfloat16(acc[mi][j][0]);
            yo[g.YP] = __float2bfloat16(acc[mi][j][1]);
            yo[8] = __float2bfloat16(acc[mi][j][2]);
            yo[g.YP + 8] = __float2bfloat16(acc[mi][j][3]);
          }
        }
      }
    }
    __syncthreads();
    __nv_bfloat16* yb = y + ((long long)n * Co + co0) * HW + (long long)r0 * W;
    if (g.yvec) {
      const int PU = PV / 8;
      for (int i = threadIdx.x; i < oc * PU; i += blockDim.x) {
        const int o = i / PU, u = i - o * PU;
        *reinterpret_cast<uint4*>(yb + o * HW + u * 8) =
            *reinterpret_cast<const uint4*>(ys + o * g.YP + u * 8);
      }
    } else {
      for (int i = threadIdx.x; i < oc * PV; i += blockDim.x) {
        const int o = i / PV, p = i - o * PV;
        yb[o * HW + p] = ys[o * g.YP + p];
      }
    }
  }
}

// The bf16 K3: blocks of kFwPixels, or of kFwPixelsSmall when that would
// leave SMs without a block (ResNet-56's 16x16 stage at batch 64). Shapes
// whose stage does not fit even at one image row take the CUDA-core kernel,
// which stages less where Ci is far below its padding to 16: a few channels
// on wide rows, such as 3 channels at W = 1200 (chip_smoke.py checks it).
// K7's bf16 modes (MODE) take the same decisions.
template <int MODE>
int fwd_mma_launch(const void* x, const void* w2, void* y, int N, int Ci, int Co, int H, int W,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), wa = reinterpret_cast<uintptr_t>(w2),
                  ya = reinterpret_cast<uintptr_t>(y);
  FwGeom g;
  bool fits = fw_geometry(Ci, H, W, kFwPixels, xa, wa, ya, &g);
  if (fits && (long long)N * ((H + g.TR - 1) / g.TR) < sms)
    fits = fw_geometry(Ci, H, W, kFwPixelsSmall, xa, wa, ya, &g);
  if (!fits) return fwd_launch<__nv_bfloat16, MODE>(x, w2, y, N, Ci, Co, H, W, stream);
  const size_t smem = fw_smem(g);
  auto kernel = conv_fwd_mma<MODE>;
  e = raise_smem_limit(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((H + g.TR - 1) / g.TR, N), kFwThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w2),
      static_cast<__nv_bfloat16*>(y), Ci, Co, H, W, g);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int Ci, int Co, int H, int W) {
  return N < 1 || N > 65535 || Ci < 1 || Co < 1 || H < 1 || W < 1 || Co > 65535 * kCoTile;
}

}  // namespace

extern "C" {

// K3 / K7. x [N, Ci, H*W], w2 [Co, 9*Ci] (mode 0 only; may be null
// otherwise), y [N, Co, H*W], all of one dtype (0 = float32, 1 = bfloat16).
// mode: 0 = conv (K3), 1 = patches (Co <= 9*Ci), 2 = copy (Co <= Ci).
// Returns the CUDA error of the launch.
int fedml_conv_fwd(const void* x, const void* w2, void* y, int N, int Ci, int Co, int H, int W,
                   int mode, int dtype, void* stream) {
  if (bad_shape(N, Ci, Co, H, W) || mode < 0 || mode > 2 || (mode == kPatches && Co > 9 * Ci) ||
      (mode == kCopy && Co > Ci))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (mode == kConv) return fwd_mma_launch<kConv>(x, w2, y, N, Ci, Co, H, W, s);
    if (mode == kPatches) return fwd_mma_launch<kPatches>(x, w2, y, N, Ci, Co, H, W, s);
    return fwd_mma_launch<kCopy>(x, w2, y, N, Ci, Co, H, W, s);
  }
  if (mode == kConv) return fwd_launch<float, kConv>(x, w2, y, N, Ci, Co, H, W, s);
  if (mode == kPatches) return fwd_launch<float, kPatches>(x, w2, y, N, Ci, Co, H, W, s);
  return fwd_launch<float, kCopy>(x, w2, y, N, Ci, Co, H, W, s);
}

// Partials K4 writes for a dtype on the current device (the scratch holds
// blocks * Co * 9 * Ci floats); 0 when the shape's stage does not fit in
// shared memory. bf16 assumes 16-byte aligned inputs; unaligned ones need
// no more.
int fedml_conv_wgrad_blocks(int N, int Ci, int Co, int H, int W, int dtype) {
  if (bad_shape(N, Ci, Co, H, W)) return 0;
  if (dtype == 1) {
    WgGeom g;
    int B = 0;
    return wg_mma_plan(N, Ci, Co, H, W, true, &g, &B) == cudaSuccess ? B : 0;
  }
  return wgrad_blocks(N, Ci, Co, H, W);
}

// K4. x [N, Ci, H*W] and dy [N, Co, H*W] of one dtype (0 = float32: the
// CUDA-core partials and finalize; 1 = bfloat16: the tensor-core kernel,
// one cooperative launch); partial the f32 scratch; dw2 [Co, 9*Ci]
// float32; barrier two zeroed words of the device that no other launch
// uses at the same time (bf16 only; they are zero again after each call).
int fedml_conv_wgrad(const void* x, const void* dy, float* partial, float* dw2,
                     unsigned int* barrier, int N, int Ci, int Co, int H, int W, int dtype,
                     void* stream) {
  if (bad_shape(N, Ci, Co, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return wgrad_mma_launch(x, dy, partial, dw2, barrier, N, Ci, Co, H, W, s);
  return wgrad_launch<float>(x, dy, partial, dw2, N, Ci, Co, H, W, s);
}

const char* fedml_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
