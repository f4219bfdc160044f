// Spatial-in-lanes 3x3 convolution for Hopper: K3 (forward, also the dgrad),
// K4 (weight gradient) and K7 (K3's probe variants).
//
// Replaces the Pallas TPU kernels
//   K3 _fwd_kernel     fedml_tpu/ops/conv_lanes.py  (launched by _conv_fwd)
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
// one call moves 2-6 MB and does 0.3-0.6 GFLOP, so on the tensor cores it
// would be bound by device-memory bytes (about 1 us). This first version
// runs on the CUDA cores in f32 (no wgmma), so it is bound by FMAs and
// shared-memory loads instead; it reads each input byte from device memory
// once per block plus a one-row halo, and writes each output once.
//
// Design, against the TPU kernel:
// - No padded copy in device memory. The TPU kernel pads rows (_pad_rows) so
//   that every tap is a static slice; here a block stages its image rows, a
//   one-row halo above and below and a one-column border, into shared memory
//   as f32, with zeros outside the image. The 9 taps are then plain offsets
//   into that tile and need no edge masks.
// - Shared memory. A block covers one image and a tile of TR whole image
//   rows (TR*W ~ 256 pixels). At Ci = 32, W = 32 (the dgrad of stage 2,
//   block 0) the K3 stage is 62 KB and K4's 113 KB, above the 48 KB a
//   block gets by default, so the pixels are tiled (TR rows, not the whole
//   image) AND the host raises the kernel's dynamic shared-memory limit with
//   cudaFuncAttributeMaxDynamicSharedMemorySize (up to the card's 227 KB);
//   TR shrinks until the stage fits. A shape whose stage does not fit even
//   at TR = 1 is refused with cudaErrorInvalidValue.
// - K3: one thread per output pixel and 16 output channels (a Co tile per
//   blockIdx.y); the W2 tile sits in shared memory as [9*Ci][16] f32 so each
//   (tap, c) costs one tile load and four float4 weight loads (broadcast
//   across the warp) for 16 FMAs. Sums in f32 in tap-major order, output in
//   the input's dtype.
// - K4: the TPU kernel sums dW2 in one accumulator across a sequential grid;
//   CUDA blocks run in no order, so each block sums a fixed range of
//   (image, row tile) items into its own [Co, 9*Ci] f32 partial in a scratch
//   buffer, and a second launch adds the partials in a fixed order in f64.
//   No float atomics: the result is the same from run to run. Inside a
//   block each thread owns 4x4 (o, k) micro-tiles and loops over pixels.
// - K7 (MODE): kCopy writes the first Co channels of the image (no staging,
//   one copy); kPatches writes the first Co rows of the patch matrix (row r
//   = tap r / Ci, channel r % Ci, zero outside the image) from the staged
//   tile, no dot; kConv is K3 itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerBlock = 256;
constexpr int kCoTile = 16;         // K3: output channels per block
constexpr int kWgCoTile = 32;       // K4: output channels per block
constexpr int kWgradBlocks = 264;   // K4: partials over all Co tiles (2 per SM)
constexpr int kFinLanes = 8;        // K4 finalize: threads per dW2 entry
constexpr size_t kDefaultSmem = 48 * 1024;
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

// K3 (MODE kConv) and K7 (kPatches, kCopy). Grid: (row tiles, Co tiles, N).
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

// Raises the kernel's dynamic shared-memory limit above the 48 KB default
// once per instantiation, as far as this launch needs.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

template <typename T, int MODE>
int fwd_launch(const void* x, const void* w2, void* y, int N, int Ci, int Co, int H, int W,
               cudaStream_t stream) {
  static size_t allowed = kDefaultSmem;
  const int TR = fit_rows(H, W, [&](int tr) { return fwd_smem(Ci, W, tr, MODE); });
  if (TR == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(Ci, W, TR, MODE);
  auto kernel = conv_fwd_kernel<T, MODE>;
  cudaError_t e = allow_smem(kernel, smem, &allowed);
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
  static size_t allowed = kDefaultSmem;
  const int TR = wgrad_rows(Ci, H, W);
  if (TR == 0) return (int)cudaErrorInvalidValue;
  const int B = wgrad_blocks(N, Ci, Co, H, W);
  const size_t smem = wgrad_smem(Ci, W, TR);
  auto kernel = conv_wgrad_partials<T>;
  cudaError_t e = allow_smem(kernel, smem, &allowed);
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
    using T = __nv_bfloat16;
    if (mode == kConv) return fwd_launch<T, kConv>(x, w2, y, N, Ci, Co, H, W, s);
    if (mode == kPatches) return fwd_launch<T, kPatches>(x, w2, y, N, Ci, Co, H, W, s);
    return fwd_launch<T, kCopy>(x, w2, y, N, Ci, Co, H, W, s);
  }
  if (mode == kConv) return fwd_launch<float, kConv>(x, w2, y, N, Ci, Co, H, W, s);
  if (mode == kPatches) return fwd_launch<float, kPatches>(x, w2, y, N, Ci, Co, H, W, s);
  return fwd_launch<float, kCopy>(x, w2, y, N, Ci, Co, H, W, s);
}

// Partials K4 writes (the scratch holds blocks * Co * 9 * Ci floats); 0
// when the shape's stage does not fit in shared memory.
int fedml_conv_wgrad_blocks(int N, int Ci, int Co, int H, int W) {
  if (bad_shape(N, Ci, Co, H, W)) return 0;
  return wgrad_blocks(N, Ci, Co, H, W);
}

// K4. x [N, Ci, H*W] and dy [N, Co, H*W] of one dtype (0 = float32,
// 1 = bfloat16); partial the f32 scratch; dw2 [Co, 9*Ci] float32.
int fedml_conv_wgrad(const void* x, const void* dy, float* partial, float* dw2, int N, int Ci,
                     int Co, int H, int W, int dtype, void* stream) {
  if (bad_shape(N, Ci, Co, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return wgrad_launch<__nv_bfloat16>(x, dy, partial, dw2, N, Ci, Co, H, W, s);
  return wgrad_launch<float>(x, dy, partial, dw2, N, Ci, Co, H, W, s);
}

const char* fedml_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
