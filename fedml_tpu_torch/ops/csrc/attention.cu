// Causal flash attention partial for Hopper: K6.
//
// Replaces the Pallas TPU kernel
//   K6 _flash_kernel   fedml_tpu/ops/attention.py  (launched by _pallas_block_partial)
//
// Computes, per (batch*head, query row i), over the keys j of one K/V chunk:
//   s_ij = (q_i . k_j) * sm_scale, masked to NEG_INF unless
//          q_off + i >= k_off + j (causal; global positions),
//   m_i  = max_j s_ij,   p_ij = exp(s_ij - m_i), 0 where s_ij <= NEG_INF/2,
//   l_i  = sum_j p_ij,   o_i = sum_j p_ij v_j   (unnormalized, f32).
// A row that sees only masked keys ends with m = NEG_INF, l = 0, o = 0,
// never NaN: a ring of chunks merges such rows away.
//
// What bounds it on this card: at the LM path's shape ([2, 8, 8192, 32],
// causal) one call does ~69 GFLOP of dot products on 17 MB of input (bf16)
// and writes 34 MB, so it is bound by operations. The JAX kernel casts q, k
// and v to f32 and keeps p in f32 for p.v; to give the same result this first
// version does f32 FMAs on the CUDA cores (67 TFLOP/s, not the tensor cores'
// 989 bf16), so its floor is ~1 ms per call at that shape.
//
// Design, against the TPU kernel:
// - The TPU grid walks the k blocks in order and carries the running
//   (m, l, acc) in VMEM scratch from one grid step to the next. CUDA blocks
//   run in no order, so one block owns a tile of query rows and loops over
//   the K/V tiles itself; (m, l, acc) live in registers for the whole loop.
// - One thread owns one query row's slice of DS = min(D, 32) head dims, and
//   R = D / DS neighbouring lanes of a warp share a row (their partial dot
//   products are summed with shuffles). q and the f32 accumulator sit in
//   registers (2 * DS floats), the tile's BK scores too. A block of 128
//   threads covers 128 / R query rows.
// - Each K/V tile (BK = 32 keys) is staged once per block into shared
//   memory as f32, so every row of the block reads it from there; a row's
//   threads read the same addresses as the other rows' (broadcast).
// - Causal: the loop over K/V tiles stops at the last key the tile's last
//   query row may see, so no block touches a tile above the diagonal (the
//   TPU kernel's "dead block" skip, here a loop bound). Blocks are issued
//   heaviest (last query tiles) first.
// - Ragged Tq, Tk: the last query tile's extra rows compute but do not
//   store; keys past Tk are staged as zeros and masked.
// - The online-softmax update is the TPU kernel's, per K/V tile: new max,
//   alpha = exp(m_prev - m_new) (0 while m_prev is NEG_INF), masked p = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;               // keys per staged K/V tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int Tq, int Tk, long long q_off, long long k_off, int causal,
                 float sm_scale) {
  constexpr int DS = D < 32 ? D : 32;  // head dims per thread
  constexpr int R = D / DS;            // threads per query row
  constexpr int BQ = kThreads / R;     // query rows per block
  __shared__ float4 ks4[kBK * D / 4];
  __shared__ float4 vs4[kBK * D / 4];
  float* ks = reinterpret_cast<float*>(ks4);
  float* vs = reinterpret_cast<float*>(vs4);

  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = qt * BQ;
  const int row = q0 + threadIdx.x / R;
  const int part = threadIdx.x % R;
  const int d0 = part * DS;
  const bool live_row = row < Tq;
  const long long qpos = q_off + row;

  const T* qb = q + (long long)bh * Tq * D;
  const T* kb = k + (long long)bh * Tk * D;
  const T* vb = v + (long long)bh * Tk * D;

  float qr[DS], acc[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    qr[d] = live_row ? to_f(qb[(long long)row * D + d0 + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m_run = kNegInf, l_run = 0.f;

  // keys [0, kend) may be seen by some row of this tile
  long long kend = Tk;
  if (causal) {
    const int q_last = min(q0 + BQ, Tq) - 1;
    const long long last_key = q_off + q_last - k_off;  // largest visible key index
    kend = last_key < 0 ? 0 : (last_key + 1 < Tk ? last_key + 1 : Tk);
  }

  for (int kt0 = 0; kt0 < kend; kt0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int j = kt0 + i / D;
      const bool in = j < Tk;
      ks[i] = in ? to_f(kb[(long long)kt0 * D + i]) : 0.f;
      vs[i] = in ? to_f(vb[(long long)kt0 * D + i]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D + d0);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DS / 4; ++d4) {
        const float4 kv = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kv.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
      }
#pragma unroll
      for (int off = R / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kj = kt0 + j;
      const bool valid = kj < Tk && (!causal || qpos >= k_off + kj);
      s[j] = valid ? dot * sm_scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = m_run <= kNegInf / 2 ? 0.f : expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < DS; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j] <= kNegInf / 2 ? 0.f : expf(s[j] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D + d0);
#pragma unroll
      for (int d4 = 0; d4 < DS / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    l_run = l_run * alpha + psum;
    m_run = m_new;
  }

  if (!live_row) return;
  float* orow = o + ((long long)bh * Tq + row) * D + d0;
#pragma unroll
  for (int d = 0; d < DS; ++d) orow[d] = acc[d];
  if (part == 0) {
    m_out[(long long)bh * Tq + row] = m_run;
    l_out[(long long)bh * Tq + row] = l_run;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, float* o, float* m, float* l, int BH,
           int Tq, int Tk, long long q_off, long long k_off, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr int BQ = kThreads / (D / (D < 32 ? D : 32));
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, m, l, Tq,
      Tk, q_off, k_off, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, float* o, float* m, float* l, int BH,
             int Tq, int Tk, int D, long long q_off, long long k_off, int causal,
             float sm_scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, s);
    case 32: return launch<T, 32>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K6. q [BH, Tq, D], k and v [BH, Tk, D], all of one dtype (0 = float32,
// 1 = bfloat16), D in {16, 32, 64, 128}; o [BH, Tq, D], m and l [BH, Tq]
// float32. Returns the CUDA error of the launch.
int fedml_attention_fwd(const void* q, const void* k, const void* v, float* o, float* m,
                        float* l, int BH, int Tq, int Tk, int D, long long q_off,
                        long long k_off, int causal, float sm_scale, int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, m, l, BH, Tq, Tk, D, q_off, k_off, causal,
                                   sm_scale, s);
  return dispatch<float>(q, k, v, o, m, l, BH, Tq, Tk, D, q_off, k_off, causal, sm_scale, s);
}

const char* fedml_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
