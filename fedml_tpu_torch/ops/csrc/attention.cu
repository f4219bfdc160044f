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
// Two kernels behind one entry point; the dtype picks one.
//
// bf16 inputs: flash_fwd_mma_kernel, on the tensor cores.
// - Numerics. The JAX kernel casts q, k, v to f32 and keeps p in f32. A
//   bf16 x bf16 product is exact in f32, so Q.K^T by mma.sync bf16 with f32
//   accumulation is the JAX kernel's f32 dot on the same inputs, summed in
//   another order. p is the one operand that is not bf16 already: it is
//   split as p = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi), both
//   round-to-nearest, and O += p_hi.V + p_lo.V (two mma.sync on the same V
//   fragment into one f32 accumulator). p_hi + p_lo keeps p to 2^-16
//   relative, so o/l stays within ~1e-5 of the f32 result; p rounded once
//   to bf16 (2^-8) would miss the 2e-5 tolerance by ~200x. l is summed from
//   the f32 p. exp is ex2.approx.
// - What bounds it: at the LM path's shape ([2, 8, 8192, 32], causal) one
//   call has 537 M live scores, and each takes one exponential on the
//   special-function units, 16 per clock per SM: 0.128 ms at 1980 MHz. The
//   tensor-core work is smaller (64 FLOPs a score for Q.K^T, 128 for the
//   split P.V: 0.07 ms at 989 TFLOP/s) and the bytes smaller still (17 MB
//   in, 34 MB out: 0.013 ms). On the card the kernel runs at ~3x that
//   floor: mma.sync issues at well below the wgmma peak, and the split adds
//   half again to the P.V products and ~3 instructions a score (without
//   the p_lo products the same kernel is ~20% faster; without the
//   exponentials, 4%).
// - Design (FlashAttention-2's): a block of 4 warps owns 64 query rows of
//   one (b, h); each warp owns 16 rows and keeps their Q fragment in
//   registers for the whole loop. K/V tiles of 64 keys arrive as bf16 in a
//   2-stage cp.async ring in shared memory, rows padded by 8 elements so
//   that ldmatrix reads them without bank conflicts (ldmatrix.trans for V).
//   S = Q.K^T (mma.sync m16n8k16) stays unscaled: sm_scale is folded into
//   the exponent's FMA, p = ex2(s * c - m * c) with c = |sm_scale| log2(e),
//   and the row max is taken on s (it commutes with a non-negative scale; a
//   negative sm_scale flips q's sign bits, which is exact). The online
//   softmax runs on the S fragment in registers, a row's max and sum
//   reduced across the 4 lanes that hold it with shuffles (the sum once, at
//   the end). The S fragment of 16 keys is the A fragment of P.V as it
//   stands, so p never leaves registers.
// - Causal: the loop over K/V tiles stops at the last key the block's last
//   row may see (the TPU kernel's dead-block skip, here a loop bound), and
//   blocks are issued heaviest query tiles first, for every head at once.
//   Only tiles on the diagonal or past Tk take the masked copy of the
//   softmax (a compile-time branch); the others run without mask tests.
// - Ragged Tq, Tk: rows past Tq load zeros and do not store; keys past Tk
//   arrive as zeros (cp.async zero-fill) and are masked.
// - Fully masked rows: the TPU kernel's rules carry over. While a row has
//   no live score its exponent offset is -inf, so p = 0 and alpha = 0;
//   masked keys get p = 0 explicitly. (A live score at or below NEG_INF/2,
//   |q.k| ~ 5e29, would get its exponential instead of 0; no finite bf16
//   inputs of magnitude below 1e14 give one.)
//
// f32 inputs: flash_fwd_kernel, on the CUDA cores. f32 operands on the
// tensor cores would be TF32 (10-bit mantissa) and break the f32 parity,
// so this kernel stays as the port's first version: one thread owns a
// query row's slice of DS = min(D, 32) head dims (R = D / DS lanes share a
// row, partial dots summed by shuffles), K/V tiles of 32 keys staged as
// f32 in shared memory, f32 FMAs; ~1 ms per call at the LM path's shape at
// best.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;               // f32 kernel: keys per staged K/V tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32 inputs: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
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

  const float* qb = q + (long long)bh * Tq * D;
  const float* kb = k + (long long)bh * Tk * D;
  const float* vb = v + (long long)bh * Tk * D;

  float qr[DS], acc[DS];
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    qr[d] = live_row ? qb[(long long)row * D + d0 + d] : 0.f;
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
      ks[i] = in ? kb[(long long)kt0 * D + i] : 0.f;
      vs[i] = in ? vb[(long long)kt0 * D + i] : 0.f;
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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, float* o, float* m, float* l, int BH,
               int Tq, int Tk, long long q_off, long long k_off, int causal, float sm_scale,
               cudaStream_t stream) {
  constexpr int BQ = kThreads / (D / (D < 32 ? D : 32));
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), o,
      m, l, Tq, Tk, q_off, k_off, causal, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;        // query rows per block, 16 per warp
constexpr int kTK = 64;                 // keys per K/V tile
constexpr int kStages = 2;              // K/V tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !in (the source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16x2 word, x0 in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p = p_hi + p_lo for a pair: p_hi = bf16(p), p_lo = bf16(p - p_hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* base, int row, int rows, int col,
                                            int D) {
  return row < rows ? *reinterpret_cast<const uint32_t*>(base + (long long)row * D + col) : 0u;
}

// Fragments (PTX mma.m16n8k16, g = lane / 4, t = lane % 4): A regs hold
// (row g | g+8, cols 2t..2t+1 | 2t+8..2t+9) in the order (g, lo), (g+8, lo),
// (g, hi), (g+8, hi); B regs hold (k 2t..2t+1 | 2t+8..2t+9, col g); C holds
// (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).
// D <= 32: at most 96 registers, so 5 blocks (20 warps) share an SM
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 32 ? 5 : 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out, int Tq, int Tk,
                     long long q_off, long long k_off, int causal, float sm_scale) {
  constexpr int SK = D + 8;            // staged row, elements (padded: no bank conflicts)
  constexpr int KC = D / 16;           // k16 chunks of the head dim (Q.K^T)
  constexpr int DN = D / 8;            // n8 tiles of the head dim (P.V)
  constexpr int NT = kTK / 8;          // n8 tiles of a key tile
  constexpr int TILE = kTK * SK;       // elements of one staged K or V tile
  constexpr int CH = D / 8;            // 16-byte chunks per row
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][K, V][kTK][SK]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest query tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + (long long)bh * Tq * D;
  const __nv_bfloat16* kb = k + (long long)bh * Tk * D;
  const __nv_bfloat16* vb = v + (long long)bh * Tk * D;

  // keys [0, kend) may be seen by some row of this block
  long long kend = Tk;
  if (causal) {
    const int q_last = min(q0 + kBQ, Tq) - 1;
    const long long last_key = q_off + q_last - k_off;
    kend = last_key < 0 ? 0 : (last_key + 1 < Tk ? last_key + 1 : Tk);
  }
  const int ntiles = (int)((kend + kTK - 1) / kTK);

  auto load_tile = [&](int it) {
    const int kt0 = it * kTK;
    __nv_bfloat16* ks = smem + (it % kStages) * 2 * TILE;
    __nv_bfloat16* vs = ks + TILE;
    for (int c = threadIdx.x; c < kTK * CH; c += kMmaThreads) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool in = kt0 + r < Tk;
      const long long off = in ? (long long)(kt0 + r) * D + col : 0;
      cp_async16(smem_addr(ks + r * SK + col), kb + off, in);
      cp_async16(smem_addr(vs + r * SK + col), vb + off, in);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_tile(0);

  // A negative sm_scale flips the sign of q (exact in bf16), so that the
  // scores are scaled by sc = |sm_scale| >= 0 and max commutes with scaling.
  const uint32_t flip = sm_scale < 0.f ? 0x80008000u : 0u;
  const float sc = fabsf(sm_scale), c_l2 = sc * kLog2e;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = ld_pair(qb, row0, Tq, c, D) ^ flip;
    qf[kc][1] = ld_pair(qb, row0 + 8, Tq, c, D) ^ flip;
    qf[kc][2] = ld_pair(qb, row0, Tq, c + 8, D) ^ flip;
    qf[kc][3] = ld_pair(qb, row0 + 8, Tq, c + 8, D) ^ flip;
  }

  float acc[DN][4];  // p_hi.V + p_lo.V
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max of the unscaled scores q.k (the scaled max is m * sc)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  // per-lane ldmatrix offsets (elements) within a staged tile
  const int k_ld = ((lane >> 4) * 8 + (lane & 7)) * SK + ((lane >> 3) & 1) * 8;
  const int v_ld = (((lane >> 3) & 1) * 8 + (lane & 7)) * SK + (lane >> 4) * 8;

  // S = Q . K^T over the keys of staged tile `it`
  auto scores = [&](int it, float (&s)[NT][4]) {
    const uint32_t ks_addr = smem_addr(smem + (it % kStages) * 2 * TILE + k_ld);
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(ks_addr + 2 * (np * 16 * SK + kc * 16), b);
        mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
      }
    }
  };

  // Online softmax of tile `it`'s scores s and O += P . V. EDGE: the tile
  // has masked keys (past Tk, or past the diagonal for some row).
  auto softmax_pv = [&](int it, float (&s)[NT][4], auto edge_c) {
    constexpr bool EDGE = decltype(edge_c)::value;
    const int kt0 = it * kTK;
    auto masked = [&](int n, int e) {
      const int key = kt0 + n * 8 + 2 * t + (e & 1);
      return key >= Tk || (causal && q_off + row0 + (e >> 1) * 8 < k_off + key);
    };
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (EDGE && masked(n, e)) s[n][e] = kNegInf;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[n][e]);
      }
    }
    float neg_m[2];  // -m * sc * log2(e); -inf while a row has no live score (p = 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m_run[h], tmax[h]);
      const float alpha = m_run[h] <= kNegInf / 2 ? 0.f : ex2((m_run[h] - m_new) * c_l2);
      neg_m[h] = m_new > kNegInf / 2 ? -m_new * c_l2 : __int_as_float(0xff800000);
      m_run[h] = m_new;
      l_run[h] *= alpha;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // p = exp((s - m) * sc), and O += p_hi . V + p_lo . V, 16 keys at a time
    const uint32_t vs_addr = smem_addr(smem + (it % kStages) * 2 * TILE + TILE + v_ld);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = ex2(fmaf(s[2 * j + u][e], c_l2, neg_m[e >> 1]));
          if (EDGE && masked(2 * j + u, e)) x = 0.f;  // also when sc = 0
          l_run[e >> 1] += x;
          p[u][e] = x;
        }
      }
      uint32_t ahi[4], alo[4];
      split_bf16(p[0][0], p[0][1], ahi[0], alo[0]);  // row g,   keys 16j + 2t
      split_bf16(p[0][2], p[0][3], ahi[1], alo[1]);  // row g+8, keys 16j + 2t
      split_bf16(p[1][0], p[1][1], ahi[2], alo[2]);  // row g,   keys 16j + 8 + 2t
      split_bf16(p[1][2], p[1][3], ahi[3], alo[3]);  // row g+8, keys 16j + 8 + 2t
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(vs_addr + 2 * (j * 16 * SK + dp * 16), b);
        mma_bf16(acc[2 * dp], ahi, b[0], b[1]);
        mma_bf16(acc[2 * dp], alo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], ahi, b[2], b[3]);
        mma_bf16(acc[2 * dp + 1], alo, b[2], b[3]);
      }
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    float s[NT][4];
    scores(it, s);
    const int kt0 = it * kTK;
    if (kt0 + kTK > Tk || (causal && q_off + q0 < k_off + kt0 + kTK - 1))
      softmax_pv(it, s, std::true_type{});
    else
      softmax_pv(it, s, std::false_type{});
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    const int row = row0 + 8 * h;
    if (row >= Tq) continue;
    const long long r = (long long)bh * Tq + row;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<float2*>(o + r * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    if (t == 0) {
      m_out[r] = m_run[h] <= kNegInf / 2 ? kNegInf : m_run[h] * sc;
      l_out[r] = l_run[h];
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, float* o, float* m, float* l, int BH,
                int Tq, int Tk, long long q_off, long long k_off, int causal, float sm_scale,
                cudaStream_t stream) {
  const size_t smem = (size_t)kStages * 2 * kTK * (D + 8) * sizeof(__nv_bfloat16);
  const int qtiles = (Tq + kBQ - 1) / kBQ;
  if (qtiles > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_mma_kernel<D>;
  const cudaError_t e = raise_smem_limit(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, qtiles);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), o, m, l, Tq, Tk, q_off, k_off, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, float* o, float* m, float* l, int BH,
           int Tq, int Tk, long long q_off, long long k_off, int causal, float sm_scale, int dtype,
           cudaStream_t s) {
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, s);
  return launch_f32<D>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, s);
}

}  // namespace

extern "C" {

// K6. q [BH, Tq, D], k and v [BH, Tk, D], all of one dtype (0 = float32,
// 1 = bfloat16; bf16 rows 16-byte aligned), D in {16, 32, 64, 128}; o
// [BH, Tq, D], m and l [BH, Tq] float32. Returns the CUDA error of the launch.
int fedml_attention_fwd(const void* q, const void* k, const void* v, float* o, float* m,
                        float* l, int BH, int Tq, int Tk, int D, long long q_off,
                        long long k_off, int causal, float sm_scale, int dtype, void* stream) {
  if (BH < 1 || BH > 65535 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, dtype, s);
    case 32: return launch<32>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, dtype, s);
    case 64: return launch<64>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, dtype, s);
    case 128:
      return launch<128>(q, k, v, o, m, l, BH, Tq, Tk, q_off, k_off, causal, sm_scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fedml_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
