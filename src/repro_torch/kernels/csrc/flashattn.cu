// Flash attention (forward) for Hopper (sm_90a).
//
// Hand-written CUDA port of the Pallas TPU kernel
// src/repro/kernels/flashattn.py:_flash_kernel (flash_attention). It computes
// the same online-softmax attention: for every query row,
//
//   s_j = (q . k_j) * scale          (f32; scale = 1/sqrt(D))
//   s_j = NEG_INF = -1e30            where the mask hides key j
//   o   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with the running max m, the denominator and the accumulator kept in f32,
// and the causal and sliding-window masks taken from absolute positions
// starting at 0 (key j is visible to query i when j < Sk, j <= i if causal,
// and j > i - window if windowed). The output is written in the input dtype.
//
// Mapping. The TPU walks the grid (B, H, Sq/BQ, Sk/BK) in order and carries
// the running statistics across the innermost KV axis in VMEM scratch. Here
// one CTA of 128 threads owns one (b, h, query tile of 64 rows) and walks
// the KV tiles of 64 keys in a loop; blocks run in parallel and carry
// nothing between them. The longest rows (the last query tiles, under a
// causal mask) are scheduled first. Two kernels:
//
//   * flash_fwd_bf16 (bf16 inputs, the model's prefill): both products on
//     the tensor cores with mma.sync (see its comment below);
//   * flash_fwd_f32 (f32 inputs): both products as f32 FMAs on the CUDA
//     cores, so f32 attention keeps f32 products as in the TPU kernel.
//
// Tiles that the causal or window mask hides from every row of the CTA are
// skipped (the TPU kernel runs them). A row whose first tiles are all masked
// accumulates exp(0) = 1 terms, exactly as the TPU kernel does; the first
// visible key then brings corr = exp(-1e30 - m) = 0, which wipes them. The
// wrapper rejects inputs in which some row sees no key at all.
//
// Layout. Any (b, h, s, d) strides with d contiguous: the public wrapper
// passes (B, H, S, D) tensors with the heads already repeated; the model's
// prefill passes its (B, S, H, D) projections and the KV-head group size
// (query head h reads KV head h / group), so no transposed or repeated copy
// is made.
//
// Bound. At the prefill shapes the work is 4*D flops per visible (query,
// key) pair against reading q, k, v and writing o once, so the tensor
// cores' peak bf16 rate bounds it. The bf16 kernel overlaps the next KV
// tile's copy (cp.async, two stages) with the products of this one; it
// still runs mma.sync from every warp rather than wgmma fed by TMA with
// warp specialization, which is the next step toward the bound.
//
// Built with FMA contraction allowed (unlike quant8): the result is held to a
// tolerance, not bitwise. The f32 kernel uses expf, the bf16 kernel exp2f on
// scores scaled by log2(e); the final division stays IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 128;
constexpr int kPad = 4;           // floats of padding per shared row
constexpr int kLdT = kBQ + kPad;  // row length of the transposed tiles
constexpr float kNegInf = -1e30f;
constexpr float kMinDenom = 1e-30f;

static_assert(kBQ == kBK, "transposed Q and K tiles share one row length");

struct Strides {
  int64_t b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int group;                     // query heads per KV head
  int sq, sk;
  int causal;
  int window;                    // <= 0: no window
  float scale;
};

// ---------------------------------------------------------------------------
// f32: the query tile is staged once in shared memory (transposed); each KV
// tile is staged in turn, K transposed for the score product and then V
// row-major for the value product, in the same buffer. Thread (ty, tx) =
// (tid / 8, tid % 8) owns query rows 4ty..4ty+3, score columns 4tx..4tx+3
// and 32+4tx..32+4tx+3, and the output columns 4(8c+tx)..+3 for c < D/32,
// so every shared load is a 16-byte vector that neighbouring threads take
// from neighbouring addresses (or the same one). The 8 threads of a row
// group sit in one warp, so row maxima and sums are warp shuffles. The
// probabilities go through shared memory (transposed) to the value product.
// ---------------------------------------------------------------------------

// Stage 64 rows of D floats (row stride `rs`, d contiguous) in shared
// memory, transposed (dst[d * ld + r]) or not (dst[r * ld + d]); rows at or
// past `valid` are zero.
template <int D, bool kTransposed>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int64_t rs, int valid) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const float x = r < valid ? src[r * rs + d] : 0.f;
    if (kTransposed)
      dst[d * ld + r] = x;
    else
      dst[r * ld + d] = x;
  }
}

__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // Q^T, then K^T / V (one buffer), then P^T
  return D * kLdT + (D * kLdT > kBK * (D + kPad) ? D * kLdT : kBK * (D + kPad)) +
         kBK * kLdT;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_f32(Params p) {
  constexpr int kLdV = D + kPad;
  constexpr int kChunks = D / 32;  // float4 output chunks per thread
  constexpr int kKV = D * kLdT > kBK * kLdV ? D * kLdT : kBK * kLdV;
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);
  float* sKV = sQt + D * kLdT;
  float* sPt = sKV + kKV;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs.b +
                    h * p.qs.h + q0 * p.qs.s;
  const float* kg = static_cast<const float*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.vs.b + hk * p.vs.h;
  float* og = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  // keys any row of this tile can see
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  const int k_begin =
      p.window > 0 ? max(0, q0 - p.window + 1) / kBK * kBK : 0;

  stage<D, true>(sQt, kLdT, qg, p.qs.s, min(kBQ, p.sq - q0));

  float m[4], l[4], acc[4][kChunks * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks * 4; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int kvalid = min(kBK, p.sk - k0);
    __syncthreads();  // the previous tile's V and P are consumed
    stage<D, true>(sKV, kLdT, kg + k0 * p.ks.s, p.ks.s, kvalid);
    __syncthreads();

    // s = Q K^T for 4 rows x 8 columns
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQt[d * kLdT + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&sKV[d * kLdT + 4 * tx]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sKV[d * kLdT + 32 + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }

    // scale, mask and the online softmax update
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + (j < 4 ? 4 * tx + j : 32 + 4 * tx + j - 4);
        bool ok = col < p.sk;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && col > row - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;  // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks * 4; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? 4 * tx + j : 32 + 4 * tx + j - 4;
      *reinterpret_cast<float4*>(&sPt[col * kLdT + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();  // P written, K consumed
    stage<D, false>(sKV, kLdV, vg + k0 * p.vs.s, p.vs.s, kvalid);
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(&sPt[kk * kLdT + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(
            &sKV[kk * kLdV + 4 * (8 * c + tx)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] += pv[i] * va.x;
          acc[i][4 * c + 1] += pv[i] * va.y;
          acc[i][4 * c + 2] += pv[i] * va.z;
          acc[i][4 * c + 3] += pv[i] * va.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(row_sum8(l[i]), kMinDenom);
    const int row = q0 + 4 * ty + i;
    if (row >= p.sq) continue;
    float* orow = og + row * p.os.s;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[4 * (8 * c + tx) + e] = acc[i][4 * c + e] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: the two products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). Each of the 4 warps owns 16 query rows of the 64-row tile; Q
// stays in registers as mma A fragments for the whole KV loop. Per KV tile
// of 64 keys a warp computes its 16 x 64 scores (S = Q K^T) in f32, updates
// the online softmax on them in registers, rounds the probabilities to bf16
// and feeds them straight back as the A fragments of P V (the accumulator
// layout of S is the A layout of P, so they never touch shared memory). KV
// tiles arrive through a two-stage cp.async ring in shared memory (the copy
// of tile i+1 runs under the products of tile i); K's B fragments are read
// with ldmatrix, V's with ldmatrix.trans. Tiles that no mask touches skip
// the per-element mask. The scores, the softmax and the accumulator are f32
// as in the TPU kernel; the probabilities enter P V in bf16, the inputs' own
// precision (the TPU kernel keeps them in f32), which the bf16 output's
// tolerance covers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Start the copy of a (64, D) bf16 tile into shared memory with cp.async
// (16 bytes per request, no registers on the way); rows at or past `valid`
// are zeroed with plain stores.
template <int D>
__device__ __forceinline__ void stage_bf16_async(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 int64_t rs, int valid) {
  constexpr int kLd = D + 8, kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    __nv_bfloat16* d = dst + r * kLd + 8 * c;
    if (r < valid) {
      const unsigned sa =
          static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(src + r * rs + 8 * c));
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

template <int D>
constexpr int smem_bytes_bf16() {
  return 4 * kBK * (D + 8) * 2;  // two stages of K and V
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int kLd = D + 8;       // bf16 per shared row: 16 B of padding
  constexpr int kKSteps = D / 16;  // k-steps of Q K^T
  constexpr int kNT = kBK / 8;     // score n-tiles per KV tile
  constexpr int kOT = D / 8;       // output n-tiles
  constexpr int kTile = kBK * kLd;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint4 smem_bf16[];
  bf16* sbase = reinterpret_cast<bf16*>(smem_bf16);  // K0, V0, K1, V1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h +
                   q0 * p.qs.s;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks.b + hk * p.ks.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs.b + hk * p.vs.h;
  bf16* og = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;

  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  const int k_begin =
      p.window > 0 ? max(0, q0 - p.window + 1) / kBK * kBK : 0;

  // Q's A fragments, through the second stage's K buffer
  stage_bf16_async<D>(sbase + 2 * kTile, qg, p.qs.s, min(kBQ, p.sq - q0));
  cp_async_commit();
  // the first KV tile, into stage 0
  if (k_begin < k_end) {
    const int kvalid = min(kBK, p.sk - k_begin);
    stage_bf16_async<D>(sbase, kg + k_begin * p.ks.s, p.ks.s, kvalid);
    stage_bf16_async<D>(sbase + kTile, vg + k_begin * p.vs.s, p.vs.s, kvalid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kKSteps][4];
  {
    const bf16* sq = sbase + 2 * kTile + (16 * warp + g) * kLd + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      qf[ks][0] = lds32(sq + 16 * ks);
      qf[ks][1] = lds32(sq + 8 * kLd + 16 * ks);
      qf[ks][2] = lds32(sq + 16 * ks + 8);
      qf[ks][3] = lds32(sq + 8 * kLd + 16 * ks + 8);
    }
  }
  __syncthreads();  // stage 1 may now be overwritten

  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK, stage ^= 1) {
    // prefetch the next tile into the other stage, then wait for this one
    const int k1 = k0 + kBK;
    if (k1 < k_end) {
      const int nvalid = min(kBK, p.sk - k1);
      bf16* nk = sbase + 2 * (stage ^ 1) * kTile;
      stage_bf16_async<D>(nk, kg + k1 * p.ks.s, p.ks.s, nvalid);
      stage_bf16_async<D>(nk + kTile, vg + k1 * p.vs.s, p.vs.s, nvalid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sK = sbase + 2 * stage * kTile;
    const bf16* sV = sK + kTile;

    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      // ldmatrix: lane l addresses key 8n + l % 8, dims 16 ks' + 8 (l / 8)
      const unsigned kaddr = static_cast<unsigned>(__cvta_generic_to_shared(
          sK + (8 * n + (lane & 7)) * kLd + 8 * (lane >> 3)));
#pragma unroll
      for (int ks = 0; ks < kKSteps; ks += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(kaddr + 2 * 16 * ks, b0, b1, b2, b3);
        mma_bf16(sc[n], qf[ks], b0, b1);
        mma_bf16(sc[n], qf[ks + 1], b2, b3);
      }
    }

    // scale, mask and the online softmax update; this thread holds columns
    // 8n + 2t + {0, 1} of rows row0 (sc[n][0..1]) and row1 (sc[n][2..3])
    float mx0 = kNegInf, mx1 = kNegInf;
    // scores in log2 units: exp(s - m) = exp2(s log2(e) - m log2(e)), one
    // multiply-add and one ex2 per score
    const float sl2 = p.scale * 1.4426950408889634f;
    const bool edge = k0 + kBK > p.sk ||
                      (p.causal && k0 + kBK - 1 > q0 + 16 * warp) ||
                      (p.window > 0 && k0 <= q0 + 16 * warp + 15 - p.window);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * sl2;
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          bool ok = col < p.sk;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && col > row - p.window;
          x = ok ? x : kNegInf;
        }
        sc[n][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn0);
      sc[n][1] = exp2f(sc[n][1] - mn0);
      sc[n][2] = exp2f(sc[n][2] - mn1);
      sc[n][3] = exp2f(sc[n][3] - mn1);
      rs0 += sc[n][0] + sc[n][1];
      rs1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * c0 + rs0;  // this thread's share of the row sums
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int n = 0; n < kOT; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // o += P V, 16 keys per k-step
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                              pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                              pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      // ldmatrix.trans: lane l addresses row l % 8 of matrix l / 8, which
      // holds keys 16j + 8 (l/8 & 1) + 0..7 of dims 8 (2 np + (l/8 >> 1))
      const int key = 16 * j + 8 * ((lane >> 3) & 1) + (lane & 7);
      const unsigned vaddr = static_cast<unsigned>(__cvta_generic_to_shared(
          sV + key * kLd + 8 * (lane >> 4)));
#pragma unroll
      for (int np = 0; np < kOT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(vaddr + 2 * 16 * np, b0, b1, b2, b3);
        mma_bf16(o[2 * np], pa, b0, b1);
        mma_bf16(o[2 * np + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, kMinDenom), d1 = fmaxf(l1, kMinDenom);
#pragma unroll
  for (int n = 0; n < kOT; ++n) {
    const int dim = 8 * n + 2 * t;
    if (row0 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(og + row0 * p.os.s + dim) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (row1 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(og + row1 * p.os.s + dim) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int b, int h, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int b, int h, cudaStream_t stream) {
  const int smem = smem_bytes_bf16<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Params& p, int b, int h, int d,
                         cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_f32<32>(p, b, h, stream);
    case 64:
      return launch_f32<64>(p, b, h, stream);
    case 128:
      return launch_f32<128>(p, b, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const Params& p, int b, int h, int d,
                          cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_bf16<32>(p, b, h, stream);
    case 64:
      return launch_bf16<64>(p, b, h, stream);
    case 128:
      return launch_bf16<128>(p, b, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Replaces src/repro/kernels/flashattn.py:_flash_kernel (flash_attention).
// q: (B, H, Sq, D) through strides (q_sb, q_sh, q_ss) and d contiguous; k, v:
// (B, H / group, Sk, D) likewise; o like q. f32 (is_bf16 == 0) or bf16 for
// all four. D is 32, 64 or 128; window <= 0 means no window.
cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, int is_bf16, int b, int h, int group,
                                int sq, int sk, int d, int64_t q_sb,
                                int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                int64_t v_sh, int64_t v_ss, int64_t o_sb,
                                int64_t o_sh, int64_t o_ss, int causal,
                                int window, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs = {q_sb, q_sh, q_ss};
  p.ks = {k_sb, k_sh, k_ss};
  p.vs = {v_sb, v_sh, v_ss};
  p.os = {o_sb, o_sh, o_ss};
  p.group = group;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_bf16(p, b, h, d, st);
  return dispatch_f32(p, b, h, d, st);
}

const char* flashattn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
