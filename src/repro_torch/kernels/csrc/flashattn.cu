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
// one CTA owns one (b, h, query tile) at a time and walks its KV tiles in a
// loop; blocks run in parallel and carry nothing between them. The longest
// rows (the last query tiles, under a causal mask) are scheduled first. Each
// (dtype, D) pair runs exactly one kernel (dispatch_bf16 / dispatch_f32):
//
//   * bf16, D 64, 128 and 256 (whisper-small's encoder, decoder and
//     cross-attention; yi-6b's and llava's prefill; recurrentgemma-2b's
//     local attention): flash_fwd_wgmma<D>, built for Hopper (see its
//     comment below): persistent CTAs, TMA loads from a warp-specialized
//     producer, both products on wgmma; D 64 on 192-row query tiles (three
//     consumer warpgroups) and 128-key KV tiles, D 128 on 128-row tiles
//     (two) and 128-key KV tiles, D 256 on 128-row tiles and 64-key KV
//     tiles;
//   * bf16, D 32 (no served model has it): flash_fwd_bf16, both products on
//     mma.sync from every warp, 64-row query tiles, a cp.async K/V ring;
//   * f32, D 32, 64 and 128: flash_fwd_f32, both products as f32 FMAs on
//     the CUDA cores, so f32 attention keeps f32 products as in the TPU
//     kernel.
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
// Bounds. The work is 4*D flops per visible (query, key) pair against
// reading q, k, v and writing o once, and one exp2 per visible pair. At the
// prefill shapes the tensor cores bound it: S-A takes 0.28 ms of bf16 work
// at 989 TFLOP/s against 0.09 ms of HBM traffic, W-enc (whisper's encoder,
// 16 x 12 heads of 1500 x 1500 at D 64) 0.112 ms. The exp2 unit (MUFU.EX2,
// 16 a clock per SM against the tensor cores' 4,096 flops) needs 1/16 of a
// clock per score: half the products' time at D 128 and all of it at D 64,
// where W-enc's 4.3e8 scores also take 0.112 ms. flash_fwd_wgmma is built
// for both: wgmma is the only instruction that reaches the tensor cores'
// rate; one thread's TMA copies leave the math warps' registers and issue
// slots to the products; 64-row warpgroup tiles read each K/V tile from
// shared memory once per 64 query rows instead of once per 16; and the
// softmax of one tile runs under products in flight: at D 128 under the same
// group's P V, at D 64 under the other two groups' products, the groups
// issuing in turns. The exp2 is MUFU.EX2 alone (ex2.approx.ftz), with the
// scale folded into the multiply-add before it on interior tiles, so each
// score costs one exp2. Persistent CTAs load the next item's tiles while the
// last ones finish. At 32 queries (W-dec, W-cross) a 192-row tile has one
// group's rows; the others only keep the barriers.
//
// Driver API. The TMA descriptors (CUtensorMap) are encoded on the host for
// every call, since the pointers change, with cuTensorMapEncodeTiled. It is
// reached through the runtime's cudaGetDriverEntryPoint(ByVersion), so the
// library links no -lcuda; <cuda.h> supplies its types only. The SM count
// and each kernel's raised shared-memory limit are asked once per device
// and process (sm_count, allow_smem).
//
// Built with FMA contraction allowed (unlike quant8): the result is held to a
// tolerance, not bitwise. The f32 kernel uses expf, the bf16 kernels 2^x on
// scores scaled by log2(e) (exp2f in flash_fwd_bf16, ex2.approx.ftz in
// flash_fwd_wgmma). The final division stays IEEE (flash_fwd_wgmma:
// one IEEE reciprocal per row, then a multiply per element).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

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
// bf16, D 32: the two products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate). Each of the 4 warps owns 16 query rows of the 64-row tile; Q
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

// ---------------------------------------------------------------------------
// bf16, D 64, 128 and 256, for Hopper: flash_fwd_wgmma<D>.
//
// Persistent: one CTA per SM (at most) takes the work items, each a (b, h,
// query tile of kBQ = 64 x kGroups rows), in turn: w = blockIdx.x, +
// gridDim.x, ..., in work_item's order. A CTA is 1 + kGroups warpgroups
// (Tile<D> holds the counts of each head dim):
//   * Warpgroup 0 produces: one thread issues every TMA load, each item's Q
//     and then its K and V tiles of 128 keys x D into a ring of kStages
//     stages; setmaxnreg lowers the warpgroup to kProducerRegs registers.
//   * Warpgroups 1..kGroups consume, 64 query rows each, with setmaxnreg
//     raised to kConsumerRegs. S = Q K^T is wgmma m64n(kBK)k16 with Q and K
//     read from shared memory (D / 16 k-steps); the online softmax runs in
//     registers on the accumulator layout; O += P V is wgmma m64nDk16 with P
//     converted to bf16 in registers (the A operand) and V read from shared
//     memory as stored, keys x D with D contiguous (an MN-major B operand).
//     Tile i's S = Q K^T is issued together with tile i-1's P V. With two
//     groups at D <= 128 (kOverlap) tile i's softmax runs while that P V is
//     still in flight, which holds two sets of P fragments; with three,
//     whose 160 registers a thread cannot hold both, and at D 256, whose O
//     alone is 128 registers a thread, the softmax follows both products
//     and writes P over the fragments the P V read.
//   * The consumer groups issue their products in turns (FlashAttention-3's
//     ping-pong): group c issues once group c - 1 (cyclically) has issued,
//     through named barrier 1 + c (group c syncs on it with 128 threads,
//     group c - 1 arrives with 128 more after its issue). The tensor cores
//     then run the other groups' products while group c runs its exp2 pass,
//     and the groups do not all wait on the tensor cores, or all on the
//     exp2 unit, at once.
//   * A group whose 64 rows all lie at or past Sq (the decoder's and the
//     cross-attention's 32 queries fill a third of a 192-row tile) keeps its
//     barrier waits, arrivals and turns but issues no product.
// Barriers (mbarrier): Q full and Q empty (the next item's Q lands once every
// group's last S = Q K^T is done); per stage, K full and V full (the
// producer's expect-tx arrival plus the TMA bytes) and K empty and V empty
// (every consumer thread arrives once its wgmma group has been waited on).
// K and V have their own barriers so that S = Q K^T starts before V has
// landed and K is refilled while V is still read.
//
// Shared memory, 1024-byte aligned: Q (kBQ x D), then kStages K tiles and
// kStages V tiles (kBK x D each), then the barriers. Every tile arrives in
// TMA boxes of 64 dims (128 bytes a row, the 128-byte swizzle's span) and all
// its rows: one box at D 64, two at D 128, four at D 256, each a box's bytes
// after the one before. The wgmma descriptors follow that layout: K-major Q
// and K with 8-row groups 1024 bytes apart (SBO), a k-step of 16 dims 32
// bytes further along the row and the next box every 4 k-steps; MN-major V
// with 8-key groups 1024 bytes apart (SBO) and, at D 128 and 256, each next
// 64 dims in the next box (LBO, one box's bytes).
//
// The tensor maps view q, k and v as (D, S, H, B) with the caller's strides,
// so query head h reads KV head h / group with no copy, and TMA fills rows
// past S with zeros (a ragged tile never reads the next head's or batch's
// rows). Rows at or past Sq are not written. A barrier wait that has not
// completed after about 2^34 cycles traps: a wrong phase fails the launch
// instead of hanging the card.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBox = 64;                            // dims per TMA box
constexpr uint32_t kRowBytes = kBox * 2;            // 128: the swizzle's span

// The counts of each head dim, chosen by timing versions in turns with
// scripts/flash_ab.py (PERF.md): consumer warpgroups of 64 query rows, and
// the registers setmaxnreg gives a producer and a consumer thread (128
// producers and 128 x kGroups consumers share 65,536). Two K/V stages:
// four timed no faster at D 64.
//
// D 256 takes 64-key KV tiles: with 128 keys, Q (128 rows) and two stages of
// K and V would need 321 KB of shared memory; with 64 they need 193 KB. Its
// O accumulator is 128 f32 registers a thread (m64n256), so a group holds
// one set of P fragments (no kOverlap).
template <int D>
struct Tile {
  static_assert(D % kBox == 0, "D is a whole number of 64-dim TMA boxes");
  static constexpr int kGroups = D == 64 ? 3 : 2;
  static constexpr int kStages = 2;
  static constexpr int kBK = D == 256 ? 64 : 128;   // keys per KV tile
  static constexpr int kPSteps = kBK / 16;          // k-steps of P V
  static constexpr int kProducerRegs = kGroups == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kGroups == 3 ? 160 : 232;
  // tile i's softmax under the same group's P V of tile i - 1: two sets of
  // P fragments, which two groups' registers hold at D <= 128 and three
  // groups' (or D 256's accumulator) do not
  static constexpr bool kOverlap = kGroups == 2 && D <= 128;

  static constexpr int kBQ = 64 * kGroups;          // query rows per CTA
  static constexpr int kThreads = 128 * (1 + kGroups);
  static constexpr int kConsumers = 128 * kGroups;  // consumer threads
  static constexpr int kBoxes = D / kBox;           // TMA boxes per tile
  static constexpr uint32_t kKVBoxBytes = kBK * kRowBytes;
  static constexpr uint32_t kQBoxBytes = kBQ * kRowBytes;
  static constexpr uint32_t kQBytes = kBoxes * kQBoxBytes;
  static constexpr uint32_t kKVBytes = kBoxes * kKVBoxBytes;
  static constexpr uint32_t kBarBytes = 8 * (2 + 4 * kStages);
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536,
                "the register file");
  static_assert(kSmemBytes <= 232448, "227 KB of shared memory per block");
};

struct Params {
  void* o;
  Strides os;
  int b, h;                      // batch, query heads
  int kv_chunk;                  // (b, KV head) pairs per L2 chunk
  int sq, sk;
  int group;
  int causal;
  int window;                    // <= 0: no window
  float scale;
};

// One work item: a (b, h, kBQ-row query tile) and its KV tiles.
struct Item {
  int q0, h, b;
  int k_begin, n_tiles;
};

// Item w of a CTA's walk. The (b, KV head) pairs go in chunks of
// p.kv_chunk, whose K and V fit in L2 together; within a chunk the longest
// rows come first (the last query tiles, under a causal mask), then the
// pairs, then the query heads that read one KV head, side by side.
template <int kBQ, int kBK>
__device__ __forceinline__ Item work_item(int w, const Params& p) {
  const int nq = (p.sq + kBQ - 1) / kBQ, hkv = p.h / p.group;
  const int pairs = p.b * hkv, per_chunk = p.kv_chunk * nq * p.group;
  const int chunk = w / per_chunk, rem = w % per_chunk;
  const int in_chunk = min(p.kv_chunk, pairs - chunk * p.kv_chunk);
  const int qt = rem / (in_chunk * p.group), rem2 = rem % (in_chunk * p.group);
  const int pair = chunk * p.kv_chunk + rem2 / p.group;
  Item it;
  it.b = pair / hkv;
  it.h = pair % hkv * p.group + rem2 % p.group;
  it.q0 = (nq - 1 - qt) * kBQ;
  const int q_last = min(it.q0 + kBQ, p.sq) - 1;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  it.k_begin = p.window > 0 ? max(0, it.q0 - p.window + 1) / kBK * kBK : 0;
  it.n_tiles = k_end > it.k_begin ? (k_end - it.k_begin + kBK - 1) / kBK : 0;
  return it;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0)
      start = now;
    else if (now - start > (1ll << 34))
      __trap();
  }
}

// Named barriers 1..kGroups order the consumer groups' turns (barrier 0 is
// __syncthreads'): `threads` counts the syncing and the arriving threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One TMA box of the (D, S, H, B) tensor map at (d, s, h, b) into shared
// memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(h),
      "r"(b)
      : "memory");
}

// Every box of one tile (rows s.. of head h, batch b), box_bytes apart.
template <int kBoxes>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, uint32_t box_bytes,
                                         int s, int h, int b) {
  mbar_expect_tx(bar, kBoxes * box_bytes);
#pragma unroll
  for (int x = 0; x < kBoxes; ++x)
    tma_load(dst + x * box_bytes, map, bar, x * kBox, s, h, b);
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending wgmma groups of this warpgroup are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Orders the compiler's reads of the accumulators after the wgmma wait:
// wgmma writes them asynchronously, which the asm operands do not say.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments that an in-flight wgmma still reads: they stay
// in their registers until the wait.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// 2^x on the exp2 unit alone (MUFU.EX2, flushing results below 2^-126 to 0):
// exp2f adds a denormal fix-up around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Eight f32 accumulators of one thread as "+f" operands.
#define WG_ACC8(d, i)                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = (accumulate ? d : 0) + A (64 x 16, shared) . B (16 x
// 128, shared), both K-major (trans 0): S = Q K^T.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        WG_ACC8(d, 0),
        WG_ACC8(d, 8),
        WG_ACC8(d, 16),
        WG_ACC8(d, 24),
        WG_ACC8(d, 32),
        WG_ACC8(d, 40),
        WG_ACC8(d, 48),
        WG_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same over a 64-key tile (D 256): m64n64k16.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        WG_ACC8(d, 0),
        WG_ACC8(d, 8),
        WG_ACC8(d, 16),
        WG_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, this thread's registers) . B (16 x N,
// shared), B MN-major (trans 1): O += P V with V stored keys x D, N = D.
// D 64: m64n64k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        WG_ACC8(d, 0),
        WG_ACC8(d, 8),
        WG_ACC8(d, 16),
        WG_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D 128: m64n128k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        WG_ACC8(d, 0),
        WG_ACC8(d, 8),
        WG_ACC8(d, 16),
        WG_ACC8(d, 24),
        WG_ACC8(d, 32),
        WG_ACC8(d, 40),
        WG_ACC8(d, 48),
        WG_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D 256: m64n256k16.
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        WG_ACC8(d, 0),
        WG_ACC8(d, 8),
        WG_ACC8(d, 16),
        WG_ACC8(d, 24),
        WG_ACC8(d, 32),
        WG_ACC8(d, 40),
        WG_ACC8(d, 48),
        WG_ACC8(d, 56),
        WG_ACC8(d, 64),
        WG_ACC8(d, 72),
        WG_ACC8(d, 80),
        WG_ACC8(d, 88),
        WG_ACC8(d, 96),
        WG_ACC8(d, 104),
        WG_ACC8(d, 112),
        WG_ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A consumer thread's rows: it holds columns 8n + 2t + {0, 1} of rows row0
// (accumulator registers 4n, 4n + 1) and row1 (4n + 2, 4n + 3), n < N / 8.
struct Rows {
  int first;  // the warpgroup's first row
  int row0, row1, t;
  float sl2;  // scale * log2(e)
};

// The online softmax update on one tile's scores `sc` (keys k0..k0+kBK-1):
// scale, mask (edge tiles only), new row maxima m, correction factors c
// for the old accumulator and denominator, l updated with this tile's row
// sums (this thread's share), and P in bf16 as wgmma's A fragments (k-step
// j covers keys 16j..16j+15, the score columns of n-tiles 2j and 2j + 1).
template <int kBK>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             uint32_t (&pa)[kBK / 16][4],
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1,
                                             int k0, const Rows& r,
                                             const Params& p) {
  constexpr int kN = kBK / 2;  // this thread's scores
  const bool edge = k0 + kBK > p.sk ||
                    (p.causal && k0 + kBK - 1 > r.first) ||
                    (p.window > 0 && k0 <= r.first + 63 - p.window);
  // Edge tiles scale and mask each score into log2 units; interior tiles
  // keep the raw scores, take the maxima on them (the scale is positive)
  // and fold the scale into the exponent's multiply-add.
  float mx0 = kNegInf, mx1 = kNegInf;
  if (edge) {
    // each row sees the keys lo..hi: j < Sk, j <= row if causal, j > row -
    // window if windowed; offsets from this thread's first column
    const int c0k = k0 + 2 * r.t;
    const int hi0 = min(p.sk - 1, p.causal ? r.row0 : p.sk) - c0k;
    const int hi1 = min(p.sk - 1, p.causal ? r.row1 : p.sk) - c0k;
    const int lo0 = (p.window > 0 ? r.row0 - p.window + 1 : 0) - c0k;
    const int lo1 = (p.window > 0 ? r.row1 - p.window + 1 : 0) - c0k;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int col = 8 * (i / 4) + (i & 1);
      const bool ok = (i & 2) ? col >= lo1 && col <= hi1
                              : col >= lo0 && col <= hi0;
      sc[i] = ok ? sc[i] * r.sl2 : kNegInf;
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i & 2)
      mx1 = fmaxf(mx1, sc[i]);
    else
      mx0 = fmaxf(mx0, sc[i]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float f = edge ? 1.f : r.sl2;
  const float mn0 = fmaxf(m0, mx0 * f), mn1 = fmaxf(m1, mx1 * f);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    sc[i] = ex2(fmaf(sc[i], f, (i & 2) ? -mn1 : -mn0));
    if (i & 2)
      rs1 += sc[i];
    else
      rs0 += sc[i];
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<D>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + T::kQBytes + 2 * kStages * T::kKVBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto sK = [&](int s) { return base + T::kQBytes + s * T::kKVBytes; };
  auto sV = [&](int s) {
    return base + T::kQBytes + (kStages + s) * T::kKVBytes;
  };
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * kStages + s); };
  const int n_items = (p.sq + T::kBQ - 1) / T::kBQ * p.h * p.b;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, T::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), T::kConsumers);
      mbar_init(v_empty(s), T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     T::kProducerRegs)
                 : "memory");
    if (threadIdx.x == 0) {
      int gt = 0;  // KV tiles this CTA has loaded
      for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
        const Item item = work_item<T::kBQ, T::kBK>(w, p);
        const int hk = item.h / p.group;
        // the next item's Q once every group's last S = Q K^T is done
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
        tma_tile<T::kBoxes>(sQ, &tq, q_full, T::kQBoxBytes, item.q0, item.h,
                            item.b);
        for (int it = 0; it < item.n_tiles; ++it, ++gt) {
          const int s = gt % kStages;
          const uint32_t free_parity = ((gt / kStages) & 1) ^ 1;
          const int k0 = item.k_begin + it * T::kBK;
          mbar_wait(k_empty(s), free_parity);
          tma_tile<T::kBoxes>(sK(s), &tk, k_full(s), T::kKVBoxBytes, k0, hk,
                              item.b);
          mbar_wait(v_empty(s), free_parity);
          tma_tile<T::kBoxes>(sV(s), &tv, v_full(s), T::kKVBoxBytes, k0, hk,
                              item.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     T::kConsumerRegs)
                 : "memory");
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const uint64_t dq = smem_desc(sQ + 64 * c * kRowBytes, 16, 1024);

    // S = Q K^T of the tile in stage s: D / 16 k-steps, 4 per 64-dim box,
    // committed as one wgmma group and left in flight
    auto issue_qk = [&](float (&sc)[T::kBK / 2], int s) {
      const uint64_t dk = smem_desc(sK(s), 16, 1024);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t in_row = (ks % 4) * 32;
        wgmma_ss(sc, dq + (((ks / 4) * T::kQBoxBytes + in_row) >> 4),
                 dk + (((ks / 4) * T::kKVBoxBytes + in_row) >> 4), ks);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage s, 16 keys per k-step, in flight
    auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&pa)[T::kPSteps][4],
                        int s) {
      const uint64_t dv = smem_desc(sV(s), T::kKVBoxBytes, 1024);
#pragma unroll
      for (int j = 0; j < T::kPSteps; ++j)
        wgmma_rs(o, pa[j], dv + ((j * 16 * kRowBytes) >> 4));
      wgmma_commit();
    };
    // the groups' turns (ping-pong): wait for group c - 1's issue, then
    // let group c + 1 issue after this one
    auto turn_wait = [&] { named_sync(1 + c, 256); };
    auto turn_pass = [&] { named_arrive(1 + (c + 1) % T::kGroups, 256); };
    if (c == 0) named_arrive(1, 256);  // group 0 goes first

    // One item's n > 0 KV tiles in n + 1 turns (turn it issues tile it's
    // S = Q K^T and tile it - 1's P V), then its rows of O. `gt` counts the
    // KV tiles consumed before it. kActive is false for a group whose rows
    // all lie at or past Sq: it keeps every barrier wait, arrival and turn
    // and computes nothing.
    auto consume = [&](auto active, const Item& item, const Rows& r, int gt) {
      constexpr bool kActive = decltype(active)::value;
      const int n = item.n_tiles;
      auto stage = [&](int i) { return (gt + i) % kStages; };
      auto parity = [&](int i) { return ((gt + i) / kStages) & 1; };
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, c0, c1;
      auto rescale = [&] {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? c1 : c0;
      };
      uint32_t pa[T::kPSteps][4];  // P of the last tile, as wgmma's A fragments

      // tile 0: its scores, then its P
      {
        float sc[T::kBK / 2];
        mbar_wait(k_full(stage(0)), parity(0));
        __syncwarp();
        turn_wait();
        if constexpr (kActive) {
          wgmma_fence();
          issue_qk(sc, stage(0));
        }
        turn_pass();
        wgmma_wait<0>();
        mbar_arrive(k_empty(stage(0)));
        if (n == 1) mbar_arrive(q_empty);
        if constexpr (kActive) {
          fence_regs(sc);
          softmax_tile<T::kBK>(sc, pa, m0, m1, l0, l1, c0, c1, item.k_begin,
                               r, p);
        }
      }
      for (int it = 1; it < n; ++it) {
        const int s = stage(it), sp = stage(it - 1);
        float sc[T::kBK / 2];
        mbar_wait(k_full(s), parity(it));
        mbar_wait(v_full(sp), parity(it - 1));
        __syncwarp();
        turn_wait();
        if constexpr (kActive) {
          wgmma_fence();
          issue_qk(sc, s);
          issue_pv(o, pa, sp);
        }
        turn_pass();
        const int k0 = item.k_begin + it * T::kBK;
        if constexpr (T::kOverlap) {
          // tile it's softmax runs while tile it - 1's P V is in flight
          wgmma_wait<1>();
          mbar_arrive(k_empty(s));
          if (it == n - 1) mbar_arrive(q_empty);
          uint32_t pn[T::kPSteps][4];
          if constexpr (kActive) {
            fence_regs(sc);
            softmax_tile<T::kBK>(sc, pn, m0, m1, l0, l1, c0, c1, k0, r, p);
            // P is computed before the wait, under this tile's P V (the
            // compiler would otherwise sink the softmax below the wait)
            fence_frag(pn);
          }
          wgmma_wait<0>();
          mbar_arrive(v_empty(sp));
          if constexpr (kActive) {
            fence_regs(o);
            fence_frag(pa);
            rescale();
#pragma unroll
            for (int jj = 0; jj < T::kPSteps; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) pa[jj][e] = pn[jj][e];
          }
        } else {
          // both products first; the new P then takes the registers of the
          // one P V read, and the other groups' products run under this
          // group's softmax
          wgmma_wait<0>();
          mbar_arrive(k_empty(s));
          if (it == n - 1) mbar_arrive(q_empty);
          mbar_arrive(v_empty(sp));
          if constexpr (kActive) {
            fence_regs(sc);
            fence_regs(o);
            fence_frag(pa);
            softmax_tile<T::kBK>(sc, pa, m0, m1, l0, l1, c0, c1, k0, r, p);
            rescale();
          }
        }
      }
      // the last tile's P V
      const int sl = stage(n - 1);
      mbar_wait(v_full(sl), parity(n - 1));
      __syncwarp();
      turn_wait();
      if constexpr (kActive) {
        wgmma_fence();
        issue_pv(o, pa, sl);
      }
      turn_pass();
      wgmma_wait<0>();
      mbar_arrive(v_empty(sl));
      if constexpr (!kActive) return;
      fence_regs(o);
      fence_frag(pa);

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // O / max(l, 1e-30): one IEEE division per row, then multiplies
      const float inv0 = 1.f / fmaxf(l0, kMinDenom);
      const float inv1 = 1.f / fmaxf(l1, kMinDenom);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) +
                          item.b * p.os.b + item.h * p.os.h;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int dim = 8 * i + 2 * r.t;
        if (r.row0 < p.sq)
          *reinterpret_cast<__nv_bfloat162*>(og + r.row0 * p.os.s + dim) =
              __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        if (r.row1 < p.sq)
          *reinterpret_cast<__nv_bfloat162*>(og + r.row1 * p.os.s + dim) =
              __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
    };

    int gt = 0;  // KV tiles this CTA has consumed
    for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
      const Item item = work_item<T::kBQ, T::kBK>(w, p);
      Rows r;
      r.first = item.q0 + 64 * c;
      r.row0 = r.first + 16 * warp + (lane >> 2);
      r.row1 = r.row0 + 8;
      r.t = lane & 3;
      // scores in log2 units: exp(s - m) = exp2(s log2(e) - m log2(e))
      r.sl2 = p.scale * 1.4426950408889634f;
      mbar_wait(q_full, j & 1);
      __syncwarp();
      if (item.n_tiles == 0)
        mbar_arrive(q_empty);
      else if (r.first < p.sq)
        consume(std::true_type{}, item, r, gt);
      else
        consume(std::false_type{}, item, r, gt);
      gt += item.n_tiles;
    }
  }
}

// cuTensorMapEncodeTiled, found once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The (D, S, H, B) view of a bf16 tensor with d contiguous and (b, h, s)
// strides `st` (elements), in boxes of 64 dims x `rows` rows, 128-byte
// swizzled.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int d, int s, int h,
                     int b, const Strides& st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg

// Host answers that stay the same within a process, kept per device: the SM
// count, and for each kernel whether its dynamic shared memory limit has
// been raised (each launcher holds its own flags). Devices past kMaxDevices
// ask every time.
constexpr int kMaxDevices = 64;

cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cached[kMaxDevices];  // 0: not asked yet
  const bool keep = device < kMaxDevices;
  if (keep && (*sms = cached[device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && keep)
    cached[device].store(*sms, std::memory_order_relaxed);
  return err;
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on `device` (the
// current one), unless the launcher's flag for the device says it was.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, int device,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  const bool keep = device < kMaxDevices;
  if (keep && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && keep)
    done[device].store(true, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int b, int h, cudaStream_t stream) {
  using T = wg::Tile<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = wg::make_map(&tq, p.q, D, p.sq, h, b, p.qs, T::kBQ);
  if (err == cudaSuccess)
    err = wg::make_map(&tk, p.k, D, p.sk, h / p.group, b, p.ks, T::kBK);
  if (err == cudaSuccess)
    err = wg::make_map(&tv, p.v, D, p.sk, h / p.group, b, p.vs, T::kBK);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> smem_set[kMaxDevices];
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = allow_smem(wg::flash_fwd_wgmma<D>, T::kSmemBytes, device, smem_set);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  // (b, KV head) pairs whose K and V fit in 32 MiB of the 50 MB L2
  const int64_t kv_bytes = 2 * int64_t{p.sk} * D * 2;
  const int kv_chunk = static_cast<int>(
      std::max<int64_t>(1, (int64_t{32} << 20) / kv_bytes));
  const wg::Params wp{p.o,  p.os,    b,        h,        kv_chunk, p.sq,
                      p.sk, p.group, p.causal, p.window, p.scale};
  // persistent: one CTA per SM walks the work items
  const int items = (p.sq + T::kBQ - 1) / T::kBQ * h * b;
  wg::flash_fwd_wgmma<D><<<std::min(items, sms), T::kThreads, T::kSmemBytes,
                           stream>>>(tq, tk, tv, wp);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int b, int h, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static std::atomic<bool> smem_set[kMaxDevices];
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = allow_smem(flash_fwd_f32<D>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int b, int h, cudaStream_t stream) {
  const int smem = smem_bytes_bf16<D>();
  static std::atomic<bool> smem_set[kMaxDevices];
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = allow_smem(flash_fwd_bf16<D>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernels, in the order of the `variant` that flash_attention_fwd
// reports (the wrapper's VARIANTS).
enum Variant { kFmaF32 = 0, kMmaBf16 = 1, kWgmmaBf16 = 2 };

cudaError_t dispatch_f32(const Params& p, int b, int h, int d,
                         cudaStream_t stream, int* variant) {
  *variant = kFmaF32;
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

// bf16: D 64, 128 and 256 on the Hopper kernel, D 32 on the mma.sync kernel.
cudaError_t dispatch_bf16(const Params& p, int b, int h, int d,
                          cudaStream_t stream, int* variant) {
  *variant = d == 32 ? kMmaBf16 : kWgmmaBf16;
  switch (d) {
    case 32:
      return launch_bf16<32>(p, b, h, stream);
    case 64:
      return launch_wgmma<64>(p, b, h, stream);
    case 128:
      return launch_wgmma<128>(p, b, h, stream);
    case 256:
      return launch_wgmma<256>(p, b, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Replaces src/repro/kernels/flashattn.py:_flash_kernel (flash_attention).
// q: (B, H, Sq, D) through strides (q_sb, q_sh, q_ss) and d contiguous; k, v:
// (B, H / group, Sk, D) likewise; o like q. f32 (is_bf16 == 0) or bf16 for
// all four. D is 32, 64 or 128 (and 256 in bf16); window <= 0 means no
// window. *variant
// receives the kernel that was launched (enum Variant).
cudaError_t flash_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, int is_bf16, int b, int h, int group,
                                int sq, int sk, int d, int64_t q_sb,
                                int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                int64_t v_sh, int64_t v_ss, int64_t o_sb,
                                int64_t o_sh, int64_t o_ss, int causal,
                                int window, float scale, void* stream,
                                int* variant) {
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
  if (is_bf16) return dispatch_bf16(p, b, h, d, st, variant);
  return dispatch_f32(p, b, h, d, st, variant);
}

const char* flashattn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
