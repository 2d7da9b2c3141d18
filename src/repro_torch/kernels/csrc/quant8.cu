// Block-wise symmetric int8 quantization kernels for Hopper (sm_90a).
//
// Hand-written CUDA ports of the four Pallas TPU kernels in
// src/repro/kernels/quant8.py. Each kernel names the TPU kernel it replaces.
// The buffer is viewed as (n_blocks, block) rows, one fp32 scale per row:
//
//   s = amax(|y|) / 127,  safe = s > 0 ? s : 1,
//   q = clip(round_half_even(y / safe), -127, 127)
//
// Mapping. One warp owns one quantization row; a CTA of TILE_ROWS = 8 warps
// owns the 8 rows that one Pallas grid step owned, so the grid is
// n_blocks / 8. A lane owns 4 consecutive elements of every 128-element
// chunk of the row (16-byte loads for f32, 8 bytes for bf16, 4 for int8);
// neighbouring lanes touch neighbouring addresses. The row's absolute
// maximum is reduced with __shfl_xor_sync. For block <= 1024 the row stays
// in registers between the max and the quantize pass; longer rows are read
// a second time (from L1/L2).
//
// Bound. All four kernels are memory-bound on an H100 (3.35 TB/s): a few
// flops per element against 3-11 bytes per element. The design reads every
// input once and writes every output once (the bytes the Python side counts
// as the bound), and keeps bf16 inputs in bf16 until they are in registers.
//
// Arithmetic that must match the plain PyTorch version bit for bit:
//   * IEEE division (__fdiv_rn), never a reciprocal multiply;
//   * round half to even (rintf), not roundf;
//   * no FMA contraction: the library is built with -fmad=false, so
//     y - q*s and acc + q*s round the product before the add, as the two
//     separate PyTorch ops do;
//   * a NaN in a row propagates into its scale, as torch.amax does.
//
// Sizes and offsets are 64-bit: the embedding bucket of a 64k-vocabulary,
// 4096-wide model alone holds 262,144,000 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 8;      // rows per CTA (quant8.TILE_ROWS)
constexpr int kWarp = 32;
constexpr int kChunk = 128;       // elements per warp-wide chunk (LANE)
constexpr int kMaxRegChunks = 8;  // rows up to 1024 elements stay in registers

__device__ __forceinline__ float nan_max(float a, float b) {
  // torch.amax / jnp.max semantics: a NaN operand wins
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 4 consecutive input elements widened to f32 in registers.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  v[0] = __bfloat162float(a.x); v[1] = __bfloat162float(a.y);
  v[2] = __bfloat162float(b.x); v[3] = __bfloat162float(b.y);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float quant_code(float y, float safe) {
  // torch.clip semantics: a NaN code (inf / inf) stays NaN, so the residual
  // of a row holding inf is NaN throughout, as in the plain version
  float q = rintf(__fdiv_rn(y, safe));
  return q != q ? q : fminf(fmaxf(q, -127.0f), 127.0f);
}

__device__ __forceinline__ void store_q4(int8_t* p, const float q[4]) {
  char4 c = make_char4((signed char)__float2int_rn(q[0]),
                       (signed char)__float2int_rn(q[1]),
                       (signed char)__float2int_rn(q[2]),
                       (signed char)__float2int_rn(q[3]));
  *reinterpret_cast<char4*>(p) = c;
}

// y = f32(x) (+ r) for the 4 elements at offset `off` of the row.
template <typename Tin, bool kEf>
__device__ __forceinline__ void load_y(const Tin* x, const float* r,
                                       int64_t off, float y[4]) {
  load4(x + off, y);
  if constexpr (kEf) {
    float rv[4];
    load4(r + off, rv);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = y[j] + rv[j];
  }
}

// Quantize one row per warp; with kEf also add the residual and write the
// new residual y - q*s. kRegChunks > 0: the row has exactly kRegChunks
// chunks and stays in registers; 0: any length, read twice.
template <typename Tin, bool kEf, int kRegChunks>
__global__ void __launch_bounds__(kTileRows * kWarp)
quantize_rows(const Tin* __restrict__ x, const float* __restrict__ r,
              int8_t* __restrict__ q, float* __restrict__ s,
              float* __restrict__ nr, int64_t n_blocks, int64_t block) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = (int64_t)blockIdx.x * kTileRows + threadIdx.x / kWarp;
  if (row >= n_blocks) return;
  const int64_t base = row * block + lane * 4;
  const int64_t n_chunks = block / kChunk;

  float amax = 0.0f;
  float y[kRegChunks > 0 ? kRegChunks : 1][4];
  if constexpr (kRegChunks > 0) {
#pragma unroll
    for (int c = 0; c < kRegChunks; ++c) {
      load_y<Tin, kEf>(x, r, base + c * kChunk, y[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = nan_max(amax, fabsf(y[c][j]));
    }
  } else {
    for (int64_t c = 0; c < n_chunks; ++c) {
      float v[4];
      load_y<Tin, kEf>(x, r, base + c * kChunk, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = nan_max(amax, fabsf(v[j]));
    }
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(amax, 127.0f);
  const float safe = scale > 0.0f ? scale : 1.0f;
  if (lane == 0) s[row] = scale;

  auto emit = [&](int64_t off, const float v[4]) {
    float qv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) qv[j] = quant_code(v[j], safe);
    store_q4(q + off, qv);
    if constexpr (kEf) {
      float rv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) rv[j] = v[j] - qv[j] * scale;
      store4(nr + off, rv);
    }
  };
  if constexpr (kRegChunks > 0) {
#pragma unroll
    for (int c = 0; c < kRegChunks; ++c) emit(base + c * kChunk, y[c]);
  } else {
    for (int64_t c = 0; c < n_chunks; ++c) {
      float v[4];
      load_y<Tin, kEf>(x, r, base + c * kChunk, v);
      emit(base + c * kChunk, v);
    }
  }
}

// out = q * s[row] (kAcc: acc + q * s[row]), one row per warp.
template <bool kAcc>
__global__ void __launch_bounds__(kTileRows * kWarp)
dequantize_rows(const int8_t* __restrict__ q, const float* __restrict__ s,
                const float* __restrict__ acc, float* __restrict__ out,
                int64_t n_blocks, int64_t block) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row = (int64_t)blockIdx.x * kTileRows + threadIdx.x / kWarp;
  if (row >= n_blocks) return;
  const float scale = s[row];
  const int64_t base = row * block + lane * 4;
  for (int64_t off = base; off < (row + 1) * block; off += kChunk) {
    char4 c = *reinterpret_cast<const char4*>(q + off);
    float v[4] = {(float)c.x * scale, (float)c.y * scale, (float)c.z * scale,
                  (float)c.w * scale};
    if constexpr (kAcc) {
      float a[4];
      load4(acc + off, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = a[j] + v[j];
    }
    store4(out + off, v);
  }
}

inline dim3 grid_for(int64_t n_blocks) {
  return dim3((unsigned)(n_blocks / kTileRows));
}

template <typename Tin, bool kEf>
cudaError_t launch_quantize(const void* x, const float* r, int8_t* q, float* s,
                            float* nr, int64_t n_blocks, int64_t block,
                            cudaStream_t stream) {
  const Tin* xt = static_cast<const Tin*>(x);
  const dim3 grid = grid_for(n_blocks);
  const dim3 threads(kTileRows * kWarp);
  switch (block / kChunk) {
#define REPRO_QUANT8_CASE(C)                                              \
  case C:                                                                 \
    quantize_rows<Tin, kEf, C><<<grid, threads, 0, stream>>>(             \
        xt, r, q, s, nr, n_blocks, block);                                \
    break;
    REPRO_QUANT8_CASE(1)
    REPRO_QUANT8_CASE(2)
    REPRO_QUANT8_CASE(3)
    REPRO_QUANT8_CASE(4)
    REPRO_QUANT8_CASE(5)
    REPRO_QUANT8_CASE(6)
    REPRO_QUANT8_CASE(7)
    REPRO_QUANT8_CASE(kMaxRegChunks)
#undef REPRO_QUANT8_CASE
    default:
      quantize_rows<Tin, kEf, 0><<<grid, threads, 0, stream>>>(
          xt, r, q, s, nr, n_blocks, block);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Replaces src/repro/kernels/quant8.py:_quantize_kernel (quantize_blocks and
// its alias quantize_cast_blocks). x: (n_blocks, block) f32 or bf16
// (x_is_bf16 != 0), q int8 of the same shape, s f32 (n_blocks,).
cudaError_t quant8_quantize(const void* x, int x_is_bf16, void* q, void* s,
                            int64_t n_blocks, int64_t block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (x_is_bf16)
    return launch_quantize<__nv_bfloat16, false>(x, nullptr, qp, sp, nullptr,
                                                 n_blocks, block, st);
  return launch_quantize<float, false>(x, nullptr, qp, sp, nullptr, n_blocks,
                                       block, st);
}

// Replaces src/repro/kernels/quant8.py:_quantize_ef_kernel (quantize_ef_blocks):
// y = f32(x) + r; (q, s) = quantize(y); nr = y - q*s, in one pass.
cudaError_t quant8_quantize_ef(const void* x, int x_is_bf16, const void* r,
                               void* q, void* s, void* nr, int64_t n_blocks,
                               int64_t block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  float* nrp = static_cast<float*>(nr);
  if (x_is_bf16)
    return launch_quantize<__nv_bfloat16, true>(x, rp, qp, sp, nrp, n_blocks,
                                                block, st);
  return launch_quantize<float, true>(x, rp, qp, sp, nrp, n_blocks, block, st);
}

// Replaces src/repro/kernels/quant8.py:_dequantize_kernel (dequantize_blocks):
// out = q * s[:, None] in f32.
cudaError_t quant8_dequantize(const void* q, const void* s, void* out,
                              int64_t n_blocks, int64_t block, void* stream) {
  dequantize_rows<false><<<grid_for(n_blocks), kTileRows * kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s), nullptr,
      static_cast<float*>(out), n_blocks, block);
  return cudaGetLastError();
}

// Replaces src/repro/kernels/quant8.py:_dequant_accum_kernel
// (dequantize_accumulate_blocks): out = acc + q * s[:, None] in f32.
cudaError_t quant8_dequantize_accumulate(const void* q, const void* s,
                                         const void* acc, void* out,
                                         int64_t n_blocks, int64_t block,
                                         void* stream) {
  dequantize_rows<true><<<grid_for(n_blocks), kTileRows * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const float*>(acc), static_cast<float*>(out), n_blocks,
      block);
  return cudaGetLastError();
}

const char* quant8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
