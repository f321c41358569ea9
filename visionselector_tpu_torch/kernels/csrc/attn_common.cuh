// Building blocks of the mma.sync decode kernel (decode_blocked_fwd.cu),
// and the helpers the wgmma kernels share (sm_90a).
//
// Tiles are 64 query rows by 64 key rows, bf16 in shared memory. The head
// dim D (a multiple of 8) is padded to Dp, the next multiple of 16 (one
// mma / wgmma k-step); D = 80 needs no padding (five k-steps); D = 24 is
// padded to 32 and its pad columns are never stored. A consumer
// warpgroup has four warps; warp w owns query rows [16w, 16w + 16) of the
// tile and does its own softmax.
//
// Products use mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Fragment
// layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with lane =
// 4 * g + t:
//   A (16x16, row): a[0] = (row g,   k 2t..2t+1), a[1] = (row g+8, k 2t..),
//                   a[2] = (row g,   k 2t+8..),   a[3] = (row g+8, k 2t+8..)
//   B (16x8, col):  b[0] = (k 2t..2t+1, col g),   b[1] = (k 2t+8.., col g)
//   C (16x8, f32):  c[0..1] = (row g, col 2t..2t+1), c[2..3] = (row g+8, ..)
// The C layout of two neighbouring n-blocks of S = Q K^T is exactly the A
// layout of P for P V, so P never leaves registers (wgmma's accumulator
// has the same layout per warp).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vst {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // query rows and key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // finite: max(-1e30, -1e30) - (-1e30) == 0
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dims {
  static_assert(D % 8 == 0 && D <= 128, "head dim: a multiple of 8, <= 128");
  static constexpr int kPad = (D + 15) / 16 * 16;  // Dp
  static constexpr int kLd = kPad + 8;              // shared row pitch
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed on load: with the lane addresses set up
// by the caller this yields the B fragments of V (keys x D) for two
// neighbouring n-blocks of 8 columns.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* smem) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte asynchronous copy; src_bytes == 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool pred) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write this warp's two output rows (bf16, the D real columns): o / l, and
// exact zeros where no key was valid (l == 0); o undivided where l stays 0
// because no exp ran (the ablation's kExp = false).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride,
                                           int row0, int n_rows,
                                           const float o[Dims<D>::kPad / 8][4],
                                           float l0, float l1, int lane) {
  const int t = lane & 3;
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  uint32_t* r0 = reinterpret_cast<uint32_t*>(out + (long long)row0 * row_stride);
  uint32_t* r1 =
      reinterpret_cast<uint32_t*>(out + (long long)(row0 + 8) * row_stride);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = (n * 8 + 2 * t) / 2;
    if (row0 < n_rows) r0[c] = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row0 + 8 < n_rows) r1[c] = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace vst
