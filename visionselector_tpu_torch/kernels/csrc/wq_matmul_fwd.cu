// wq_matmul_fwd: weight-only quantized matrix product for decode rows.
//
// Replaces no TPU kernel. The reference's `_dense`
// (visionselector_tpu/models/qwen25vl/lm.py:124-157) leaves its int8 or
// packed int4 decoder kernels in HBM and lets XLA fuse the convert (and,
// with grouped scales, the multiply) into the dot's operand read. PyTorch
// has no such fusion: `x @ w.to(bf16)` writes a bf16 copy of the weight
// and reads it back, 5 bytes a weight instead of 1. This kernel keeps the
// weight in its stored bits and widens it in registers.
//
// Semantics (identical to the plain PyTorch version `wq_matmul_plain`):
// y[M, N] = x[M, K] @ dequant(Wq)[K, N], x and y bf16 (M <= 32 rows), Wq
// int8 [K, N] or packed int4 uint8 [K, N / 2] (byte j of a row holds column
// 2j in its low nibble and column 2j + 1 in its high nibble, each a 4-bit
// two's complement number), fp32 scales [N] (per output channel) or, with
// int4, [G, N] (one row per `group` = K / G inputs). Per channel the fp32 sum of
// x * q is rounded to bf16 and multiplied by bf16(s), the reference's
// `(x @ w.astype(bf16)) * s.astype(bf16)`; grouped, each weight becomes
// bf16(q) * bf16(s_g) rounded to bf16 before the product, the reference's
// `x @ (w.astype(bf16) * s.astype(bf16))`. Sums are fp32.
//
// What bounds it on the H100: at M <= 32 rows a weight byte takes at most
// 64 flop, far below the ~295 a byte the tensor cores need, so the bound
// is the bytes: Wq + scales + x + y, over 3.35 TB/s (the 3B decoder's
// 2.775 B int8 weights: 0.83 ms a decode step). The design, simple first:
//
// * A block of 8 warps owns 32 output columns and every k row, so each
//   weight byte is read from device memory once per call; grid
//   ceil(N / 32). Rows of K go in chunks of 256: warp w takes rows
//   [32 w, 32 w + 32) of each chunk (K split across warps).
// * Loads: each lane reads 16 bytes of consecutive output columns of one
//   k row (16 int8 columns, or 32 int4 columns) into registers; the next
//   chunk's loads are issued before the current chunk is computed. A
//   warp's rows go to its own part of shared memory, from where lane c
//   reads column c of each row and widens it in registers.
// * The chunk's x rows sit in shared memory as fp32, [256][MP] (MP = M
//   rounded up to a power of two), thread t holding column k = t of the
//   chunk (loaded with the weights, one chunk ahead), read as float4
//   broadcasts: each lane keeps MP fp32 accumulators for its column. A
//   grouped scale is read once per group boundary a warp's rows cross.
// * After the last chunk the 8 warps' partial sums are added through
//   shared memory (16 rows at a time), the per-channel scale is applied
//   and y is written.
// No wgmma, no TMA: making it fast is later work.
//
// `fault` plants an error for the checks: 1 skips the last k chunk, 2 swaps
// the two nibbles of an int4 byte, 3 reads group g with group g + 1's scale
// (the last group keeps its own). The model always passes 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vst_wq {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;       // output columns per block
constexpr int kWarpRows = 32;   // k rows per warp per chunk
constexpr int kChunk = kWarps * kWarpRows;
constexpr int kMaxRows = 32;
constexpr int kRedRows = 16;    // accumulator rows reduced per pass

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int BITS, bool GROUPED, int MP>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, bf16* __restrict__ y,
                 int M, int K, int N, int group, int vec, int fault) {
  static_assert(kChunk == kThreads, "one x column of a chunk per thread");
  constexpr int kRowBytes = kCols * BITS / 8;          // 32 or 16
  constexpr int kLanesPerRow = kRowBytes / 16;         // 2 or 1
  constexpr int kRowsPerPass = 32 / kLanesPerRow;      // 16 or 32
  constexpr int kPasses = kWarpRows / kRowsPerPass;    // 2 or 1
  // x rows of a chunk in shared memory as fp32, one k per row of MP
  // values; the 4 pad floats keep the threads' float4 stores off each
  // other's banks
  constexpr int kXStride = MP >= 4 ? MP + 4 : MP;
  constexpr int kXsBytes = kChunk * kXStride * 4;
  constexpr int kWsBytes = kWarps * kWarpRows * kRowBytes;
  constexpr int kRedBytes = kWarps * kRedRows * 32 * 4;
  constexpr int kSmem =
      kXsBytes + kWsBytes > kRedBytes ? kXsBytes + kWsBytes : kRedBytes;
  __shared__ __align__(16) unsigned char smem[kSmem];
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* ws_all = smem + kXsBytes;
  float* red = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col = blockIdx.x * kCols + lane;
  const long long row_bytes = BITS == 8 ? (long long)N : (long long)N / 2;
  const long long col_byte0 = (long long)blockIdx.x * kRowBytes;
  unsigned char* ws = ws_all + warp * kWarpRows * kRowBytes;
  const int G = GROUPED ? K / group : 1;

  int n_chunks = (K + kChunk - 1) / kChunk;
  if (fault == 1) n_chunks -= 1;

  // Lane l's part of a pass: tile row l / kLanesPerRow, bytes
  // [16 (l % kLanesPerRow), + 16) of that row.
  const int my_row = lane / kLanesPerRow;
  const int my_boff = (lane % kLanesPerRow) * 16;
  uint4 regs[kPasses];
  float xreg[MP];

  // The chunk's weight bytes and this thread's x column (k = chunk * 256 +
  // tid, every row), into registers.
  auto load_regs = [&](int chunk) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kRowsPerPass + my_row;
      const long long k = (long long)chunk * kChunk + warp * kWarpRows + r;
      const long long b0 = col_byte0 + my_boff;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K) {
        const uint8_t* src = w + k * row_bytes + b0;
        if (vec && b0 + 16 <= row_bytes) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          union { uint4 u; unsigned char c[16]; } t;
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            t.c[b] = b0 + b < row_bytes ? src[b] : 0;
          }
          v = t.u;
        }
      }
      regs[p] = v;
    }
    const int k = chunk * kChunk + tid;
#pragma unroll
    for (int m = 0; m < MP; ++m) {
      xreg[m] = (m < M && k < K)
                    ? __bfloat162float(x[(long long)m * K + k]) : 0.f;
    }
  };

  float acc[MP];
#pragma unroll
  for (int m = 0; m < MP; ++m) acc[m] = 0.f;

  if (n_chunks > 0) load_regs(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int kc = c * kChunk;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kRowsPerPass + my_row;
      *reinterpret_cast<uint4*>(ws + r * kRowBytes + my_boff) = regs[p];
    }
    float* xdst = xs + tid * kXStride;
    if constexpr (MP >= 4) {
#pragma unroll
      for (int j = 0; j < MP / 4; ++j) {
        reinterpret_cast<float4*>(xdst)[j] = make_float4(
            xreg[4 * j], xreg[4 * j + 1], xreg[4 * j + 2], xreg[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < MP; ++m) xdst[m] = xreg[m];
    }
    __syncthreads();
    if (c + 1 < n_chunks) load_regs(c + 1);

    // Grouped scales: the group of the warp's first row, then one step
    // at each group boundary (rows go up by one).
    const int k0 = kc + warp * kWarpRows;
    int g = 0, g_end = 0;
    float sb = 0.f;
    auto group_scale = [&](int gg) {
      if (fault == 3 && gg + 1 < G) gg += 1;
      return col < N ? bf16_round(__ldg(scale + (long long)gg * N + col))
                     : 0.f;
    };
    if (GROUPED && k0 < K) {
      g = k0 / group;
      g_end = (g + 1) * group;
      sb = group_scale(g);
    }
#pragma unroll 4
    for (int r = 0; r < kWarpRows; ++r) {
      const int kk = warp * kWarpRows + r;
      const int k = kc + kk;
      if (k >= K) break;
      int q;
      if (BITS == 8) {
        q = static_cast<int>(static_cast<signed char>(ws[r * kRowBytes + lane]));
      } else {
        const int byte = ws[r * kRowBytes + (lane >> 1)];
        const int shift = ((lane & 1) ^ (fault == 2 ? 1 : 0)) * 4;
        q = (((byte >> shift) & 15) ^ 8) - 8;
      }
      float wv = static_cast<float>(q);
      if (GROUPED) {
        if (k >= g_end) {
          ++g;
          g_end += group;
          sb = group_scale(g);
        }
        wv = bf16_round(wv * sb);
      }
      const float* xr = xs + kk * kXStride;
      if constexpr (MP >= 4) {
#pragma unroll
        for (int j = 0; j < MP / 4; ++j) {
          const float4 v = reinterpret_cast<const float4*>(xr)[j];
          acc[4 * j] = fmaf(v.x, wv, acc[4 * j]);
          acc[4 * j + 1] = fmaf(v.y, wv, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(v.z, wv, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(v.w, wv, acc[4 * j + 3]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m] = fmaf(xr[m], wv, acc[m]);
      }
    }
    __syncthreads();
  }

  // Add the warps' partial sums, 16 rows at a time, and write y.
#pragma unroll
  for (int base = 0; base < MP; base += kRedRows) {
#pragma unroll
    for (int i = 0; i < kRedRows; ++i) {
      if (base + i < MP) {
        red[(warp * kRedRows + i) * 32 + lane] = acc[base + i];
      }
    }
    __syncthreads();
    for (int o = tid; o < kRedRows * 32; o += kThreads) {
      const int i = o >> 5;
      const int cl = o & 31;
      const int m = base + i;
      const int n = blockIdx.x * kCols + cl;
      if (m < M && m < MP && n < N) {
        float sum = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) {
          sum += red[(ww * kRedRows + i) * 32 + cl];
        }
        float out;
        if (GROUPED) {
          out = sum;
        } else {
          out = bf16_round(sum) * bf16_round(__ldg(scale + n));
        }
        y[(long long)m * N + n] = __float2bfloat16(out);
      }
    }
    __syncthreads();
  }
}

template <int BITS, bool GROUPED>
cudaError_t launch_rows(const bf16* x, const uint8_t* w, const float* s,
                        bf16* y, int M, int K, int N, int group, int vec,
                        int fault, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols);
  const dim3 block(kThreads);
#define VST_WQ_LAUNCH(MP)                                                 \
  wq_matmul_kernel<BITS, GROUPED, MP><<<grid, block, 0, stream>>>(        \
      x, w, s, y, M, K, N, group, vec, fault)
  if (M <= 1) {
    VST_WQ_LAUNCH(1);
  } else if (M <= 2) {
    VST_WQ_LAUNCH(2);
  } else if (M <= 4) {
    VST_WQ_LAUNCH(4);
  } else if (M <= 8) {
    VST_WQ_LAUNCH(8);
  } else if (M <= 16) {
    VST_WQ_LAUNCH(16);
  } else {
    VST_WQ_LAUNCH(32);
  }
#undef VST_WQ_LAUNCH
  return cudaGetLastError();
}

}  // namespace vst_wq

// bits 8 or 4; group 0 for per-channel scales [N], else (int4 only) the
// group size of scales [K / group, N]. x [M, K] and y [M, N] are contiguous bf16, w is
// [K, N] int8 or [K, N / 2] packed int4, contiguous.
extern "C" int vst_wq_matmul_fwd(const void* x, const void* w,
                                 const void* scale, void* y, int M, int K,
                                 int N, int bits, int group, int fault,
                                 void* stream) {
  using namespace vst_wq;
  // grouped scales come only with int4 (the specs are int8, int4, int4:gN)
  if (M < 1 || M > kMaxRows || K < 1 || N < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && N % 2) || group < 0 || (group && K % group) ||
      (bits == 8 && group)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = bits == 8 ? (long long)N : (long long)N / 2;
  const int vec =
      row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 8) {
    err = launch_rows<8, false>(xp, wp, sp, yp, M, K, N, 0, vec, fault, st);
  } else if (group == 0) {
    err = launch_rows<4, false>(xp, wp, sp, yp, M, K, N, 0, vec, fault, st);
  } else {
    err = launch_rows<4, true>(xp, wp, sp, yp, M, K, N, group, vec, fault,
                               st);
  }
  return (int)err;
}
