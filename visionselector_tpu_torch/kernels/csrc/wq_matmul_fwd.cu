// Weight-only quantized products on Hopper: wq_matmul_fwd (kernel A, decode
// rows) and wq_dequant_fwd (kernel B, the dequantize route's transient).
//
// Replaces no TPU kernel. The reference's `_dense`
// (visionselector_tpu/models/qwen25vl/lm.py:124-157) leaves its int8 or
// packed int4 decoder kernels in HBM and lets XLA fuse the convert (and,
// with grouped scales, the multiply) into the dot's operand read. PyTorch
// has no such fusion: `x @ w.to(bf16)` writes a bf16 copy of the weight
// and reads it back, 5 bytes a weight instead of 1.
//
// Semantics (kernels/wq_matmul.py holds the plain versions): Wq int8 [K, N]
// or packed int4 uint8 [K, N / 2] (byte j of a row holds column 2j in its
// low nibble and column 2j + 1 in its high nibble, each a 4-bit two's
// complement number), fp32 scales [N] (per output channel) or, with int4,
// [G, N] (one row per `group` = K / G inputs). Kernel A: y[M, N] =
// x[M, K] @ Wq, x and y bf16, M <= 64: per channel bf16(sum x q) * bf16(s)
// rounded to bf16, the reference's `(x @ w.astype(bf16)) * s.astype(bf16)`;
// grouped, each weight bf16(bf16(q) * bf16(s_g)) before the product, the
// reference's `x @ (w.astype(bf16) * s.astype(bf16))`. Sums are fp32.
// Kernel B: the [K, N] bf16 transient of the dequantize route, bf16(q) per
// channel (the scale follows the product), bf16(q * bf16(s_g)) grouped,
// bit-equal to `wq_matmul.dequantize`.
//
// What bounds them on the H100: at M <= 64 rows a weight takes at most
// 128 flop, below the ~295 a byte the tensor cores need, so kernel A's
// bound is its bytes: Wq + scales + x + y over 3.35 TB/s (the 3B decoder
// layer's seven products: 0.0231 ms int8, 0.0116 int4). Kernel B is
// elementwise: Wq + scales + the transient (3 bytes a weight int8, 2.5
// int4, in bf16).
//
// Kernel A's design:
// * The card is filled at every shape: the host plan (`wq_plan`) cuts N
//   into column tiles of 8 lanes x CT columns (the widest that still
//   gives enough blocks, up to `wide_ct`: 128-byte tile rows where the
//   accumulators allow; down to 16 columns for narrow N or few groups)
//   and K into splits of whole 64-row units (whole groups under groups),
//   at least one block per SM and two where the shape allows. A block's 4
//   warps split its k rows again in 16-row steps.
// * Bytes in flight: each warp streams its weight tile (16-byte coalesced
//   `cp.async`, 8 or 4 bytes where a stored row is not a multiple of 16)
//   and its x tile through a 4-stage ring in shared memory, 32 k rows a
//   stage, rows past the warp's range zero-filled. Weight rows of 16
//   bytes or more sit in an XOR-swizzled layout (16-byte chunks within a
//   128-byte line), so the lanes' reads below hit distinct banks.
// * Tensor cores: mma.sync m16n8k16 with the weight as A ("swap AB": 16
//   output columns on A's rows, 8 x rows on B's columns). A lane (g, t)
//   reads 4 k rows (4t .. 4t + 3 of a 16-row step) of its own CT columns;
//   logical k pair (2t, 2t + 1) is stored row pair (4t, 4t + 1) and
//   (2t + 8, 2t + 9) is (4t + 2, 4t + 3), so x's B fragment is one 8-byte
//   read of 4 consecutive k, and the weight needs no transpose: the two
//   rows' bytes of one column widen into one bf16x2 register. int8 widens
//   exactly through an fp32 magic number (prmt into 0x4B0000xx, one fadd,
//   the high halves of two rows packed by one prmt); int4 through a bf16
//   magic number (prmt interleaves the two rows, lop3 masks a nibble pair
//   into 0x43xx with its sign bit flipped, one bf16x2 fma subtracts 136).
//   Groups multiply by bf16(s_g) with one bf16x2 fma (single rounding, as
//   the reference), the scales for the next stage's group loaded a stage
//   ahead.
// * Reduction: the 4 warps' fp32 sums add in shared memory in warp order;
//   with one split the block writes y. Else the K splits of a column tile
//   are one thread-block cluster (at most 16 blocks, as K5 merges its
//   splits): after a cluster barrier rank r reads its slice of the tile's
//   outputs from every rank's shared memory (`mapa` +
//   `ld.shared::cluster`) and adds them in rank order: deterministic, no
//   global round trip, no float atomics. The per-channel scale is applied
//   once, after the whole sum.
//
// `fault` plants an error for the checks: 1 skips the last 16 k rows, 2
// swaps the two nibbles of an int4 byte, 3 reads group g with group g + 1's
// scale (the last group keeps its own), 4 drops one K split's partial
// (split 0's, or with one split warp 0's). The model always passes 0.
//
// Kernel B: one thread per 8 columns (8 or 4 stored bytes in, 16 bf16
// bytes out), each warp load and store one contiguous run, widened by the
// same magic numbers (pairs of adjacent columns).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace vst_wq {

typedef __nv_bfloat16 bf16;

// wq_matmul.py's plan mirrors these (WQ_WARPS, WQ_STAGES, WQ_STAGE_ROWS).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr int kStageRows = 32;
constexpr int kMaxRows = 64;
constexpr int kSplitRows = 64;
constexpr int kMaxSplits = 16;  // a cluster's blocks (non-portable size)

// The most columns a lane takes at a row tile: the widest whose
// accumulators (CT * MT / 4 a lane) stay within 128 registers, up to 16
// stored bytes a row (a 128-byte tile row). A plan takes this, a half or a
// quarter of it (never 4), or 2.
constexpr int wide_ct(int bits, int mt) {
  return bits == 8 ? (mt <= 32 ? 16 : 8) : (mt <= 8 ? 32 : mt <= 32 ? 16 : 8);
}

template <int BITS, int CT, int MT>
struct Cfg {
  static constexpr int BN = 8 * CT;                // columns of a tile
  static constexpr int RB = BN * BITS / 8;         // stored bytes of a tile row
  static constexpr int CB = CT * BITS / 8;         // bytes a lane reads a row
  static constexpr int WBYTES = kStageRows * RB;   // weights of a stage
  static constexpr int XBYTES = kStageRows * MT * 2;
  static constexpr int STAGE = WBYTES + XBYTES;
  static constexpr int RING = kWarps * kStages * STAGE;
  static constexpr int RED = kWarps * MT * BN * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES, zero-filled when !valid (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of stage byte `off` (in row r of RB bytes): the 16-byte
// chunk index within its 128-byte line XOR 2 * ((r >> 2) & 3), a
// permutation of each line's chunks for rows of 16 bytes or more; rows of
// 8 bytes (two to a chunk) stay in place.
template <int RB>
__device__ __forceinline__ int swz(int r, int off) {
  if constexpr (RB < 16) {
    return off;
  } else {
    const int c = ((off >> 4) ^ (2 * ((r >> 2) & 3))) & 7;
    return (off & ~127) | (c << 4) | (off & 15);
  }
}

__device__ __forceinline__ uint32_t lop3_and_xor(uint32_t a, uint32_t b,
                                                 uint32_t c) {
  uint32_t d;  // (a & b) ^ c
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of shared address `a` in block `rank` of the
// cluster, and a load from it.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t bf16x2_of(float v) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  return b | (b << 16);
}

// Words a lane holds of one row: CB stored bytes, at least one word.
template <int CB>
constexpr int kWords = CB >= 4 ? CB / 4 : 1;

// CB stored bytes of one row into w (the low bytes of w[0] below 4).
template <int CB>
__device__ __forceinline__ void lds_row(const unsigned char* p,
                                        uint32_t (&w)[kWords<CB>]) {
  if constexpr (CB == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else if constexpr (CB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (CB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (CB == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *p;
  }
}

// Four rows' bytes of a lane's CT columns -> bf16x2 registers: a01[c] =
// (row 0, row 1) of column c, a23[c] = (row 2, row 3).
template <int BITS, int CT, int NW>
__device__ __forceinline__ void widen(const uint32_t (&w)[4][NW],
                                      uint32_t (&a01)[CT],
                                      uint32_t (&a23)[CT]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t* dst = h ? a23 : a01;
    if constexpr (BITS == 8) {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        // 0x4B0000uu = 2^23 + u with u = q + 128; less 2^23 + 128 = q
        const uint32_t u0 = w[2 * h][c >> 2] ^ 0x80808080u;
        const uint32_t u1 = w[2 * h + 1][c >> 2] ^ 0x80808080u;
        const float f0 =
            __uint_as_float(__byte_perm(u0, 0x4B000000u, 0x7650 | (c & 3))) -
            8388736.f;
        const float f1 =
            __uint_as_float(__byte_perm(u1, 0x4B000000u, 0x7650 | (c & 3))) -
            8388736.f;
        // integers below 2^8: the high halves are their exact bf16
        dst[c] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        // a word's bytes 0-1 (P) or 2-3 (Q) of row 0 low, of row 1 high
        const uint32_t pq =
            __byte_perm(w[2 * h][c >> 3], w[2 * h + 1][c >> 3],
                        (c & 7) < 4 ? 0x5410 : 0x7632);
        const uint32_t src = pq >> (4 * (c & 3));
        // 0x4300 | (nibble ^ 8) = 128 + q + 8, exact; less 136 = q
        const uint32_t v = lop3_and_xor(src, 0x000F000Fu, 0x43084308u);
        dst[c] = bf2_fma(v, 0x3F803F80u, 0xC308C308u);
      }
    }
  }
}

template <int BITS, bool GROUPED, int CT, int MT>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, bf16* __restrict__ y, int M,
                 int K, int N, int group, int split_rows, int cp,
                 int fault) {
  using C = Cfg<BITS, CT, MT>;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const long long row_bytes = BITS == 8 ? (long long)N : (long long)N / 2;
  const int col0 = tile * C::BN;
  const long long byte0 = (long long)tile * C::RB;

  // This warp's k rows: the block's split, cut into 16-row steps.
  const int kb = split * split_rows;
  const int ke = min(K, kb + split_rows);
  const int steps = (ke - kb + 15) >> 4;
  const int wk0 = min(ke, kb + 16 * (warp * steps / kWarps));
  const int wk1 = min(ke, kb + 16 * ((warp + 1) * steps / kWarps));
  const int n_st = (wk1 - wk0 + kStageRows - 1) / kStageRows;
  const int last16 = ((K - 1) >> 4) << 4;
  unsigned char* ring = smem + warp * kStages * C::STAGE;

  // Stage j's copies (always one commit group, maybe empty).
  auto issue = [&](int j) {
    if (j < n_st) {
      unsigned char* st = ring + (j % kStages) * C::STAGE;
      const uint32_t sw = smem_u32(st);
      const int ks = wk0 + j * kStageRows;
      auto weights = [&](auto bytes) {
        constexpr int CP = decltype(bytes)::value;
        if constexpr (CP <= C::RB) {
          constexpr int per_row = C::RB / CP;
          for (int ci = lane; ci < kStageRows * per_row; ci += 32) {
            const int r = ci / per_row;
            const int b = (ci % per_row) * CP;
            const int k = ks + r;
            if (byte0 + b < row_bytes) {
              const bool ok = k < wk1;
              const uint8_t* src =
                  ok ? w + (long long)k * row_bytes + byte0 + b : w;
              cp_async<CP>(sw + swz<C::RB>(r, r * C::RB + b), src, ok);
            }
          }
        }
      };
      if (cp == 16) {
        weights(std::integral_constant<int, 16>());
      } else if (cp == 8) {
        weights(std::integral_constant<int, 8>());
      } else {
        weights(std::integral_constant<int, 4>());
      }
      // x: [steps][MT rows][16 k] bf16, 16-byte chunks of 8 k
      for (int ci = lane; ci < MT * (kStageRows / 8); ci += 32) {
        const int m = (ci >> 1) % MT;
        const int k = ks + ((ci >> 1) / MT) * 16 + (ci & 1) * 8;
        if (m < M) {
          const bool ok = k < wk1;
          cp_async<16>(sw + C::WBYTES + ci * 16,
                       ok ? x + (long long)m * K + k : x, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[MT / 8][CT / 2][4];
#pragma unroll
  for (int q = 0; q < MT / 8; ++q) {
#pragma unroll
    for (int p = 0; p < CT / 2; ++p) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][p][e] = 0.f;
    }
  }

  // Grouped scales: bf16x2 (s, s) of the lane's columns for group cur_g;
  // the raw scales of group pre_g, loaded when cur_g's are taken.
  const int G = GROUPED ? K / group : 1;
  uint32_t sc[CT];
  float pre[CT];
  int cur_g = -1, pre_g = -1;
  auto load_scales = [&](int gi, float (&dst)[CT]) {
    if (fault == 3 && gi + 1 < G) gi += 1;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = col0 + g * CT + c;
      dst[c] = col < N ? __ldg(scale + (long long)gi * N + col) : 0.f;
    }
  };
  auto use_group = [&](int gi) {
    if (gi == cur_g) return;
    if (gi != pre_g) load_scales(gi, pre);
#pragma unroll
    for (int c = 0; c < CT; ++c) sc[c] = bf16x2_of(pre[c]);
    cur_g = gi;
    pre_g = -1;
    if ((gi + 1) * group < wk1) {
      load_scales(gi + 1, pre);
      pre_g = gi + 1;
    }
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  for (int j = 0; j < n_st; ++j) {
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* st = ring + (j % kStages) * C::STAGE;
    const int ks = wk0 + j * kStageRows;
#pragma unroll
    for (int sub = 0; sub < kStageRows / 16; ++sub) {
      const int k0 = ks + sub * 16;
      if (k0 >= wk1) break;
      if (fault == 1 && k0 == last16) continue;
#ifdef VST_WQ_NO_MATH
      continue;
#endif
      if constexpr (GROUPED) use_group(k0 / group);
      uint32_t wr[4][kWords<C::CB>];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sub * 16 + 4 * t + i;
        lds_row<C::CB>(st + swz<C::RB>(r, r * C::RB + g * C::CB), wr[i]);
        if (BITS == 4 && fault == 2) {
#pragma unroll
          for (int e = 0; e < kWords<C::CB>; ++e) {
            wr[i][e] = ((wr[i][e] >> 4) & 0x0F0F0F0Fu) |
                       ((wr[i][e] & 0x0F0F0F0Fu) << 4);
          }
        }
      }
      uint32_t a01[CT], a23[CT];
      widen<BITS, CT, kWords<C::CB>>(wr, a01, a23);
      if constexpr (GROUPED) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          a01[c] = bf2_fma(a01[c], sc[c], 0x80008000u);
          a23[c] = bf2_fma(a23[c], sc[c], 0x80008000u);
        }
      }
      const unsigned char* xs = st + C::WBYTES + sub * MT * 32;
#pragma unroll
      for (int q = 0; q < MT / 8; ++q) {
        const uint2 b =
            *reinterpret_cast<const uint2*>(xs + (8 * q + g) * 32 + 8 * t);
#pragma unroll
        for (int p = 0; p < CT / 2; ++p) {
          mma16816(acc[q][p], a01[2 * p], a01[2 * p + 1], a23[2 * p],
                   a23[2 * p + 1], b.x, b.y);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warps' sums into shared memory: red[warp][m][column of the tile].
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < MT / 8; ++q) {
#pragma unroll
    for (int p = 0; p < CT / 2; ++p) {
      const int cl = g * CT + 2 * p;
      const int m0 = 8 * q + 2 * t;
      float* r0 = red + (warp * MT + m0) * C::BN + cl;
      r0[0] = acc[q][p][0];
      r0[C::BN] = acc[q][p][1];
      r0[1] = acc[q][p][2];
      r0[C::BN + 1] = acc[q][p][3];
    }
  }
  __syncthreads();
  auto finish = [&](float v, int m, int col) {  // the epilogue of output m, col
    float out = v;
    if constexpr (!GROUPED) {
      out = bf16_round(v) * bf16_round(__ldg(scale + col));
    }
    y[(long long)m * N + col] = __float2bfloat16_rn(out);
  };
  // The block's partial (the warps' sums in warp order) in place of
  // warp 0's rows; with one split, y.
  for (int o = tid; o < M * C::BN; o += kThreads) {
    const int m = o / C::BN;
    const int cl = o % C::BN;
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      if (fault == 4 && splits == 1 && ww == 0) continue;
      v += red[(ww * MT + m) * C::BN + cl];
    }
    if (splits == 1) {
      if (col0 + cl < N) finish(v, m, col0 + cl);
    } else {
      red[m * C::BN + cl] = v;
    }
  }
  if (splits == 1) return;
#ifdef VST_WQ_NO_REDUCE
  return;
#endif

  // The splits (this cluster's ranks) added through distributed shared
  // memory in rank order; rank r finishes outputs [r * per, (r + 1) * per)
  // of the tile. The second barrier keeps every rank's partial in place
  // until the others have read it.
  cluster_arrive_release();
  cluster_wait();
  const int outs = M * C::BN;
  const int per = (outs + splits - 1) / splits;
  const uint32_t part = smem_u32(red);
  for (int o = split * per + tid; o < min(outs, (split + 1) * per);
       o += kThreads) {
    const int col = col0 + o % C::BN;
    float v = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float got[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = s0 + e;
        got[e] = r < splits && !(fault == 4 && r == 0)
                     ? ld_cluster(mapa(part + 4 * o, r)) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v += got[e];
    }
    if (col < N) finish(v, o / C::BN, col);
  }
  cluster_arrive_release();
  cluster_wait();
}

// Once per instantiation and device: the dynamic shared-memory ceiling and
// clusters of up to 16 blocks. File scope (not a static in the template):
// a template's static is one symbol for every copy of the library in a
// process, and a second copy would skip its own kernels' preparation.
static unsigned g_prepared[3][4][4];

constexpr int ct_index(int ct) {
  return ct == 32 ? 0 : ct == 16 ? 1 : ct == 8 ? 2 : 3;
}

constexpr int mt_index(int mt) {
  return mt == 8 ? 0 : mt == 16 ? 1 : mt == 32 ? 2 : 3;
}

template <int BITS, bool GROUPED, int CT, int MT>
cudaError_t launch_a(const bf16* x, const uint8_t* w, const float* s,
                     bf16* y, int M, int K, int N, int group, int tiles,
                     int splits, int split_rows, int cp, int fault,
                     cudaStream_t stream) {
  using C = Cfg<BITS, CT, MT>;
  auto kernel = wq_matmul_kernel<BITS, GROUPED, CT, MT>;
  unsigned& done =
      g_prepared[BITS == 8 ? 0 : GROUPED ? 2 : 1][ct_index(CT)][mt_index(MT)];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32 || !((done >> dev) & 1u)) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return e;
    if (dev < 32) done |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, x, w, s, y, M, K, N, group, split_rows,
                     cp, fault);
  return cudaGetLastError();
}

template <int BITS, bool GROUPED, int CT, int MT>
cudaError_t launch_a(const bf16* x, const uint8_t* w, const float* s,
                     bf16* y, float* ws, int* tickets, int M, int K, int N,
                     int group, int tiles, int splits, int split_rows, int cp,
                     int fault, cudaStream_t stream) {
  using C = Cfg<BITS, CT, MT>;
  auto kernel = wq_matmul_kernel<BITS, GROUPED, CT, MT>;
  if (C::SMEM + 64 > 48 * 1024) {  // with the static s_last
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(tiles, splits), kThreads, C::SMEM, stream>>>(
      x, w, s, y, ws, tickets, M, K, N, group, split_rows, cp, fault);
  return cudaGetLastError();
}

template <int BITS, bool GROUPED, int CT, int MT>
cudaError_t launch_if(const bf16* x, const uint8_t* w, const float* s,
                      bf16* y, int M, int K, int N, int group, int tiles,
                      int splits, int split_rows, int cp, int fault,
                      cudaStream_t stream) {
  if constexpr (CT == 2 || (CT >= 8 && CT <= wide_ct(BITS, MT))) {
    return launch_a<BITS, GROUPED, CT, MT>(x, w, s, y, M, K, N, group, tiles,
                                           splits, split_rows, cp, fault,
                                           stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <int BITS, bool GROUPED, int CT>
cudaError_t launch_rows(int mt, const bf16* x, const uint8_t* w,
                        const float* s, bf16* y, int M, int K, int N,
                        int group, int tiles, int splits,
                        int split_rows, int cp, int fault,
                        cudaStream_t stream) {
#define VST_WQ_LAUNCH(MT)                                                 \
  launch_if<BITS, GROUPED, CT, MT>(x, w, s, y, M, K, N, group, tiles, \
                                   splits, split_rows, cp, fault, stream)
  switch (mt) {
    case 8: return VST_WQ_LAUNCH(8);
    case 16: return VST_WQ_LAUNCH(16);
    case 32: return VST_WQ_LAUNCH(32);
    case 64: return VST_WQ_LAUNCH(64);
    default: return cudaErrorInvalidValue;
  }
#undef VST_WQ_LAUNCH
}

template <int BITS, bool GROUPED>
cudaError_t launch_cols(int ct, int mt, const bf16* x, const uint8_t* w,
                        const float* s, bf16* y, int M, int K, int N,
                        int group, int tiles, int splits,
                        int split_rows, int cp, int fault,
                        cudaStream_t stream) {
#define VST_WQ_COLS(CT)                                                       \
  launch_rows<BITS, GROUPED, CT>(mt, x, w, s, y, M, K, N, group, tiles, \
                                 splits, split_rows, cp, fault, stream)
  switch (ct) {
    case 32: return VST_WQ_COLS(32);
    case 16: return VST_WQ_COLS(16);
    case 8: return VST_WQ_COLS(8);
    case 2: return VST_WQ_COLS(2);
    default: return cudaErrorInvalidValue;
  }
#undef VST_WQ_COLS
}

// Kernel B: one thread per 8 columns of a row (8 int8 or 4 packed bytes
// in, 16 bf16 bytes out), so that a warp's loads and stores are each one
// contiguous run; widened by magic numbers as kernel A does, pairs of
// adjacent columns into one bf16x2 word.
template <int BITS, bool GROUPED>
__global__ void __launch_bounds__(256)
wq_dequant_bf16_kernel(const uint8_t* __restrict__ w,
                       const float* __restrict__ scale, bf16* __restrict__ out,
                       int K, int N, int group) {
  const long long per_row = N / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * per_row) return;
  const long long k = i / per_row;
  const long long n0 = (i % per_row) * 8;
  uint32_t o[4];
  if constexpr (BITS == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(w + k * N + n0));
    const uint32_t wd[2] = {v.x, v.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // 2^23 + (q + 128), less 2^23 + 128: q exactly
      const uint32_t u = wd[e] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j)) -
               8388736.f;
      }
      o[2 * e] =
          __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      o[2 * e + 1] =
          __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    }
  } else {
    // byte j's low nibble (column 2j) to bits 0-3, its high nibble (column
    // 2j + 1) to bits 16-19, sign bits flipped: 128 + q + 8, less 136
    const uint32_t x =
        __ldg(reinterpret_cast<const uint32_t*>(w + k * (N / 2) + n0 / 2)) ^
        0x88888888u;
    const uint32_t xs = x >> 4;
    uint32_t sc[4];
    if constexpr (GROUPED) {
      const float4* sg = reinterpret_cast<const float4*>(
          scale + (k / group) * (long long)N + n0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 f = __ldg(sg + j);
        const __nv_bfloat162 a = __floats2bfloat162_rn(f.x, f.y);
        const __nv_bfloat162 b = __floats2bfloat162_rn(f.z, f.w);
        sc[2 * j] = *reinterpret_cast<const uint32_t*>(&a);
        sc[2 * j + 1] = *reinterpret_cast<const uint32_t*>(&b);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = __byte_perm(x, xs, ((4 + j) << 8) | j);
      uint32_t v;
      asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"  // (a & b) | c
          : "=r"(v)
          : "r"(t), "r"(0x000F000Fu), "r"(0x43004300u));
      v = bf2_fma(v, 0x3F803F80u, 0xC308C308u);
      if constexpr (GROUPED) v = bf2_fma(v, sc[j], 0x80008000u);
      o[j] = v;
    }
  }
  *reinterpret_cast<uint4*>(out + k * N + n0) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

template <int BITS, bool GROUPED>
cudaError_t launch_b(const uint8_t* w, const float* s, bf16* out, int K,
                     int N, int group, cudaStream_t stream) {
  const long long threads = (long long)K * (N / 8);
  wq_dequant_bf16_kernel<BITS, GROUPED>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
          w, s, out, K, N, group);
  return cudaGetLastError();
}

}  // namespace vst_wq

// Kernel A. bits 8 or 4; group 0 for per-channel scales [N], else (int4
// only, a multiple of 16 dividing K) the group size of scales [K / group,
// N]. x [M, K] (K a multiple of 8, 16-byte aligned) and y [M, N] are
// contiguous bf16, w is [K, N] int8 or [K, N / 2] packed int4 (a stored row
// a multiple of 4 bytes), contiguous. The plan (`wq_plan`): ct columns a
// lane (2, or 8 to wide_ct(bits, mt)), row tile mt (8, 16, 32, 64), tiles
// x splits blocks of split_rows k rows (a multiple of 64 or of the group),
// at most 16 splits: one cluster per column tile.
extern "C" int vst_wq_matmul_fwd(const void* x, const void* w,
                                 const void* scale, void* y, int M, int K,
                                 int N, int bits, int group, int ct, int mt,
                                 int tiles, int splits, int split_rows,
                                 int fault, void* stream) {
  using namespace vst_wq;
  const int bn = 8 * ct;
  const int unit = group ? group : kSplitRows;
  if (M < 1 || M > kMaxRows || M > mt || K < 1 || K % 8 || N < 1 ||
      (bits != 8 && bits != 4) || (bits == 4 && N % 8) ||
      (bits == 8 && N % 4) || group < 0 ||
      (group && (bits != 4 || group % 16 || K % group)) ||
      tiles != (N + bn - 1) / bn ||
      splits < 1 || splits > kMaxSplits || split_rows < 1 ||
      split_rows % unit || (long long)splits * split_rows < K ||
      (long long)(splits - 1) * split_rows >= K ||
      reinterpret_cast<uintptr_t>(x) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_bytes = bits == 8 ? (long long)N : (long long)N / 2;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int vec = row_bytes % 16 == 0 && wa % 16 == 0  ? 16
                  : row_bytes % 8 == 0 && wa % 8 == 0 ? 8
                  : wa % 4 == 0                        ? 4
                                                       : 0;
  if (vec == 0) return (int)cudaErrorInvalidValue;
  const int rb = bn * bits / 8;
  const int cp = vec < rb ? vec : rb;
  const bf16* xp = static_cast<const bf16*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 8) {
    err = launch_cols<8, false>(ct, mt, xp, wp, sp, yp, M, K, N, 0, tiles,
                                splits, split_rows, cp, fault, st);
  } else if (group == 0) {
    err = launch_cols<4, false>(ct, mt, xp, wp, sp, yp, M, K, N, 0, tiles,
                                splits, split_rows, cp, fault, st);
  } else {
    err = launch_cols<4, true>(ct, mt, xp, wp, sp, yp, M, K, N, group, tiles,
                               splits, split_rows, cp, fault, st);
  }
  return (int)err;
}

// Kernel B: the [K, N] bf16 transient of w [K, N] int8 or [K, N / 2] packed
// int4 and scales [N] or [K / group, N], all contiguous; N a multiple of 8,
// w 8-byte (int8) or 4-byte (int4) aligned, scales and out 16-byte aligned.
extern "C" int vst_wq_dequant_fwd(const void* w, const void* scale, void* out,
                                  int K, int N, int bits, int group,
                                  void* stream) {
  using namespace vst_wq;
  if (K < 1 || N < 1 || N % 8 || (bits != 8 && bits != 4) || group < 0 ||
      (group && (bits != 4 || K % group)) ||
      reinterpret_cast<uintptr_t>(w) % (bits == 8 ? 8 : 4) ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bits == 8) {
    err = launch_b<8, false>(wp, sp, o, K, N, 0, st);
  } else if (group == 0) {
    err = launch_b<4, false>(wp, sp, o, K, N, 0, st);
  } else {
    err = launch_b<4, true>(wp, sp, o, K, N, group, st);
  }
  return (int)err;
}
