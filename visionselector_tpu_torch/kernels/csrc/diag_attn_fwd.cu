// diag_attn_fwd: block-diagonal segment attention forward (sm_90a).
//
// Replaces the TPU kernel _diag_kernel behind attention_diag in
// visionselector_tpu/kernels/attention.py. Under the window-aligned ViT
// layout every window sits in its own 64-patch slot, so the queries of a
// 64-row tile attend only to the keys of the same tile: one exact fp32
// softmax over a [64, 64] tile with the segment mask (seg_q == seg_k,
// seg_k > 0), then P V with p rounded to bf16. Rows with no valid key
// (padding rows) come out exactly 0. The result equals
// attention_diag(block_q=64) and the plain PyTorch version `diag_plain`.
//
// What bounds it on the H100: bytes. Per (tile, head) it reads 3 x 64 x D
// bf16 and writes 64 x D, against 4 x 64 x 64 x D flops, far below the
// card's ~295 flops per byte: the 28 window layers must stream q, k and v
// through at the memory's rate and keep it busy from the first byte to the
// last. So the design is a persistent kernel of producer and consumer
// roles:
//
//  - Grid: blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor on
//    this kernel's threads and shared memory) x SMs, at most one block per
//    item. An item is (b, 64-row tile, head), numbered ((b * S / 64) +
//    tile) * H + head; block i walks items i, i + grid, i + 2 grid, ...
//    (plain mirror: tiles.diag_items_plain).
//  - A producer warp (the last warp) runs ahead of the consumers through a
//    ring of kDiagStages stages, each the q, k and v tiles of one item:
//    per item it waits for the stage's `empty` mbarrier, then one lane
//    issues the tensor copies (TMA, cp.async.bulk.tensor) completed on the
//    stage's `full` mbarrier. The tensor maps (encoded in the C entry
//    point) lie over the [B, S, H, D] strided views the caller passes (v
//    straight from the qkv slab, row stride 3 H D): no prologue, no image
//    in global memory, no v^T.
//  - Tile layout in shared memory: a 64 x Dp tile (Dp = D rounded up to
//    16) is one or two parts of whole rows, each part one tensor box of
//    (cols, 64 rows) with the swizzle that matches its row: 64 columns
//    (128-byte rows, 128-byte swizzle), 32 (D = 24: 64-byte rows, columns
//    24-31 out of bounds land as zeros) or 16 (32-byte rows). D = 80 is
//    64 + 16 columns, D = 128 64 + 64. Every row of the view is read as
//    whole 128-, 64- or 32-byte pieces. wgmma reads a part directly: q and
//    k K-major (SBO = 8 rows, the start address stepping 32 bytes per k
//    step inside the swizzle row), v MN-major with the transpose bit (SBO =
//    8 keys, 16 keys per k step), so P V is one wgmma m64nNk16 per part
//    and k step.
//  - kDiagConsumers consumer warpgroups; loaded item n of a block goes to
//    stage n % kDiagStages and warpgroup n % kDiagConsumers (kDiagStages a
//    multiple of it, so each warpgroup owns its stages and waits on every
//    phase of them in order). A warpgroup runs S = Q K^T with wgmma
//    m64n64k16 (both operands from shared memory), the exact softmax in
//    registers in base 2 (no kv loop, no online rescale), rounds P to bf16
//    in registers and runs P V (A from registers), releases the stage,
//    then stages o / l as bf16 in its own 64 x Dp buffer (the parts'
//    swizzled layout: a warp's 4-byte writes hit 32 banks), fences the
//    async proxy and issues the tile's tensor stores (TMA, whole rows);
//    before it writes that buffer again it waits for the stores' read
//    (cp.async.bulk.wait_group.read).
//  - Tile kinds, decided on the card by each warp from the tile's 64
//    segment ids (tiles.tile_seg_plain's rule; plain mirror
//    tiles.diag_tile_kinds_plain): all rows one segment > 0 -> no mask;
//    all rows padding -> no copy, no product, the stored rows are zeros;
//    otherwise the segment mask per element. `kind` (a [B, S / 64] array,
//    normally null) overrides the decision: a test hook that plants a
//    fault.
//
// Build variants for tools/diag_floor.py: -DVST_DIAG_NO_STORE (no output
// write), -DVST_DIAG_NO_MATH (loads and stores, no products: zeros out),
// -DVST_DIAG_EMPTY (returns at once).
//
// Layout: q/k/v are [B, S, H, D] read through strides (base pointers and
// batch, row and head strides 16-byte aligned); out is a contiguous
// [B, S, H, D]; S is a multiple of 64.
#include <cuda.h>  // CUtensorMap and the encoder's types (no -lcuda)

#include "attn_common.cuh"
#include "hopper_common.cuh"

namespace vst {

// Two consumer warpgroups of two stages each, one block per SM at D = 80
// and 128 (144,448 / 230,464 bytes): 4-5% faster on the H100 than one
// warpgroup with 3 stages at two blocks per SM, or with 2 or 4 stages
// (PERF.md section 6).
constexpr int kDiagStages = 4;
constexpr int kDiagConsumers = 2;
static_assert(kDiagStages >= 2 && kDiagStages % kDiagConsumers == 0,
              "each consumer warpgroup owns kDiagStages / kDiagConsumers "
              "stages");
constexpr int kDiagThreads = kDiagConsumers * kThreads + 32;

enum : int { kTilePad = 0, kTileUniform = 1, kTileMixed = 2 };

struct DiagParams {
  const int* seg;   // [B, S]
  const int* kind;  // [B, S / 64] tile kinds, or null: from seg
  int S, H, n_items;
  float scale;
};

// One part of a tile: 64 rows of kCols bf16 (kBytes each), swizzled in
// 16-byte chunks: chunk j of row r lies at r * kBytes + (j ^ s) * 16 with
// s = ((r * kBytes) >> 7) & (kBytes / 16 - 1), the 128-, 64- or 32-byte
// swizzle of the tensor copies and of wgmma (address bits 4.. XOR bits 7..).
template <int kCols>
struct Part {
  static_assert(kCols == 16 || kCols == 32 || kCols == 64, "part width");
  static constexpr int kBytes = kCols * 2;
  static constexpr uint32_t kSize = kTile * kBytes;
  static constexpr uint32_t kSbo = 8 * kBytes;  // the next 8 rows
  static constexpr uint64_t kLayout = kBytes == 128 ? 1 : kBytes == 64 ? 2 : 3;
  static __device__ __forceinline__ int chunk(int r, int j) {
    return r * kBytes + ((j ^ (((r * kBytes) >> 7) & (kBytes / 16 - 1))) << 4);
  }
};

template <int D>
struct DiagDims {
  static constexpr int kDp = Dims<D>::kPad;
  static constexpr int kC0 = D >= 64 ? 64 : kDp;  // columns of part 0
  static constexpr int kC1 = kDp - kC0;           // of part 1: 0, 16 or 64
  static constexpr int kImg = kTile * kDp;        // elements of one tile
  static constexpr uint32_t kImgBytes = kImg * sizeof(bf16);
  // The ring, one output buffer per consumer warpgroup, the mbarriers, and
  // room to align the base to 1,024 bytes (the swizzle atom).
  static constexpr int kSmem =
      (3 * kDiagStages + kDiagConsumers) * (int)kImgBytes +
      2 * kDiagStages * (int)sizeof(uint64_t) + 1024;
};

// The kind of tile `tile` of batch row b; every lane of the warp calls it.
__device__ __forceinline__ int tile_kind(const DiagParams& p, int b, int tile,
                                         int lane) {
  if (p.kind != nullptr) return p.kind[b * (p.S / kTile) + tile];
  const int* s = p.seg + (long long)b * p.S + tile * kTile;
  const int x = s[lane], y = s[lane + 32];
  if (__all_sync(0xffffffffu, x == 0 && y == 0)) return kTilePad;
  const int first = __shfl_sync(0xffffffffu, x, 0);
  return __all_sync(0xffffffffu, x == first && y == first) ? kTileUniform
                                                           : kTileMixed;
}

// The tensor maps of one launch: q, k, v and out, each for part 0 and part
// 1 (the same map when both parts have one width).
struct DiagMaps {
  CUtensorMap q0, q1, k0, k1, v0, v1, o0, o1;
};

// The q, k and v tiles of item (b, tile, h) into one stage by one lane's
// tensor copies (one box per part), completed on `bar`.
template <int D>
__device__ __forceinline__ void load_item(unsigned char* stage,
                                          const DiagMaps& m, int b, int tile,
                                          int h, uint64_t* bar) {
  using namespace hopper;
  using G = DiagDims<D>;
  const int row = tile * kTile;
  const CUtensorMap* maps[3][2] = {
      {&m.q0, &m.q1}, {&m.k0, &m.k1}, {&m.v0, &m.v1}};
  mbar_arrive_expect_tx(bar, 3 * G::kImgBytes);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    unsigned char* dst = stage + t * G::kImgBytes;
    tma_load_4d(dst, maps[t][0], 0, row, h, b, bar);
    if constexpr (G::kC1 > 0) {
      tma_load_4d(dst + Part<G::kC0>::kSize, maps[t][1], G::kC0, row, h, b,
                  bar);
    }
  }
}

// s += Q K^T over one part (kCols columns of q and k at sq, sk).
template <int kCols>
__device__ __forceinline__ void qk_part(float (&s)[32], const unsigned char* sq,
                                        const unsigned char* sk, bool first) {
  using namespace hopper;
  using P = Part<kCols>;
  const uint64_t dq = swizzled_desc(sq, 16, P::kSbo, P::kLayout);
  const uint64_t dk = swizzled_desc(sk, 16, P::kSbo, P::kLayout);
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {  // k step: 32 bytes along a row
    wgmma_m64n64k16_ss(s, dq + 2 * kk, dk + 2 * kk, !(first && kk == 0));
  }
}

// o[:, part] += P V over one part (kCols columns of v at sv, MN-major).
template <int kCols>
__device__ __forceinline__ void pv_part(float* o, const uint32_t (&pa)[4][4],
                                        const unsigned char* sv) {
  using namespace hopper;
  using P = Part<kCols>;
  const uint64_t dv = swizzled_desc(sv, 16, P::kSbo, P::kLayout);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // k step: 16 keys, 16 rows
    WgmmaRS<kCols, 1>::mma(o, pa[kk], dv + kk * (16 * P::kBytes >> 4));
  }
}

// One item's products for a consumer warpgroup (warp wi of it): S = Q K^T,
// the exact softmax over the tile's 64 keys (with the segment mask when
// kMask), then o = P V (unnormalised) and the row sums l0, l1 of this
// thread's rows 16 wi + g and + 8. A masked element gets p = 0 explicitly,
// so a row with no valid key keeps l = 0 and o = 0.
template <int D, bool kMask>
__device__ __forceinline__ void item_math(const unsigned char* stage,
                                          const int* seg_tile, float sl2,
                                          float (&o)[Dims<D>::kPad / 8][4],
                                          float& l0, float& l1, int wi,
                                          int lane) {
  using namespace hopper;
  using G = DiagDims<D>;
  constexpr uint32_t kP1 = Part<G::kC0>::kSize;  // part 1's offset
  const unsigned char* sq = stage;
  const unsigned char* sk = stage + G::kImgBytes;
  const unsigned char* sv = stage + 2 * G::kImgBytes;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs<32>(s);
  wgmma_fence();
  qk_part<G::kC0>(s, sq, sk, true);
  if constexpr (G::kC1 > 0) qk_part<G::kC1>(s, sq + kP1, sk + kP1, false);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);

  // s[4n + e]: row 16 wi + g + 8 (e / 2), key 8n + 2t + e % 2.
  const int g = lane >> 2, t = lane & 3;
  unsigned ok = 0xffffffffu;  // bit 4n + e: element (n, e) is a valid key
  if constexpr (kMask) {
    const int q0 = seg_tile[16 * wi + g], q1 = seg_tile[16 * wi + g + 8];
    ok = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ks = seg_tile[8 * n + 2 * t + e];
        ok |= (unsigned)(ks > 0 && ks == q0) << (4 * n + e);
        ok |= (unsigned)(ks > 0 && ks == q1) << (4 * n + 2 + e);
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * n + e];
      x = (ok >> (4 * n + e)) & 1u ? x * sl2 : kNegInf;
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * n + e];
      x = (ok >> (4 * n + e)) & 1u ? exp2f(x - (e < 2 ? mx0 : mx1)) : 0.f;
      if (e < 2) sum0 += x;
      else sum1 += x;
    }
  }
  l0 = quad_sum(sum0);
  l1 = quad_sum(sum1);

  // P as the A fragments of the four 16-key k steps: 8-column blocks 2kk
  // and 2kk + 1 of the accumulator are mma.sync's A layout.
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  fence_regs<G::kDp / 2>(&o[0][0]);
  fence_regs<16>(&pa[0][0]);
  wgmma_fence();
  pv_part<G::kC0>(&o[0][0], pa, sv);
  if constexpr (G::kC1 > 0) pv_part<G::kC1>(&o[G::kC0 / 8][0], pa, sv + kP1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<G::kDp / 2>(&o[0][0]);
  fence_regs<16>(&pa[0][0]);
}

// o / l as bf16 into this warpgroup's buffer (the parts' layout), then the
// tile's tensor stores by the warpgroup's thread 0 (tid).
template <int D>
__device__ __forceinline__ void store_item(unsigned char* buf,
                                           const DiagMaps& m,
                                           const float (&o)[Dims<D>::kPad / 8]
                                                           [4],
                                           float l0, float l1, int b, int tile,
                                           int h, int wg, int wi, int lane,
                                           int tid) {
  using namespace hopper;
  using G = DiagDims<D>;
  using P0 = Part<G::kC0>;
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  if (tid == 0) bulk_wait_read<0>();  // the last stores have read the buffer
  named_barrier(1 + wg, kThreads);
  const int r0 = 16 * wi + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {  // columns 8n + 2t, + 1
    unsigned char* part = n * 8 < G::kC0 ? buf : buf + P0::kSize;
    const int j = n * 8 < G::kC0 ? n : n - G::kC0 / 8;
    int a0, a1;
    if (n * 8 < G::kC0) {
      a0 = P0::chunk(r0, j);
      a1 = P0::chunk(r0 + 8, j);
    } else {
      a0 = Part<(G::kC1 > 0 ? G::kC1 : 16)>::chunk(r0, j);
      a1 = Part<(G::kC1 > 0 ? G::kC1 : 16)>::chunk(r0 + 8, j);
    }
    *reinterpret_cast<uint32_t*>(part + a0 + 4 * t) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(part + a1 + 4 * t) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  fence_proxy_async_smem();
  named_barrier(1 + wg, kThreads);
  if (tid == 0) {
    tma_store_4d(&m.o0, buf, 0, tile * kTile, h, b);
    if constexpr (G::kC1 > 0) {
      tma_store_4d(&m.o1, buf + P0::kSize, G::kC0, tile * kTile, h, b);
    }
    bulk_commit();
  }
}

template <int D>
__global__ void __launch_bounds__(kDiagThreads, 1)
    diag_attn_fwd_kernel(const __grid_constant__ DiagMaps maps,
                         const DiagParams p) {
#ifdef VST_DIAG_EMPTY
  return;
#endif
  using namespace hopper;
  using G = DiagDims<D>;
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  unsigned char* s_ring = smem;  // [stage][q, k, v][kImgBytes]
  unsigned char* s_out = s_ring + kDiagStages * 3 * G::kImgBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(s_out + kDiagConsumers * G::kImgBytes);
  uint64_t* empty = full + kDiagStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = p.S / kTile;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kDiagStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();  // the last barrier of the block: the roles split here

  if (warp == kDiagConsumers * kWarps) {  // producer warp
    if (lane == 0) {
      prefetch_tensormap(&maps.q0);
      prefetch_tensormap(&maps.k0);
      prefetch_tensormap(&maps.v0);
    }
    int n = 0;  // items loaded so far
    for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
      const int h = item % p.H, bt = item / p.H;
      const int tile = bt % n_tiles, b = bt / n_tiles;
      if (tile_kind(p, b, tile, lane) == kTilePad) continue;
      const int st = n % kDiagStages;
      const uint32_t parity = ((n / kDiagStages) & 1) ^ 1;
      ++n;
      if (lane != 0) continue;
      mbar_wait(&empty[st], parity);
      load_item<D>(s_ring + st * 3 * G::kImgBytes, maps, b, tile, h,
                   &full[st]);
    }
    return;
  }

  // Consumer warpgroup wg; its warp wi owns query rows [16 wi, 16 wi + 16).
  const int wg = warp / kWarps, wi = warp % kWarps;
  const int tid = threadIdx.x % kThreads;
  const float sl2 = p.scale * kLog2e;  // softmax in base 2
  unsigned char* buf = s_out + wg * G::kImgBytes;
  int n = 0, j = 0;  // items loaded so far, items walked so far
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++j) {
    const int h = item % p.H, bt = item / p.H;
    const int tile = bt % n_tiles, b = bt / n_tiles;
    const int kind = tile_kind(p, b, tile, lane);
    int owner = j % kDiagConsumers, st = 0;
    uint32_t parity = 0;
    if (kind != kTilePad) {
      owner = n % kDiagConsumers;
      st = n % kDiagStages;
      parity = (n / kDiagStages) & 1;
      ++n;
    }
    if (owner != wg) continue;
    float o[G::kDp / 8][4];
#pragma unroll
    for (int c = 0; c < G::kDp / 8; ++c) {
      o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    }
    float l0 = 0.f, l1 = 0.f;
    if (kind != kTilePad) {
      mbar_wait(&full[st], parity);
#ifndef VST_DIAG_NO_MATH
      const unsigned char* stage = s_ring + st * 3 * G::kImgBytes;
      const int* seg_tile = p.seg + (long long)b * p.S + tile * kTile;
      if (kind == kTileUniform) {
        item_math<D, false>(stage, seg_tile, sl2, o, l0, l1, wi, lane);
      } else {
        item_math<D, true>(stage, seg_tile, sl2, o, l0, l1, wi, lane);
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with st
    }
#ifndef VST_DIAG_NO_STORE
    store_item<D>(buf, maps, o, l0, l1, b, tile, h, wg, wi, lane, tid);
#endif
  }
#ifndef VST_DIAG_NO_STORE
  if (tid == 0) bulk_wait<0>();
#endif
}

// --- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded: the
// library needs no -lcuda.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// The 4-D tensor map (D, S, H, B) of a [B, S, H, D] bf16 view (element
// strides sb, ss, sh; the head dim contiguous) whose box is one part: cols
// columns x 64 rows, swizzled as its rows are long (128, 64 or 32 bytes).
// Returns 0 or 10000 + the driver's error.
static int encode_map(CUtensorMap* map, const void* base, long long sb,
                      long long ss, long long sh, int B, int S, int H, int D,
                      int cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {ss * e, sh * e, sb * e};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)kTile, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// A tensor's two part maps (part 1's only when it exists and differs).
template <int D>
static int encode_parts(CUtensorMap* m0, CUtensorMap* m1, const void* base,
                        long long sb, long long ss, long long sh, int B, int S,
                        int H) {
  using G = DiagDims<D>;
  int err = encode_map(m0, base, sb, ss, sh, B, S, H, D, G::kC0);
  if (err) return err;
  if (G::kC1 == 0 || G::kC1 == G::kC0) {
    *m1 = *m0;
    return 0;
  }
  return encode_map(m1, base, sb, ss, sh, B, S, H, D, G::kC1);
}

template <int D>
static int blocks_per_sm() {
  constexpr int smem = DiagDims<D>::kSmem;
  if (cudaFuncSetAttribute(diag_attn_fwd_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, diag_attn_fwd_kernel<D>, kDiagThreads, smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

static int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

// sd: the batch, row and head strides of q, k and v (elements).
template <int D>
static int launch(const DiagParams& p, const void* q, const void* k,
                  const void* v, void* out, const long long (&sd)[9], int B,
                  cudaStream_t stream) {
  DiagMaps m;
  const long long os = (long long)p.H * D;  // out's row stride
  int err = encode_parts<D>(&m.q0, &m.q1, q, sd[0], sd[1], sd[2], B, p.S, p.H);
  if (!err) {
    err = encode_parts<D>(&m.k0, &m.k1, k, sd[3], sd[4], sd[5], B, p.S, p.H);
  }
  if (!err) {
    err = encode_parts<D>(&m.v0, &m.v1, v, sd[6], sd[7], sd[8], B, p.S, p.H);
  }
  if (!err) {
    err = encode_parts<D>(&m.o0, &m.o1, out, os * p.S, os, D, B, p.S, p.H);
  }
  if (err) return err;
  const int per_sm = blocks_per_sm<D>(), sms = sm_count();
  if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = p.n_items < per_sm * sms ? p.n_items : per_sm * sms;
  if (grid < 1) return 0;
  diag_attn_fwd_kernel<D><<<grid, kDiagThreads, DiagDims<D>::kSmem, stream>>>(
      m, p);
  return (int)cudaGetLastError();
}

}  // namespace vst

extern "C" int vst_diag_attn_fwd(
    const void* q, const void* k, const void* v, void* out, const int* seg,
    const int* kind, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int B, int S, int H, int D, float scale,
    void* stream) {
  vst::DiagParams p;
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  p.seg = seg;
  p.kind = kind;
  p.S = S;
  p.H = H;
  p.n_items = B * (S / vst::kTile) * H;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {  // keep in step with KERNEL_HEAD_DIMS in attention.py
    case 16: return vst::launch<16>(p, q, k, v, out, strides, B, st);
    case 24: return vst::launch<24>(p, q, k, v, out, strides, B, st);
    case 64: return vst::launch<64>(p, q, k, v, out, strides, B, st);
    case 80: return vst::launch<80>(p, q, k, v, out, strides, B, st);
    case 128: return vst::launch<128>(p, q, k, v, out, strides, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What the launch of head dim D uses: what = 0 dynamic shared memory bytes,
// 1 blocks per SM, 2 ring stages, 3 consumer warpgroups, 4 the card's SMs.
// -1 for an unknown D or what.
template <int D>
static int diag_query(int what) {
  switch (what) {
    case 0: return vst::DiagDims<D>::kSmem;
    case 1: return vst::blocks_per_sm<D>();
    case 2: return vst::kDiagStages;
    case 3: return vst::kDiagConsumers;
    case 4: return vst::sm_count();
    default: return -1;
  }
}

extern "C" int vst_diag_attn_query(int D, int what) {
  switch (D) {
    case 16: return diag_query<16>(what);
    case 24: return diag_query<24>(what);
    case 64: return diag_query<64>(what);
    case 80: return diag_query<80>(what);
    case 128: return diag_query<128>(what);
    default: return -1;
  }
}
