// The wgmma attention main loop and the tile-image writes, shared by the
// fused ViT kernel (fused_vit_attn_fwd.cu, after its rotary prologue) and
// every call of the flash kernel (flash_varlen_fwd.cu, after its prologue
// without rotation), causal or not. sm_90a.
//
// Tile images (hopper_common.cuh; plain versions in kernels/tiles.py): one
// 64-row tile of one head is one contiguous no-swizzle K-major image of
// 64 * Dp bf16, Dp = D rounded up to 16:
//   q, k: 64 token rows x Dp (head dims zero-padded), LBO 128 B, SBO
//         Dp * 16 B, k step 256 B;
//   v:    transposed, Dp head-dim rows x 64 keys (keys contiguous, so P V's
//         B operand is K-major too), LBO 128 B, SBO 1,024 B.
// Rows past the sequence are zero. q images are [B, H, nq, 64 * Dp], k and
// v^T images [B, H_kv, nk, 64 * Dp]. tile_seg ([B, nq] for q, [B, nk] for
// kv) is the tile's segment id if its 64 rows (rows past the sequence
// count as segment 0) share one id > 0, else -1.
//
// Main loop: one block per (64-row q tile, head, batch) of one consumer
// warpgroup (warps 0-3) and one producer warp (warp 4). The producer's
// lane 0 moves the q image once and then keeps a ring of kStages (k image,
// v^T image) stages full with one cp.async.bulk per image, completed on
// the stage's `full` mbarrier (expect-tx); the consumers release a stage
// through its `empty` mbarrier. The consumer warpgroup computes S = Q K^T
// with wgmma m64n64k16 (both operands from shared memory, Dp / 16 k
// steps), the online softmax in base 2 in registers (the accumulator has
// mma.sync's C layout, so the masking, max and sum logic is that of the
// mma.sync kernels of attn_common.cuh), rounds P to bf16 in registers and adds P V with wgmma
// m64nDpk16 (A from registers, B the v^T image), fenced, committed and
// waited around each product. Query head h reads kv head h / (H / H_kv).
// The kv tiles visited are [lo, hi) of the 64-row bounds (the full range
// without bounds), capped at lo + kv_iters when kv_iters > 0, and with
// kCausal at iq + 1 (no tile past the diagonal). With kCausal a q tile with
// no row of segment > 0 visits nothing: its block votes on its 64 segment
// ids before the roles split, moves no image and stores exact zeros.
//
// Mask-free steps: a kv tile whose tile_seg equals the q tile's (and is
// not -1) is interior: every (query, key) pair of it is valid, so its step
// reads no segment ids and compares nothing. Other tiles mask per element
// (keys past the sequence have segment 0); a masked element gets p = 0
// explicitly, so a padding key never gives exp(0) and a row with no valid
// key keeps l = 0 and is stored as exact zeros. With kCausal the diagonal
// tile (j == iq) always takes the masked step, whose compare adds query
// row >= key index; the tiles below it are mask-free on the tile_seg rule
// (the LM prefill's valid prefix makes every full one so). kMask = false (the
// ablation) takes the mask-free step everywhere; kExp = false (the
// ablation) takes p = the scaled logit with no exp and no running max, so
// l stays 0 and the rows are stored undivided.
#pragma once

#include "attn_common.cuh"
#include "hopper_common.cuh"

namespace vst {

constexpr int kStages = 3;                   // kv stages in the ring
constexpr int kMainThreads = kThreads + 32;  // consumer warpgroup + producer

struct WgmmaAttnParams {
  const bf16* q_img;   // [B, H, nq, 64 * Dp]
  const bf16* k_img;   // [B, H_kv, nk, 64 * Dp]
  const bf16* vt_img;  // [B, H_kv, nk, 64 * Dp]
  const int* q_tseg;   // [B, nq]
  const int* kv_tseg;  // [B, nk]
  const int* q_seg;    // [B, Sq]
  const int* kv_seg;   // [B, Sk]
  const int* bounds;   // [nq, 2] or null (full range)
  bf16* out;           // query row i of batch b, head h at
                       // out + (b * Sq + i) * out_ld + h * D
  long long out_ld;
  int Sq, Sk, H, Hkv;
  int kv_iters;  // 0: no cap
  float scale;
};

// --- the prologues' image writes (every thread of a kThreads block) -------

// The 64 x Dp image of rows [row_base, row_base + 64): 16-byte chunk c of
// the image is row r of core matrix c / 8; chunk(row, col0) returns the 8
// elements at columns [col0, col0 + 8) of a row < n_rows (col0 < D). Rows
// at or past n_rows and columns past D are zero.
template <int D, typename Chunk>
__device__ __forceinline__ void write_row_image(bf16* dst, int row_base,
                                                int n_rows,
                                                const Chunk& chunk) {
  constexpr int kDp = Dims<D>::kPad;
  constexpr int kImg = kTile * kDp;
  for (int c = threadIdx.x; c < kImg / 8; c += kThreads) {
    const int cm = c >> 3;
    const int r = (cm / (kDp / 8)) * 8 + (c & 7);
    const int col0 = (cm % (kDp / 8)) * 8;
    const int row = row_base + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows && col0 < D) val = chunk(row, col0);
    *reinterpret_cast<uint4*>(dst + c * 8) = val;
  }
}

// The Dp x 64 v^T image of rows [row_base, row_base + 64) of a head whose
// row r starts at src + r * row_stride (16-byte aligned): the tile staged
// in shared memory (rows past n_rows zero), then written transposed.
template <int D>
__device__ __forceinline__ void write_vt_image(bf16* dst, const bf16* src,
                                               long long row_stride,
                                               int row_base, int n_rows) {
  constexpr int kDp = Dims<D>::kPad;
  constexpr int kImg = kTile * kDp;
  __shared__ __align__(16) bf16 s_v[kTile][D + 8];
  for (int c = threadIdx.x; c < kTile * (D / 8); c += kThreads) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row_base + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row_base + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(&s_v[r][col]) = val;
  }
  __syncthreads();
  // 16-byte chunk c of the image: core matrix c / 8 (head-dim group, key
  // group), its row c % 8.
  for (int c = threadIdx.x; c < kImg / 8; c += kThreads) {
    const int cm = c >> 3;
    const int dim = (cm / (kTile / 8)) * 8 + (c & 7);
    const int key0 = (cm % (kTile / 8)) * 8;
    alignas(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] = dim < D ? s_v[key0 + e][dim] : __float2bfloat16_rn(0.f);
    }
    *reinterpret_cast<uint4*>(dst + c * 8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// *out = the segment id that rows [row_base, row_base + 64) share (rows at
// or past n_rows count as 0) if it is > 0, else -1. Every thread of the
// block calls it (a block-wide vote).
__device__ __forceinline__ void write_tile_seg(int* out, const int* seg,
                                               int row_base, int n_rows) {
  const int first = row_base < n_rows ? seg[row_base] : 0;
  bool same = true;
  if (threadIdx.x < kTile) {
    const int row = row_base + threadIdx.x;
    same = (row < n_rows ? seg[row] : 0) == first;
  }
  const int all_same = __syncthreads_and(same);
  if (threadIdx.x == 0) *out = all_same && first > 0 ? first : -1;
}

// --- the main loop ----------------------------------------------------------

// One kv tile of the online softmax for this thread's query rows g and g + 8
// (s: the tile's raw logits from wgmma, s[4n + e] = element e of 8-column
// block n), then o += P V by wgmma with P (bf16) from registers and B the
// tile's v^T image at sv. valid(n, e) says whether element (n, e) is a key
// its row may attend; a masked element gets p = 0 explicitly, so a row with
// no valid key keeps l = 0. kExp = false: p = the masked s * scale, m and l
// untouched.
template <int D, bool kExp, typename Valid>
__device__ __forceinline__ void softmax_pv(float (&s)[32],
                                           float (&o)[Dims<D>::kPad / 8][4],
                                           float& m0, float& m1, float& l0,
                                           float& l1, float scale,
                                           const bf16* sv,
                                           const Valid& valid) {
  using namespace hopper;
  constexpr int kDp = Dims<D>::kPad;
  if constexpr (!kExp) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * n + e];
        x = valid(n, e) ? x * scale : 0.f;
      }
    }
  } else {
    const float sl2 = scale * kLog2e;  // softmax in base 2
    float mx0 = kNegInf, mx1 = kNegInf;
    unsigned ok = 0;  // bit 4n + e: element (n, e) is a valid key
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = valid(n, e);
        float& x = s[4 * n + e];
        x = v ? x * sl2 : kNegInf;
        ok |= (unsigned)v << (4 * n + e);
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = (ok >> (4 * n + e)) & 1u;
        float& x = s[4 * n + e];
        x = v ? exp2f(x - (e < 2 ? mn0 : mn1)) : 0.f;
        if (e < 2) sum0 += x;
        else sum1 += x;
      }
    }
    l0 = l0 * a0 + quad_sum(sum0);
    l1 = l1 * a1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kDp / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
  }
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
  const uint64_t dv = image_desc(sv, 128, kTile * 16);
  fence_regs<kDp / 2>(&o[0][0]);
  fence_regs<16>(&pa[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    WgmmaRS<kDp>::mma(&o[0][0], pa[kk], dv + kk * 16);  // +256 bytes
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<kDp / 2>(&o[0][0]);
  fence_regs<16>(&pa[0][0]);
}

// Dynamic shared memory of the main loop: the q image, kStages k and v^T
// images, 1 + 2 * kStages mbarriers.
template <int D>
constexpr int main_smem_bytes() {
  return (1 + 2 * kStages) * kTile * Dims<D>::kPad * (int)sizeof(bf16) +
         (1 + 2 * kStages) * (int)sizeof(uint64_t);
}

// The main loop of one block: q tile iq of head h of batch b. smem_raw:
// main_smem_bytes<D>() of dynamic shared memory, 128-byte aligned. Every
// thread of a kMainThreads block calls it.
template <int D, bool kMask, bool kExp, bool kCausal>
__device__ __forceinline__ void wgmma_attn_block(const WgmmaAttnParams& p,
                                                 unsigned char* smem_raw,
                                                 int iq, int h, int b) {
  using namespace hopper;
  constexpr int kDp = Dims<D>::kPad;
  constexpr int kImg = kTile * kDp;
  constexpr uint32_t kImgBytes = kImg * sizeof(bf16);
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kImg;             // [kStages][kImg]
  bf16* s_v = s_k + kStages * kImg;   // [kStages][kImg], v^T images
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_v + kStages * kImg);
  uint64_t* full = q_full + 1;        // [kStages]
  uint64_t* empty = full + kStages;   // [kStages]

  const int nq = (p.Sq + kTile - 1) / kTile;
  const int nk = (p.Sk + kTile - 1) / kTile;
  const int hk = h / (p.H / p.Hkv);
  const long long kv_head = ((long long)b * p.Hkv + hk) * nk * kImg;
  int lo = 0, hi = nk;
  if (p.bounds != nullptr) {
    lo = p.bounds[2 * iq];
    hi = p.bounds[2 * iq + 1];
  }
  if (p.kv_iters > 0) hi = min(hi, lo + p.kv_iters);
  if constexpr (kCausal) hi = min(hi, iq + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* q_seg = p.q_seg + (long long)b * p.Sq;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  // The last barrier of the block: the roles split here.
  bool live = true;  // the q tile has a row of segment > 0
  if constexpr (kCausal) {
    const int row = iq * kTile + threadIdx.x;
    live = __syncthreads_or(threadIdx.x < kTile && row < p.Sq &&
                            q_seg[row] > 0);
    if (!live) hi = lo;
  } else {
    __syncthreads();
  }

  if (warp == kWarps) {  // producer warp
    if (lane == 0 && live) {
      mbar_arrive_expect_tx(q_full, kImgBytes);
      bulk_g2s(s_q, p.q_img + (((long long)b * p.H + h) * nq + iq) * kImg,
               kImgBytes, q_full);
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * kImgBytes);
        bulk_g2s(s_k + st * kImg, p.k_img + kv_head + (long long)j * kImg,
                 kImgBytes, &full[st]);
        bulk_g2s(s_v + st * kImg, p.vt_img + kv_head + (long long)j * kImg,
                 kImgBytes, &full[st]);
      }
    }
    return;
  }

  // Consumer warpgroup: warp w owns query rows [16w, 16w + 16) of the tile.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = iq * kTile + warp * 16 + g;  // rows row0 and row0 + 8
  const int* kv_seg = p.kv_seg + (long long)b * p.Sk;
  const int* kv_tseg = p.kv_tseg + (long long)b * nk;
  const int seg0 = row0 < p.Sq ? q_seg[row0] : 0;
  const int seg1 = row0 + 8 < p.Sq ? q_seg[row0 + 8] : 0;
  const int q_uniform = p.q_tseg[(long long)b * nq + iq];

  float s[32];
  float o[kDp / 8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int n = 0; n < kDp / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  if (live) mbar_wait(q_full, 0);
  const uint64_t dq = image_desc(s_q, 128, kDp * 16);
  for (int j = lo, i = 0; j < hi; ++j, ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint64_t dk = image_desc(s_k + st * kImg, 128, kDp * 16);
    fence_regs<32>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      wgmma_m64n64k16_ss(s, dq + kk * 16, dk + kk * 16, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);

    const bf16* sv = s_v + st * kImg;
    if (!kMask || (q_uniform >= 0 && kv_tseg[j] == q_uniform &&
                   (!kCausal || j < iq))) {
      softmax_pv<D, kExp>(s, o, m0, m1, l0, l1, p.scale, sv,
                          [](int, int) { return true; });
    } else {
      const int* kseg = kv_seg + j * kTile;
      const int n_keys = p.Sk - j * kTile;  // keys at or past it are padding
      int ks[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e;
          ks[n][e] = c < n_keys ? kseg[c] : 0;
        }
      }
      softmax_pv<D, kExp>(s, o, m0, m1, l0, l1, p.scale, sv,
                          [&](int n, int e) {
                            const int k = ks[n][e & 1];
                            bool ok = (e < 2 ? seg0 : seg1) == k && k > 0;
                            if constexpr (kCausal) {  // query row >= key
                              ok = ok && (e < 2 ? row0 : row0 + 8) >=
                                             j * kTile + n * 8 + 2 * t +
                                                 (e & 1);
                            }
                            return ok;
                          });
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with st
  }

  // Without the exp, l stays 0 and the rows are stored undivided.
  store_rows<D>(p.out + (long long)b * p.Sq * p.out_ld + (long long)h * D,
                p.out_ld, row0, p.Sq, o, l0, l1, lane);
}

}  // namespace vst
