// fused_vit_attn_fwd: rotary + segment-masked flash attention straight from
// the ViT's qkv projection slab, in two launches of one C entry point.
//
// Replaces the TPU kernel visionselector_tpu/kernels/fused_vit_attn.py:
// fused_vit_attention -> _fused_kernel. It computes the same function: the
// slab qkv [S, 3 * H * D] (q, k, v of head h at columns h * D, (H + h) * D
// and (2H + h) * D) gets rotate-half rotary on q and k from cos/sin [S, D],
// then each head's segment-masked attention over the kv tiles [lo, hi) of
// the 64-row bounds (the full range without bounds), and the output is
// written at column h * D of [S, H * D], ready for the proj matmul. Rows
// with no valid key come out exactly 0.
//
// Rotary arithmetic: cos/sin arrive in the slab's dtype (bf16; the wrapper
// casts, as the reference does) and each output element is
// bf16(bf16(x * cos) + bf16(rot * sin)), the products and the sum taken in
// fp32 and each rounded once to bf16: what PyTorch's eager bf16 ops compute
// for `q * cos + rotate_half(q) * sin`. So the rotated q and k equal the
// unfused path's exactly, and the plain version (`fused_plain` = apply
// rotary, then `flash_plain`) rounds at the same points.
//
// 1. fused_rotary_prologue_kernel, once per layer: one block of 128
//    threads per (64-row tile, head, q | k | v) reads the slab with 16-byte
//    loads, rotates q and k, and writes each tile as a wgmma-ready image
//    (hopper_common.cuh: no-swizzle K-major core matrices) into scratch
//    [H, ceil(S / 64), 64 * Dp] bf16, Dp = D rounded up to 16:
//      q, k: 64 token rows x Dp (head dims zero-padded), LBO 128 B,
//            SBO Dp * 16 B, k step 256 B;
//      v:    transposed, Dp head-dim rows x 64 keys (keys contiguous, so
//            P V's B operand is K-major too), LBO 128 B, SBO 1,024 B.
//    Rows past S are zero. The q blocks of head 0 also write tile_seg
//    [ceil(S / 64)]: the tile's segment id if all 64 rows share one id > 0,
//    else -1. Bound: bytes, the slab read once and the images written once
//    (47.2 MB each way at S = 6144, H = 16, D = 80).
// 2. fused_attn_main_kernel: one block per (64-row q tile, head) of one
//    consumer warpgroup (warps 0-3) and one producer warp (warp 4). The
//    producer's lane 0 moves the q image once and then keeps a ring of
//    kStages (k image, v^T image) stages full with one cp.async.bulk per
//    image, completed on the stage's `full` mbarrier (expect-tx); the
//    consumers release a stage through its `empty` mbarrier. The consumer
//    warpgroup computes S = Q K^T with wgmma m64n64k16 (both operands from
//    shared memory, Dp / 16 k steps), the online softmax in base 2 in
//    registers (the accumulator has mma.sync's C layout, so the masking,
//    max and sum logic is the flash kernel's), rounds P to bf16 in
//    registers and adds P V with wgmma m64nDpk16 (A from registers, B the
//    v^T image), fenced, committed and waited around each product. A kv
//    tile whose tile_seg equals the q tile's (and is not -1) is interior:
//    every (query, key) pair of it is valid, so its step reads no segment
//    ids and compares nothing; other tiles mask per element as the flash
//    kernel does (keys past S have segment 0 and get p = 0). Nothing is
//    rotated in the kv loop. Bound: a full layer is two matrix products
//    and one exp per visited (query, key) pair (operations); a window
//    layer visits one kv tile per q tile and is bound by reading the
//    images. Each product is waited for before the softmax runs: three
//    blocks share an SM (127 registers, 70 KB of shared memory), and their
//    interleaving already overlaps one block's softmax with another's
//    products. Issuing tile j's Q K^T with tile j - 1's P V and running
//    tile j's softmax under that P V measured 9% slower on the H100 (full
//    layer at S = 6144, H = 16, D = 80: 0.727-0.731 ms against 0.668).
#include "attn_common.cuh"
#include "hopper_common.cuh"

namespace vst {

using namespace hopper;

constexpr int kStages = 3;                    // kv stages in the ring
constexpr int kMainThreads = kThreads + 32;   // consumer warpgroup + producer

struct PrologueParams {
  const bf16* qkv;  // [S, 3 * H * D]
  const bf16* cos;  // [S, D]
  const bf16* sin;  // [S, D]
  const int* seg;   // [S]
  bf16* q_img;      // [H, ceil(S / 64), 64 * Dp] each
  bf16* k_img;
  bf16* vt_img;
  int* tile_seg;    // [ceil(S / 64)]
  int S, H;
};

struct MainParams {
  const bf16* q_img;
  const bf16* k_img;
  const bf16* vt_img;
  const int* tile_seg;
  const int* seg;     // [S]
  const int* bounds;  // [ceil(S / 64), 2] or null (full range)
  bf16* out;          // [S, H * D]
  int S, H;
  float scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_rotary_prologue_kernel(const PrologueParams p) {
  constexpr int kDp = Dims<D>::kPad, kHalf = D / 2;
  constexpr int kImg = kTile * kDp;  // elements of one tile image
  const int t = blockIdx.x, h = blockIdx.y, which = blockIdx.z;  // q, k, v
  const int row_base = t * kTile;
  const long long ld = 3LL * p.H * D;  // slab row stride
  const bf16* src = p.qkv + (long long)(which * p.H + h) * D;
  const long long img = ((long long)h * gridDim.x + t) * kImg;

  if (which == 2) {
    // v: stage the 64 x D tile (rows past S zero), write its transpose.
    __shared__ __align__(16) bf16 s_v[kTile][D + 8];
    for (int c = threadIdx.x; c < kTile * (D / 8); c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row_base + r < p.S) {
        val = *reinterpret_cast<const uint4*>(
            src + (long long)(row_base + r) * ld + col);
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
      *reinterpret_cast<uint4*>(p.vt_img + img + c * 8) =
          *reinterpret_cast<const uint4*>(o);
    }
    return;
  }

  bf16* dst = (which == 0 ? p.q_img : p.k_img) + img;
  for (int c = threadIdx.x; c < kImg / 8; c += kThreads) {
    const int cm = c >> 3;
    const int r = (cm / (kDp / 8)) * 8 + (c & 7);
    const int col0 = (cm % (kDp / 8)) * 8;
    const int row = row_base + r;
    alignas(16) bf16 o[8];
    if (row < p.S && col0 < D) {
      const bf16* xr = src + (long long)row * ld;
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + col0);
      const uint4 cv =
          *reinterpret_cast<const uint4*>(p.cos + (long long)row * D + col0);
      const uint4 sv =
          *reinterpret_cast<const uint4*>(p.sin + (long long)row * D + col0);
      const bf16* x8 = reinterpret_cast<const bf16*>(&xv);
      const bf16* c8 = reinterpret_cast<const bf16*>(&cv);
      const bf16* s8 = reinterpret_cast<const bf16*>(&sv);
      alignas(16) bf16 part[8];  // rotate_half's partner of each element
      if constexpr (kHalf % 8 == 0) {
        const int pc = col0 < kHalf ? col0 + kHalf : col0 - kHalf;
        *reinterpret_cast<uint4*>(part) =
            *reinterpret_cast<const uint4*>(xr + pc);
      } else {  // D = 24: a chunk straddles the halves
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = col0 + e;
          part[e] = xr[col < kHalf ? col + kHalf : col - kHalf];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float a = __bfloat162float(x8[e]);
        float b = __bfloat162float(part[e]);
        if (col0 + e < kHalf) b = -b;
        o[e] = __float2bfloat16_rn(round_bf16(a * __bfloat162float(c8[e])) +
                                   round_bf16(b * __bfloat162float(s8[e])));
      }
    } else {
      *reinterpret_cast<uint4*>(o) = make_uint4(0u, 0u, 0u, 0u);
    }
    *reinterpret_cast<uint4*>(dst + c * 8) = *reinterpret_cast<const uint4*>(o);
  }

  if (which == 0 && h == 0) {  // block-uniform: one block per tile
    const int first = row_base < p.S ? p.seg[row_base] : 0;
    bool same = true;
    if (threadIdx.x < kTile) {
      const int row = row_base + threadIdx.x;
      same = (row < p.S ? p.seg[row] : 0) == first;
    }
    const int all_same = __syncthreads_and(same);
    if (threadIdx.x == 0) p.tile_seg[t] = all_same && first > 0 ? first : -1;
  }
}

// One kv tile of the online softmax for this thread's query rows g and g + 8
// (s: the tile's raw logits from wgmma, s[4n + e] = element e of 8-column
// block n), then o += P V by wgmma with P (bf16) from registers and B the
// tile's v^T image at sv. valid(n, e) says whether element (n, e) is a key
// its row may attend; a masked element gets p = 0 explicitly, so a row with
// no valid key keeps l = 0. The arithmetic is online_softmax_pv's
// (attn_common.cuh) with kExp.
template <int D, typename Valid>
__device__ __forceinline__ void softmax_pv(float (&s)[32],
                                           float (&o)[Dims<D>::kPad / 8][4],
                                           float& m0, float& m1, float& l0,
                                           float& l1, float sl2,
                                           const bf16* sv,
                                           const Valid& valid) {
  constexpr int kDp = Dims<D>::kPad;
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

template <int D>
constexpr int main_smem_bytes() {
  return (1 + 2 * kStages) * kTile * Dims<D>::kPad * (int)sizeof(bf16) +
         (1 + 2 * kStages) * (int)sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(kMainThreads, 2)
    fused_attn_main_kernel(const MainParams p) {
  constexpr int kDp = Dims<D>::kPad;
  constexpr int kImg = kTile * kDp;
  constexpr uint32_t kImgBytes = kImg * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kImg;             // [kStages][kImg]
  bf16* s_v = s_k + kStages * kImg;   // [kStages][kImg], v^T images
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_v + kStages * kImg);
  uint64_t* full = q_full + 1;        // [kStages]
  uint64_t* empty = full + kStages;   // [kStages]

  const int iq = blockIdx.x, h = blockIdx.y;
  const int n_tiles = gridDim.x;
  const long long head_img = (long long)h * n_tiles * kImg;
  int lo = 0, hi = n_tiles;
  if (p.bounds != nullptr) {
    lo = p.bounds[2 * iq];
    hi = p.bounds[2 * iq + 1];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();  // the last barrier of the block: the roles split here

  if (warp == kWarps) {  // producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kImgBytes);
      bulk_g2s(s_q, p.q_img + head_img + (long long)iq * kImg, kImgBytes,
               q_full);
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * kImgBytes);
        bulk_g2s(s_k + st * kImg, p.k_img + head_img + (long long)j * kImg,
                 kImgBytes, &full[st]);
        bulk_g2s(s_v + st * kImg, p.vt_img + head_img + (long long)j * kImg,
                 kImgBytes, &full[st]);
      }
    }
    return;
  }

  // Consumer warpgroup: warp w owns query rows [16w, 16w + 16) of the tile.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = iq * kTile + warp * 16 + g;  // rows row0 and row0 + 8
  const int seg0 = row0 < p.S ? p.seg[row0] : 0;
  const int seg1 = row0 + 8 < p.S ? p.seg[row0 + 8] : 0;
  const int q_uniform = p.tile_seg[iq];
  const float sl2 = p.scale * kLog2e;  // softmax in base 2

  float s[32];
  float o[kDp / 8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int n = 0; n < kDp / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
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
    if (q_uniform >= 0 && p.tile_seg[j] == q_uniform) {
      softmax_pv<D>(s, o, m0, m1, l0, l1, sl2, sv,
                    [](int, int) { return true; });
    } else {
      const int* kseg = p.seg + j * kTile;
      const int n_keys = p.S - j * kTile;  // keys at or past it are padding
      int ks[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e;
          ks[n][e] = c < n_keys ? kseg[c] : 0;
        }
      }
      softmax_pv<D>(s, o, m0, m1, l0, l1, sl2, sv, [&](int n, int e) {
        const int k = ks[n][e & 1];
        return (e < 2 ? seg0 : seg1) == k && k > 0;
      });
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with st
  }

  store_rows<D>(p.out + (long long)h * D, (long long)p.H * D, row0, p.S, o,
                l0, l1, lane);
}

template <int D>
int launch(const PrologueParams& pp, const MainParams& mp, int phases,
           cudaStream_t stream) {
  const int n_tiles = (pp.S + kTile - 1) / kTile;
  if (phases & 1) {
    fused_rotary_prologue_kernel<D>
        <<<dim3(n_tiles, pp.H, 3), kThreads, 0, stream>>>(pp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    constexpr int smem = main_smem_bytes<D>();
    const cudaError_t attr = cudaFuncSetAttribute(
        fused_attn_main_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return (int)attr;
    fused_attn_main_kernel<D>
        <<<dim3(n_tiles, mp.H), kMainThreads, smem, stream>>>(mp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace vst

// phases: 1 = the rotary prologue, 2 = the attention main loop, 3 = both
// (the wrapper's call). q_img / k_img / vt_img: [H, ceil(S / 64), 64 * Dp]
// bf16 scratch each; tile_seg: [ceil(S / 64)] int32 scratch.
extern "C" int vst_fused_vit_attn_fwd(const void* qkv, const void* cos,
                                      const void* sin, void* out,
                                      const int* seg, const int* bounds,
                                      void* q_img, void* k_img, void* vt_img,
                                      int* tile_seg, int S, int H, int D,
                                      float scale, int phases, void* stream) {
  vst::PrologueParams pp;
  pp.qkv = static_cast<const vst::bf16*>(qkv);
  pp.cos = static_cast<const vst::bf16*>(cos);
  pp.sin = static_cast<const vst::bf16*>(sin);
  pp.seg = seg;
  pp.q_img = static_cast<vst::bf16*>(q_img);
  pp.k_img = static_cast<vst::bf16*>(k_img);
  pp.vt_img = static_cast<vst::bf16*>(vt_img);
  pp.tile_seg = tile_seg;
  pp.S = S;
  pp.H = H;
  vst::MainParams mp;
  mp.q_img = pp.q_img;
  mp.k_img = pp.k_img;
  mp.vt_img = pp.vt_img;
  mp.tile_seg = tile_seg;
  mp.seg = seg;
  mp.bounds = bounds;
  mp.out = static_cast<vst::bf16*>(out);
  mp.S = S;
  mp.H = H;
  mp.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {  // keep in step with KERNEL_HEAD_DIMS in attention.py
    case 16: return vst::launch<16>(pp, mp, phases, st);
    case 24: return vst::launch<24>(pp, mp, phases, st);
    case 64: return vst::launch<64>(pp, mp, phases, st);
    case 80: return vst::launch<80>(pp, mp, phases, st);
    case 128: return vst::launch<128>(pp, mp, phases, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the main kernel for head dim D (0 if D is not
// one the kernel takes).
extern "C" int vst_fused_main_smem_bytes(int D) {
  switch (D) {
    case 16: return vst::main_smem_bytes<16>();
    case 24: return vst::main_smem_bytes<24>();
    case 64: return vst::main_smem_bytes<64>();
    case 80: return vst::main_smem_bytes<80>();
    case 128: return vst::main_smem_bytes<128>();
    default: return 0;
  }
}
