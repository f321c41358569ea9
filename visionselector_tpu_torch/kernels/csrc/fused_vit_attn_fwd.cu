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
//    (wgmma_attn.cuh: no-swizzle K-major core matrices) into scratch
//    [H, ceil(S / 64), 64 * Dp] bf16, Dp = D rounded up to 16. The q blocks
//    of head 0 also write tile_seg [ceil(S / 64)]. Bound: bytes, the slab
//    read once and the images written once (47.2 MB each way at S = 6144,
//    H = 16, D = 80).
// 2. fused_attn_main_kernel: the wgmma main loop of wgmma_attn.cuh (shared
//    with the flash kernel's non-causal route) with the mask and the exp,
//    B = 1, H_kv = H, no kv_iters cap, q and kv segments both `seg`.
//    Nothing is rotated in the kv loop. Bound: a full layer is two matrix
//    products and one exp per visited (query, key) pair (operations); a
//    window layer visits one kv tile per q tile and is bound by reading the
//    images. Each product is waited for before the softmax runs: three
//    blocks share an SM (127 registers, 70 KB of shared memory), and their
//    interleaving already overlaps one block's softmax with another's
//    products. Issuing tile j's Q K^T with tile j - 1's P V and running
//    tile j's softmax under that P V measured 9% slower on the H100 (full
//    layer at S = 6144, H = 16, D = 80: 0.727-0.731 ms against 0.668).
#include "wgmma_attn.cuh"

namespace vst {

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_rotary_prologue_kernel(const PrologueParams p) {
  constexpr int kHalf = D / 2;
  constexpr int kImg = kTile * Dims<D>::kPad;  // elements of one tile image
  const int t = blockIdx.x, h = blockIdx.y, which = blockIdx.z;  // q, k, v
  const int row_base = t * kTile;
  const long long ld = 3LL * p.H * D;  // slab row stride
  const bf16* src = p.qkv + (long long)(which * p.H + h) * D;
  const long long img = ((long long)h * gridDim.x + t) * kImg;

  if (which == 2) {
    write_vt_image<D>(p.vt_img + img, src, ld, row_base, p.S);
    return;
  }

  write_row_image<D>(
      (which == 0 ? p.q_img : p.k_img) + img, row_base, p.S,
      [&](int row, int col0) {
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
        alignas(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = __bfloat162float(x8[e]);
          float b = __bfloat162float(part[e]);
          if (col0 + e < kHalf) b = -b;
          o[e] = __float2bfloat16_rn(
              round_bf16(a * __bfloat162float(c8[e])) +
              round_bf16(b * __bfloat162float(s8[e])));
        }
        return *reinterpret_cast<const uint4*>(o);
      });

  if (which == 0 && h == 0) {  // block-uniform: one block per tile
    write_tile_seg(p.tile_seg + t, p.seg, row_base, p.S);
  }
}

template <int D>
__global__ void __launch_bounds__(kMainThreads, 2)
    fused_attn_main_kernel(const WgmmaAttnParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  wgmma_attn_block<D, true, true, false>(p, smem_raw, blockIdx.x, blockIdx.y,
                                         0);
}

template <int D>
int launch(const PrologueParams& pp, const WgmmaAttnParams& mp, int phases,
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
  vst::WgmmaAttnParams mp;
  mp.q_img = pp.q_img;
  mp.k_img = pp.k_img;
  mp.vt_img = pp.vt_img;
  mp.q_tseg = tile_seg;
  mp.kv_tseg = tile_seg;
  mp.q_seg = seg;
  mp.kv_seg = seg;
  mp.bounds = bounds;
  mp.out = static_cast<vst::bf16*>(out);
  mp.out_ld = (long long)H * D;
  mp.Sq = S;
  mp.Sk = S;
  mp.H = H;
  mp.Hkv = H;
  mp.kv_iters = 0;
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
