// fused_vit_attn_fwd: rotary + segment-masked flash attention straight from
// the ViT's qkv projection slab.
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
// Design for the H100: the TPU program holds all 16 heads of a 256-row q
// block in VMEM; here a 64 x 1280 q tile alone would fill shared memory, so
// one block of 128 threads handles one (64-row q tile, head), as the flash
// kernel does, and reads q, k and v rows straight from the slab through the
// row stride 3 * H * D (no split, no copy). The q tile is rotated once in
// shared memory before its fragments are loaded; each k tile is rotated in
// place after it lands (cp.async, double-buffered as in the flash kernel),
// reading the tile's cos/sin rows from global memory (they stay in L2: 2 x
// 0.98 MB at S = 6144, D = 80). The softmax tile step is the flash
// kernel's (online_softmax_pv, attn_common.cuh). What bounds it: a full
// layer is two matrix products plus one exp per (query, key) pair, like
// the flash kernel, plus the rotation of every visited k tile; a window
// layer visits one kv tile per q tile and is bound by reading the slab.
#include "attn_common.cuh"

namespace vst {

struct FusedParams {
  const bf16* qkv;    // [S, 3 * H * D]
  const bf16* cos;    // [S, D]
  const bf16* sin;    // [S, D]
  bf16* out;          // [S, H * D]
  const int* seg;     // [S]
  const int* bounds;  // [ceil(S / 64), 2] or null (full range)
  int S, H;
  float scale;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rotate-half rotary in place on the rows [row0, row0 + 64) of a shared
// [64][Dp + 8] tile: for i < D / 2, x[i] <- x[i] cos[i] - x[i + D/2] sin[i]
// and x[i + D/2] <- x[i + D/2] cos[i + D/2] + x[i] sin[i + D/2], rounded as
// the header says. Rows at or past n_rows are zero-filled and stay so.
template <int D>
__device__ __forceinline__ void rotate_tile(bf16* tile, const bf16* cos,
                                            const bf16* sin, int row0,
                                            int n_rows) {
  constexpr int kLd = Dims<D>::kLd, kHalf = D / 2;
  for (int c = threadIdx.x; c < kTile * kHalf; c += kThreads) {
    const int r = c / kHalf, i = c % kHalf;
    if (row0 + r >= n_rows) continue;
    bf16* x = tile + r * kLd;
    const bf16* cr = cos + (long long)(row0 + r) * D;
    const bf16* sr = sin + (long long)(row0 + r) * D;
    const float a = __bfloat162float(x[i]);
    const float b = __bfloat162float(x[i + kHalf]);
    x[i] = __float2bfloat16_rn(round_bf16(a * __bfloat162float(cr[i])) +
                               round_bf16(-b * __bfloat162float(sr[i])));
    x[i + kHalf] = __float2bfloat16_rn(
        round_bf16(b * __bfloat162float(cr[i + kHalf])) +
        round_bf16(a * __bfloat162float(sr[i + kHalf])));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_vit_attn_fwd_kernel(const FusedParams p) {
  constexpr int kLd = Dims<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [2][64][kLd]
  bf16* s_v = s_k + 2 * kTile * kLd;              // [2][64][kLd]
  int* s_seg = reinterpret_cast<int*>(s_v + 2 * kTile * kLd);  // [2][64]

  const int iq = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * kTile;
  const long long ld = 3LL * p.H * D;  // slab row stride
  const bf16* qg = p.qkv + (long long)h * D;
  const bf16* kg = p.qkv + (long long)(p.H + h) * D;
  const bf16* vg = p.qkv + (long long)(2 * p.H + h) * D;

  int lo = 0, hi = (p.S + kTile - 1) / kTile;
  if (p.bounds != nullptr) {
    lo = p.bounds[2 * iq];
    hi = p.bounds[2 * iq + 1];
  }

  // Q tile through the first K buffer, rotated once, into registers.
  load_tile_async<D>(s_k, qg, ld, q0, p.S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  rotate_tile<D>(s_k, p.cos, p.sin, q0, p.S);
  __syncthreads();
  uint32_t qf[Dims<D>::kPad / 16][4];
  load_q_frags<D>(qf, s_k, warp, lane);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int seg0 = row0 < p.S ? p.seg[row0] : 0;
  const int seg1 = row0 + 8 < p.S ? p.seg[row0 + 8] : 0;
  __syncthreads();

  auto load_kv = [&](int j, int buf) {
    load_tile_async<D>(s_k + buf * kTile * kLd, kg, ld, j * kTile, p.S);
    load_tile_async<D>(s_v + buf * kTile * kLd, vg, ld, j * kTile, p.S);
    if (threadIdx.x < kTile) {
      const int r = j * kTile + threadIdx.x;
      s_seg[buf * kTile + threadIdx.x] = r < p.S ? p.seg[r] : 0;
    }
    cp_async_commit();
  };

  float o[Dims<D>::kPad / 8][4];
#pragma unroll
  for (int n = 0; n < Dims<D>::kPad / 8; ++n) {
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  if (lo < hi) load_kv(lo, 0);
  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {  // prefetch the next tile into the other buffer
      load_kv(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* sk = s_k + buf * kTile * kLd;
    const bf16* sv = s_v + buf * kTile * kLd;
    const int* sseg = s_seg + buf * kTile;
    rotate_tile<D>(sk, p.cos, p.sin, j * kTile, p.S);
    __syncthreads();

    float s[8][4];
    qk_tile<D>(s, qf, sk, lane);
    auto valid = [&](int n, int e) {
      const int ks = sseg[n * 8 + 2 * t + (e & 1)];
      return (e < 2 ? seg0 : seg1) == ks && ks > 0;
    };
    online_softmax_pv<D, true>(s, o, m0, m1, l0, l1, p.scale, sv, lane,
                               valid);
    __syncthreads();  // this buffer is refilled two iterations from now
  }

  store_rows<D>(p.out + (long long)h * D, (long long)p.H * D, row0, p.S, o,
                l0, l1, lane);
}

template <int D>
int launch(const FusedParams& p, cudaStream_t stream) {
  constexpr int kLd = Dims<D>::kLd;
  const size_t smem = 2 * 2 * kTile * kLd * sizeof(bf16) + 2 * kTile * sizeof(int);
  cudaFuncSetAttribute(fused_vit_attn_fwd_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((p.S + kTile - 1) / kTile, p.H);
  fused_vit_attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace vst

extern "C" int vst_fused_vit_attn_fwd(const void* qkv, const void* cos,
                                      const void* sin, void* out,
                                      const int* seg, const int* bounds,
                                      int S, int H, int D, float scale,
                                      void* stream) {
  vst::FusedParams p;
  p.qkv = static_cast<const vst::bf16*>(qkv);
  p.cos = static_cast<const vst::bf16*>(cos);
  p.sin = static_cast<const vst::bf16*>(sin);
  p.out = static_cast<vst::bf16*>(out);
  p.seg = seg;
  p.bounds = bounds;
  p.S = S;
  p.H = H;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {  // keep in step with KERNEL_HEAD_DIMS in attention.py
    case 16: return vst::launch<16>(p, st);
    case 24: return vst::launch<24>(p, st);
    case 64: return vst::launch<64>(p, st);
    case 80: return vst::launch<80>(p, st);
    case 128: return vst::launch<128>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
