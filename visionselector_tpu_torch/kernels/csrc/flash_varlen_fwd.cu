// flash_varlen_fwd: segment-id (varlen) flash attention forward.
//
// Replaces four TPU kernels: of visionselector_tpu/kernels/attention.py,
// _flash_pallas (_flash_kernel, whole kv per program), _flash_pallas_streamed
// (_flash_kernel_streamed, kv streamed tile by tile with a kv_iters cap) and
// _flash_pallas_packed (_flash_kernel on [B, S, H * dp] slabs, here launched
// on a strided view of the slab, no copy); and the full-attention bench
// kernel of tools/bench_fullattn_ablate.py (variant -> _kernel), whose
// variants compile the segment mask (kMask) and/or the exp (kExp) out
// (vst_fullattn_ablate_fwd, no bounds).
//
// Semantics (identical to the plain PyTorch version `flash_plain`): query
// row i may attend key j iff seg_q[i] == seg_k[j], seg_k[j] > 0 and, when
// causal, i >= j. Query tile iq visits kv tiles [lo, hi) from the bounds
// (the full range when no bounds are given), truncated to lo + kv_iters
// when kv_iters > 0, and capped at iq + 1 when causal. Rows with no valid
// key come out exactly 0. Softmax statistics and the output accumulator
// are fp32; p is rounded to bf16 before P V as the reference does.
//
// Layout: q/k/v are [B, S, H, D] read through strides (no transposes;
// base pointers and batch, row and head strides 16-byte aligned); GQA
// reads kv head h / (H / H_kv), so the caller never expands kv. out is a
// contiguous [B, Sq, H, D].
//
// Every call makes two launches (the ViT's full-attention layers, K1 with
// bounds; K2 with a kv_iters cap; K3 on the padded slab; K7's four
// variants; the causal LM prefill, K1 and K3 with causal = 1):
//  1. flash_images_prologue_kernel: one block of 128 threads per (64-row
//     tile, head, q | k | v, batch) reads the tile with 16-byte loads and
//     writes it as a wgmma tile image (wgmma_attn.cuh: q and k K-major, v
//     transposed, zero pads and rows past S zero) into scratch; the head-0
//     blocks of q and of v also write the q and kv tile_seg. No rotation.
//     Bound: bytes, q, k and v read once and the images written once (47.2
//     MB each way at S = 6144, H = 16, D = 80; at GQA 16/2 it writes 2
//     heads of k and v^T images and 16 of q).
//  2. flash_wgmma_main_kernel<D, kMask, kExp, kCausal>: the wgmma main loop
//     of wgmma_attn.cuh (shared with the fused ViT kernel): a producer warp
//     feeds a 3-stage ring of k and v^T images by bulk async copies, one
//     consumer warpgroup runs wgmma for Q K^T and P V with the softmax in
//     registers, and a kv tile whose tile_seg equals the q tile's takes the
//     mask-free step. Bound: two matrix products and one exp per visited
//     (query, key) pair (operations; each kv tile is reused by 64 queries).
//     Dynamic shared memory: the q image and 3 stages of k and v^T images,
//     71,736 bytes at D = 80 (three blocks per SM), 114,744 at Dp = 128
//     (two blocks per SM; 3 stages kept, 2 would not fit a third block).
//     kCausal (the LM prefill): kv tiles past the diagonal are not visited
//     and the diagonal tile compares positions, so a q tile carries iq + 1
//     steps (half the pairs of the tiles up to the diagonal); a q tile of
//     padding rows only visits none. Its grid is (H, nq, B) with q tile
//     nq - 1 - blockIdx.y: the heaviest tiles of every head start first.
#include "attn_common.cuh"
#include "wgmma_attn.cuh"

namespace vst {

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  const int* q_seg;   // [B, Sq]
  const int* kv_seg;  // [B, Sk]
  const int* bounds;  // [ceil(Sq / 64), 2] or null (full range)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, Sq, Sk, H, Hkv;
  int kv_iters;  // 0: no cap
  float scale;
  // Scratch: tile images and tile segment ids.
  bf16* q_img;   // [B, H, ceil(Sq / 64), 64 * Dp]
  bf16* k_img;   // [B, H_kv, ceil(Sk / 64), 64 * Dp]
  bf16* vt_img;  // [B, H_kv, ceil(Sk / 64), 64 * Dp]
  int* q_tseg;   // [B, ceil(Sq / 64)]
  int* kv_tseg;  // [B, ceil(Sk / 64)]
};

// --- the image prologue, then the wgmma main loop -----------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_images_prologue_kernel(const FlashParams p) {
  constexpr int kImg = kTile * Dims<D>::kPad;
  const int t = blockIdx.x, h = blockIdx.y;
  const int which = blockIdx.z % 3, b = blockIdx.z / 3;  // q, k, v
  const int n_rows = which == 0 ? p.Sq : p.Sk;
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  const int heads = which == 0 ? p.H : p.Hkv;
  if (t >= n_tiles || h >= heads) return;  // the grid covers the larger
  const int row_base = t * kTile;
  const long long img = (((long long)b * heads + h) * n_tiles + t) * kImg;

  if (which == 2) {
    write_vt_image<D>(p.vt_img + img, p.v + b * p.v_sb + h * p.v_sh, p.v_ss,
                      row_base, n_rows);
    if (h == 0) {  // block-uniform: one block per kv tile
      write_tile_seg(p.kv_tseg + (long long)b * n_tiles + t,
                     p.kv_seg + (long long)b * p.Sk, row_base, n_rows);
    }
    return;
  }

  const bf16* src = which == 0 ? p.q + b * p.q_sb + h * p.q_sh
                               : p.k + b * p.k_sb + h * p.k_sh;
  const long long ss = which == 0 ? p.q_ss : p.k_ss;
  write_row_image<D>((which == 0 ? p.q_img : p.k_img) + img, row_base, n_rows,
                     [&](int row, int col0) {
                       return *reinterpret_cast<const uint4*>(
                           src + row * ss + col0);
                     });
  if (which == 0 && h == 0) {  // block-uniform: one block per q tile
    write_tile_seg(p.q_tseg + (long long)b * n_tiles + t,
                   p.q_seg + (long long)b * p.Sq, row_base, n_rows);
  }
}

template <int D, bool kMask, bool kExp, bool kCausal>
__global__ void __launch_bounds__(kMainThreads, 2)
    flash_wgmma_main_kernel(const WgmmaAttnParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if constexpr (kCausal) {  // grid (H, nq, B), the last q tile first
    wgmma_attn_block<D, kMask, kExp, true>(
        p, smem_raw, gridDim.y - 1 - blockIdx.y, blockIdx.x, blockIdx.z);
  } else {  // grid (nq, H, B)
    wgmma_attn_block<D, kMask, kExp, false>(p, smem_raw, blockIdx.x,
                                            blockIdx.y, blockIdx.z);
  }
}

// phases: 1 = the prologue, 2 = the main loop (on images a prologue
// wrote), 3 = both.
template <int D, bool kMask, bool kExp, bool kCausal>
int launch_wgmma(const FlashParams& p, int phases, cudaStream_t stream) {
  const int nq = (p.Sq + kTile - 1) / kTile, nk = (p.Sk + kTile - 1) / kTile;
  if (phases & 1) {
    flash_images_prologue_kernel<D>
        <<<dim3(nq > nk ? nq : nk, p.H, 3 * p.B), kThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    WgmmaAttnParams m;
    m.q_img = p.q_img;
    m.k_img = p.k_img;
    m.vt_img = p.vt_img;
    m.q_tseg = p.q_tseg;
    m.kv_tseg = p.kv_tseg;
    m.q_seg = p.q_seg;
    m.kv_seg = p.kv_seg;
    m.bounds = p.bounds;
    m.out = p.out;
    m.out_ld = (long long)p.H * D;
    m.Sq = p.Sq;
    m.Sk = p.Sk;
    m.H = p.H;
    m.Hkv = p.Hkv;
    m.kv_iters = p.kv_iters;
    m.scale = p.scale;
    constexpr int smem = main_smem_bytes<D>();
    auto kernel = flash_wgmma_main_kernel<D, kMask, kExp, kCausal>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid = kCausal ? dim3(p.H, nq, p.B) : dim3(nq, p.H, p.B);
    kernel<<<grid, kMainThreads, smem, stream>>>(m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int D>
int launch_ablate(const FlashParams& p, int do_mask, int do_exp, int phases,
                  cudaStream_t stream) {
  if (do_mask && do_exp) {
    return launch_wgmma<D, true, true, false>(p, phases, stream);
  }
  if (do_mask) return launch_wgmma<D, true, false, false>(p, phases, stream);
  if (do_exp) return launch_wgmma<D, false, true, false>(p, phases, stream);
  return launch_wgmma<D, false, false, false>(p, phases, stream);
}

template <int D>
int launch(const FlashParams& p, int causal, int phases, cudaStream_t stream) {
  return causal ? launch_wgmma<D, true, true, true>(p, phases, stream)
                : launch_wgmma<D, true, true, false>(p, phases, stream);
}

FlashParams make_params(const void* q, const void* k, const void* v,
                        void* out, const int* q_seg, const int* kv_seg,
                        const int* bounds, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int B, int Sq, int Sk, int H, int Hkv,
                        int kv_iters, float scale, void* q_img, void* k_img,
                        void* vt_img, int* q_tseg, int* kv_tseg) {
  FlashParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.q_seg = q_seg;
  p.kv_seg = kv_seg;
  p.bounds = bounds;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.Hkv = Hkv;
  p.kv_iters = kv_iters;
  p.scale = scale;
  p.q_img = static_cast<bf16*>(q_img);
  p.k_img = static_cast<bf16*>(k_img);
  p.vt_img = static_cast<bf16*>(vt_img);
  p.q_tseg = q_tseg;
  p.kv_tseg = kv_tseg;
  return p;
}

}  // namespace vst

// q_img .. kv_tseg: the scratch the prologue writes and the main loop reads;
// phases 1 = the prologue, 2 = the main loop, 3 = both; causal selects the
// main loop's instantiation.
extern "C" int vst_flash_varlen_fwd(
    const void* q, const void* k, const void* v, void* out, const int* q_seg,
    const int* kv_seg, const int* bounds, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int B, int Sq, int Sk,
    int H, int Hkv, int D, int causal, int kv_iters, float scale, void* q_img,
    void* k_img, void* vt_img, int* q_tseg, int* kv_tseg, int phases,
    void* stream) {
  const vst::FlashParams p = vst::make_params(
      q, k, v, out, q_seg, kv_seg, bounds, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, B, Sq, Sk, H, Hkv, kv_iters, scale, q_img, k_img,
      vt_img, q_tseg, kv_tseg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {  // keep in step with FLASH_HEAD_DIMS in attention.py
    case 16: return vst::launch<16>(p, causal, phases, st);
    case 24: return vst::launch<24>(p, causal, phases, st);
    case 32: return vst::launch<32>(p, causal, phases, st);
    case 64: return vst::launch<64>(p, causal, phases, st);
    case 80: return vst::launch<80>(p, causal, phases, st);
    case 128: return vst::launch<128>(p, causal, phases, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The ablation on the wgmma route: q/k/v [B, S, H, D] through strides, one
// seg [B, S] for queries and keys, no bounds, no kv_iters cap; scratch and
// phases as vst_flash_varlen_fwd's.
extern "C" int vst_fullattn_ablate_fwd(
    const void* q, const void* k, const void* v, void* out, const int* seg,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int S, int H, int D, int do_mask, int do_exp,
    float scale, void* q_img, void* k_img, void* vt_img, int* q_tseg,
    int* kv_tseg, int phases, void* stream) {
  const vst::FlashParams p = vst::make_params(
      q, k, v, out, seg, seg, nullptr, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, B, S, S, H, H, 0, scale, q_img, k_img, vt_img, q_tseg,
      kv_tseg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return vst::launch_ablate<16>(p, do_mask, do_exp, phases, st);
    case 24: return vst::launch_ablate<24>(p, do_mask, do_exp, phases, st);
    case 64: return vst::launch_ablate<64>(p, do_mask, do_exp, phases, st);
    case 80: return vst::launch_ablate<80>(p, do_mask, do_exp, phases, st);
    case 128: return vst::launch_ablate<128>(p, do_mask, do_exp, phases, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the wgmma main loop (the flash and the fused
// kernels') for head dim D, and how many blocks of the flash main loop
// (causal or not) fit on one SM; 0 if D is not one the kernels take.
extern "C" int vst_wgmma_main_smem_bytes(int D) {
  switch (D) {
    case 16: return vst::main_smem_bytes<16>();
    case 24: return vst::main_smem_bytes<24>();
    case 64: return vst::main_smem_bytes<64>();
    case 80: return vst::main_smem_bytes<80>();
    case 128: return vst::main_smem_bytes<128>();
    default: return 0;
  }
}

template <int D, bool kCausal>
static int blocks_per_sm() {
  constexpr int smem = vst::main_smem_bytes<D>();
  auto kernel = vst::flash_wgmma_main_kernel<D, true, true, kCausal>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, vst::kMainThreads, smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

template <int D>
static int blocks_per_sm(int causal) {
  return causal ? blocks_per_sm<D, true>() : blocks_per_sm<D, false>();
}

extern "C" int vst_wgmma_main_blocks_per_sm(int D, int causal) {
  switch (D) {
    case 16: return blocks_per_sm<16>(causal);
    case 24: return blocks_per_sm<24>(causal);
    case 64: return blocks_per_sm<64>(causal);
    case 80: return blocks_per_sm<80>(causal);
    case 128: return blocks_per_sm<128>(causal);
    default: return 0;
  }
}
