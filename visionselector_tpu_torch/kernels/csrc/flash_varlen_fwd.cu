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
// Two routes, chosen by the `causal` argument:
//
// Non-causal (the ViT's full-attention layers, K1 with bounds; K2 with a
// kv_iters cap; K3 on the padded slab; K7's four variants): two launches.
//  1. flash_images_prologue_kernel: one block of 128 threads per (64-row
//     tile, head, q | k | v, batch) reads the tile with 16-byte loads and
//     writes it as a wgmma tile image (wgmma_attn.cuh: q and k K-major, v
//     transposed, zero pads and rows past S zero) into scratch; the head-0
//     blocks of q and of v also write the q and kv tile_seg. No rotation.
//     Bound: bytes, q, k and v read once and the images written once (47.2
//     MB each way at S = 6144, H = 16, D = 80).
//  2. flash_wgmma_main_kernel<D, kMask, kExp>: the wgmma main loop of
//     wgmma_attn.cuh (shared with the fused ViT kernel): a producer warp
//     feeds a 3-stage ring of k and v^T images by bulk async copies, one
//     consumer warpgroup runs wgmma for Q K^T and P V with the softmax in
//     registers, and a kv tile whose tile_seg equals the q tile's takes the
//     mask-free step. Bound: two matrix products and one exp per visited
//     (query, key) pair (operations; each kv tile is reused by 64 queries).
//     Dynamic shared memory: the q image and 3 stages of k and v^T images,
//     71,736 bytes at D = 80 (three blocks per SM), 114,744 at Dp = 128
//     (two blocks per SM; 3 stages kept, 2 would not fit a third block).
//
// Causal (the LM prefill): flash_causal_fwd_kernel, one block of 128
// threads per (q tile, head, batch), mma.sync m16n8k16 with S and P in
// registers (the C fragment of S reused as the A fragment of P), K/V tiles
// double-buffered with cp.async, kv tiles past the diagonal skipped, a
// segment-id and position compare per element. Bound: operations (half the
// pairs of the tiles up to the diagonal). Moving it onto the wgmma main
// loop is later work.
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
  // The non-causal route's scratch: tile images and tile segment ids.
  bf16* q_img;   // [B, H, ceil(Sq / 64), 64 * Dp]
  bf16* k_img;   // [B, H_kv, ceil(Sk / 64), 64 * Dp]
  bf16* vt_img;  // [B, H_kv, ceil(Sk / 64), 64 * Dp]
  int* q_tseg;   // [B, ceil(Sq / 64)]
  int* kv_tseg;  // [B, ceil(Sk / 64)]
};

// --- non-causal: image prologue, then the wgmma main loop -----------------

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

template <int D, bool kMask, bool kExp>
__global__ void __launch_bounds__(kMainThreads, 2)
    flash_wgmma_main_kernel(const WgmmaAttnParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  wgmma_attn_block<D, kMask, kExp>(p, smem_raw, blockIdx.x, blockIdx.y,
                                   blockIdx.z);
}

// phases: 1 = the prologue, 2 = the main loop (on images a prologue
// wrote), 3 = both.
template <int D, bool kMask, bool kExp>
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
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_wgmma_main_kernel<D, kMask, kExp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    flash_wgmma_main_kernel<D, kMask, kExp>
        <<<dim3(nq, p.H, p.B), kMainThreads, smem, stream>>>(m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int D>
int launch_ablate(const FlashParams& p, int do_mask, int do_exp, int phases,
                  cudaStream_t stream) {
  if (do_mask && do_exp) return launch_wgmma<D, true, true>(p, phases, stream);
  if (do_mask) return launch_wgmma<D, true, false>(p, phases, stream);
  if (do_exp) return launch_wgmma<D, false, true>(p, phases, stream);
  return launch_wgmma<D, false, false>(p, phases, stream);
}

// --- causal: the mma.sync kernel -------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_causal_fwd_kernel(const FlashParams p) {
  constexpr int kLd = Dims<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [2][64][kLd]
  bf16* s_v = s_k + 2 * kTile * kLd;              // [2][64][kLd]
  int* s_seg = reinterpret_cast<int*>(s_v + 2 * kTile * kLd);  // [2][64]

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * kTile;

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;
  const int* kseg = p.kv_seg + (long long)b * p.Sk;

  int lo = 0, hi = (p.Sk + kTile - 1) / kTile;
  if (p.bounds != nullptr) {
    lo = p.bounds[2 * iq];
    hi = p.bounds[2 * iq + 1];
  }
  if (p.kv_iters > 0) hi = min(hi, lo + p.kv_iters);
  hi = min(hi, iq + 1);  // tiles starting past the last row

  // Q tile through the first K buffer into registers.
  load_tile_async<D>(s_k, qg, p.q_ss, q0, p.Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[Dims<D>::kPad / 16][4];
  load_q_frags<D>(qf, s_k, warp, lane);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int* qseg = p.q_seg + (long long)b * p.Sq;
  const int seg0 = row0 < p.Sq ? qseg[row0] : 0;
  const int seg1 = row0 + 8 < p.Sq ? qseg[row0 + 8] : 0;
  __syncthreads();

  // K, V and the key segment ids of tile j into buffer `buf`.
  auto load_kv = [&](int j, int buf) {
    load_tile_async<D>(s_k + buf * kTile * kLd, kg, p.k_ss, j * kTile, p.Sk);
    load_tile_async<D>(s_v + buf * kTile * kLd, vg, p.v_ss, j * kTile, p.Sk);
    if (threadIdx.x < kTile) {
      const int r = j * kTile + threadIdx.x;
      s_seg[buf * kTile + threadIdx.x] = r < p.Sk ? kseg[r] : 0;
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
    const bf16* sk = s_k + buf * kTile * kLd;
    const bf16* sv = s_v + buf * kTile * kLd;
    const int* sseg = s_seg + buf * kTile;

    float s[8][4];
    qk_tile<D>(s, qf, sk, lane);
    online_softmax_pv<D>(s, o, m0, m1, l0, l1, p.scale, sv, lane,
                         [&](int n, int e) {
                           const int col = n * 8 + 2 * t + (e & 1);
                           const int ks = sseg[col];
                           const int row = e < 2 ? row0 : row0 + 8;
                           return (e < 2 ? seg0 : seg1) == ks && ks > 0 &&
                                  row >= j * kTile + col;
                         });
    __syncthreads();  // this buffer is refilled two iterations from now
  }

  bf16* og = p.out + ((long long)b * p.Sq * p.H + h) * D;
  store_rows<D>(og, (long long)p.H * D, row0, p.Sq, o, l0, l1, lane);
}

template <int D>
int launch_causal(const FlashParams& p, cudaStream_t stream) {
  constexpr int kLd = Dims<D>::kLd;
  const size_t smem = 2 * 2 * kTile * kLd * sizeof(bf16) + 2 * kTile * sizeof(int);
  cudaFuncSetAttribute(flash_causal_fwd_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  flash_causal_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const FlashParams& p, int causal, int phases, cudaStream_t stream) {
  return causal ? launch_causal<D>(p, stream)
                : launch_wgmma<D, true, true>(p, phases, stream);
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

// causal = 0 takes the wgmma route (q_img .. kv_tseg: its scratch; phases
// 1 = the prologue, 2 = the main loop, 3 = both); causal = 1 the mma.sync
// kernel (the scratch and phases unused).
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
  switch (D) {  // keep in step with KERNEL_HEAD_DIMS in attention.py
    case 16: return vst::launch<16>(p, causal, phases, st);
    case 24: return vst::launch<24>(p, causal, phases, st);
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

// Dynamic shared memory of the wgmma main loop (both routes that run it)
// for head dim D, and how many of its blocks fit on one SM; 0 if D is not
// one the kernels take.
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

template <int D>
static int blocks_per_sm() {
  constexpr int smem = vst::main_smem_bytes<D>();
  auto kernel = vst::flash_wgmma_main_kernel<D, true, true>;
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

extern "C" int vst_wgmma_main_blocks_per_sm(int D) {
  switch (D) {
    case 16: return blocks_per_sm<16>();
    case 24: return blocks_per_sm<24>();
    case 64: return blocks_per_sm<64>();
    case 80: return blocks_per_sm<80>();
    case 128: return blocks_per_sm<128>();
    default: return 0;
  }
}
