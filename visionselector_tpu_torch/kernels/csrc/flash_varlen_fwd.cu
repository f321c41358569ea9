// flash_varlen_fwd: segment-id (varlen) flash attention forward.
//
// Replaces two TPU kernels of visionselector_tpu/kernels/attention.py:
// _flash_pallas (_flash_kernel, whole kv per program) and
// _flash_pallas_streamed (_flash_kernel_streamed, kv streamed tile by tile
// with a kv_iters cap). A GPU kernel streams kv tiles anyway, so one kernel
// covers both entry points. The packed entry point (_flash_pallas_packed,
// [B, S, H * dp] slabs) is the same kernel launched on a strided view of
// the slab: the kernel reads q/k/v through strides, so no copy is made.
//
// Semantics (identical to the plain PyTorch version `flash_plain`): query
// row i may attend key j iff seg_q[i] == seg_k[j], seg_k[j] > 0 and, when
// causal, i >= j. Query tile iq visits kv tiles [lo, hi) from the bounds
// (the full range when no bounds are given), truncated to lo + kv_iters
// when kv_iters > 0, and capped at iq + 1 when causal. Rows with no valid
// key come out exactly 0. Softmax statistics and the output accumulator
// are fp32; p is rounded to bf16 before P V as the reference does.
//
// What bounds it on the H100: the ViT full-attention layers (S = 6144,
// 16 heads, D = 80) and the LM prefill are two matrix products plus one
// exp per (query, key) pair, so tensor-core issue rate and the exp/mask
// arithmetic bound it, not bytes (each kv tile is reused by 64 queries).
// The simple design keeps S and P in registers (mma.sync m16n8k16, the C
// fragment of S reused as the A fragment of P), double-buffers K/V tiles
// with cp.async so the next tile's load overlaps this tile's math, and
// skips kv tiles outside [lo, hi). D = 80 is five 16-wide k-steps of the
// mma, so it needs no padding; a D that is not a multiple of 16 is padded
// in shared memory by the loads' zero fill, never in the weights. Later
// work: wgmma + TMA, and splitting the exp over more warps.
//
// The full-attention ablation (vst_fullattn_ablate_fwd) replaces the TPU
// bench kernel tools/bench_fullattn_ablate.py: variant -> _kernel. It runs
// this same kernel, same grid, tiles and loads, with no bounds and the
// segment mask (kMask) and/or the exp (kExp) compiled out, to show which
// part of the production kernel owns its time. kMask = kExp = true is the
// production kernel itself.
//
// Layout: q/k/v are [B, S, H, D] read through strides (no transposes);
// GQA reads kv head h / (H / H_kv), so the caller never expands kv. out is
// a contiguous [B, Sq, H, D]. One block of 128 threads per (q tile, head,
// batch).
#include "attn_common.cuh"

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
  int causal;
  int kv_iters;  // 0: no cap
  float scale;
};

template <int D, bool kMask, bool kExp>
__global__ void __launch_bounds__(kThreads)
    flash_varlen_fwd_kernel(const FlashParams p) {
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
  if (p.causal) hi = min(hi, iq + 1);  // tiles starting past the last row

  // Q tile through the first K buffer into registers.
  load_tile_async<D>(s_k, qg, p.q_ss, q0, p.Sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[Dims<D>::kPad / 16][4];
  load_q_frags<D>(qf, s_k, warp, lane);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int seg0 = 0, seg1 = 0;
  if constexpr (kMask) {
    const int* qseg = p.q_seg + (long long)b * p.Sq;
    seg0 = row0 < p.Sq ? qseg[row0] : 0;
    seg1 = row0 + 8 < p.Sq ? qseg[row0 + 8] : 0;
  }
  __syncthreads();

  // K, V (and the key segment ids) of tile j into buffer `buf`.
  auto load_kv = [&](int j, int buf) {
    load_tile_async<D>(s_k + buf * kTile * kLd, kg, p.k_ss, j * kTile, p.Sk);
    load_tile_async<D>(s_v + buf * kTile * kLd, vg, p.v_ss, j * kTile, p.Sk);
    if constexpr (kMask) {
      if (threadIdx.x < kTile) {
        const int r = j * kTile + threadIdx.x;
        s_seg[buf * kTile + threadIdx.x] = r < p.Sk ? kseg[r] : 0;
      }
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
    auto valid = [&](int n, int e) {
      if constexpr (kMask) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int ks = sseg[col];
        const int row = e < 2 ? row0 : row0 + 8;
        return (e < 2 ? seg0 : seg1) == ks && ks > 0 &&
               (!p.causal || row >= j * kTile + col);
      } else {
        return true;
      }
    };
    online_softmax_pv<D, kExp>(s, o, m0, m1, l0, l1, p.scale, sv, lane, valid);
    __syncthreads();  // this buffer is refilled two iterations from now
  }

  // Without the exp, l stays 0 and the rows are stored undivided.
  bf16* og = p.out + ((long long)b * p.Sq * p.H + h) * D;
  store_rows<D>(og, (long long)p.H * D, row0, p.Sq, o, l0, l1, lane);
}

template <int D, bool kMask = true, bool kExp = true>
int launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int kLd = Dims<D>::kLd;
  const size_t smem = 2 * 2 * kTile * kLd * sizeof(bf16) + 2 * kTile * sizeof(int);
  cudaFuncSetAttribute(flash_varlen_fwd_kernel<D, kMask, kExp>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  flash_varlen_fwd_kernel<D, kMask, kExp><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_ablate(const FlashParams& p, int do_mask, int do_exp,
                  cudaStream_t stream) {
  if (do_mask && do_exp) return launch<D, true, true>(p, stream);
  if (do_mask) return launch<D, true, false>(p, stream);
  if (do_exp) return launch<D, false, true>(p, stream);
  return launch<D, false, false>(p, stream);
}

FlashParams make_params(const void* q, const void* k, const void* v,
                        void* out, const int* q_seg, const int* kv_seg,
                        const int* bounds, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, int B, int Sq, int Sk, int H, int Hkv,
                        int causal, int kv_iters, float scale) {
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
  p.causal = causal;
  p.kv_iters = kv_iters;
  p.scale = scale;
  return p;
}

}  // namespace vst

extern "C" int vst_flash_varlen_fwd(
    const void* q, const void* k, const void* v, void* out, const int* q_seg,
    const int* kv_seg, const int* bounds, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int B, int Sq, int Sk,
    int H, int Hkv, int D, int causal, int kv_iters, float scale,
    void* stream) {
  const vst::FlashParams p = vst::make_params(
      q, k, v, out, q_seg, kv_seg, bounds, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, B, Sq, Sk, H, Hkv, causal, kv_iters, scale);
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

// The ablation: q/k/v [B, S, H, D] through strides, one seg [B, S] for
// queries and keys, no bounds, no causal mask, no kv_iters cap.
extern "C" int vst_fullattn_ablate_fwd(
    const void* q, const void* k, const void* v, void* out, const int* seg,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int S, int H, int D, int do_mask, int do_exp,
    float scale, void* stream) {
  const vst::FlashParams p = vst::make_params(
      q, k, v, out, seg, seg, nullptr, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, B, S, S, H, H, 0, 0, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return vst::launch_ablate<16>(p, do_mask, do_exp, st);
    case 24: return vst::launch_ablate<24>(p, do_mask, do_exp, st);
    case 64: return vst::launch_ablate<64>(p, do_mask, do_exp, st);
    case 80: return vst::launch_ablate<80>(p, do_mask, do_exp, st);
    case 128: return vst::launch_ablate<128>(p, do_mask, do_exp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
