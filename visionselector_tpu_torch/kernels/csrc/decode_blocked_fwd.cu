// decode_blocked_fwd: length-aware GQA decode attention over a KV cache.
//
// Replaces the TPU kernel _decode_blocked_pallas (_decode_blocked_kernel) of
// visionselector_tpu/kernels/attention.py.
//
// Semantics (identical to the plain PyTorch version `decode_blocked_plain`):
// q is [B, t_c, Hq, D]; the caches are [B, T, Hkv, D] (bf16, or int8 with
// per-row f32 scales [B, T, Hkv]) and are never expanded: query head h reads
// kv head h / (Hq / Hkv). Chunk row i of slot b attends to cache positions
// < base_len[b] + i + 1. With int8 caches the k scale multiplies the logits
// and the v scale multiplies p after the row sum, as the TPU kernel does;
// the tiles load as int8 and become bf16 in shared memory. Softmax
// statistics and the accumulator are fp32, p is rounded to bf16 before P V,
// and a row with no valid key comes out exactly 0.
//
// What bounds it on the H100: a decode step reads every live cache row once
// and does 4 * D flop per (query row, key), so it moves bytes (about one
// flop per byte at t_c = 1, far below the ~295 the tensor cores need). The
// design therefore reads only the live prefix, ceil((base_len + t_c) / 64)
// tiles of each slot (the TPU kernel's clamped index map becomes a loop
// bound), and spreads those tiles over enough blocks to keep many loads in
// flight: at 3B one step has only B * Hkv = 16 (slot, kv head) pairs, so
// each pair's live tiles are split into contiguous ranges, one per block
// (flash-decoding). A block holds the pair's n_rep query heads of up to 16
// chunk rows as the 16 rows of one mma.sync m16n8k16 tile (8 real rows at
// t_c = 1), double-buffers K/V tiles with cp.async, and gives each of its
// four warps 16 keys of every 64-key tile; the warps' softmax states merge
// in shared memory. Each block then writes its fp32 partial (m, l, acc);
// the last block of a pair to finish (an atomic counter, reset by that
// block) merges the partials (at most kMaxSplits) and writes the output,
// so one launch does the whole step. Later work: TMA loads, and int8 loads
// that skip the bf16 staging copy.
#include <type_traits>

#include "attn_common.cuh"

namespace vst {

constexpr int kRows = 16;       // query rows per block (one mma M)
constexpr int kMaxSplits = 64;  // the merge's statistics fit shared memory

struct DecodeParams {
  const bf16* q;
  const void* k;         // bf16 or int8
  const void* v;
  const float* k_scale;  // [B, T, Hkv] (int8 caches) or null
  const float* v_scale;
  bf16* out;              // [B, t_c, Hq, D] contiguous
  const long long* lens;  // [B] base lengths
  float* part_o;          // [pairs * n_splits][16][D], null when n_splits == 1
  float* part_ml;         // [pairs * n_splits][2][16]
  unsigned* counters;     // [pairs], zero between launches
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long s_sb, s_ss, s_sh;
  int B, tc, Hq, Hkv, T, n_splits;
  float scale;
};

// 8-byte asynchronous copy (int8 rows); src_bytes == 0 writes zeros.
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem,
                                           bool pred) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_bytes));
}

template <int D>
__device__ __forceinline__ void store_out(const DecodeParams& p, int b, int hk,
                                          int n_rep, int R, int rr, int col,
                                          float acc, float l) {
  if (rr >= R) return;
  const int i = rr / n_rep, h = hk * n_rep + rr % n_rep;
  p.out[(((long long)b * p.tc + i) * p.Hq + h) * D + col] =
      __float2bfloat16(acc / (l == 0.f ? 1.f : l));
}

template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    decode_blocked_fwd_kernel(const DecodeParams p) {
  constexpr int kLd = Dims<D>::kLd;
  constexpr int kDp = Dims<D>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [2][64][kLd]
  bf16* s_v = s_k + 2 * kTile * kLd;              // [2][64][kLd]
  bf16* s_q = s_v + 2 * kTile * kLd;              // [16][kLd]
  float* s_sc = reinterpret_cast<float*>(s_q + kRows * kLd);  // [2][2][64]
  int8_t* s_raw = reinterpret_cast<int8_t*>(s_sc + 4 * kTile);  // [2][2][64][D]
  __shared__ int s_last;

  const int split = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int groups = gridDim.y / p.Hkv;
  const int hk = y / groups, grp = y % groups;
  const int n_rep = p.Hq / p.Hkv;
  const int R = p.tc * n_rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // Live tiles of this slot, and this block's contiguous share of them.
  const long long base = p.lens[b];
  const long long live_keys =
      min((long long)p.T, max(0LL, base + (long long)p.tc));
  const int n_live = (int)((live_keys + kTile - 1) / kTile);
  const int tps = (n_live + p.n_splits - 1) / p.n_splits;
  const int lo = min(split * tps, n_live), hi = min(lo + tps, n_live);

  // Key limits of this thread's two rows (0 for padding rows).
  const int r0 = grp * kRows + g, r1 = r0 + 8;
  const int lim0 =
      r0 < R ? (int)min((long long)p.T, max(0LL, base + r0 / n_rep + 1)) : 0;
  const int lim1 =
      r1 < R ? (int)min((long long)p.T, max(0LL, base + r1 / n_rep + 1)) : 0;

  typedef typename std::conditional<kQuant, int8_t, bf16>::type elem_t;
  const elem_t* kg = static_cast<const elem_t*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const elem_t* vg = static_cast<const elem_t*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto load_tile = [&](int j, int buf) {
    if constexpr (kQuant) {
      constexpr int kChunks = D / 8;  // 8-byte chunks per int8 row
      for (int c = threadIdx.x; c < 2 * kTile * kChunks; c += kThreads) {
        const int kv = c / (kTile * kChunks), rem = c % (kTile * kChunks);
        const int r = rem / kChunks, col = (rem % kChunks) * 8;
        const int row = j * kTile + r;
        const bool ok = row < p.T;
        const elem_t* src = kv ? vg : kg;
        const long long st = kv ? p.v_ss : p.k_ss;
        cp_async_8(s_raw + ((buf * 2 + kv) * kTile + r) * D + col,
                   ok ? src + row * st + col : src, ok);
      }
      const int r = threadIdx.x & (kTile - 1), kv = threadIdx.x / kTile;
      const int row = j * kTile + r;
      const float* sc = kv ? p.v_scale : p.k_scale;
      s_sc[(buf * 2 + kv) * kTile + r] =
          row < p.T ? sc[b * p.s_sb + row * p.s_ss + hk * p.s_sh] : 0.f;
    } else {
      load_tile_async<D>(s_k + buf * kTile * kLd, kg, p.k_ss, j * kTile, p.T);
      load_tile_async<D>(s_v + buf * kTile * kLd, vg, p.v_ss, j * kTile, p.T);
    }
  };

  // Q rows: row rr of the group is chunk position rr / n_rep, query head
  // hk * n_rep + rr % n_rep. Padding rows and columns are zero-filled.
  for (int c = threadIdx.x; c < kRows * (kDp / 8); c += kThreads) {
    const int r = c / (kDp / 8), col = (c % (kDp / 8)) * 8;
    const int rr = grp * kRows + r;
    const bool ok = rr < R && col < D;
    const bf16* src = ok ? p.q + b * p.q_sb + (rr / n_rep) * p.q_ss +
                               (hk * n_rep + rr % n_rep) * p.q_sh + col
                         : p.q;
    cp_async_16(s_q + r * kLd + col, src, ok);
  }
  if (lo < hi) load_tile(lo, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kDp / 16][4];
  load_q_frags<D>(qf, s_q, 0, lane);

  float o[kDp / 8][4];
#pragma unroll
  for (int n = 0; n < kDp / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * kLog2e;  // softmax in base 2
  const int key_off = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix lanes
  const int col_off = (lane >> 4) * 8;

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {  // prefetch the next tile into the other buffer
      load_tile(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQuant) {  // int8 -> bf16 (exact) into this buffer
      for (int c = threadIdx.x; c < 2 * kTile * (kDp / 8); c += kThreads) {
        const int kv = c / (kTile * (kDp / 8)), rem = c % (kTile * (kDp / 8));
        const int r = rem / (kDp / 8), col = (rem % (kDp / 8)) * 8;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (col < D) {
          const int2 raw = *reinterpret_cast<const int2*>(
              s_raw + ((buf * 2 + kv) * kTile + r) * D + col);
          const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
          packed.x = pack_bf16((float)x[0], (float)x[1]);
          packed.y = pack_bf16((float)x[2], (float)x[3]);
          packed.z = pack_bf16((float)x[4], (float)x[5]);
          packed.w = pack_bf16((float)x[6], (float)x[7]);
        }
        bf16* dst = (kv ? s_v : s_k) + (buf * kTile + r) * kLd + col;
        *reinterpret_cast<uint4*>(dst) = packed;
      }
      __syncthreads();
    }
    const bf16* sk = s_k + buf * kTile * kLd;
    const bf16* sv = s_v + buf * kTile * kLd;
    const float* ksc = s_sc + (buf * 2) * kTile + warp * 16;
    const float* vsc = ksc + kTile;

    // S = Q K^T for the 16 rows against this warp's 16 keys of the tile.
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kb = sk + (warp * 16 + n * 8 + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        mma_16816(s[n], qf[kk], lds32(kb + kk * 16), lds32(kb + kk * 16 + 8));
      }
    }

    // Scale, k dequant scale, length mask (explicit: a masked key gives p 0).
    const int key0 = j * kTile + warp * 16;
    float mx0 = kNegInf, mx1 = kNegInf;
    unsigned ok = 0;  // bit 4n + e: element (n, e) is a valid key
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = n * 8 + 2 * t + (e & 1);
        const bool valid = key0 + kl < (e < 2 ? lim0 : lim1);
        float x = s[n][e] * sl2;
        if constexpr (kQuant) x *= ksc[kl];
        s[n][e] = valid ? x : kNegInf;
        ok |= (unsigned)valid << (4 * n + e);
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (ok >> (4 * n + e)) & 1u;
        float pe = valid ? exp2f(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        if (e < 2) sum0 += pe;
        else sum1 += pe;
        if constexpr (kQuant) pe *= vsc[n * 8 + 2 * t + (e & 1)];  // after l
        s[n][e] = pe;
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
    // o += P V over this warp's 16 keys (P's C layout is the A layout).
    uint32_t a[4];
    a[0] = pack_bf16(s[0][0], s[0][1]);
    a[1] = pack_bf16(s[0][2], s[0][3]);
    a[2] = pack_bf16(s[1][0], s[1][1]);
    a[3] = pack_bf16(s[1][2], s[1][3]);
    const bf16* vrow = sv + (warp * 16 + key_off) * kLd + col_off;
#pragma unroll
    for (int nd = 0; nd < kDp / 16; ++nd) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vrow + nd * 16);
      mma_16816(o[2 * nd], a, bv[0], bv[1]);
      mma_16816(o[2 * nd + 1], a, bv[2], bv[3]);
    }
    __syncthreads();  // this buffer is refilled two iterations from now
  }

  // Merge the four warps' states in shared memory (over the K buffers).
  float* c_o = reinterpret_cast<float*>(smem_raw);  // [4][16][kDp]
  float* c_m = c_o + kWarps * kRows * kDp;           // [4][16]
  float* c_l = c_m + kWarps * kRows;                 // [4][16]
  if (t == 0) {
    c_m[warp * kRows + g] = m0;
    c_m[warp * kRows + g + 8] = m1;
    c_l[warp * kRows + g] = l0;
    c_l[warp * kRows + g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < kDp / 8; ++n) {
    float* row = c_o + (warp * kRows + g) * kDp + n * 8 + 2 * t;
    row[0] = o[n][0];
    row[1] = o[n][1];
    row[8 * kDp] = o[n][2];
    row[8 * kDp + 1] = o[n][3];
  }
  __syncthreads();

  const bool single = p.n_splits == 1;
  const int pair = b * gridDim.y + y;
  const long long part = (long long)pair * p.n_splits + split;
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, col = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, c_m[w * kRows + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(c_m[w * kRows + r] - mx);
      l += c_l[w * kRows + r] * f;
      acc += c_o[(w * kRows + r) * kDp + col] * f;
    }
    if (single) {
      store_out<D>(p, b, hk, n_rep, R, grp * kRows + r, col, acc, l);
    } else {
      p.part_o[(part * kRows + r) * D + col] = acc;
      if (col == 0) {
        p.part_ml[(part * 2) * kRows + r] = mx;
        p.part_ml[(part * 2 + 1) * kRows + r] = l;
      }
    }
  }
  if (single) return;

  // The last block of this pair to finish merges every split's partial.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(&p.counters[pair], 1u);
    s_last = prev == (unsigned)(p.n_splits - 1);
    if (s_last) atomicExch(&p.counters[pair], 0u);  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Per-split row statistics into shared memory (all loads in flight at
  // once), then one thread per row turns them into weights 2^(m_s - m).
  const long long first = (long long)pair * p.n_splits;
  float* s_w = reinterpret_cast<float*>(smem_raw);  // [n_splits][16]: m, then weight
  float* s_ls = s_w + p.n_splits * kRows;           // [n_splits][16]: l
  float* s_lt = s_ls + p.n_splits * kRows;          // [16]: merged l
  for (int i = threadIdx.x; i < p.n_splits * kRows; i += kThreads) {
    const long long at = (first + i / kRows) * 2 * kRows + i % kRows;
    s_w[i] = __ldcg(p.part_ml + at);
    s_ls[i] = __ldcg(p.part_ml + at + kRows);
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int sp = 0; sp < p.n_splits; ++sp) mx = fmaxf(mx, s_w[sp * kRows + r]);
    float l = 0.f;
    for (int sp = 0; sp < p.n_splits; ++sp) {
      const float f = exp2f(s_w[sp * kRows + r] - mx);
      s_w[sp * kRows + r] = f;
      l += s_ls[sp * kRows + r] * f;
    }
    s_lt[r] = l;
  }
  __syncthreads();
  // The weighted sum of the partial accumulators, four columns per load.
  for (int idx = threadIdx.x; idx < kRows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c4 = idx % (D / 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < p.n_splits; ++sp) {
      const float4 o = __ldcg(reinterpret_cast<const float4*>(
                                  p.part_o + ((first + sp) * kRows + r) * D) +
                              c4);
      const float f = s_w[sp * kRows + r];
      acc.x += o.x * f;
      acc.y += o.y * f;
      acc.z += o.z * f;
      acc.w += o.w * f;
    }
    const int rr = grp * kRows + r;
    const float l = s_lt[r];
    store_out<D>(p, b, hk, n_rep, R, rr, 4 * c4, acc.x, l);
    store_out<D>(p, b, hk, n_rep, R, rr, 4 * c4 + 1, acc.y, l);
    store_out<D>(p, b, hk, n_rep, R, rr, 4 * c4 + 2, acc.z, l);
    store_out<D>(p, b, hk, n_rep, R, rr, 4 * c4 + 3, acc.w, l);
  }
}

template <int D, bool kQuant>
int launch_decode(const DecodeParams& p, cudaStream_t stream) {
  constexpr int kLd = Dims<D>::kLd;
  size_t smem = (4 * kTile + kRows) * kLd * sizeof(bf16) +
                4 * kTile * sizeof(float);
  if (kQuant) smem += 4 * kTile * D;
  cudaFuncSetAttribute(decode_blocked_fwd_kernel<D, kQuant>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int rows = p.tc * (p.Hq / p.Hkv);
  const int groups = (rows + kRows - 1) / kRows;
  const dim3 grid(p.n_splits, p.Hkv * groups, p.B);
  decode_blocked_fwd_kernel<D, kQuant><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_decode(const DecodeParams& p, int quant, cudaStream_t stream) {
  return quant ? launch_decode<D, true>(p, stream)
               : launch_decode<D, false>(p, stream);
}

}  // namespace vst

extern "C" int vst_decode_blocked_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* lens, void* part_o,
    void* part_ml, void* counters, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long s_sb,
    long long s_ss, long long s_sh, int B, int tc, int Hq, int Hkv, int T,
    int D, int quant, int n_splits, float scale, void* stream) {
  vst::DecodeParams p;
  p.q = static_cast<const vst::bf16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.out = static_cast<vst::bf16*>(out);
  p.lens = static_cast<const long long*>(lens);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.counters = static_cast<unsigned*>(counters);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.s_sb = s_sb; p.s_ss = s_ss; p.s_sh = s_sh;
  p.B = B; p.tc = tc; p.Hq = Hq; p.Hkv = Hkv; p.T = T;
  if (n_splits < 1 || n_splits > vst::kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  p.n_splits = n_splits;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {  // keep in step with KERNEL_HEAD_DIMS in attention.py
    case 16: return vst::launch_decode<16>(p, quant, st);
    case 24: return vst::launch_decode<24>(p, quant, st);
    case 64: return vst::launch_decode<64>(p, quant, st);
    case 80: return vst::launch_decode<80>(p, quant, st);
    case 128: return vst::launch_decode<128>(p, quant, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
