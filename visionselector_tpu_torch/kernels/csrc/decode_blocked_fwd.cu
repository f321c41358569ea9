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
// and the v scale multiplies p after the row sum, as the TPU kernel does.
// Softmax statistics and the accumulator are fp32, p is rounded to bf16
// before P V, and a row with no valid key comes out exactly 0.
//
// What bounds it on the H100: a decode step reads every live cache row once
// and does 4 * D flop per (query row, key), about one flop per byte at
// t_c = 1, far below the ~295 the tensor cores need: it moves bytes, and at
// the 3B decoder's ~6 MB a step the fixed cost of a launch and of the merge
// of split states matters as much. The design (the schedule's plain mirror
// is `decode_split_plain`):
//
// * One thread-block cluster of C blocks ("ranks") per (slot, kv head, row
//   group); grid (C, Hkv * groups, B). A block holds all R = t_c * n_rep
//   query rows of its kv head up to 32 (16 * mt rows as mt m16 mma.sync
//   tiles: t_c <= 4 at the 3B and 7B decoders' 16/2 and 28/4 heads), so kv
//   is read once per step; more rows take more row groups (at 64 rows the
//   merge's inboxes would not fit beside the ring).
//   C, mt and the shared memory depend on shapes and the card only: the
//   launch reads no length on the host.
// * Each block reads lens[b], counts the slot's live 64-row tiles,
//   ceil((base_len + t_c) / 64) capped at ceil(T / 64) (the TPU kernel's
//   clamped kv index map as a loop bound), and takes the contiguous share
//   [rank * n / C, (rank + 1) * n / C) of them. A rank with no tile issues
//   no load and sends nothing to the merge.
// * One producer warp keeps kStages stages of K and V tiles (and int8
//   scales) in flight in a ring of mbarriers: cp.async copies of the live
//   rows, rows past the live length zero-filled, whose completion arrives
//   on the stage's barrier (cp.async.mbarrier.arrive). A rank's tiles are
//   64 rows of D contiguous elements each, Hkv * D apart in a pool's layer
//   view; one cp.async.bulk per row measured half the rate of these 16-byte
//   copies (the copy engine takes the 128 small requests of a tile one at a
//   time). int8 rows of D = 24 are 24 bytes: that instantiation (fixed at
//   compile time from D and the type) copies 8 bytes at a time.
// * 4 * mt consumer warps: warp (mt, quarter) owns 16 query rows and 16
//   keys of each 64-key tile, with its own online softmax. int8 tiles stay
//   int8 in shared memory and are widened to bf16 as the mma operands are
//   built, with no staging pass.
// * The merge goes through distributed shared memory, pushed, with one
//   cluster barrier: every consumer warp of a rank with tiles stores its
//   rows' (m, l) into each rank of the cluster and its accumulator's
//   8-column block nb into rank nb % C. After the barrier each rank merges,
//   for its own columns, the 4 partial states of each rank with tiles from
//   its own shared memory and writes them. No global partials, no atomics,
//   no remote reads.
#include <type_traits>

#include "attn_common.cuh"
#include "hopper_common.cuh"

namespace vst {

constexpr int kMtMax = 2;        // m16 tiles per block: up to 32 query rows
constexpr int kMaxCluster = 16;  // ranks per (slot, kv head, row group)
constexpr int kMaxThreads = 32 * (4 * kMtMax + 1);
constexpr int kRingBudget = 77824;  // bytes of K/V stages (2 blocks per SM)

struct DecodeParams {
  const bf16* q;
  const void* k;         // bf16 or int8
  const void* v;
  const float* k_scale;  // [B, T, Hkv] (int8 caches) or null
  const float* v_scale;
  bf16* out;              // [B, t_c, Hq, D] contiguous
  const long long* lens;  // [B] base lengths
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long s_sb, s_ss, s_sh;
  int B, tc, Hq, Hkv, T;
  int mt, groups;  // m16 tiles per block, row groups per kv head
  int drop_rank;   // a merge that leaves this rank out (tests); -1: none
  float scale;
};

// Shared memory of one block: the K/V ring, q, and the merge's inboxes
// (written by the cluster's ranks), sized by m16 tiles per block (mt), rows
// per block (ns) and ranks (C).
template <int D, bool kQuant>
struct DecodeSmem {
  static constexpr int kDp = Dims<D>::kPad;
  static constexpr int kLd = Dims<D>::kLd;  // q pitch (bf16 elements)
  static constexpr int kNb = kDp / 8;       // 8-column blocks of a row
  static constexpr int kRowBytes = kQuant ? D : 2 * D;  // one cache row
  static constexpr int kChunk = kRowBytes % 16 == 0 ? 16 : 8;  // copy size
  // Row pitch of a K/V tile: 16 bytes past the row, so the fragment reads
  // of 8 rows fall in different banks.
  static constexpr int kPitch = kQuant ? kDp + 16 : 2 * kLd;
  static constexpr int kTileBytes = kTile * kPitch;
  static constexpr int kScaleBytes = kQuant ? 2 * kTile * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileBytes + kScaleBytes;
  // Stages in flight: 2 to 4, as many as the budget holds.
  static constexpr int kStages =
      kRingBudget / kStageBytes < 2   ? 2
      : kRingBudget / kStageBytes > 4 ? 4
                                      : kRingBudget / kStageBytes;
  static constexpr int kRing = kStages * kStageBytes;

  // Columns of the accumulator a rank receives: its 8-column blocks.
  __host__ __device__ static int own(int C) { return (kNb + C - 1) / C * 8; }

  struct Layout {
    int q, o, m, l, bar, bytes;
  };
  // q [16 mt][kLd] bf16; inboxes o [C * 4][ns][own] and m, l [ns][C * 4]
  // f32 (the partial state of sender rank c's key-quarter warp q at index
  // 4 c + q); the ring's mbarriers.
  __host__ __device__ static Layout layout(int mt, int ns, int C) {
    Layout a;
    a.q = kRing;
    a.o = a.q + 16 * mt * kLd * 2;
    a.m = a.o + C * 4 * ns * own(C) * 4;
    a.l = a.m + C * 4 * ns * 4;
    a.bar = (a.l + C * 4 * ns * 4 + 15) / 16 * 16;
    a.bytes = a.bar + 2 * kStages * 8;
    return a;
  }
};

// 8-byte and 4-byte asynchronous copies; src_bytes == 0 writes zeros.
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}

// Cluster barrier halves: every thread of every block of the cluster
// arrives, then waits. Relaxed: no memory order (the start: every block is
// running); release / acquire: stores before it are visible after it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_size() {
  int n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`, and stores there.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(hopper::smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x)
               : "memory");
}

__device__ __forceinline__ void st_peer(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}

// Two int8 values as a bf16 pair (exact): (lo, hi), or the two bytes of
// a 16-bit word, low byte first.
__device__ __forceinline__ uint32_t i8x2_bf16x2(int8_t lo, int8_t hi) {
  return pack_bf16((float)lo, (float)hi);
}

__device__ __forceinline__ uint32_t i8x2_bf16x2(uint16_t w) {
  return i8x2_bf16x2((int8_t)(w & 0xff), (int8_t)(w >> 8));
}

template <int D, bool kQuant>
__global__ void __launch_bounds__(kMaxThreads, 1)
    decode_blocked_fwd_kernel(const DecodeParams p) {
#ifdef VST_DECODE_EMPTY
  return;
#endif
  using L = DecodeSmem<D, kQuant>;
  constexpr int kDp = L::kDp, kLd = L::kLd, kPitch = L::kPitch;
  constexpr int kStages = L::kStages, kNb = L::kNb;
  typedef typename std::conditional<kQuant, int8_t, bf16>::type elem_t;
  extern __shared__ __align__(128) unsigned char smem[];

  const int rank = cluster_rank();
  const int n_rank = cluster_size();  // a power of two
  const int n_cw = 4 * p.mt;                     // consumer warps
  const int y = blockIdx.y, b = blockIdx.z;
  const int hk = y / p.groups, grp = y % p.groups;
  const int n_rep = p.Hq / p.Hkv;
  const int R = p.tc * n_rep;
  const int ns = min(16 * p.mt, R);   // rows per block (inbox row stride)
  const int row0 = grp * 16 * p.mt;   // this block's first query row
  const int n_rows = min(ns, R - row0);  // its real rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const typename L::Layout lay = L::layout(p.mt, ns, n_rank);
  bf16* s_q = reinterpret_cast<bf16*>(smem + lay.q);
  float* in_o = reinterpret_cast<float*>(smem + lay.o);
  float* in_m = reinterpret_cast<float*>(smem + lay.m);
  float* in_l = reinterpret_cast<float*>(smem + lay.l);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  uint64_t* empty = full + kStages;

  const long long base = p.lens[b];  // in flight while q is requested

  // Q rows, before anything waits on the length: block row r is chunk
  // position (row0 + r) / n_rep, query head hk * n_rep + (row0 + r) % n_rep.
  // Padding rows and columns are zero.
  if (warp < n_cw) {
    for (int c = threadIdx.x; c < 16 * p.mt * (kDp / 8); c += n_cw * 32) {
      const int r = c / (kDp / 8), col = (c % (kDp / 8)) * 8;
      const int rr = row0 + r;
      const bool ok = rr < R && col < D;
      const bf16* src = ok ? p.q + b * p.q_sb + (rr / n_rep) * p.q_ss +
                                 (hk * n_rep + rr % n_rep) * p.q_sh + col
                           : p.q;
      cp_async_16(s_q + r * kLd + col, src, ok);
    }
    cp_async_commit();
  }

  if constexpr (!kQuant && kDp > D) {
    // K's pad columns (D = 24), which no copy writes, are 0 in every stage.
    for (int c = threadIdx.x; c < kStages * kTile; c += blockDim.x) {
      bf16* row = reinterpret_cast<bf16*>(smem + (c / kTile) * L::kStageBytes +
                                          (c % kTile) * kPitch);
#pragma unroll
      for (int col = D; col < kDp; col += 8) {
        *reinterpret_cast<uint4*>(row + col) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // The slot's live tiles; rank c's contiguous share is
  // [c * n_live / C, (c + 1) * n_live / C).
  const int live = (int)min((long long)p.T, max(0LL, base + p.tc));
  const int n_live = (live + kTile - 1) / kTile;
  const int shift = __ffs(n_rank) - 1;
  const int lo = (rank * n_live) >> shift, hi = ((rank + 1) * n_live) >> shift;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer lanes' cp.async
      hopper::mbar_init(&empty[s], n_cw);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  cluster_arrive_relaxed();  // this block runs: its inboxes may be written

  const elem_t* kg = static_cast<const elem_t*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const elem_t* vg = static_cast<const elem_t*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto stage_k = [&](int s) { return smem + s * L::kStageBytes; };
  auto stage_v = [&](int s) { return stage_k(s) + L::kTileBytes; };
  auto stage_sc = [&](int s) {  // [2][64] f32: k scales, then v scales
    return reinterpret_cast<float*>(stage_v(s) + L::kTileBytes);
  };

  if (warp == n_cw) {
    // Producer: the live rows of tile j of [lo, hi) into stage
    // (j - lo) % kStages. Rows past the live length keep what the stage
    // held: a masked key selects p = 0 (and skips its scales), a warp whose
    // 16 keys are all past it skips the tile, and bf16 v rows from the live
    // length up to its warp's end are zero-filled (an unwritten stage may
    // hold any bits; int8 values are always finite).
    constexpr int kCh = L::kChunk, kChunks = L::kRowBytes / kCh;
    constexpr int kEl = kCh / (int)sizeof(elem_t);
    for (int j = lo; j < hi; ++j) {
      const int it = j - lo, s = it % kStages, use = it / kStages;
      if (use > 0) hopper::mbar_wait(&empty[s], (use - 1) & 1);
      const int r0 = j * kTile, nr = min(kTile, live - r0);
      unsigned char* sk = stage_k(s);
      unsigned char* sv = stage_v(s);
      for (int c = lane; c < nr * kChunks; c += 32) {
        const int r = c / kChunks, cc = c - r * kChunks;
        const long long row = r0 + r;
        if constexpr (kCh == 16) {
          cp_async_16(sk + r * kPitch + cc * 16, kg + row * p.k_ss + cc * kEl,
                      true);
          cp_async_16(sv + r * kPitch + cc * 16, vg + row * p.v_ss + cc * kEl,
                      true);
        } else {
          cp_async_8(sk + r * kPitch + cc * 8, kg + row * p.k_ss + cc * kEl,
                     true);
          cp_async_8(sv + r * kPitch + cc * 8, vg + row * p.v_ss + cc * kEl,
                     true);
        }
      }
      if constexpr (!kQuant) {
        const int n_zero = (min(kTile, (nr + 15) & ~15) - nr) * kChunks;
        for (int c = lane; c < n_zero; c += 32) {
          const int r = nr + c / kChunks, cc = c % kChunks;
          cp_async_16(sv + r * kPitch + cc * 16, vg, false);
        }
      }
      if constexpr (kQuant) {
        float* sc = stage_sc(s);
        for (int c = lane; c < 2 * kTile; c += 32) {
          const int kv = c / kTile, r = c % kTile;
          if (r < nr) {
            cp_async_4(sc + c,
                       (kv ? p.v_scale : p.k_scale) + b * p.s_sb +
                           (long long)(r0 + r) * p.s_ss + hk * p.s_sh,
                       true);
          }
        }
      }
      hopper::cp_async_arrive_noinc(&full[s]);
    }
  }

  // Consumer warp (mt, quarter): rows [16 mt, 16 mt + 16) of the block,
  // keys [16 quarter, 16 quarter + 16) of every tile.
  const int mt = warp >> 2, quarter = warp & 3;
  float o[kDp / 8][4];
#pragma unroll
  for (int n = 0; n < kDp / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  if (warp < n_cw && lo < hi) {
    cp_async_wait<0>();
    asm volatile("bar.sync 1, %0;\n" ::"r"(n_cw * 32) : "memory");

    // Key limits of this thread's two rows (0 for padding rows).
    const int r0 = row0 + mt * 16 + g, r1 = r0 + 8;
    const int lim0 =
        r0 < R ? (int)min((long long)p.T, max(0LL, base + r0 / n_rep + 1)) : 0;
    const int lim1 =
        r1 < R ? (int)min((long long)p.T, max(0LL, base + r1 / n_rep + 1)) : 0;
    const float sl2 = p.scale * kLog2e;  // softmax in base 2
    const bf16* qrow = s_q + (mt * 16 + g) * kLd + 2 * t;
    const int key_off = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix lanes
    const int col_off = (lane >> 4) * 8;

    for (int j = lo; j < hi; ++j) {
      const int it = j - lo, s = it % kStages;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);
      const int key0 = j * kTile + quarter * 16;
      if (key0 >= live) {  // every key of this warp's quarter is masked
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
        continue;
      }
      const unsigned char* sk = stage_k(s) + quarter * 16 * kPitch;
      const unsigned char* sv = stage_v(s) + quarter * 16 * kPitch;
      const float* ksc = stage_sc(s) + quarter * 16;
      const float* vsc = ksc + kTile;

      // S = Q K^T for the warp's 16 rows against its 16 keys of the tile.
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDp / 16; ++kk) {
        uint32_t a[4];
        a[0] = lds32(qrow + kk * 16);
        a[1] = lds32(qrow + 8 * kLd + kk * 16);
        a[2] = lds32(qrow + kk * 16 + 8);
        a[3] = lds32(qrow + 8 * kLd + kk * 16 + 8);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const unsigned char* kr = sk + (n * 8 + g) * kPitch;
          uint32_t b0, b1;
          if constexpr (kQuant) {  // int8 -> bf16 in registers
            const unsigned char* k8 = kr + kk * 16 + 2 * t;
            b0 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(k8));
            b1 = i8x2_bf16x2(*reinterpret_cast<const uint16_t*>(k8 + 8));
          } else {
            const bf16* kb = reinterpret_cast<const bf16*>(kr) + kk * 16 + 2 * t;
            b0 = lds32(kb);
            b1 = lds32(kb + 8);
          }
          mma_16816(sc[n], a, b0, b1);
        }
      }

      // Scale, k dequant scale, length mask (explicit: a masked key gives
      // p 0 whatever its row holds).
      float mx0 = kNegInf, mx1 = kNegInf;
      unsigned ok = 0;  // bit 4n + e: element (n, e) is a valid key
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = n * 8 + 2 * t + (e & 1);
          const bool valid = key0 + kl < (e < 2 ? lim0 : lim1);
          float x = sc[n][e] * sl2;
          if constexpr (kQuant) x *= ksc[kl];
          sc[n][e] = valid ? x : kNegInf;
          ok |= (unsigned)valid << (4 * n + e);
          if (e < 2) mx0 = fmaxf(mx0, sc[n][e]);
          else mx1 = fmaxf(mx1, sc[n][e]);
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
          float pe = valid ? exp2f(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          if (e < 2) sum0 += pe;
          else sum1 += pe;
          if constexpr (kQuant) {  // after the row sum
            pe = valid ? pe * vsc[n * 8 + 2 * t + (e & 1)] : 0.f;
          }
          sc[n][e] = pe;
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
      // o += P V over the warp's 16 keys (P's C layout is the A layout).
      uint32_t a[4];
      a[0] = pack_bf16(sc[0][0], sc[0][1]);
      a[1] = pack_bf16(sc[0][2], sc[0][3]);
      a[2] = pack_bf16(sc[1][0], sc[1][1]);
      a[3] = pack_bf16(sc[1][2], sc[1][3]);
      if constexpr (kQuant) {
        // B fragment of V (keys 2t, 2t + 1 and 2t + 8, 2t + 9; column g of
        // each 8-column block), widened from int8 in registers.
        const int8_t* v0 = reinterpret_cast<const int8_t*>(sv) + 2 * t * kPitch + g;
#pragma unroll
        for (int n = 0; n < kDp / 8; ++n) {
          const int8_t* vc = v0 + n * 8;
          const uint32_t b0 = i8x2_bf16x2(vc[0], vc[kPitch]);
          const uint32_t b1 = i8x2_bf16x2(vc[8 * kPitch], vc[9 * kPitch]);
          mma_16816(o[n], a, b0, b1);
        }
      } else {
        const bf16* vrow =
            reinterpret_cast<const bf16*>(sv) + key_off * kLd + col_off;
#pragma unroll
        for (int nd = 0; nd < kDp / 16; ++nd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + nd * 16);
          mma_16816(o[2 * nd], a, bv[0], bv[1]);
          mma_16816(o[2 * nd + 1], a, bv[2], bv[3]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // stage free
    }
  }
  if (warp < n_cw) cp_async_wait<0>();  // q of a rank without tiles
#ifdef VST_DECODE_NO_MERGE
  return;
#endif
  cluster_wait();  // every block of the cluster runs

  // Push this warp's partial state: (m, l) of its real rows to every rank,
  // 8-column block nb of its accumulator to rank nb % C.
  const int own = L::own(n_rank), n_p = 4 * n_rank;
  if (warp < n_cw && lo < hi) {
    const int src = rank * 4 + quarter;
    const int ra = mt * 16 + g, rb = ra + 8;  // this thread's block rows
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      const uint32_t dst =
          peer_addr(in_o + src * ns * own + (nb >> shift) * 8 + 2 * t,
                    nb & (n_rank - 1));
      if (ra < n_rows) st_peer(dst + ra * own * 4, o[nb][0], o[nb][1]);
      if (rb < n_rows) st_peer(dst + rb * own * 4, o[nb][2], o[nb][3]);
    }
    if (t == 0) {
      for (int c = 0; c < n_rank; ++c) {
        const uint32_t dm = peer_addr(in_m + src, c);
        const uint32_t dl = peer_addr(in_l + src, c);
        if (ra < n_rows) {
          st_peer(dm + ra * n_p * 4, m0);
          st_peer(dl + ra * n_p * 4, l0);
        }
        if (rb < n_rows) {
          st_peer(dm + rb * n_p * 4, m1);
          st_peer(dl + rb * n_p * 4, l1);
        }
      }
    }
  }
  cluster_arrive_release();
  cluster_wait();  // every push has landed

  // Ranks whose partial states take part: those with tiles.
  unsigned senders = 0;
  for (int c = 0; c < n_rank; ++c) {
    const bool has = (c * n_live) >> shift < ((c + 1) * n_live) >> shift;
    senders |= (unsigned)(has && c != p.drop_rank) << c;
  }
  // This rank's columns: 8-column blocks rank, rank + C, ...; two per item.
  // Each item merges its row's 4 x (sending ranks) partial states: m = the
  // max, weights 2^(m_i - m), l = sum l_i w_i, out = sum acc_i w_i / l.
  const int n_own = (kNb - rank + n_rank - 1) >> shift;
  for (int i = threadIdx.x; i < n_rows * n_own * 4; i += blockDim.x) {
    const int r = i / (n_own * 4), j = i % (n_own * 4);
    const int col = (((j >> 2) << shift) + rank) * 8 + (j & 3) * 2;
    if (col >= D) continue;  // the pad columns of D = 24
    const float* m_r = in_m + r * n_p;
    const float* l_r = in_l + r * n_p;
    const float* x = in_o + r * own + (j >> 2) * 8 + (j & 3) * 2;
    float mx = kNegInf;
    for (unsigned u = senders; u; u &= u - 1) {
      const int c4 = 4 * (__ffs(u) - 1);
      mx = fmaxf(mx, fmaxf(fmaxf(m_r[c4], m_r[c4 + 1]),
                           fmaxf(m_r[c4 + 2], m_r[c4 + 3])));
    }
    float l = 0.f;
    float2 acc = make_float2(0.f, 0.f);
    for (unsigned u = senders; u; u &= u - 1) {
      const int c4 = 4 * (__ffs(u) - 1);
#pragma unroll
      for (int k = c4; k < c4 + 4; ++k) {
        const float f = exp2f(m_r[k] - mx);
        const float2 v = *reinterpret_cast<const float2*>(x + k * ns * own);
        l += l_r[k] * f;
        acc.x += v.x * f;
        acc.y += v.y * f;
      }
    }
    // l is 0 only for a row with no valid key (or no sending rank): its
    // acc is 0 too, and it comes out exactly 0.
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int rr = row0 + r;
    const int ci = rr / n_rep, h = hk * n_rep + rr % n_rep;
    *reinterpret_cast<uint32_t*>(
        p.out + (((long long)b * p.tc + ci) * p.Hq + h) * D + col) =
        pack_bf16(acc.x * inv, acc.y * inv);
  }
}

// Rows per block and row groups for R = t_c * n_rep query rows.
inline void decode_rows(int tc, int n_rep, int* mt, int* groups) {
  const int r = tc * n_rep;
  *mt = (r + 15) / 16 < kMtMax ? (r + 15) / 16 : kMtMax;
  *groups = (r + 16 * *mt - 1) / (16 * *mt);
}

// Instantiations prepared, one bit per device. Internal linkage: a static
// inside the template would be one symbol for every copy of this library
// loaded into a process (GNU unique), and a second copy would skip its own
// kernels' preparation.
static unsigned g_prepared[2][129];

// Once per instantiation and device: the shared-memory ceiling and
// clusters of more than 8 blocks.
template <int D, bool kQuant>
int decode_prepare() {
  unsigned& done = g_prepared[kQuant][D];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (done >> dev) & 1u) return 0;
  auto kern = decode_blocked_fwd_kernel<D, kQuant>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DecodeSmem<D, kQuant>::layout(kMtMax, 16 * kMtMax, kMaxCluster).bytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return (int)e;
}

// Dynamic shared memory of one launch (the kernel's own layout).
template <int D, bool kQuant>
int decode_smem(const DecodeParams& p, int cluster) {
  const int r = p.tc * (p.Hq / p.Hkv);
  const int ns = 16 * p.mt < r ? 16 * p.mt : r;
  return DecodeSmem<D, kQuant>::layout(p.mt, ns, cluster).bytes;
}

template <int D, bool kQuant>
void decode_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   const DecodeParams& p, int cluster, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, p.Hkv * p.groups, p.B);
  cfg->blockDim = dim3(32 * (4 * p.mt + 1));
  cfg->dynamicSmemBytes = decode_smem<D, kQuant>(p, cluster);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int D, bool kQuant>
int launch_decode(const DecodeParams& p, int cluster, cudaStream_t stream) {
  int e = decode_prepare<D, kQuant>();
  if (e) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  decode_config<D, kQuant>(&cfg, &attr, p, cluster, stream);
  cudaLaunchKernelEx(&cfg, decode_blocked_fwd_kernel<D, kQuant>, p);
  return (int)cudaGetLastError();
}

// What the card can hold of one launch shape: "clusters" = the most
// clusters of `cluster` blocks resident at once, else blocks per SM.
template <int D, bool kQuant>
int decode_occupancy(const DecodeParams& p, int cluster, int what) {
  if (decode_prepare<D, kQuant>()) return -1;
  auto kern = decode_blocked_fwd_kernel<D, kQuant>;
  int n = 0;
  if (what == 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    decode_config<D, kQuant>(&cfg, &attr, p, cluster, 0);
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) n = -1;
  } else if (what == 1) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kern, 32 * (4 * p.mt + 1),
            decode_smem<D, kQuant>(p, cluster)) != cudaSuccess) {
      n = -1;
    }
  } else {
    n = decode_smem<D, kQuant>(p, cluster);
  }
  cudaGetLastError();  // a refused query leaves no sticky error behind
  return n;
}

template <int D>
int decode_dispatch(const DecodeParams& p, int quant, int cluster, int what,
                    cudaStream_t stream) {
  if (what < 0) {
    return quant ? launch_decode<D, true>(p, cluster, stream)
                 : launch_decode<D, false>(p, cluster, stream);
  }
  return quant ? decode_occupancy<D, true>(p, cluster, what)
               : decode_occupancy<D, false>(p, cluster, what);
}

int decode_entry(const DecodeParams& p, int D, int quant, int cluster,
                 int what, cudaStream_t stream) {
  switch (D) {  // keep in step with FLASH_HEAD_DIMS in attention.py
    case 16: return decode_dispatch<16>(p, quant, cluster, what, stream);
    case 24: return decode_dispatch<24>(p, quant, cluster, what, stream);
    case 32: return decode_dispatch<32>(p, quant, cluster, what, stream);
    case 64: return decode_dispatch<64>(p, quant, cluster, what, stream);
    case 80: return decode_dispatch<80>(p, quant, cluster, what, stream);
    case 128: return decode_dispatch<128>(p, quant, cluster, what, stream);
    default: return what < 0 ? (int)cudaErrorInvalidValue : -1;
  }
}

}  // namespace vst

extern "C" int vst_decode_blocked_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* lens, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long s_sb, long long s_ss, long long s_sh, int B, int tc, int Hq,
    int Hkv, int T, int D, int quant, int cluster, int drop_rank, float scale,
    void* stream) {
  vst::DecodeParams p;
  p.q = static_cast<const vst::bf16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.out = static_cast<vst::bf16*>(out);
  p.lens = static_cast<const long long*>(lens);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.s_sb = s_sb; p.s_ss = s_ss; p.s_sh = s_sh;
  p.B = B; p.tc = tc; p.Hq = Hq; p.Hkv = Hkv; p.T = T;
  p.drop_rank = drop_rank;
  p.scale = scale;
  if (cluster < 1 || cluster > vst::kMaxCluster || (cluster & (cluster - 1)) ||
      Hkv < 1 || Hq % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  vst::decode_rows(tc, Hq / Hkv, &p.mt, &p.groups);
  return vst::decode_entry(p, D, quant, cluster, -1,
                           static_cast<cudaStream_t>(stream));
}

// Launch facts of one shape (no launch): what = 0, the most clusters of
// `cluster` blocks the card holds at once; 1, blocks per SM; 2, dynamic
// shared memory bytes per block. -1 when the query fails.
extern "C" int vst_decode_blocked_query(int tc, int Hq, int Hkv, int D,
                                        int quant, int cluster, int what) {
  if (cluster < 1 || cluster > vst::kMaxCluster || (cluster & (cluster - 1)) ||
      Hkv < 1 || Hq % Hkv) {
    return -1;
  }
  vst::DecodeParams p{};
  p.B = 1; p.tc = tc; p.Hq = Hq; p.Hkv = Hkv;
  vst::decode_rows(tc, Hq / Hkv, &p.mt, &p.groups);
  return vst::decode_entry(p, D, quant, cluster, what, nullptr);
}
