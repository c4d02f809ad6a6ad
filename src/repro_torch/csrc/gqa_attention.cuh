// Shared bf16 core of the two GQA attention kernels on Hopper (sm_90a):
// csrc/flash_attention.cu (a strided slab, right-aligned queries) and
// csrc/paged_decode.cu (a page table, an int32 array of query positions).
// The two differ only in a policy type that tells the core where key row t
// lies and at which position each query row sits; everything below is
// common.
//
// Function.  GQA attention of the g * S query rows of one kv-head group
// against bf16 K/V rows of width HD: fp32 scores scaled by 1/sqrt(HD),
// masked by causality (key <= query position), an optional sliding window
// (key > position - window) and a key limit, and an fp32 online softmax.
// The probabilities are rounded to bf16 for the value product, as the plain
// versions do.  A row that sees no key outputs 0.
//
// Design.
//  * Grid (split, slot * kv head, row tile).  A block's query rows are taken
//    position-major across the g heads of the group (row = s * g + member),
//    so every staged K/V tile serves the whole group.  Row tiles are handed
//    out last first: under a causal mask they see the most keys, so the
//    longest blocks start first.
//  * Two block shapes (Config).  Calls whose grid of 128-row blocks fills the
//    card (a prefill) take one warpgroup a block, two 64-row m-tiles, and run
//    both products as warpgroup MMAs (wgmma): Q K^T with q and K read from
//    shared memory, P V with P from registers and V from shared memory; the
//    softmax of one m-tile runs while the tensor cores work on the other's
//    products.  Other calls (decode steps, prefill chunks) take one warp and
//    16 rows a block and split the keys (below); they run mma.sync m16n8k16
//    with ldmatrix (q, K) and ldmatrix.trans (V) fragments.  Both accumulate
//    in fp32 in one fragment layout: lane l of a warp holds rows l / 4 and
//    l / 4 + 8 of each 16.  The probabilities go from the fp32 score fragment
//    straight into the bf16 A operand of P V, in registers.  Row max and sum
//    use the 4 lanes of a quad (shfl_xor 1, 2); the sum is reduced once, at
//    the end.
//  * Shared memory: tiles of HD bf16 a row are stored as columns of 64-value
//    (128-byte) atoms, 16-byte chunks XOR-swizzled by row -- the layout of the
//    wgmma 128-byte swizzle (64-byte for HD 32), on which the 8 rows an
//    ldmatrix phase reads also hit 8 bank groups.
//  * Staging: tiles of KT keys, K and V, copied with cp.async.cg 16 bytes a
//    thread into a ring of STAGES buffers: the next tiles are in flight while
//    one computes.  Keys outside the block's key range are zero-filled, never
//    read.  The output tile goes back through shared memory, so each row is
//    written in whole 16-byte chunks.
//  * Split-KV: the block's visible key tiles (a range computed in the kernel
//    from the rows' positions) are cut into gridDim.x contiguous parts, one
//    a block.  With more than one split the blocks of one (slot, kv head,
//    row tile) form a thread-block cluster.  Each writes its partial (m, l,
//    unnormalised acc) to its own shared memory; after cluster.sync() every
//    rank combines a slice of the outputs from all ranks' partials through
//    distributed shared memory, in split order 0, 1, ..., so the output
//    depends on the data alone.  One launch, no global scratch.  A split
//    that sees no key has l = 0 and m = kNegInf and contributes exactly 0.
//  * Masking only where needed: a block skips a tile none of its rows sees
//    (a one-warp block: none of the warp's rows), and the mask is applied
//    only to tiles that some row of the warp sees in part (the diagonal and
//    window-edge tiles).
//
// Bound.  Memory at the serving shapes: a call must read q, each visible
// K/V row once and write the output once.  The products run on the tensor
// cores (989 TFLOP/s bf16), so operations bound only long prefills.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace gqa {

namespace cg = cooperative_groups;

constexpr int kMaxSplits = 8;          // the portable cluster size
constexpr int kMaxRowSlots = 128;      // the largest STAGES * KT of a Config
constexpr float kNegInf = -1e30f;      // running-max floor: exp2(m - m_new) stays finite
constexpr float kLog2e = 1.4426950408889634f;

using namespace sm90;   // the PTX building blocks (sm90.cuh)

// Shape of a block of NW warps (kernels/gqa_split.py mirrors it): keys a
// staged tile holds, the depth of the ring of stages, and 16-row m-tiles a
// warp owns.  One-warp blocks (mma.sync) serve split-KV calls: 32-key tiles
// keep a decode step's blocks resident at once.  One-warpgroup blocks (wgmma)
// serve calls whose rows fill the card: two 64-row wgmma m-tiles share each
// staged K/V tile, halving the tiles' reads per query row.
template <int NW> struct Config;
template <> struct Config<1> { static constexpr int kKeyTile = 32, kStages = 3, kMTiles = 1; };
template <> struct Config<4> { static constexpr int kKeyTile = 64, kStages = 2, kMTiles = 2; };

template <int NW>
__host__ __device__ constexpr int rows_per_block() { return 16 * NW * Config<NW>::kMTiles; }

// Shared memory of one block: the q tile, the ring of K/V stages, then the
// policy's own, from a 1024-aligned start (hence the 1024 spare bytes).  The
// split combine reuses the K/V stages for the partials.
template <int NW>
__host__ __device__ constexpr size_t core_smem_bytes(int hd) {
  return 1024 + (size_t)rows_per_block<NW>() * hd * 2 +
         (size_t)Config<NW>::kStages * 2 * Config<NW>::kKeyTile * hd * 2;
}

// The policy P provides (per block, after begin()):
//   kHD, kPrepare         head width; whether prepare() must precede staging
//   causal, window        the mask's options
//   begin(b, kvh, r0, nr, g, S, extra)   per-block set-up (all threads call it)
//   qpos(r)               position of tile row r < nr
//   key_range(lo, hi)     keys some row of the block can see lie in [lo, hi]
//   key_limit()           keys >= it are never visible
//   prepare(t0, slot, n)  set-up of the n keys from t0 in row slots slot ..
//                         slot + n - 1 (< kMaxRowSlots), before they are
//                         addressed (when kPrepare)
//   k_row(slot, kpos), v_row(slot, kpos)   row kpos (in row slot `slot`) of K
//                         and V
template <int NW, class P>
__global__ void __launch_bounds__(NW * 32)
attention_kernel(P pol, const bf16* __restrict__ q, bf16* __restrict__ out, int S,
                 int h, int hk, float scale_log2) {
  constexpr int HD = P::kHD;
  constexpr bool WG = NW == 4;                // one warpgroup: wgmma products
  constexpr int MT = Config<NW>::kMTiles;     // 16-row m-tiles a warp
  constexpr int RT = rows_per_block<NW>();    // query rows a block
  constexpr int NT = 32 * NW;
  constexpr int CH = HD / 8;                  // 16-byte chunks a row
  constexpr int KT = Config<NW>::kKeyTile;
  constexpr int STAGES = Config<NW>::kStages;
  constexpr int TILE = KT * HD * 2;           // bytes of one K (or V) tile
  static_assert(STAGES * KT <= kMaxRowSlots, "row slots");
  static_assert((NW == 1 && MT == 1) || (NW == 4 && KT == 64),
                "a warp, or a warpgroup on 64-key tiles");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kv_s = q_s + RT * HD * 2;    // [stage][K, V][KT][HD]
  unsigned char* extra = kv_s + STAGES * 2 * TILE;

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int g = h / hk;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * RT;
  const int nr = min(RT, g * S - r0);
  const int b = blockIdx.y / hk, kvh = blockIdx.y % hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  P p = pol;
  p.begin(b, kvh, r0, nr, g, S, extra);

  // 16-byte chunks of tile rows: thread tid copies chunk tid % CH of rows
  // tid / CH, tid / CH + RSTEP, ...
  constexpr int RSTEP = NT / CH;
  static_assert(NT % CH == 0, "whole rows a pass");
  const int ch = tid % CH, t_first_row = tid / CH;

  // the q tile: row r is (position (r0 + r) / g, head kvh * g + (r0 + r) % g)
  const bf16* q_b = q + (size_t)b * S * h * HD;
#pragma unroll
  for (int r = t_first_row; r < RT; r += RSTEP) {
    const int row = r0 + r;
    const bool ok = r < nr;
    const bf16* src = ok ? q_b + ((size_t)(row / g) * h + kvh * g + row % g) * HD + ch * 8 : q;
    cp_async16(smem_addr(q_s + swz<HD, RT>(r, ch)), src, ok);
  }

  // this split's key tiles
  int k_lo, k_hi;
  p.key_range(k_lo, k_hi);
  int t_first = 0, t_end = 0;
  if (k_hi >= k_lo) {
    const int tl = k_lo / KT, n = k_hi / KT - tl + 1;
    t_first = tl + split * n / n_splits;
    t_end = tl + (split + 1) * n / n_splits;
  }
  auto stage = [&](int tile, int st) {       // issue tile's copies into stage st
    const int t0 = tile * KT;
    if constexpr (P::kPrepare) {
      p.prepare(t0, st * KT, KT);
      __syncthreads();
    }
    const uint32_t ks = smem_addr(kv_s + st * 2 * TILE), vs = ks + TILE;
#pragma unroll
    for (int t = t_first_row; t < KT; t += RSTEP) {
      const int kpos = t0 + t;
      const bool ok = kpos >= k_lo && kpos <= k_hi;
      const uint32_t off = swz<HD, KT>(t, ch);
      cp_async16(ks + off, ok ? p.k_row(st * KT + t, kpos) + ch * 8 : q, ok);
      cp_async16(vs + off, ok ? p.v_row(st * KT + t, kpos) + ch * 8 : q, ok);
    }
  };

  // row of m-tile mt of this warp (a warpgroup's m-tile mt is rows 64 mt ..
  // 64 mt + 63, the M of one wgmma); lane l holds its rows l / 4 and l / 4 + 8
  auto tile_row = [&](int mt) { return mt * 16 * NW + warp * 16; };
  int qp[MT][2];
  int m_lo = INT_MAX, m_hi = INT_MIN;         // positions of this warp's valid rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tile_row(mt) + (lane >> 2) + 8 * i;
      qp[mt][i] = r < nr ? p.qpos(r) : -1;
    }
    const int r = tile_row(mt) + (lane & 15);
    if (r < nr) {
      m_lo = min(m_lo, p.qpos(r));
      m_hi = max(m_hi, p.qpos(r));
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    m_lo = min(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = max(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  // the range a tile skip is decided on: the warp's, or for a warpgroup
  // (whose products all its warps run together) the block's
  int w_lo = m_lo, w_hi = m_hi;
  if constexpr (WG) {
    w_lo = INT_MAX;
    w_hi = INT_MIN;
    for (int r = lane & 15; r < nr; r += 16) {
      w_lo = min(w_lo, p.qpos(r));
      w_hi = max(w_hi, p.qpos(r));
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, o));
      w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, o));
    }
  }
  const bool rows_live = w_lo <= w_hi;
  const int limit = p.key_limit();

  float m[MT][2], l[MT][2], acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }

  // q and the first STAGES - 1 tiles in flight, one commit group each
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_first + i < t_end) stage(t_first + i, i);
    cp_async_commit();
  }
  for (int tile = t_first; tile < t_end; ++tile) {
    const int st = (tile - t_first) % STAGES;
    cp_async_wait<STAGES - 2>();                // this tile (and q) have landed
    if constexpr (WG) fence_proxy_async();     // ... visible to wgmma
    __syncthreads();                            // ... for every thread; and the
                                                // stage refilled below is free
    if (tile + STAGES - 1 < t_end) stage(tile + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_async_commit();
    const int t0 = tile * KT;
    bool live = rows_live;
    if (p.causal) live = live && t0 <= w_hi;
    if (p.window > 0) live = live && t0 + KT - 1 > w_lo - p.window;
    if (!live) continue;
    // no mask where every valid row of the warp sees the whole tile
    const bool full = m_lo > m_hi ||          // a warp of padding rows only
                      (t0 + KT <= limit && (!p.causal || t0 + KT - 1 <= m_lo) &&
                       (p.window <= 0 || t0 > m_hi - p.window));
    const unsigned char* ks = kv_s + st * 2 * TILE;
    const unsigned char* vs = ks + TILE;
    float s[MT][KT / 8][4];
    // scale into the exp2 domain, mask the partly visible tiles only, and
    // update m-tile mt's online softmax; s[mt] becomes the probabilities
    auto softmax = [&](int mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e] * scale_log2;
          if (!full) {
            const int kp = t0 + n * 8 + (lane & 3) * 2 + (e & 1);
            const int qpos = qp[mt][e >> 1];
            bool vis = kp < limit;
            if (p.causal) vis = vis && kp <= qpos;
            if (p.window > 0) vis = vis && kp > qpos - p.window;
            x = vis ? x : -INFINITY;
          }
          s[mt][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[mt][i], quad_max(mx[i]));
        alpha[i] = fast_exp2(m[mt][i] - m_new);
        m[mt][i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = fast_exp2(s[mt][n][e] - m[mt][e >> 1]);   // masked: exp2(-inf) = 0
          sum[e >> 1] += s[mt][n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[mt][i] = l[mt][i] * alpha[i] + sum[i];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[mt][n][0] *= alpha[0]; acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1]; acc[mt][n][3] *= alpha[1];
      }
    };
    // the bf16 A operand of P V, keys 16 kk .. 16 kk + 15, from the fragment
    auto p_frag = [&](int mt, int kk, uint32_t (&a)[4]) {
      a[0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      a[1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      a[2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      a[3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    };
    if constexpr (WG) {
      // S = Q K^T, one commit group an m-tile; each m-tile's softmax runs
      // while the tensor cores work on the other's products
      static_assert(MT == 2, "two m-tiles a warpgroup");
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc)
          wgmma_ss_n64(s[mt], desc_k_major<HD, RT>(smem_addr(q_s), kc, 64 * mt),
                       desc_k_major<HD, KT>(smem_addr(ks), kc, 0), kc);
        wgmma_commit();
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wgmma_wait<1>();                        // S of m-tile mt (groups end in order)
        softmax(mt);
        wgmma_fence();
        // O += P V: P from registers, V from shared memory
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          uint32_t a[4];
          p_frag(mt, kk, a);
          wgmma_rs<HD>(acc[mt], a, desc_mn_major<HD, KT>(smem_addr(vs), kk));
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
    } else {
      // S = Q K^T through ldmatrix (q, K) and mma.sync
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t qf[4];
        ldmatrix_x4(qf, smem_addr(q_s + swz<HD, RT>(tile_row(0) + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                    kc * 2 + (lane >> 4))));
#pragma unroll
        for (int np = 0; np < KT / 16; ++np) {
          uint32_t bf[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bf, smem_addr(ks + swz<HD, KT>(key, kc * 2 + ((lane >> 3) & 1))));
          mma_bf16(s[0][2 * np], qf, bf[0], bf[1]);
          mma_bf16(s[0][2 * np + 1], qf, bf[2], bf[3]);
        }
      }
      softmax(0);
      // O += P V: P from registers, V through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t a[4];
        p_frag(0, kk, a);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bf[4];
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(bf, smem_addr(vs + swz<HD, KT>(key, dp * 2 + (lane >> 4))));
          mma_bf16(acc[0][2 * dp], a, bf[0], bf[1]);
          mma_bf16(acc[0][2 * dp + 1], a, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) l[mt][i] = quad_sum(l[mt][i]);

  const int col = (lane & 3) * 2;
  if constexpr (NW == 1) {                    // split-KV runs on one-warp blocks
    if (n_splits > 1) {
      // split-KV: partials to this block's shared memory, combined across the cluster
      constexpr int LDA = HD + 4;               // fp32 partial-acc row stride
      static_assert((2 + LDA) * RT * 4 <= STAGES * 2 * TILE, "partials fit the stages");
      float* m_s = reinterpret_cast<float*>(kv_s);
      float* l_s = m_s + RT;
      float* acc_s = l_s + RT;                  // [RT][LDA]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = tile_row(mt) + (lane >> 2) + 8 * i;
          if ((lane & 3) == 0) {
            m_s[r] = m[mt][i];
            l_s[r] = l[mt][i];
          }
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
            *reinterpret_cast<float2*>(acc_s + r * LDA + n * 8 + col) =
                make_float2(acc[mt][n][2 * i], acc[mt][n][2 * i + 1]);
        }
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      // this rank's slice of the valid rows' outputs, in units of 4 columns
      constexpr int UPR = HD / 4;
      const int units = nr * UPR;
      for (int u = split * units / n_splits + tid; u < (split + 1) * units / n_splits; u += NT) {
        const int r = u / UPR, c = (u % UPR) * 4;
        // every rank's loads issued before any is used (distributed shared
        // memory is far); then the sums in the fixed split order
        float ms[kMaxSplits], ls[kMaxSplits];
        float4 as[kMaxSplits];
#pragma unroll
        for (int sp = 0; sp < kMaxSplits; ++sp) {
          if (sp < n_splits) {
            ms[sp] = *cluster.map_shared_rank(m_s + r, sp);
            ls[sp] = *cluster.map_shared_rank(l_s + r, sp);
            as[sp] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(acc_s + r * LDA + c, sp));
          }
        }
        float mm = kNegInf;
#pragma unroll
        for (int sp = 0; sp < kMaxSplits; ++sp)
          if (sp < n_splits) mm = fmaxf(mm, ms[sp]);
        float ll = 0.f;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int sp = 0; sp < kMaxSplits; ++sp) {
          if (sp < n_splits) {
            const float w = fast_exp2(ms[sp] - mm);
            ll = fmaf(ls[sp], w, ll);
            o.x = fmaf(as[sp].x, w, o.x); o.y = fmaf(as[sp].y, w, o.y);
            o.z = fmaf(as[sp].z, w, o.z); o.w = fmaf(as[sp].w, w, o.w);
          }
        }
        const float inv = ll > 0.f ? 1.f / ll : 0.f;
        const int row = r0 + r;
        bf16* dst = out + (((size_t)b * S + row / g) * h + kvh * g + row % g) * HD + c;
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16(o.x * inv, o.y * inv), pack_bf16(o.z * inv, o.w * inv));
      }
      cluster.sync();                           // peers are done reading this block
      return;
    }
  }
  // the output tile through shared memory (the K/V stages are free), then
  // whole 16-byte chunks of each valid row
  unsigned char* o_s = kv_s;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tile_row(mt) + (lane >> 2) + 8 * i;
      const float inv = l[mt][i] > 0.f ? 1.f / l[mt][i] : 0.f;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(o_s + swz<HD, RT>(r, n) + col * 2) =
            pack_bf16(acc[mt][n][2 * i] * inv, acc[mt][n][2 * i + 1] * inv);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = t_first_row; r < RT; r += RSTEP) {
    if (r >= nr) break;
    const int row = r0 + r;
    *reinterpret_cast<uint4*>(out + (((size_t)b * S + row / g) * h + kvh * g + row % g) * HD +
                              ch * 8) = *reinterpret_cast<const uint4*>(o_s + swz<HD, RT>(r, ch));
  }
}

// Launch one call: grid (splits, B * hk, row tiles), a cluster of `splits`
// blocks along x when splits > 1.  Returns a cudaError_t as int.
template <int NW, class P>
int launch(const P& pol, const void* q, void* out, int B, int S, int h, int hk,
           int splits, float scale, size_t extra_smem, cudaStream_t stream) {
  constexpr int RT = rows_per_block<NW>();
  if (B <= 0 || S <= 0 || hk <= 0 || h % hk || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && NW != 1))
    return (int)cudaErrorInvalidValue;
  const int row_tiles = ((h / hk) * S + RT - 1) / RT;
  if (row_tiles > 65535 || B * hk > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = core_smem_bytes<NW>(P::kHD) + extra_smem;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<NW, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * hk, row_tiles);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, attention_kernel<NW, P>, pol, static_cast<const bf16*>(q),
      static_cast<bf16*>(out), S, h, hk, scale * kLog2e);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace gqa
