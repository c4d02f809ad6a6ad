// Flash attention backward for GQA on Hopper (sm_90a), fp32 and bf16.
//
// The gradient of csrc/flash_attention.cu's function (kernels/
// flash_attention.py::FlashAttention).  The reference's TPU kernel
// (repro/kernels/flash_attention.py::flash_attention_pallas) has no
// backward: the reference trains by differentiating its checkpointed
// chunked_attention loop (repro/models/attention.py:106-109), so this
// kernel is the card's counterpart of that gradient.
//
// Contract (the plain versions: flash_attention_bwd_tiled, the same
// algorithm and schedule in PyTorch; flash_attention_bwd_ref, autograd of
// the plain forward):
//   q, dq      (B, S, h, hd)   T     contiguous
//   k          (B, T, hk, hd)  T     batch and sequence strides as given,
//                                    head stride hd, unit dim stride
//   v          (B, T, hk, hdv) T     as k, head stride hdv
//   out, dout  (B, S, h, hdv)  T     contiguous (the forward's output and
//                                    its gradient)
//   lse        (B, h, S)       fp32  the forward's row log-sum-exp (natural log)
//   dsum       (B, h, S)       fp32  scratch: D = rowsum(dout * out)
//   dk, dv     (B, T, hk, hd / hdv) T  contiguous
// (hd, hdv) is (64, 64), (128, 128) or MLA's (192, 128).  Query s sits at
// position s + T - S; the mask and the scale (1/sqrt(hd)) are the forward's.
//
// Math (FlashAttention-2): D = rowsum(dO o O); P = exp(S scale - lse);
// dV = P^T dO with P rounded to T for the product (the forward rounds it so);
// dP = dO V^T; dS = P o (dP - D); dQ = dS K scale; dK = dS^T Q scale, dS
// rounded to T for both products.  Scores, softmax and every accumulator
// in fp32; never TF32 (the fp32 card-vs-CPU gates rest on it).
//
// Two kernels, no atomics, so two runs give the same bits and a (batch, kv
// head)'s gradients depend on its own data alone:
//  * dq: grid (B * hk, row tile).  Rows are position-major across the g
//    heads of the group (row = s * g + member), as the forward takes them.
//    It first computes D for its rows (written for the second kernel), then
//    walks the key tiles its rows see, recomputing S and dP, and writes dQ
//    once.
//  * dk/dv: grid (B * hk, key tile).  It walks the row tiles of the group's
//    g heads that see its keys, so each K/V tile serves the whole group, keeps
//    dK and dV in registers and writes them once.
// Blocks start in order of their linear index, so with the heads innermost
// every head's longest tiles under a causal mask (the last row tiles, the
// first key tiles) start in the first wave.
// The dq kernel recomputes the two products the dk/dv kernel also computes:
// five products' worth of work becomes seven.
//
// The schedule: a block's range of tiles comes from rows_seeing / keys_seen,
// and each warp decides on every 16-row x 16-key unit whether to skip it (no
// visible pair), run it unmasked (every pair visible) or mask it
// (unit_state).  The three are kernels/flash_attention.py's bwd_rows,
// bwd_keys and bwd_unit_state line for line; the CPU tests hold those
// against a brute-force mask.
//
// bf16 (the path training runs): one warpgroup a block, every product a
// warpgroup MMA (wgmma) of M 64 -- the dq kernel's 64 rows, the dk/dv
// kernel's 64 keys -- so each operand in shared memory is read once a
// warpgroup: the score-like products (S = Q K^T, dP = dO V^T; S^T, dP^T)
// with both operands K-major in shared memory, the others (dQ += dS K, dV +=
// P^T dO, dK += dS^T Q) with P or dS from registers and the tile read
// MN-major.  Tiles are in the forward's 128-byte XOR-swizzled layout, the
// other side staged by a cp.async ring of two (K/V tiles for dq, Q/dO tiles
// with their lse and D for dk/dv; 64 rows or keys, 32 at MLA's widths).  P
// and dS go from the fp32 accumulator fragment straight into the bf16 A
// operand of the next product; a warp's fragment rows are its 16 rows or
// keys, so the masks and the unit states are per warp.
// fp32: FMA kernels in the shape of flash_attention.cu's flash_fwd_kernel
// (a 16 x 16 thread grid, tiles of 32 rows and 32 keys in shared memory).
//
// Bound.  Operations: 10 hd per visible (query head row, key) pair (the
// score product and four others), at the tensor cores' bf16 rate; the
// bytes (q, k, v, out, dout read once, dq, dk, dv written once) are far
// smaller at the training shapes.
//
// Shared memory above 48 KB is set once per device by
// flash_attention_bwd_init (the wrapper calls it on a device's first
// launch): no launch sets an attribute, and nothing here is static.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnit = 16;   // rows and keys of the unit a warp skips or masks

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* dsum;
  void* dq;
  void* dk;
  void* dv;
  int B, S, T, h, hk;
  long long k_bs, k_ss, v_bs, v_ss;
  int causal, window;
  float scale;
};

// ---- the schedule (kernels/flash_attention.py::bwd_rows, bwd_keys,
// bwd_unit_state); rows are position-major, row r at position r / g + T - S

// rows [lo, hi) that see some key of [k0, k1) (k1 <= T)
__device__ __forceinline__ void rows_seeing(const Args& a, int g, int k0, int k1, int& lo,
                                            int& hi) {
  const int off = a.T - a.S;
  const int p_lo = a.causal ? k0 : off;
  const int p_hi = a.window > 0 ? k1 - 1 + a.window - 1 : off + a.S - 1;
  const int s_lo = max(0, p_lo - off), s_hi = min(a.S - 1, p_hi - off);
  lo = s_lo <= s_hi ? s_lo * g : 0;
  hi = s_lo <= s_hi ? (s_hi + 1) * g : 0;
}

// keys [lo, hi) that some row of [r0, r1) sees (r1 <= g S)
__device__ __forceinline__ void keys_seen(const Args& a, int g, int r0, int r1, int& lo,
                                          int& hi) {
  const int off = a.T - a.S;
  const int p_lo = r0 / g + off, p_hi = (r1 - 1) / g + off;
  const int k_hi = a.causal ? min(a.T - 1, p_hi) : a.T - 1;
  const int k_lo = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
  lo = k_lo <= k_hi ? k_lo : 0;
  hi = k_lo <= k_hi ? k_hi + 1 : 0;
}

// rows [r0, r1) against keys [k0, k1) (both clipped to the valid ones):
// 0 no pair visible, 1 every pair visible, 2 some (a mask)
__device__ __forceinline__ int unit_state(const Args& a, int g, int r0, int r1, int k0,
                                          int k1) {
  if (r0 >= r1 || k0 >= k1) return 0;
  const int off = a.T - a.S;
  const int p_lo = r0 / g + off, p_hi = (r1 - 1) / g + off;
  const bool any = (!a.causal || k0 <= p_hi) && (a.window <= 0 || k1 - 1 > p_lo - a.window);
  if (!any) return 0;
  const bool all = (!a.causal || k1 - 1 <= p_lo) && (a.window <= 0 || k0 > p_hi - a.window);
  return all ? 1 : 2;
}

__device__ __forceinline__ bool visible(const Args& a, int key, int qpos) {
  bool vis = key < a.T;
  if (a.causal) vis = vis && key <= qpos;
  if (a.window > 0) vis = vis && key > qpos - a.window;
  return vis;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// offset of row r (position-major) of kv head kvh's group in a (B, S, h, W) tensor
__device__ __forceinline__ size_t row_off(int b, int r, int g, int kvh, int S, int h, int W) {
  return (((size_t)b * S + r / g) * h + kvh * g + r % g) * W;
}

// ... and in a (B, h, S) row vector
__device__ __forceinline__ size_t vec_off(int b, int r, int g, int kvh, int S, int h) {
  return ((size_t)b * h + kvh * g + r % g) * S + r / g;
}

// ============================ bf16: wgmma =================================

constexpr int kThreadsBf16 = 128;   // one warpgroup: warp w owns M rows 16 w .. 16 w + 15
constexpr int kStages = 2;
constexpr int kBlockRows = 64;      // dq: query rows a block (the M of its products)
constexpr int kBlockKeys = 64;      // dk/dv: keys a block (the M of its products)

// the staged tile of the other side: keys a dq K/V tile, rows a dk/dv Q/dO
// tile (the N of the score-like products); 32 at MLA's widths keeps the
// registers and two blocks an SM
__host__ __device__ constexpr int stage_tile(int hd) { return hd > 128 ? 32 : 64; }

__host__ __device__ constexpr size_t dq_bf16_smem(int hd, int hdv) {
  // the block's q and dO tiles, then the ring of K/V stages
  return 1024 + (size_t)kBlockRows * (hd + hdv) * 2 +
         (size_t)kStages * stage_tile(hd) * (hd + hdv) * 2;
}
__host__ __device__ constexpr size_t dkdv_bf16_smem(int hd, int hdv) {
  // the block's K and V tiles, the ring of Q/dO stages, each stage's lse and D
  return 1024 + (size_t)kBlockKeys * (hd + hdv) * 2 +
         (size_t)kStages * stage_tile(hd) * ((hd + hdv) * 2 + 2 * 4);
}

// d (64 x N) += a (registers, 64 x 16) * b, b the 16 rows kk of a tile of
// ROWS rows of N values read MN-major; N 192 as three 64-wide atoms
template <int N, int ROWS>
__device__ __forceinline__ void rs_product(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                           uint32_t tile, int kk) {
  if constexpr (N == 192) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      wgmma_rs_n64(*reinterpret_cast<float(*)[8][4]>(&d[8 * j]), a,
                   desc_mn_major<N, ROWS>(tile + j * ROWS * 128, kk));
  } else {
    wgmma_rs<N>(d, a, desc_mn_major<N, ROWS>(tile, kk));
  }
}

// the bf16 A operand (16 rows x 16) of columns 16 kk .. 16 kk + 15 of a
// 64 x N fp32 accumulator fragment
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[NT][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsBf16) dq_bf16(Args a) {
  constexpr int RT = kBlockRows, KT = stage_tile(HD), NT = kThreadsBf16;
  constexpr int CH = HD / 8, CHV = HDV / 8;
  constexpr int TILE_K = KT * HD * 2, TILE = TILE_K + KT * HDV * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                  // [RT][HD]
  unsigned char* do_s = q_s + RT * HD * 2;    // [RT][HDV]
  unsigned char* kv_s = do_s + RT * HDV * 2;  // [stage][K [KT][HD], V [KT][HDV]]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* out = static_cast<const bf16*>(a.out);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int g = a.h / a.hk;
  const int rows = g * a.S;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * RT;   // the rows seeing most keys first
  const int nr = min(RT, rows - r0);
  const int b = blockIdx.x / a.hk, kvh = blockIdx.x % a.hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = a.T - a.S;
  const float scale_log2 = a.scale * kLog2e;

  for (int i = tid; i < RT * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r < nr;
    const bf16* src = ok ? q + row_off(b, r0 + r, g, kvh, a.S, a.h, HD) + ch * 8 : q;
    cp_async16(smem_addr(q_s + swz<HD, RT>(r, ch)), src, ok);
  }
  for (int i = tid; i < RT * CHV; i += NT) {
    const int r = i / CHV, ch = i % CHV;
    const bool ok = r < nr;
    const bf16* src = ok ? dout + row_off(b, r0 + r, g, kvh, a.S, a.h, HDV) + ch * 8 : dout;
    cp_async16(smem_addr(do_s + swz<HDV, RT>(r, ch)), src, ok);
  }
  cp_async_commit();

  // D of the warp's 16 rows: each lane sums its pairs of values in order,
  // then the warp's butterfly; lane l keeps rows l / 4 and l / 4 + 8
  float dsum[2] = {0.f, 0.f}, lse2[2];
  int qp[2];
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    float part = 0.f;
    if (r < nr) {
      const size_t o = row_off(b, r0 + r, g, kvh, a.S, a.h, HDV);
      for (int d = lane * 2; d < HDV; d += 64) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + o + d));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + o + d));
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
      }
    }
    part = warp_sum(part);
    if ((lane >> 2) == (i & 7)) dsum[i >> 3] = part;
    if (lane == 0 && r < nr) a.dsum[vec_off(b, r0 + r, g, kvh, a.S, a.h)] = part;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    // a padding row: P = exp2(-inf) = 0, so it adds nothing anywhere
    qp[i] = r < nr ? (r0 + r) / g + off : -1;
    lse2[i] = r < nr ? a.lse[vec_off(b, r0 + r, g, kvh, a.S, a.h)] * kLog2e : INFINITY;
  }

  const int wr0 = r0 + warp * 16, wr1 = min(wr0 + 16, rows);   // the warp's rows
  int k_lo, k_hi;
  keys_seen(a, g, r0, r0 + nr, k_lo, k_hi);
  const int t_first = k_lo / KT, t_end = k_hi > k_lo ? (k_hi - 1) / KT + 1 : t_first;
  auto stage = [&](int tile, int st) {
    const int t0 = tile * KT;
    const uint32_t ks = smem_addr(kv_s + st * TILE), vs = ks + TILE_K;
#pragma unroll
    for (int i = tid; i < KT * CH; i += NT) {
      const int t = i / CH, ch = i % CH, kpos = t0 + t;
      const bool ok = kpos < a.T;
      cp_async16(ks + swz<HD, KT>(t, ch),
                 ok ? k + b * a.k_bs + kpos * a.k_ss + kvh * HD + ch * 8 : k, ok);
    }
#pragma unroll
    for (int i = tid; i < KT * CHV; i += NT) {
      const int t = i / CHV, ch = i % CHV, kpos = t0 + t;
      const bool ok = kpos < a.T;
      cp_async16(vs + swz<HDV, KT>(t, ch),
                 ok ? v + b * a.v_bs + kpos * a.v_ss + kvh * HDV + ch * 8 : v, ok);
    }
  };

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_first + i < t_end) stage(t_first + i, i);
    cp_async_commit();
  }
  for (int tile = t_first; tile < t_end; ++tile) {
    const int st = (tile - t_first) % kStages;
    cp_async_wait<kStages - 2>();   // this tile (and q, dO) have landed
    fence_proxy_async();            // ... visible to wgmma
    __syncthreads();                // ... for every thread; the stage refilled below is free
    if (tile + kStages - 1 < t_end) stage(tile + kStages - 1, (st + kStages - 1) % kStages);
    cp_async_commit();
    const int t0 = tile * KT;
    if (unit_state(a, g, r0, r0 + nr, t0, min(t0 + KT, a.T)) == 0) continue;
    const uint32_t ks = smem_addr(kv_s + st * TILE), vs = ks + TILE_K;
    // S = Q K^T and dP = dO V^T, one commit group each
    float s[KT / 8][4], dp[KT / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss<KT>(s, desc_k_major<HD, RT>(smem_addr(q_s), kc, 0),
                   desc_k_major<HD, KT>(ks, kc, 0), kc);
    wgmma_commit();
#pragma unroll
    for (int dc = 0; dc < HDV / 16; ++dc)
      wgmma_ss<KT>(dp, desc_k_major<HDV, RT>(smem_addr(do_s), dc, 0),
                   desc_k_major<HDV, KT>(vs, dc, 0), dc);
    wgmma_commit();
    wgmma_wait<1>();   // S (groups end in order)
    // P in place of S: unmasked on the warp's units every pair of which is visible
#pragma unroll
    for (int u = 0; u < KT / kUnit; ++u) {
      const int k0 = t0 + u * kUnit;
      const bool full = unit_state(a, g, wr0, wr1, k0, min(k0 + kUnit, a.T)) == 1 &&
                        k0 + kUnit <= a.T;
#pragma unroll
      for (int nt = 2 * u; nt < 2 * u + 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = s[nt][e] * scale_log2 - lse2[i];
          if (!full) {
            const int kp = t0 + nt * 8 + (lane & 3) * 2 + (e & 1);
            x = visible(a, kp, qp[i]) ? x : -INFINITY;
          }
          s[nt][e] = fast_exp2(x);
        }
      }
    }
    wgmma_wait<0>();   // dP
    // dS in place of dP, then dQ += dS K
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dsum[e >> 1]);
    // every A operand packed before the first product is issued, so none
    // of their registers is written while a product may still read them
    uint32_t af[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) pack_a(af[kk], dp, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) rs_product<HD, KT>(acc, af[kk], ks, kk);
    wgmma_commit();
    wgmma_wait<0>();   // the stage's K is read before it is refilled
  }
  cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    if (r >= nr) continue;
    bf16* dst = dq + row_off(b, r0 + r, g, kvh, a.S, a.h, HD) + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsBf16) dkdv_bf16(Args a) {
  constexpr int KB = kBlockKeys, QT = stage_tile(HD), NT = kThreadsBf16;
  constexpr int CH = HD / 8, CHV = HDV / 8;
  constexpr int TILE_Q = QT * HD * 2, TILE = TILE_Q + QT * HDV * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k_s = base;                         // [KB][HD]
  unsigned char* v_s = k_s + KB * HD * 2;            // [KB][HDV]
  unsigned char* st_s = v_s + KB * HDV * 2;          // [stage][Q [QT][HD], dO [QT][HDV]]
  float* lse_s = reinterpret_cast<float*>(st_s + kStages * TILE);   // [stage][QT]
  float* d_s = lse_s + kStages * QT;                                // [stage][QT]

  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int g = a.h / a.hk;
  const int rows = g * a.S;
  const int k0b = blockIdx.y * KB;
  const int nk = min(KB, a.T - k0b);
  const int b = blockIdx.x / a.hk, kvh = blockIdx.x % a.hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = a.T - a.S;
  const float scale_log2 = a.scale * kLog2e;

  for (int i = tid; i < KB * CH; i += NT) {
    const int t = i / CH, ch = i % CH, kpos = k0b + t;
    const bool ok = t < nk;
    cp_async16(smem_addr(k_s + swz<HD, KB>(t, ch)),
               ok ? k + b * a.k_bs + kpos * a.k_ss + kvh * HD + ch * 8 : k, ok);
  }
  for (int i = tid; i < KB * CHV; i += NT) {
    const int t = i / CHV, ch = i % CHV, kpos = k0b + t;
    const bool ok = t < nk;
    cp_async16(smem_addr(v_s + swz<HDV, KB>(t, ch)),
               ok ? v + b * a.v_bs + kpos * a.v_ss + kvh * HDV + ch * 8 : v, ok);
  }
  cp_async_commit();

  int r_lo, r_hi;
  rows_seeing(a, g, k0b, k0b + nk, r_lo, r_hi);
  const int t_first = r_lo / QT, t_end = r_hi > r_lo ? (r_hi - 1) / QT + 1 : t_first;
  auto stage = [&](int tile, int st) {
    const int rt0 = tile * QT;
    const uint32_t qs = smem_addr(st_s + st * TILE), dos = qs + TILE_Q;
#pragma unroll
    for (int i = tid; i < QT * CH; i += NT) {
      const int r = i / CH, ch = i % CH;
      const bool ok = rt0 + r < rows;
      cp_async16(qs + swz<HD, QT>(r, ch),
                 ok ? q + row_off(b, rt0 + r, g, kvh, a.S, a.h, HD) + ch * 8 : q, ok);
    }
#pragma unroll
    for (int i = tid; i < QT * CHV; i += NT) {
      const int r = i / CHV, ch = i % CHV;
      const bool ok = rt0 + r < rows;
      cp_async16(dos + swz<HDV, QT>(r, ch),
                 ok ? dout + row_off(b, rt0 + r, g, kvh, a.S, a.h, HDV) + ch * 8 : dout, ok);
    }
    // a padding row: lse +inf makes its P 0, and D 0 keeps its dS 0
    for (int i = tid; i < QT; i += NT) {
      const bool ok = rt0 + i < rows;
      const size_t o = ok ? vec_off(b, rt0 + i, g, kvh, a.S, a.h) : 0;
      lse_s[st * QT + i] = ok ? a.lse[o] * kLog2e : INFINITY;
      d_s[st * QT + i] = ok ? a.dsum[o] : 0.f;
    }
  };

  const int kw0 = k0b + warp * 16, kw1 = min(kw0 + 16, a.T);   // the warp's keys
  float dk[HD / 8][4], dv[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_first + i < t_end) stage(t_first + i, i);
    cp_async_commit();
  }
  for (int tile = t_first; tile < t_end; ++tile) {
    const int st = (tile - t_first) % kStages;
    cp_async_wait<kStages - 2>();   // this tile (and K, V) have landed
    fence_proxy_async();            // ... visible to wgmma
    __syncthreads();                // ... for every thread; the stage refilled below is free
    if (tile + kStages - 1 < t_end) stage(tile + kStages - 1, (st + kStages - 1) % kStages);
    cp_async_commit();
    const int rt0 = tile * QT;
    if (unit_state(a, g, rt0, min(rt0 + QT, rows), k0b, k0b + nk) == 0) continue;
    const uint32_t qs = smem_addr(st_s + st * TILE), dos = qs + TILE_Q;
    const float* lse_t = lse_s + st * QT;
    const float* d_t = d_s + st * QT;
    // S^T = K Q^T and dP^T = V dO^T: the block's 64 keys against the tile's rows
    float s[QT / 8][4], dp[QT / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss<QT>(s, desc_k_major<HD, KB>(smem_addr(k_s), kc, 0),
                   desc_k_major<HD, QT>(qs, kc, 0), kc);
    wgmma_commit();
#pragma unroll
    for (int dc = 0; dc < HDV / 16; ++dc)
      wgmma_ss<QT>(dp, desc_k_major<HDV, KB>(smem_addr(v_s), dc, 0),
                   desc_k_major<HDV, QT>(dos, dc, 0), dc);
    wgmma_commit();
    wgmma_wait<1>();   // S^T
    // P^T in place of S^T: unmasked on the warp's units every pair of which is visible
#pragma unroll
    for (int u = 0; u < QT / kUnit; ++u) {
      const int ur0 = rt0 + u * kUnit;
      const bool full = unit_state(a, g, ur0, min(ur0 + kUnit, rows), kw0, kw1) == 1 &&
                        kw0 + kUnit <= a.T;
#pragma unroll
      for (int nt = 2 * u; nt < 2 * u + 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = nt * 8 + (lane & 3) * 2 + (e & 1);
          float x = s[nt][e] * scale_log2 - lse_t[rr];
          if (!full) {
            const int key = kw0 + (lane >> 2) + 8 * (e >> 1);
            x = visible(a, key, (rt0 + rr) / g + off) ? x : -INFINITY;
          }
          s[nt][e] = fast_exp2(x);
        }
      }
    }
    wgmma_wait<0>();   // dP^T
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - d_t[nt * 8 + (lane & 3) * 2 + (e & 1)]);
    // dV += P^T dO and dK += dS^T Q, contracting over the tile's rows; every
    // A operand packed before the first product is issued
    uint32_t pa[QT / 16][4], da[QT / 16][4];
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) rs_product<HDV, QT>(dv, pa[kk], dos, kk);
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) rs_product<HD, QT>(dk, da[kk], qs, kk);
    wgmma_commit();
    wgmma_wait<0>();   // the stage is read before it is refilled
  }
  cp_async_wait<0>();

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw0 + (lane >> 2) + 8 * i;
    if (key >= a.T) continue;
    const size_t row = ((size_t)b * a.T + key) * a.hk + kvh;
    bf16* dst_k = dkp + row * HD + (lane & 3) * 2;
    bf16* dst_v = dvp + row * HDV + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst_k + n * 8) =
          pack_bf16(dk[n][2 * i] * a.scale, dk[n][2 * i + 1] * a.scale);
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst_v + n * 8) = pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
  }
}

// ============================ fp32: FMA ===================================

constexpr int kThreadsF32 = 256;   // a 16 x 16 grid of (ty, tx)
constexpr int kF32Rows = 32;       // rows a dq block / a staged dk/dv row tile: 2 a ty or tx
constexpr int kF32Keys = 32;       // keys a staged dq key tile / a dk/dv block

__host__ __device__ constexpr size_t dq_f32_smem(int hd, int hdv) {
  // q^T, dO^T [W][rows]; K^T, V^T [W][keys]; K [keys][hd]; dS [rows][keys]
  return ((size_t)kF32Rows * (hd + hdv) + (size_t)kF32Keys * (2 * hd + hdv) +
          (size_t)kF32Rows * kF32Keys) * 4;
}
__host__ __device__ constexpr size_t dkdv_f32_smem(int hd, int hdv) {
  // K^T, V^T [W][keys]; q^T, dO^T [W][rows]; q, dO [rows][W]; P^T, dS^T
  // [keys][rows]; lse, D [rows]
  return ((size_t)kF32Keys * (hd + hdv) + (size_t)kF32Rows * 2 * (hd + hdv) +
          2 * (size_t)kF32Keys * kF32Rows + 2 * (size_t)kF32Rows) * 4;
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsF32) dq_f32(Args a) {
  constexpr int RT = kF32Rows, KT = kF32Keys, NT = kThreadsF32;
  extern __shared__ float fsm[];
  float* qT = fsm;                 // [HD][RT]
  float* doT = qT + HD * RT;       // [HDV][RT]
  float* kT = doT + HDV * RT;      // [HD][KT]
  float* vT = kT + HD * KT;        // [HDV][KT]
  float* kr = vT + HDV * KT;       // [KT][HD]
  float* ds_s = kr + KT * HD;      // [RT][KT]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* out = static_cast<const float*>(a.out);
  const float* dout = static_cast<const float*>(a.dout);
  const int g = a.h / a.hk;
  const int rows = g * a.S;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * RT;
  const int nr = min(RT, rows - r0);
  const int b = blockIdx.x / a.hk, kvh = blockIdx.x % a.hk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int off = a.T - a.S;

  for (int c = tid; c < RT * HD; c += NT) {
    const int r = c / HD, d = c % HD;
    qT[d * RT + r] = r < nr ? q[row_off(b, r0 + r, g, kvh, a.S, a.h, HD) + d] : 0.f;
  }
  for (int c = tid; c < RT * HDV; c += NT) {
    const int r = c / HDV, d = c % HDV;
    doT[d * RT + r] = r < nr ? dout[row_off(b, r0 + r, g, kvh, a.S, a.h, HDV) + d] : 0.f;
  }
  // this thread's rows ty * 2 + i: D (each of the 16 lanes of a ty sums
  // every 16th value, then the half-warp's butterfly), lse, position
  float lse_r[2], d_r[2];
  int qp[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty * 2 + i;
    valid[i] = r < nr;
    float part = 0.f;
    if (valid[i]) {
      const size_t o = row_off(b, r0 + r, g, kvh, a.S, a.h, HDV);
      for (int d = tx; d < HDV; d += 16) part = fmaf(dout[o + d], out[o + d], part);
    }
    d_r[i] = half_warp_sum(part);
    qp[i] = (r0 + r) / g + off;
    lse_r[i] = valid[i] ? a.lse[vec_off(b, r0 + r, g, kvh, a.S, a.h)] : INFINITY;
    if (valid[i] && tx == 0) a.dsum[vec_off(b, r0 + r, g, kvh, a.S, a.h)] = d_r[i];
  }

  float acc[2][HD / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;

  int k_lo, k_hi;
  keys_seen(a, g, r0, r0 + nr, k_lo, k_hi);
  for (int t0 = (k_lo / KT) * KT; t0 < k_hi; t0 += KT) {
    __syncthreads();   // the previous tile's readers are done
    for (int c = tid; c < KT * HD; c += NT) {
      const int t = c / HD, d = c % HD, kp = t0 + t;
      const float x = kp < a.T ? k[b * a.k_bs + kp * a.k_ss + kvh * HD + d] : 0.f;
      kT[d * KT + t] = x;
      kr[t * HD + d] = x;
    }
    for (int c = tid; c < KT * HDV; c += NT) {
      const int t = c / HDV, d = c % HDV, kp = t0 + t;
      vT[d * KT + t] = kp < a.T ? v[b * a.v_bs + kp * a.v_ss + kvh * HDV + d] : 0.f;
    }
    __syncthreads();
    float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float2 q2 = *reinterpret_cast<const float2*>(qT + d * RT + ty * 2);
      const float2 k2 = *reinterpret_cast<const float2*>(kT + d * KT + tx * 2);
      s[0][0] = fmaf(q2.x, k2.x, s[0][0]); s[0][1] = fmaf(q2.x, k2.y, s[0][1]);
      s[1][0] = fmaf(q2.y, k2.x, s[1][0]); s[1][1] = fmaf(q2.y, k2.y, s[1][1]);
    }
#pragma unroll 8
    for (int d = 0; d < HDV; ++d) {
      const float2 o2 = *reinterpret_cast<const float2*>(doT + d * RT + ty * 2);
      const float2 v2 = *reinterpret_cast<const float2*>(vT + d * KT + tx * 2);
      dp[0][0] = fmaf(o2.x, v2.x, dp[0][0]); dp[0][1] = fmaf(o2.x, v2.y, dp[0][1]);
      dp[1][0] = fmaf(o2.y, v2.x, dp[1][0]); dp[1][1] = fmaf(o2.y, v2.y, dp[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = t0 + tx * 2 + j;
        const float p = valid[i] && visible(a, kp, qp[i]) ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        ds_s[(ty * 2 + i) * KT + tx * 2 + j] = p * (dp[i][j] - d_r[i]);
      }
    __syncthreads();
    for (int t = 0; t < KT; ++t) {
      const float d0 = ds_s[(ty * 2) * KT + t], d1 = ds_s[(ty * 2 + 1) * KT + t];
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const float kv = kr[t * HD + tx + 16 * c];
        acc[0][c] = fmaf(d0, kv, acc[0][c]);
        acc[1][c] = fmaf(d1, kv, acc[1][c]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    float* dst = dq + row_off(b, r0 + ty * 2 + i, g, kvh, a.S, a.h, HD);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dst[tx + 16 * c] = acc[i][c] * a.scale;
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreadsF32) dkdv_f32(Args a) {
  constexpr int KB = kF32Keys, QT = kF32Rows, NT = kThreadsF32;
  extern __shared__ float fsm[];
  float* kT = fsm;                 // [HD][KB]
  float* vT = kT + HD * KB;        // [HDV][KB]
  float* qT = vT + HDV * KB;       // [HD][QT]
  float* qr = qT + HD * QT;        // [QT][HD]
  float* doT = qr + QT * HD;       // [HDV][QT]
  float* dor = doT + HDV * QT;     // [QT][HDV]
  float* p_s = dor + QT * HDV;     // [KB][QT]
  float* ds_s = p_s + KB * QT;     // [KB][QT]
  float* lse_s = ds_s + KB * QT;   // [QT]
  float* d_s = lse_s + QT;         // [QT]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const int g = a.h / a.hk;
  const int rows = g * a.S;
  const int k0b = blockIdx.y * KB;
  const int nk = min(KB, a.T - k0b);
  const int b = blockIdx.x / a.hk, kvh = blockIdx.x % a.hk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int off = a.T - a.S;

  for (int c = tid; c < KB * HD; c += NT) {
    const int t = c / HD, d = c % HD;
    kT[d * KB + t] = t < nk ? k[b * a.k_bs + (k0b + t) * a.k_ss + kvh * HD + d] : 0.f;
  }
  for (int c = tid; c < KB * HDV; c += NT) {
    const int t = c / HDV, d = c % HDV;
    vT[d * KB + t] = t < nk ? v[b * a.v_bs + (k0b + t) * a.v_ss + kvh * HDV + d] : 0.f;
  }

  // this thread's keys ty * 2 + i; its output columns tx + 16 c
  float dk[2][HD / 16], dv[2][HDV / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c) dv[i][c] = 0.f;
  }

  int r_lo, r_hi;
  rows_seeing(a, g, k0b, k0b + nk, r_lo, r_hi);
  for (int rt0 = (r_lo / QT) * QT; rt0 < r_hi; rt0 += QT) {
    __syncthreads();   // the previous tile's readers are done (and K, V are in)
    for (int c = tid; c < QT * HD; c += NT) {
      const int r = c / HD, d = c % HD;
      const float x = rt0 + r < rows ? q[row_off(b, rt0 + r, g, kvh, a.S, a.h, HD) + d] : 0.f;
      qT[d * QT + r] = x;
      qr[r * HD + d] = x;
    }
    for (int c = tid; c < QT * HDV; c += NT) {
      const int r = c / HDV, d = c % HDV;
      const float x = rt0 + r < rows ? dout[row_off(b, rt0 + r, g, kvh, a.S, a.h, HDV) + d] : 0.f;
      doT[d * QT + r] = x;
      dor[r * HDV + d] = x;
    }
    for (int r = tid; r < QT; r += NT) {
      const bool ok = rt0 + r < rows;
      const size_t o = ok ? vec_off(b, rt0 + r, g, kvh, a.S, a.h) : 0;
      lse_s[r] = ok ? a.lse[o] : INFINITY;
      d_s[r] = ok ? a.dsum[o] : 0.f;
    }
    __syncthreads();
    float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float2 k2 = *reinterpret_cast<const float2*>(kT + d * KB + ty * 2);
      const float2 q2 = *reinterpret_cast<const float2*>(qT + d * QT + tx * 2);
      s[0][0] = fmaf(k2.x, q2.x, s[0][0]); s[0][1] = fmaf(k2.x, q2.y, s[0][1]);
      s[1][0] = fmaf(k2.y, q2.x, s[1][0]); s[1][1] = fmaf(k2.y, q2.y, s[1][1]);
    }
#pragma unroll 8
    for (int d = 0; d < HDV; ++d) {
      const float2 v2 = *reinterpret_cast<const float2*>(vT + d * KB + ty * 2);
      const float2 o2 = *reinterpret_cast<const float2*>(doT + d * QT + tx * 2);
      dp[0][0] = fmaf(v2.x, o2.x, dp[0][0]); dp[0][1] = fmaf(v2.x, o2.y, dp[0][1]);
      dp[1][0] = fmaf(v2.y, o2.x, dp[1][0]); dp[1][1] = fmaf(v2.y, o2.y, dp[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0b + ty * 2 + i, rr = tx * 2 + j, row = rt0 + rr;
        const bool vis = row < rows && visible(a, key, row / g + off);
        const float p = vis ? expf(s[i][j] * a.scale - lse_s[rr]) : 0.f;
        p_s[(ty * 2 + i) * QT + rr] = p;
        ds_s[(ty * 2 + i) * QT + rr] = p * (dp[i][j] - d_s[rr]);
      }
    __syncthreads();
    for (int r = 0; r < QT; ++r) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p = p_s[(ty * 2 + i) * QT + r], ds = ds_s[(ty * 2 + i) * QT + r];
#pragma unroll
        for (int c = 0; c < HDV / 16; ++c) dv[i][c] = fmaf(p, dor[r * HDV + tx + 16 * c], dv[i][c]);
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) dk[i][c] = fmaf(ds, qr[r * HD + tx + 16 * c], dk[i][c]);
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0b + ty * 2 + i;
    if (key >= a.T) continue;
    const size_t row = ((size_t)b * a.T + key) * a.hk + kvh;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) dkp[row * HD + tx + 16 * c] = dk[i][c] * a.scale;
#pragma unroll
    for (int c = 0; c < HDV / 16; ++c) dvp[row * HDV + tx + 16 * c] = dv[i][c];
  }
}

// ============================ launchers ===================================

template <class K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int HD, int HDV>
int init_widths() {
  int rc = set_smem(dq_bf16<HD, HDV>, dq_bf16_smem(HD, HDV));
  if (!rc) rc = set_smem(dkdv_bf16<HD, HDV>, dkdv_bf16_smem(HD, HDV));
  if (!rc) rc = set_smem(dq_f32<HD, HDV>, dq_f32_smem(HD, HDV));
  if (!rc) rc = set_smem(dkdv_f32<HD, HDV>, dkdv_f32_smem(HD, HDV));
  return rc;
}

template <int HD, int HDV>
int launch_widths(const Args& a, bool bf16_path, cudaStream_t stream) {
  const int g = a.h / a.hk;
  const int row_tile = bf16_path ? kBlockRows : kF32Rows;
  const int key_tile = bf16_path ? kBlockKeys : kF32Keys;
  const dim3 grid_dq(a.B * a.hk, (g * a.S + row_tile - 1) / row_tile);
  const dim3 grid_kv(a.B * a.hk, (a.T + key_tile - 1) / key_tile);
  if (grid_dq.y > 65535 || grid_kv.y > 65535) return (int)cudaErrorInvalidConfiguration;
  if (bf16_path) {
    dq_bf16<HD, HDV><<<grid_dq, kThreadsBf16, dq_bf16_smem(HD, HDV), stream>>>(a);
  } else {
    dq_f32<HD, HDV><<<grid_dq, kThreadsF32, dq_f32_smem(HD, HDV), stream>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // after the dq kernel on the same stream: it wrote D
  if (bf16_path) {
    dkdv_bf16<HD, HDV><<<grid_kv, kThreadsBf16, dkdv_bf16_smem(HD, HDV), stream>>>(a);
  } else {
    dkdv_f32<HD, HDV><<<grid_kv, kThreadsF32, dkdv_f32_smem(HD, HDV), stream>>>(a);
  }
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, const void* out, const void* lse,
           const void* dout, void* dsum, void* dq, void* dk, void* dv, int B, int S, int Tk,
           int h, int hk, int hd, int hdv, long long k_bs, long long k_ss, long long v_bs,
           long long v_ss, int causal, int window, float scale, bool bf16_path,
           void* stream_ptr) {
  if (B <= 0 || S <= 0 || Tk <= 0 || hk <= 0 || h % hk) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
               dq, dk, dv, B, S, Tk, h, hk, k_bs, k_ss, v_bs, v_ss, causal, window, scale};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (hd == 64 && hdv == 64) return launch_widths<64, 64>(a, bf16_path, stream);
  if (hd == 128 && hdv == 128) return launch_widths<128, 128>(a, bf16_path, stream);
  if (hd == 192 && hdv == 128) return launch_widths<192, 128>(a, bf16_path, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Set the shared-memory size every kernel of this library launches with, on
// the current device; the wrapper calls it once for each device.
int flash_attention_bwd_init() {
  int rc = init_widths<64, 64>();
  if (!rc) rc = init_widths<128, 128>();
  if (!rc) rc = init_widths<192, 128>();
  return rc;
}

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                            const void* lse, const void* dout, void* dsum, void* dq, void* dk,
                            void* dv, int B, int S, int Tk, int h, int hk, int hd, int hdv,
                            long long k_bs, long long k_ss, long long v_bs, long long v_ss,
                            int causal, int window, float scale, void* stream) {
  return launch(q, k, v, out, lse, dout, dsum, dq, dk, dv, B, S, Tk, h, hk, hd, hdv, k_bs,
                k_ss, v_bs, v_ss, causal, window, scale, false, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                             const void* lse, const void* dout, void* dsum, void* dq, void* dk,
                             void* dv, int B, int S, int Tk, int h, int hk, int hd, int hdv,
                             long long k_bs, long long k_ss, long long v_bs, long long v_ss,
                             int causal, int window, float scale, void* stream) {
  return launch(q, k, v, out, lse, dout, dsum, dq, dk, dv, B, S, Tk, h, hk, hd, hdv, k_bs,
                k_ss, v_bs, v_ss, causal, window, scale, true, stream);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
